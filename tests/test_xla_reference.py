"""The XLA path of every model family against a float64 NumPy reference.

Covers the shape, mask, packing and gradient cases of the recurrent
families (blstm, lstm, cudnnlstm) and the MoE head: peepholes and
projection on and off, full and ragged lengths, odd batches, packed rows
with ``reset_mask``, carried initial states, and directional derivatives
checked against central differences of the float64 reference.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lstm_ctc_tpu.models import apply_model, init_model
from lstm_ctc_tpu.models.cells import (bilstm_dual_scan, init_lstm_cell,
                                       lstm_scan, reverse_segments,
                                       reverse_sequence)
from lstm_ctc_tpu.models.moe import apply_moe, init_moe

ATOL = 2e-5      # float32 scan against the float64 reference


# ------------------------------------------------------------ reference
def sigmoid(v):
    return 1.0 / (1.0 + np.exp(-v))


def f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def ref_cell_scan(p, x, seq_len, forget_bias, reset=None, init=None,
                  reverse=False):
    """TF LSTMCell + dynamic_rnn masking, step by step in float64.
    ``reset`` [B, T] zeroes the carry at segment starts; ``reverse`` runs
    the padded buffer from its end."""
    batch, steps, _ = x.shape
    units = p["bias"].shape[0] // 4
    proj = p.get("proj")
    out_dim = proj.shape[1] if proj is not None else units
    if init is None:
        c, h = np.zeros((batch, units)), np.zeros((batch, out_dim))
    else:
        c, h = (np.array(a, np.float64) for a in init)
    out = np.zeros((batch, steps, out_dim))
    for t in (range(steps - 1, -1, -1) if reverse else range(steps)):
        if reset is not None:
            keep = 1.0 - reset[:, t:t + 1]
            c, h = c * keep, h * keep
        i, j, f, o = np.split(x[:, t] @ p["wx"] + h @ p["wh"] + p["bias"],
                              4, axis=-1)
        if "w_i_diag" in p:
            i = i + p["w_i_diag"] * c
            f = f + p["w_f_diag"] * c
        c_new = sigmoid(f + forget_bias) * c + sigmoid(i) * np.tanh(j)
        if "w_o_diag" in p:
            o = o + p["w_o_diag"] * c_new
        y = sigmoid(o) * np.tanh(c_new)
        if proj is not None:
            y = y @ proj
        alive = (t < seq_len)[:, None]
        c = np.where(alive, c_new, c)
        h = np.where(alive, y, h)
        out[:, t] = np.where(alive, y, 0.0)
    return out, (c, h)


def ref_reverse(x, seq_len, reset=None):
    """tf.reverse_sequence, or segment-wise reversal of packed rows."""
    out = x.copy()
    for b in range(x.shape[0]):
        n = int(seq_len[b])
        starts = [0] if reset is None else \
            [t for t in range(n) if reset[b, t] > 0.5] or [0]
        for s, e in zip(starts, starts[1:] + [n]):
            out[b, s:e] = x[b, s:e][::-1]
    return out


def ref_blstm_layer(fw, bw, x, seq_len, reset=None):
    fw_out, fw_state = ref_cell_scan(fw, x, seq_len, 5.0, reset)
    bw_out, bw_state = ref_cell_scan(bw, ref_reverse(x, seq_len, reset),
                                     seq_len, 5.0, reset)
    return fw_out, bw_out, fw_state, bw_state


def ref_moe(p, x, num_experts, temp):
    gate = x @ p["w_prior"] + p["b_prior"]
    gate = np.exp(gate - gate.max(-1, keepdims=True))
    gate = gate / gate.sum(-1, keepdims=True)
    expert = temp * np.tanh(x @ p["w_expert"] + p["b_expert"])
    expert = expert.reshape(x.shape[0], num_experts, -1)
    return np.einsum("ne,nev->nv", gate, expert)


def ref_model(params, state, x, seq_len, config, reset=None):
    """Logits of apply_model(train=False) for every family."""
    x = np.asarray(x, np.float64)
    kind = config["nnet_type"]
    if kind == "blstm":
        fin = x
        for i, (fw, bw) in enumerate(zip(params["fwd"], params["bwd"])):
            fw_out, bw_out, _, _ = ref_blstm_layer(fw, bw, fin, seq_len,
                                                   reset)
            cat = np.concatenate(
                [fw_out, ref_reverse(bw_out, seq_len, reset)], axis=2)
            fin = fin + cat if i == 0 and fin.shape[2] == cat.shape[2] \
                else cat
        h = fin
    else:
        h = x
        if config.get("use_bn"):
            h = ref_bn(params["bn_in"], state["bn_in"], h)
        for i, cell in enumerate(params["layers"]):
            out, _ = ref_cell_scan(cell, h, seq_len, 1.0)
            if kind == "lstm" and out.shape[2] == h.shape[2]:
                out = out + h
            if config.get("use_bn"):
                out = ref_bn(params["bn"][i], state["bn"][i], out)
            h = out
    flat = h.reshape(-1, h.shape[2])
    if config.get("num_experts"):
        y = ref_moe(params["moe"], flat, config["num_experts"],
                    config["moe_temp"])
    else:
        y = flat @ params["head"]["w"] + params["head"]["b"]
    return y.reshape(h.shape[0], h.shape[1], -1)


def ref_bn(p, s, x):
    return (x - s["mean"]) / np.sqrt(s["var"] + 1e-3) * p["scale"] \
        + p["offset"]


# ------------------------------------------------------------ fixtures
def cell(seed, d, units, proj, peep):
    return init_lstm_cell(jax.random.PRNGKey(seed), d, units,
                          num_proj=proj, use_peepholes=peep)


def lengths(kind, batch, steps):
    if kind == "full":
        return np.full((batch,), steps, np.int32)
    return np.asarray([steps] + [max(1, steps - 3 * b - 2)
                                 for b in range(1, batch)], np.int32)


def packed_reset(seq_len, steps):
    """Two or three segments per row, starting at 0."""
    reset = np.zeros((len(seq_len), steps), np.float32)
    for b, n in enumerate(seq_len):
        for start in (0, n // 3, (2 * n) // 3 + b % 2):
            if start < n:
                reset[b, start] = 1.0
    return reset


PEEP_PROJ = [(False, None), (True, None), (False, 4), (True, 4)]


# ------------------------------------------------------------ lstm_scan
@pytest.mark.parametrize("peep,proj", PEEP_PROJ)
@pytest.mark.parametrize("lens", ["full", "ragged"])
def test_lstm_scan_matches_reference(peep, proj, lens):
    batch, steps = 3, 11
    p = cell(0, 5, 7, proj, peep)
    x = np.random.RandomState(1).randn(batch, steps, 5).astype(np.float32)
    seq = lengths(lens, batch, steps)
    out, (c, h) = lstm_scan(p, jnp.asarray(x), jnp.asarray(seq), 1.0)
    want, (wc, wh) = ref_cell_scan(f64(p), x.astype(np.float64), seq, 1.0)
    np.testing.assert_allclose(np.asarray(out), want, atol=ATOL)
    np.testing.assert_allclose(np.asarray(c), wc, atol=ATOL)
    np.testing.assert_allclose(np.asarray(h), wh, atol=ATOL)


@pytest.mark.parametrize("proj", [None, 4])
def test_lstm_scan_carries_initial_state(proj):
    """Chunked streaming: two chunks with the state carried equal one
    pass over the whole sequence."""
    p = cell(2, 5, 6, proj, True)
    x = np.random.RandomState(3).randn(2, 12, 5).astype(np.float32)
    seq = np.full((2,), 12, np.int32)
    first, state = lstm_scan(p, jnp.asarray(x[:, :5]), jnp.full((2,), 5),
                             1.0)
    second, _ = lstm_scan(p, jnp.asarray(x[:, 5:]), jnp.full((2,), 7), 1.0,
                          initial_state=state)
    want, _ = ref_cell_scan(f64(p), x.astype(np.float64), seq, 1.0)
    got = np.concatenate([np.asarray(first), np.asarray(second)], axis=1)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("lens", ["full", "ragged"])
def test_lstm_scan_reverse_runs_from_the_buffer_end(lens):
    p = cell(4, 5, 6, 3, True)
    x = np.random.RandomState(5).randn(3, 9, 5).astype(np.float32)
    seq = lengths(lens, 3, 9)
    out, _ = lstm_scan(p, jnp.asarray(x), jnp.asarray(seq), 1.0,
                       reverse=True)
    want, _ = ref_cell_scan(f64(p), x.astype(np.float64), seq, 1.0,
                            reverse=True)
    np.testing.assert_allclose(np.asarray(out), want, atol=ATOL)


# ------------------------------------------------------ bilstm_dual_scan
@pytest.mark.parametrize("peep,proj", PEEP_PROJ)
@pytest.mark.parametrize("rows", ["full", "ragged", "packed"])
def test_bilstm_dual_scan_matches_reference(peep, proj, rows):
    batch, steps = 3, 13          # odd batch
    fw, bw = cell(6, 5, 7, proj, peep), cell(7, 5, 7, proj, peep)
    x = np.random.RandomState(8).randn(batch, steps, 5).astype(np.float32)
    seq = lengths("full" if rows == "full" else "ragged", batch, steps)
    reset = packed_reset(seq, steps) if rows == "packed" else None
    r = None if reset is None else jnp.asarray(reset)
    x_rev = reverse_sequence(jnp.asarray(x), jnp.asarray(seq)) \
        if reset is None else \
        reverse_segments(jnp.asarray(x), jnp.asarray(seq), r)
    fw_out, bw_out, (fs, bs) = bilstm_dual_scan(
        fw, bw, jnp.asarray(x), x_rev, jnp.asarray(seq), 5.0, reset_mask=r)
    want = ref_blstm_layer(f64(fw), f64(bw), x.astype(np.float64), seq,
                           reset)
    np.testing.assert_allclose(np.asarray(fw_out), want[0], atol=ATOL)
    np.testing.assert_allclose(np.asarray(bw_out), want[1], atol=ATOL)
    for got, ref in zip((fs, bs), want[2:]):
        np.testing.assert_allclose(np.asarray(got[0]), ref[0], atol=ATOL)
        np.testing.assert_allclose(np.asarray(got[1]), ref[1], atol=ATOL)


# ------------------------------------------------------------ gradients
def directional_check(jax_loss, ref_loss, args, seed):
    """<grad f, v> from JAX (float32) against a float64 central
    difference of the reference along a random direction v."""
    rng = np.random.RandomState(seed)
    v = jax.tree.map(lambda a: rng.randn(*np.shape(a)), args)
    grad = jax.grad(jax_loss)(args)
    want = sum(float(np.sum(np.asarray(g, np.float64) * d)) for g, d in
               zip(jax.tree.leaves(grad), jax.tree.leaves(v)))
    eps = 1e-5
    base = f64(args)
    plus = jax.tree.map(lambda a, d: a + eps * d, base, v)
    minus = jax.tree.map(lambda a, d: a - eps * d, base, v)
    got = (ref_loss(plus) - ref_loss(minus)) / (2 * eps)
    np.testing.assert_allclose(want, got, rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("peep,proj", PEEP_PROJ)
def test_lstm_scan_gradient(peep, proj):
    p = cell(9, 4, 5, proj, peep)
    rs = np.random.RandomState(10)
    x = rs.randn(3, 7, 4).astype(np.float32)
    seq = lengths("ragged", 3, 7)
    cot = rs.randn(3, 7, proj or 5)

    def jax_loss(a):
        out, _ = lstm_scan(a[0], a[1], jnp.asarray(seq), 1.0)
        return jnp.sum(out * cot)

    def ref_loss(a):
        return float(np.sum(ref_cell_scan(a[0], a[1], seq, 1.0)[0] * cot))

    directional_check(jax_loss, ref_loss, (p, jnp.asarray(x)), 11)


@pytest.mark.parametrize("peep,proj", PEEP_PROJ)
def test_bilstm_packed_gradient(peep, proj):
    fw, bw = cell(12, 4, 5, proj, peep), cell(13, 4, 5, proj, peep)
    rs = np.random.RandomState(14)
    x = rs.randn(2, 9, 4).astype(np.float32)
    seq = lengths("ragged", 2, 9)
    reset = packed_reset(seq, 9)
    cot = rs.randn(2, 2, 9, proj or 5)

    def jax_loss(a):
        xr = reverse_segments(a[2], jnp.asarray(seq), jnp.asarray(reset))
        f, b, _ = bilstm_dual_scan(a[0], a[1], a[2], xr, jnp.asarray(seq),
                                   5.0, reset_mask=jnp.asarray(reset))
        return jnp.sum(f * cot[0]) + jnp.sum(b * cot[1])

    def ref_loss(a):
        f, b, _, _ = ref_blstm_layer(a[0], a[1], a[2], seq, reset)
        return float(np.sum(f * cot[0]) + np.sum(b * cot[1]))

    directional_check(jax_loss, ref_loss, (fw, bw, jnp.asarray(x)), 15)


# ------------------------------------------------------------ models
BASE = {"input_dim": 4, "left_context": 1, "right_context": 1,
        "subsample": 0, "num_layers": 2, "num_neurons": 8,
        "num_projects": 6, "num_targets": 7, "use_peepholes": True,
        "dropout_rate": 1.0, "num_experts": 0, "moe_temp": 10.0}


@pytest.mark.parametrize("over", [
    {"nnet_type": "blstm"},
    {"nnet_type": "blstm", "num_experts": 3},
    {"nnet_type": "blstm", "input_dim": 4, "left_context": 0,
     "right_context": 0, "num_projects": 2},      # layer-0 residual
    {"nnet_type": "blstm", "num_projects": 0, "use_peepholes": False},
    {"nnet_type": "lstm"},
    {"nnet_type": "lstm", "num_experts": 3},
    {"nnet_type": "lstm", "use_bn": True},
    {"nnet_type": "cudnnlstm", "num_projects": 0, "use_peepholes": False},
], ids=["blstm", "blstm_moe", "blstm_residual", "blstm_plain", "lstm",
        "lstm_moe", "lstm_bn_eval", "cudnnlstm"])
def test_model_logits_match_reference(over):
    config = dict(BASE, **over)
    params, state = init_model(jax.random.PRNGKey(16), config)
    if config.get("use_bn"):
        rs = np.random.RandomState(17)
        state = jax.tree.map(
            lambda a: jnp.asarray(0.5 + rs.rand(*a.shape), jnp.float32),
            state)
    dim = config["input_dim"] * (1 + config["left_context"]
                                 + config["right_context"])
    x = np.random.RandomState(18).randn(3, 10, dim).astype(np.float32)
    seq = lengths("ragged", 3, 10)
    logits, _, _, _ = apply_model(params, state, jnp.asarray(x),
                                  jnp.asarray(seq), config)
    want = ref_model(f64(params), f64(state), x, seq, config)
    np.testing.assert_allclose(np.asarray(logits), want, atol=1e-4)


def test_blstm_packed_rows_match_reference():
    config = dict(BASE, nnet_type="blstm")
    params, state = init_model(jax.random.PRNGKey(19), config)
    x = np.random.RandomState(20).randn(2, 12, 12).astype(np.float32)
    seq = lengths("ragged", 2, 12)
    reset = packed_reset(seq, 12)
    logits, _, _, _ = apply_model(params, state, jnp.asarray(x),
                                  jnp.asarray(seq), config,
                                  reset_mask=jnp.asarray(reset))
    want = ref_model(f64(params), f64(state), x, seq, config, reset)
    np.testing.assert_allclose(np.asarray(logits), want, atol=1e-4)


# ------------------------------------------------------------ MoE head
@pytest.mark.parametrize("n,d,e,v", [(5, 6, 3, 4), (16, 8, 4, 7),
                                     (1, 4, 1, 5)])
def test_moe_head_matches_reference(n, d, e, v):
    p = init_moe(jax.random.PRNGKey(21), d, v, e)
    x = np.random.RandomState(22).randn(n, d).astype(np.float32)
    got = apply_moe(p, jnp.asarray(x), e, 10.0,
                    compute_dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(got),
                               ref_moe(f64(p), x.astype(np.float64), e,
                                       10.0), atol=1e-4)


@pytest.mark.parametrize("n,d,e,v", [(6, 5, 3, 4), (4, 8, 6, 3)])
def test_moe_head_gradient(n, d, e, v):
    p = init_moe(jax.random.PRNGKey(23), d, v, e)
    rs = np.random.RandomState(24)
    x = rs.randn(n, d).astype(np.float32)
    cot = rs.randn(n, v)

    def jax_loss(a):
        return jnp.sum(apply_moe(a[0], a[1], e, 10.0,
                                 compute_dtype=jnp.float32) * cot)

    def ref_loss(a):
        return float(np.sum(ref_moe(a[0], a[1], e, 10.0) * cot))

    directional_check(jax_loss, ref_loss, (p, jnp.asarray(x)), 25)


def _dots(closed):
    found = []
    for eqn in closed.eqns:
        if eqn.primitive.name == "dot_general":
            found.append((tuple(str(v.aval.dtype) for v in eqn.invars),
                          str(eqn.outvars[0].aval.dtype)))
        for value in eqn.params.values():
            inner = getattr(value, "jaxpr", None)
            if inner is not None:
                found.extend(_dots(inner))
    return found


def test_moe_head_bf16_expert_projection_accumulates_in_f32():
    """compute_dtype=bf16 puts bf16 operands into the expert projection
    with a float32 result; the gate projection stays float32."""
    p = init_moe(jax.random.PRNGKey(26), 8, 5, 3)
    x = jnp.ones((4, 8), jnp.float32)
    dots = _dots(jax.make_jaxpr(lambda p, x: apply_moe(
        p, x, 3, 10.0, compute_dtype=jnp.bfloat16))(p, x).jaxpr)
    assert (("bfloat16", "bfloat16"), "float32") in dots
    assert (("float32", "float32"), "float32") in dots


def test_moe_head_bf16_gradient_reads_the_bf16_activations():
    """The weight cotangent of the bf16 expert projection contracts the
    float32 output cotangent with the bf16 activations; the gradient
    itself is float32."""
    p = init_moe(jax.random.PRNGKey(27), 8, 5, 3)
    x = jnp.ones((4, 8), jnp.float32)
    grad_fn = jax.grad(lambda p: jnp.sum(apply_moe(
        p, x, 3, 10.0, compute_dtype=jnp.bfloat16)))
    dots = _dots(jax.make_jaxpr(grad_fn)(p).jaxpr)
    assert (("bfloat16", "bfloat16"), "float32") in dots
    assert (("float32", "bfloat16"), "float32") in dots
    grads = jax.eval_shape(grad_fn, p)
    assert grads["w_expert"].dtype == jnp.float32


def test_moe_head_dropout_is_train_only():
    p = init_moe(jax.random.PRNGKey(28), 6, 4, 3)
    x = jnp.asarray(np.random.RandomState(29).randn(8, 6), jnp.float32)
    plain = apply_moe(p, x, 3, 10.0)
    np.testing.assert_array_equal(
        np.asarray(apply_moe(p, x, 3, 10.0, keep_prob=0.5)),
        np.asarray(plain))
    dropped = apply_moe(p, x, 3, 10.0, keep_prob=0.5,
                        dropout_rng=jax.random.PRNGKey(30))
    assert not np.allclose(np.asarray(dropped), np.asarray(plain))


@pytest.mark.gpu
def test_moe_head_bf16_on_the_card_matches_f32(gpu_device):
    """On the card the bf16 head agrees with the float32 head to bf16
    rounding of its operands (8 mantissa bits)."""
    p = jax.device_put(init_moe(jax.random.PRNGKey(31), 640, 72, 72),
                       gpu_device)
    x = jax.device_put(jnp.asarray(np.random.RandomState(32)
                                   .randn(512, 640) * 0.05, jnp.float32),
                       gpu_device)
    with jax.default_matmul_precision("highest"):
        want = apply_moe(p, x, 72, 10.0, compute_dtype=jnp.float32)
    got = apply_moe(p, x, 72, 10.0, compute_dtype=jnp.bfloat16)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=5e-2)
