"""Model-layer tests: cell math vs a numpy TF-LSTMCell reference, masking,
reverse-sequence, BLSTM/LSTM/MoE shapes and semantics."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lstm_ctc_tpu.models import apply_model, init_model
from lstm_ctc_tpu.models.cells import (
    init_lstm_cell,
    lstm_scan,
    reverse_sequence,
)
from lstm_ctc_tpu.models.moe import apply_moe, init_moe


def numpy_lstm_reference(params, x, seq_len, forget_bias):
    """Step-by-step TF LSTMCell semantics in plain numpy."""
    wx = np.asarray(params["wx"])
    wh = np.asarray(params["wh"])
    bias = np.asarray(params["bias"])
    proj = np.asarray(params["proj"]) if "proj" in params else None
    peep = "w_i_diag" in params
    batch, time_steps, _ = x.shape
    units = bias.shape[0] // 4
    out_dim = proj.shape[1] if proj is not None else units
    c = np.zeros((batch, units), np.float32)
    h = np.zeros((batch, out_dim), np.float32)
    outputs = np.zeros((batch, time_steps, out_dim), np.float32)

    def sigmoid(v):
        return 1.0 / (1.0 + np.exp(-v))

    for t in range(time_steps):
        gates = x[:, t] @ wx + h @ wh + bias
        i, j, f, o = np.split(gates, 4, axis=-1)
        if peep:
            i = i + params["w_i_diag"] * c
            f = f + params["w_f_diag"] * c
        c_new = sigmoid(f + forget_bias) * c + sigmoid(i) * np.tanh(j)
        if peep:
            o = o + params["w_o_diag"] * c_new
        out = sigmoid(o) * np.tanh(c_new)
        if proj is not None:
            out = out @ proj
        alive = (t < seq_len)[:, None]
        c = np.where(alive, c_new, c)
        h = np.where(alive, out, h)
        outputs[:, t] = np.where(alive, out, 0.0)
    return outputs, (c, h)


@pytest.mark.parametrize("use_peepholes,num_proj", [
    (False, None), (True, None), (False, 5), (True, 5),
])
def test_lstm_scan_matches_numpy_reference(use_peepholes, num_proj):
    rng = jax.random.PRNGKey(0)
    params = init_lstm_cell(rng, input_dim=7, num_units=9,
                            num_proj=num_proj, use_peepholes=use_peepholes)
    x = np.random.RandomState(0).randn(3, 11, 7).astype(np.float32)
    seq_len = np.array([11, 6, 0], np.int32)
    out, (c, h) = lstm_scan(params, jnp.asarray(x), jnp.asarray(seq_len),
                            forget_bias=5.0)
    params_np = jax.tree.map(np.asarray, params)
    ref_out, (ref_c, ref_h) = numpy_lstm_reference(
        params_np, x, seq_len, forget_bias=5.0)
    np.testing.assert_allclose(np.asarray(out), ref_out, atol=2e-5)
    np.testing.assert_allclose(np.asarray(c), ref_c, atol=2e-5)
    np.testing.assert_allclose(np.asarray(h), ref_h, atol=2e-5)


def test_lstm_scan_masks_padding():
    rng = jax.random.PRNGKey(1)
    params = init_lstm_cell(rng, 4, 6, num_proj=3)
    x = np.random.RandomState(1).randn(2, 10, 4).astype(np.float32)
    seq_len = jnp.array([4, 10])
    out, state = lstm_scan(params, jnp.asarray(x), seq_len, 1.0)
    assert np.all(np.asarray(out)[0, 4:] == 0.0)
    # state for row 0 frozen at t=4: recompute with truncated input
    out2, state2 = lstm_scan(params, jnp.asarray(x[:1, :4]),
                             jnp.array([4]), 1.0)
    np.testing.assert_allclose(np.asarray(state[0])[0],
                               np.asarray(state2[0])[0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(state[1])[0],
                               np.asarray(state2[1])[0], atol=1e-6)


def test_dual_scan_matches_two_single_scans():
    from lstm_ctc_tpu.models.cells import bilstm_dual_scan
    rng = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(rng)
    fw = init_lstm_cell(k1, 6, 8, num_proj=4, use_peepholes=True)
    bw = init_lstm_cell(k2, 6, 8, num_proj=4, use_peepholes=True)
    x = jnp.asarray(np.random.RandomState(0).randn(3, 9, 6), jnp.float32)
    seq_len = jnp.array([9, 5, 0])
    x_rev = reverse_sequence(x, seq_len)
    f_out, b_out, (f_st, b_st) = bilstm_dual_scan(fw, bw, x, x_rev,
                                                  seq_len, 5.0)
    f_ref, f_st_ref = lstm_scan(fw, x, seq_len, 5.0)
    b_ref, b_st_ref = lstm_scan(bw, x_rev, seq_len, 5.0)
    np.testing.assert_allclose(np.asarray(f_out), np.asarray(f_ref),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(b_out), np.asarray(b_ref),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(f_st[0]), np.asarray(f_st_ref[0]),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(b_st[1]), np.asarray(b_st_ref[1]),
                               atol=1e-5)


def test_reverse_sequence():
    x = jnp.asarray(np.arange(2 * 5 * 1, dtype=np.float32).reshape(2, 5, 1))
    seq_len = jnp.array([3, 5])
    rev = np.asarray(reverse_sequence(x, seq_len))
    # row 0: first 3 reversed, tail untouched
    np.testing.assert_array_equal(rev[0, :, 0], [2, 1, 0, 3, 4])
    np.testing.assert_array_equal(rev[1, :, 0], [9, 8, 7, 6, 5])
    # double reverse is identity
    rev2 = reverse_sequence(jnp.asarray(rev), seq_len)
    np.testing.assert_array_equal(np.asarray(rev2), np.asarray(x))


WSJ_LIKE_CONFIG = {
    "nnet_type": "blstm",
    "input_dim": 12,
    "left_context": 0,
    "right_context": 0,
    "subsample": 0,
    "num_layers": 2,
    "num_neurons": 16,
    "num_projects": 8,
    "num_targets": 10,
    "use_peepholes": True,
    "dropout_rate": 0.9,
    "num_experts": 0,
    "moe_temp": 10.0,
}


def test_blstm_shapes_and_padding():
    config = dict(WSJ_LIKE_CONFIG)
    params, state = init_model(jax.random.PRNGKey(0), config)
    x = jnp.asarray(np.random.RandomState(0).randn(3, 20, 12), jnp.float32)
    seq_len = jnp.array([20, 13, 0])
    logits, encoder, reg, _ = apply_model(params, state, x, seq_len, config)
    assert logits.shape == (3, 20, 10)
    assert encoder.shape[0] == 3
    assert reg == []
    # padded frames see zeroed LSTM output → logits there equal the head bias
    bias = np.asarray(params["head"]["b"])
    np.testing.assert_allclose(np.asarray(logits)[1, 13:],
                               np.tile(bias, (7, 1)), atol=1e-5)


def test_blstm_residual_layer0():
    config = dict(WSJ_LIKE_CONFIG, input_dim=16, num_projects=8)
    # input_dim == 2*num_projects → residual connection active on layer 0
    params, state = init_model(jax.random.PRNGKey(0), config)
    x = jnp.asarray(np.random.RandomState(0).randn(2, 6, 16), jnp.float32)
    logits, _, _, _ = apply_model(params, state, x, jnp.array([6, 6]), config)
    assert logits.shape == (2, 6, 10)


def test_blstm_independent_of_padding_amount():
    """Same utterance padded to different bucket lengths → same logits."""
    config = dict(WSJ_LIKE_CONFIG)
    params, state = init_model(jax.random.PRNGKey(2), config)
    x = np.random.RandomState(3).randn(1, 9, 12).astype(np.float32)
    x_long = np.zeros((1, 15, 12), np.float32)
    x_long[:, :9] = x
    l1, _, _, _ = apply_model(params, state, jnp.asarray(x),
                              jnp.array([9]), config)
    l2, _, _, _ = apply_model(params, state, jnp.asarray(x_long),
                              jnp.array([9]), config)
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l2)[:, :9],
                               atol=1e-5)


def test_moe_head_mixture_semantics():
    rng = jax.random.PRNGKey(0)
    params = init_moe(rng, output_dim=6, num_targets=5, num_experts=3)
    x = jnp.asarray(np.random.RandomState(0).randn(7, 6), jnp.float32)
    y = apply_moe(params, x, num_experts=3, moe_temperature=10.0)
    assert y.shape == (7, 5)
    # mixed logits are bounded by the temperature (|tanh| <= 1, gate sums to 1)
    assert np.abs(np.asarray(y)).max() <= 10.0 + 1e-5
    # manual computation
    gate = jax.nn.softmax(x @ params["w_prior"] + params["b_prior"])
    expert = 10.0 * jnp.tanh(x @ params["w_expert"] + params["b_expert"])
    expert = expert.reshape(7, 3, 5)
    ref = jnp.einsum("ne,nev->nv", gate, expert)
    np.testing.assert_allclose(np.asarray(y), np.asarray(ref), atol=1e-6)


def test_blstm_moe_end_to_end():
    config = dict(WSJ_LIKE_CONFIG, num_experts=4)
    params, state = init_model(jax.random.PRNGKey(0), config)
    x = jnp.asarray(np.random.RandomState(0).randn(2, 8, 12), jnp.float32)
    logits, _, _, _ = apply_model(params, state, x, jnp.array([8, 5]), config)
    assert logits.shape == (2, 8, 10)


def test_compute_dtype_bfloat16_config_plumbing():
    """`compute_dtype = bfloat16` in nnet.config (string, as the recipe
    writes it) must reach the cell matmuls.  This CPU jax build cannot
    EXECUTE bf16 dots (DotThunk: "Unsupported element type"), so assert
    at trace level: the jaxpr must contain bf16×bf16 dot_generals, and
    the final logits must stay f32."""
    config = dict(WSJ_LIKE_CONFIG, num_experts=4, dropout_rate=1.0,
                  compute_dtype="bfloat16")
    params, state = init_model(jax.random.PRNGKey(0), config)
    x = jnp.asarray(np.random.RandomState(0).randn(2, 8, 12), jnp.float32)

    def fwd(params, x):
        logits, _, _, _ = apply_model(params, state, x,
                                      jnp.array([8, 5]), config)
        return logits

    out_shape = jax.eval_shape(fwd, params, x)
    assert out_shape.dtype == jnp.float32

    jaxpr = jax.make_jaxpr(fwd)(params, x)

    def count_bf16_dots(closed):
        n = 0
        for eqn in closed.eqns:
            if eqn.primitive.name == "dot_general" and all(
                    v.aval.dtype == jnp.bfloat16 for v in eqn.invars):
                n += 1
            for p in eqn.params.values():
                inner = getattr(p, "jaxpr", None)
                if inner is not None:
                    n += count_bf16_dots(inner)
        return n

    assert count_bf16_dots(jaxpr.jaxpr) > 0


def test_compute_dtype_default_resolution(monkeypatch):
    """AUTO default: f32 on the CPU backend (this wheel cannot execute
    bf16 x bf16 → f32 dots), bf16 on accelerators — gated on the
    synthetic recipe's accuracy under bf16 (egs/synthetic/
    RESULT_PARITY.md).  Explicit config and the env var override both
    directions."""
    from lstm_ctc_tpu.models.blstm import _compute_dtype

    monkeypatch.delenv("LSTM_CTC_TPU_COMPUTE_DTYPE", raising=False)
    assert jax.default_backend() == "cpu"
    assert _compute_dtype({}) is None
    assert _compute_dtype({"compute_dtype": "bfloat16"}) == jnp.bfloat16
    assert _compute_dtype({"compute_dtype": "float32"}) == jnp.float32
    monkeypatch.setenv("LSTM_CTC_TPU_COMPUTE_DTYPE", "bf16")
    assert _compute_dtype({"compute_dtype": "float32"}) == jnp.bfloat16
    monkeypatch.setenv("LSTM_CTC_TPU_COMPUTE_DTYPE", "f32")
    assert _compute_dtype({"compute_dtype": "bfloat16"}) == jnp.float32


def test_compute_dtype_bfloat16_unidirectional_plumbing():
    """The config knob must reach the unidirectional families' cell
    matmuls too (lstm._scan_fn partials) — trace-level, as above."""
    config = dict(WSJ_LIKE_CONFIG, nnet_type="lstm", num_experts=0,
                  dropout_rate=1.0, compute_dtype="bfloat16")
    params, state = init_model(jax.random.PRNGKey(0), config)
    x = jnp.asarray(np.random.RandomState(0).randn(2, 8, 12), jnp.float32)

    def fwd(params, x):
        logits, _, _, _ = apply_model(params, state, x,
                                      jnp.array([8, 5]), config)
        return logits

    jaxpr = jax.make_jaxpr(fwd)(params, x)

    def count_bf16_dots(closed):
        n = 0
        for eqn in closed.eqns:
            if eqn.primitive.name == "dot_general" and all(
                    v.aval.dtype == jnp.bfloat16 for v in eqn.invars):
                n += 1
            for p in eqn.params.values():
                inner = getattr(p, "jaxpr", None)
                if inner is not None:
                    n += count_bf16_dots(inner)
        return n

    assert count_bf16_dots(jaxpr.jaxpr) > 0


def test_uniform_label_smoothing_reg():
    config = dict(WSJ_LIKE_CONFIG, uniform_label_sm=0.1)
    params, state = init_model(jax.random.PRNGKey(0), config)
    x = jnp.asarray(np.random.RandomState(0).randn(2, 8, 12), jnp.float32)
    _, _, reg, _ = apply_model(params, state, x, jnp.array([8, 8]), config)
    assert len(reg) == 1
    value, weight = reg[0]
    assert weight == 0.1
    assert np.isfinite(float(value)) and float(value) >= -1e-4


def test_unidirectional_lstm_and_cudnn_variants():
    for nnet_type, extra in [("lstm", {"use_bn": True}),
                             ("lstm", {}),
                             ("cudnnlstm", {})]:
        config = dict(WSJ_LIKE_CONFIG, nnet_type=nnet_type, **extra)
        params, state = init_model(jax.random.PRNGKey(0), config)
        x = jnp.asarray(np.random.RandomState(0).randn(2, 8, 12), jnp.float32)
        logits, _, _, new_state = apply_model(
            params, state, x, jnp.array([8, 6]), config, train=True,
            dropout_rng=jax.random.PRNGKey(1))
        assert logits.shape == (2, 8, 10)
        if extra.get("use_bn"):
            # running moments must move at train time
            assert not np.allclose(np.asarray(new_state["bn_in"]["mean"]), 0.0)


def test_dropout_train_vs_eval():
    config = dict(WSJ_LIKE_CONFIG, dropout_rate=0.5)
    params, state = init_model(jax.random.PRNGKey(0), config)
    x = jnp.asarray(np.random.RandomState(0).randn(2, 8, 12), jnp.float32)
    seq = jnp.array([8, 8])
    eval1, _, _, _ = apply_model(params, state, x, seq, config, train=False)
    eval2, _, _, _ = apply_model(params, state, x, seq, config, train=False)
    np.testing.assert_array_equal(np.asarray(eval1), np.asarray(eval2))
    tr1, _, _, _ = apply_model(params, state, x, seq, config, train=True,
                               dropout_rng=jax.random.PRNGKey(1))
    tr2, _, _, _ = apply_model(params, state, x, seq, config, train=True,
                               dropout_rng=jax.random.PRNGKey(2))
    assert not np.allclose(np.asarray(tr1), np.asarray(tr2))


def test_lstm_bn_fold_matches_materializing_path(monkeypatch):
    """LSTM_CTC_TPU_BN_FOLD=1 (train-mode BN folded into the next
    consumer's input weights, models/lstm._bn_fold_enabled) must match
    the materializing BN path: logits, running-moment updates, and
    parameter gradients — with dropout ACTIVE, so the fold path's RNG
    consumption order is pinned too.  Covers both head types (dense
    head folds the final affine into w/b; MoE head materializes it)."""
    for extra in ({}, {"num_experts": 3, "moe_temp": 10.0}):
        config = dict(WSJ_LIKE_CONFIG, nnet_type="lstm", use_bn=True,
                      dropout_rate=0.8, **extra)
        params, state = init_model(jax.random.PRNGKey(0), config)
        rs = np.random.RandomState(4)
        x = jnp.asarray(rs.randn(3, 10, 12), jnp.float32)
        seq = jnp.array([10, 7, 4])
        rng = jax.random.PRNGKey(5)

        def loss(p, fold):
            monkeypatch.setenv("LSTM_CTC_TPU_BN_FOLD",
                               "1" if fold else "0")
            logits, _, _, new_state = apply_model(
                p, state, x, seq, config, train=True, dropout_rng=rng)
            return jnp.sum(logits * logits), (logits, new_state)

        (v_ref, (lg_ref, st_ref)), g_ref = jax.value_and_grad(
            lambda p: loss(p, False), has_aux=True)(params)
        (v_fold, (lg_fold, st_fold)), g_fold = jax.value_and_grad(
            lambda p: loss(p, True), has_aux=True)(params)
        np.testing.assert_allclose(np.asarray(lg_fold),
                                   np.asarray(lg_ref),
                                   rtol=1e-4, atol=1e-5)
        for a, b in zip(jax.tree_util.tree_leaves(st_fold),
                        jax.tree_util.tree_leaves(st_ref)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-5, atol=1e-6)
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(g_fold),
                jax.tree_util.tree_leaves_with_path(g_ref)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-3, atol=2e-4,
                                       err_msg=str(path))
