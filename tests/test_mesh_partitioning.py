"""Multi-device mesh partitioning of the data-parallel train step.

On the 8-virtual-device CPU mesh these tests certify:

  * loss and updated-parameter parity of the mesh train step vs the
    same step on one device;
  * the compiled mesh train step contains NO all-gather of the
    batch-sharded MoE input, CTC lattice or logits (HLO inspection — the
    failure mode a numeric test cannot catch);
  * the CTC alpha/beta kernels run per shard under shard_map
    (ops/ctc._make_ctc_core) and equal the scan recursion.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from __graft_entry__ import FLAGSHIP_CONFIG, _example_batch
from lstm_ctc_tpu.models import init_model
from lstm_ctc_tpu.train.graph import make_train_step

N_DEV = 8


def _mesh():
    devs = jax.devices("cpu")
    assert len(devs) >= N_DEV
    return Mesh(np.asarray(devs[:N_DEV]), ("data",))


def _tiny_config(**over):
    cfg = dict(FLAGSHIP_CONFIG, num_layers=2, num_neurons=16,
               num_projects=16, num_experts=4, dropout_rate=1.0)
    cfg.update(over)
    return cfg


def _step_args(config, mesh=None, batch_size=2 * N_DEV):
    batch = _example_batch(config, batch=batch_size, time_steps=16)
    if mesh is not None:
        sh = NamedSharding(mesh, P("data"))
        batch = {k: jax.device_put(v, sh) for k, v in batch.items()}
    params, net_state = init_model(jax.random.PRNGKey(0), config)
    init_opt, train_step = make_train_step(
        config, learn_rate=1e-3, optimizer="adam")
    opt_state = init_opt(params)
    if mesh is not None:
        rep = NamedSharding(mesh, P())
        params = jax.device_put(params, rep)
        opt_state = jax.device_put(opt_state, rep)
        net_state = jax.device_put(net_state, rep)
    return train_step, (params, opt_state, net_state,
                        jax.random.PRNGKey(1), batch)


def test_mesh_step_matches_single_device():
    """Full train step (model, CTC, backward, adam) over the mesh agrees
    with the single-device step on loss AND on the updated parameters."""
    config = _tiny_config()
    step, args = _step_args(config)
    p_ref, _, _, m_ref = step(*args)

    mesh = _mesh()
    step_m, args_m = _step_args(dict(config, mesh=mesh), mesh=mesh)
    p_got, _, _, m_got = step_m(*args_m)

    np.testing.assert_allclose(float(m_got["eval_loss"]),
                               float(m_ref["eval_loss"]),
                               rtol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(p_ref),
                    jax.tree_util.tree_leaves(p_got)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-3, atol=5e-5)


def _collect_allgather_bytes(hlo_text):
    """Byte sizes of every all-gather result in a compiled HLO dump."""
    import re
    sizes = []
    for line in hlo_text.splitlines():
        if "all-gather" not in line:
            continue
        m = re.search(r"=\s*((?:\([^)]*\))|(?:\S+))\s*all-gather", line)
        if not m:
            continue
        shapes = re.findall(r"([a-z0-9]+)\[([0-9,]*)\]", m.group(1))
        total = 0
        for dtype, dims in shapes:
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            width = {"f32": 4, "s32": 4, "u32": 4, "bf16": 2, "f16": 2,
                     "pred": 1, "s8": 1, "u8": 1, "f64": 8, "s64": 8,
                     "u64": 8}.get(dtype, 4)
            total += n * width
        sizes.append(total)
    return sizes


def test_compiled_mesh_step_has_no_batch_allgather():
    """The compiled mesh train step must not all-gather the
    batch-sharded MoE input / CTC lattice: gradient sync is all-reduce,
    and every big per-batch operand stays sharded end-to-end.  This
    catches any sharding-annotation regression that makes GSPMD gather a
    batch-sharded operand (specs dropped, batch replicated into the
    step)."""
    mesh = _mesh()
    config = _tiny_config(mesh=mesh)
    step, args = _step_args(config, mesh=mesh)
    compiled = step.lower(*args).compile()
    text = "\n".join(m.to_string() for m in compiled.runtime_executable()
                     .hlo_modules()) if hasattr(
        compiled, "runtime_executable") else compiled.as_text()
    sizes = _collect_allgather_bytes(text)
    # the sharded MoE input is [B·T, 2P] f32 = 16·16·32·4 = 32 KiB and
    # the CTC lattice [T, B, S] = 16·16·17·4 ≈ 17 KiB; any all-gather
    # that big means a batch-sharded operand was replicated
    batch, t, s = 2 * N_DEV, 16, 2 * 8 + 1
    moe_bytes = batch * t * 32 * 4
    lattice_bytes = t * batch * s * 4
    limit = min(moe_bytes, lattice_bytes) // 2
    big = [sz for sz in sizes if sz >= limit]
    assert not big, ("compiled mesh step all-gathers %r bytes — a "
                     "batch-sharded operand was replicated"
                     % big)


def test_compiled_packed_mesh_step_has_no_batch_allgather():
    """PACKED rows under the mesh: the per-utterance CTC view is built
    as a row-batched take_along_axis (train/graph.compute_losses), so
    GSPMD keeps the [B,T,V] logits and the [N,T_u,V] view partitioned
    on the batch axis — the flat [B·T] gather this replaced forced an
    all-gather of the full logits.  Only the tiny per-slot label arrays
    may move."""
    from __graft_entry__ import _packed_batch

    mesh = _mesh()
    config = _tiny_config(mesh=mesh)
    batch = _packed_batch(config, num_rows=2 * N_DEV, pack_factor=2)
    sh = NamedSharding(mesh, P("data"))
    batch = {k: jax.device_put(v, sh) for k, v in batch.items()}
    params, net_state = init_model(jax.random.PRNGKey(0), config)
    init_opt, train_step = make_train_step(
        config, learn_rate=1e-3, optimizer="adam")
    rep = NamedSharding(mesh, P())
    params = jax.device_put(params, rep)
    opt_state = jax.device_put(init_opt(params), rep)
    net_state = jax.device_put(net_state, rep)
    compiled = train_step.lower(params, opt_state, net_state,
                                jax.random.PRNGKey(1), batch).compile()
    text = "\n".join(m.to_string() for m in compiled.runtime_executable()
                     .hlo_modules()) if hasattr(
        compiled, "runtime_executable") else compiled.as_text()
    sizes = _collect_allgather_bytes(text)
    num_rows, row_t = batch["nnet_input"].shape[0], \
        batch["utt_time_index"].shape[1]
    vocab = config["num_targets"]
    # gathering the per-utterance view on replicated logits would move
    # ≥ the f32 logits [B, T, V]; anything that big is a regression
    limit = num_rows * row_t * vocab * 4 // 2
    big = [sz for sz in sizes if sz >= limit]
    assert not big, ("compiled packed mesh step all-gathers %r bytes — "
                     "the per-utterance CTC gather lost its row-batched "
                     "form" % big)


def test_ctc_mesh_pallas_matches_scan():
    """ctc_loss(mesh=...) with the kernels (Pallas interpreter): per-shard
    DP under shard_map must equal the scan CTC — values and gradients."""
    from lstm_ctc_tpu.ops.ctc import ctc_loss

    rs = np.random.RandomState(9)
    b, t, v, u = 16, 12, 7, 3
    logits = jnp.asarray(rs.randn(b, t, v), jnp.float32)
    seq_len = jnp.asarray(rs.randint(u + 2, t + 1, b), jnp.int32)
    labels = jnp.asarray(rs.randint(0, v - 1, (b, u)), jnp.int32)
    lab_len = jnp.asarray(rs.randint(1, u + 1, b), jnp.int32)
    labels = jnp.where(jnp.arange(u)[None, :] < lab_len[:, None],
                       labels, -1)

    want = ctc_loss(logits, seq_len, labels, lab_len)
    want_g = jax.grad(lambda lg: jnp.sum(
        ctc_loss(lg, seq_len, labels, lab_len)))(logits)

    mesh = _mesh()
    kw = dict(mesh=mesh, interpret=True)
    got = ctc_loss(logits, seq_len, labels, lab_len, **kw)
    got_g = jax.grad(lambda lg: jnp.sum(
        ctc_loss(lg, seq_len, labels, lab_len, **kw)))(logits)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_g), np.asarray(want_g),
                               rtol=1e-5, atol=1e-5)


def test_ctc_mesh_indivisible_batch_falls_back():
    """A batch the mesh size does not divide takes the scan (the kernel
    runs per shard) and is still correct."""
    from lstm_ctc_tpu.ops.ctc import ctc_loss, dp_impl

    rs = np.random.RandomState(11)
    b, t, v, u = 6, 10, 5, 2       # 6 % 8 != 0
    logits = jnp.asarray(rs.randn(b, t, v), jnp.float32)
    seq_len = jnp.full((b,), t, jnp.int32)
    labels = jnp.asarray(rs.randint(0, v - 1, (b, u)), jnp.int32)
    lab_len = jnp.full((b,), u, jnp.int32)

    assert dp_impl(_mesh(), b, 2 * u + 1, interpret=True) == "scan"
    assert dp_impl(_mesh(), 16, 2 * u + 1, interpret=True) == "kernel"
    want = ctc_loss(logits, seq_len, labels, lab_len)
    got = ctc_loss(logits, seq_len, labels, lab_len, mesh=_mesh(),
                   interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_compiled_tiered_packed_mesh_step_has_no_batch_allgather(
        monkeypatch):
    """The OPT-IN tiered CTC gather under the mesh: each rank tier's
    take_along_axis runs per-shard under shard_map like the full-width
    branch, so enabling LSTM_CTC_TPU_CTC_TIERED on a mesh does not
    reintroduce the [B,T,V] logits all-gather."""
    from __graft_entry__ import _packed_batch

    monkeypatch.setenv("LSTM_CTC_TPU_CTC_TIERED", "1")
    mesh = _mesh()
    config = _tiny_config(mesh=mesh)
    batch = _packed_batch(config, num_rows=2 * N_DEV, pack_factor=2)
    sh = NamedSharding(mesh, P("data"))
    batch = {k: jax.device_put(v, sh) for k, v in batch.items()}
    params, net_state = init_model(jax.random.PRNGKey(0), config)
    init_opt, train_step = make_train_step(
        config, learn_rate=1e-3, optimizer="adam")
    rep = NamedSharding(mesh, P())
    params = jax.device_put(params, rep)
    opt_state = jax.device_put(init_opt(params), rep)
    net_state = jax.device_put(net_state, rep)
    compiled = train_step.lower(params, opt_state, net_state,
                                jax.random.PRNGKey(1), batch).compile()
    text = "\n".join(m.to_string() for m in compiled.runtime_executable()
                     .hlo_modules()) if hasattr(
        compiled, "runtime_executable") else compiled.as_text()
    sizes = _collect_allgather_bytes(text)
    num_rows, row_t = batch["nnet_input"].shape[0], \
        batch["utt_time_index"].shape[1]
    vocab = config["num_targets"]
    limit = num_rows * row_t * vocab * 4 // 2
    big = [sz for sz in sizes if sz >= limit]
    assert not big, ("compiled TIERED packed mesh step all-gathers %r "
                     "bytes — a tier gather lost its shard_map form"
                     % big)


def test_tiered_mesh_gather_matches_full_width():
    """Numeric parity of the shard_map'd tier gathers: tiered loss on
    the mesh == full-width loss without one (same batch, params)."""
    from __graft_entry__ import _packed_batch
    from lstm_ctc_tpu.train.graph import compute_losses

    mesh = _mesh()
    config = _tiny_config()
    batch = _packed_batch(config, num_rows=2 * N_DEV, pack_factor=2)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    params, net_state = init_model(jax.random.PRNGKey(2), config)

    want, _, _ = compute_losses(params, net_state, batch, config,
                                train=False)
    got, _, _ = compute_losses(
        params, net_state, batch,
        dict(config, mesh=mesh, ctc_tiered_slots=True), train=False)
    np.testing.assert_allclose(float(got["eval_loss"]),
                               float(want["eval_loss"]), rtol=1e-5)


def test_undeclared_packed_contract_warns_on_mesh(monkeypatch):
    """A packed batch whose config does NOT declare the rank-major slot
    contract, on a multi-device mesh, must take the flat gather AND emit
    the one-time replication warning — and the loss
    must still be correct."""
    import warnings as _warnings

    import lstm_ctc_tpu.train.graph as graph_mod
    from __graft_entry__ import _packed_batch
    from lstm_ctc_tpu.train.graph import compute_losses

    monkeypatch.setattr(graph_mod, "_warned_flat_packed_gather", False)
    mesh = _mesh()
    config = _tiny_config()
    batch = _packed_batch(config, num_rows=2 * N_DEV, pack_factor=2)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    params, net_state = init_model(jax.random.PRNGKey(2), config)
    declared, _, _ = compute_losses(
        params, net_state, batch, dict(config, mesh=mesh), train=False)

    undeclared = dict(config, mesh=mesh)
    undeclared.pop("packed_slots_rank_major", None)
    with pytest.warns(UserWarning, match="rank-major"):
        got, _, _ = compute_losses(params, net_state, batch, undeclared,
                                   train=False)
    np.testing.assert_allclose(float(got["eval_loss"]),
                               float(declared["eval_loss"]), rtol=1e-5)
    # one-time: a second trace stays silent (filter ONLY the gather
    # warning — an unrelated dependency warning must not fail this)
    with _warnings.catch_warnings():
        _warnings.filterwarnings("error", message=".*rank-major.*",
                                 category=UserWarning)
        compute_losses(params, net_state, batch, undeclared, train=False)


def test_tiered_gather_warns_when_mesh_indivisible(monkeypatch):
    """The opt-in tiered gather silently rode GSPMD (re-introducing the
    logits all-gather) when the rows did not divide the mesh; it must
    now say so once at trace time — correctness is unchanged."""
    import lstm_ctc_tpu.train.graph as graph_mod
    from __graft_entry__ import _packed_batch
    from lstm_ctc_tpu.train.graph import compute_losses

    monkeypatch.setattr(graph_mod, "_warned_tiered_unsharded", False)
    mesh = _mesh()
    config = _tiny_config()
    batch = _packed_batch(config, num_rows=N_DEV + 1, pack_factor=2)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    params, net_state = init_model(jax.random.PRNGKey(3), config)
    tiered = dict(config, mesh=mesh, ctc_tiered_slots=True)
    with pytest.warns(UserWarning, match="un-shard_mapped"):
        got, _, _ = compute_losses(params, net_state, batch, tiered,
                                   train=False)
    want, _, _ = compute_losses(params, net_state, batch,
                                dict(config, ctc_tiered_slots=True),
                                train=False)
    np.testing.assert_allclose(float(got["eval_loss"]),
                               float(want["eval_loss"]), rtol=1e-5)
