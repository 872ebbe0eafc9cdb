"""Data-parallel correctness on a virtual 8-device CPU mesh: the sharded
train step must produce the same losses and parameters as single-device
execution."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from lstm_ctc_tpu.models import init_model
from lstm_ctc_tpu.parallel import batch_sharding, get_mesh, shard_batch
from lstm_ctc_tpu.train.graph import make_train_step

CONFIG = {
    "nnet_type": "blstm",
    "input_dim": 6,
    "left_context": 0,
    "right_context": 0,
    "subsample": 0,
    "num_layers": 1,
    "num_neurons": 12,
    "num_projects": 6,
    "num_targets": 5,
    "use_peepholes": True,
    "dropout_rate": 1.0,
    "num_experts": 0,
}


def make_batch(batch=16, time=10):
    rng = np.random.RandomState(0)
    labels = np.full((batch, 3), -1, np.int32)
    tgt_len = np.zeros((batch,), np.int32)
    for b in range(batch):
        u = rng.randint(1, 4)
        labels[b, :u] = rng.randint(0, 4, u)
        tgt_len[b] = u
    return {
        "nnet_input": rng.randn(batch, time, 6).astype(np.float32),
        "sequence_length": np.full((batch,), time, np.int32),
        "nnet_target": labels,
        "target_length": tgt_len,
    }


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8
    mesh = get_mesh()
    assert mesh.devices.size == 8


def test_sharded_step_matches_single_device():
    mesh = get_mesh()
    batch = make_batch()
    params, net_state = init_model(jax.random.PRNGKey(0), CONFIG)
    init_opt, train_step = make_train_step(CONFIG, learn_rate=1e-2,
                                           optimizer="adam")
    rng = jax.random.PRNGKey(7)

    # single-device run (deep copies: the train step donates its inputs)
    params = jax.tree.map(np.asarray, params)
    p1 = jax.device_put(params, jax.devices()[0])
    o1 = init_opt(p1)
    s1 = jax.device_put(net_state, jax.devices()[0])
    for _ in range(3):
        p1, o1, s1, m1 = train_step(p1, o1, s1, rng, {
            k: jax.device_put(v, jax.devices()[0])
            for k, v in batch.items()})

    # sharded run: batch split over the 8-way data mesh
    replicated = NamedSharding(mesh, P())
    p2 = jax.device_put(params, replicated)
    o2 = init_opt(p2)
    s2 = jax.device_put(net_state, replicated)
    for _ in range(3):
        device_batch = shard_batch(mesh, batch)
        assert device_batch["nnet_input"].sharding.spec == P("data")
        p2, o2, s2, m2 = train_step(p2, o2, s2,
                                    jax.device_put(rng, replicated),
                                    device_batch)

    np.testing.assert_allclose(float(m1["eval_loss"]),
                               float(m2["eval_loss"]), rtol=1e-5)
    assert int(m1["size"]) == int(m2["size"])
    for (path1, leaf1), (path2, leaf2) in zip(
            jax.tree_util.tree_leaves_with_path(p1),
            jax.tree_util.tree_leaves_with_path(p2)):
        np.testing.assert_allclose(np.asarray(leaf1), np.asarray(leaf2),
                                   atol=1e-5)


def test_indivisible_batch_replicates():
    mesh = get_mesh()
    batch = make_batch(batch=10)  # 10 % 8 != 0
    device_batch = shard_batch(mesh, batch)
    assert device_batch["nnet_input"].sharding.spec == P()


@pytest.mark.parametrize("family", [
    {"nnet_type": "lstm", "num_neurons": 12, "num_projects": 6},
    {"nnet_type": "lstm", "num_layers": 3, "num_neurons": 16,
     "num_projects": 8, "use_bn": True},
    {"nnet_type": "cudnnlstm", "num_neurons": 12, "num_projects": 0,
     "use_peepholes": False},
], ids=["lstm", "lstm_bn_3layer", "cudnnlstm"])
def test_sharded_unidirectional_step_matches_single_device(family):
    """The unidirectional families' DP train step on the mesh equals the
    single-device step: same loss, same updated params (two steps)."""
    mesh = get_mesh()
    config = dict(CONFIG, mesh=mesh, **family)
    batch = make_batch()
    params, net_state = init_model(jax.random.PRNGKey(3), config)
    params = jax.tree.map(np.asarray, params)
    net_state = jax.tree.map(np.asarray, net_state)
    rng = jax.random.PRNGKey(9)

    def run(sharding, put_batch):
        init_opt, train_step = make_train_step(config, learn_rate=1e-2,
                                               optimizer="adam")
        p = jax.device_put(params, sharding)
        o = init_opt(p)
        s = jax.device_put(net_state, sharding)
        for _ in range(2):
            p, o, s, m = train_step(p, o, s, jax.device_put(rng, sharding),
                                    put_batch(batch))
        return p, m

    one = jax.devices()[0]
    p_one, m_one = run(one, lambda b: jax.device_put(b, one))
    p_dp, m_dp = run(NamedSharding(mesh, P()),
                     lambda b: shard_batch(mesh, b))
    np.testing.assert_allclose(float(m_dp["eval_loss"]),
                               float(m_one["eval_loss"]), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(p_one),
                    jax.tree_util.tree_leaves(p_dp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2e-5)
