"""Streaming inference must match the offline forward pass exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lstm_ctc_tpu.data.pipeline import splice_frames, subsample_frames
from lstm_ctc_tpu.models import apply_model, init_model
from lstm_ctc_tpu.models.streaming import StreamingSession

BASE_CONFIG = {
    "nnet_type": "lstm",
    "input_dim": 6,
    "left_context": 0,
    "right_context": 0,
    "subsample": 0,
    "num_layers": 2,
    "num_neurons": 16,
    "num_projects": 16,
    "num_targets": 7,
    "use_peepholes": True,
    "dropout_rate": 1.0,
    "num_experts": 0,
}


def offline_logits(params, state, config, raw):
    feats = splice_frames(raw, config["left_context"],
                          config["right_context"])
    feats = subsample_frames(feats, config["subsample"])
    logits, _, _, _ = apply_model(
        params, state, jnp.asarray(feats[None]),
        jnp.array([feats.shape[0]]), config, train=False)
    return np.asarray(logits)[0]


@pytest.mark.parametrize("config_update,chunk,feed", [
    ({}, 16, 13),
    ({"left_context": 1, "right_context": 1}, 8, 7),
    ({"left_context": 1, "right_context": 1, "subsample": 2}, 8, 5),
    ({"nnet_type": "cudnnlstm"}, 16, 9),
    ({"num_experts": 3}, 16, 11),
    ({"use_bn": True}, 16, 13),
])
def test_streaming_matches_offline(config_update, chunk, feed):
    config = dict(BASE_CONFIG, **config_update)
    params, state = init_model(jax.random.PRNGKey(0), config)
    if config_update.get("use_bn"):
        # non-trivial running moments so the folded BN affine matters
        rs = np.random.RandomState(7)
        for bn in list(state["bn"]) + [state["bn_in"]]:
            dim = bn["mean"].shape[0]
            bn["mean"] = jnp.asarray(rs.randn(dim) * 0.3, jnp.float32)
            bn["var"] = jnp.asarray(0.5 + rs.rand(dim), jnp.float32)
    raw = np.random.RandomState(1).randn(57, 6).astype(np.float32)

    ref = offline_logits(params, state, config, raw)

    session = StreamingSession(params, state, config, chunk_size=chunk)
    chunks = []
    for start in range(0, raw.shape[0], feed):
        chunks.append(session.process(raw[start:start + feed]))
    chunks.append(session.process(None, flush=True))
    got = np.concatenate(chunks, axis=0)

    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, atol=2e-4)


def test_streaming_rejects_blstm():
    config = dict(BASE_CONFIG, nnet_type="blstm")
    params, state = init_model(jax.random.PRNGKey(0), config)
    with pytest.raises(ValueError):
        StreamingSession(params, state, config)


@pytest.mark.slow
def test_streaming_forward_cli(tmp_path):
    """nnet-forward --streaming writes the same posteriors as the batched
    path (causal model with splice+subsample)."""
    import os
    import subprocess
    import sys

    from lstm_ctc_tpu import kaldi
    from lstm_ctc_tpu.data import RecordShardWriter
    from lstm_ctc_tpu.train.checkpoint import save_checkpoint

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    config = dict(BASE_CONFIG, nnet_type="lstm", left_context=1,
                  right_context=1, subsample=2)
    params, state = init_model(jax.random.PRNGKey(0), config)
    ckpt = str(tmp_path / "nnet.0")
    save_checkpoint(ckpt, params, state)

    cfg_path = tmp_path / "nnet.config"
    cfg_path.write_text("".join(
        "%s = %s\n" % (k, str(v).lower() if isinstance(v, bool) else v)
        for k, v in config.items()))

    rng = np.random.RandomState(0)
    scp = str(tmp_path / "r.scp")
    with RecordShardWriter(str(tmp_path / "r.rec")) as writer, \
            open(scp, "w") as scp_fh:
        for i in range(3):
            meta = writer.write("u%d" % i,
                                rng.randn(40 + i * 7, 6).astype(np.float32))
            scp_fh.write(meta.scp_line())

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)

    outs = {}
    for mode, flag in [("batch", "false"), ("stream", "true")]:
        ark = str(tmp_path / ("%s.ark" % mode))
        proc = subprocess.run(
            [sys.executable, os.path.join(repo, "bin", "nnet-forward.py"),
             scp, str(cfg_path), ckpt, "ark:" + ark,
             "--apply-log", "true", "--streaming", flag],
            capture_output=True, text=True, env=env, cwd=repo)
        assert proc.returncode == 0, proc.stderr[-1500:]
        outs[mode] = dict(
            kaldi.SequentialBaseFloatMatrixReader("ark:" + ark))
    for key in outs["batch"]:
        np.testing.assert_allclose(outs["stream"][key], outs["batch"][key],
                                   atol=2e-3)


@pytest.mark.parametrize("use_bn", [False, True])
def test_streaming_chunks_match_offline(use_bn):
    """Chunks of 11 raw frames through a 16-row session, with carried
    (c, h) states and, with use_bn, eval-mode BN between layers, match
    the offline forward."""
    config = dict(BASE_CONFIG, use_bn=use_bn)
    params, state = init_model(jax.random.PRNGKey(2), config)
    if use_bn:
        rs = np.random.RandomState(9)
        for bn in list(state["bn"]) + [state["bn_in"]]:
            dim = bn["mean"].shape[0]
            bn["mean"] = jnp.asarray(rs.randn(dim) * 0.3, jnp.float32)
            bn["var"] = jnp.asarray(0.5 + rs.rand(dim), jnp.float32)
    raw = np.random.RandomState(3).randn(41, 6).astype(np.float32)

    ref = offline_logits(params, state, config, raw)
    session = StreamingSession(params, state, config, chunk_size=16)
    chunks = []
    for start in range(0, raw.shape[0], 11):
        chunks.append(session.process(raw[start:start + 11]))
    chunks.append(session.process(None, flush=True))
    got = np.concatenate(chunks, axis=0)

    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-4)


def test_session_reset_reuses_compiled_step():
    """reset() clears per-utterance state while keeping the jitted chunk
    step — a reused session must match a fresh one exactly."""
    config = dict(BASE_CONFIG)
    params, state = init_model(jax.random.PRNGKey(4), config)
    raw1 = np.random.RandomState(5).randn(37, 6).astype(np.float32)
    raw2 = np.random.RandomState(6).randn(23, 6).astype(np.float32)

    shared = StreamingSession(params, state, config, chunk_size=16)
    out1 = shared.process(raw1, flush=True)
    shared.reset()
    out2 = shared.process(raw2, flush=True)

    fresh = StreamingSession(params, state, config, chunk_size=16)
    np.testing.assert_array_equal(out2, fresh.process(raw2, flush=True))
    assert out1.shape[0] == 37 and out2.shape[0] == 23
