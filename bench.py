#!/usr/bin/env python3
"""Benchmark: acoustic frames/s per card on the flagship WSJ BLSTM-CTC model.

Measures the full jitted training step (forward + CTC + backward + adam)
on the GPU JAX provides:

  * ``flagship_b32``     — B=32, T=384 unpacked
  * ``flagship_b64``     — B=64 unpacked
  * ``recipe_packed_pf3``— the SHIPPED recipe config (egs/wsj/
                           run_wsj_phn.sh:51 pack_factor=3): packed rows
                           via the real BucketedBatcher over a WSJ-like
                           length mix; its frames/s counts REAL acoustic
                           frames only (padding excluded), i.e. true
                           epoch throughput

plus the unidirectional families, the streaming chunk step and the
inference forward pass.  Each row carries an MFU estimate:
model-FLOPs/frame (analytic, 3× forward for fwd+bwd — the standard MFU
convention, which excludes remat recompute) × frames/s ÷ the card's
bf16 peak from ``PEAK_BF16_FLOPS``.

Prints cumulative JSON lines; the last one is the result.  ``value`` =
flagship B=32 train frames/s.  Without a GPU it exits non-zero;
``--smoke`` is the explicit CPU tier (tiny shapes, numbers meaningless,
MFU null).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

# Dense bf16 tensor-core peak per device kind, keyed by the exact
# ``jax.Device.device_kind``, with its source.
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": (
        989e12, "NVIDIA H100 SXM data sheet, dense BF16 (no sparsity)"),
}


def peak_bf16_flops(device_kind: str) -> float:
    """The card's bf16 peak; a kind not in the table is an error."""
    if device_kind not in PEAK_BF16_FLOPS:
        raise KeyError("no bf16 peak on record for device kind %r; add it "
                       "to PEAK_BF16_FLOPS with its source" % device_kind)
    return PEAK_BF16_FLOPS[device_kind][0]


def gpu_name_and_power_limit():
    """``name, power.limit`` of the cards as nvidia-smi reports them
    (one line per card), or None without nvidia-smi.  Runs in a child so
    the caller need not hold a JAX client."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def device_facts(jax):
    """What every result line says about where it ran."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": jax.device_count(),
            "name_power_limit": gpu_name_and_power_limit(),
            "xla_flags": os.environ.get("XLA_FLAGS", "")}


def model_fwd_flops_per_frame(config):
    """Analytic forward FLOPs per acoustic frame (matmuls only; 2·M·N·K
    per matmul).  BLSTM: per direction per layer, input proj D·4H,
    recurrent P·4H, projection H·P; unidirectional families: one
    direction, layer input = P; MoE head: gate 2P·E + experts
    2P·(E·V); dense head: head_in·V."""
    d_in = config["input_dim"] * (1 + config["left_context"]
                                  + config["right_context"])
    h = config["num_neurons"]
    p = config.get("num_projects") or h
    v = config["num_targets"]
    e = config.get("num_experts", 0) or 0
    layers = config["num_layers"]
    bidi = config.get("nnet_type", "blstm") == "blstm"
    ndir = 2 if bidi else 1
    head_in = (2 * p) if bidi else p

    def per_dir(d):
        f = 2 * d * 4 * h + 2 * p * 4 * h
        if config.get("num_projects"):
            f += 2 * h * p
        return f

    flops = ndir * per_dir(d_in)                    # layer 0
    flops += ndir * per_dir(head_in) * (layers - 1)  # stack
    if e > 0:
        flops += 2 * head_in * e + 2 * head_in * (e * v)
    else:
        flops += 2 * head_in * v
    return flops


STEPS = 30     # shrunk by --smoke


def _time_steps_loop(run_once, result, steps=None):
    """Steady-state seconds/step: one warm-up step (compile), then
    ``steps`` chained steps ended by ``block_until_ready`` on the last
    result."""
    steps = STEPS if steps is None else steps
    run_once()
    jax_block(result())
    t0 = time.perf_counter()
    for _ in range(steps):
        run_once()
    jax_block(result())
    return (time.perf_counter() - t0) / steps


def jax_block(x):
    import jax
    jax.block_until_ready(x)


def bench_unpacked(config, batch_size, time_steps, jax):
    from __graft_entry__ import _example_batch
    from lstm_ctc_tpu.train.graph import make_train_step
    from lstm_ctc_tpu.models import init_model

    batch = _example_batch(config, batch=batch_size, time_steps=time_steps)
    batch = {k: jax.device_put(v) for k, v in batch.items()}
    params0, net_state0 = init_model(jax.random.PRNGKey(0), config)
    init_opt, train_step = make_train_step(
        config, learn_rate=1e-3, optimizer="adam")
    rng = jax.random.PRNGKey(1)

    state = {}

    def reset():
        # train_step donates params/opt_state/net_state — re-put per run
        state["p"] = jax.device_put(params0)
        state["o"] = init_opt(state["p"])
        state["s"] = jax.device_put(net_state0)

    reset()

    def run_once():
        state["p"], state["o"], state["s"], state["m"] = train_step(
            state["p"], state["o"], state["s"], rng, batch)

    dt = _time_steps_loop(run_once, lambda: state["m"])
    return batch_size * time_steps / dt


def bench_packed(config, batch_size, pack_factor, jax, tiered=False):
    """Shipped recipe config: REAL frames/s over packed rows produced by
    the actual batcher (windowed best-fit) on a WSJ-like length mix."""
    from lstm_ctc_tpu.data.pipeline import BucketedBatcher
    from lstm_ctc_tpu.data.records import RecordMeta
    from lstm_ctc_tpu.train.graph import make_train_step
    from lstm_ctc_tpu.models import init_model

    # packed slots come from BucketedBatcher → declare the rank-major
    # contract (row-batched/tiered CTC gather, train/graph.py)
    config = dict(config, ctc_tiered_slots=tiered,
                  packed_slots_rank_major=True)
    rng_np = np.random.RandomState(0)
    # enough utterances for ~8 full batches — a B·pack_factor batch
    # consumes batch_size·pf utts, and a fixture smaller than a couple of
    # batches leaves the packer a degenerate tail (fill collapses)
    n_utts = max(512, 8 * batch_size * max(pack_factor or 1, 1))
    len_lo, len_hi = 200, 1152
    if _SMOKE:
        n_utts, (len_lo, len_hi) = 4 * batch_size, (30, 120)
    raw_dim = config["input_dim"]
    # WSJ-ish raw utterance lengths (10 ms frames, pre-subsample)
    lengths = rng_np.randint(len_lo, len_hi, size=n_utts)
    label_lens = np.maximum(2, lengths // 30)
    metas = [RecordMeta("u%03d" % i, int(t), raw_dim, True, "mem", i)
             for i, t in enumerate(lengths)]
    feats = {m.key: rng_np.randn(m.num_rows, raw_dim).astype(np.float32)
             for m in metas}
    labs = {m.key: rng_np.randint(
        0, config["num_targets"] - 1, label_lens[i]).astype(np.int32)
        for i, m in enumerate(metas)}

    class Loader:
        def load(self, meta):
            return meta.key, feats[meta.key], labs[meta.key]

        def close(self):
            pass

    batcher = BucketedBatcher(
        metas, batch_size=batch_size,
        left_context=config["left_context"],
        right_context=config["right_context"],
        subsample=config["subsample"],
        label_lengths=[len(labs[m.key]) for m in metas],
        pack_factor=pack_factor)
    loader = Loader()
    plan = batcher.batch_plan(shuffle=True, seed=0)
    batches = []
    real_frames = []
    for bucket_idx, rows in plan[:6]:
        b = batcher.assemble(bucket_idx, rows, loader)
        arrays = {
            "nnet_input": b.nnet_input,
            "sequence_length": b.sequence_length,
            "nnet_target": b.nnet_target,
            "target_length": b.target_length,
        }
        if (pack_factor or 1) > 1:
            arrays["reset_mask"] = b.reset_mask
            arrays["utt_time_index"] = b.utt_time_index
            arrays["utt_sequence_length"] = b.utt_sequence_length
            real = int(np.sum(b.utt_sequence_length))
        else:
            # unpacked control: one utterance per row
            real = int(np.sum(b.sequence_length))
        batches.append({k: jax.device_put(v) for k, v in arrays.items()})
        real_frames.append(real)
    # per-batch padded size: packed mode has one row shape, but the
    # unpacked control draws from multiple [B, T] buckets
    padded_frames = [b["nnet_input"].shape[0] * b["nnet_input"].shape[1]
                     for b in batches]
    fill = float(np.mean([f / p for f, p in zip(real_frames,
                                                padded_frames)]))

    params0, net_state0 = init_model(jax.random.PRNGKey(0), config)
    init_opt, train_step = make_train_step(
        config, learn_rate=1e-3, optimizer="adam")
    rng = jax.random.PRNGKey(1)
    state = {"p": jax.device_put(params0), "s": jax.device_put(net_state0)}
    state["o"] = init_opt(state["p"])

    def run_once(i=[0]):
        b = batches[i[0] % len(batches)]
        i[0] += 1
        state["p"], state["o"], state["s"], state["m"] = train_step(
            state["p"], state["o"], state["s"], rng, b)

    # warm EVERY bucket shape first — each distinct [B, T] compiles
    # separately, and a compile inside the timed loop would dominate it
    for _ in range(len(batches) - 1):
        run_once()

    dt = _time_steps_loop(run_once, lambda: state["m"],
                          steps=(5 if not _SMOKE else 2) * len(batches))
    mean_real = float(np.mean(real_frames))
    return mean_real / dt, fill


def bench_mesh(config, batch_per_device, time_steps, jax):
    """Data-parallel scaling row: the SAME jitted train step over a 1-D
    mesh of ALL local devices (parallel/mesh.py), batch sharded on the
    batch axis, params replicated — ``config["mesh"]`` runs the CTC
    kernels per shard under shard_map as nnet-train does.  Global batch
    = batch_per_device · n_devices; returns (global frames/s, n_devices).

    The row appears only when JAX reports more than one device (a
    multi-card host, or the CPU smoke tier under
    --xla_force_host_platform_device_count)."""
    from __graft_entry__ import _example_batch
    from lstm_ctc_tpu.models import init_model
    from lstm_ctc_tpu.parallel.mesh import (get_mesh, replicated_sharding,
                                            shard_batch)
    from lstm_ctc_tpu.train.graph import make_train_step

    mesh = get_mesh()
    n_dev = mesh.devices.size
    cfg = dict(config, mesh=mesh)
    global_batch = batch_per_device * n_dev
    batch = _example_batch(cfg, batch=global_batch, time_steps=time_steps)
    batch = shard_batch(mesh, batch)
    params0, net_state0 = init_model(jax.random.PRNGKey(0), cfg)
    init_opt, train_step = make_train_step(
        cfg, learn_rate=1e-3, optimizer="adam")
    rep = replicated_sharding(mesh)
    rng = jax.device_put(jax.random.PRNGKey(1), rep)
    state = {"p": jax.device_put(params0, rep),
             "s": jax.device_put(net_state0, rep)}
    state["o"] = init_opt(state["p"])

    def run_once():
        state["p"], state["o"], state["s"], state["m"] = train_step(
            state["p"], state["o"], state["s"], rng, batch)

    dt = _time_steps_loop(run_once, lambda: state["m"])
    return global_batch * time_steps / dt, n_dev


def bench_streaming(config, jax, chunk_rows=16):
    """Serving-latency row: one streaming chunk step of the causal
    ``lstm`` family (models/streaming.StreamingSession) at batch 1 with
    carried (c, h) states — the deployment mode the reference reserves
    the lstm/cudnnlstm families for (SURVEY §7 step 7).

    Chunks chain on-device through the carried states (the next chunk
    depends on the previous one's states), so the loop measures the
    per-chunk latency a serving process would see.  Returns (sec/chunk,
    audio seconds covered per chunk): chunk_rows model rows each cover
    ``subsample`` raw 10 ms frames."""
    from lstm_ctc_tpu.models import init_model
    from lstm_ctc_tpu.models.streaming import StreamingSession

    cfg = dict(config, nnet_type="lstm", use_peepholes=True,
               num_experts=0, use_bn=False, dropout_rate=1.0)
    cfg.pop("mesh", None)
    if not cfg.get("num_projects"):
        cfg["num_projects"] = cfg["num_neurons"]
    params, net_state = init_model(jax.random.PRNGKey(0), cfg)
    params = jax.device_put(params)
    sess = StreamingSession(params, net_state, cfg, chunk_size=chunk_rows)
    feat_dim = cfg["input_dim"] * (1 + cfg["left_context"]
                                   + cfg["right_context"])
    rng_np = np.random.RandomState(0)
    x = jax.device_put(
        rng_np.randn(1, chunk_rows, feat_dim).astype(np.float32))
    seq_len = jax.device_put(np.array([chunk_rows], np.int32))

    step = jax.jit(lambda st, xx: sess._model_chunk(
        params, net_state, st, xx, seq_len))
    state = {"s": sess._init_states()}
    out = {}

    def run_once():
        out["y"], state["s"] = step(state["s"], x)

    dt = _time_steps_loop(run_once, lambda: out["y"])
    audio_s = chunk_rows * max(cfg.get("subsample", 1) or 1, 1) * 0.01
    return dt, audio_s


_SMOKE = False


def main():
    import jax

    from __graft_entry__ import FLAGSHIP_CONFIG, _example_batch
    from lstm_ctc_tpu.cli import enable_compile_cache
    from lstm_ctc_tpu.models import apply_model, init_model

    enable_compile_cache()
    facts = device_facts(jax)
    if facts["platform"] != "gpu" and not _SMOKE:
        print("bench: no GPU (platform %r); --smoke is the CPU tier"
              % facts["platform"], file=sys.stderr)
        sys.exit(1)
    peak = None if _SMOKE else peak_bf16_flops(facts["kind"])

    t_start = time.monotonic()
    # soft deadline on SECONDARY rows: whatever completed is still
    # emitted as a full JSON line well inside the driver's window
    row_deadline = float(os.environ.get("LSTM_CTC_TPU_BENCH_DEADLINE",
                                        "2100"))

    config = dict(FLAGSHIP_CONFIG, dropout_rate=1.0)
    bench_b, bench_t = 32, 384
    if _SMOKE:
        # CI path: tiny shapes, every row exercised, numbers meaningless
        config.update(num_layers=2, num_neurons=16, num_projects=16,
                      num_experts=4)
        bench_b, bench_t = 4, 32
    fwd_flops = model_fwd_flops_per_frame(config)
    train_flops = 3 * fwd_flops

    def mfu(fps, flops=train_flops):
        return None if peak is None else round(fps * flops / peak, 4)

    rows = []
    # Built incrementally and re-emitted after every row: a mid-run kill
    # (driver timeout, backend wedge) still leaves the LAST stdout line a
    # complete, parsable JSON result covering everything that finished.
    result = {
        "metric": "train_frames_per_sec_per_chip",
        "value": None,
        "unit": "frames/s",
        "mfu": None,
        "configs": rows,
        "model_train_mflops_per_frame": round(train_flops / 1e6, 1),
        "mfu_peak_note": None if peak is None else (
            "MFU vs %s (%.0f TFLOP/s); counts useful fwd+bwd matmul "
            "FLOPs (3x fwd), excluding remat recompute"
            % (PEAK_BF16_FLOPS[facts["kind"]][1], peak / 1e12)),
        "forward_frames_per_sec": None,
        "device": facts,
    }

    def emit():
        print(json.dumps(result), flush=True)

    def try_row(label, fn):
        # a failing secondary row must not sink the whole benchmark,
        # and a slow bench must degrade to fewer rows, not to rc=124
        elapsed = time.monotonic() - t_start
        if elapsed > row_deadline:
            rows.append({"config": label,
                         "skipped": "bench deadline (%.0fs elapsed)"
                                    % elapsed})
        else:
            try:
                rows.append(fn())
            except Exception as exc:   # noqa: BLE001
                rows.append({"config": label, "error": str(exc)[:200]})
        emit()

    # the headline row runs un-guarded: without it there is no metric
    fps32 = bench_unpacked(config, bench_b, bench_t, jax)
    rows.append({"config": "flagship_b32_t384",
                 "frames_per_sec": round(fps32, 1), "mfu": mfu(fps32)})
    result["value"] = round(fps32, 1)
    result["mfu"] = mfu(fps32)
    emit()

    def row_b64():
        fps64 = bench_unpacked(config, 2 * bench_b, bench_t, jax)
        return {"config": "flagship_b64_t384",
                "frames_per_sec": round(fps64, 1), "mfu": mfu(fps64)}

    def row_packed():
        fps_packed, fill = bench_packed(config, bench_b, 3, jax)
        return {"config": "recipe_packed_pf3_b32",
                "frames_per_sec": round(fps_packed, 1),
                "mfu": mfu(fps_packed), "fill": round(fill, 3),
                "note": "REAL frames/s (padding excluded) — shipped "
                        "recipe config (egs/wsj/run_wsj_phn.sh "
                        "pack_factor=3)"}

    try_row("flagship_b64_t384", row_b64)
    try_row("recipe_packed_pf3_b32", row_packed)

    # DP over a device mesh — only when more than one device exists (CI
    # exercises this on a forced 8-device CPU mesh)
    if jax.device_count() > 1:
        def row_mesh():
            fps_mesh, n_dev = bench_mesh(config, bench_b, bench_t, jax)
            return {"config": "mesh_dp%d_b%dx%d_t384"
                              % (n_dev, bench_b, n_dev),
                    "frames_per_sec": round(fps_mesh, 1),
                    "frames_per_sec_per_chip": round(fps_mesh / n_dev, 1),
                    "mfu": mfu(fps_mesh / n_dev),
                    "note": "global frames/s over a %d-device DP mesh; "
                            "mfu is per chip" % n_dev}

        try_row("mesh_dp", row_mesh)

    # unidirectional families; lstm_bn adds train-mode batch-norm
    # between layers (folded into the next layer's input kernel,
    # models/lstm._bn_fold_enabled)
    def fam_row(label, fam, proj, peep, use_bn=False):
        if _SMOKE and proj:
            proj = config["num_projects"]
        fam_cfg = dict(config, nnet_type=fam, num_projects=proj,
                       use_peepholes=peep, num_experts=0,
                       use_bn=use_bn)
        fam_flops = 3 * model_fwd_flops_per_frame(fam_cfg)
        fps_fam = bench_unpacked(fam_cfg, bench_b, bench_t, jax)
        return {"config": "%s_b32_t384" % label,
                "frames_per_sec": round(fps_fam, 1),
                "mfu": mfu(fps_fam, fam_flops)}

    for label, fam, proj, peep, bn in (
            ("lstm", "lstm", 320, True, False),
            ("cudnnlstm", "cudnnlstm", None, False, False),
            ("lstm_bn", "lstm", 320, True, True)):
        try_row("%s_b32_t384" % label,
                lambda label=label, fam=fam, proj=proj, peep=peep, bn=bn:
                fam_row(label, fam, proj, peep, use_bn=bn))

    # --- streaming serving latency (causal lstm, batch 1) ---
    def row_streaming():
        chunk_rows = 4 if _SMOKE else 16
        dt, audio_s = bench_streaming(config, jax, chunk_rows=chunk_rows)
        return {"config": "streaming_lstm_b1_chunk%d" % chunk_rows,
                "ms_per_chunk": round(dt * 1e3, 3),
                "audio_s_per_chunk": round(audio_s, 3),
                # 4 decimals: a slow CPU smoke tier can land under 0.05,
                # which round(_, 1) would truncate to a spurious 0.0
                "real_time_factor": round(audio_s / dt, 4),
                "note": "device-side chunk-step latency of the causal "
                        "serving path (carried states, batch 1); RTF = "
                        "audio seconds per chunk / latency"}

    try_row("streaming_lstm_b1", row_streaming)

    # --- forward (inference) ---
    params, net_state = init_model(jax.random.PRNGKey(0), config)
    batch = _example_batch(config, batch=bench_b, time_steps=bench_t)
    batch = {k: jax.device_put(v) for k, v in batch.items()}

    @jax.jit
    def forward(params, nnet_input, sequence_length):
        logits, _, _, _ = apply_model(
            params, net_state, nnet_input, sequence_length, config,
            train=False)
        return logits

    fwd_out = {}

    def run_fwd():
        fwd_out["o"] = forward(params, batch["nnet_input"],
                               batch["sequence_length"])

    try:
        fwd_dt = _time_steps_loop(run_fwd, lambda: fwd_out["o"])
        result["forward_frames_per_sec"] = round(
            bench_b * bench_t / fwd_dt, 1)
    except Exception as exc:   # noqa: BLE001
        rows.append({"config": "forward_b32_t384",
                     "error": str(exc)[:200]})
    result["peak_bytes_in_use"] = (
        jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    emit()


if __name__ == "__main__":
    if "--smoke" in sys.argv:
        _SMOKE = True
        STEPS = 3
    main()
