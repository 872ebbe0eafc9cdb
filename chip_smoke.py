#!/usr/bin/env python3
"""Bring-up smoke test of the flagship training path on one GPU.

Drives the WSJ treatment model (4 residual BLSTM layers of 320 cells,
projection 320, peepholes; 40-d fbank spliced ±1, subsample 3; MoE head of
72 experts over 72 targets) through the entry points a user calls, with
random weights made from a seed:

  1. device   — the platform must be a GPU (no CPU fallback); prints the
                card, its power limit, the JAX version and XLA_FLAGS;
  2. CLIs     — bin/convert-to-records.py, nnet-init.py, nnet-train.py
                (3 batches of 32, adam) and nnet-forward.py, once unpacked
                and once with --pack-factor 3; every tr_loss finite, the
                parameters moved, every posterior row a log-distribution;
  3. parity   — loss (B=32, T=384) and gradients (B=32, T=16) of the
                shipped bf16 default against a float32 reference under
                matmul precision "highest";
  4. CTC      — the Pallas CTC kernels against the lax.scan recursion,
                and the flagship train step with each;
  5. timing   — flagship step time and frames/s, compile times (first
                and rebuilt from the persistent cache) and peak device
                memory (bring-up figures, not a benchmark).

``--four`` runs only the data-parallel path on four cards.  The CLIs run
in this process (one JAX process owns the card).  The last line of
stdout is the JSON result; any failure exits non-zero before it.

    python chip_smoke.py            # one card
    python chip_smoke.py --four     # four cards, data-parallel only
"""

import argparse
import contextlib
import json
import os
import runpy
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Labels per raw 10 ms frame: about one phone per 90 ms of read speech.
RAW_FRAMES_PER_LABEL = 9
FLAGSHIP_B, FLAGSHIP_T = 32, 384

# bf16 matmul operands (f32 accumulation) against the f32 "highest"
# reference.  Loss: bf16 keeps 8 mantissa bits, so each product carries
# ~2^-9 relative error; summed over thousands of random-sign terms it
# largely cancels, and 2e-2 of the summed CTC loss bounds it with room.
LOSS_RTOL = 2e-2
# Gradients.  At random init on white-noise features the 4-layer stack is
# chaotic: a perturbation of the forward pass grows with time and depth
# (float32 vs float64 logits: 6.5e-7 relative at T=16, 4.7e-4 at T=384;
# bf16-rounded weights: 7e-3 at T=16, 0.78 at T=384 — CPU, B=2).  At
# T=384 the bf16 and TF32 gradients are therefore uncorrelated with the
# reference whatever the code does; they are printed, not bounded.  The
# bound applies to a window of PARITY_SHORT_T rows at full width, where
# bf16-rounded weights alone move the whole gradient by 1e-2 (CPU, B=32):
# 1e-1 leaves room for the per-step rounding of activations and still
# fails a wrong cast or a dropped term, which move it to order 1.
GRAD_RTOL = 1e-1
PARITY_SHORT_T = 16
# CTC kernel against the scan at "highest": same f32 arithmetic in the
# same order per lattice cell, so only the log/exp implementations differ.
CTC_LOSS_RTOL = 1e-5
CTC_GRAD_ATOL = 1e-5
# Four cards against one: per-row math is identical, but the gradient
# all-reduce sums in another order and bf16 GEMMs of other shapes may
# take other cuBLAS algorithms.
DP_LOSS_RTOL = 1e-3
DP_UPDATE_RTOL = 2e-2


def say(*args):
    print(*args, flush=True)


def flagship_config():
    from __graft_entry__ import FLAGSHIP_CONFIG
    return {k: v for k, v in FLAGSHIP_CONFIG.items()
            if k != "packed_slots_rank_major"}


# ---------------------------------------------------------------- phase 1
def check_device(jax, want_count=1):
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit("chip_smoke: no GPU (platform %r)" % dev.platform)
    if jax.device_count() < want_count:
        raise SystemExit("chip_smoke: need %d GPUs, found %d"
                         % (want_count, jax.device_count()))
    say("device: platform=%s kind=%s count=%d"
        % (dev.platform, dev.device_kind, jax.device_count()))
    say("jax %s  XLA_FLAGS=%r" % (jax.__version__,
                                  os.environ.get("XLA_FLAGS", "")))
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": jax.device_count()}


def result_line(facts):
    """The last line of stdout: what ran, on which device."""
    return json.dumps({"ok": True, "device": facts})


def print_card():
    from bench import gpu_name_and_power_limit
    say("nvidia-smi name, power.limit: %s" % gpu_name_and_power_limit())


# ---------------------------------------------------------------- phase 2
def make_corpus(workdir, name, num_utts, len_range, config, seed):
    """Random fbank-like features and labels at one label per
    RAW_FRAMES_PER_LABEL raw frames, as Kaldi archives → records scp."""
    from lstm_ctc_tpu import kaldi
    rng = np.random.RandomState(seed)
    feats_ark = os.path.join(workdir, name + "_feats.ark")
    labels_ark = os.path.join(workdir, name + "_labels.ark")
    with kaldi.BaseFloatMatrixWriter("ark:" + feats_ark) as fw, \
            kaldi.Int32VectorWriter("ark:" + labels_ark) as lw:
        for i in range(num_utts):
            frames = rng.randint(len_range[0], len_range[1] + 1)
            key = "%s_%04d" % (name, i)
            fw.Write(key, rng.randn(frames, config["input_dim"])
                     .astype(np.float32))
            lw.Write(key, rng.randint(
                0, config["num_targets"] - 1,
                max(1, frames // RAW_FRAMES_PER_LABEL)).astype(np.int32))
    scp = os.path.join(workdir, name + ".scp")
    run_cli("convert-to-records.py",
            ["ark:" + feats_ark, os.path.join(workdir, name), scp,
             "--nnet-target", "ark:" + labels_ark])
    return scp


def run_cli(script, argv):
    """Run a bin/ CLI in this process, as ``python bin/<script> argv``."""
    path = os.path.join(REPO, "bin", script)
    saved = sys.argv
    sys.argv = [path] + list(argv)
    try:
        runpy.run_path(path, run_name="__main__")
    except SystemExit as exc:
        if exc.code not in (None, 0):
            raise RuntimeError("%s exited with %r" % (script, exc.code))
    finally:
        sys.argv = saved


def write_config(path, config):
    from lstm_ctc_tpu.config import format_config
    with open(path, "w") as fh:
        fh.write(format_config(config))


def load_params(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files if k.startswith("params/")}


def train_through_clis(workdir, config, scp, batch_size, pack_factor,
                       min_steps=3, label="", nnet0=None, forward_scp=None):
    """nnet-init → nnet-train → nnet-forward on ``scp``; returns a dict of
    what the run showed.  Raises on any broken expectation.  ``nnet0``
    starts from an existing model instead of nnet-init; ``forward_scp``
    runs nnet-forward on other records than ``scp``."""
    from lstm_ctc_tpu import kaldi
    from lstm_ctc_tpu.data import scan_scp
    from lstm_ctc_tpu.data.pipeline import output_length
    cfg_path = os.path.join(workdir, "nnet%s.config" % label)
    write_config(cfg_path, config)
    nnet1 = os.path.join(workdir, "nnet%s.1" % label)
    metrics = os.path.join(workdir, "train%s.jsonl" % label)
    if nnet0 is None:
        nnet0 = os.path.join(workdir, "nnet%s.0" % label)
        run_cli("nnet-init.py", [scp, cfg_path, nnet0, "--objective", "ctc",
                                 "--batch-size", str(batch_size)])
    t0 = time.perf_counter()
    run_cli("nnet-train.py", [scp, cfg_path, nnet0, nnet1,
                              "--objective", "ctc", "--optimizer", "adam",
                              "--learn-rate", "0.0005",
                              "--batch-size", str(batch_size),
                              "--pack-factor", str(pack_factor),
                              "--metrics-file", metrics])
    train_s = time.perf_counter() - t0
    steps = [json.loads(line) for line in open(metrics)]
    losses = [s["loss"] for s in steps] + [s["batch_loss"] for s in steps]
    if len(steps) < min_steps:
        raise AssertionError("nnet-train ran %d batches, want >= %d"
                             % (len(steps), min_steps))
    if not np.all(np.isfinite(losses)):
        raise AssertionError("non-finite tr_loss: %r" % losses)
    before, after = load_params(nnet0), load_params(nnet1)
    moved = sum(not np.array_equal(before[k], after[k]) for k in before)
    if moved != len(before):
        raise AssertionError("%d of %d parameter arrays unchanged"
                             % (len(before) - moved, len(before)))

    post = os.path.join(workdir, "post%s.ark" % label)
    scp = forward_scp or scp
    run_cli("nnet-forward.py", [scp, cfg_path, nnet1, "ark:" + post,
                                "--apply-log", "true",
                                "--batch-size", str(batch_size)])
    posts = dict(kaldi.SequentialBaseFloatMatrixReader("ark:" + post))
    want = {m.key: (output_length(m.num_rows, config["subsample"]),
                    config["num_targets"]) for m in scan_scp(scp)}
    if sorted(posts) != sorted(want):
        raise AssertionError("forward wrote %d of %d utterances"
                             % (len(posts), len(want)))
    for key, mat in posts.items():
        if mat.shape != want[key]:
            raise AssertionError("posterior %s has shape %s, want %s"
                                 % (key, mat.shape, want[key]))
        row_mass = np.exp(mat.astype(np.float64)).sum(axis=1)
        if not np.allclose(row_mass, 1.0, atol=1e-3):
            raise AssertionError("posterior rows of %s are not "
                                 "log-distributions" % key)
    return {"steps": len(steps), "tr_loss": steps[-1]["loss"],
            "train_seconds": round(train_s, 2),
            "utterances": len(posts)}


# ---------------------------------------------------------------- phase 3
def flagship_batch(config, batch=None, time_steps=None):
    from __graft_entry__ import _example_batch
    batch = batch or FLAGSHIP_B
    time_steps = time_steps or FLAGSHIP_T
    labels = time_steps * max(config.get("subsample", 1) or 1, 1) \
        // RAW_FRAMES_PER_LABEL
    return _example_batch(config, batch=batch, time_steps=time_steps,
                          num_labels=labels)


def _flat(tree):
    import jax
    import jax.numpy as jnp
    return jnp.concatenate([jnp.ravel(x).astype(jnp.float32)
                            for x in jax.tree.leaves(tree)])


def loss_and_grad(jax, params, net_state, batch, config):
    from lstm_ctc_tpu.train.graph import compute_losses
    fn = jax.jit(jax.value_and_grad(lambda p: compute_losses(
        p, net_state, batch, config, train=False)[0]["eval_loss"]))
    loss, grad = fn(params)
    return float(loss), grad


def relative(a, b):
    import jax.numpy as jnp
    return float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b))


def grad_diffs(got, ref):
    """Relative L2 distances: whole gradient, MoE head, each layer."""
    out = {"all": relative(_flat(got), _flat(ref))}
    for key in ref:
        if isinstance(ref[key], list):
            for i, (g, r) in enumerate(zip(got[key], ref[key])):
                out["%s%d" % (key, i)] = relative(_flat(g), _flat(r))
        else:
            out[key] = relative(_flat(got[key]), _flat(ref[key]))
    return {k: float("%.3e" % v) for k, v in out.items()}


def compare_precisions(jax, params, net_state, batch, config):
    """bf16 default and f32 (TF32 allowed) against f32 "highest"."""
    with jax.default_matmul_precision("highest"):
        ref_loss, ref_grad = loss_and_grad(
            jax, params, net_state, batch,
            dict(config, compute_dtype="float32"))
    bf_loss, bf_grad = loss_and_grad(jax, params, net_state, batch, config)
    tf_loss, tf_grad = loss_and_grad(jax, params, net_state, batch,
                                     dict(config, compute_dtype="float32"))
    finite = all(bool(np.all(np.isfinite(np.asarray(g))))
                 for g in jax.tree.leaves(bf_grad))
    if not (finite and np.isfinite([bf_loss, ref_loss]).all()):
        raise AssertionError("non-finite bf16 loss or gradient")
    return {"ref_loss": ref_loss, "bf16_loss": bf_loss,
            "bf16_loss_rel": abs(bf_loss - ref_loss) / abs(ref_loss),
            "bf16_grad_rel": grad_diffs(bf_grad, ref_grad),
            "f32_default_loss_rel": abs(tf_loss - ref_loss) / abs(ref_loss),
            "f32_default_grad_rel": grad_diffs(tf_grad, ref_grad)}


def parity(jax, config, batch, short_batch):
    """bf16 default vs the f32 "highest" reference: the loss on the full
    batch, the gradients on a short window at full width."""
    from lstm_ctc_tpu.models import init_model
    params, net_state = init_model(jax.random.PRNGKey(0), config)
    out = {}
    for name, data in (("full", batch), ("short", short_batch)):
        out[name] = compare_precisions(jax, params, net_state, data, config)
        say("parity %s [B=%d, T=%d]: %s" % (
            name, data["nnet_input"].shape[0], data["nnet_input"].shape[1],
            json.dumps(out[name])))
        if out[name]["bf16_loss_rel"] > LOSS_RTOL:
            raise AssertionError(
                "bf16 loss off the f32 reference by %.3e > %g (%s)"
                % (out[name]["bf16_loss_rel"], LOSS_RTOL, name))
    grad_rel = out["short"]["bf16_grad_rel"]["all"]
    if grad_rel > GRAD_RTOL:
        raise AssertionError("bf16 gradient off the f32 reference by "
                             "%.3e > %g (T=%d)" % (grad_rel, GRAD_RTOL,
                                                   PARITY_SHORT_T))
    return out


# ---------------------------------------------------------------- phase 4
def ctc_kernel_parity(jax, config, batch, interpret=False):
    """CTC loss and d loss/d logits: Pallas kernels vs the scan
    (``interpret`` runs the kernels in the Pallas interpreter: tests)."""
    import jax.numpy as jnp

    from lstm_ctc_tpu.ops import ctc
    rng = np.random.RandomState(1)
    logits = jnp.asarray(rng.randn(
        batch["nnet_input"].shape[0], batch["nnet_input"].shape[1],
        config["num_targets"]).astype(np.float32))
    args = [jnp.asarray(batch[k]) for k in
            ("sequence_length", "nnet_target", "target_length")]
    results = {}
    with jax.default_matmul_precision("highest"):
        for impl in ("scan", "kernel"):
            with impl_env(impl):
                fn = jax.jit(jax.value_and_grad(
                    lambda lg: jnp.sum(ctc.ctc_loss(
                        lg, *args, interpret=interpret))))
                results[impl] = fn(logits)
    (ls, gs), (lk, gk) = results["scan"], results["kernel"]
    loss_rel = abs(float(lk) - float(ls)) / abs(float(ls))
    grad_diff = float(jnp.max(jnp.abs(gk - gs)))
    say("ctc kernel vs scan: S=%d loss_rel=%.3e grad_max_abs=%.3e"
        % (2 * batch["nnet_target"].shape[1] + 1, loss_rel, grad_diff))
    if not (loss_rel <= CTC_LOSS_RTOL and grad_diff <= CTC_GRAD_ATOL):
        raise AssertionError("CTC kernel disagrees with the scan")
    return {"loss_rel": loss_rel, "grad_max_abs": grad_diff}


@contextlib.contextmanager
def impl_env(impl):
    """Set LSTM_CTC_TPU_CTC_IMPL while a step is traced."""
    saved = os.environ.get("LSTM_CTC_TPU_CTC_IMPL")
    os.environ["LSTM_CTC_TPU_CTC_IMPL"] = impl
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("LSTM_CTC_TPU_CTC_IMPL", None)
        else:
            os.environ["LSTM_CTC_TPU_CTC_IMPL"] = saved


def build_step(jax, config, batch, impl="auto", optimizer="adam",
               learn_rate=1e-3, shardings=None):
    """(compiled train step, fresh state, (trace+lower s, compile s))."""
    from lstm_ctc_tpu.models import init_model
    from lstm_ctc_tpu.train.graph import make_train_step
    params, net_state = init_model(jax.random.PRNGKey(0), config)
    init_opt, step = make_train_step(config, learn_rate=learn_rate,
                                     optimizer=optimizer)
    state = [params, init_opt(params), net_state, jax.random.PRNGKey(1)]
    if shardings is not None:
        state = [jax.device_put(x, shardings) for x in state]
    with impl_env(impl):
        t0 = time.perf_counter()
        lowered = step.lower(*state, batch)
        t1 = time.perf_counter()
        compiled = lowered.compile()
        t2 = time.perf_counter()
    return compiled, state, (t1 - t0, t2 - t1)


def time_steps(jax, compiled, state, batch, steps=20):
    """Seconds per step over ``steps`` chained steps (after one warm-up);
    returns (seconds, last metrics)."""
    params, opt, net_state, rng = state
    params, opt, net_state, metrics = compiled(params, opt, net_state, rng,
                                               batch)
    jax.block_until_ready(metrics)
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt, net_state, metrics = compiled(params, opt, net_state,
                                                   rng, batch)
    jax.block_until_ready(metrics)
    state[:3] = params, opt, net_state
    return (time.perf_counter() - t0) / steps, metrics


def count_cache_hits(jax):
    """A list that grows by one per persistent compile-cache hit."""
    from jax import monitoring
    hits = []
    monitoring.register_event_listener(
        lambda event, **_: hits.append(event)
        if event == "/jax/compilation_cache/cache_hits" else None)
    return hits


# ---------------------------------------------------------------- --four
def four_cards(jax, config, workdir):
    """One flagship step at global batch 4×32 on a 4-card data mesh vs
    the same batch on one card, then nnet-train with four cards.  The
    step runs on a PARITY_SHORT_T-row window: rows compute the same on
    both sides, but the cards may take other GEMM algorithms, and at
    T=384 the chaotic random-init stack (see GRAD_RTOL) would blow such
    last-bit differences up to an uncorrelated update."""
    from lstm_ctc_tpu.parallel.mesh import (batch_sharding, get_mesh,
                                            replicated_sharding)
    from lstm_ctc_tpu.train.checkpoint import save_checkpoint
    from lstm_ctc_tpu.cli import init_from_config

    mesh = get_mesh(4)
    host = flagship_batch(config, batch=4 * FLAGSHIP_B,
                          time_steps=PARITY_SHORT_T)
    one = jax.devices()[0]
    results = {}
    for name, cfg, data, rep in (
            ("1card", config, jax.device_put(host, one), one),
            ("4card", dict(config, mesh=mesh),
             jax.device_put(host, batch_sharding(mesh)),
             replicated_sharding(mesh))):
        compiled, state, comp_s = build_step(
            jax, cfg, data, optimizer="sgd", learn_rate=1e-2,
            shardings=rep)
        before = _flat(jax.device_get(state[0]))
        params, opt, net_state, metrics = compiled(*state, data)
        update = _flat(jax.device_get(params)) - before
        say("dp %s: global batch %d × %d rows, compile %.2f s"
            % (name, 4 * FLAGSHIP_B, PARITY_SHORT_T, sum(comp_s)))
        results[name] = (float(metrics["eval_loss"]), update)
    loss_1, upd_1 = results["1card"]
    loss_4, upd_4 = results["4card"]
    loss_rel = abs(loss_4 - loss_1) / abs(loss_1)
    upd_rel = relative(upd_4, upd_1)
    say("dp parity: loss 1card=%.4f 4card=%.4f rel=%.3e update_rel=%.3e "
        "(tolerances %g, %g)" % (loss_1, loss_4, loss_rel, upd_rel,
                                 DP_LOSS_RTOL, DP_UPDATE_RTOL))
    if not (loss_rel <= DP_LOSS_RTOL and upd_rel <= DP_UPDATE_RTOL):
        raise AssertionError("4-card step disagrees with 1 card")

    scp = make_corpus(workdir, "dp", 3 * 4 * FLAGSHIP_B, (1000, 1152),
                      config, seed=4)
    cfg_path = os.path.join(workdir, "nnet_dp.config")
    write_config(cfg_path, config)
    nnet0, nnet1 = (os.path.join(workdir, n) for n in ("dp.0", "dp.1"))
    save_checkpoint(nnet0, *init_from_config(config))
    metrics = os.path.join(workdir, "dp.jsonl")
    run_cli("nnet-train.py", [scp, cfg_path, nnet0, nnet1,
                              "--objective", "ctc", "--optimizer", "adam",
                              "--learn-rate", "0.0005",
                              "--batch-size", str(4 * FLAGSHIP_B),
                              "--metrics-file", metrics])
    steps = [json.loads(line) for line in open(metrics)]
    if len(steps) < 3 or not np.all(np.isfinite(
            [s["loss"] for s in steps])):
        raise AssertionError("4-card nnet-train: %r" % steps)
    say("dp nnet-train: %d batches of %d on %d cards, tr_loss=%.4f, "
        "frames/s per step %s" % (len(steps), 4 * FLAGSHIP_B,
                                  mesh.devices.size, steps[-1]["loss"],
                                  [s["frames_per_sec"] for s in steps]))
    return {"loss_rel": loss_rel, "update_rel": upd_rel}


# ---------------------------------------------------------------- main
def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the 4-card data-parallel path")
    args = parser.parse_args(argv)

    import jax
    facts = check_device(jax, want_count=4 if args.four else 1)
    sys.path.insert(0, REPO)
    from lstm_ctc_tpu.cli import enable_compile_cache
    say("compile cache: %s" % enable_compile_cache())
    config = flagship_config()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        if args.four:
            four_cards(jax, config, workdir)
            print_card()
            say(result_line(facts))
            return 0

        # phase 2: the user's path, plain and packed
        scp = make_corpus(workdir, "tr", 3 * FLAGSHIP_B, (1000, 1152),
                          config, seed=1)
        plain = train_through_clis(workdir, config, scp, FLAGSHIP_B, 1)
        say("cli plain: %s" % json.dumps(plain))
        # WSJ-like length mix so that rows really hold several
        # utterances; same initial model, and the forward pass runs on
        # the first corpus (one bucket shape, already compiled)
        scp_mix = make_corpus(workdir, "mix", 6 * FLAGSHIP_B, (200, 1152),
                              config, seed=2)
        packed = train_through_clis(
            workdir, config, scp_mix, FLAGSHIP_B, 3, label="_pf3",
            nnet0=os.path.join(workdir, "nnet.0"), forward_scp=scp)
        say("cli pack_factor=3: %s" % json.dumps(packed))

    # phase 3
    batch = jax.device_put(flagship_batch(config))
    parity(jax, config, batch, jax.device_put(
        flagship_batch(config, time_steps=PARITY_SHORT_T)))

    # phase 4 (and the step times of phase 5)
    ctc_kernel_parity(jax, config, batch)
    hits = count_cache_hits(jax)
    steps = {}
    for impl in ("kernel", "scan"):
        steps[impl] = build_step(jax, config, batch, impl=impl)
        if impl == "kernel":
            first_hits = len(hits)
    times = {"kernel": [], "scan": []}
    for impl in ("kernel", "scan", "kernel", "scan"):
        compiled, state, _ = steps[impl]
        dt, metrics = time_steps(jax, compiled, state, batch)
        if not np.isfinite(float(metrics["eval_loss"])):
            raise AssertionError("non-finite flagship loss (%s)" % impl)
        times[impl].append(dt)
    frames = FLAGSHIP_B * FLAGSHIP_T
    for impl in ("kernel", "scan"):
        best = min(times[impl])
        say("flagship train step, CTC %s: %s ms per step (best %.3f ms, "
            "%.0f frames/s)" % (impl, [round(t * 1e3, 3)
                                       for t in times[impl]],
                                best * 1e3, frames / best))

    # phase 5: compile times and memory.  A first build without cache
    # hits is a cold compile; the rebuild after clear_caches reads the
    # persistent cache.
    first = steps["kernel"][2]
    jax.clear_caches()
    before = len(hits)
    _, _, warm = build_step(jax, config, batch)
    say("compile of the train step, trace+lower / XLA compile: first in "
        "this run %.2f / %.2f s (%d persistent-cache hits), rebuilt %.2f / "
        "%.2f s (%d persistent-cache hits)"
        % (first + (first_hits,) + warm + (len(hits) - before,)))
    stats = jax.devices()[0].memory_stats() or {}
    say("peak_bytes_in_use: %s" % stats.get("peak_bytes_in_use"))
    print_card()
    say(result_line(facts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
