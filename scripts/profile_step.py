#!/usr/bin/env python3
"""Per-segment timing breakdown of the flagship train step.

Attributes the step time across the BLSTM chain, the MoE head, the CTC
loss, the backward pass and the optimizer by timing nested subgraphs and
differencing (each timed with bench.py's loop, which ends every window
with block_until_ready):

  fwd_chain      — 4-layer BLSTM chain with a dense head
  fwd_logits     — + MoE head (full inference forward)
  fwd_loss       — + CTC forward (loss value, no grad)
  grad           — value_and_grad of the full loss (no optimizer)
  full_step      — the shipped train step (grad + clip + adam + donate)

Optionally dumps a jax.profiler trace per segment (--profile-dir) for
xprof-level inspection.

Needs a GPU (MFU divides by the card's entry in bench.PEAK_BF16_FLOPS).

Usage: python scripts/profile_step.py [--batch 32] [--time-steps 384]
         [--json out.json] [--profile-dir DIR]
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--time-steps", type=int, default=384)
    ap.add_argument("--json", default=None)
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import (_time_steps_loop, device_facts,
                       model_fwd_flops_per_frame, peak_bf16_flops)
    from __graft_entry__ import FLAGSHIP_CONFIG, _example_batch
    from lstm_ctc_tpu.cli import enable_compile_cache
    from lstm_ctc_tpu.models import apply_model, init_model
    from lstm_ctc_tpu.ops import ctc_loss
    from lstm_ctc_tpu.train.graph import compute_losses, make_train_step

    enable_compile_cache()
    facts = device_facts(jax)
    if facts["platform"] != "gpu":
        sys.exit("profile_step: no GPU (platform %r)" % facts["platform"])
    peak = peak_bf16_flops(facts["kind"])
    config = dict(FLAGSHIP_CONFIG, dropout_rate=1.0)
    b, t = args.batch, args.time_steps
    batch = _example_batch(config, batch=b, time_steps=t)
    batch = {k: jax.device_put(v) for k, v in batch.items()}
    params, net_state = init_model(jax.random.PRNGKey(0), config)
    params = jax.device_put(params)
    rng = jax.random.PRNGKey(1)

    frames = b * t
    segments = {}

    def timeit(name, run_once, result):
        dt = _time_steps_loop(run_once, result, steps=args.steps)
        segments[name] = dt
        print("%-12s %8.3f ms  (%.0f frames/s)"
              % (name, dt * 1e3, frames / dt), flush=True)
        if args.profile_dir:
            with jax.profiler.trace(os.path.join(args.profile_dir, name)):
                for _ in range(3):
                    run_once()
                jax.block_until_ready(result())
        return dt

    # --- fwd_chain: the recurrent chain; apply_blstm always applies a
    # head, so time it with a dense head (2P·V matmul, negligible vs
    # the E·V MoE tile) and attribute the difference to the MoE head
    dense_cfg = dict(config, num_experts=0)
    params_dense, _ = init_model(jax.random.PRNGKey(0), dense_cfg)
    params_dense = jax.device_put(params_dense)

    @jax.jit
    def f_chain(p, x, sl):
        logits, _, _, _ = apply_model(p, net_state, x, sl, dense_cfg,
                                      train=False)
        return logits

    o = {}
    timeit("fwd_chain", lambda: o.__setitem__(
        "c", f_chain(params_dense, batch["nnet_input"],
                     batch["sequence_length"])),
        lambda: o["c"])

    # --- fwd_logits: + MoE head ---
    @jax.jit
    def f_logits(p, x, sl):
        logits, _, _, _ = apply_model(p, net_state, x, sl, config,
                                      train=False)
        return logits

    timeit("fwd_logits", lambda: o.__setitem__(
        "l", f_logits(params, batch["nnet_input"],
                      batch["sequence_length"])),
        lambda: o["l"])

    # --- ctc_only: loss fwd on fixed logits ---
    logits_fixed = o["l"]

    @jax.jit
    def f_ctc(lg):
        return jnp.sum(ctc_loss(lg, batch["sequence_length"],
                                batch["nnet_target"],
                                batch["target_length"]))

    timeit("ctc_fwd", lambda: o.__setitem__("cl", f_ctc(logits_fixed)),
           lambda: o["cl"])

    @jax.jit
    def f_ctc_grad(lg):
        return jax.value_and_grad(
            lambda z: jnp.sum(ctc_loss(z, batch["sequence_length"],
                                       batch["nnet_target"],
                                       batch["target_length"])))(lg)

    timeit("ctc_fwdbwd", lambda: o.__setitem__(
        "cg", f_ctc_grad(logits_fixed)[0]), lambda: o["cg"])

    # --- fwd_loss: full forward + CTC value ---
    @jax.jit
    def f_loss(p, bt):
        metrics, _, _ = compute_losses(p, net_state, bt, config,
                                       train=False)
        return metrics["loss"]

    timeit("fwd_loss", lambda: o.__setitem__("fl", f_loss(params, batch)),
           lambda: o["fl"])

    # --- grad: value_and_grad of the training loss, no optimizer ---
    def loss_fn(p, bt, key):
        metrics, _, _ = compute_losses(p, net_state, bt, config,
                                       train=True, dropout_rng=key)
        return metrics["loss"]

    @jax.jit
    def f_grad(p, bt, key):
        val, grads = jax.value_and_grad(loss_fn)(p, bt, key)
        return val, grads

    timeit("grad", lambda: o.__setitem__(
        "g", f_grad(params, batch, rng)[0]), lambda: o["g"])

    # --- full_step: the shipped train step ---
    init_opt, train_step = make_train_step(config, learn_rate=1e-3,
                                           optimizer="adam")
    import numpy as np
    params_host = jax.tree.map(np.asarray, params)
    state = {}

    def reset():
        state["p"] = jax.device_put(params_host)
        state["o"] = init_opt(state["p"])
        state["s"] = jax.device_put(net_state)

    reset()

    def step_once():
        state["p"], state["o"], state["s"], state["m"] = train_step(
            state["p"], state["o"], state["s"], rng, batch)

    timeit("full_step", step_once, lambda: state["m"])

    # --- decomposition ---
    fwd_flops = model_fwd_flops_per_frame(config)
    full = segments["full_step"]
    report = {
        "batch": b, "time_steps": t,
        "segments_ms": {k: round(v * 1e3, 3) for k, v in segments.items()},
        "decomposition_ms": {
            "blstm_chain_fwd": round(segments["fwd_chain"] * 1e3, 3),
            "moe_head_fwd": round(
                (segments["fwd_logits"] - segments["fwd_chain"]) * 1e3, 3),
            "ctc_fwd": round(segments["ctc_fwd"] * 1e3, 3),
            "ctc_bwd": round(
                (segments["ctc_fwdbwd"] - segments["ctc_fwd"]) * 1e3, 3),
            "backward_minus_forward": round(
                (segments["grad"] - segments["fwd_loss"]) * 1e3, 3),
            "optimizer_and_update": round(
                (segments["full_step"] - segments["grad"]) * 1e3, 3),
        },
        "train_frames_per_sec": round(frames / full, 1),
        "mfu": round(frames / full * 3 * fwd_flops / peak, 4),
        "device": facts,
    }
    print(json.dumps(report))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2)


if __name__ == "__main__":
    main()
