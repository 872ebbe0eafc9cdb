#!/usr/bin/env python3
"""A/B the flagship train step under different env-var settings.

Each variant runs in its OWN SUBPROCESS (kernel/env knobs are read at
trace time; a fresh process guarantees no stale jit cache leaks
between variants) and times bench.py's flagship row.  The parent never
imports JAX, so each variant's process owns the card alone.

Usage:
  python scripts/ab_train_step.py \\
      "baseline=" \\
      "scan_ctc=LSTM_CTC_TPU_CTC_IMPL=scan" \\
      [--batch 32] [--time-steps 384] [--repeats 2]

Each positional arg is ``name=ENV=VAL[,ENV=VAL...]`` (empty env = as
shipped).  Prints one JSON line per (variant, repeat) plus a final
comparison.  Repeats interleave A/B/A/B to decorrelate slow drifts of
the card.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PAYLOAD = r"""
import json, sys
sys.path.insert(0, %(repo)r)
import jax
from lstm_ctc_tpu.cli import enable_compile_cache
enable_compile_cache()
import bench
from bench import bench_unpacked
from __graft_entry__ import FLAGSHIP_CONFIG
bench.STEPS = %(steps)d
config = dict(FLAGSHIP_CONFIG, dropout_rate=1.0)
if %(tiny)d:
    config.update(num_layers=2, num_neurons=16, num_projects=16,
                  num_experts=4)
config.update(json.loads(%(config_json)r) or {})
if %(packed)d:
    from bench import bench_packed
    fps, fill = bench_packed(config, %(batch)d, %(packed)d, jax)
    print(json.dumps({"frames_per_sec": round(fps, 1),
                      "fill": round(fill, 4)}))
else:
    fps = bench_unpacked(config, %(batch)d, %(time_steps)d, jax)
    print(json.dumps({"frames_per_sec": round(fps, 1)}))
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+",
                    help="name=ENV=VAL[,ENV=VAL...]")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--time-steps", type=int, default=384)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model dims (harness smoke test)")
    ap.add_argument("--packed", type=int, default=0, metavar="PF",
                    help="time the packed row (bench_packed, REAL "
                         "frames/s) at this pack factor instead of the "
                         "unpacked flagship row")
    ap.add_argument("--config", default="{}",
                    help="JSON dict merged over FLAGSHIP_CONFIG (e.g. "
                         "'{\"nnet_type\": \"lstm\", \"use_bn\": true}' "
                         "to A/B the lstm+bn family)")
    args = ap.parse_args()

    variants = []
    for spec in args.variants:
        name, _, envs = spec.partition("=")
        env_pairs = {}
        if envs:
            for kv in envs.split(","):
                k, _, v = kv.partition("=")
                env_pairs[k] = v
        variants.append((name, env_pairs))

    # fail fast on malformed overrides (before burning chip reps)
    if not isinstance(json.loads(args.config), dict):
        ap.error("--config must be a JSON object")
    payload = PAYLOAD % {"repo": REPO, "batch": args.batch,
                         "time_steps": args.time_steps,
                         "steps": args.steps, "tiny": int(args.tiny),
                         "packed": args.packed,
                         "config_json": args.config}
    results = {name: [] for name, _ in variants}
    for rep in range(args.repeats):
        for name, env_pairs in variants:
            env = dict(os.environ, **env_pairs)
            try:
                r = subprocess.run([sys.executable, "-c", payload],
                                   capture_output=True, text=True,
                                   env=env, timeout=args.timeout,
                                   cwd=REPO)
            except subprocess.TimeoutExpired:
                # a wedged backend must cost one variant rep, not the
                # whole harness (and its summary line)
                print(json.dumps({"variant": name, "rep": rep,
                                  "error": "timeout after %ss"
                                           % args.timeout}), flush=True)
                continue
            if r.returncode != 0:
                print(json.dumps({"variant": name, "rep": rep,
                                  "error": r.stderr[-500:]}), flush=True)
                continue
            row = json.loads(r.stdout.strip().splitlines()[-1])
            results[name].append(row["frames_per_sec"])
            print(json.dumps(dict({"variant": name, "rep": rep},
                                  **row)), flush=True)

    summary = {}
    for name, vals in results.items():
        if vals:
            summary[name] = {"best": max(vals), "runs": vals}
    names = [n for n, _ in variants if results.get(n)]
    if len(names) >= 2 and results[names[0]]:
        base = max(results[names[0]])
        for n in names[1:]:
            summary[n]["vs_" + names[0]] = round(
                (max(results[n]) - base) / base * 100.0, 2)
    print(json.dumps({"summary": summary}))


if __name__ == "__main__":
    main()
