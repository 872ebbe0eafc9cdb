"""scripts/ab_train_step.py — the env-variant A/B harness for the card
must keep working on CPU with tiny shapes, so a harness regression is
caught before it spoils a run on the card."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AB = os.path.join(REPO, "scripts", "ab_train_step.py")


def _run(extra_args):
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu",
               LSTM_CTC_TPU_LSTM_IMPL="scan",
               LSTM_CTC_TPU_CTC_IMPL="scan")
    r = subprocess.run(
        [sys.executable, AB,
         "a=", "b=LSTM_CTC_TPU_MOE_NBLOCK=128",
         "--tiny", "--repeats", "1", "--steps", "2",
         "--batch", "4", "--time-steps", "32"] + extra_args,
        # generous: the dominant cost is 2 jax imports + traces, which
        # stretch badly when the box is busy (e.g. parity lanes in CI)
        capture_output=True, text=True, env=env, cwd=REPO, timeout=2400)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    lines = [json.loads(l) for l in r.stdout.strip().splitlines()]
    per_run = [l for l in lines if "variant" in l]
    assert not any("error" in l for l in per_run), per_run
    summary = lines[-1]["summary"]
    return per_run, summary


def test_ab_harness_unpacked_smoke():
    per_run, summary = _run([])
    assert {l["variant"] for l in per_run} == {"a", "b"}
    assert all(l["frames_per_sec"] > 0 for l in per_run)
    # the comparison field names the baseline variant
    assert "vs_a" in summary["b"]


def test_ab_harness_packed_mode():
    per_run, summary = _run(["--packed", "2"])
    assert all(l["frames_per_sec"] > 0 for l in per_run)
    # packed rows report REAL-frame fill alongside throughput
    assert all(0.0 < l["fill"] <= 1.0 for l in per_run)
    assert summary["a"]["best"] > 0 and summary["b"]["best"] > 0


def test_ab_harness_rejects_malformed_config():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, AB, "a=", "--tiny", "--config", "{not json"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode != 0
