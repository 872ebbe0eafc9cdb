"""bench.py: --smoke runs every benchmark row on CPU with tiny shapes and
emits valid JSON (MFU null), so a bench.py regression is caught before a
run on the card; without --smoke it refuses a host with no GPU; the peak
table is keyed by the exact device kind."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_smoke_emits_full_json():
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu",
               LSTM_CTC_TPU_CTC_IMPL="scan")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--smoke"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=1500)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    # incremental emission: EVERY stdout line is a complete JSON result
    # (a mid-run kill leaves the last finished state parsable)
    assert len(lines) >= 3, lines
    for line in lines:
        json.loads(line)
    data = json.loads(lines[-1])
    assert data["metric"] == "train_frames_per_sec_per_chip"
    assert data["value"] > 0
    assert data["forward_frames_per_sec"] > 0
    # the CPU tier has no peak to divide by
    assert data["mfu"] is None and data["mfu_peak_note"] is None
    assert all(row.get("mfu") is None for row in data["configs"])
    assert data["device"]["platform"] == "cpu"
    labels = {row["config"] for row in data["configs"]}
    assert {"flagship_b32_t384", "flagship_b64_t384",
            "recipe_packed_pf3_b32", "lstm_b32_t384",
            "cudnnlstm_b32_t384", "lstm_bn_b32_t384",
            "streaming_lstm_b1_chunk4"} <= labels
    errors = [row for row in data["configs"] if "error" in row]
    assert not errors, errors
    for row in data["configs"]:
        if row["config"].startswith("streaming_"):
            # latency row: ms/chunk + real-time factor, no frames/s
            assert row["ms_per_chunk"] > 0 and row["real_time_factor"] > 0
        else:
            assert row["frames_per_sec"] > 0


def test_bench_smoke_mesh_row_on_multi_device():
    """With >1 device visible, the bench must add the DP-mesh row (the
    sharded train step over all local devices) — exercised here on a
    forced 8-device CPU mesh."""
    env = dict(os.environ)
    xla_flags = env.get("XLA_FLAGS", "")
    env.update(JAX_PLATFORMS="cpu",
               XLA_FLAGS=(xla_flags
                          + " --xla_force_host_platform_device_count=8"),
               LSTM_CTC_TPU_CTC_IMPL="scan")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--smoke"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=1500)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    data = json.loads(r.stdout.strip().splitlines()[-1])
    mesh_rows = [row for row in data["configs"]
                 if row["config"].startswith("mesh_dp")]
    assert len(mesh_rows) == 1, data["configs"]
    row = mesh_rows[0]
    assert "error" not in row, row
    assert row["config"] == "mesh_dp8_b4x8_t384"
    assert row["frames_per_sec"] > 0
    assert row["frames_per_sec_per_chip"] > 0


def test_bench_deadline_degrades_to_fewer_rows():
    """With an exhausted row deadline the bench must still exit 0 with a
    parsable result: headline row present, secondary rows marked
    skipped — never rc=124 with nothing emitted."""
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu",
               LSTM_CTC_TPU_CTC_IMPL="scan",
               LSTM_CTC_TPU_BENCH_DEADLINE="0")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--smoke"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    data = json.loads(r.stdout.strip().splitlines()[-1])
    assert data["value"] > 0
    skipped = [row for row in data["configs"] if "skipped" in row]
    assert skipped, data["configs"]


def test_bench_refuses_a_host_without_gpu():
    """Without --smoke the bench measures the card or nothing: on CPU it
    exits non-zero and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert not r.stdout.strip()


def _bench():
    sys.path.insert(0, REPO)
    import bench
    return bench


def test_peak_table_knows_the_h100():
    bench = _bench()
    assert bench.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert "data sheet" in bench.PEAK_BF16_FLOPS["NVIDIA H100 80GB HBM3"][1]


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe",
                                  "NVIDIA A100-SXM4-80GB", ""])
def test_peak_table_refuses_an_unknown_kind(kind):
    with pytest.raises(KeyError, match="no bf16 peak"):
        _bench().peak_bf16_flops(kind)


def test_power_limit_is_none_without_nvidia_smi(monkeypatch):
    import subprocess as sp

    def missing(*a, **kw):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(sp, "run", missing)
    assert _bench().gpu_name_and_power_limit() is None
