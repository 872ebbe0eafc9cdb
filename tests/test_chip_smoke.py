"""chip_smoke.py's host-side contract and its phases at tiny widths.

On a host without a GPU the script must exit non-zero and print no
result; alone in a directory it must fail the same way.  Its phases are
plain functions, run here on CPU with a small model so that the CLI
flow, the parity arithmetic and the four-card comparison are rehearsed
before they reach a card (where chip_smoke.py runs them at full width).
"""

import json
import os
import shutil
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def run_script(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "chip_smoke.py")] + list(args),
        capture_output=True, text=True, env=env, cwd=cwd, timeout=300)


@pytest.mark.parametrize("args", [(), ("--four",)])
def test_refuses_a_cpu_platform(args):
    r = run_script(REPO, *args)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = run_script(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_result_line_format():
    facts = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
             "count": 1}
    line = chip_smoke.result_line(facts)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": facts}


def fake_jax(platform, count):
    dev = types.SimpleNamespace(platform=platform, device_kind="Kind X")
    return types.SimpleNamespace(devices=lambda: [dev] * count,
                                 device_count=lambda: count,
                                 __version__=jax.__version__)


def test_check_device_reports_the_card(capsys):
    facts = chip_smoke.check_device(fake_jax("gpu", 1))
    assert facts == {"platform": "gpu", "kind": "Kind X", "count": 1}
    assert "kind=Kind X count=1" in capsys.readouterr().out


@pytest.mark.parametrize("platform,count,want", [("cpu", 1, 1),
                                                 ("gpu", 1, 4)])
def test_check_device_refuses(platform, count, want):
    with pytest.raises(SystemExit):
        chip_smoke.check_device(fake_jax(platform, count), want_count=want)


# ------------------------------------------------------- tiny phases
TINY = {"num_layers": 1, "num_neurons": 16, "num_projects": 16,
        "num_experts": 4}


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(chip_smoke, "FLAGSHIP_B", 2)
    monkeypatch.setattr(chip_smoke, "FLAGSHIP_T", 24)
    return dict(chip_smoke.flagship_config(), **TINY)


def test_flagship_batch_has_speech_label_density(tiny):
    batch = chip_smoke.flagship_batch(tiny, batch=8, time_steps=384)
    # 384 rows × subsample 3 = 1152 raw frames → 128 labels
    assert batch["nnet_target"].shape == (8, 128)
    assert batch["target_length"].min() >= 112
    assert batch["nnet_input"].shape == (8, 384, 120)


@pytest.mark.parametrize("pack_factor,len_range", [(1, (60, 72)),
                                                   (3, (12, 72))])
def test_cli_phase_trains_and_forwards(tmp_path, tiny, pack_factor,
                                       len_range):
    scp = chip_smoke.make_corpus(str(tmp_path), "tr", 8, len_range, tiny,
                                 seed=1)
    out = chip_smoke.train_through_clis(str(tmp_path), tiny, scp, 2,
                                        pack_factor, min_steps=2)
    assert out["steps"] >= 2 and np.isfinite(out["tr_loss"])
    assert out["utterances"] == 8


def test_cli_phase_continues_from_a_model(tmp_path, tiny):
    """The packed run of main(): same initial model, forward on the
    first corpus."""
    first = chip_smoke.make_corpus(str(tmp_path), "tr", 6, (60, 72), tiny,
                                   seed=1)
    chip_smoke.train_through_clis(str(tmp_path), tiny, first, 2, 1,
                                  min_steps=2)
    mix = chip_smoke.make_corpus(str(tmp_path), "mix", 12, (12, 72), tiny,
                                 seed=2)
    out = chip_smoke.train_through_clis(
        str(tmp_path), tiny, mix, 2, 3, min_steps=2, label="_pf3",
        nnet0=str(tmp_path / "nnet.0"), forward_scp=first)
    assert out["utterances"] == 6


def test_parity_phase_on_cpu(tiny):
    # CPU computes in float32 for both sides: the diffs are ~0
    batch = chip_smoke.flagship_batch(tiny)
    short = chip_smoke.flagship_batch(tiny, time_steps=8)
    out = chip_smoke.parity(jax, tiny, batch, short)
    for name in ("full", "short"):
        assert out[name]["bf16_loss_rel"] < 1e-5
        assert out[name]["bf16_grad_rel"]["all"] < 1e-4
        assert set(out[name]["bf16_grad_rel"]) == {"all", "fwd0", "bwd0",
                                                   "moe"}


def test_ctc_phase_interpreted(tiny):
    batch = chip_smoke.flagship_batch(tiny)
    out = chip_smoke.ctc_kernel_parity(jax, tiny, batch, interpret=True)
    assert out["loss_rel"] <= chip_smoke.CTC_LOSS_RTOL


def test_four_card_phase_on_virtual_devices(tmp_path, tiny):
    assert jax.device_count() >= 4
    out = chip_smoke.four_cards(jax, tiny, str(tmp_path))
    assert out["loss_rel"] <= chip_smoke.DP_LOSS_RTOL
    assert out["update_rel"] <= chip_smoke.DP_UPDATE_RTOL
