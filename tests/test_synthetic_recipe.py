"""The flagship integration test: the synthetic recipe end-to-end —
audio synthesis → native fbank/CMVN → records → BLSTM-CTC training via
the newbob outer loop → native TLG build → native lattice decode →
acoustic-scale-sweep WER scoring.  Everything self-contained."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FSTBIN = os.path.join(REPO, "native", "build")


@pytest.mark.slow
@pytest.mark.skipif(
    not os.path.exists(os.path.join(FSTBIN, "fst-tools")),
    reason="native toolkit not built")
def test_synthetic_recipe_end_to_end(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHON=sys.executable)
    env.pop("XLA_FLAGS", None)  # no virtual multi-device in subprocesses
    proc = subprocess.run(
        ["bash", os.path.join(REPO, "egs", "synthetic", "run.sh"),
         "--work", str(tmp_path / "work"),
         "--num-train", "64", "--max-iter", "18", "--min-iters", "18",
         "--keep-lr-iters", "18"],
        capture_output=True, text=True, env=env, cwd=REPO)
    assert proc.returncode == 0, \
        "recipe failed:\nstdout:\n%s\nstderr:\n%s" % (
            proc.stdout[-4000:], proc.stderr[-2000:])
    match = re.search(r"best WER =====\n\S+summary (\d+\.\d+)", proc.stdout)
    assert match, "no WER summary in:\n%s" % proc.stdout[-2000:]
    wer = float(match.group(1))
    assert wer < 0.25, "recipe WER too high: %.3f" % wer


def test_gen_data_hard_profile(tmp_path):
    """The non-saturated accuracy-gate corpus (--hard): larger
    minimal-pair vocabulary, noisy confusable tones — dict and data
    dirs must materialize with the extended lexicon and the same phone
    inventory (the network output size must not change)."""
    proc = subprocess.run(
        [sys.executable,
         os.path.join(REPO, "egs", "synthetic", "local", "gen_data.py"),
         str(tmp_path), "4", "2", "2", "7", "--hard"],
        capture_output=True, text=True, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    lex = open(os.path.join(str(tmp_path), "data", "dict",
                            "lexicon.txt")).read().split("\n")
    words = {line.split()[0] for line in lex if line}
    assert {"kam", "sam", "kat", "mit", "tesko", "mura"} <= words
    units = open(os.path.join(str(tmp_path), "data", "dict",
                              "units.txt")).read().strip().split("\n")
    assert len(units) == 10          # phone inventory unchanged
    # audio exists and is non-trivially sized
    wav_dir = os.path.join(str(tmp_path), "wav", "train")
    assert len(os.listdir(wav_dir)) == 4
    # easy and hard corpora must differ (noise/vocab actually applied)
    proc2 = subprocess.run(
        [sys.executable,
         os.path.join(REPO, "egs", "synthetic", "local", "gen_data.py"),
         str(tmp_path / "easy"), "4", "2", "2", "7"],
        capture_output=True, text=True, cwd=REPO)
    assert proc2.returncode == 0, proc2.stderr
    lex2 = open(os.path.join(str(tmp_path / "easy"), "data", "dict",
                             "lexicon.txt")).read()
    assert "tesko" not in lex2


def _gen_data_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "gen_data", os.path.join(REPO, "egs", "synthetic", "local",
                                 "gen_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hard_profile_calibration_invariants():
    """Pin the CALIBRATED hard-profile design (gen_data.Profile
    docstring): the k/t frequency alias that makes
    kam/tam and oak/oat true homophones (the budget-immune WER floor),
    the 1.15 spacing (the regression-sensitive margin), the
    minimal-pair lexicon superset, and the jitter/noise knobs.  A
    silent regression in any of these would de-calibrate the accuracy
    gate and only surface at the next chip session."""
    gd = _gen_data_module()
    prof = gd.Profile(hard=True)
    phones = gd.PHONES

    # 1.15 spacing between non-aliased neighbours (measured margin:
    # 1.18 saturates to ~0%, 1.13 is unlearnable at protocol budget)
    assert abs(prof.freqs[1] / prof.freqs[0] - 1.15) < 1e-9
    # the t→k alias must be EXACT — approximate equality would turn the
    # irreducible homophone floor back into (learnable) acoustics
    assert prof.freqs[phones.index("t")] == prof.freqs[phones.index("k")]
    # homophone twins: identical tone sequences, resolvable only by LM
    def tones(word):
        return [prof.freqs[phones.index(p)] for p in prof.words[word]]
    assert tones("kam") == tones("tam")
    assert tones("oak") == tones("oat")
    # hard lexicon is a strict superset of the easy one (same base
    # vocabulary + minimal pairs + homophones)
    assert set(gd.WORDS) < set(prof.words)
    assert set(gd.HARD_EXTRA_WORDS) <= set(prof.words)
    # per-token jitter is on but bounded well under the 15% spacing
    # (otherwise neighbouring tones overlap and the task de-calibrates)
    assert 0.0 < prof.freq_jitter <= 0.05
    assert prof.noise_sigma == 1200.0
    assert 0.0 < prof.dur_lo < prof.dur_hi
    assert prof.amp_lo < prof.amp_hi

    # the easy profile must stay the saturated pipeline proof: wide
    # spacing, NO alias, NO jitter, base vocabulary only
    easy = gd.Profile(hard=False)
    assert abs(easy.freqs[1] / easy.freqs[0] - 1.22) < 1e-9
    assert easy.freqs[phones.index("t")] != easy.freqs[phones.index("k")]
    assert easy.freq_jitter == 0.0
    assert set(easy.words) == set(gd.WORDS)

    # re-calibration knobs stay overridable — and the alias survives a
    # spacing override (it is applied after the ladder is built)
    re_prof = gd.Profile(hard=True, freq_step=1.3, noise_sigma=60.0)
    assert abs(re_prof.freqs[1] / re_prof.freqs[0] - 1.3) < 1e-9
    assert re_prof.freqs[phones.index("t")] \
        == re_prof.freqs[phones.index("k")]
    assert re_prof.noise_sigma == 60.0


def test_run_sh_profile_hard_plumbing(tmp_path):
    """run.sh --profile hard must reach gen_data.py with --hard (and
    --gen-extra must pass through): stage 0 alone, checked via the
    generator's own output and the materialized hard lexicon."""
    env = dict(os.environ, PYTHON=sys.executable)
    proc = subprocess.run(
        ["bash", os.path.join(REPO, "egs", "synthetic", "run.sh"),
         "--work", str(tmp_path / "work"), "--stage", "0",
         "--stop-stage", "0", "--num-train", "4",
         "--profile", "hard", "--gen-extra", "--freq-step 1.3"],
        capture_output=True, text=True, env=env, cwd=REPO)
    assert proc.returncode == 0, \
        "stage 0 failed:\nstdout:\n%s\nstderr:\n%s" % (
            proc.stdout[-3000:], proc.stderr[-2000:])
    assert "generated hard corpus" in proc.stdout
    lex = open(tmp_path / "work" / "data" / "dict" / "lexicon.txt").read()
    words = {line.split()[0] for line in lex.splitlines() if line}
    assert {"tam", "oat", "sam", "tesko"} <= words    # hard lexicon
    # stop-stage honored: no TLG/lang dir was built
    assert not os.path.exists(tmp_path / "work" / "lang")
    # and the default profile stays easy
    proc2 = subprocess.run(
        ["bash", os.path.join(REPO, "egs", "synthetic", "run.sh"),
         "--work", str(tmp_path / "work2"), "--stage", "0",
         "--stop-stage", "0", "--num-train", "4"],
        capture_output=True, text=True, env=env, cwd=REPO)
    assert proc2.returncode == 0
    assert "generated easy corpus" in proc2.stdout


@pytest.mark.slow
@pytest.mark.skipif(
    not os.path.exists(os.path.join(FSTBIN, "fst-tools")),
    reason="native toolkit not built")
def test_synthetic_recipe_hard_profile_smoke(tmp_path):
    """2-iteration smoke of the hard profile end-to-end: the accuracy
    gate's recipe path (gen_data --hard → train → decode → score) must
    execute, not just its generator.  No WER bar — at this budget the
    model is untrained; the multi-seed protocol result lives in
    egs/synthetic/RESULT_PARITY.md."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHON=sys.executable)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        ["bash", os.path.join(REPO, "egs", "synthetic", "run.sh"),
         "--work", str(tmp_path / "work"), "--profile", "hard",
         "--num-train", "16", "--max-iter", "2", "--min-iters", "2",
         "--keep-lr-iters", "2", "--stop-stage", "5"],
        capture_output=True, text=True, env=env, cwd=REPO)
    assert proc.returncode == 0, \
        "hard-profile recipe failed:\nstdout:\n%s\nstderr:\n%s" % (
            proc.stdout[-4000:], proc.stderr[-2000:])
    match = re.search(r"best WER =====\n\S+summary (\d+\.\d+)",
                      proc.stdout)
    assert match, "no WER summary in:\n%s" % proc.stdout[-2000:]
