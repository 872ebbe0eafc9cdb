"""End-to-end CLI test: Kaldi arks → convert → init → train → validate →
forward, checking the reference's log contract and loss improvement.

This is the synthetic stand-in for the WSJ recipe (SURVEY §4): utterances
are drawn from a generative process where each hidden label emits 2-4
noisy frames, so the CTC task is learnable in a few epochs on CPU.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from lstm_ctc_tpu import kaldi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(REPO, "bin")

NUM_CLASSES = 6          # 5 labels + blank (last)
INPUT_DIM = 10


def cli_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # no virtual multi-device in subprocesses
    return env


def run_cli(args, **kw):
    proc = subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, env=cli_env(), cwd=REPO, **kw)
    assert proc.returncode == 0, \
        "CLI failed: %s\nstdout:\n%s\nstderr:\n%s" % (
            args, proc.stdout[-2000:], proc.stderr[-2000:])
    return proc.stderr


def scrape(stderr, name):
    hits = re.findall(r"^INFO:tensorflow:%s = ([\d.naif-]+)$" % name,
                      stderr, re.M)
    assert hits, "no %s line in:\n%s" % (name, stderr[-2000:])
    return float(hits[-1])


def make_corpus(tmp_path, num_utts, seed):
    """Features: label-dependent cluster means + noise, 2-4 frames/label."""
    rng = np.random.RandomState(seed)
    means = np.random.RandomState(7).randn(NUM_CLASSES - 1, INPUT_DIM) * 2.0
    feats_ark = str(tmp_path / ("feats_%d.ark" % seed))
    labels_ark = str(tmp_path / ("labels_%d.ark" % seed))
    with kaldi.BaseFloatMatrixWriter("ark:" + feats_ark) as fw, \
            kaldi.Int32VectorWriter("ark:" + labels_ark) as lw:
        for i in range(num_utts):
            num_labels = rng.randint(2, 6)
            labels = rng.randint(0, NUM_CLASSES - 1, num_labels)
            frames = []
            for lab in labels:
                reps = rng.randint(2, 5)
                frames.append(means[lab]
                              + 0.3 * rng.randn(reps, INPUT_DIM))
            feats = np.concatenate(frames).astype(np.float32)
            key = "utt_%d_%03d" % (seed, i)
            fw.Write(key, feats)
            lw.Write(key, labels.astype(np.int32))
    return feats_ark, labels_ark


@pytest.mark.slow
def test_full_cli_pipeline(tmp_path):
    tr_feats, tr_labels = make_corpus(tmp_path, 40, seed=1)
    cv_feats, cv_labels = make_corpus(tmp_path, 12, seed=2)

    # --- convert-to-records (features via a pipe rspecifier) ---
    tr_scp = str(tmp_path / "tr.scp")
    cv_scp = str(tmp_path / "cv.scp")
    run_cli([os.path.join(BIN, "convert-to-records.py"),
             "ark:cat %s |" % tr_feats, str(tmp_path / "tr"), tr_scp,
             "--nnet-target", "ark:" + tr_labels])
    run_cli([os.path.join(BIN, "convert-to-records.py"),
             "ark:" + cv_feats, str(tmp_path / "cv"), cv_scp,
             "--nnet-target", "ark:" + cv_labels])
    assert len(open(tr_scp).readlines()) == 40

    # --- nnet.config, the recipe contract (run_wsj_phn.sh:226-243) ---
    config = str(tmp_path / "nnet.config")
    with open(config, "w") as fh:
        fh.write("""
nnet_type = blstm
input_dim = %d
left_context = 1
right_context = 1
subsample = 2
num_layers = 1
num_neurons = 32
num_projects = 16
num_targets = %d
use_peepholes = true
dropout_rate = 1.0
num_experts = 0
moe_temp = 10.0
seed = 5
""" % (INPUT_DIM, NUM_CLASSES))

    nnet0 = str(tmp_path / "nnet.0")
    stderr = run_cli([os.path.join(BIN, "nnet-init.py"), cv_scp, config,
                      nnet0, "--objective", "ctc", "--evaluate", "true",
                      "--batch-size", "8"])
    cv_loss_0 = scrape(stderr, "cv_loss")
    cv_eval_0 = scrape(stderr, "cv_eval")
    assert cv_loss_0 > 1.0

    # --- a few training epochs ---
    prev = nnet0
    tr_losses = []
    for it in (1, 2, 3):
        out = str(tmp_path / ("nnet.%d" % it))
        # epoch 2 trains on multi-utterance packed rows (state resets),
        # exercising the packed CLI path end-to-end; losses must keep
        # falling across the packed/unpacked mix
        pack = ["--pack-factor", "2"] if it == 2 else []
        stderr = run_cli([os.path.join(BIN, "nnet-train.py"), tr_scp, config,
                          prev, out, "--objective", "ctc",
                          "--optimizer", "adam", "--learn-rate", "0.004",
                          "--batch-size", "8", "--seed", str(it),
                          "--report-interval", "5"] + pack)
        tr_losses.append(scrape(stderr, "tr_loss"))
        prev = out
    assert tr_losses[-1] < cv_loss_0, \
        "training did not reduce loss: %s" % tr_losses

    # --- validate improved model ---
    stderr = run_cli([os.path.join(BIN, "nnet-validate.py"), cv_scp, config,
                      prev, "--objective", "ctc", "--evaluate", "true",
                      "--batch-size", "8"])
    cv_loss_n = scrape(stderr, "cv_loss")
    cv_eval_n = scrape(stderr, "cv_eval")
    assert cv_loss_n < cv_loss_0
    assert cv_eval_n < cv_eval_0

    # --- forward to a Kaldi archive, log-posteriors sum to 1 in prob ---
    post_ark = str(tmp_path / "post.ark")
    run_cli([os.path.join(BIN, "nnet-forward.py"), cv_scp, config, prev,
             "ark:" + post_ark, "--apply-log", "true"])
    posts = dict(kaldi.SequentialBaseFloatMatrixReader("ark:" + post_ark))
    assert len(posts) == 12
    some = next(iter(posts.values()))
    assert some.shape[1] == NUM_CLASSES
    np.testing.assert_allclose(np.exp(some).sum(axis=1), 1.0, atol=1e-4)

    # --- greedy decode CLI ---
    hyp_ark = str(tmp_path / "hyp.ark")
    run_cli([os.path.join(BIN, "nnet-decode.py"), cv_scp, config, prev,
             "ark,t:" + hyp_ark])
    hyps = dict(kaldi.SequentialInt32VectorReader("ark:" + hyp_ark))
    assert len(hyps) == 12
