"""bin/nnet-train-loop.py (in-process outer loop) must reproduce
scripts/train_oplr.sh (one process per epoch) exactly: same checkpoint
bytes per iteration, same accept/reject + LR trajectory, same .done
stats.  The in-process driver exists for runs where per-process
start-up dominates; this test pins that the change is purely
operational."""

import os
import subprocess
import sys

import numpy as np
import pytest

from lstm_ctc_tpu import kaldi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")

NUM_CLASSES = 5
INPUT_DIM = 8


def sh_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHON"] = sys.executable
    env.pop("XLA_FLAGS", None)
    return env


def run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          env=sh_env(), cwd=REPO)
    assert proc.returncode == 0, "%s failed:\nstdout:\n%s\nstderr:\n%s" % (
        cmd, proc.stdout[-3000:], proc.stderr[-2000:])
    return proc


def make_records(tmp_path):
    rng = np.random.RandomState(3)
    means = np.random.RandomState(11).randn(NUM_CLASSES - 1, INPUT_DIM) * 2.0
    feats_ark = str(tmp_path / "feats.ark")
    feats_scp = str(tmp_path / "feats.scp")
    labels_ark = str(tmp_path / "labels.ark")
    labels_scp = str(tmp_path / "labels.scp")
    with kaldi.BaseFloatMatrixWriter(
            "ark,scp:%s,%s" % (feats_ark, feats_scp)) as fw, \
            kaldi.Int32VectorWriter(
                "ark,scp:%s,%s" % (labels_ark, labels_scp)) as lw:
        for i in range(24):
            labels = rng.randint(0, NUM_CLASSES - 1, rng.randint(2, 5))
            frames = [means[lab] + 0.3 * rng.randn(rng.randint(2, 4),
                                                   INPUT_DIM)
                      for lab in labels]
            fw.Write("utt%03d" % i, np.concatenate(frames).astype(np.float32))
            lw.Write("utt%03d" % i, labels.astype(np.int32))
    cmvn = str(tmp_path / "cmvn.mat")
    run([sys.executable, os.path.join(REPO, "bin", "compute-cmvn-stats.py"),
         "scp:" + feats_scp, cmvn])
    run(["bash", os.path.join(SCRIPTS, "tfrecord.sh"),
         "--feats-scp", feats_scp, "--trans-scp", labels_scp,
         "--cmvn-ark", cmvn, "--nj", "1",
         "--dir", str(tmp_path / "rec")])
    return str(tmp_path / "rec" / "tfrecords.scp")


@pytest.mark.slow
def test_inproc_loop_matches_script_loop(tmp_path):
    scp = make_records(tmp_path)
    config = tmp_path / "nnet.config"
    config.write_text("""nnet_type = blstm
input_dim = %d
left_context = 0
right_context = 0
subsample = 0
num_layers = 1
num_neurons = 16
num_projects = 8
num_targets = %d
use_peepholes = true
dropout_rate = 1.0
num_experts = 0
seed = 3
""" % (INPUT_DIM, NUM_CLASSES))

    common = ["--tr-tfrecords-scp", scp, "--cv-tfrecords-scp", scp,
              "--nnet-config", str(config),
              "--objective", "ctc", "--optimizer", "adam",
              "--learn-rate", "0.005", "--max-iter", "3",
              "--min-iters", "0", "--batch-size", "8",
              "--cv-goal", "loss", "--shuffle", "true"]
    exp_script = tmp_path / "exp_script"
    exp_inproc = tmp_path / "exp_inproc"
    run(["bash", os.path.join(SCRIPTS, "train_oplr.sh"),
         "--dir", str(exp_script)] + common)
    out = run([sys.executable,
               os.path.join(REPO, "bin", "nnet-train-loop.py"),
               "--dir", str(exp_inproc)] + common).stdout

    # same artifacts, iteration by iteration
    for it in range(4):
        a = exp_script / ("nnet.%d" % it)
        b = exp_inproc / ("nnet.%d" % it)
        assert a.exists() == b.exists(), it
        if not a.exists():
            continue
        with np.load(a) as da, np.load(b) as db:
            assert sorted(da.files) == sorted(db.files)
            for k in da.files:
                np.testing.assert_array_equal(da[k], db[k],
                                              err_msg="iter %d %s" % (it, k))
        da_done = dict(line.split() for line in
                       (exp_script / ("nnet.%d.done" % it))
                       .read_text().splitlines())
        db_done = dict(line.split() for line in
                       (exp_inproc / ("nnet.%d.done" % it))
                       .read_text().splitlines())
        for key in da_done:
            assert abs(float(da_done[key]) - float(db_done[key])) < 1e-5, \
                (it, key, da_done, db_done)

    assert (exp_script / "final.nnet").read_text().strip() == \
        (exp_inproc / "final.nnet").read_text().strip()
    # the inproc driver resumes off the same .done markers
    out2 = run([sys.executable,
                os.path.join(REPO, "bin", "nnet-train-loop.py"),
                "--dir", str(exp_inproc)] + common).stdout
    assert out2.count("skipping this iteration") == 3
