"""Shell-layer integration: tfrecord.sh conversion fan-out and the
train_oplr.sh outer loop on a synthetic corpus (marked slow)."""

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
    env.pop("XLA_FLAGS", None)  # no virtual multi-device in subprocesses
    return env


def run(cmd, **kw):
    proc = subprocess.run(cmd, capture_output=True, text=True, env=sh_env(),
                          cwd=REPO, **kw)
    assert proc.returncode == 0, "%s failed:\nstdout:\n%s\nstderr:\n%s" % (
        cmd, proc.stdout[-3000:], proc.stderr[-2000:])
    return proc


def make_corpus(tmp_path, tag, num_utts, seed):
    rng = np.random.RandomState(seed)
    means = np.random.RandomState(11).randn(NUM_CLASSES - 1, INPUT_DIM) * 2.0
    feats_ark = str(tmp_path / ("feats_%s.ark" % tag))
    feats_scp = str(tmp_path / ("feats_%s.scp" % tag))
    labels_ark = str(tmp_path / ("labels_%s.ark" % tag))
    labels_scp = str(tmp_path / ("labels_%s.scp" % tag))
    with kaldi.BaseFloatMatrixWriter(
            "ark,scp:%s,%s" % (feats_ark, feats_scp)) as fw, \
            kaldi.Int32VectorWriter(
                "ark,scp:%s,%s" % (labels_ark, labels_scp)) as lw:
        for i in range(num_utts):
            labels = rng.randint(0, NUM_CLASSES - 1, rng.randint(2, 5))
            frames = [means[lab] + 0.3 * rng.randn(rng.randint(2, 4),
                                                   INPUT_DIM)
                      for lab in labels]
            key = "%s_%03d" % (tag, i)
            fw.Write(key, np.concatenate(frames).astype(np.float32))
            lw.Write(key, labels.astype(np.int32))
    return feats_scp, labels_scp, feats_ark


@pytest.mark.slow
def test_tfrecord_sh_and_train_oplr_sh(tmp_path):
    tr_feats_scp, tr_labels_scp, tr_ark = make_corpus(tmp_path, "tr", 24, 3)
    cv_feats_scp, cv_labels_scp, _ = make_corpus(tmp_path, "cv", 8, 4)

    # global CMVN stats from training features
    cmvn = str(tmp_path / "cmvn.mat")
    run([sys.executable, os.path.join(REPO, "bin", "compute-cmvn-stats.py"),
         "scp:" + tr_feats_scp, cmvn])

    # conversion fan-out via tfrecord.sh (2 jobs)
    for tag, fscp, lscp in [("tr", tr_feats_scp, tr_labels_scp),
                            ("cv", cv_feats_scp, cv_labels_scp)]:
        run(["bash", os.path.join(SCRIPTS, "tfrecord.sh"),
             "--feats-scp", fscp, "--trans-scp", lscp,
             "--cmvn-ark", cmvn, "--nj", "2",
             "--dir", str(tmp_path / ("rec_" + tag))])
        scp = tmp_path / ("rec_" + tag) / "tfrecords.scp"
        assert scp.exists() and len(scp.read_text().splitlines()) > 0

    # nnet.config
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

    # outer loop: 2 iterations of train_oplr.sh
    exp = tmp_path / "exp"
    run(["bash", os.path.join(SCRIPTS, "train_oplr.sh"),
         "--tr-tfrecords-scp", str(tmp_path / "rec_tr" / "tfrecords.scp"),
         "--cv-tfrecords-scp", str(tmp_path / "rec_cv" / "tfrecords.scp"),
         "--nnet-config", str(config), "--dir", str(exp),
         "--objective", "ctc", "--optimizer", "adam",
         "--learn-rate", "0.005", "--max-iter", "2", "--min-iters", "0",
         "--batch-size", "8", "--cv-goal", "loss", "--shuffle", "true",
         # epoch training on packed rows via the recipe-level
         # pass-through (the WSJ/Libri recipes use this flag)
         "--train-extra-opts", "--pack-factor 2"])

    assert (exp / "final.nnet").exists()
    assert (exp / "nnet.1.done").exists()
    assert (exp / "nnet.2.done").exists()
    final = (exp / "final.nnet").read_text().strip()
    assert (exp / final).exists()
    # training reduced the loss vs iteration-0 CV
    cv0 = float((exp / "nnet.0.done").read_text().split()[1])
    done2 = dict(line.split() for line in
                 (exp / "nnet.2.done").read_text().splitlines())
    assert float(done2["cv_loss"]) < cv0

    # resumability: rerunning skips all iterations (fast) and keeps state
    out = run(["bash", os.path.join(SCRIPTS, "train_oplr.sh"),
               "--tr-tfrecords-scp", str(tmp_path / "rec_tr" / "tfrecords.scp"),
               "--cv-tfrecords-scp", str(tmp_path / "rec_cv" / "tfrecords.scp"),
               "--nnet-config", str(config), "--dir", str(exp),
               "--objective", "ctc", "--max-iter", "2", "--min-iters", "0",
               "--batch-size", "8", "--cv-goal", "loss"]).stdout
    assert out.count("exists, skipping this iteration") == 2


@pytest.mark.slow
def test_decode_sh_greedy_per(tmp_path):
    """Self-contained PER scoring path: decode.sh → int2sym → compute-wer."""
    tr_feats_scp, tr_labels_scp, _ = make_corpus(tmp_path, "tr", 24, 5)
    cmvn = str(tmp_path / "cmvn.mat")
    run([sys.executable, os.path.join(REPO, "bin", "compute-cmvn-stats.py"),
         "scp:" + tr_feats_scp, cmvn])
    run(["bash", os.path.join(SCRIPTS, "tfrecord.sh"),
         "--feats-scp", tr_feats_scp, "--trans-scp", tr_labels_scp,
         "--cmvn-ark", cmvn, "--nj", "1",
         "--dir", str(tmp_path / "rec")])

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

    exp = tmp_path / "exp"
    run(["bash", os.path.join(SCRIPTS, "train_oplr.sh"),
         "--tr-tfrecords-scp", str(tmp_path / "rec" / "tfrecords.scp"),
         "--cv-tfrecords-scp", str(tmp_path / "rec" / "tfrecords.scp"),
         "--nnet-config", str(config), "--dir", str(exp),
         "--objective", "ctc", "--optimizer", "adam",
         "--learn-rate", "0.008", "--max-iter", "10", "--min-iters", "10",
         "--batch-size", "8", "--cv-goal", "loss", "--shuffle", "true"])

    # units table and reference text
    units = tmp_path / "units.txt"
    units.write_text("".join("u%d %d\n" % (i, i)
                             for i in range(NUM_CLASSES - 1)))
    ans = tmp_path / "text"
    with open(ans, "w") as fh:
        for key, vec in kaldi.SequentialInt32VectorReader(
                "scp:" + tr_labels_scp):
            fh.write("%s %s\n" % (key,
                                  " ".join("u%d" % v for v in vec)))

    run(["bash", os.path.join(SCRIPTS, "decode.sh"),
         "--tfrecords-scp", str(tmp_path / "rec" / "tfrecords.scp"),
         "--nnet-config", str(config),
         "--units", str(units), "--ans", str(ans),
         "--dir", str(exp / "decode")])
    per = (exp / "decode" / "per").read_text()
    assert "summary wer:" in per
    summary_wer = float(per.split("summary wer:")[1].split()[0])
    assert summary_wer < 0.3, "PER too high after training: %s" % summary_wer


@pytest.mark.slow
def test_train_variants_and_warm_start(tmp_path):
    """train.sh (plain newbob) and train_decay.sh run; train_oplr.sh
    --srcdir warm-starts from another experiment's final.nnet."""
    feats_scp, labels_scp, _ = make_corpus(tmp_path, "tr", 16, 9)
    cmvn = str(tmp_path / "cmvn.mat")
    run([sys.executable, os.path.join(REPO, "bin", "compute-cmvn-stats.py"),
         "scp:" + feats_scp, cmvn])
    run(["bash", os.path.join(SCRIPTS, "tfrecord.sh"),
         "--feats-scp", feats_scp, "--trans-scp", labels_scp,
         "--cmvn-ark", cmvn, "--nj", "1", "--dir", str(tmp_path / "rec")])
    scp = str(tmp_path / "rec" / "tfrecords.scp")

    config = tmp_path / "nnet.config"
    config.write_text("""nnet_type = lstm
input_dim = %d
left_context = 0
right_context = 0
subsample = 0
num_layers = 1
num_neurons = 12
num_projects = 12
num_targets = %d
use_peepholes = true
dropout_rate = 1.0
num_experts = 0
seed = 3
""" % (INPUT_DIM, NUM_CLASSES))

    common = ["--tr-tfrecords-scp", scp, "--cv-tfrecords-scp", scp,
              "--objective", "ctc", "--optimizer", "adam",
              "--learn-rate", "0.004", "--max-iter", "1",
              "--min-iters", "0", "--batch-size", "8",
              "--cv-goal", "loss"]

    for script in ("train.sh", "train_decay.sh"):
        exp = tmp_path / ("exp_" + script.replace(".sh", ""))
        run(["bash", os.path.join(SCRIPTS, script),
             "--nnet-config", str(config), "--dir", str(exp)] + common)
        assert (exp / "final.nnet").exists()
        final = (exp / "final.nnet").read_text().strip()
        assert (exp / final).exists()

    # warm start: srcdir points at the finished train.sh experiment
    src_exp = tmp_path / "exp_train"
    warm = tmp_path / "exp_warm"
    run(["bash", os.path.join(SCRIPTS, "train_oplr.sh"),
         "--srcdir", str(src_exp), "--dir", str(warm)] + common)
    assert (warm / "final.nnet").exists()
    # iteration 0 validated the warm-start model (no nnet.0 file created)
    assert not (warm / "nnet.0").exists()
    assert (warm / "nnet.0.done").exists()


@pytest.mark.slow
def test_kill_mid_epoch_resumes_cleanly(tmp_path):
    """Fault injection: SIGKILL nnet-train mid-epoch; the checkpoint
    write is atomic (tmp+rename) and the outer loop redoes the epoch on
    rerun (idempotent .done markers)."""
    import signal
    import time

    feats_scp, labels_scp, _ = make_corpus(tmp_path, "tr", 24, 13)
    cmvn = str(tmp_path / "cmvn.mat")
    run([sys.executable, os.path.join(REPO, "bin", "compute-cmvn-stats.py"),
         "scp:" + feats_scp, cmvn])
    run(["bash", os.path.join(SCRIPTS, "tfrecord.sh"),
         "--feats-scp", feats_scp, "--trans-scp", labels_scp,
         "--cmvn-ark", cmvn, "--nj", "1", "--dir", str(tmp_path / "rec")])
    scp = str(tmp_path / "rec" / "tfrecords.scp")

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

    exp = tmp_path / "exp"
    exp.mkdir()
    run([sys.executable, os.path.join(REPO, "bin", "nnet-init.py"),
         scp, str(config), str(exp / "nnet.0"),
         "--objective", "ctc", "--batch-size", "8"])
    (exp / "nnet.0.done").write_text("cv_loss 10.0\ncv_eval 1.0\n")

    # launch one epoch and kill it while it runs
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "bin", "nnet-train.py"),
         scp, str(config), str(exp / "nnet.0"), str(exp / "nnet.1"),
         "--objective", "ctc", "--optimizer", "adam",
         "--learn-rate", "0.004", "--batch-size", "8"],
        env=sh_env(), cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    time.sleep(4.0)  # inside jax init / first batches
    proc.kill()
    proc.wait()
    # atomicity: either no nnet.1 at all, or only the .tmp leftover —
    # never a corrupt half-written checkpoint at the final path
    if (exp / "nnet.1").exists():
        import numpy as np_  # noqa
        np.load(str(exp / "nnet.1"))  # must be a valid npz if present

    # the outer loop redoes the epoch and completes
    run(["bash", os.path.join(SCRIPTS, "train_oplr.sh"),
         "--tr-tfrecords-scp", scp, "--cv-tfrecords-scp", scp,
         "--nnet-config", str(config), "--dir", str(exp),
         "--objective", "ctc", "--optimizer", "adam",
         "--learn-rate", "0.004", "--max-iter", "2", "--min-iters", "0",
         "--batch-size", "8", "--cv-goal", "loss"])
    assert (exp / "nnet.1.done").exists()
    assert (exp / "nnet.2.done").exists()
    final = (exp / "final.nnet").read_text().strip()
    np.load(str(exp / final))
