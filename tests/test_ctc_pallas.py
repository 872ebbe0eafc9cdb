"""Pallas CTC kernels (Pallas interpreter on CPU) vs the lax.scan path,
and the one function that chooses between them (ops/ctc.dp_impl)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lstm_ctc_tpu.ops import ctc, ctc_pallas


def make_case(seed, B=3, T=70, V=6, U=5):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, V).astype(np.float32)
    seq_len = rng.randint(T // 2, T + 1, B).astype(np.int32)
    seq_len[0] = T
    labels = np.full((B, U), -1, np.int32)
    label_len = np.zeros((B,), np.int32)
    for b in range(B):
        u = rng.randint(1, U + 1)
        labels[b, :u] = rng.randint(0, V - 1, u)
        label_len[b] = u
    if U > 1 and label_len[0] > 1:
        labels[0, 1] = labels[0, 0]   # a repeat: no s-2 skip there
    if B > 2:
        labels[2, :] = -1     # empty-label row
        label_len[2] = 0
    if B > 1:
        seq_len[1] = 0        # dummy padding row (zero-length sequence)
    return (jnp.asarray(logits), jnp.asarray(seq_len), jnp.asarray(labels),
            jnp.asarray(label_len))


def loss_and_grad(args, **kw):
    loss = ctc.ctc_loss(*args, **kw)
    grad = jax.grad(lambda lg: jnp.sum(ctc.ctc_loss(lg, *args[1:], **kw)))(
        args[0])
    return np.asarray(loss), np.asarray(grad)


def check_matches_scan(args):
    ref_loss, ref_grad = loss_and_grad(args)               # CPU: scan
    got_loss, got_grad = loss_and_grad(args, interpret=True)
    np.testing.assert_allclose(got_loss, ref_loss, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_grad, ref_grad, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pallas_matches_scan_values_and_grads(seed):
    check_matches_scan(make_case(seed))


@pytest.mark.parametrize("seed,shape", [
    (8, {"B": 1, "T": 9, "U": 1}),  # a single short row, S = 3
    (9, {"U": 13, "V": 30}),        # S = 27: block padded to 32
])
def test_kernel_matches_scan_values_and_grads(seed, shape):
    check_matches_scan(make_case(seed, **shape))


def test_pallas_batch_tiling():
    """The grid runs one program per row: many rows, each its own
    lattice and length, match the scan."""
    check_matches_scan(make_case(7, B=11, T=40))


def test_pallas_time_block_boundary():
    """The time loop runs inside one program with no time blocks: an
    odd T matches the scan."""
    check_matches_scan(make_case(5, T=33))


def test_pallas_blocks_large_batch(monkeypatch):
    """B=128 WSJ-shaped lattices (U=120, S=241) stay on the kernel path:
    rows are grid programs, so the batch never sends the scan."""
    monkeypatch.delenv("LSTM_CTC_TPU_CTC_IMPL", raising=False)
    assert ctc.dp_impl(None, 128, 2 * 120 + 1, interpret=True) == "kernel"


def test_kernel_infeasible_pairs_get_zero_loss_and_grad():
    """More labels than frames (and repeats that need blanks between
    them) are infeasible: zero loss, zero gradient, as in the scan."""
    args = list(make_case(3, B=3, T=6, U=5))
    args[1] = jnp.asarray([6, 3, 6], jnp.int32)
    args[2] = jnp.asarray([[1, 1, 1, 1, -1], [0, 1, 2, 3, 4],
                           [2, -1, -1, -1, -1]], jnp.int32)
    args[3] = jnp.asarray([4, 5, 1], jnp.int32)
    ref_loss, ref_grad = loss_and_grad(args)
    got_loss, got_grad = loss_and_grad(args, interpret=True)
    assert got_loss[0] == 0.0 and got_loss[1] == 0.0 and got_loss[2] > 0
    np.testing.assert_array_equal(got_grad[:2], 0.0)
    np.testing.assert_allclose(got_loss, ref_loss, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_grad, ref_grad, atol=1e-5)


def test_alpha_rows_past_the_end_repeat_the_last():
    """The alpha buffer holds alpha_t for every t; rows past a
    sequence's end repeat its last alpha (what the loss reads)."""
    logits, seq_len, labels, label_len = make_case(4, B=2, T=12)
    seq_len = jnp.asarray([12, 7], jnp.int32)
    ext, valid, can_skip = ctc._lattice(labels, label_len, 5)
    lp = jnp.take_along_axis(jax.nn.log_softmax(logits), ext[:, None, :],
                             axis=2).transpose(1, 0, 2)
    alpha0 = jnp.where(valid & (jnp.arange(ext.shape[1]) < 2), lp[0],
                       ctc.NEG_INF)
    alpha = np.asarray(ctc_pallas.alpha_pallas(
        lp, seq_len, valid, can_skip, alpha0, interpret=True))
    np.testing.assert_array_equal(alpha[0], np.asarray(alpha0))
    for t in range(7, 12):
        np.testing.assert_array_equal(alpha[t, 1], alpha[6, 1])


# ---------------------------------------------------------- selection
def test_dp_impl_auto_is_scan_on_cpu(monkeypatch):
    monkeypatch.delenv("LSTM_CTC_TPU_CTC_IMPL", raising=False)
    assert ctc.dp_impl(None, 4, 21) == "scan"
    assert ctc.dp_impl(None, 4, 21, interpret=True) == "kernel"


def test_dp_impl_env_scan_wins(monkeypatch):
    monkeypatch.setenv("LSTM_CTC_TPU_CTC_IMPL", "scan")
    assert ctc.dp_impl(None, 4, 21, interpret=True) == "scan"


def test_dp_impl_forced_kernel_off_gpu_raises(monkeypatch):
    monkeypatch.setenv("LSTM_CTC_TPU_CTC_IMPL", "kernel")
    with pytest.raises(RuntimeError, match="GPU only"):
        ctc.dp_impl(None, 4, 21)
    args = make_case(0)
    with pytest.raises(RuntimeError, match="GPU only"):
        ctc.ctc_loss(*args)


def test_dp_impl_rejects_unknown_value(monkeypatch):
    monkeypatch.setenv("LSTM_CTC_TPU_CTC_IMPL", "pallas")
    with pytest.raises(ValueError, match="auto, scan or kernel"):
        ctc.dp_impl(None, 4, 21)


def test_dp_impl_wide_lattice_takes_the_scan_and_logs_once(monkeypatch,
                                                           capsys):
    monkeypatch.delenv("LSTM_CTC_TPU_CTC_IMPL", raising=False)
    monkeypatch.setattr(ctc, "_logged_wide_lattice", False)
    widest = ctc_pallas.MAX_LATTICE
    assert ctc.dp_impl(None, 4, widest, interpret=True) == "kernel"
    assert ctc.dp_impl(None, 4, widest + 1, interpret=True) == "scan"
    assert ctc.dp_impl(None, 4, widest + 1, interpret=True) == "scan"
    err = capsys.readouterr().err
    assert err.count("exceeds the kernel") == 1


@pytest.mark.parametrize("ext_len,block", [(1, 1), (3, 4), (257, 512),
                                           (512, 512), (4097, 8192)])
def test_lattice_block_is_the_next_power_of_two(ext_len, block):
    assert ctc_pallas.lattice_block(ext_len) == block
    assert ctc_pallas.fits_kernel(ext_len) == (block <= 4096)
