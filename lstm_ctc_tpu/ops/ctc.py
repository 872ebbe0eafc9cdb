"""CTC loss — log-space forward/backward DP over the 2U+1 label lattice.

Functional mirror of ``tf.nn.ctc_loss(..., ignore_longer_outputs_than_
inputs=True)`` as used by the reference (nnet/graph.py:109-116):

  * logits are batch-major ``[B, T, V]`` and are softmax-normalized
    internally;
  * blank is the LAST class index (the toolkit's label convention: labels
    are shifted down by one at data prep and blank occupies index V-1,
    reference egs/wsj/run_wsj_phn.sh:129-139);
  * per-sequence loss = -log p(labels | logits); the caller sums over the
    batch (graph.py:115-116);
  * infeasible pairs — more labels than frames — get zero loss and zero
    gradient (the ``ignore_longer_outputs_than_inputs`` flag, graph.py:113).
    The same zeroing extends to pairs infeasible due to repeated labels
    (U + #repeats > T), which TF leaves at ±inf; data prep filters these
    (reference bin/convert-to-tfrecords.py:78-83).

Structure: the per-position label log-probs are gathered for the whole
sequence in one vectorized ``take_along_axis`` (no per-step gathers inside
the loop).  The alpha and beta recursions run either as ``lax.scan``s of
banded [B, 2U+1] updates or, on a GPU, as one Pallas kernel per recursion
(ops/ctc_pallas.py); ``dp_impl`` is the one place that chooses.  The
gradient is analytic via ``custom_vjp`` — softmax(logits) minus the
alpha·beta occupancy scattered back to classes with one batched [S→V]
matmul — instead of autodiff through the forward recursion.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import jax
import jax.numpy as jnp

from .. import logging_util as log

NEG_INF = -1e30

_logged_wide_lattice = False


def dp_impl(mesh, batch: int, ext_len: int, interpret: bool = False) -> str:
    """Choose how the alpha/beta recursions run: ``"kernel"`` (the Pallas
    kernels of ops/ctc_pallas.py) or ``"scan"``.

    The kernel runs on a GPU, and on any backend when ``interpret`` asks
    for the Pallas interpreter (tests); the scan everywhere else.
    ``LSTM_CTC_TPU_CTC_IMPL=scan|kernel`` overrides the choice; forcing
    the kernel where it cannot compile raises.  Two shape rules send the
    scan: a lattice row wider than the kernel keeps in registers (logged
    once), and a multi-device mesh that does not divide the batch (the
    kernel runs per shard under shard_map)."""
    global _logged_wide_lattice
    from .ctc_pallas import MAX_LATTICE, fits_kernel

    impl = os.environ.get("LSTM_CTC_TPU_CTC_IMPL", "auto")
    if impl not in ("auto", "scan", "kernel"):
        raise ValueError("LSTM_CTC_TPU_CTC_IMPL must be auto, scan or "
                         "kernel, not %r" % impl)
    if impl == "scan":
        return "scan"
    on_gpu = jax.default_backend() == "gpu"
    if not (on_gpu or interpret):
        if impl == "kernel":
            raise RuntimeError(
                "LSTM_CTC_TPU_CTC_IMPL=kernel: the CTC kernel compiles "
                "for a GPU only (backend is %r)" % jax.default_backend())
        return "scan"
    if _mesh_shards(mesh, batch) is None:
        return "scan"
    if not fits_kernel(ext_len):
        if not _logged_wide_lattice:
            _logged_wide_lattice = True
            log.info("ctc_loss: lattice width %d exceeds the kernel's %d; "
                     "using the lax.scan recursion" % (ext_len, MAX_LATTICE))
        return "scan"
    return "kernel"


def _mesh_shards(mesh, batch: int):
    """Number of per-batch shards the DP kernels run under shard_map
    with (1 = run the kernel directly, no mesh).  A multi-device mesh
    whose size does not divide the batch cannot shard: returns None."""
    if mesh is None:
        return 1
    size = mesh.devices.size
    if size <= 1:
        return 1
    return size if batch % size == 0 else None


def _shard_dp_kernel(mesh, fn, arg_kinds):
    """shard_map wrapper for the alpha/beta DP kernels over the batch
    axis.  ``arg_kinds``: one of "tbs" ([T, B, S]), "b" ([B]) or "bs"
    ([B, S]) per positional argument; output is [T, B, S].  A raw
    pallas_call inside a GSPMD jit would be replicated (all-gathered);
    per-shard invocation keeps the DP partitioning end-to-end."""
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    kind_spec = {"tbs": P(None, axis, None),
                 "b": P(axis),
                 "bs": P(axis, None)}
    in_specs = tuple(kind_spec[k] for k in arg_kinds)
    return jax.shard_map(
        fn, mesh=mesh,
        in_specs=in_specs,
        out_specs=P(None, axis, None),
        check_vma=False,
    )


def _run_kernel(fn, mesh, batch, args, kinds, interpret):
    run = functools.partial(fn, interpret=interpret)
    if _mesh_shards(mesh, batch) > 1:
        run = _shard_dp_kernel(mesh, run, kinds)
    return run(*args)


def _log3sum(a, b, c):
    """logsumexp of three stacked [B, S] terms, NEG_INF-safe."""
    m = jnp.maximum(jnp.maximum(a, b), c)
    out = m + jnp.log(jnp.exp(a - m) + jnp.exp(b - m) + jnp.exp(c - m))
    return jnp.where(m <= NEG_INF * 0.5, NEG_INF, out)


def _shift_right(x, amount):
    pad = jnp.full(x.shape[:-1] + (amount,), NEG_INF, x.dtype)
    return jnp.concatenate([pad, x[..., :-amount]], axis=-1)


def _shift_left(x, amount):
    pad = jnp.full(x.shape[:-1] + (amount,), NEG_INF, x.dtype)
    return jnp.concatenate([x[..., amount:], pad], axis=-1)


def _lattice(labels, label_length, blank_id):
    """Extended labels + transition masks for the 2U+1 lattice."""
    batch, max_u = labels.shape
    ext_len = 2 * max_u + 1
    safe = jnp.maximum(labels, 0)
    ext = jnp.full((batch, ext_len), blank_id, dtype=labels.dtype)
    ext = ext.at[:, 1::2].set(safe)
    s_range = jnp.arange(ext_len)[None, :]
    valid = s_range < (2 * label_length[:, None] + 1)         # [B, S]
    ext_prev2 = jnp.concatenate(
        [jnp.full((batch, 2), -1, dtype=ext.dtype), ext[:, :-2]], axis=1)
    can_skip = (s_range % 2 == 1) & (ext != ext_prev2) & (s_range >= 2)
    return ext, valid, can_skip


def _forward(logits, sequence_length, labels, label_length, blank_id,
             mesh=None, interpret=False):
    """Returns (loss [B], residuals for the backward pass)."""
    batch, max_t, _ = logits.shape
    ext, valid, can_skip = _lattice(labels, label_length, blank_id)

    log_probs = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    # [B, T, S] → [T, B, S]: one vectorized gather for the whole sequence
    lp_ext = jnp.take_along_axis(
        log_probs, ext[:, None, :], axis=2)
    lp_ext = jnp.moveaxis(lp_ext, 1, 0)

    s_range = jnp.arange(ext.shape[1])[None, :]
    init_mask = (s_range == 0) | ((s_range == 1) & (label_length[:, None] > 0))
    alpha0 = jnp.where(init_mask & valid, lp_ext[0], NEG_INF)

    if dp_impl(mesh, batch, ext.shape[1], interpret) == "kernel":
        from .ctc_pallas import alpha_pallas
        alpha_all = _run_kernel(
            alpha_pallas, mesh, batch,
            (lp_ext, sequence_length, valid, can_skip, alpha0),
            ("tbs", "b", "bs", "bs", "bs"), interpret)
        alpha_last = alpha_all[-1]
    else:
        time_mask = (jnp.arange(max_t)[:, None]
                     < sequence_length[None, :])              # [T, B]

        def fwd_step(alpha, inputs):
            lp, alive = inputs
            summed = _log3sum(alpha, _shift_right(alpha, 1),
                              jnp.where(can_skip, _shift_right(alpha, 2),
                                        NEG_INF))
            new_alpha = jnp.where(valid, summed + lp, NEG_INF)
            new_alpha = jnp.where(alive[:, None], new_alpha, alpha)
            return new_alpha, alpha

        alpha_last, alpha_hist = jax.lax.scan(
            fwd_step, alpha0, (lp_ext[1:], time_mask[1:]))
        alpha_last = jnp.where((sequence_length > 0)[:, None], alpha_last,
                               alpha0)
        # alpha_hist rows are PRE-step alphas → alpha at t = concat order
        alpha_all = jnp.concatenate([alpha_hist, alpha_last[None]], axis=0)

    end = 2 * label_length
    last_blank = jnp.take_along_axis(alpha_last, end[:, None], axis=1)[:, 0]
    last_label = jnp.take_along_axis(
        alpha_last, jnp.maximum(end - 1, 0)[:, None], axis=1)[:, 0]
    last_label = jnp.where(label_length > 0, last_label, NEG_INF)
    m = jnp.maximum(last_blank, last_label)
    log_lik = m + jnp.log(jnp.exp(last_blank - m) + jnp.exp(last_label - m))
    log_lik = jnp.where(m <= NEG_INF * 0.5, NEG_INF, log_lik)

    feasible = (label_length <= sequence_length) \
        & (sequence_length > 0) & (log_lik > NEG_INF * 0.5)
    loss = jnp.where(feasible, -log_lik, 0.0)
    residuals = (log_probs, lp_ext, alpha_all, log_lik, feasible,
                 ext, valid, can_skip, sequence_length, label_length,
                 jnp.zeros((0,), logits.dtype))   # primal-dtype sentinel
    return loss, residuals


def _backward(residuals, grad_loss, mesh=None, interpret=False):
    """Analytic gradient: softmax - occupancy, scaled per-row by the
    upstream cotangent of each sequence's loss."""
    (log_probs, lp_ext, alpha_all, log_lik, feasible,
     ext, valid, can_skip, sequence_length, label_length,
     dtype_sentinel) = residuals
    max_t, batch, ext_len = lp_ext.shape
    num_classes = log_probs.shape[2]

    s_range = jnp.arange(ext_len)[None, :]
    end = 2 * label_length[:, None]
    final_mask = (s_range == end) | ((s_range == end - 1)
                                     & (label_length[:, None] > 0))
    # beta includes its own emission term: beta'_t(s) = log P(emit s at t,
    # then finish) so that gamma_t = alpha_t + beta'_t - lp_ext_t - loglik.
    time_mask = (jnp.arange(max_t)[:, None] < sequence_length[None, :])

    # beta at the last *valid* frame per sequence: emission at that frame
    # for the two final states.  We scan in reverse over the padded buffer;
    # frames past sequence_length carry beta through unchanged after
    # initializing at the per-sequence last frame.
    # transition s → s+2 is allowed iff can_skip holds at the DESTINATION
    skip_from = jnp.concatenate(
        [can_skip[:, 2:], jnp.zeros((batch, 2), dtype=bool)], axis=1)
    # iterate t = T-1 .. 0; is_last marks t == sequence_length-1
    t_index = jnp.arange(max_t)
    is_last = (t_index[:, None] == (sequence_length - 1)[None, :])

    if dp_impl(mesh, batch, ext_len, interpret) == "kernel":
        from .ctc_pallas import beta_pallas
        beta_all = _run_kernel(
            beta_pallas, mesh, batch,
            (lp_ext, sequence_length, valid, skip_from, final_mask & valid),
            ("tbs", "b", "bs", "bs", "bs"), interpret)
    else:
        def bwd_step(beta, inputs):
            lp, alive, last = inputs
            # initialize at each sequence's final frame
            init = jnp.where(final_mask & valid, lp, NEG_INF)
            moved = _log3sum(beta, _shift_left(beta, 1),
                             jnp.where(skip_from, _shift_left(beta, 2),
                                       NEG_INF))
            new_beta = jnp.where(valid, moved + lp, NEG_INF)
            new_beta = jnp.where(last[:, None], init, new_beta)
            new_beta = jnp.where(alive[:, None], new_beta, beta)
            return new_beta, new_beta

        beta_init = jnp.full((batch, ext_len), NEG_INF, jnp.float32)
        _, beta_all_rev = jax.lax.scan(
            bwd_step, beta_init,
            (lp_ext[::-1], time_mask[::-1], is_last[::-1]))
        beta_all = beta_all_rev[::-1]                         # [T, B, S]

    # occupancy gamma_t(s) = alpha_t + beta_t - lp_ext_t - loglik
    gamma_log = alpha_all + beta_all - lp_ext - log_lik[None, :, None]
    gamma_log = jnp.where(valid[None] & time_mask[:, :, None]
                          & feasible[None, :, None], gamma_log, NEG_INF)
    # occupancy is a probability; the clamp guards exp() against the
    # NEG_INF arithmetic of infeasible rows leaking through as +inf
    gamma = jnp.exp(jnp.minimum(gamma_log, 0.0))              # [T, B, S]

    # scatter occupancy back to classes: one batched [S→V] matmul
    onehot = jax.nn.one_hot(ext, num_classes, dtype=jnp.float32)  # [B,S,V]
    occ = jnp.einsum("tbs,bsv->btv", gamma, onehot)           # [B, T, V]

    softmax = jnp.exp(log_probs)
    grad = softmax - occ
    grad = grad * time_mask.T[:, :, None]
    grad = grad * feasible[:, None, None]
    grad = grad * grad_loss[:, None, None]
    # cotangent dtype must match the primal (custom_vjp aval check)
    return grad.astype(dtype_sentinel.dtype)


@functools.lru_cache(maxsize=8)
def _make_ctc_core(mesh, interpret=False):
    """custom_vjp CTC core closed over the (static, hashable) mesh: on a
    multi-device mesh the alpha/beta kernels run per-shard under
    shard_map (a raw pallas_call in a GSPMD jit would be all-gathered).
    ``mesh=None`` → the single-device/jit-partitioned form."""

    @jax.custom_vjp
    def core(logits, sequence_length, labels, label_length, blank_id):
        loss, _ = _forward(logits, sequence_length, labels, label_length,
                           blank_id, mesh=mesh, interpret=interpret)
        return loss

    def core_fwd(logits, sequence_length, labels, label_length, blank_id):
        loss, residuals = _forward(logits, sequence_length, labels,
                                   label_length, blank_id, mesh=mesh,
                                   interpret=interpret)
        return loss, residuals

    def core_bwd(residuals, grad_loss):
        grad_logits = _backward(residuals, grad_loss, mesh=mesh,
                                interpret=interpret)
        return grad_logits, None, None, None, None

    core.defvjp(core_fwd, core_bwd)
    return core


def ctc_loss(logits: jnp.ndarray,
             sequence_length: jnp.ndarray,
             labels: jnp.ndarray,
             label_length: Optional[jnp.ndarray] = None,
             blank_id: Optional[int] = None,
             mesh=None,
             interpret: bool = False) -> jnp.ndarray:
    """Per-sequence negative log-likelihood, shape [B].

    ``mesh``: optional jax.sharding.Mesh for data-parallel training —
    the DP kernels run per shard under shard_map so the batch-sharded
    lattice never gets all-gathered (train/graph.py threads
    ``config["mesh"]``).  ``interpret``: run the DP kernels in the Pallas
    interpreter (tests on a host without a GPU; see ``dp_impl``)."""
    num_classes = logits.shape[2]
    if blank_id is None:
        blank_id = num_classes - 1
    if label_length is None:
        label_length = jnp.sum((labels >= 0).astype(jnp.int32), axis=1)
    if labels.shape[1] == 0:
        # a zero-column label matrix (every reference empty) would give
        # the DP a width-1 lattice the scan carries cannot shift over;
        # the only path is all-blank — loss = −Σ_t log P(blank)
        log_probs = jax.nn.log_softmax(
            logits.astype(jnp.float32), axis=2)
        t_idx = jnp.arange(logits.shape[1])
        mask = t_idx[None, :] < sequence_length[:, None]
        return -jnp.sum(
            jnp.where(mask, log_probs[:, :, blank_id], 0.0),
            axis=1).astype(logits.dtype)
    return _make_ctc_core(mesh, interpret)(logits, sequence_length, labels,
                                           label_length, blank_id)
