"""Pallas (Triton route) kernels for the CTC alpha/beta recursions.

The ``lax.scan`` recursions in ops/ctc.py run 2·T sequential steps of a
tiny banded [B, S] update (S = 2U+1), so on a GPU each step costs a few
kernel launches of microseconds of work.  These kernels run the whole time
loop inside one program per utterance: the grid is over batch rows (rows
are independent, so programs need not run in any order), and the T loop
is a ``fori_loop`` inside the program.

The recursion needs the previous step's row shifted by one and two
lattice positions.  Triton has no shuffle across the lanes of a block, so
each step reads the previous row back from the output buffer at offsets
s, s∓1 and s∓2 (masked at the edges), after a block-wide barrier that
makes the previous step's store visible to every thread of the program.

Buffers are passed flat, with two leading and one trailing row of
padding, so every shifted window is a plain in-bounds slice — interpret
mode (which clamps out-of-range slices) then computes exactly what the
compiled kernel does.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NEG_INF = -1e30

# Widest lattice row (S = 2U+1, padded to a power of two) a program keeps
# in registers; wider rows take the scan (ops/ctc.py).
MAX_LATTICE = 4096


def lattice_block(ext_len: int) -> int:
    """Power-of-two block that holds one lattice row."""
    return pl.next_power_of_2(ext_len)


def fits_kernel(ext_len: int) -> bool:
    return lattice_block(ext_len) <= MAX_LATTICE


def _num_warps(block: int) -> int:
    return max(1, min(8, block // 128))


def _log3(a, b, c):
    m = jnp.maximum(jnp.maximum(a, b), c)
    out = m + jnp.log(jnp.exp(a - m) + jnp.exp(b - m) + jnp.exp(c - m))
    return jnp.where(m <= NEG_INF * 0.5, NEG_INF, out)


def _row(ref, start, block, mask):
    return plgpu.load(ref.at[pl.ds(start, block)], mask=mask, other=NEG_INF)


def _alpha_kernel(lp_ref, len_ref, valid_ref, skip_ref, init_ref, out_ref,
                  *, max_t, batch, ext_len, block, interpret):
    b = pl.program_id(0)
    s = jnp.arange(block)
    in_row = s < ext_len
    row0 = PAD + b * ext_len
    valid = plgpu.load(valid_ref.at[pl.ds(b * ext_len, block)],
                       mask=in_row, other=0) > 0
    can_skip = plgpu.load(skip_ref.at[pl.ds(b * ext_len, block)],
                          mask=in_row, other=0) > 0
    seq_len = len_ref[b]
    alpha0 = _row(init_ref, b * ext_len, block, in_row)
    plgpu.store(out_ref.at[pl.ds(row0, block)], alpha0, mask=in_row)

    def step(t, carry):
        if not interpret:
            plgpu.debug_barrier()     # previous row stored by all threads
        prev = PAD + ((t - 1) * batch + b) * ext_len
        cur = PAD + (t * batch + b) * ext_len
        alpha = _row(out_ref, prev, block, in_row)
        alpha1 = _row(out_ref, prev - 1, block, in_row & (s >= 1))
        alpha2 = _row(out_ref, prev - 2, block, in_row & (s >= 2) & can_skip)
        lp = _row(lp_ref, cur - PAD, block, in_row)
        new = jnp.where(valid, _log3(alpha, alpha1, alpha2) + lp, NEG_INF)
        new = jnp.where(t < seq_len, new, alpha)
        plgpu.store(out_ref.at[pl.ds(cur, block)], new, mask=in_row)
        return carry

    jax.lax.fori_loop(1, max_t, step, 0)


def _beta_kernel(lp_ref, len_ref, valid_ref, skip_ref, final_ref, out_ref,
                 *, max_t, batch, ext_len, block, interpret):
    b = pl.program_id(0)
    s = jnp.arange(block)
    in_row = s < ext_len
    valid = plgpu.load(valid_ref.at[pl.ds(b * ext_len, block)],
                       mask=in_row, other=0) > 0
    skip_from = plgpu.load(skip_ref.at[pl.ds(b * ext_len, block)],
                           mask=in_row, other=0) > 0
    final = plgpu.load(final_ref.at[pl.ds(b * ext_len, block)],
                       mask=in_row, other=0) > 0
    seq_len = len_ref[b]

    def step(i, carry):
        t = max_t - 1 - i
        if not interpret:
            plgpu.debug_barrier()     # next row stored by all threads
        cur = PAD + (t * batch + b) * ext_len
        nxt = PAD + ((t + 1) * batch + b) * ext_len
        has_next = t + 1 < max_t
        beta = _row(out_ref, nxt, block, in_row & has_next)
        beta1 = _row(out_ref, nxt + 1, block,
                     has_next & (s + 1 < ext_len))
        beta2 = _row(out_ref, nxt + 2, block,
                     has_next & (s + 2 < ext_len) & skip_from)
        lp = _row(lp_ref, cur - PAD, block, in_row)
        new = jnp.where(valid, _log3(beta, beta1, beta2) + lp, NEG_INF)
        init = jnp.where(final & valid, lp, NEG_INF)
        new = jnp.where(t == seq_len - 1, init, new)
        new = jnp.where(t < seq_len, new, beta)
        plgpu.store(out_ref.at[pl.ds(cur, block)], new, mask=in_row)
        return carry

    jax.lax.fori_loop(0, max_t, step, 0)


# leading padding of the flat output: room for the s-1 / s-2 windows
PAD = 2


def _flat(x, trailing):
    """Flatten and append ``trailing`` zeros so that a block-wide window
    starting at any row stays inside the buffer."""
    flat = x.reshape(-1)
    return jnp.concatenate([flat, jnp.zeros((trailing,), flat.dtype)])


def _run(kernel, lp_ext, sequence_length, rows, interpret):
    max_t, batch, ext_len = lp_ext.shape
    block = lattice_block(ext_len)
    out_len = PAD + max_t * batch * ext_len + block
    body = functools.partial(kernel, max_t=max_t, batch=batch,
                             ext_len=ext_len, block=block,
                             interpret=interpret)
    out = pl.pallas_call(
        body,
        grid=(batch,),
        out_shape=jax.ShapeDtypeStruct((out_len,), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=_num_warps(block),
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(_flat(lp_ext.astype(jnp.float32), block),
      sequence_length.astype(jnp.int32),
      *[_flat(r, block) for r in rows])
    return out[PAD:PAD + max_t * batch * ext_len].reshape(
        max_t, batch, ext_len)


@functools.partial(jax.jit, static_argnames=("interpret",))
def alpha_pallas(lp_ext, sequence_length, valid, can_skip, alpha0,
                 interpret=False):
    """lp_ext [T,B,S], sequence_length [B], valid/can_skip [B,S] bool,
    alpha0 [B,S] → alpha_all [T,B,S] (row 0 == alpha0; rows past a
    sequence's end repeat its last alpha)."""
    rows = (valid.astype(jnp.int32), can_skip.astype(jnp.int32),
            alpha0.astype(jnp.float32))
    return _run(_alpha_kernel, lp_ext, sequence_length, rows, interpret)


@functools.partial(jax.jit, static_argnames=("interpret",))
def beta_pallas(lp_ext, sequence_length, valid, skip_from, final_mask,
                interpret=False):
    """Reverse-time beta' recursion (emission included) → beta_all
    [T,B,S] in forward time order.  ``skip_from`` marks s whose s+2
    transition is allowed; ``final_mask`` the two end states."""
    rows = (valid.astype(jnp.int32), skip_from.astype(jnp.int32),
            final_mask.astype(jnp.int32))
    return _run(_beta_kernel, lp_ext, sequence_length, rows, interpret)
