"""LSTM cell primitives: parameter init + masked time-scan.

Semantics mirror TF1's ``tf.contrib.rnn.LSTMCell`` as used by the reference
(nnet/bilstm.py:125-188): optional diagonal peephole connections, optional
output projection (``num_proj``), a forget-gate bias added at runtime, TF
gate order (i, j, f, o), and ``dynamic_rnn`` masking — outputs are zero past
``sequence_length`` and the carried state freezes there.

Structure: the input-to-gates projection for the *whole* sequence is one
large ``[B·T, D] × [D, 4H]`` matmul (done outside the scan); only the
recurrent ``[B, P] × [P, 4H]`` matmul and the elementwise gate math live
inside ``lax.scan``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp


def glorot_uniform(rng, shape, dtype=jnp.float32):
    if len(shape) == 1:
        fan_in = fan_out = shape[0]
    else:
        fan_in, fan_out = shape[0], shape[1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(rng, shape, dtype, -limit, limit)


def truncated_normal(rng, shape, stddev, dtype=jnp.float32):
    return stddev * jax.random.truncated_normal(rng, -2.0, 2.0, shape, dtype)


def init_lstm_cell(rng,
                   input_dim: int,
                   num_units: int,
                   num_proj: Optional[int] = None,
                   use_peepholes: bool = False) -> Dict:
    """Parameters for one LSTM cell.  The TF cell's single ``[D+P, 4H]``
    kernel is split into input (``wx``) and recurrent (``wh``) halves so the
    input half can be applied to the whole sequence at once."""
    out_dim = num_proj if num_proj else num_units
    k_kernel, k_proj, k_wi, k_wf, k_wo = jax.random.split(rng, 5)
    kernel = glorot_uniform(k_kernel, (input_dim + out_dim, 4 * num_units))
    params = {
        "wx": kernel[:input_dim],
        "wh": kernel[input_dim:],
        "bias": jnp.zeros((4 * num_units,), jnp.float32),
    }
    if use_peepholes:
        params["w_i_diag"] = glorot_uniform(k_wi, (num_units,))
        params["w_f_diag"] = glorot_uniform(k_wf, (num_units,))
        params["w_o_diag"] = glorot_uniform(k_wo, (num_units,))
    if num_proj:
        params["proj"] = glorot_uniform(k_proj, (num_units, num_proj))
    return params


def lstm_scan(params: Dict,
              x: jnp.ndarray,
              sequence_length: jnp.ndarray,
              forget_bias: float = 1.0,
              reverse: bool = False,
              initial_state: Optional[Tuple] = None,
              compute_dtype=None) -> Tuple[jnp.ndarray, Tuple]:
    """Run the cell over time.  x: [B, T, D] → outputs [B, T, P], final
    state (c [B, H], h [B, P]).

    With ``reverse=True`` the recurrence runs from the *end of the padded
    buffer* backwards — callers implement the reference's
    ``tf.reverse_sequence`` trick instead (bilstm.py:112,190), which this
    flag does not replicate; it exists for streaming/No-padding use.

    ``compute_dtype`` casts matmul operands (accumulation and the carried
    state stay in x.dtype) — same mixed-precision semantics as
    bilstm_dual_scan.
    """
    batch, time_steps, _ = x.shape
    num_units = params["bias"].shape[0] // 4
    out_dim = params["proj"].shape[1] if "proj" in params else num_units
    use_peepholes = "w_i_diag" in params
    cdt = compute_dtype or x.dtype
    wh = params["wh"].astype(cdt)
    proj_w = params["proj"].astype(cdt) if "proj" in params else None

    # One big input projection outside the scan.
    gates_x = jnp.einsum("btd,dh->bth", x.astype(cdt),
                         params["wx"].astype(cdt),
                         preferred_element_type=x.dtype) + params["bias"]
    gates_x = jnp.moveaxis(gates_x, 1, 0)                     # [T, B, 4H]
    mask = (jnp.arange(time_steps)[:, None]
            < sequence_length[None, :]).astype(x.dtype)       # [T, B]
    if reverse:
        gates_x = gates_x[::-1]
        mask = mask[::-1]

    def step(carry, inputs):
        c, h = carry
        g_x, m = inputs
        gates = g_x + jax.lax.dot(h.astype(cdt), wh,
                                  preferred_element_type=x.dtype)
        i, j, f, o = jnp.split(gates, 4, axis=-1)
        if use_peepholes:
            i = i + params["w_i_diag"] * c
            f = f + params["w_f_diag"] * c
        c_new = (jax.nn.sigmoid(f + forget_bias) * c
                 + jax.nn.sigmoid(i) * jnp.tanh(j))
        if use_peepholes:
            o = o + params["w_o_diag"] * c_new
        out = jax.nn.sigmoid(o) * jnp.tanh(c_new)
        if proj_w is not None:
            out = jax.lax.dot(out.astype(cdt), proj_w,
                              preferred_element_type=x.dtype)
        m = m[:, None]
        c_next = m * c_new + (1.0 - m) * c
        h_next = m * out + (1.0 - m) * h
        return (c_next, h_next), m * out

    init = initial_state if initial_state is not None else (
        jnp.zeros((batch, num_units), x.dtype),
        jnp.zeros((batch, out_dim), x.dtype))
    (c_final, h_final), outputs = jax.lax.scan(
        jax.checkpoint(step), init, (gates_x, mask), unroll=8)
    if reverse:
        outputs = outputs[::-1]
    return jnp.moveaxis(outputs, 0, 1), (c_final, h_final)


def bilstm_dual_scan(fw_params: Dict,
                     bw_params: Dict,
                     x: jnp.ndarray,
                     x_rev: jnp.ndarray,
                     sequence_length: jnp.ndarray,
                     forget_bias: float = 1.0,
                     compute_dtype=None,
                     reset_mask=None):
    """Run the forward and backward cells of one BLSTM layer in a single
    scan.  The two directions are independent within a layer, so batching
    them halves the number of sequential scan steps: each recurrent matmul
    is tiny at acoustic batch sizes, so the step count, not the FLOPs,
    sets the time.

    x is the layer input, x_rev its reverse_sequence (bilstm.py:112 trick);
    both use the same time mask since reversal keeps valid frames in the
    first ``sequence_length`` positions.

    Returns (fw_out [B,T,P], bw_out [B,T,P] (still reversed),
    (fw_state, bw_state)).
    """
    batch, time_steps, _ = x.shape
    num_units = fw_params["bias"].shape[0] // 4
    out_dim = fw_params["proj"].shape[1] if "proj" in fw_params else num_units
    use_peepholes = "w_i_diag" in fw_params
    use_proj = "proj" in fw_params

    # [2, ...] stacked weights; direction is a batched matmul dimension.
    # With compute_dtype=bfloat16 the matmul operands are cast down while
    # accumulation and the carried state stay float32.
    cdt = compute_dtype or x.dtype
    wx = jnp.stack([fw_params["wx"], bw_params["wx"]]).astype(cdt)
    wh = jnp.stack([fw_params["wh"], bw_params["wh"]]).astype(cdt)
    bias = jnp.stack([fw_params["bias"], bw_params["bias"]])
    x2 = jnp.stack([x, x_rev]).astype(cdt)                   # [2, B, T, D]
    gates_x = jnp.einsum("kbtd,kdh->tkbh", x2, wx,
                         preferred_element_type=jnp.float32) \
        + bias[None, :, None, :]
    if use_proj:
        proj = jnp.stack([fw_params["proj"], bw_params["proj"]]).astype(cdt)
    if use_peepholes:
        w_i = jnp.stack([fw_params["w_i_diag"], bw_params["w_i_diag"]])
        w_f = jnp.stack([fw_params["w_f_diag"], bw_params["w_f_diag"]])
        w_o = jnp.stack([fw_params["w_o_diag"], bw_params["w_o_diag"]])

    mask = (jnp.arange(time_steps)[:, None]
            < sequence_length[None, :]).astype(x.dtype)      # [T, B]
    # multi-utterance row packing: reset_mask [B, T] is 1.0 at the first
    # frame of each packed segment — the carried state is zeroed there so
    # every segment starts from the zero initial state, exactly as if it
    # had its own row
    has_reset = reset_mask is not None
    if has_reset:
        keep = 1.0 - jnp.transpose(reset_mask).astype(x.dtype)  # [T, B]
        xs_extra = (keep,)
    else:
        xs_extra = ()

    def step(carry, inputs):
        c, h = carry                                          # [2, B, H/P]
        if has_reset:
            g_x, m, kp = inputs
            kp = kp[None, :, None]
            c = kp * c
            h = kp * h
        else:
            g_x, m = inputs                                   # [T-slice]
        gates = g_x + jnp.einsum("kbp,kph->kbh", h.astype(cdt), wh,
                                 preferred_element_type=jnp.float32)
        i, j, f, o = jnp.split(gates, 4, axis=-1)
        if use_peepholes:
            i = i + w_i[:, None, :] * c
            f = f + w_f[:, None, :] * c
        c_new = (jax.nn.sigmoid(f + forget_bias) * c
                 + jax.nn.sigmoid(i) * jnp.tanh(j))
        if use_peepholes:
            o = o + w_o[:, None, :] * c_new
        out = jax.nn.sigmoid(o) * jnp.tanh(c_new)
        if use_proj:
            out = jnp.einsum("kbh,khp->kbp", out.astype(cdt), proj,
                             preferred_element_type=jnp.float32)
        m = m[None, :, None]
        c_next = m * c_new + (1.0 - m) * c
        h_next = m * out + (1.0 - m) * h
        return (c_next, h_next), m * out

    init = (jnp.zeros((2, batch, num_units), x.dtype),
            jnp.zeros((2, batch, out_dim), x.dtype))
    # Full rematerialization of the step in the backward pass (recomputing
    # gate math instead of storing per-step residuals) plus 8-way loop
    # unrolling (amortizes per-step loop overhead on the sequential
    # recurrence).  Both settings predate the GPU; re-sweep them there.
    (c_final, h_final), outputs = jax.lax.scan(
        jax.checkpoint(step), init, (gates_x, mask) + xs_extra, unroll=8)
    outputs = jnp.moveaxis(outputs, 0, 2)                     # [2, B, T, P]
    fw_state = (c_final[0], h_final[0])
    bw_state = (c_final[1], h_final[1])
    return outputs[0], outputs[1], (fw_state, bw_state)


def reverse_sequence(x: jnp.ndarray, sequence_length: jnp.ndarray) -> jnp.ndarray:
    """Reverse the first ``sequence_length`` steps of each row, leaving
    padding in place — ``tf.reverse_sequence`` (reference bilstm.py:112)."""
    time_steps = x.shape[1]
    t = jnp.arange(time_steps)[None, :]
    lengths = sequence_length[:, None]
    idx = jnp.where(t < lengths, lengths - 1 - t, t)
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2))
    return jnp.take_along_axis(x, idx, axis=1)


def dropout(rng, x: jnp.ndarray, keep_prob: float) -> jnp.ndarray:
    """Inverted dropout with *keep* probability (the reference passes
    dropout_rate=0.9 meaning keep 0.9, bilstm.py:78-99)."""
    if keep_prob >= 1.0:
        return x
    keep = jax.random.bernoulli(rng, keep_prob, x.shape)
    return jnp.where(keep, x / keep_prob, 0.0)


def reverse_segments(x: jnp.ndarray,
                     sequence_length: jnp.ndarray,
                     reset_mask: jnp.ndarray) -> jnp.ndarray:
    """Segment-wise ``reverse_sequence`` for multi-utterance packed rows:
    each packed segment (delimited by ``reset_mask`` starts) is reversed
    in place; padding past ``sequence_length`` stays put.  With a single
    segment per row this reduces to ``reverse_sequence``."""
    batch, time_steps = x.shape[0], x.shape[1]
    t = jnp.arange(time_steps)[None, :]
    r = reset_mask > 0.5
    start = jax.lax.cummax(jnp.where(r, t, 0), axis=1)
    nxt = jnp.where(r, t, time_steps)
    nxt_after = jnp.concatenate(
        [nxt[:, 1:], jnp.full((batch, 1), time_steps, nxt.dtype)], axis=1)
    nxt_after = jax.lax.cummin(nxt_after, axis=1, reverse=True)
    end = jnp.minimum(nxt_after, sequence_length[:, None])
    idx = jnp.where(t < sequence_length[:, None], start + end - 1 - t, t)
    idx = jnp.clip(idx, 0, time_steps - 1)
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2))
    return jnp.take_along_axis(x, idx, axis=1)
