"""Streaming (chunked) inference for unidirectional LSTM models.

The reference lists streaming unidirectional LSTM-CTC inference as its
stretch deployment mode (SURVEY §7 step 7; the ``lstm``/``cudnnlstm``
model types exist for it).  A ``StreamingSession`` consumes raw feature
frames in arbitrary-sized chunks and emits CTC logits incrementally,
matching the full-utterance forward pass exactly:

  * splice context is carried across chunk boundaries (left context from
    the previous chunk; right context delays emission until the needed
    future frames arrive);
  * the subsample phase is tracked so frame selection matches the
    offline ``floor(T/n)`` gather (data/pipeline.py semantics);
  * per-layer LSTM (c, h) states carry over; the per-chunk model step is
    one jitted function compiled once for the fixed chunk size (short
    tails are padded and masked via ``sequence_length``).

Only causal models stream (``lstm``, ``cudnnlstm``); the BLSTM needs the
whole utterance by construction.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .cells import lstm_scan
from .lstm import _apply_bn, _dims
from .moe import apply_moe


class StreamingSession:
    """Stateful chunk-by-chunk forward for one utterance (batch 1)."""

    def __init__(self, params: Dict, net_state: Dict, config: Dict,
                 chunk_size: int = 32):
        if config["nnet_type"] not in ("lstm", "cudnnlstm"):
            raise ValueError(
                "streaming needs a causal model (lstm/cudnnlstm), got %s"
                % config["nnet_type"])
        self.params = params
        self.net_state = net_state
        self.config = config
        self.chunk_size = chunk_size
        self.left = config.get("left_context", 0) or 0
        self.right = config.get("right_context", 0) or 0
        self.subsample = config.get("subsample", 0) or 0
        self._raw_buffer: Optional[np.ndarray] = None
        self._next_raw = 0          # next raw-frame index to consider
        self._states: Optional[List[Tuple]] = None
        self._jit_fn = jax.jit(self._model_chunk)

    def reset(self) -> None:
        """Clear per-utterance state, KEEPING the compiled chunk step —
        one session serves a whole archive (a fresh session per
        utterance would retrace + reload the executable every time)."""
        self._raw_buffer = None
        self._next_raw = 0
        self._states = None

    # --- jitted model step over one fixed-size (padded) chunk ---
    def _model_chunk(self, params, net_state, states, x, seq_len):
        config = self.config
        dims = _dims(config)
        new_states = []
        out = x
        use_bn = dims["use_bn"] and config["nnet_type"] == "lstm"
        if use_bn:
            out, _ = _apply_bn(params["bn_in"], net_state["bn_in"], out,
                               train=False)
        res_flags = [config["nnet_type"] == "lstm" and not (
            i == 0 and dims["input_dim"] != dims["output_dim"])
            for i in range(dims["num_layers"])]
        from .blstm import _compute_dtype

        for i, cell in enumerate(params["layers"]):
            layer_out, state = lstm_scan(
                cell, out, seq_len, forget_bias=1.0,
                initial_state=states[i],
                compute_dtype=_compute_dtype(config))
            if res_flags[i]:
                layer_out = layer_out + out
            if use_bn:
                layer_out, _ = _apply_bn(params["bn"][i],
                                         net_state["bn"][i],
                                         layer_out, train=False)
            new_states.append(state)
            out = layer_out
        flat = out.reshape(-1, out.shape[-1])
        if dims["num_experts"] > 0:
            y = apply_moe(params["moe"], flat, dims["num_experts"],
                          dims["moe_temp"],
                          compute_dtype=_compute_dtype(config))
        else:
            y = flat @ params["head"]["w"] + params["head"]["b"]
        return y.reshape(1, -1, dims["num_targets"]), new_states

    def _init_states(self) -> List[Tuple]:
        dims = _dims(self.config)
        units = dims["num_neurons"]
        states = []
        for cell in self.params["layers"]:
            proj = cell["proj"].shape[1] if "proj" in cell else units
            states.append((jnp.zeros((1, units)), jnp.zeros((1, proj))))
        return states

    def _spliceable_rows(self, flush: bool) -> np.ndarray:
        """Spliced + subsampled rows emittable right now."""
        buf = self._raw_buffer
        dim = (buf.shape[1] if buf is not None else 0) * \
            (1 + self.left + self.right)
        if buf is None:
            return np.zeros((0, dim), np.float32)
        total = buf.shape[0]
        factor = self.subsample if self.subsample and self.subsample > 1 \
            else 1
        rows = []
        t = self._next_raw
        while t < total:
            if t % factor != 0:
                t += 1
                continue
            if flush and factor > 1 and t + factor > total:
                break  # offline keeps floor(T/n) rows: t must be ≤ T-n
            if not flush and t + self.right >= total:
                break  # needs future frames (edge clamp only at flush)
            lo = max(0, t - self.left)
            hi = min(total - 1, t + self.right)
            parts = []
            if self.left - (t - lo):
                parts.extend([buf[lo:lo + 1]] * (self.left - (t - lo)))
            parts.append(buf[lo:hi + 1])
            if self.right - (hi - t):
                parts.extend([buf[hi:hi + 1]] * (self.right - (hi - t)))
            rows.append(np.concatenate(parts, axis=0).reshape(-1))
            t += 1
            self._next_raw = t
        if not rows:
            return np.zeros((0, dim), np.float32)
        return np.stack(rows).astype(np.float32)

    def process(self, frames: Optional[np.ndarray],
                flush: bool = False) -> np.ndarray:
        """Feed raw feature frames [N, D]; returns newly available logits
        [M, V].  Call once more with flush=True at utterance end."""
        if self._states is None:
            self._states = self._init_states()
        if frames is not None and len(frames):
            frames = np.asarray(frames, np.float32)
            self._raw_buffer = frames if self._raw_buffer is None else \
                np.concatenate([self._raw_buffer, frames], axis=0)
        ready = self._spliceable_rows(flush)
        if ready.shape[0] == 0:
            return np.zeros((0, self.config["num_targets"]), np.float32)
        outputs = []
        pos = 0
        while pos < ready.shape[0]:
            chunk = ready[pos:pos + self.chunk_size]
            true_len = chunk.shape[0]
            if true_len < self.chunk_size:
                chunk = np.concatenate(
                    [chunk, np.zeros((self.chunk_size - true_len,
                                      chunk.shape[1]), np.float32)], axis=0)
            logits, self._states = self._jit_fn(
                self.params, self.net_state, self._states,
                jnp.asarray(chunk[None]),
                jnp.full((1,), true_len, jnp.int32))
            outputs.append(np.asarray(logits)[0, :true_len])
            pos += true_len
        return np.concatenate(outputs, axis=0)
