"""Residual projected bidirectional LSTM acoustic model.

Capability mirror of reference nnet/bilstm.py:25-273:
  * per-layer forward + backward LSTMCell(num_proj, use_peepholes,
    forget_bias=5.0) run via the reverse-sequence trick (bilstm.py:112,190);
  * per-direction output dropout with *keep* probability ``dropout_rate``;
  * forward/backward outputs concatenated on the feature axis; residual add
    on layer 0 iff ``input_dim == 2 * num_projects`` (bilstm.py:199-200);
  * head: dense (truncated-normal stddev 1/sqrt(num_neurons)) or the MoE
    mixture-of-softmaxes head when ``num_experts > 0`` (bilstm.py:229-249);
  * optional uniform / prior label-smoothing KL regularizers appended to a
    ``reg_losses`` list of (value, weight) pairs (bilstm.py:255-269);
  * an ``encoder`` summary vector: concat of both final states
    (bilstm.py:206-208).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp

from .. import logging_util as log
from ..train.class_prior import get_class_prior
from .cells import (
    bilstm_dual_scan,
    dropout,
    init_lstm_cell,
    reverse_segments,
    reverse_sequence,
    truncated_normal,
)
from .moe import apply_moe, init_moe

FORGET_BIAS = 5.0  # reference bilstm.py:130-134


def _model_dims(config: Dict) -> Dict:
    dims = {
        "input_dim": config["input_dim"] * (
            1 + config.get("left_context", 0) + config.get("right_context", 0)),
        "num_layers": config["num_layers"],
        "num_neurons": config["num_neurons"],
        "num_projects": config.get("num_projects") or None,
        "num_targets": config["num_targets"],
        "use_peepholes": bool(config.get("use_peepholes", False)),
        "num_experts": config.get("num_experts") or 0,
        "moe_temp": float(config.get("moe_temp", 10.0)),
    }
    dims["output_dim"] = 2 * (dims["num_projects"] or dims["num_neurons"])
    return dims


def init_blstm(rng, config: Dict) -> Dict:
    dims = _model_dims(config)
    params: Dict = {"fwd": [], "bwd": []}
    layer_input_dim = dims["input_dim"]
    proj_dim = dims["num_projects"] or dims["num_neurons"]
    for _ in range(dims["num_layers"]):
        rng, k_f, k_b = jax.random.split(rng, 3)
        params["fwd"].append(init_lstm_cell(
            k_f, layer_input_dim, dims["num_neurons"], dims["num_projects"],
            dims["use_peepholes"]))
        params["bwd"].append(init_lstm_cell(
            k_b, layer_input_dim, dims["num_neurons"], dims["num_projects"],
            dims["use_peepholes"]))
        layer_input_dim = 2 * proj_dim
    rng, k_head = jax.random.split(rng)
    if dims["num_experts"] > 0:
        params["moe"] = init_moe(k_head, dims["output_dim"],
                                 dims["num_targets"], dims["num_experts"])
    else:
        # stddev 1/sqrt(num_neurons) — bilstm.py:232-238
        stddev = 1.0 / math.sqrt(float(dims["num_neurons"]))
        params["head"] = {
            "w": truncated_normal(k_head, (dims["output_dim"],
                                           dims["num_targets"]), stddev),
            "b": jnp.zeros((dims["num_targets"],), jnp.float32),
        }
    return params


def label_smoothing_reg(logits: jnp.ndarray, config: Dict) -> List:
    """KL(label-smoothing) regularizers, (value, weight) pairs
    (reference bilstm.py:255-269)."""
    reg_losses = []
    num_targets = config["num_targets"]
    uniform_w = config.get("uniform_label_sm")
    prior_w = config.get("prior_label_sm")
    prior_path = config.get("prior_label_path")
    if uniform_w is not None and uniform_w > 0:
        pred = jax.nn.softmax(logits)
        log_uniform = jnp.log(jnp.asarray(1.0 / num_targets))
        kl = pred * (jnp.log(pred) - log_uniform)
        reg_losses.append((jnp.sum(kl) * uniform_w, uniform_w))
    elif prior_w is not None and prior_w > 0 and prior_path is not None:
        prior_log_prob = jnp.asarray(get_class_prior(prior_path))
        pred = jax.nn.softmax(logits)
        kl = pred * (jnp.log(pred) - prior_log_prob)
        reg_losses.append((jnp.sum(kl) * prior_w, prior_w))
    return reg_losses


def _compute_dtype(config):
    """Matmul operand precision for the LSTM stack and the MoE head
    (accumulation and the carried state stay float32).  Default is AUTO:
    bfloat16 on accelerator backends, float32 on CPU (where the parity
    tests want exact f32).  bf16-by-default is gated on accuracy: the
    synthetic recipe reaches the same WER under compute_dtype=bfloat16
    (egs/synthetic/RESULT_PARITY.md).  Force with ``compute_dtype =
    float32`` in nnet.config or LSTM_CTC_TPU_COMPUTE_DTYPE=float32; an
    f32 matmul on a GPU may still run in TF32 unless the caller sets
    ``jax.default_matmul_precision("highest")``."""
    import os
    raw = (os.environ.get("LSTM_CTC_TPU_COMPUTE_DTYPE")
           or str(config.get("compute_dtype", "") or "")).lower()
    if raw in ("bfloat16", "bf16"):
        return jnp.bfloat16
    if raw in ("float32", "f32", "fp32"):
        return jnp.float32   # explicit so the MoE head honors it too
    return None if jax.default_backend() == "cpu" else jnp.bfloat16


def apply_blstm(params: Dict,
                nnet_input: jnp.ndarray,
                sequence_length: jnp.ndarray,
                config: Dict,
                train: bool = False,
                dropout_rng=None,
                reset_mask=None) -> Tuple[jnp.ndarray, jnp.ndarray, List]:
    """nnet_input: [B, T, D·ctx] (already spliced) → (logits [B, T, V],
    encoder [B, 2(H+P)·2], reg_losses).

    ``reset_mask`` [B, T] marks the first frame of each segment when rows
    pack multiple utterances (data/pipeline.py pack_factor): the LSTM
    carry is zeroed there and the backward direction reverses each
    segment in place, so every packed utterance computes exactly what it
    would in its own row."""
    dims = _model_dims(config)
    keep_prob = float(config.get("dropout_rate", 1.0)) if train else 1.0
    num_layers = dims["num_layers"]
    compute_dtype = _compute_dtype(config)

    if reset_mask is None:
        rev = lambda v: reverse_sequence(v, sequence_length)
    else:
        rev = lambda v: reverse_segments(v, sequence_length, reset_mask)

    finput = nnet_input
    binput = rev(nnet_input)
    fw_state = bw_state = None
    for i in range(num_layers):
        fw_out, bw_out, (fw_state, bw_state) = bilstm_dual_scan(
            params["fwd"][i], params["bwd"][i], finput, binput,
            sequence_length, FORGET_BIAS, compute_dtype=compute_dtype,
            reset_mask=reset_mask)
        if keep_prob < 1.0 and dropout_rng is not None:
            dropout_rng, k_f, k_b = jax.random.split(dropout_rng, 3)
            fw_out = dropout(k_f, fw_out, keep_prob)
            bw_out = dropout(k_b, bw_out, keep_prob)
        rev_bw = rev(bw_out)
        cat = jnp.concatenate([fw_out, rev_bw], axis=2)
        if i == 0 and dims["input_dim"] == dims["output_dim"]:
            finput = finput + cat          # bilstm.py:199-200
        else:
            finput = cat
        binput = rev(finput)

    encoder = jnp.concatenate(
        [fw_state[0], fw_state[1], bw_state[0], bw_state[1]], axis=1)

    batch, time_steps, _ = finput.shape
    flat = finput.reshape(batch * time_steps, dims["output_dim"])
    if dims["num_experts"] > 0:
        if keep_prob < 1.0 and dropout_rng is not None:
            dropout_rng, k_moe = jax.random.split(dropout_rng)
        else:
            k_moe = None
        y = apply_moe(params["moe"], flat, dims["num_experts"],
                      dims["moe_temp"], keep_prob, k_moe,
                      compute_dtype=compute_dtype)
    else:
        y = flat @ params["head"]["w"] + params["head"]["b"]
    logits = y.reshape(batch, time_steps, dims["num_targets"])

    reg_losses = label_smoothing_reg(logits, config)
    return logits, encoder, reg_losses
