"""Unidirectional LSTM acoustic models (``lstm`` and ``cudnnlstm`` types).

Capability mirrors of reference nnet/lstm.py:
  * ``lstm`` (lstm.py:125-371): stack of projected peephole LSTMCells;
    layer 0 is a plain cell when ``input_dim != num_projects``, all other
    layers are residual (``ResidualWrapper``: output = cell(x) + x,
    lstm.py:243-260); optional batch-norm before layer 0 and after every
    layer (``use_bn``, lstm.py:276-295); per-layer output dropout (keep
    prob); dense or MoE head.  The reference's dead experimental branches
    (feature_project / ornn regularizers, which call functions that do not
    exist anywhere in the repo — lstm.py:214-218,307-317) are intentionally
    not reproduced; nor is the stale 4-arg ``create_moe`` call
    (lstm.py:324-328) — the intended 6-param MoE head is used instead.
  * ``cudnnlstm`` (lstm.py:26-122): stack of standard LSTM cells
    (CudnnCompatibleLSTMCell: forget_bias 1.0, no peepholes/projection)
    plus a dense head; no dropout.

Batch-norm uses batch statistics at train time and running averages at eval
(tf.layers.batch_normalization semantics, momentum 0.99); the running
moments live in a separate ``state`` pytree updated by the train step.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from .cells import dropout, init_lstm_cell, lstm_scan, truncated_normal
from .moe import apply_moe, init_moe

BN_MOMENTUM = 0.99
BN_EPS = 1e-3  # tf.layers.batch_normalization default


def _dims(config: Dict) -> Dict:
    dims = {
        "input_dim": config["input_dim"] * (
            1 + config.get("left_context", 0) + config.get("right_context", 0)),
        "num_layers": config["num_layers"],
        "num_neurons": config["num_neurons"],
        "num_projects": config.get("num_projects") or None,
        "num_targets": config["num_targets"],
        "use_peepholes": bool(config.get("use_peepholes", True)),
        "use_bn": bool(config.get("use_bn", False)),
        "num_experts": config.get("num_experts") or 0,
        "moe_temp": float(config.get("moe_temp", 10.0)),
    }
    dims["output_dim"] = dims["num_projects"] or dims["num_neurons"]
    return dims


def _scan_fn(config):
    from .blstm import _compute_dtype
    return functools.partial(lstm_scan, compute_dtype=_compute_dtype(config))


def _init_bn(dim: int) -> Dict:
    return {"scale": jnp.ones((dim,), jnp.float32),
            "offset": jnp.zeros((dim,), jnp.float32)}


def _init_bn_state(dim: int) -> Dict:
    return {"mean": jnp.zeros((dim,), jnp.float32),
            "var": jnp.ones((dim,), jnp.float32)}


def _bn_fold_enabled() -> bool:
    """Default-ON (opt out with LSTM_CTC_TPU_BN_FOLD=0): apply
    train-mode BN by folding its per-channel affine into the NEXT
    consumer's input weights instead of materializing the normalized
    [B, T, C] tensor.

    BN with batch stats is x̂ = a·x + b (a = scale·rsqrt(var+eps),
    b = offset − mean·a), and a matmul consumer absorbs it exactly:
    x̂ @ W = x @ (a ⊙ W) + b @ W — so each layer boundary saves one
    HBM write + read of the normalized activations, at the cost of a
    tiny [D, 4H] weight rescale.  Residual adds recreate x̂ as an
    elementwise op XLA fuses into the add.  Semantically identical to
    the materializing path (same stats, same running-moment updates);
    gradient/logit parity pinned by tests/test_models.py.  Set the env
    to 0 for the materializing path."""
    import os
    return os.environ.get("LSTM_CTC_TPU_BN_FOLD", "1") == "1"


def _bn_train_affine(bn_params: Dict, bn_state: Dict, x: jnp.ndarray):
    """Train-mode BN as a per-channel affine: returns ((a, b),
    new running state) without materializing the normalized tensor.
    Stats are UNMASKED over all leading axes — the reference's
    tf.layers.batch_normalization semantics (padded frames included)."""
    axes = tuple(range(x.ndim - 1))
    mean = jnp.mean(x, axis=axes)
    var = jnp.var(x, axis=axes)
    new_state = {
        "mean": BN_MOMENTUM * bn_state["mean"] + (1 - BN_MOMENTUM) * mean,
        "var": BN_MOMENTUM * bn_state["var"] + (1 - BN_MOMENTUM) * var,
    }
    inv = jax.lax.rsqrt(var + BN_EPS)
    a = inv * bn_params["scale"]
    return (a, bn_params["offset"] - mean * a), new_state


def _fold_affine_into_cell(cell: Dict, a: jnp.ndarray,
                           b: jnp.ndarray) -> Dict:
    """Fold an input affine x̂ = a·x + b into an LSTM cell's input
    kernel: x̂ @ wx + bias = x @ (a ⊙ wx) + (bias + b @ wx)."""
    cell = dict(cell)
    extra = b @ cell["wx"]
    cell["wx"] = a[:, None] * cell["wx"]
    cell["bias"] = cell["bias"] + extra
    return cell


def _apply_bn(bn_params: Dict, bn_state: Dict, x: jnp.ndarray, train: bool):
    if train:
        # single source of truth for train-mode stats/moments: the
        # materializing path is exactly the fold path's affine, applied
        (a, b), new_state = _bn_train_affine(bn_params, bn_state, x)
        return a * x + b, new_state
    mean, var = bn_state["mean"], bn_state["var"]
    inv = jax.lax.rsqrt(var + BN_EPS)
    return ((x - mean) * inv * bn_params["scale"] + bn_params["offset"],
            bn_state)


def init_lstm(rng, config: Dict) -> Tuple[Dict, Dict]:
    """Returns (params, state); state holds batch-norm running moments."""
    dims = _dims(config)
    params: Dict = {"layers": []}
    state: Dict = {"bn": []}
    layer_input = dims["input_dim"]
    for i in range(dims["num_layers"]):
        rng, k = jax.random.split(rng)
        params["layers"].append(init_lstm_cell(
            k, layer_input, dims["num_neurons"], dims["num_projects"],
            use_peepholes=True))
        layer_input = dims["output_dim"]
    if dims["use_bn"]:
        params["bn_in"] = _init_bn(dims["input_dim"])
        state["bn_in"] = _init_bn_state(dims["input_dim"])
        params["bn"] = [_init_bn(dims["output_dim"])
                        for _ in range(dims["num_layers"])]
        state["bn"] = [_init_bn_state(dims["output_dim"])
                       for _ in range(dims["num_layers"])]
    rng, k_head = jax.random.split(rng)
    if dims["num_experts"] > 0:
        params["moe"] = init_moe(k_head, dims["output_dim"],
                                 dims["num_targets"], dims["num_experts"])
    else:
        stddev = 1.0 / math.sqrt(float(dims["output_dim"]))  # lstm.py:333-339
        params["head"] = {
            "w": truncated_normal(k_head, (dims["output_dim"],
                                           dims["num_targets"]), stddev),
            "b": jnp.zeros((dims["num_targets"],), jnp.float32),
        }
    return params, state


def apply_lstm(params: Dict,
               state: Dict,
               nnet_input: jnp.ndarray,
               sequence_length: jnp.ndarray,
               config: Dict,
               train: bool = False,
               dropout_rng=None):
    """→ (logits, encoder=None, reg_losses, new_state)."""
    dims = _dims(config)
    keep_prob = float(config.get("dropout_rate", 1.0)) if train else 1.0
    x = nnet_input
    new_state = {"bn": list(state.get("bn", []))}
    bn_fold = dims["use_bn"] and train and _bn_fold_enabled()
    if dims["use_bn"] and not bn_fold:
        # (the fold branch below applies bn_in as an affine folded into
        # layer 0's input kernel instead of materializing it here)
        x, new_state["bn_in"] = _apply_bn(
            params["bn_in"], state["bn_in"], x, train)
    res_flags = [not (i == 0 and dims["input_dim"] != dims["output_dim"])
                 for i in range(dims["num_layers"])]
    head_affine = None
    if bn_fold:
        # fold each BN's train-mode affine into the next layer's input
        # kernel (and the input BN into layer 0) — no normalized
        # [B, T, C] tensor is ever materialized between layers.  RNG
        # consumption order matches the materializing loop exactly.
        pending, new_state["bn_in"] = _bn_train_affine(
            params["bn_in"], state["bn_in"], x)
        scan_fn = _scan_fn(config)
        for i in range(dims["num_layers"]):
            cell = _fold_affine_into_cell(params["layers"][i], *pending)
            out, _ = scan_fn(cell, x, sequence_length, forget_bias=1.0)
            if res_flags[i]:
                # residual adds the layer's NORMALIZED input (x̂); the
                # affine fuses into the add — still no materialization
                out = out + (pending[0] * x + pending[1])
            if keep_prob < 1.0 and dropout_rng is not None:
                dropout_rng, k = jax.random.split(dropout_rng)
                out = dropout(k, out, keep_prob)
            pending, new_state["bn"][i] = _bn_train_affine(
                params["bn"][i], state["bn"][i], out)
            x = out
        head_affine = pending          # last BN folds into the head
    else:
        scan_fn = _scan_fn(config)
        for i in range(dims["num_layers"]):
            out, _ = scan_fn(params["layers"][i], x, sequence_length,
                             forget_bias=1.0)
            if res_flags[i]:
                out = out + x              # ResidualWrapper, lstm.py:250-258
            if keep_prob < 1.0 and dropout_rng is not None:
                dropout_rng, k = jax.random.split(dropout_rng)
                out = dropout(k, out, keep_prob)
            if dims["use_bn"]:
                out, new_state["bn"][i] = _apply_bn(
                    params["bn"][i], state["bn"][i], out, train)
            x = out

    batch, time_steps, _ = x.shape
    flat = x.reshape(batch * time_steps, dims["output_dim"])
    if head_affine is not None and dims["num_experts"] > 0:
        # the MoE head has two matmul consumers (gate + experts) and
        # dropout — materialize the final affine instead of folding
        # (still saves every inter-layer materialization)
        flat = head_affine[0] * flat + head_affine[1]
        head_affine = None
    if dims["num_experts"] > 0:
        if keep_prob < 1.0 and dropout_rng is not None:
            dropout_rng, k_moe = jax.random.split(dropout_rng)
        else:
            k_moe = None
        from .blstm import _compute_dtype
        y = apply_moe(params["moe"], flat, dims["num_experts"],
                      dims["moe_temp"], keep_prob, k_moe,
                      compute_dtype=_compute_dtype(config))
    else:
        w_head, b_head = params["head"]["w"], params["head"]["b"]
        if head_affine is not None:
            a, b = head_affine
            w_head, b_head = a[:, None] * w_head, b_head + b @ w_head
        y = flat @ w_head + b_head
    logits = y.reshape(batch, time_steps, dims["num_targets"])
    return logits, None, [], new_state


def init_cudnnlstm(rng, config: Dict) -> Dict:
    dims = _dims(config)
    params: Dict = {"layers": []}
    layer_input = dims["input_dim"]
    for _ in range(dims["num_layers"]):
        rng, k = jax.random.split(rng)
        params["layers"].append(init_lstm_cell(
            k, layer_input, dims["num_neurons"], num_proj=None,
            use_peepholes=False))
        layer_input = dims["num_neurons"]
    rng, k_head = jax.random.split(rng)
    stddev = 1.0 / math.sqrt(float(dims["num_neurons"]))
    params["head"] = {
        "w": truncated_normal(k_head, (dims["num_neurons"],
                                       dims["num_targets"]), stddev),
        "b": jnp.zeros((dims["num_targets"],), jnp.float32),
    }
    return params


def apply_cudnnlstm(params: Dict,
                    nnet_input: jnp.ndarray,
                    sequence_length: jnp.ndarray,
                    config: Dict,
                    train: bool = False,
                    dropout_rng=None):
    dims = _dims(config)
    x = nnet_input
    scan_fn = _scan_fn(config)
    for cell in params["layers"]:
        x, _ = scan_fn(cell, x, sequence_length, forget_bias=1.0)
    batch, time_steps, _ = x.shape
    flat = x.reshape(batch * time_steps, dims["num_neurons"])
    y = flat @ params["head"]["w"] + params["head"]["b"]
    logits = y.reshape(batch, time_steps, dims["num_targets"])
    return logits, None, []
