"""High-rank mixture-of-softmaxes output head (the ICASSP'19 "MoE" model).

Mirrors reference nnet/moe.py:29-72: a softmax gate over ``num_experts``
(with dropout on the gate probabilities) mixes per-expert logit vectors
``moe_temperature * tanh(xW + b)`` (with dropout on the expert logits);
the mixed result is used directly as CTC "logits".

The expert projection is a single ``[B·T, 2P] × [2P, E·V]`` matmul — the
dominant FLOP consumer of the whole model — with bf16 operands and float32
accumulation by default; the gate mix is a batched contraction XLA fuses
around it.
"""

from __future__ import annotations

import math
from typing import Dict

import jax
import jax.numpy as jnp

from .cells import dropout, truncated_normal


def init_moe(rng, output_dim: int, num_targets: int, num_experts: int) -> Dict:
    k_prior, k_expert = jax.random.split(rng)
    stddev = 1.0 / math.sqrt(float(output_dim))
    return {
        "w_prior": truncated_normal(k_prior, (output_dim, num_experts), stddev),
        "b_prior": jnp.zeros((num_experts,), jnp.float32),
        "w_expert": truncated_normal(
            k_expert, (output_dim, num_targets * num_experts), stddev),
        "b_expert": jnp.zeros((num_targets * num_experts,), jnp.float32),
    }


def apply_moe(params: Dict,
              x: jnp.ndarray,
              num_experts: int,
              moe_temperature: float,
              keep_prob: float = 1.0,
              dropout_rng=None,
              compute_dtype=None) -> jnp.ndarray:
    """x: [N, output_dim] → mixed logits [N, num_targets].

    ``compute_dtype``: operand precision of the expert projection, with
    float32 accumulation (None keeps x's dtype; callers pass
    blstm._compute_dtype, which is bf16 on accelerators).  The small
    gate projection stays in x's dtype."""
    gate_logits = x @ params["w_prior"] + params["b_prior"]      # [N, E]
    gate = jax.nn.softmax(gate_logits, axis=-1)
    use_dropout = keep_prob < 1.0 and dropout_rng is not None
    if use_dropout:
        k_gate, k_expert = jax.random.split(dropout_rng)
        gate = dropout(k_gate, gate, keep_prob)

    cdt = compute_dtype or x.dtype
    expert = moe_temperature * jnp.tanh(
        jnp.dot(x.astype(cdt), params["w_expert"].astype(cdt),
                preferred_element_type=jnp.float32)
        + params["b_expert"])                                    # [N, E·V]
    expert = expert.reshape(x.shape[0], num_experts, -1)         # [N, E, V]
    if use_dropout:
        expert = dropout(k_expert, expert, keep_prob)
    return jnp.einsum("ne,nev->nv", gate, expert)
