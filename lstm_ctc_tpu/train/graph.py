"""Jitted train/eval steps — the compute-graph layer.

Numerics mirrored from reference nnet/graph.py:51-209:
  * ``eval_loss`` = summed per-sequence CTC loss over the batch
    (graph.py:109-116);
  * ``size`` = total count of real (non-pad) target labels — the
    normalizer used by the outer loop's running mean (graph.py:105-106);
  * ``loss`` = eval_loss + active label-smoothing regularizers
    (graph.py:120-133);
  * training loss additionally takes L2 (0.5·Σv²) × 1e-5 over parameters
    whose name does not contain "bias" (graph.py:183-189).  Note the
    reference quirk: only the LSTM cell biases are *named* "bias" in TF —
    the dense/MoE head biases are anonymous Variables and therefore DO get
    L2-regularized; we reproduce that by excluding only keys equal to
    "bias";
  * gradients are clipped by global norm 5.0 (graph.py:190-192) and
    applied by adam / sgd / momentum(0.9) (graph.py:37-48).

Each step is one ``jax.jit`` program: model forward, CTC loss, backward,
update — all fused by XLA; donated params/opt-state avoid HBM copies.  Under
a multi-device mesh the batch arrives sharded on the batch axis and XLA
inserts the gradient all-reduce automatically.
"""

from __future__ import annotations

import functools
import warnings
from typing import Dict

import jax
import jax.numpy as jnp
import optax

from ..models import apply_model
from ..ops import ctc_loss

_warned_flat_packed_gather = False
_warned_tiered_unsharded = False


def _warn_flat_packed_gather(n_slots: int, num_rows: int,
                             reason: str, remedy: str) -> None:
    """One-time trace-time notice when a packed batch on a multi-device
    mesh takes the layout-agnostic flat gather: correct, but GSPMD
    replicates the [B,T,V] logits to serve arbitrary [B·T] indices —
    exactly the multi-device pathology the row-batched gather exists to
    avoid (mirrors ops/ctc._warn_scan_fallback)."""
    global _warned_flat_packed_gather
    if not _warned_flat_packed_gather:
        _warned_flat_packed_gather = True
        warnings.warn(
            "packed CTC view: %s (%d slots over %d rows), so the "
            "layout-agnostic flat gather is used — on this multi-device "
            "mesh GSPMD will all-gather the [B,T,V] logits for it. "
            "%s" % (reason, n_slots, num_rows, remedy),
            stacklevel=4)


def _warn_tiered_unsharded(num_rows: int, n_devices: int) -> None:
    """One-time trace-time notice when the opt-in tiered gather cannot
    run under shard_map (per-shard row count not integral) and so rides
    GSPMD un-shard_mapped — the same logits-replication pathology the
    flat-gather warning above flags."""
    global _warned_tiered_unsharded
    if not _warned_tiered_unsharded:
        _warned_tiered_unsharded = True
        warnings.warn(
            "tiered packed CTC gather: %d rows do not divide the %d-"
            "device mesh, so the tier gathers run un-shard_mapped and "
            "GSPMD will all-gather the [B,T,V] logits for them. Use a "
            "batch divisible by the mesh (or unset "
            "LSTM_CTC_TPU_CTC_TIERED / ctc_tiered_slots to take the "
            "row-batched full-width gather)." % (num_rows, n_devices),
            stacklevel=4)


def get_optimizer(name: str, learn_rate: float,
                  momentum: float = 0.9) -> optax.GradientTransformation:
    if name == "adam":
        # TF1 AdamOptimizer defaults (epsilon 1e-8)
        return optax.adam(learn_rate, b1=0.9, b2=0.999, eps=1e-8)
    if name == "sgd":
        return optax.sgd(learn_rate)
    if name == "momentum":
        return optax.sgd(learn_rate, momentum=momentum)
    raise ValueError("unsupported optimizer: %s" % name)


def _l2_loss(params) -> jnp.ndarray:
    """0.5·Σv² over non-"bias" leaves (see module docstring for the
    bias-naming quirk being mirrored)."""
    leaves = jax.tree_util.tree_leaves_with_path(params)
    total = 0.0
    for path, leaf in leaves:
        keys = [getattr(p, "key", getattr(p, "name", "")) for p in path]
        if any(k == "bias" for k in keys):
            continue
        total = total + 0.5 * jnp.sum(jnp.square(leaf))
    return total


def ctc_tiered_enabled(config: Dict) -> bool:
    """Opt-in gate for the rank-tier CTC gather (LSTM_CTC_TPU_CTC_TIERED=1
    or ``ctc_tiered_slots`` in config).  The packed slot layout is always
    rank-major (data/pipeline), so the flag is resolved here, where the
    gather is built, from config/env alone — no batcher-side mutation.
    The simpler full-width view is the shipped default."""
    import os
    raw = os.environ.get("LSTM_CTC_TPU_CTC_TIERED", "") \
        or str(config.get("ctc_tiered_slots", "") or "")
    return raw in ("1", "true", "True")


def _row_relative_slots(batch: Dict, num_rows: int, row_t: int,
                        pf: int) -> jnp.ndarray:
    """Rebase the flat ``utt_time_index`` to row-relative time indices,
    shaped [pf, B, T_u].  Valid only under the pipeline's rank-major
    slot contract (slot k·B+r reads row r); dummy slots (zero length ⇒
    zero loss/grad) default to flat index 0 and clip to in-row."""
    n_slots = pf * num_rows
    t_u = batch["utt_time_index"].shape[1]   # may be < row_t
    row_ids = jnp.arange(n_slots, dtype=jnp.int32) % num_rows
    rel = batch["utt_time_index"] - row_ids[:, None] * row_t
    rel = jnp.clip(rel, 0, row_t - 1)        # [N, T_u] in-row
    return rel.reshape(pf, num_rows, t_u)


def compute_losses(params, net_state, batch: Dict, config: Dict,
                   train: bool, dropout_rng=None):
    """Shared forward pass → (metrics dict, logits, new_net_state).

    With multi-utterance packed rows (data/pipeline.py pack_factor) the
    batch carries ``reset_mask`` (state zeroing at segment starts) and a
    per-utterance view for the loss: ``utt_time_index`` gathers each
    packed utterance's frames out of the row-major logits so the CTC sees
    exactly the per-utterance [N, T_u, V] it would for unpacked rows."""
    logits, _, reg_losses, new_state = apply_model(
        params, net_state, batch["nnet_input"], batch["sequence_length"],
        config, train=train, dropout_rng=dropout_rng,
        reset_mask=batch.get("reset_mask"))
    if "utt_time_index" in batch:
        num_rows, row_t, vocab = logits.shape
        n_slots = batch["utt_time_index"].shape[0]
        pf = n_slots // num_rows
        mesh = config.get("mesh")
        # The row-batched gather below is only correct under the
        # pipeline's rank-major slot contract (slot k·B+r reads row r,
        # data/pipeline.Batch docstring).  The contract cannot be
        # checked on traced index values, so it is DECLARED: producers
        # that follow it set config["packed_slots_rank_major"]=True
        # (bin/nnet-train.py and bin/nnet-train-loop.py do next to their
        # BucketedBatcher, which asserts the invariant at assembly
        # time).  Undeclared
        # batches — an external producer with an arbitrary slot→row
        # mapping, e.g. utterance-order slots — get the layout-agnostic
        # flat gather, which is correct for any valid utt_time_index
        # but replicates the logits on a mesh (one-time warning).
        rank_major = (bool(config.get("packed_slots_rank_major"))
                      and pf >= 1 and n_slots == pf * num_rows)
        if not rank_major:
            if mesh is not None and mesh.devices.size > 1:
                if n_slots != max(pf, 1) * num_rows:
                    # declaring the flag would change nothing here —
                    # the slot count itself breaks the contract
                    reason = "slot count off the rank-major contract"
                    remedy = ("Emit pf*num_rows slots (dummy-padded) "
                              "in rank-major order to use the "
                              "row-batched sharded gather.")
                else:
                    reason = ("batch does not declare the rank-major "
                              "slot contract")
                    remedy = ("Batches from data/pipeline."
                              "BucketedBatcher follow the rank-major "
                              "slot contract; declare it with "
                              "config['packed_slots_rank_major']=True "
                              "to get the row-batched sharded gather.")
                _warn_flat_packed_gather(n_slots, num_rows, reason,
                                         remedy)
            flat = logits.reshape(num_rows * row_t, vocab)
            per_seq = ctc_loss(flat[batch["utt_time_index"]],
                               batch["utt_sequence_length"],
                               batch["nnet_target"],
                               batch["target_length"],
                               mesh=mesh)
        # ROW-LOCAL batched gather.  Slot k·B+r reads only row r's frames
        # (pipeline._assemble_packed invariant), so the per-utterance
        # view is expressed as a take_along_axis over the TIME axis with
        # the batch axis as a gather batch dim — a form GSPMD partitions
        # on a batch-sharded mesh (a flat [B·T] gather with arbitrary
        # indices forced an all-gather of the [B,T,V] logits on real
        # meshes).
        # Indices are rebased row-relative; dummy slots (zero-length ⇒
        # zero loss/grad) default to flat index 0 and clip to in-row.
        elif ctc_tiered_enabled(config) and pf >= 2:
            rel3 = _row_relative_slots(batch, num_rows, row_t, pf)
            # Rank-major slot layout (data/pipeline._assemble_packed):
            # slot k·B+r holds row r's (k+1)-th longest utterance, which
            # is ≤ ⌈row_t/(k+1)⌉ frames (the k+1 longest sum to ≤
            # row_t).  Gathering each rank tier at its static width cuts
            # the CTC view from pf·B·row_t frames to B·row_t·Σ1/(k+1) —
            # ~39% less gather+DP work at pf=3, ~48% at pf=4.
            # Each tier gather is a row-local take_along_axis with the
            # batch axis leading, so on a mesh it runs per-shard under
            # shard_map exactly like the full-width branch below (the
            # un-shard_mapped form made GSPMD all-gather the logits —
            # round-4 footgun, now closed for the opt-in path too).
            use_shard = (mesh is not None and mesh.devices.size > 1
                         and num_rows % mesh.devices.size == 0)
            if (mesh is not None and mesh.devices.size > 1
                    and not use_shard):
                _warn_tiered_unsharded(num_rows, mesh.devices.size)

            def tier_gather(lg, r):
                return jnp.take_along_axis(lg, r, axis=1)  # [B,w,V]

            if use_shard:
                from jax.sharding import PartitionSpec
                axis = mesh.axis_names[0]
                tier_gather_sharded = jax.shard_map(
                    tier_gather, mesh=mesh,
                    in_specs=(PartitionSpec(axis), PartitionSpec(axis)),
                    out_specs=PartitionSpec(axis))
            parts = []
            for k in range(pf):
                width = -(-row_t // (k + 1))
                sl = slice(k * num_rows, (k + 1) * num_rows)
                rel_k = rel3[k, :, :width, None]
                tier_logits = (tier_gather_sharded(logits, rel_k)
                               if use_shard else
                               tier_gather(logits, rel_k))
                parts.append(ctc_loss(
                    tier_logits, batch["utt_sequence_length"][sl],
                    batch["nnet_target"][sl], batch["target_length"][sl],
                    mesh=mesh))
            per_seq = jnp.concatenate(parts)
        else:
            rel3 = _row_relative_slots(batch, num_rows, row_t, pf)

            # [B, pf, T_u, V]: time-axis gather, batch dims (B) aligned;
            # slots fold out ROW-major so the utt axis of the CTC stays
            # aligned with the row sharding (per_seq is only summed, so
            # the rank-major → row-major reorder is loss-invariant)
            def gather_view(lg, r3):
                v = jnp.take_along_axis(
                    lg[:, None, :, :],
                    r3.transpose(1, 0, 2)[:, :, :, None], axis=2)
                return v.reshape(-1, r3.shape[2], lg.shape[-1])

            if mesh is not None and mesh.devices.size > 1 \
                    and num_rows % mesh.devices.size == 0:
                # GSPMD does not recognize the batched gather as
                # batch-parallel (measured: it all-gathers the [B,T,V]
                # logits); shard_map makes the row-locality explicit —
                # indices are row-relative, so shards need no rebasing,
                # and the row-major fold keeps the slot axis aligned
                # with the row sharding for the sharded CTC below.
                from jax.sharding import PartitionSpec
                axis = mesh.axis_names[0]
                view = jax.shard_map(
                    gather_view, mesh=mesh,
                    in_specs=(PartitionSpec(axis),
                              PartitionSpec(None, axis)),
                    out_specs=PartitionSpec(axis))(logits, rel3)
            else:
                view = gather_view(logits, rel3)

            def row_major(a):
                return (a.reshape((pf, num_rows) + a.shape[1:])
                        .swapaxes(0, 1)
                        .reshape((n_slots,) + a.shape[1:]))

            per_seq = ctc_loss(view,
                               row_major(batch["utt_sequence_length"]),
                               row_major(batch["nnet_target"]),
                               row_major(batch["target_length"]),
                               mesh=mesh)
    else:
        per_seq = ctc_loss(logits, batch["sequence_length"],
                           batch["nnet_target"], batch["target_length"],
                           mesh=config.get("mesh"))
    eval_loss = jnp.sum(per_seq)
    size = jnp.sum((batch["nnet_target"] >= 0).astype(jnp.int32))
    loss = eval_loss
    for value, weight in reg_losses:
        if value is not None and weight is not None and weight > 0:
            loss = loss + value
    metrics = {"size": size, "eval_loss": eval_loss, "loss": loss}
    return metrics, logits, new_state


def make_eval_step(config: Dict, with_logits: bool = False):
    """Returns eval_step(params, net_state, batch) → metrics[, logits]."""

    @jax.jit
    def eval_step(params, net_state, batch):
        metrics, logits, _ = compute_losses(
            params, net_state, batch, config, train=False)
        if with_logits:
            return metrics, logits
        return metrics

    return eval_step


def make_train_step(config: Dict,
                    learn_rate: float,
                    optimizer: str = "sgd",
                    clip_norm: float = 5.0,
                    l2_decay_weight: float = 1e-5):
    """Returns (init_opt_state, train_step).

    train_step(params, opt_state, net_state, rng, batch)
        → (params, opt_state, net_state, metrics)
    """
    tx = get_optimizer(optimizer, learn_rate)

    def loss_fn(params, net_state, batch, dropout_rng):
        metrics, _, new_state = compute_losses(
            params, net_state, batch, config, train=True,
            dropout_rng=dropout_rng)
        total = metrics["loss"] + l2_decay_weight * _l2_loss(params)
        return total, (metrics, new_state)

    @functools.partial(jax.jit, donate_argnums=(0, 1, 2))
    def train_step(params, opt_state, net_state, rng, batch):
        (_, (metrics, new_state)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, net_state, batch, rng)
        grads, _ = _clip_by_global_norm(grads, clip_norm)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, new_state, metrics

    return tx.init, train_step


def _clip_by_global_norm(grads, clip_norm: float):
    """tf.clip_by_global_norm semantics (reference graph.py:190-192)."""
    global_norm = optax.global_norm(grads)
    scale = jnp.minimum(1.0, clip_norm / jnp.maximum(global_norm, 1e-20))
    # TF scales by clip_norm/max(global_norm, clip_norm) — identical result
    clipped = jax.tree.map(lambda g: g * scale, grads)
    return clipped, global_norm
