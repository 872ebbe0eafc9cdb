"""Shared plumbing for the bin/ command-line tools."""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import jax
import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself, so
    no other directory is configured); otherwise the cache lives at one
    fixed path inside the checkout, ``<repo>/.jax_cache``.  The outer
    training loop launches one process per epoch (reference
    scripts/train.sh contract), so without the cache every epoch re-pays
    the full jit compile of the train/eval steps."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(REPO_ROOT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    if not os.environ.get("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"):
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


enable_compile_cache()

from . import logging_util as log
from .data import BucketedBatcher, scan_label_lengths, scan_scp
from .models import init_model
from .parallel import get_mesh, shard_batch


def str2bool(v: str) -> bool:
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def log_invocation() -> None:
    log.info(" ".join(sys.argv))


def build_batcher(records_scp: str, config: Dict, batch_size: int,
                  need_labels: bool = True,
                  pack_factor: int = 1) -> BucketedBatcher:
    metas = scan_scp(records_scp)
    label_lengths = None
    if need_labels and metas and metas[0].has_label:
        label_lengths = scan_label_lengths(metas)
    # Packed batches lay slots out rank-major (longest-first per row);
    # the batcher asserts that invariant at assembly time.  The contract
    # is DECLARED by the code that owns the config↔producer pairing
    # (bin/nnet-train.py, bin/nnet-train-loop.py set
    # config["packed_slots_rank_major"]=True next to their batcher) so
    # train/graph.compute_losses may use the row-batched sharded gather
    # — deliberately NOT declared here: this helper must not mutate a
    # shared config that may later also see packed batches from an
    # arbitrary-layout producer (which need the layout-agnostic flat
    # gather).  The opt-in tiered CTC gather is likewise resolved where
    # the gather is built (train/graph.ctc_tiered_enabled), not here.
    return BucketedBatcher(
        metas,
        batch_size=batch_size,
        left_context=config.get("left_context", 0) or 0,
        right_context=config.get("right_context", 0) or 0,
        subsample=config.get("subsample", 0) or 0,
        label_lengths=label_lengths,
        pack_factor=pack_factor,
    )


def make_shard_fn():
    """Returns (shard_fn, mesh).  The shard/replicate decision is made
    per array in parallel.shard_batch (batches shard across the data
    mesh when the leading axis divides it; otherwise replicated)."""
    mesh = get_mesh()

    def shard_fn(batch):
        arrays = {
            "nnet_input": batch.nnet_input,
            "sequence_length": batch.sequence_length,
            "nnet_target": batch.nnet_target,
            "target_length": batch.target_length,
        }
        if getattr(batch, "reset_mask", None) is not None:
            arrays["reset_mask"] = batch.reset_mask
            arrays["utt_time_index"] = batch.utt_time_index
            arrays["utt_sequence_length"] = batch.utt_sequence_length
        return shard_batch(mesh, arrays)

    return shard_fn, mesh


def init_from_config(config: Dict):
    """Deterministic model init seeded from the config's ``seed`` key."""
    seed = int(config.get("seed", 777) or 777)
    return init_model(jax.random.PRNGKey(seed), config)


def check_objective_and_type(args, config: Dict) -> None:
    if args.objective != "ctc":
        log.fatal("unsupported objective: %s" % args.objective)
        sys.exit(1)
    nnet_type = config.get("nnet_type")
    if nnet_type not in ("blstm", "cudnnlstm", "lstm"):
        log.fatal("unsupported nnet_type: %s" % nnet_type)
        sys.exit(1)
