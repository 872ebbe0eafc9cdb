"""Device mesh + data-parallel shardings.

The reference has no in-framework distributed training at all (one process,
one GPU; SURVEY §2.5) — here data parallelism is first-class: a 1-D
``data`` mesh over all local devices, batches sharded on the batch axis,
parameters replicated.  XLA inserts the gradient all-reduce (NCCL on GPUs) when
the jitted train step consumes sharded batches and produces replicated
parameter updates — no explicit collectives needed at this scale
(~10-30M-param models, DP-only; matching the reference's capability set
per SURVEY §2.5).
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_warned_replicated = False


def get_mesh(num_devices: Optional[int] = None) -> Mesh:
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), ("data",))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("data"))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, batch: Dict):
    """Device-put a host batch dict, splitting the batch axis across the
    mesh when divisible (else replicating, with a one-time warning — a
    replicated batch silently forfeits the mesh's data parallelism)."""
    global _warned_replicated
    num = mesh.devices.size
    out = {}
    for key, value in batch.items():
        if hasattr(value, "shape") and value.ndim >= 1 \
                and value.shape[0] % num == 0:
            sharding = NamedSharding(mesh, P("data"))
        else:
            if num > 1 and hasattr(value, "shape") and value.ndim >= 1 \
                    and not _warned_replicated:
                _warned_replicated = True
                warnings.warn(
                    "shard_batch: batch axis %d of %r is not divisible by "
                    "the %d-device mesh; replicating instead of sharding "
                    "(an up-to-%dx throughput loss). Pad or resize batches "
                    "to a multiple of the mesh size."
                    % (value.shape[0], key, num, num), stacklevel=2)
            sharding = NamedSharding(mesh, P())
        out[key] = jax.device_put(value, sharding)
    return out
