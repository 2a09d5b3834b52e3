"""Device mesh and sharding helpers.

The reference is single-threaded, single-process (SURVEY.md section 5); the
scaling model here is SPMD data parallelism over utterances: a 1-D
``jax.sharding.Mesh`` with a ``data`` axis, batch arrays sharded on their
leading axis via NamedSharding, XLA inserting any collectives (none are needed
in the hot path -- the pipeline is pointwise per utterance; only metric
reductions use ``psum``-style collectives).

For single extremely long utterances, :func:`segment_sharding` shards the
*segment* axis instead (CP-style): segments are independent when
``prev_smooth == 0``, so this is also communication-free.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh",
    "batch_sharding",
    "segment_sharding",
    "replicated",
    "pad_to_multiple",
    "shard_put",
]


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None, axis_name: str = "data"
) -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices."""
    devs = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devs, (axis_name,))


def batch_sharding(mesh: Mesh, ndim: int, axis_name: str = "data") -> NamedSharding:
    """Shard the leading (batch) axis; replicate the rest."""
    return NamedSharding(mesh, P(axis_name, *([None] * (ndim - 1))))


# Shard axis 0 = segment axis of a single long utterance (CP-style): the
# same leading-axis layout as batch_sharding, kept as a semantic alias so
# the two can never diverge.
segment_sharding = batch_sharding


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def shard_put(mesh: Mesh, arr, axis_name: str = "data"):
    """Device-put an array sharded on its leading axis."""
    return jax.device_put(arr, batch_sharding(mesh, np.ndim(arr), axis_name))
