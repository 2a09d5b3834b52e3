"""Multi-process (multi-host) execution: the DCN half of the scaling story.

The reference is single-process (SURVEY.md section 5, "Distributed comm
backend: none"); the equivalent here is JAX's global-mesh SPMD model:

- every process calls :func:`initialize` (``jax.distributed.initialize``)
  against one coordinator; after that ``jax.devices()`` lists the GLOBAL
  device set and a ``Mesh`` built over it spans all processes;
- each process feeds only its LOCAL batch rows
  (:func:`global_batch_from_local`); the jitted program runs SPMD and XLA
  inserts any cross-process collectives (for this pipeline: only the
  feature-stats all-reduce, pipeline/sndenv.py) -- gloo on the CPU test
  fabric, NCCL between GPUs;
- results come back as global ``jax.Array``s whose shards are addressable
  only on their owning process; :func:`allgather` replicates them to every
  host when a full copy is wanted.

Tested end-to-end by ``tests/test_multiprocess.py``: two OS processes x 4
virtual CPU devices each form one 8-device mesh, run ``BatchedSndEnv`` on a
globally-sharded batch, and the gathered result equals the single-process
run bit-for-bit-tight (f32 reassociation slack only). The corpus-scale
composition is :meth:`CorpusRunner.run_distributed` (per-process file
shards + rank-0 manifest/stats merge).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from .mesh import batch_sharding

__all__ = [
    "initialize",
    "process_count",
    "process_index",
    "is_multiprocess_mesh",
    "global_batch_from_local",
    "allgather",
    "gather_local_rows",
    "barrier",
]


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    cpu_test_devices: Optional[int] = None,
) -> None:
    """``jax.distributed.initialize`` with the repo's test-fabric setup.

    ``cpu_test_devices``: when set, force the CPU backend with that many
    virtual devices per process and the gloo cross-process collective
    implementation BEFORE touching any jax op -- the 2-process CI fabric.
    Leave None on GPU hosts. Every process opens all the GPUs it can see
    and reserves most of each card's memory, so when several processes
    share one host give each its own card with ``CUDA_VISIBLE_DEVICES``.

    Must be called before any other jax API touches a backend.
    """
    if cpu_test_devices is not None:
        import os
        import re

        # force EXACTLY this device count (replace any inherited flag: the
        # test-suite conftest exports its own count=8, which a spawned
        # worker would otherwise silently inherit)
        flags = re.sub(
            r"--xla_force_host_platform_device_count=\d+",
            "",
            os.environ.get("XLA_FLAGS", ""),
        )
        os.environ["XLA_FLAGS"] = (
            flags
            + f" --xla_force_host_platform_device_count={cpu_test_devices}"
        ).strip()
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()


def is_multiprocess_mesh(mesh) -> bool:
    """True when the mesh's devices span more than one process (its arrays
    are then only partially addressable from any one host)."""
    return len({d.process_index for d in mesh.devices.flat}) > 1


def global_batch_from_local(mesh, local: np.ndarray, axis_name: str = "data"):
    """Assemble the global batch array from this process' local rows.

    Every process contributes ``local`` (same shape on each); the global
    array's leading axis is the process-ordered concatenation, sharded over
    the mesh's ``axis_name`` axis. The construction is metadata-only: local
    rows land on local devices, nothing crosses the network.
    """
    sharding = batch_sharding(mesh, np.ndim(local), axis_name)
    return jax.make_array_from_process_local_data(sharding, np.asarray(local))


def allgather(tree):
    """Replicate (a pytree of) global jax.Arrays to full host-local numpy
    copies on every process (one XLA all-gather per leaf)."""
    from jax.experimental import multihost_utils

    return jax.tree_util.tree_map(
        lambda x: None
        if x is None
        else np.asarray(multihost_utils.process_allgather(x, tiled=True)),
        tree,
        is_leaf=lambda v: v is None,
    )


def gather_local_rows(tree, local_rows: int, pad_rows: int):
    """Gather ``BatchedSndEnv.process_local`` outputs to full host copies
    and drop every process' internal pad rows.

    The global batch is the process-ordered concatenation of per-process
    blocks of ``local_rows + pad_rows`` rows (``process_local``'s return
    contract); this replicates the leaves (:func:`allgather`) and keeps
    rows ``p * (local_rows + pad_rows) + [0, local_rows)`` for each
    process p -- i.e. the caller-ordered batch, pad-free, identical on
    every process.
    """
    gathered = allgather(tree)
    block = local_rows + pad_rows
    keep = np.concatenate([
        np.arange(p * block, p * block + local_rows)
        for p in range(jax.process_count())
    ])
    return jax.tree_util.tree_map(
        lambda x: None if x is None else x[keep],
        gathered,
        is_leaf=lambda v: v is None,
    )


def barrier(name: str = "auditory_tpu_barrier") -> None:
    """Block until every process reaches this point (used between a
    distributed corpus run and the rank-0 shard merge)."""
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)
