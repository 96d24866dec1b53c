"""Device mesh + multi-host initialization helpers.

Reference counterpart: Julia ``Distributed`` TCP master/worker setup
(SURVEY.md §7.8).  Here: one process per host via
``jax.distributed.initialize``, a single 1-D mesh ``('d',)`` over all
devices (entity instances hash-partition over it; the latent dim K stays
replicated — SURVEY §9.0).  The mesh follows the algorithm alone: the
GPUs of one host reach each other all to all over NVLink, and XLA hands
the collectives to NCCL.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec


AXIS = "d"


def data_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The 1-D data mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (no-op on a single process).

    On a multi-host cluster, call once per host before building the
    engine; `jax.devices()` then becomes global.
    """
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def instance_permutation(n: int, entity_index: int) -> np.ndarray:
    """Deterministic hash-partition permutation of instance ids.

    Independent of the device count (so factor state is comparable across
    shardings and resumable on a different topology); pseudo-random so nnz
    per contiguous shard is balanced in expectation — this is the
    "hash-partitioned entities" of the north star (BASELINE.json).
    Returns ``perm`` with ``perm[position] = original_id``.
    """
    rng = np.random.default_rng(0xB0F + entity_index)
    return rng.permutation(n).astype(np.int64)
