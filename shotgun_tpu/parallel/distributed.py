"""Multi-host initialization and mesh construction.

The reference has no distributed backend at all (SURVEY.md §2.2); this is
the new-build equivalent: ``jax.distributed`` for process bootstrap and a
global data mesh whose collectives ride the devices' interconnect within a
host and the network across hosts.  Per-genome count vectors and filter counters merge with exact
integer ``psum``/``pmin`` (parallel/mesh.py), so dumpalign output is
host-count invariant.

Typical multi-host launch (one process per host):

    from shotgun_tpu.parallel import distributed
    distributed.initialize()              # reads env or explicit args
    mesh = distributed.global_data_mesh()
    ...
    PseudoAlignment(...).align_packed_reads(batch, mesh=mesh,
                                            store_reads=False)

Each host feeds its own read shard (batch rows are globally ordered by
host rank); the merged AggResult is identical on every host, and host 0
writes the summary JSON.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
from jax.sharding import Mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """``jax.distributed.initialize`` passthrough; no-op for single
    process.  With no arguments, JAX auto-detects a cluster environment
    where one is present (e.g. SLURM)."""
    if num_processes == 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def initialize_from_env() -> Optional[Mesh]:
    """CLI mesh wiring: build the global data mesh from environment.

    * ``SHOTGUN_TPU_NPROCS`` (with ``SHOTGUN_TPU_PROC_ID`` and optional
      ``SHOTGUN_TPU_COORDINATOR``, default ``localhost:29400``): multi-
      process launch -- one CLI process per host, collectives over the
      interconnect (Gloo on CPU), host 0 prints the summary.
    * ``SHOTGUN_TPU_MESH=data``: single-process mesh over all local
      devices (multi-chip, one host).
    * neither set: returns None (plain single-device path).
    """
    nprocs = os.environ.get("SHOTGUN_TPU_NPROCS")
    if nprocs and int(nprocs) > 1:
        initialize(
            os.environ.get("SHOTGUN_TPU_COORDINATOR", "localhost:29400"),
            int(nprocs),
            int(os.environ["SHOTGUN_TPU_PROC_ID"]),
        )
        return global_data_mesh()
    if os.environ.get("SHOTGUN_TPU_MESH") == "data":
        return global_data_mesh()
    return None


def global_data_mesh(axis: str = "data") -> Mesh:
    """1-D mesh over every device in the job (all hosts)."""
    return Mesh(jax.devices(), (axis,))


def is_primary() -> bool:
    return jax.process_index() == 0


def local_read_slice(total_reads: int) -> slice:
    """The contiguous slice of a global read set this host should load --
    equal shards in process order, so global read order (and therefore the
    dumpalign Summary dict order) is preserved."""
    nproc = jax.process_count()
    per = (total_reads + nproc - 1) // nproc
    start = jax.process_index() * per
    return slice(start, min(start + per, total_reads))
