"""Data-parallel pseudo-alignment over a device mesh.

Reads are the data-parallel axis (SURVEY.md §2.2): each device aligns its
shard of the batch with the probe table replicated, then per-genome count
vectors and filter counters merge with exact integer ``psum`` collectives
and first-encounter order keys with ``pmin`` -- so dumpalign output is
invariant to the shard count by construction.

Both probe structures run as one program: the shard-local align
(``models.pipeline.align_batch_core``) and the psum-merge under one
``shard_map``.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from shotgun_tpu.models.pipeline import (
    AggResult,
    aggregate_batch,
    align_batch_core,
)


def make_mesh(devices: Optional[Sequence] = None, axis: str = "data") -> Mesh:
    devs = list(devices) if devices is not None else jax.devices()
    return Mesh(devs, (axis,))


def _lifted_psum_agg(local: AggResult, rows_per_shard: int, r: int) -> AggResult:
    """Merge shard-local aggregation into the global result (inside
    shard_map): integer psum for counters, pmin for order keys lifted to
    global read order (global_row = shard_idx * rows_per_shard + local_row)."""
    shard_idx = jax.lax.axis_index("data")
    offset = shard_idx.astype(jnp.int32) * jnp.int32(rows_per_shard * (r + 2))
    big = jnp.int32(0x3FFFFFFF)
    lifted = jnp.where(local.first_key < big, local.first_key + offset, big)
    psum = lambda x: jax.lax.psum(x, "data")
    return AggResult(
        n_unique=psum(local.n_unique),
        n_ambiguous=psum(local.n_ambiguous),
        n_unmapped=psum(local.n_unmapped),
        n_filtered_reads=psum(local.n_filtered_reads),
        n_filtered_kmers=psum(local.n_filtered_kmers),
        n_hr_kmers=psum(local.n_hr_kmers),
        unique_by_rec=psum(local.unique_by_rec),
        amb_by_rec=psum(local.amb_by_rec),
        first_key=jax.lax.pmin(lifted, "data"),
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "k", "has_mrq", "has_mkq", "has_mg", "packed"),
)
def align_aggregate_sharded(
    probe_tab, set_member, codes, qual, lengths, row_valid,
    m, p, mrq, mkq, mg,
    *,
    mesh: Mesh, k: int, has_mrq: bool, has_mkq: bool, has_mg: bool,
    packed: bool = False,
) -> AggResult:
    """Shard reads over the mesh's 'data' axis; return globally-merged
    aggregation (identical to single-device ``aggregate_batch``):
    shard-local align + aggregate, psum/pmin-merged, in one program."""
    n_shards = mesh.shape["data"]
    rows_per_shard = codes.shape[0] // n_shards
    r = set_member.shape[1]

    def fn(probe_tab, set_member, codes, qual, lengths, row_valid,
           m, p, mrq, mkq, mg):
        res = align_batch_core(
            probe_tab, set_member, codes, qual, lengths, m, p, mrq, mkq, mg,
            k=k, has_mrq=has_mrq, has_mkq=has_mkq, has_mg=has_mg,
            packed=packed,
        )
        local = aggregate_batch(res, row_valid)
        return _lifted_psum_agg(local, rows_per_shard, r)

    import jax.tree_util as jtu
    tab_specs = jtu.tree_map(lambda _: P(), probe_tab)
    return jax.shard_map(
        fn, mesh=mesh,
        in_specs=(
            tab_specs, P(),
            P("data"), P("data"), P("data"), P("data"),
            P(), P(), P(), P(), P(),
        ),
        out_specs=P(),
    )(probe_tab, set_member, codes, qual, lengths, row_valid,
      m, p, mrq, mkq, mg)


def shard_read_arrays(mesh: Mesh, *arrays):
    """Batch-dim-sharded global arrays from (full) host copies.

    Single process: plain device_put.  Multi-process: every process holds
    the same full batch (global read order); each contributes the
    contiguous row range its devices own via
    ``make_array_from_process_local_data`` (process p owns rows
    [p*B/nproc, (p+1)*B/nproc) because the mesh enumerates devices in
    process order), so the global array -- and therefore the psum-merged
    aggregation -- is identical to the single-process result.
    """
    nproc = jax.process_count()
    pid = jax.process_index()
    out = []
    for arr in arrays:
        spec = P("data") if arr.ndim == 1 else P("data", *([None] * (arr.ndim - 1)))
        sh = NamedSharding(mesh, spec)
        if nproc == 1:
            out.append(jax.device_put(arr, sh))
        else:
            per = arr.shape[0] // nproc
            local = arr[pid * per: (pid + 1) * per]
            out.append(jax.make_array_from_process_local_data(
                sh, local, global_shape=arr.shape))
    return tuple(out)


def replicate(mesh: Mesh, *arrays):
    out = []
    for arr in arrays:
        out.append(jax.device_put(arr, NamedSharding(mesh, P())))
    return tuple(out)
