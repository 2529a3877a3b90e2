"""Tensor-parallel probe: k-mer table sharded across a 'table' mesh axis.

When the k-mer database exceeds one device's memory, the sorted key table is
range-partitioned across the 'table' axis of a ('data', 'table') mesh
(SURVEY.md §2.2 TP row).  Queries are replicated along 'table' (reads are
already sharded along 'data'): each device sort-joins the full query set
of its data row against its local key range, then per-query results merge
with ``pmax`` collectives -- exactly one shard can hit a given key, and a
read's duplicate k-mers share a key so they land on the same shard,
making the in-sort first-occurrence dedupe shard-local-correct.

Communication per batch: the query broadcast is free (reads are device-
put replicated along 'table' up front) and the merge is one integer
``pmax`` of four [B/D, W] arrays over the interconnect.  Each shard's sort shrinks to
U/T + N elements, so table capacity scales linearly with the axis size
while per-batch cost stays flat.

Aggregation counters psum over 'data' only: every device in a table group
holds identical merged per-query results, so summing over 'table' would
multiply counts by the axis size.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from shotgun_tpu.models.pipeline import (
    AggResult,
    aggregate_batch,
    core_from_probe,
)
from shotgun_tpu.ops.encode import (
    rolling_encode_jnp,
    rolling_encode_words_jnp,
    window_quality_sums,
)
from shotgun_tpu.ops.probe_sort import SortedTableDev, SortedTableDevW
from shotgun_tpu.ops.probe_sort2 import (
    probe_dedupe_sorted,
    probe_dedupe_sorted_words,
)
from shotgun_tpu.parallel.mesh import _lifted_psum_agg

#: table pad rows: all-ones keys could collide with the poly-T k-mer, so
#: pads are marked by genome_count == 0 (impossible for real entries) and
#: masked out of ``hit`` after the local probe
_PAD_KEY = np.uint32(0xFFFFFFFF)


def make_mesh_2d(devices=None, data: int = None, table: int = 1) -> Mesh:
    """('data', 'table') mesh over the given (or all) devices."""
    devs = list(devices) if devices is not None else jax.devices()
    if data is None:
        data = len(devs) // table
    assert data * table == len(devs), (data, table, len(devs))
    arr = np.array(devs).reshape(data, table)
    return Mesh(arr, ("data", "table"))


def pad_table_for_sharding(
    tab_host: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
    n_shards: int,
) -> SortedTableDev:
    """Pad the key-sorted host table to a multiple of n_shards.

    Pad rows carry the max key and genome_count 0; range partitioning a
    key-sorted array into equal contiguous chunks IS the shard layout, so
    no extra routing metadata is needed.
    """
    klo, khi, sid, gc = tab_host
    u = klo.size
    up = -(-max(u, 1) // n_shards) * n_shards
    pad = up - u
    return SortedTableDev(
        klo=np.concatenate([klo, np.full(pad, _PAD_KEY, np.uint32)]),
        khi=np.concatenate([khi, np.full(pad, _PAD_KEY, np.uint32)]),
        sid=np.concatenate([sid, np.zeros(pad, np.int32)]).astype(np.int32),
        gc=np.concatenate([gc, np.zeros(pad, np.int32)]).astype(np.int32),
    )


def pad_table_words_for_sharding(
    tab_host: Tuple[Tuple[np.ndarray, ...], np.ndarray, np.ndarray],
    n_shards: int,
) -> SortedTableDevW:
    """Multi-word form of ``pad_table_for_sharding`` (any k).

    Pad rows carry all-ones key words and gc == 0; the words probe gives
    gc==0 rows the pad tag, so they are inert even when the all-ones key
    equals a real poly-T k-mer (possible when 2k == 32*nw)."""
    cols, sid, gc = tab_host
    u = cols[0].size
    up = -(-max(u, 1) // n_shards) * n_shards
    pad = up - u
    return SortedTableDevW(
        kws=tuple(
            np.concatenate([c, np.full(pad, _PAD_KEY, np.uint32)])
            for c in cols
        ),
        sid=np.concatenate([sid, np.zeros(pad, np.int32)]).astype(np.int32),
        gc=np.concatenate([gc, np.zeros(pad, np.int32)]).astype(np.int32),
    )


def device_put_sharded_table(mesh: Mesh, tab):
    """Place the padded table with its key dim split along 'table' and
    replicated along 'data'."""
    if not isinstance(tab, (SortedTableDev, SortedTableDevW)):
        raise TypeError(
            "table sharding supports the sort-merge probe only "
            f"(got {type(tab).__name__})"
        )
    sh = NamedSharding(mesh, P("table"))
    return jax.tree.map(lambda a: jax.device_put(a, sh), tab)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "k", "has_mrq", "has_mkq", "has_mg"),
)
def align_aggregate_table_sharded(
    tab: SortedTableDev,       # key dim sharded along 'table'
    set_member,
    codes,                     # [B, L] sharded along 'data'
    qual,
    lengths,
    row_valid,
    m, p, mrq, mkq, mg,
    *,
    mesh: Mesh,
    k: int,
    has_mrq: bool,
    has_mkq: bool,
    has_mg: bool,
) -> AggResult:
    """DP x TP pseudo-alignment: reads sharded on 'data', table on 'table'.

    Output equals the single-device ``aggregate_batch`` exactly, invariant
    to both axis sizes (integer collectives only).

    Only the sort-merge probe supports table sharding: its key-sorted
    layout makes range partitioning the shard function.  The bucketized
    hash table would need its bucket space re-hashed per shard; run it
    replicated via ``parallel.mesh.align_aggregate_sharded`` instead.
    """
    if not isinstance(tab, (SortedTableDev, SortedTableDevW)):
        raise TypeError(
            "table sharding supports the sort-merge probe only "
            f"(got {type(tab).__name__}); build the table with "
            "SHOTGUN_TPU_PROBE=sort, or keep the hash probe replicated "
            "via parallel.mesh.align_aggregate_sharded"
        )
    n_data = mesh.shape["data"]
    rows_per_shard = codes.shape[0] // n_data
    r = set_member.shape[1]
    num_sets = set_member.shape[0]

    def fn(tab, set_member, codes, qual, lengths, row_valid,
           m, p, mrq, mkq, mg):
        b, l = codes.shape
        w = l - k + 1
        w_iota = jax.lax.broadcasted_iota(jnp.int32, (b, w), 1)
        lens = lengths.astype(jnp.int32)
        valid = w_iota < (lens - jnp.int32(k - 1))[:, None]
        if has_mkq:
            qsum = window_quality_sums(qual, k)
            kq_ok = valid & (qsum >= mkq * jnp.int32(k))
        else:
            kq_ok = valid
        if isinstance(tab, SortedTableDevW):
            # multi-word keys (any k): pads are tag-excluded by gc == 0
            qws = rolling_encode_words_jnp(codes, k)
            hit, sid, gcount, first_occ = probe_dedupe_sorted_words(
                tab, qws, kq_ok,
                num_sets=num_sets, max_genome_count=r,
            )
        else:
            lo, hi = rolling_encode_jnp(codes, k)
            hit, sid, gcount, first_occ = probe_dedupe_sorted(
                tab, lo, hi, kq_ok,
                num_sets=num_sets, max_genome_count=r,
            )
            # pad rows are marked by gc == 0
            hit = hit & (gcount > 0)
            first_occ = first_occ & hit
        # merge across table shards: exactly one shard hits a given key
        hit = jax.lax.pmax(hit.astype(jnp.int32), "table") > 0
        sid = jax.lax.pmax(sid, "table")
        gcount = jax.lax.pmax(gcount, "table")
        first_occ = jax.lax.pmax(first_occ.astype(jnp.int32), "table") > 0
        sid = jnp.where(hit, sid, jnp.int32(-1))

        res = core_from_probe(
            (hit, sid, gcount, None), set_member, qual, lengths,
            m, p, mrq, mkq, mg,
            k=k, has_mrq=has_mrq, has_mkq=has_mkq, has_mg=has_mg,
            pre_first_occ=first_occ,
        )
        local = aggregate_batch(res, row_valid)
        # identical on every table shard -> psum over 'data' only
        return _lifted_psum_agg(local, rows_per_shard, r)

    import jax.tree_util as jtu
    tab_specs = jtu.tree_map(lambda _: P("table"), tab)
    return jax.shard_map(
        fn, mesh=mesh,
        in_specs=(
            tab_specs,
            P(),
            P("data", None), P("data", None), P("data"), P("data"),
            P(), P(), P(), P(), P(),
        ),
        out_specs=P(),
    )(tab, set_member, codes, qual, lengths, row_valid,
      m, p, mrq, mkq, mg)
