"""Vectorized single-gather hash probe: read k-mer windows -> genome sets.

Device half of index/hashtable.py.  Exactly one dynamic gather per window
(the whole bucket row, ``slots * 16`` contiguous bytes), a key compare and
slot reduction over the row, plus a broadcast compare against the tiny
overflow stash (typically compiled away because the stash is empty).

``probe_kmers`` is one trace with no fences, so XLA may fuse the row
gather into the compare and the slot reductions instead of writing the
gathered [B, W, slots, 4] rows to device memory and reading them back.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from shotgun_tpu.ops.encode import mix32

_EMPTY32 = jnp.uint32(0xFFFFFFFF)


class HashTableDev(NamedTuple):
    """Device arrays of the bucketized hash table."""

    table: jnp.ndarray   # uint32 [n_buckets, slots, 4]
    stash: jnp.ndarray   # uint32 [stash_n, 4]


def resolve_rows(
    rows: jnp.ndarray,    # uint32 [B, W, slots, 4] pre-gathered bucket rows
    bidx: jnp.ndarray,    # int32  [B, W] bucket indices (for slot_pos)
    stash: jnp.ndarray,   # uint32 [stash_n, 4]
    lo: jnp.ndarray,      # uint32 [B, W]
    hi: jnp.ndarray,      # uint32 [B, W]
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Key compare + slot reduce over pre-gathered bucket rows.

    Returns (hit [B,W] bool, set_id [B,W] int32, genome_count [B,W] int32,
    slot_pos [B,W] int32).  ``slot_pos`` is the flat table slot of the
    match -- unique per distinct k-mer, so within-read dedupe can compare
    one int32 instead of the (lo, hi) pair.  Misses have set_id == -1,
    genome_count == 0, slot_pos == -1.
    """
    slots = rows.shape[2]
    match = (
        (rows[..., 0] == lo[..., None])
        & (rows[..., 1] == hi[..., None])
        & (rows[..., 2] != _EMPTY32)
    )
    found_sid = jnp.min(jnp.where(match, rows[..., 2], _EMPTY32), axis=-1)
    found_gc = jnp.max(jnp.where(match, rows[..., 3], jnp.uint32(0)), axis=-1)
    slot_iota = jax.lax.broadcasted_iota(jnp.uint32, (1, 1, slots), 2)
    flat = bidx.astype(jnp.uint32)[..., None] * jnp.uint32(slots) + slot_iota
    found_pos = jnp.min(jnp.where(match, flat, _EMPTY32), axis=-1)

    stash_n = stash.shape[0]
    if stash_n:
        # overflow stash: compare every window against every stash entry
        smatch = (stash[None, None, :, 0] == lo[..., None]) & (
            stash[None, None, :, 1] == hi[..., None]
        )
        s_sid = jnp.min(
            jnp.where(smatch, stash[None, None, :, 2], _EMPTY32), axis=-1
        )
        s_gc = jnp.max(
            jnp.where(smatch, stash[None, None, :, 3], jnp.uint32(0)), axis=-1
        )
        # stash slot_pos values sit past every table slot; the consumer only
        # needs uniqueness per key, so a large fixed offset suffices
        base = jnp.uint32(0x7FFF0000)
        s_pos = jnp.min(
            jnp.where(
                smatch,
                base + jax.lax.broadcasted_iota(jnp.uint32, (1, 1, stash_n), 2),
                _EMPTY32,
            ),
            axis=-1,
        )
        found_sid = jnp.minimum(found_sid, s_sid)
        found_gc = jnp.maximum(found_gc, s_gc)
        found_pos = jnp.minimum(found_pos, s_pos)

    hit = found_sid != _EMPTY32
    set_id = jnp.where(hit, found_sid, jnp.uint32(0)).astype(jnp.int32)
    set_id = jnp.where(hit, set_id, jnp.int32(-1))
    genome_count = found_gc.astype(jnp.int32)
    slot_pos = jnp.where(hit, found_pos, jnp.uint32(0)).astype(jnp.int32)
    slot_pos = jnp.where(hit, slot_pos, jnp.int32(-1))
    return hit, set_id, genome_count, slot_pos


def probe_kmers(
    table: jnp.ndarray,      # uint32 [n_buckets, slots, 4]
    stash: jnp.ndarray,      # uint32 [stash_n, 4] (stash_n is static, may be 0)
    lo: jnp.ndarray,         # uint32 [B, W]
    hi: jnp.ndarray,         # uint32 [B, W]
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Probe every window: bucket-row gather + resolve in one trace."""
    n_buckets = table.shape[0]
    bidx = (mix32(lo, hi, jnp) & jnp.uint32(n_buckets - 1)).astype(jnp.int32)
    rows = jnp.take(table, bidx, axis=0)  # [B, W, slots, 4]
    return resolve_rows(rows, bidx, stash, lo, hi)
