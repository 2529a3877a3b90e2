"""Single-gather hash table for device-side k-mer probing.

Design constraint: the probe issues exactly ONE bucket-row gather per
query, one contiguous row of ``slots * 16`` bytes.  The build guarantees
it: every key lives in its primary bucket; keys that would overflow go to
a tiny *stash* that the probe resolves with a broadcast compare (no
gather).
If the stash exceeds its cap the table doubles and rebuilds -- for random
k-mer keys at the default sizing the stash is almost always empty.

Layout: ``table[n_buckets, SLOTS, 4]`` uint32 rows of
(key_lo, key_hi, set_id, genome_count); empty slots have set_id == EMPTY.
Full 62-bit keys are compared, never hashes, so collisions resolve exactly
(survey §7.3.4).  Replaces the reference's Python dict probe
(reference kmer.py:292-298).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from shotgun_tpu.ops.encode import mix32

SLOTS = 4
EMPTY = np.uint32(0xFFFFFFFF)
STASH_CAP = 64

#: initial expected keys-per-bucket by slot width -- sized so bucket
#: overflow (-> stash) is vanishingly rare; narrow buckets + low load
#: suit small tables while wide buckets + high load (64 B/key at 16
#: slots) keep 100M-key tables inside device memory
_TARGET_LAMBDA = {2: 0.03, 4: 0.25, 8: 2.0, 16: 4.0}


@dataclass
class ProbeTable:
    """Host-resident table arrays, ready to ship to device."""

    table: np.ndarray       # uint32 [n_buckets, SLOTS, 4]
    n_buckets: int          # power of two
    stash: np.ndarray       # uint32 [stash_n, 4] overflow keys (maybe empty)
    num_keys: int

    # retained for compatibility: number of bucket gathers a probe needs
    # (always 1 in this design)
    max_bucket_probe: int = 1

    @property
    def nbytes(self) -> int:
        return self.table.nbytes + self.stash.nbytes


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length()


def build_probe_table(
    kmer_lo: np.ndarray,
    kmer_hi: np.ndarray,
    set_id: np.ndarray,
    genome_count: np.ndarray,
    slots_per_bucket: int = SLOTS,
    stash_cap: int = STASH_CAP,
) -> ProbeTable:
    """Place every distinct k-mer in its primary bucket (single-gather
    guarantee) with overflow spilling to the stash."""
    u = kmer_lo.size
    lam = _TARGET_LAMBDA.get(slots_per_bucket, 1.0)
    n_buckets = _next_pow2(max(int(u / lam), 1))
    while True:
        table, stash_idx = _try_build(
            kmer_lo, kmer_hi, set_id, genome_count, n_buckets, slots_per_bucket
        )
        if stash_idx.size <= stash_cap:
            break
        n_buckets *= 2
    stash = np.empty((stash_idx.size, 4), dtype=np.uint32)
    stash[:, 0] = kmer_lo[stash_idx]
    stash[:, 1] = kmer_hi[stash_idx]
    stash[:, 2] = set_id[stash_idx].astype(np.uint32)
    stash[:, 3] = genome_count[stash_idx].astype(np.uint32)
    return ProbeTable(
        table=table, n_buckets=n_buckets, stash=stash, num_keys=int(u)
    )


def _try_build(kmer_lo, kmer_hi, set_id, genome_count, n_buckets, slots):
    u = kmer_lo.size
    mask = np.uint32(n_buckets - 1)
    table = np.empty((n_buckets, slots, 4), dtype=np.uint32)
    table[..., 2] = EMPTY

    bucket = (mix32(kmer_lo, kmer_hi, np) & mask).astype(np.int64)
    order = np.argsort(bucket, kind="stable")
    b_sorted = bucket[order]
    # rank of each key within its bucket
    group_start = np.searchsorted(b_sorted, b_sorted)
    rank = np.arange(u, dtype=np.int64) - group_start
    placed = rank < slots
    pk = order[placed]
    table[b_sorted[placed], rank[placed], 0] = kmer_lo[pk]
    table[b_sorted[placed], rank[placed], 1] = kmer_hi[pk]
    table[b_sorted[placed], rank[placed], 2] = set_id[pk].astype(np.uint32)
    table[b_sorted[placed], rank[placed], 3] = genome_count[pk].astype(np.uint32)
    return table, order[~placed]
