"""Sorted k-mer table containers + host-side table assembly.

The sort-merge probe itself lives in ``probe_sort2`` (boundary-scan
join, no associative_scan); this module keeps the device table
NamedTuples and the host array extractors shared by the probe, the
range-partitioned TP form (parallel/table_sharded.py) and the
device-side builder (index/device_build.py).

Cost model (why a sorted table at all): merging table and query keys in
one bandwidth-bound ``lax.sort`` needs no gather at all, and the table
takes 16 B/key instead of the bucket hash's 64.  Its per-batch cost grows
with the table, so above ``KmerReference.AUTO_HASH_MIN_KEYS`` distinct
keys the auto probe switches to the hash table.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax  # noqa: F401  (kept: device arrays in the NamedTuples)
import jax.numpy as jnp
import numpy as np


class SortedTableDev(NamedTuple):
    """Device arrays of the key-sorted k-mer index (k <= 31 2-word form)."""

    klo: jnp.ndarray   # uint32 [U] key low words, sorted by (hi, lo)
    khi: jnp.ndarray   # uint32 [U] key high words
    sid: jnp.ndarray   # int32  [U] genome-set ids
    gc: jnp.ndarray    # int32  [U] genome counts


class SortedTableDevW(NamedTuple):
    """Multi-word form for any k: key words MOST-significant first, each
    [U] uint32, rows sorted by the full lexicographic key (identical to
    the host index's sorted order).  ``gc == 0`` marks pad rows (range-
    partitioning pads; impossible for real entries)."""

    kws: Tuple[jnp.ndarray, ...]
    sid: jnp.ndarray   # int32 [U]
    gc: jnp.ndarray    # int32 [U]


def sorted_table_host_words(index):
    """Host arrays for SortedTableDevW from a KmerIndex: key-word columns
    reversed to most-significant-first."""
    nw = index.kmer_words.shape[1]
    cols = tuple(
        np.ascontiguousarray(index.kmer_words[:, j])
        for j in range(nw - 1, -1, -1)
    )
    return (
        cols,
        index.set_id.astype(np.int32),
        index.genome_counts().astype(np.int32),
    )


def sorted_table_host(index) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host arrays for SortedTableDev from a KmerIndex."""
    return (
        index.kmer_lo,
        index.kmer_hi,
        index.set_id.astype(np.int32),
        index.genome_counts().astype(np.int32),
    )
