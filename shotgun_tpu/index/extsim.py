"""EXTSIM: greedy filtering of highly-similar genomes.

Array-native reimplementation of the reference pipeline
(reference kmer.py:152-263): per-identifier k-mer sets, ascending sort by
(unique_kmers, total_kmers, genome_length, order), greedy keep-first scan
with overlap-coefficient similarity |A∩B| / min(|A|, |B|), strict ``>``
threshold comparison, and a ``similarity_info`` report in processed order.

Identifier semantics are preserved exactly: records sharing a description
merge their k-mer sets, and the *last* such record defines genome_length
and sort order (dict-overwrite behavior, reference kmer.py:164-176).

Scaling design (SURVEY.md §7.1 L6): the O(G²) pairwise intersection work
is one overlap-count matrix ``O = M @ M.T`` over the 0/1 k-mer membership
matrix M [G, U].  M is streamed in k-mer chunks so memory stays bounded;
large G runs the chunks on the accelerator's matrix units (bf16 inputs --
0/1 is exact in bf16 -- with float32 accumulation, exact below 2^24
shared k-mers per pair).  Only the inherently-sequential greedy keep loop stays
on host, vectorized over the kept list per candidate.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from shotgun_tpu.index.build import KmerIndex, filter_records

#: identifiers below this count use the host float32 matmul; at or above
#: it chunks run on the accelerator (one-time jit compile amortized by
#: the G² work it replaces)
_DEVICE_MIN_G = int(os.environ.get("SHOTGUN_TPU_EXTSIM_DEVICE_MIN_G", "256"))
_CHUNK = 1 << 13


def _ident_pairs(index: KmerIndex) -> Tuple[List[str], np.ndarray, np.ndarray, np.ndarray]:
    """(idents, ident of record, kmer ids, ident ids) -- the unique
    (k-mer, identifier) membership pairs, sorted k-mer-major."""
    kmer_of_occ = np.repeat(
        np.arange(index.num_kmers, dtype=np.int64), np.diff(index.post_offsets)
    )
    ident_of_rec: Dict[str, int] = {}
    ident_idx = np.empty(max(index.num_records, 1), dtype=np.int64)
    idents: List[str] = []
    for rec, desc in enumerate(index.descriptions):
        if desc not in ident_of_rec:
            ident_of_rec[desc] = len(idents)
            idents.append(desc)
        ident_idx[rec] = ident_of_rec[desc]

    n_id = max(len(idents), 1)
    pairs = np.unique(
        kmer_of_occ * n_id + ident_idx[index.post_record]
    )
    return (
        idents,
        ident_idx[: index.num_records],
        pairs // n_id,
        (pairs % n_id).astype(np.int32),
    )


def _overlap_matrix_host(
    kmer_u: np.ndarray, ident_u: np.ndarray, g: int, num_kmers: int
) -> np.ndarray:
    """Chunked float32 matmul on host (exact: 0/1 inputs, counts < 2^24)."""
    out = np.zeros((g, g), dtype=np.float64)
    for c0 in range(0, max(num_kmers, 1), _CHUNK):
        s0, s1 = np.searchsorted(kmer_u, [c0, c0 + _CHUNK])
        if s0 == s1:
            continue
        mc = np.zeros((g, min(_CHUNK, num_kmers - c0)), dtype=np.float32)
        mc[ident_u[s0:s1], kmer_u[s0:s1] - c0] = 1.0
        out += (mc @ mc.T).astype(np.float64)
    return np.rint(out).astype(np.int64)


def _overlap_matrix_device(
    kmer_u: np.ndarray, ident_u: np.ndarray, g: int, num_kmers: int
) -> np.ndarray:
    """Accelerator path: k-mer chunks scatter onto a [G, C] one-hot on
    device, bf16 @ bf16.T accumulates the [G, G] counts in float32 on the
    matrix units.  Pairs ship once; per-chunk slices are padded to a fixed width so
    the whole sweep is one lax.scan."""
    import jax
    import jax.numpy as jnp

    n_chunks = max(-(-num_kmers // _CHUNK), 1)
    bounds = np.searchsorted(kmer_u, np.arange(n_chunks + 1) * _CHUNK)
    p_max = max(int(np.max(np.diff(bounds))), 1)
    id_c = np.full((n_chunks, p_max), g, dtype=np.int32)     # row g = pad sink
    km_c = np.zeros((n_chunks, p_max), dtype=np.int32)
    for c in range(n_chunks):
        s0, s1 = bounds[c], bounds[c + 1]
        id_c[c, : s1 - s0] = ident_u[s0:s1]
        km_c[c, : s1 - s0] = (kmer_u[s0:s1] - c * _CHUNK).astype(np.int32)

    @jax.jit
    def sweep(id_chunks, km_chunks):
        def step(acc, xs):
            ids, kms = xs
            mc = jnp.zeros((g + 1, _CHUNK), jnp.bfloat16).at[ids, kms].set(
                jnp.bfloat16(1))[:g]
            acc = acc + jnp.dot(
                mc, mc.T, preferred_element_type=jnp.float32)
            return acc, None

        acc0 = jnp.zeros((g, g), jnp.float32)
        acc, _ = jax.lax.scan(step, acc0, (id_chunks, km_chunks))
        return acc

    out = np.asarray(sweep(jnp.asarray(id_c), jnp.asarray(km_c)))
    return np.rint(out.astype(np.float64)).astype(np.int64)


def _overlap_matrix(
    kmer_u: np.ndarray, ident_u: np.ndarray, g: int, num_kmers: int
) -> np.ndarray:
    if g >= _DEVICE_MIN_G:
        return _overlap_matrix_device(kmer_u, ident_u, g, num_kmers)
    return _overlap_matrix_host(kmer_u, ident_u, g, num_kmers)


def apply_similarity_filter(index: KmerIndex, threshold: float) -> KmerIndex:
    """Run the full EXTSIM pipeline; returns a filtered index with
    ``similarity_info`` populated."""
    idents, _ident_of_rec, kmer_u, ident_u = _ident_pairs(index)
    g = len(idents)
    record_count = index.genome_counts()  # distinct records per k-mer

    totals = np.bincount(ident_u, minlength=g).astype(np.int64)
    uniq_mask = record_count[kmer_u] == 1
    uniques = np.bincount(ident_u[uniq_mask], minlength=g).astype(np.int64)

    # per-identifier stats; last record with an identifier wins for
    # genome_length and order (reference kmer.py:165-176)
    stats: Dict[str, Tuple[int, int, int, int]] = {}
    ident_pos = {d: i for i, d in enumerate(idents)}
    for order, desc in enumerate(index.descriptions):
        i = ident_pos[desc]
        stats[desc] = (int(uniques[i]), int(totals[i]),
                       int(index.record_lengths[order]), order)

    overlap = _overlap_matrix(kmer_u, ident_u, g, index.num_kmers)

    processed = sorted(stats.items(), key=lambda item: item[1])

    kept_ids = np.empty(g, dtype=np.int64)
    n_kept = 0
    similarity_info: Dict[str, Dict[str, object]] = {}
    for ident, (unique, total, length, _order) in processed:
        i = ident_pos[ident]
        verdict = None
        if n_kept:
            kl = kept_ids[:n_kept]
            denom = np.minimum(totals[i], totals[kl]).astype(np.float64)
            scores = np.divide(
                overlap[i, kl].astype(np.float64), denom,
                out=np.zeros(n_kept, dtype=np.float64), where=denom > 0)
            over = scores > threshold
            if over.any():
                j = int(np.argmax(over))  # first kept genome over threshold
                verdict = (idents[int(kl[j])], float(scores[j]))
        if verdict is None:
            similarity_info[ident] = {
                "kept": "yes",
                "unique_kmers": unique,
                "total_kmers": total,
                "genome_length": length,
                "similar_to": "NA",
                "similarity_score": "NA",
            }
            kept_ids[n_kept] = i
            n_kept += 1
        else:
            similarity_info[ident] = {
                "kept": "no",
                "unique_kmers": unique,
                "total_kmers": total,
                "genome_length": length,
                "similar_to": verdict[0],
                "similarity_score": verdict[1],
            }

    keep = {ident for ident, info in similarity_info.items() if info["kept"] == "yes"}
    kept_records = np.asarray(
        [r for r, desc in enumerate(index.descriptions) if desc in keep],
        dtype=np.int64,
    )
    out = filter_records(index, kept_records)
    out.similarity_info = similarity_info
    return out
