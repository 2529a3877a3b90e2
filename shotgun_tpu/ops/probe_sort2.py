"""Sort-merge k-mer probe v2/v3: gather-free lookup + in-sort dedupe.

Replaces ops/probe_sort.py's associative_scan payload fill (which compiles
an enormous HLO) with plain ``cummax`` carries, and folds the per-read
first-occurrence dedupe (reference kmer.py:429) into the sorted domain so
the pipeline's O(W^2) dedupe block disappears.

The probe is one ``lax.sort`` join:

  1. tag-pack table keys (bit 0 = 0) and query keys (bit 0 = 1); queries
     that failed the MKQ/validity gates get an all-ones sentinel key so
     they can never match;
  2. one stable 2-key sort groups equal keys, table row first, queries in
     original (read, window) order;
  3. ``cummax`` scans recover, per query, whether its run contains a table
     row and that row's payload: each table row carries
     ``TBIT | (rank << Pb) | payload_chunk`` words -- the cummax over
     sorted order always selects the latest table row, whose low bits are
     the payload chunk (rank is monotone in sorted position because the
     table is pre-sorted by key);
  4. a query is a within-read duplicate iff its sorted predecessor is a
     query with the same key from the same read (stable order makes
     same-read same-key queries consecutive);
  5. one restore sort by original position brings (hit, set id, genome
     count, first-occurrence) back to [B, W].

Zero gathers, zero scatters: sorts + cumulative maxima + elementwise only.

v3 payload economy (the sorts dominate this probe's time): query rows carry their restore position ``val`` IN the first
carry word (table words have bit 30 set, so they dominate any val under
the cummax and a query row's own word still reads back as its val), the
(sid, gc) payload chunks share one bit stream, and the restore sort packs
(sid, gc, flags) into a single word with a 1-key unstable sort (restore
keys are distinct for the query rows that matter).  Main join: 2 sort
keys + 1 carry word (vs 2+3 before); restore: 1 key + 1 payload (vs 1+3)
whenever the static bit budget fits, with exact multi-word fallback.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from shotgun_tpu.ops.probe_sort import (  # noqa: F401 (re-export)
    SortedTableDev,
    SortedTableDevW,
    sorted_table_host,
    sorted_table_host_words,
)

_NEG1 = np.int32(-1)
#: table-row flag bit in carry words; query rows carry val < 2**30
_TBIT = np.int32(1 << 30)


def _bits_for(n: int) -> int:
    """ceil(log2(max(n, 2))) -- bits to represent values in [0, n)."""
    return max(int(np.ceil(np.log2(max(int(n), 2)))), 1)


def _shift_pack(lo, hi, tag_bit: int):
    """62-bit key -> order-preserving 64-bit pair with tag in bit 0."""
    skh = (hi << jnp.uint32(1)) | (lo >> jnp.uint32(31))
    skl = (lo << jnp.uint32(1)) | jnp.uint32(tag_bit)
    return skh, skl


def _carry_layout(u: int, n: int, num_sets: int, max_genome_count: int):
    """Static sizing of the v3 carry words.

    Each carry word is ``TBIT | (rank << pb) | chunk`` for table rows and
    ``val`` for query rows; chunks are pb-bit slices of the packed
    (sid << gc_bits | gc) payload.  Returns (pb, gc_bits, payload_bits,
    n_words, gc_cap).
    """
    assert n < (1 << 30), "batch too large for val-in-carry packing"
    rbits = _bits_for(u)
    pb = 30 - rbits
    assert pb >= 1, "table too large for int32 carry words"
    sid_bits = _bits_for(num_sets)
    gc_cap = min(int(max_genome_count), (1 << 16) - 1)
    gc_bits = _bits_for(gc_cap + 1)
    payload_bits = sid_bits + gc_bits
    n_words = -(-payload_bits // pb)
    return pb, gc_bits, payload_bits, n_words, gc_cap


def _carry_words(tab_sid, tab_gc, rank, n, pb, gc_bits, n_words, gc_cap,
                 table_live=None):
    """Build the concatenated carry words (table rows || query vals)."""
    payload = ((tab_sid.astype(jnp.uint32) << jnp.uint32(gc_bits))
               | jnp.clip(tab_gc, 0, jnp.int32(gc_cap)).astype(jnp.uint32))
    mask_pb = jnp.uint32((1 << pb) - 1)
    qval = jnp.arange(n, dtype=jnp.int32)
    words = []
    for j in range(n_words):
        chunk = (payload >> jnp.uint32(j * pb)) & mask_pb
        wj = (_TBIT | (rank << jnp.uint32(pb)).astype(jnp.int32)
              | chunk.astype(jnp.int32))
        if table_live is not None:
            # dead rows (padding) must never win a cummax: carry -1
            wj = jnp.where(table_live, wj, _NEG1)
        words.append(jnp.concatenate([wj, qval]))
    return words


def _payload_from_cummax(words_s, pb, gc_bits, payload_bits, n_words):
    """Recover (sid, gc) for matched queries from carry-word cummaxes.

    Also returns the first word's raw sorted stream (query rows read back
    their own val from it)."""
    mask_pb = jnp.uint32((1 << pb) - 1)
    acc = jnp.zeros(words_s[0].shape, dtype=jnp.uint32)
    for j in range(n_words):
        cw = jax.lax.cummax(words_s[j])
        chunk = cw.astype(jnp.uint32) & mask_pb
        acc = acc | (chunk << jnp.uint32(j * pb))
    if payload_bits < 32:
        acc = acc & jnp.uint32((1 << payload_bits) - 1)
    gc_q = (acc & jnp.uint32((1 << gc_bits) - 1)).astype(jnp.int32)
    sid_q = (acc >> jnp.uint32(gc_bits)).astype(jnp.int32)
    return sid_q, gc_q


def _restore(is_table, val_q, sid_q, gc_q, flags, n, b, w, num_sets,
             gc_bits):
    """Bring (hit, sid, gc, first_occ) back to [B, W] with ONE 1-key sort.

    ``val_q`` holds each query row's original flat position (garbage for
    table rows); table rows get key n so they sort past every query.
    Packs (flags | gc | sid) into one payload word when the static bit
    budget fits (sid_bits + gc_bits + 2 <= 31), else falls back to
    separate words.  Keys of the first n rows are distinct, so an
    unstable sort is deterministic where it matters.
    """
    key = jnp.where(is_table, jnp.int32(n), val_q)
    sid_bits = _bits_for(num_sets)
    if sid_bits + gc_bits + 2 <= 31:
        packed = (flags
                  | (gc_q << jnp.int32(2))
                  | (sid_q << jnp.int32(2 + gc_bits)))
        _, packed_r = jax.lax.sort((key, packed), num_keys=1,
                                   is_stable=False)
        packed_r = packed_r[:n]
        flags_r = packed_r & jnp.int32(3)
        gc_r = (packed_r >> jnp.int32(2)) & jnp.int32((1 << gc_bits) - 1)
        sid_r = packed_r >> jnp.int32(2 + gc_bits)
    else:
        _, sid_r, gc_r, flags_r = jax.lax.sort(
            (key, sid_q, gc_q, flags), num_keys=1, is_stable=False)
        sid_r, gc_r, flags_r = sid_r[:n], gc_r[:n], flags_r[:n]
    hit = (flags_r & 1).astype(bool).reshape(b, w)
    first_occ = (flags_r >> 1).astype(bool).reshape(b, w)
    set_id = jnp.where(hit, sid_r.reshape(b, w), _NEG1)
    genome_count = jnp.where(hit, gc_r.reshape(b, w), jnp.int32(0))
    return hit, set_id, genome_count, first_occ


def probe_dedupe_sorted(
    tab: SortedTableDev,
    lo: jnp.ndarray,      # uint32 [B, W]
    hi: jnp.ndarray,      # uint32 [B, W]
    query_ok: jnp.ndarray,  # bool [B, W] windows that passed validity + MKQ
    *,
    num_sets: int,
    max_genome_count: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Probe + within-read first-occurrence dedupe in one sorted join.

    Returns (hit, set_id, genome_count, first_occ), all [B, W]:
    ``hit`` is True iff the window passed ``query_ok`` and its k-mer is in
    the table; ``first_occ`` marks the first hit window of each distinct
    k-mer within its read (reference kmer.py:429).  Misses have
    set_id == -1, genome_count == 0.

    ``num_sets``/``max_genome_count`` bound the payload values (static) so
    the carry words can be sized; genome counts saturate at 2**16-1 when
    larger (the count is only compared against mg and == 1).
    """
    b, w = lo.shape
    n = b * w
    u = int(tab.klo.shape[0])
    if u == 0:
        neg = jnp.full((b, w), -1, dtype=jnp.int32)
        zero = jnp.zeros((b, w), dtype=jnp.int32)
        false = jnp.zeros((b, w), dtype=bool)
        return false, neg, zero, false
    m = u + n

    pb, gc_bits, payload_bits, n_words, gc_cap = _carry_layout(
        u, n, num_sets, max_genome_count)

    # ---- build sort operands ----
    qlo = lo.reshape(-1)
    qhi = hi.reshape(-1)
    ok = query_ok.reshape(-1)
    qkh, qkl = _shift_pack(qlo, qhi, 1)
    # gated-out queries get the max key (can't match; table keys have tag 0)
    ones = jnp.uint32(0xFFFFFFFF)
    qkh = jnp.where(ok, qkh, ones)
    qkl = jnp.where(ok, qkl, ones)
    tkh, tkl = _shift_pack(tab.klo, tab.khi, 0)

    ckh = jnp.concatenate([tkh, qkh])
    ckl = jnp.concatenate([tkl, qkl])
    rank = jnp.arange(u, dtype=jnp.uint32)
    words = _carry_words(tab.sid, tab.gc, rank, n, pb, gc_bits, n_words,
                         gc_cap, table_live=tab.gc > 0)

    ops = jax.lax.sort((ckh, ckl, *words), num_keys=2, is_stable=True)
    skh, skl = ops[0], ops[1]
    words_s = ops[2:]

    # ---- sorted-domain logic (scans + elementwise) ----
    # shape-bucket pad rows (reference._pad_rows) carry all-ones keys:
    # tag bit 0 like table rows, but skh's MSB set -- impossible for a
    # real 62-bit key (hi < 2**30), so the MSB test exactly excludes
    # them from matching while they still restore past every query
    iota = jnp.arange(m, dtype=jnp.int32)
    tag_table = (skl & jnp.uint32(1)) == 0
    is_table = tag_table & ((skh >> jnp.uint32(31)) == 0)
    prev_same = jnp.concatenate([
        jnp.zeros(1, dtype=bool),
        (skh[1:] == skh[:-1]) & ((skl[1:] >> 1) == (skl[:-1] >> 1)),
    ])
    lt = jax.lax.cummax(jnp.where(is_table, iota, _NEG1))
    rs = jax.lax.cummax(jnp.where(~prev_same, iota, jnp.int32(0)))
    match = (~is_table) & (lt >= rs)

    sid_q, gc_q = _payload_from_cummax(words_s, pb, gc_bits, payload_bits,
                                       n_words)
    # query rows read their own restore position back from word 0
    val_q = words_s[0]

    # within-read duplicate: predecessor is a same-key query from the same
    # read (stable sort keeps same-key queries in read/window order)
    prev_is_query = jnp.concatenate([
        jnp.zeros(1, dtype=bool), ~is_table[:-1]])
    same_read = jnp.concatenate([
        jnp.zeros(1, dtype=bool),
        (val_q[1:] // jnp.int32(w)) == (val_q[:-1] // jnp.int32(w)),
    ])
    dup = match & prev_same & prev_is_query & same_read
    first_occ_s = match & ~dup

    flags = (match.astype(jnp.int32)
             | (first_occ_s.astype(jnp.int32) << 1))
    # pads restore last like real table rows (tag_table, not is_table:
    # their carry word is -1, which must never win a restore-key slot)
    return _restore(tag_table, val_q, sid_q, gc_q, flags, n, b, w,
                    num_sets, gc_bits)


def probe_dedupe_sorted_words(
    tab: SortedTableDevW,
    qws: Tuple[jnp.ndarray, ...],  # query key words, msb first, each [B, W]
    query_ok: jnp.ndarray,         # bool [B, W] windows passing validity+MKQ
    *,
    num_sets: int,
    max_genome_count: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Multi-word-key form of ``probe_dedupe_sorted`` (any k).

    Same contract: probe + within-read first-occurrence dedupe in one
    sorted join, returning (hit, set_id, genome_count, first_occ) [B, W].

    Instead of folding a tag bit into the key (which needs a free bit the
    multi-word key may not have, e.g. 2k == 32*nw), rows carry a separate
    uint32 tag sort word AFTER the key words:

      0 = real table row,  1 = ok query,  2 = gated query,  3 = table pad

    Runs are equal-key groups irrespective of tag; within a run the tag
    orders real table rows first, then ok queries (stable: original read/
    window order), then gated queries and pads -- so the ok-query dup
    chain is contiguous, gated windows never match or claim first_occ,
    and a pad row can never shadow a real entry even when its all-ones
    key equals a real poly-T k-mer (possible when 2k == 32*nw).
    """
    b, w = qws[0].shape
    n = b * w
    nw = len(qws)
    u = int(tab.kws[0].shape[0])
    if u == 0:
        neg = jnp.full((b, w), -1, dtype=jnp.int32)
        zero = jnp.zeros((b, w), dtype=jnp.int32)
        false = jnp.zeros((b, w), dtype=bool)
        return false, neg, zero, false
    m = u + n

    pb, gc_bits, payload_bits, n_words, gc_cap = _carry_layout(
        u, n, num_sets, max_genome_count)

    # ---- sort operands: nw key words + tag word, then carry words ----
    ok = query_ok.reshape(-1)
    is_pad = tab.gc <= 0
    keys = [
        jnp.concatenate([tw, qw.reshape(-1)]) for tw, qw in zip(tab.kws, qws)
    ]
    tag = jnp.concatenate([
        jnp.where(is_pad, jnp.uint32(3), jnp.uint32(0)),
        jnp.where(ok, jnp.uint32(1), jnp.uint32(2)),
    ])
    rank = jnp.arange(u, dtype=jnp.uint32)
    words = _carry_words(tab.sid, tab.gc, rank, n, pb, gc_bits, n_words,
                         gc_cap, table_live=~is_pad)

    ops = jax.lax.sort(
        (*keys, tag, *words), num_keys=nw + 1, is_stable=True)
    keys_s = ops[:nw]
    tag_s = ops[nw]
    words_s = ops[nw + 1:]

    # ---- sorted-domain logic ----
    iota = jnp.arange(m, dtype=jnp.int32)
    is_table = tag_s == jnp.uint32(0)
    is_okq = tag_s == jnp.uint32(1)
    prev_same = jnp.ones(m - 1, dtype=bool)
    for ks in keys_s:
        prev_same = prev_same & (ks[1:] == ks[:-1])
    prev_same = jnp.concatenate([jnp.zeros(1, dtype=bool), prev_same])
    lt = jax.lax.cummax(jnp.where(is_table, iota, _NEG1))
    rs = jax.lax.cummax(jnp.where(~prev_same, iota, jnp.int32(0)))
    match = is_okq & (lt >= rs)

    sid_q, gc_q = _payload_from_cummax(words_s, pb, gc_bits, payload_bits,
                                       n_words)
    # non-table rows (ok + gated queries, pads) read back their carry
    # word; for queries that is their val.  Pads carry -1 but are
    # is_table=False... they must not confuse same_read: a pad's val
    # reads -1 -> -1 // w == -1, never equal to a real read id except
    # another pad; pads are never match/first_occ so flags stay 0 and
    # their restore key is forced to n below via is_restore_last.
    val_q = words_s[0]
    is_restore_last = is_table | (tag_s == jnp.uint32(3))

    # within-read duplicate: predecessor is a same-key OK query from the
    # same read (ok queries are tag-contiguous and stable-ordered)
    prev_is_okq = jnp.concatenate([jnp.zeros(1, dtype=bool), is_okq[:-1]])
    same_read = jnp.concatenate([
        jnp.zeros(1, dtype=bool),
        (val_q[1:] // jnp.int32(w)) == (val_q[:-1] // jnp.int32(w)),
    ])
    dup = match & prev_same & prev_is_okq & same_read
    first_occ_s = match & ~dup

    flags = (match.astype(jnp.int32)
             | (first_occ_s.astype(jnp.int32) << 1))
    return _restore(is_restore_last, val_q, sid_q, gc_q, flags, n, b, w,
                    num_sets, gc_bits)
