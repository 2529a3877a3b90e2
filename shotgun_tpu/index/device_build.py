"""Device-side k-mer index build v2: the accelerator replaces the host
build loop.

The reference builds its DB with a Python dict scan (reference
kmer.py:135-150), and the native C++ builder is a memory-bound radix
whose rate falls as the collection grows.  This module builds the
ALIGN-relevant index -- the sorted probe table (keys, set ids, genome
counts) and the genome-set member table -- entirely on the device, for
ANY record count up to
``R_CAP`` and any k <= 31.  The big arrays stay device-resident and feed
``ops.probe_sort2`` directly; only two scalar words and a bounded
(set, record) pair list come back to the host.

Design (one upload, one fused dispatch, one fetch):

  1. windows: rolling 2-bit encode over the concatenated genome codes;
     windows containing an N or crossing a record boundary get an
     all-ones sentinel key (unreachable by real 62-bit keys).
  2. ONE 3-key sort of (key_hi, key_lo, record): duplicate k-mers group
     together with records ascending inside each group.  The table KEEPS
     duplicate key rows -- the sort-merge probe's cummax join reads the
     last table row of a run, and duplicates carry identical payload, so
     no compaction pass is needed (the padded table length is the shape
     bucket either way).
  3. per-group genome counts from three NATIVE cumulative ops (no
     doubling scan): cs = cumsum(distinct-pair flag) is nondecreasing,
     so cummax of its group-start values and reverse-cummin of its
     group-end values broadcast both boundaries to every row.
  4. set ids: a k-mer hitting ONE record (the overwhelmingly common
     case) gets sid = record directly -- the first R member-table rows
     are the singleton sets, known without any dedupe.  Only groups with
     gc > 1 enter the multi-set machinery, and the whole of it runs
     under ``lax.cond``: corpora with no shared k-mers skip those sorts
     at run time entirely.
  5. multi sets dedupe by a 64-bit segmented-sum hash (gc mixed in),
     assigned via one dedupe sort + one restore sort + a 1-word reverse
     segmented broadcast.  Hash collisions cannot corrupt output: the
     distinct (sid, record) pairs of ALL multi groups are extracted
     (two 1-key sorts) and fetched, and the host verifies that every
     multi sid's pair count equals its groups' genome count -- two
     DIFFERENT sets merged by a colliding hash have a strictly larger
     union, so the check is exact; on failure the caller falls back to
     the bit-identical host builder.

Limits: k <= 31 (two-word keys), R <= R_CAP records, <= SMAX multi
sets, <= PMAX multi (set, record) pairs.  Anything else returns None and
falls back to the host builder.  Correctness is pinned by equality tests
against the host index (tests/test_device_build.py).
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np

from shotgun_tpu.utils.platform import configure_platform

configure_platform()

import jax
import jax.numpy as jnp

_ONES = np.uint32(0xFFFFFFFF)
_BIG = np.int32(0x7FFFFFFF)

#: record-count cap: sid/record pairs pack as sid * R_CAP + rec in int32
R_CAP = 4096
#: cap on DISTINCT multi-record genome-sets (sets of >= 2 records)
SMAX = 4096
#: cap on fetched multi (set, record) pairs (the union of all multi sets)
PMAX = 1 << 17
#: pair-fetch head size: the common fetch ships only this many pairs
#: (most corpora have few multi sets); the full [PMAX] tail is fetched
#: in a second transfer only when n_pairs exceeds it
PHEAD = 4096
#: cap on uploaded N-run (start, end) pairs; draft genomes carry
#: thousands of assembly-gap runs, so the cap is generous -- past it the
#: caller falls back to the host builder
NRUNS_CAP = 1 << 16


def _mix32(x):
    """splitmix32-style avalanche over uint32 (device)."""
    x = x.astype(jnp.uint32)
    x = (x ^ (x >> jnp.uint32(16))) * jnp.uint32(0x7FEB352D)
    x = (x ^ (x >> jnp.uint32(15))) * jnp.uint32(0x846CA68B)
    return x ^ (x >> jnp.uint32(16))


def _segmented_sum_scan(new, vals):
    """Inclusive segmented SUM scan (segments start where ``new`` is
    True): flag-carrying Hillis-Steele doubling, O(log n) constant-HLO
    steps (jax.lax.associative_scan's compile time grows with array
    size; this form compiles flat)."""
    n = int(new.shape[0])
    flag = new
    vals = tuple(vals)
    d = 1
    while d < n:
        def sh(x, fill):
            return jnp.concatenate([jnp.full(d, fill, x.dtype), x[:-d]])
        shifted = tuple(sh(v, 0) for v in vals)
        vals = tuple(
            jnp.where(flag, v, v + sv) for v, sv in zip(vals, shifted))
        flag = flag | sh(flag, True)
        d *= 2
    return vals


def _reverse_segmented_or_bcast(last, val):
    """Broadcast ``val`` (nonzero only at segment-LAST rows) to every row
    of its segment, flowing right-to-left; segments end at ``last``."""
    n = int(val.shape[0])
    flag = last
    d = 1
    while d < n:
        def sh_r(x, fill):
            return jnp.concatenate([x[d:], jnp.full(d, fill, x.dtype)])
        val = jnp.where(flag, val, val | sh_r(val, 0))
        flag = flag | sh_r(flag, True)
        d *= 2
    return val


@functools.partial(jax.jit, static_argnames=("k", "gp"))
def _build_tables_v2(buf, r_num, *, k: int, gp: int):
    """Single-dispatch general build.  ``buf`` is the combined upload:
    [gp/4] 2-bit packed codes ++ [NRUNS_CAP*2] int32 N-run (start, end)
    pairs ++ [(R_CAP+1)] int32 record-start offsets, all little-endian
    bytes in ONE host->device transfer.  N/pad positions pack as code 0 and
    are invalidated here by rebuilding the bad plane from +1/-1 run
    deltas (0.25 B/base upload; the r5a dense bitmask was 0.375).
    ``r_num`` is the record count as a TRACED int32 scalar, so differing
    record counts share one executable."""
    nc = gp // 4
    codes2 = buf[:nc]

    def i32s(lo, n):
        b4 = buf[lo: lo + 4 * n].astype(jnp.int32)
        return (b4[0::4] | (b4[1::4] << 8) | (b4[2::4] << 16)
                | (b4[3::4] << 24))

    run_s = i32s(nc, NRUNS_CAP)
    run_e = i32s(nc + 4 * NRUNS_CAP, NRUNS_CAP)
    offsets = i32s(nc + 8 * NRUNS_CAP, R_CAP + 1)

    # ---- unpack + window encode ----
    u8 = codes2.astype(jnp.uint32)[:, None]
    shifts = jnp.arange(4, dtype=jnp.uint32)[None, :] * jnp.uint32(2)
    c32 = ((u8 >> shifts) & jnp.uint32(3)).reshape(gp)
    # bad plane from sparse run deltas: +1 at starts, -1 at ends (length
    # gp + 1 so an end at gp cannot clip onto a real position); unused
    # run slots are (0, 0) pairs whose deltas cancel
    delta = (jnp.zeros(gp + 1, jnp.int32)
             .at[run_s].add(1).at[run_e].add(-1))
    bad = (jnp.cumsum(delta[:gp]) > 0).astype(jnp.int32)
    rec_start = jnp.zeros(gp, jnp.int32).at[offsets].set(1)

    w = gp - k + 1
    lo = jnp.zeros(w, dtype=jnp.uint32)
    hi = jnp.zeros(w, dtype=jnp.uint32)
    for j in range(k):
        c = c32[j: j + w]
        hi = (hi << jnp.uint32(2)) | (lo >> jnp.uint32(30))
        lo = (lo << jnp.uint32(2)) | c
    cs_bad = jnp.cumsum(bad)
    bad_in = cs_bad[k - 1:] - jnp.concatenate(
        [jnp.zeros(1, jnp.int32), cs_bad[: w - 1]])
    cs_rs = jnp.cumsum(rec_start)
    starts_in = cs_rs[k - 1:] - cs_rs[: w]
    valid = (bad_in == 0) & (starts_in == 0)
    rec_of_win = (cs_rs[: w] - 1).astype(jnp.uint32)

    skh = jnp.where(valid, hi, jnp.uint32(_ONES))
    skl = jnp.where(valid, lo, jnp.uint32(_ONES))

    # ---- SORT1: (key, record); records ascend within each key group ----
    skh, skl, rec_s = jax.lax.sort((skh, skl, rec_of_win), num_keys=3,
                                   is_stable=False)
    rec_i = rec_s.astype(jnp.int32)

    live = (skh >> jnp.uint32(31)) == 0
    same_key = (skh[1:] == skh[:-1]) & (skl[1:] == skl[:-1])
    new_key = live & jnp.concatenate(
        [jnp.ones(1, dtype=bool), ~same_key])
    is_last = live & jnp.concatenate([~same_key, jnp.ones(1, dtype=bool)])
    d = live & (new_key | jnp.concatenate(
        [jnp.ones(1, dtype=bool), rec_s[1:] != rec_s[:-1]]))
    num_kmers = jnp.sum(new_key.astype(jnp.int32))

    # ---- per-group genome count via native cumulative ops ----
    cs = jnp.cumsum(d.astype(jnp.int32))
    csb = jax.lax.cummax(jnp.where(new_key, cs - d, jnp.int32(-1)))
    cse = jax.lax.cummin(jnp.where(is_last, cs, _BIG), reverse=True)
    gc_all = jnp.where(live, cse - csb, 0)
    single = gc_all == 1

    n_multi_groups = jnp.sum((new_key & ~single).astype(jnp.int32))
    iota = jnp.arange(w, dtype=jnp.int32)

    def multi_branch(_):
        md = d & ~single
        h1c = jnp.where(md, _mix32(rec_s + jnp.uint32(0x9E3779B9)),
                        jnp.uint32(0))
        h2c = jnp.where(md, _mix32(rec_s ^ jnp.uint32(0x85EBCA6B)),
                        jnp.uint32(0))
        h1, h2 = _segmented_sum_scan(new_key, (h1c, h2c))
        # fold gc into the hash so merged groups always agree on gc
        gcm = _mix32(gc_all.astype(jnp.uint32) + jnp.uint32(0xC2B2AE35))
        h1 = h1 ^ gcm
        h2 = h2 + gcm
        m_last = is_last & ~single
        # dedupe sort: real rows carry h1 >> 1 (top bit clear), others
        # all-ones -- a real hash can never collide with the filler key
        k1 = jnp.where(m_last, h1 >> jnp.uint32(1), jnp.uint32(_ONES))
        k2 = jnp.where(m_last, h2, jnp.uint32(_ONES))
        k1s, k2s, iota_s = jax.lax.sort((k1, k2, iota), num_keys=2,
                                        is_stable=False)
        real = (k1s >> jnp.uint32(31)) == 0
        prev_same_h = jnp.concatenate([
            jnp.zeros(1, dtype=bool),
            (k1s[1:] == k1s[:-1]) & (k2s[1:] == k2s[:-1])])
        new_set = real & ~prev_same_h
        midx_sorted = jnp.cumsum(new_set.astype(jnp.int32)) - 1
        n_multi = jnp.sum(new_set.astype(jnp.int32))
        # restore to key order: payload midx+1 at real rows, 0 elsewhere
        pay = jnp.where(real, midx_sorted + 1, 0)
        _, pay_r = jax.lax.sort((iota_s, pay), num_keys=1,
                                is_stable=False)
        midx_b = _reverse_segmented_or_bcast(is_last, pay_r) - 1
        # distinct (multi set, record) pairs of ALL multi groups
        pairkey = jnp.where(
            md, midx_b * jnp.int32(R_CAP) + rec_i, _BIG)
        pk_s, gc_s = jax.lax.sort((pairkey, gc_all), num_keys=1,
                                  is_stable=False)
        uniq = (pk_s < _BIG) & jnp.concatenate([
            jnp.ones(1, dtype=bool), pk_s[1:] != pk_s[:-1]])
        n_pairs = jnp.sum(uniq.astype(jnp.int32))
        pk_u, gc_u = jax.lax.sort(
            (jnp.where(uniq, pk_s, _BIG), gc_s), num_keys=1,
            is_stable=False)

        def fit(x, size, fill):  # [w] -> [size] regardless of w
            if w >= size:
                return x[:size]
            return jnp.concatenate(
                [x, jnp.full(size - w, fill, x.dtype)])
        return (midx_b, n_multi, n_pairs,
                fit(pk_u, PHEAD, _BIG), fit(gc_u, PHEAD, 0),
                fit(pk_u, PMAX, _BIG), fit(gc_u, PMAX, 0))

    def no_multi_branch(_):
        return (jnp.full(w, -1, jnp.int32), jnp.int32(0), jnp.int32(0),
                jnp.full(PHEAD, _BIG, jnp.int32),
                jnp.zeros(PHEAD, jnp.int32),
                jnp.full(PMAX, _BIG, jnp.int32),
                jnp.zeros(PMAX, jnp.int32))

    (midx_b, n_multi, n_pairs, pairs_h, pair_gc_h,
     pairs_f, pair_gc_f) = jax.lax.cond(
        n_multi_groups > 0, multi_branch, no_multi_branch, operand=None)

    # set ids: singleton sets ARE their record id (member rows [0, R));
    # multi sets append after them ([R, R + n_multi)).  ``r_num`` is
    # traced, so varying record counts never recompile.
    sid_all = jnp.where(live & single, rec_i,
                        jnp.where(live, r_num + midx_b, 0))
    gc_col = jnp.where(live, gc_all, 0)

    pad = gp - w  # k - 1 rows: table length == the gp shape bucket
    klo = jnp.concatenate([skl, jnp.full(pad, _ONES, jnp.uint32)])
    khi = jnp.concatenate([skh, jnp.full(pad, _ONES, jnp.uint32)])
    sid_col = jnp.concatenate([sid_all, jnp.zeros(pad, jnp.int32)])
    gc_col = jnp.concatenate([gc_col, jnp.zeros(pad, jnp.int32)])

    return (klo, khi, sid_col, gc_col, num_kmers, n_multi, n_pairs,
            pairs_h, pair_gc_h, pairs_f, pair_gc_f)


def _host_prep(genomes, k: int, pad_rows):
    """2-bit pack + sparse N-run list + offsets, combined into ONE upload
    buffer (one host->device transfer instead of three).
    The pack runs in the native lib (one pass, 2 threads) with a numpy
    fallback.  Returns (buf, gp) or None when the corpus has more than
    NRUNS_CAP N runs (caller falls back to the host builder)."""
    from shotgun_tpu.io import native as _native

    g = int(genomes.codes.size)
    gp = pad_rows(g + max(k - 1, 1), lo=4096)
    nc = gp // 4
    buf = np.empty(nc + 8 * NRUNS_CAP + (R_CAP + 1) * 4, dtype=np.uint8)
    codes2 = buf[:nc]
    runs = np.zeros(2 * NRUNS_CAP, dtype=np.int32)  # interleaved (s, e)
    # one N-run slot is reserved for the pad region below
    n_runs = _native.pack2(genomes.codes, gp, codes2,
                           runs[: 2 * (NRUNS_CAP - 1)])
    if n_runs is None:
        # numpy fallback: pack + run extraction via boolean diffs
        codes = np.empty(gp, dtype=np.uint8)
        codes[:g] = genomes.codes
        codes[g:] = 0
        cq = codes.reshape(-1, 4)
        codes2[:] = (cq[:, 0] & 3) | ((cq[:, 1] & 3) << 2) \
            | ((cq[:, 2] & 3) << 4) | ((cq[:, 3] & 3) << 6)
        bad = codes >= 4
        bad[g:] = False
        edges = np.flatnonzero(np.diff(
            np.concatenate([[False], bad, [False]]).astype(np.int8)))
        n_runs = edges.size // 2
        if n_runs > NRUNS_CAP - 1:
            return None
        runs[: edges.size] = edges
    elif n_runs < 0:
        return None
    # pad region acts like one N run (g, gp)
    runs[2 * n_runs] = g
    runs[2 * n_runs + 1] = gp
    rr = runs.reshape(-1, 2)
    buf[nc: nc + 4 * NRUNS_CAP] = np.ascontiguousarray(
        rr[:, 0]).astype("<i4").view(np.uint8)
    buf[nc + 4 * NRUNS_CAP: nc + 8 * NRUNS_CAP] = np.ascontiguousarray(
        rr[:, 1]).astype("<i4").view(np.uint8)
    offsets = np.full(R_CAP + 1, g, dtype=np.int32)
    offsets[: genomes.num_records] = genomes.offsets[:-1]
    buf[nc + 8 * NRUNS_CAP:] = offsets.astype("<i4").view(np.uint8)
    return buf, gp


def device_build_tables(genomes, k: int, pad_rows) -> Optional[dict]:
    """Build the padded sorted probe table + set member table on device.

    ``genomes``: io.packing.GenomeArrays; ``pad_rows``: the shape-bucket
    function (reference.KmerReference._pad_rows).  Returns a dict with
    device arrays {klo, khi, sid, gc} (table length == the gp shape
    bucket), host ``set_masks`` (uint8 [num_sets, ceil(R/8)]: rows
    [0, R) are the singleton sets {r}, rows [R, R + n_multi) the multi
    sets), and ints num_kmers/num_sets -- or None
    when unsupported (k > 31, R > R_CAP, genomes shorter than k, more
    than SMAX multi sets, more than PMAX multi pairs, or a detected hash
    collision -- callers fall back to the bit-identical host builder).
    """
    if k > 31 or genomes.num_records > R_CAP or genomes.codes.size < k:
        return None
    r = genomes.num_records
    t0 = time.perf_counter()
    prep = _host_prep(genomes, k, pad_rows)
    if prep is None:
        return None  # > NRUNS_CAP N runs: host builder handles it
    buf, gp = prep
    prep_s = time.perf_counter() - t0

    (klo, khi, sid, gc, num_kmers_d, n_multi_d, n_pairs_d,
     pairs_hd, pair_gc_hd, pairs_fd, pair_gc_fd) = _build_tables_v2(
        jnp.asarray(buf), jnp.int32(r), k=k, gp=gp)
    # ONE fetch: scalars + the pair-list head together; the full pair
    # tail costs a second fetch only for multi-set-heavy corpora
    u, n_multi, n_pairs, pairs, pair_gc = jax.device_get(
        (num_kmers_d, n_multi_d, n_pairs_d, pairs_hd, pair_gc_hd))
    u, n_multi, n_pairs = int(u), int(n_multi), int(n_pairs)
    if n_multi > SMAX or n_pairs > PMAX:
        return None
    if n_pairs > PHEAD:
        pairs, pair_gc = jax.device_get((pairs_fd, pair_gc_fd))

    gbytes = max((r + 7) // 8, 1)
    num_sets = r + n_multi
    set_masks = np.zeros((num_sets, gbytes), dtype=np.uint8)
    rr = np.arange(r)
    set_masks[rr, rr >> 3] = np.uint8(1) << (rr & 7).astype(np.uint8)
    if n_pairs:
        pk = pairs[:n_pairs].astype(np.int64)
        pgc = pair_gc[:n_pairs].astype(np.int64)
        sidx = pk // R_CAP          # multi set index j in [0, n_multi)
        recx = pk % R_CAP
        # EXACT collision check: within each multi sid, the union size
        # (distinct pair count) must equal every member group's gc; two
        # different sets merged by a hash collision have a larger union
        counts = np.bincount(sidx, minlength=n_multi)
        if (counts[sidx] != pgc).any() or (recx >= r).any():
            return None  # collision (astronomically rare): host rebuild
        np.bitwise_or.at(
            set_masks, (r + sidx, recx >> 3),
            np.uint8(1) << (recx & 7).astype(np.uint8))
    return dict(
        klo=klo, khi=khi, sid=sid, gc=gc,
        num_kmers=u, num_sets=num_sets, set_masks=set_masks,
        num_records=r, prep_s=prep_s,
    )


#: hash-table sizing for the device hash build (matches the host
#: builder's 16-slot wide-bucket layout for big tables: 64 B/key)
HASH_SLOTS = 16
HASH_LAMBDA = 4.0
STASH_PAD = 64


@functools.partial(jax.jit, static_argnames=("nb",))
def _hash_table_from_rows(klo, khi, sid, gc, *, nb: int):
    """Bucketized single-gather hash table (index/hashtable.py layout)
    from the v2 sorted table rows, entirely on device.

    Distinct keys (first row of each duplicate run) hash to their
    primary bucket; rank-within-bucket comes from one 1-key sort plus a
    cummax, and the [nb, SLOTS, 4] table materializes with a single
    ``mode="drop"`` scatter (dup/pad/overflow rows simply drop).
    Overflow keys land in a STASH_PAD-row stash via a second tiny
    ordinal scatter; if the stash overflows the caller doubles ``nb``.
    Replaces the host ``build_probe_table`` for device-built references
    above the auto hash threshold, where the sort-join probe's
    per-batch table re-sort dominates align time."""
    from shotgun_tpu.ops.encode import mix32

    n = klo.shape[0]
    live = gc > 0
    new = live & jnp.concatenate([
        jnp.ones(1, dtype=bool),
        (klo[1:] != klo[:-1]) | (khi[1:] != khi[:-1])])
    bucket = jnp.where(
        new, (mix32(klo, khi, jnp) & jnp.uint32(nb - 1)).astype(jnp.int32),
        jnp.int32(nb))
    bs, klo2, khi2, sid2, gc2 = jax.lax.sort(
        (bucket, klo, khi, sid, gc), num_keys=1, is_stable=False)
    iota = jnp.arange(n, dtype=jnp.int32)
    newb = jnp.concatenate([jnp.ones(1, dtype=bool), bs[1:] != bs[:-1]])
    start = jax.lax.cummax(jnp.where(newb, iota, jnp.int32(-1)))
    rank = iota - start
    real = bs < jnp.int32(nb)
    placed = real & (rank < HASH_SLOTS)
    cols = (klo2, khi2, sid2.astype(jnp.uint32), gc2.astype(jnp.uint32))
    # init: every slot's sid word carries the EMPTY marker -- built by
    # broadcasting a 4-word pattern (an iota-indexed scatter here cost a
    # 2 GB index plane + an extra 8 GB copy at 100M keys).  Columns
    # scatter one at a time with 3-D (bucket, slot, word) indices: a
    # flattened index space overflows int32 past 2^31 table words.
    pat = jnp.asarray([0, 0, int(_ONES), 0], jnp.uint32)
    table = jnp.broadcast_to(
        pat[None, None, :], (nb, HASH_SLOTS, 4)).reshape(
            nb, HASH_SLOTS, 4)
    tb = jnp.where(placed, bs, jnp.int32(nb))  # nb -> dropped
    ts = jnp.where(placed, rank, jnp.int32(0))
    for c, col in enumerate(cols):
        table = table.at[tb, ts, c].set(col, mode="drop")
    # stash: overflow keys by global ordinal (collisions past the cap
    # clip onto the last row, but then n_stash > STASH_PAD and the
    # caller rebuilds wider anyway)
    over = real & (rank >= HASH_SLOTS)
    n_stash = jnp.sum(over.astype(jnp.int32))
    ordn = jnp.cumsum(over.astype(jnp.int32)) - 1
    stash = jnp.full((STASH_PAD, 4), _ONES, jnp.uint32)
    srow = jnp.where(over, jnp.minimum(ordn, STASH_PAD - 1),
                     jnp.int32(STASH_PAD))
    for c, col in enumerate(cols):
        stash = stash.at[srow, c].set(col, mode="drop")
    return table, stash, n_stash


#: device bytes one align batch needs beside the resident tables: the
#: largest auto batch (32768 reads padded to 160 bases, 130 windows each)
#: touches 32768 * 130 bucket rows of HASH_SLOTS * 16 B (1.1 GB) plus its
#: per-window masks and the set-count one-hots; 4 GiB covers them
ALIGN_BATCH_MARGIN = 4 << 30
#: peak device bytes per padded genome position of ``_build_tables_v2``
#: (sort operands, their sorted copies and the per-row scans)
BUILD_BYTES_PER_ROW = 128


def budget_from_stats(stats: Optional[dict]) -> Optional[int]:
    """Device bytes a new table may take, from ``Device.memory_stats()``:
    the allocator's limit minus what is in use minus one align batch's
    working set (``ALIGN_BATCH_MARGIN``).  None where the backend reports
    no ``bytes_limit`` (the CPU backend): no budget applies there."""
    if not stats or "bytes_limit" not in stats:
        return None
    return (int(stats["bytes_limit"]) - int(stats.get("bytes_in_use", 0))
            - ALIGN_BATCH_MARGIN)


def device_memory_budget() -> Optional[int]:
    """``budget_from_stats`` of the first device, as it is now."""
    return budget_from_stats(jax.devices()[0].memory_stats())


def _hash_buckets(num_keys: int) -> int:
    return 1 << max(int(max(num_keys / HASH_LAMBDA, 1)) - 1, 1).bit_length()


def _hash_bytes(nb: int, n_rows: int) -> int:
    """Device bytes of a hash assembly: the table plus the scatter's
    sort workspace over the ``n_rows`` sorted-table rows."""
    return nb * HASH_SLOTS * 16 + 8 * n_rows * 4


def device_build_bytes(n_bases: int, pad_rows) -> int:
    """Peak device bytes of a device build over ``n_bases`` genome bases
    followed by the hash assembly the auto probe may run on it (at most
    one distinct key per base; the 16 B/row sorted table stays resident
    under the assembly)."""
    gp = pad_rows(n_bases)
    return max(gp * BUILD_BYTES_PER_ROW,
               16 * gp + _hash_bytes(_hash_buckets(n_bases), gp))


def device_hash_table(built: dict):
    """Build the 16-slot device hash table from ``device_build_tables``
    output; returns (table, stash) device arrays, or None when the table
    does not fit the device-memory budget or the stash cannot be
    satisfied (pathological key sets)."""
    nb = _hash_buckets(built["num_kmers"])
    n = int(built["klo"].shape[0])
    budget = device_memory_budget()
    try:
        for _ in range(3):
            # re-checked on every stash-overflow doubling: a retry at 2-4x
            # the vetted nb must fit the budget too
            if budget is not None and _hash_bytes(nb, n) > budget:
                return None
            table, stash, n_stash_d = _hash_table_from_rows(
                built["klo"], built["khi"], built["sid"], built["gc"],
                nb=nb)
            if int(jax.device_get(n_stash_d)) <= STASH_PAD:
                return table, stash
            nb *= 2
    except jax.errors.JaxRuntimeError as exc:
        # out of device memory despite the budget (other live arrays):
        # the sorted table still serves.  Anything else is a fault.
        if "RESOURCE_EXHAUSTED" not in str(exc):
            raise
        return None
    return None
