"""The flagship device pipeline: batched pseudo-alignment in one dispatch.

Per batch of packed reads, entirely on device:

  1. rolling 2-bit k-mer encode                    (ops/encode.py)
  2. probe: sort-merge join (ops/probe_sort2.py) or bucketized hash
     table (ops/probe.py), chosen by table size
  3. integer quality gates: MRQ read gate, MKQ window gate
     (raw-``ord`` means as exact integer comparisons;
      reference kmer.py:394-408,419-421)
  4. max-genomes gate                              (reference kmer.py:425-427)
  5. first-occurrence dedupe of k-mer values within a read
     (duplicate k-mers collapse; reference kmer.py:429)
  6. per-record specific/total distinct-k-mer counts + first-window keys
     (reconstructing the reference's dict-insertion orders)
  7. the m/p decision procedure with the reference's exact tie-breaking
     and downgrade quirks                          (reference kmer.py:444-480)

Shapes are static per (B, L, R, S) configuration; scalar thresholds are
traced so changing m/p/quality values never recompiles.

``aggregate_batch`` folds per-read results into per-record counters and
first-encounter order keys on device, so the dumpalign path ships only
O(R) data back to the host per batch.  Under a sharded ``jit`` the
reductions become XLA collectives over the data axis.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from shotgun_tpu.utils.platform import configure_platform

configure_platform()

from shotgun_tpu.ops.encode import (
    rolling_encode_jnp,
    rolling_encode_words_jnp,
    unpack_codes_2bit,
    window_quality_sums,
)
from shotgun_tpu.ops.probe import probe_kmers
from shotgun_tpu.ops.probe_sort import (
    SortedTableDev,
    SortedTableDevW,
)

import numpy as _np

BIG = _np.int32(0x3FFFFFFF)


def _count_product(subscripts: str, x: jnp.ndarray,
                   y: jnp.ndarray) -> jnp.ndarray:
    """Matrix product of integer counts carried in float32, exact.

    HIGHEST precision: at the default precision a GPU may run float32
    products in TF32, whose 11-bit significand rounds counts above 2048
    (a read longer than about 2.1 kbp can have that many windows in one
    genome-set), and a rounded count can flip the m/p decision.  Full
    float32 is exact below 2^24."""
    return jnp.einsum(subscripts, x, y, precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)


# ReadMappingType codes (device-side): reference kmer.py:41-47
UNMAPPED, UNIQUELY_MAPPED, AMBIGUOUSLY_MAPPED = 0, 1, 2


class BatchResult(NamedTuple):
    """Per-read device outputs for one batch."""

    mtype: jnp.ndarray          # int32 [B] 0/1/2
    winner: jnp.ndarray         # int32 [B] record id (unique/downgraded rows)
    downgraded: jnp.ndarray     # bool  [B]
    amb_mask: jnp.ndarray       # bool  [B, R] members of the ambiguous list
    fw_sel: jnp.ndarray         # int32 [B, R] first-window order key
    read_filtered: jnp.ndarray  # bool  [B] MRQ-filtered (not added at all)
    n_qual_kmers: jnp.ndarray   # int32 [B] per-occurrence MKQ filter count
    n_hr_kmers: jnp.ndarray     # int32 [B] per-occurrence max-genomes count


#: per-chunk set width for the one-hot count reduction; sets are processed
#: in chunks of this many so the [B, SET_CHUNK, W] one-hot stays small
SET_CHUNK = 64
#: up to this many chunks the reduction is unrolled (XLA fuses the whole
#: thing); past it a lax.scan keeps program size O(1) in S, so set tables
#: with tens of thousands of distinct genome-sets compile and run
SET_UNROLL_CHUNKS = 16


def core_from_probe(
    probe_res: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray],
    set_member: jnp.ndarray,  # uint8  [S, R]
    qual: jnp.ndarray,        # uint8  [B, L]
    lengths: jnp.ndarray,     # int32  [B]
    m: jnp.ndarray,           # int32 scalar
    p: jnp.ndarray,           # int32 scalar
    mrq: jnp.ndarray,         # int32 scalar (ignored unless has_mrq)
    mkq: jnp.ndarray,         # int32 scalar
    mg: jnp.ndarray,          # int32 scalar
    *,
    k: int,
    has_mrq: bool,
    has_mkq: bool,
    has_mg: bool,
    pre_first_occ: jnp.ndarray = None,
) -> BatchResult:
    """Everything after the probe: gates, dedupe, counts, m/p decision.

    Contains no large gathers (see module docstring); safe to trace into
    any jit, including shard_map bodies.

    ``pre_first_occ``: within-read first-occurrence mask already computed
    by the probe (ops/probe_sort2.py does it in the sorted domain).  When
    given, ``probe_res``'s slot_pos may be None and the dedupe block is
    skipped; the max-genomes gate still masks whole keys (redundancy is
    uniform per key, so masking first_occ by ~redundant is exact).
    """
    hit, sid, gcount, slot_pos = probe_res
    b, w = hit.shape
    r = set_member.shape[1]
    w_iota = jax.lax.broadcasted_iota(jnp.int32, (b, w), 1)
    r_iota = jax.lax.broadcasted_iota(jnp.int32, (b, r), 1)

    # touch every scalar arg so no jit signature ever has pruned params
    # (a zero-anchor keeps all scalars live at zero cost)
    anchor = (m + p + mrq + mkq + mg) * jnp.int32(0)
    lens = lengths.astype(jnp.int32) + anchor
    valid = w_iota < (lens - jnp.int32(k - 1))[:, None]

    # ---- quality gates (exact integer forms of raw-ord means) ----
    if has_mrq:
        total_q = jnp.sum(qual.astype(jnp.int32), axis=1)  # pads are 0
        read_filtered = total_q < mrq * lens
    else:
        read_filtered = jnp.zeros((b,), dtype=bool)

    if has_mkq:
        qsum = window_quality_sums(qual, k)
        kq_fail = valid & (qsum < mkq * jnp.int32(k))
        kq_ok = valid & ~kq_fail
        n_qual_kmers = jnp.sum(kq_fail, axis=1, dtype=jnp.int32)
    else:
        kq_ok = valid
        n_qual_kmers = jnp.zeros((b,), dtype=jnp.int32)

    # ---- max-genomes gate (reference kmer.py:425-427) ----
    hit = hit & kq_ok
    if has_mg:
        redundant = hit & (gcount > mg)
        n_hr_kmers = jnp.sum(redundant, axis=1, dtype=jnp.int32)
        stored = hit & ~redundant
    else:
        n_hr_kmers = jnp.zeros((b,), dtype=jnp.int32)
        stored = hit

    # ---- first-occurrence dedupe of equal k-mer values in a read ----
    if pre_first_occ is not None:
        first_occ = pre_first_occ & stored
    else:
        # equal k-mer values share a unique table slot, so one int32
        # compare suffices (misses are -1 but carry stored=False)
        eq = slot_pos[:, :, None] == slot_pos[:, None, :]
        prev = (
            jax.lax.broadcasted_iota(jnp.int32, (w, w), 1)
            < jax.lax.broadcasted_iota(jnp.int32, (w, w), 0)
        )  # prev[w, w'] == w' < w
        dup = jnp.any(eq & stored[:, None, :] & prev[None], axis=2)
        first_occ = stored & ~dup

    # ---- per-record counts + first-window keys ----
    # reduce over W in set space (one-hot), then project into record
    # space with a matrix product -- no per-window gather.  Sets are
    # processed in SET_CHUNK-wide chunks so the [B, chunk, W] one-hot
    # stays small; W stays the minor dimension.  Small tables unroll the
    # chunk loop (full fusion); large ones run it as a scan so program
    # size and memory stay O(1) in the number of genome-sets.
    spec_w = first_occ & (gcount == 1)
    s = set_member.shape[0]
    w_row = w_iota[:, None, :]                         # [B, 1, W]

    def _chunk_step(carry, member_c, c0):
        """Fold one [cs, R] slice of the set table into the accumulators."""
        spec_counts, total_counts, fw_spec, fw_total = carry
        cs = member_c.shape[0]
        mf = member_c.astype(jnp.float32)               # [cs, R]
        mb = member_c > 0
        s_iota = jax.lax.broadcasted_iota(jnp.int32, (1, cs, 1), 1) + c0
        onehot_t = sid[:, None, :] == s_iota            # [B, cs, W]
        spec_oh_t = onehot_t & spec_w[:, None, :]
        tot_oh_t = onehot_t & first_occ[:, None, :]
        spec_sc = jnp.sum(spec_oh_t, axis=2, dtype=jnp.float32)  # [B, cs]
        tot_sc = jnp.sum(tot_oh_t, axis=2, dtype=jnp.float32)
        spec_counts = spec_counts + _count_product("bc,cr->br", spec_sc, mf)
        total_counts = total_counts + _count_product("bc,cr->br", tot_sc, mf)
        fw_set_spec = jnp.min(
            jnp.where(spec_oh_t, w_row, BIG), axis=2)   # [B, cs]
        fw_set_tot = jnp.min(
            jnp.where(tot_oh_t, w_row, BIG), axis=2)
        fw_spec = jnp.minimum(fw_spec, jnp.min(
            jnp.where(mb[None], fw_set_spec[:, :, None], BIG), axis=1
        ).astype(jnp.int32))
        fw_total = jnp.minimum(fw_total, jnp.min(
            jnp.where(mb[None], fw_set_tot[:, :, None], BIG), axis=1
        ).astype(jnp.int32))
        return spec_counts, total_counts, fw_spec, fw_total

    carry = (
        jnp.zeros((b, r), dtype=jnp.float32),
        jnp.zeros((b, r), dtype=jnp.float32),
        jnp.full((b, r), BIG, dtype=jnp.int32),
        jnp.full((b, r), BIG, dtype=jnp.int32),
    )
    n_chunks = max((s + SET_CHUNK - 1) // SET_CHUNK, 1)
    if n_chunks <= SET_UNROLL_CHUNKS:
        for c0 in range(0, max(s, 1), SET_CHUNK):
            carry = _chunk_step(
                carry, set_member[c0: c0 + SET_CHUNK], jnp.int32(c0))
    else:
        # Wide set tables: per-window membership gather, scanned over
        # window chunks.  Work scales as B*W*R (the size of the evidence
        # matrix) instead of the one-hot path's B*S*R, which loses badly
        # once S >> W; memory stays at one [B, WIN_CHUNK, R] tile.
        WIN_CHUNK = 32
        wp = ((w + WIN_CHUNK - 1) // WIN_CHUNK) * WIN_CHUNK
        nw = wp // WIN_CHUNK

        def _to_chunks(x, fill):
            xpad = jnp.pad(x, ((0, 0), (0, wp - w)), constant_values=fill)
            return jnp.swapaxes(
                xpad.reshape(b, nw, WIN_CHUNK), 0, 1)  # [nW, B, WC]

        xs = (
            _to_chunks(jnp.where(stored, sid, 0), 0),
            _to_chunks(spec_w, False),
            _to_chunks(first_occ, False),
            _to_chunks(w_iota, BIG),
        )

        def _win_body(c, xs_c):
            spec_counts, total_counts, fw_spec, fw_total = c
            sid_c, spec_c, tot_c, wi_c = xs_c
            mem = jnp.take(set_member, sid_c, axis=0)   # [B, WC, R] u8
            mem_f = mem.astype(jnp.float32)
            spec_counts = spec_counts + _count_product(
                "bwr,bw->br", mem_f, spec_c.astype(jnp.float32))
            total_counts = total_counts + _count_product(
                "bwr,bw->br", mem_f, tot_c.astype(jnp.float32))
            in_set = mem > 0
            fw_spec = jnp.minimum(fw_spec, jnp.min(
                jnp.where(spec_c[:, :, None] & in_set, wi_c[:, :, None], BIG),
                axis=1).astype(jnp.int32))
            fw_total = jnp.minimum(fw_total, jnp.min(
                jnp.where(tot_c[:, :, None] & in_set, wi_c[:, :, None], BIG),
                axis=1).astype(jnp.int32))
            return (spec_counts, total_counts, fw_spec, fw_total), None

        carry, _ = jax.lax.scan(_win_body, carry, xs)
    spec_counts, total_counts, fw_spec, fw_total = carry
    spec_counts = spec_counts.astype(jnp.int32)
    total_counts = total_counts.astype(jnp.int32)

    # ---- m-decision over specific counts (reference kmer.py:444-462) ----
    has_kmers = jnp.any(first_occ, axis=1)
    n_spec = jnp.sum((spec_counts > 0).astype(jnp.int32), axis=1)
    maxc = jnp.max(spec_counts, axis=1)
    tie_key = jnp.where(
        (spec_counts == maxc[:, None]) & (spec_counts > 0), fw_spec, BIG
    )
    winner = jnp.argmin(tie_key, axis=1).astype(jnp.int32)
    winner_oh = r_iota == winner[:, None]
    sc_excl = jnp.where(winner_oh, jnp.int32(-1), spec_counts)
    second_val = jnp.max(sc_excl, axis=1)
    unique_spec = (n_spec == 1) | ((n_spec > 1) & (maxc >= second_val + m))

    # ---- p-validation / downgrade (reference kmer.py:464-480) ----
    # winner's total count via one-hot sum (no gather)
    mt = jnp.sum(jnp.where(winner_oh, total_counts, 0), axis=1)
    max_total = jnp.max(total_counts, axis=1)
    downgraded = unique_spec & (p >= 0) & ((max_total - mt) > p)

    is_unique = unique_spec & ~downgraded
    mtype = jnp.where(
        ~has_kmers,
        jnp.int32(UNMAPPED),
        jnp.where(is_unique, jnp.int32(UNIQUELY_MAPPED), jnp.int32(AMBIGUOUSLY_MAPPED)),
    )
    amb_mask = jnp.where(
        downgraded[:, None], total_counts >= mt[:, None], spec_counts > 0
    ) & (mtype == AMBIGUOUSLY_MAPPED)[:, None]
    fw_sel = jnp.where(downgraded[:, None], fw_total, fw_spec)

    return BatchResult(
        mtype=mtype,
        winner=winner,
        downgraded=downgraded & (mtype == AMBIGUOUSLY_MAPPED),
        amb_mask=amb_mask,
        fw_sel=fw_sel,
        read_filtered=read_filtered,
        n_qual_kmers=n_qual_kmers,
        n_hr_kmers=n_hr_kmers,
    )


def _window_ok(qual, lengths, k: int, w: int, mkq, has_mkq: bool) -> jnp.ndarray:
    """[B, W] mask of windows inside the read that pass the MKQ gate.

    ``w`` comes from the (unpacked) codes shape -- ``qual`` may be a
    [B, 1] dummy when no quality gate consumes it (transfer diet)."""
    b = qual.shape[0]
    w_iota = jax.lax.broadcasted_iota(jnp.int32, (b, w), 1)
    lens = lengths.astype(jnp.int32)
    valid = w_iota < (lens - jnp.int32(k - 1))[:, None]
    if has_mkq:
        qsum = window_quality_sums(qual, k)
        return valid & (qsum >= mkq * jnp.int32(k))
    return valid


def align_batch_core(
    probe_tab,                # HashTableDev or SortedTableDev
    set_member: jnp.ndarray,  # uint8  [S, R]
    codes: jnp.ndarray,       # uint8  [B, L]
    qual: jnp.ndarray,        # uint8  [B, L]
    lengths: jnp.ndarray,     # int32  [B]
    m: jnp.ndarray,
    p: jnp.ndarray,
    mrq: jnp.ndarray,
    mkq: jnp.ndarray,
    mg: jnp.ndarray,
    *,
    k: int,
    has_mrq: bool,
    has_mkq: bool,
    has_mg: bool,
    packed: bool = False,
) -> BatchResult:
    """Single-trace form: probe + everything downstream in one program,
    for every probe structure (the jitted entry points and the shard_map
    bodies all trace this).

    ``packed``: codes arrive 2-bit packed [B, L/4] and are unpacked
    on device (see ``unpack_codes_2bit``).
    """
    if packed:
        codes = unpack_codes_2bit(codes)
    if isinstance(probe_tab, SortedTableDevW):
        # multi-word keys (any k): gather-free sorted join with a tag word
        from shotgun_tpu.ops.probe_sort2 import probe_dedupe_sorted_words

        qws = rolling_encode_words_jnp(codes, k)
        kq_ok = _window_ok(
            qual, lengths, k, codes.shape[1] - k + 1, mkq, has_mkq)
        hit, sid, gcount, first_occ = probe_dedupe_sorted_words(
            probe_tab, qws, kq_ok,
            num_sets=set_member.shape[0],
            max_genome_count=set_member.shape[1],
        )
        return core_from_probe(
            (hit, sid, gcount, None), set_member, qual, lengths,
            m, p, mrq, mkq, mg,
            k=k, has_mrq=has_mrq, has_mkq=has_mkq, has_mg=has_mg,
            pre_first_occ=first_occ,
        )
    lo, hi = rolling_encode_jnp(codes, k)
    if isinstance(probe_tab, SortedTableDev):
        from shotgun_tpu.ops.probe_sort2 import probe_dedupe_sorted

        kq_ok = _window_ok(
            qual, lengths, k, codes.shape[1] - k + 1, mkq, has_mkq)
        hit, sid, gcount, first_occ = probe_dedupe_sorted(
            probe_tab, lo, hi, kq_ok,
            num_sets=set_member.shape[0],
            max_genome_count=set_member.shape[1],
        )
        return core_from_probe(
            (hit, sid, gcount, None), set_member, qual, lengths,
            m, p, mrq, mkq, mg,
            k=k, has_mrq=has_mrq, has_mkq=has_mkq, has_mg=has_mg,
            pre_first_occ=first_occ,
        )
    probe_res = probe_kmers(probe_tab.table, probe_tab.stash, lo, hi)
    return core_from_probe(
        probe_res, set_member, qual, lengths, m, p, mrq, mkq, mg,
        k=k, has_mrq=has_mrq, has_mkq=has_mkq, has_mg=has_mg,
    )


class AggResult(NamedTuple):
    """Per-batch counters, merged exactly across batches/shards (ints)."""

    n_unique: jnp.ndarray        # int32 []
    n_ambiguous: jnp.ndarray     # int32 []
    n_unmapped: jnp.ndarray      # int32 []
    n_filtered_reads: jnp.ndarray
    n_filtered_kmers: jnp.ndarray
    n_hr_kmers: jnp.ndarray
    unique_by_rec: jnp.ndarray   # int32 [R]
    amb_by_rec: jnp.ndarray      # int32 [R]
    first_key: jnp.ndarray       # int32 [R] min of row*(R+2)+pos, BIG if absent


class FoldCarry(NamedTuple):
    """Device-resident accumulation of AggResults across batches.

    The whole accumulation stays on device and the caller fetches it
    ONCE per run instead of fetching every batch's AggResult.

    int32 throughout: caps one align call at 2^31-1 reads and 2^31-1
    batches -- the host-side totals stay int64 across calls.
    """

    counters: jnp.ndarray       # int32 [6]: uniq, amb, unmapped, f_reads, f_kmers, hr
    unique_by_rec: jnp.ndarray  # int32 [Rp]
    amb_by_rec: jnp.ndarray     # int32 [Rp]
    first_batch: jnp.ndarray    # int32 [Rp], FOLD_INF when unseen
    first_key: jnp.ndarray      # int32 [Rp]
    batch_no: jnp.ndarray       # int32 [] index of the NEXT batch to fold


FOLD_INF = _np.int32(0x7FFFFFFF)


def init_fold_carry(rp: int, start_batch: int = 0) -> FoldCarry:
    """Initial carry as NUMPY leaves: the first fold call transfers them
    like any other argument.  Building them with jnp.zeros/jnp.full
    would compile (and on every warm CLI run load) four trivial XLA
    programs; this way the warm path runs exactly one executable."""
    return FoldCarry(
        counters=_np.zeros(6, dtype=_np.int32),
        unique_by_rec=_np.zeros(rp, dtype=_np.int32),
        amb_by_rec=_np.zeros(rp, dtype=_np.int32),
        first_batch=_np.full(rp, FOLD_INF, dtype=_np.int32),
        first_key=_np.full(rp, FOLD_INF, dtype=_np.int32),
        batch_no=_np.int32(start_batch),
    )


def _fold_agg(carry: FoldCarry, agg: AggResult) -> FoldCarry:
    """Trace-level fold of one batch's AggResult into the running carry.

    The batch index lives IN the carry (incremented here) so streaming
    callers never ship a per-batch scalar to the device."""
    counters = carry.counters + jnp.stack([
        agg.n_unique, agg.n_ambiguous, agg.n_unmapped,
        agg.n_filtered_reads, agg.n_filtered_kmers, agg.n_hr_kmers,
    ]).astype(jnp.int32)
    fresh = (agg.first_key < BIG) & (carry.first_batch == FOLD_INF)
    return FoldCarry(
        counters=counters,
        unique_by_rec=carry.unique_by_rec + agg.unique_by_rec,
        amb_by_rec=carry.amb_by_rec + agg.amb_by_rec,
        first_batch=jnp.where(fresh, carry.batch_no, carry.first_batch),
        first_key=jnp.where(fresh, agg.first_key, carry.first_key),
        batch_no=carry.batch_no + jnp.int32(1),
    )


@functools.partial(jax.jit, donate_argnums=(0,))
def fold_agg_device(carry: FoldCarry, agg: AggResult) -> FoldCarry:
    """One batch's AggResult into the running carry (all on device)."""
    return _fold_agg(carry, agg)



def _split_len_cols(codes_ext: jnp.ndarray):
    """Split a combined transfer buffer: the last 4 byte-columns carry
    each row's int32 length (little-endian), so each chunk is one
    host->device transfer instead of two."""
    lb = codes_ext[..., -4:].astype(jnp.int32)
    lengths = (lb[..., 0] | (lb[..., 1] << 8) | (lb[..., 2] << 16)
               | (lb[..., 3] << 24))
    return codes_ext[..., :-4], lengths


@functools.partial(
    jax.jit,
    static_argnames=("k", "has_mrq", "has_mkq", "has_mg", "packed",
                     "len_in_codes"),
    donate_argnums=(0,),
)
def align_fold_batch(
    carry: FoldCarry,
    probe_tab,
    set_member,
    codes,
    qual,
    lengths,
    m, p, mrq, mkq, mg,
    *,
    k: int,
    has_mrq: bool,
    has_mkq: bool,
    has_mg: bool,
    packed: bool = False,
    len_in_codes: bool = False,
) -> FoldCarry:
    """ONE dispatch per streamed batch: align + aggregate + fold.

    The dumpalign stream path (PseudoAlignment.align_stream) needs only
    the folded carry; fusing the whole chain into a single program (a)
    halves the per-batch dispatch count vs align_batch + fold_agg_device,
    and (b) lets XLA dead-code-eliminate every per-read output buffer --
    nothing row-shaped leaves the program.

    ``row_valid`` is derived on device as ``lengths > 0``: the FASTQ
    grammar requires a nonempty sequence line (reference records.py:262),
    so zero-length rows are exactly the tail padding of the final chunk.
    Works for both probe families.
    """
    if len_in_codes:
        # fold the placeholder lengths arg into the anchor so it is never
        # a pruned parameter (see core_from_probe's scalar anchor)
        codes, real_lengths = _split_len_cols(codes)
        lengths = real_lengths + lengths.astype(jnp.int32).sum() * 0
    row_valid = lengths > jnp.int32(0)
    res = align_batch_core(
        probe_tab, set_member, codes, qual, lengths, m, p, mrq, mkq, mg,
        k=k, has_mrq=has_mrq, has_mkq=has_mkq, has_mg=has_mg, packed=packed,
    )
    return _fold_agg(carry, aggregate_batch(res, row_valid))


@functools.partial(
    jax.jit,
    static_argnames=("k", "has_mrq", "has_mkq", "has_mg", "packed",
                     "len_in_codes", "store"),
    donate_argnums=(0,),
)
def align_fold_superbatch(
    carry: FoldCarry,
    probe_tab,
    set_member,
    codes,     # uint8 [S, B, C] (2-bit packed when packed=True)
    qual,      # uint8 [S, B, L] scanned per sub-batch, or [B, 1] shared dummy
    lengths,   # int32 [S, B]
    m, p, mrq, mkq, mg,
    *,
    k: int,
    has_mrq: bool,
    has_mkq: bool,
    has_mg: bool,
    packed: bool = False,
    len_in_codes: bool = False,
    store: bool = False,
) -> FoldCarry:
    """S streamed sub-batches in ONE dispatch: ``lax.scan`` of the fused
    align+aggregate+fold body over the leading axis.

    ``store``: additionally stack each sub-batch's packed per-read store
    outputs (``pack_store_words``) as scan ys and return
    ``(carry, words [S, B], keys [S, B, R])`` -- the align-task path
    (store_reads=True) gets the same one dispatch per S sub-batches as
    the dumpalign stream.

    Shipping S sub-batches as one [S, B, ...] transfer + one dispatch
    divides the per-batch transfer and dispatch count by S while the
    on-device batch shape stays B.  Tail padding rows are
    zero-length and fall out of ``row_valid`` exactly as in
    ``align_fold_batch``; a fully padded trailing sub-batch still bumps
    ``batch_no``, which is harmless (order keys only consume batch_no of
    batches that contained live reads).

    ``qual`` may be the shared [B, 1] device-resident dummy when no
    quality gate consumes it (rank 2 -> closed over as a scan constant
    instead of scanned, so the host never ships a per-superbatch plane).

    Sorted-table probes whose table DOMINATES the per-batch join
    additionally share ONE sort-join across the whole superbatch: the
    static table rows ride the join once per dispatch (u + S*B*W rows)
    instead of once per sub-batch (S * (u + B*W)) -- at the 8M-key
    auto-switch boundary that is ~3x less sorted data.  Only the probe
    is hoisted; classification and aggregation still scan per sub-batch
    so the one-hot set reduction keeps its [B, chunk, W] working-set
    shape.  For small tables the per-sub-batch join is faster (one huge
    sort loses to S batch-size sorts), so sharing engages only when
    u > 2 * B * W.
    """
    if len_in_codes:
        codes, real_lengths = _split_len_cols(codes)
        lengths = real_lengths + lengths.astype(jnp.int32).sum() * 0
    scan_qual = qual.ndim == 3
    s, b = lengths.shape

    probe_shared = None
    n_words_c = codes.shape[2] * (4 if packed else 1)
    u_rows = (int(probe_tab.klo.shape[0])
              if isinstance(probe_tab, SortedTableDev)
              else int(probe_tab.kws[0].shape[0])
              if isinstance(probe_tab, SortedTableDevW) else 0)
    share = u_rows > 2 * b * (n_words_c - k + 1)
    if share and isinstance(probe_tab, (SortedTableDev, SortedTableDevW)):
        flat_codes = codes.reshape(s * b, codes.shape[2])
        flat_len = lengths.reshape(s * b)
        if scan_qual:
            flat_qual = qual.reshape(s * b, qual.shape[2])
        else:
            # gates are the only consumers; without them the window mask
            # needs only lengths
            flat_qual = jnp.zeros((s * b, 1), dtype=jnp.uint8)
        fc = unpack_codes_2bit(flat_codes) if packed else flat_codes
        w = fc.shape[1] - k + 1
        kq_ok = _window_ok(flat_qual, flat_len, k, w, mkq, has_mkq)
        if isinstance(probe_tab, SortedTableDevW):
            from shotgun_tpu.ops.probe_sort2 import (
                probe_dedupe_sorted_words,
            )

            qws = rolling_encode_words_jnp(fc, k)
            pr = probe_dedupe_sorted_words(
                probe_tab, qws, kq_ok,
                num_sets=set_member.shape[0],
                max_genome_count=set_member.shape[1],
            )
        else:
            from shotgun_tpu.ops.probe_sort2 import probe_dedupe_sorted

            lo, hi = rolling_encode_jnp(fc, k)
            pr = probe_dedupe_sorted(
                probe_tab, lo, hi, kq_ok,
                num_sets=set_member.shape[0],
                max_genome_count=set_member.shape[1],
            )
        probe_shared = tuple(x.reshape(s, b, w) for x in pr)

    def body(c, xs):
        if probe_shared is not None:
            if scan_qual:
                hit_b, sid_b, gc_b, focc_b, qual_b, len_b = xs
            else:
                hit_b, sid_b, gc_b, focc_b, len_b = xs
                qual_b = qual
            res = core_from_probe(
                (hit_b, sid_b, gc_b, None), set_member, qual_b, len_b,
                m, p, mrq, mkq, mg,
                k=k, has_mrq=has_mrq, has_mkq=has_mkq, has_mg=has_mg,
                pre_first_occ=focc_b,
            )
        else:
            if scan_qual:
                codes_b, qual_b, len_b = xs
            else:
                codes_b, len_b = xs
                qual_b = qual
            res = align_batch_core(
                probe_tab, set_member, codes_b, qual_b, len_b,
                m, p, mrq, mkq, mg,
                k=k, has_mrq=has_mrq, has_mkq=has_mkq, has_mg=has_mg,
                packed=packed,
            )
        row_valid = len_b > jnp.int32(0)
        folded = _fold_agg(c, aggregate_batch(res, row_valid))
        return folded, (pack_store_words(res, max_w=n_words_c - k + 1)
                        if store else None)

    if probe_shared is not None:
        xs = ((*probe_shared, qual, lengths) if scan_qual
              else (*probe_shared, lengths))
    else:
        xs = (codes, qual, lengths) if scan_qual else (codes, lengths)
    carry, ys = jax.lax.scan(body, carry, xs)
    if store:
        return carry, ys[0], ys[1]
    return carry


#: int16 store-key sentinel ("record not in the mapping list")
STORE_KEY_INF16 = _np.int16(0x7FFF)


@functools.partial(jax.jit, static_argnames=("max_w",))
def pack_store_words(res: BatchResult, *, max_w: int):
    """Compact per-read outputs for the store_reads (align-task) path
    (the data PseudoAlignment.reads carries per read in the reference:
    mapping type + genomes_mapped_to list, kmer.py:536-549).

    Two arrays per batch instead of eight, concatenated on device and
    fetched once per run.

      word [B] int32: mtype | downgraded << 2 | read_filtered << 3
                      | winner << 4
      keys [B, R]:    fw order key where the record is in the read's
                      mapping list, sentinel elsewhere (the list = winner
                      for unique rows, amb_mask members for ambiguous
                      rows).  int16 when ``max_w`` (the static window
                      count, every in-list fw value's bound) fits --
                      any read under ~32 kbp -- halving the run's
                      largest fetch; int32 otherwise.
    """
    b, r = res.amb_mask.shape
    r_iota = jax.lax.broadcasted_iota(jnp.int32, (b, r), 1)
    winner_onehot = r_iota == res.winner[:, None]
    is_u = res.mtype == UNIQUELY_MAPPED
    is_a = res.mtype == AMBIGUOUSLY_MAPPED
    in_list = jnp.where(is_u[:, None], winner_onehot,
                        res.amb_mask & is_a[:, None])
    if max_w < int(STORE_KEY_INF16):
        keys = jnp.where(in_list, res.fw_sel,
                         jnp.int32(STORE_KEY_INF16)).astype(jnp.int16)
    else:
        keys = jnp.where(in_list, res.fw_sel, BIG)
    word = (res.mtype
            | (res.downgraded.astype(jnp.int32) << 2)
            | (res.read_filtered.astype(jnp.int32) << 3)
            | (res.winner << 4))
    return word, keys


def aggregate_batch(res: BatchResult, row_valid: jnp.ndarray) -> AggResult:
    """Fold per-read outputs into per-record counters + order keys.

    ``first_key`` reconstructs the reference's Summary dict insertion order
    (reference kmer.py:639-654): per read, genomes are encountered in list
    order; across reads, in input order.  pos-in-list is the rank of the
    (first-window, record) key; a downgrade's prepended winner gets pos 0.
    """
    b, r = res.amb_mask.shape
    r_iota = jax.lax.broadcasted_iota(jnp.int32, (b, r), 1)
    row_iota = jax.lax.broadcasted_iota(jnp.int32, (b, r), 0)

    live = row_valid & ~res.read_filtered
    is_u = live & (res.mtype == UNIQUELY_MAPPED)
    is_a = live & (res.mtype == AMBIGUOUSLY_MAPPED)
    is_n = live & (res.mtype == UNMAPPED)

    winner_onehot = (r_iota == res.winner[:, None])
    unique_by_rec = jnp.sum(
        (winner_onehot & is_u[:, None]).astype(jnp.int32), axis=0
    )
    amb_inc = res.amb_mask.astype(jnp.int32) + jnp.where(
        (res.downgraded & is_a)[:, None] & winner_onehot, 1, 0
    )
    amb_by_rec = jnp.sum(jnp.where(is_a[:, None], amb_inc, 0), axis=0)

    # in-list membership + position
    in_list = jnp.where(
        is_u[:, None], winner_onehot, res.amb_mask & is_a[:, None]
    )
    key = res.fw_sel * jnp.int32(r) + r_iota  # lexicographic (fw, record)
    key = jnp.where(
        (res.downgraded & is_a)[:, None] & winner_onehot, jnp.int32(-1), key
    )
    key = jnp.where(in_list, key, BIG)
    # rank of each in-list key within its row.  In-list keys are distinct
    # by construction (they carry r_iota in the low digits), so comparison
    # count and sorted position agree.  Pairwise count is fastest for the
    # small lane-padded shapes; past that its [B, R, R] intermediate is
    # quadratic in the genome count, so wide tables use argsort-of-argsort
    if r <= 512:
        rank = jnp.sum(
            (key[:, None, :] < key[:, :, None]).astype(jnp.int32), axis=2
        )
    else:
        order = jnp.argsort(key, axis=1)
        rank = jnp.argsort(order, axis=1).astype(jnp.int32)
    enc_key = jnp.where(in_list, row_iota * jnp.int32(r + 2) + rank, BIG)
    first_key = jnp.min(enc_key, axis=0)

    mask32 = lambda x: jnp.sum(x.astype(jnp.int32))
    return AggResult(
        n_unique=mask32(is_u),
        n_ambiguous=mask32(is_a),
        n_unmapped=mask32(is_n),
        n_filtered_reads=jnp.sum(
            (row_valid & res.read_filtered).astype(jnp.int32)
        ),
        n_filtered_kmers=jnp.sum(jnp.where(live, res.n_qual_kmers, 0)),
        n_hr_kmers=jnp.sum(jnp.where(live, res.n_hr_kmers, 0)),
        unique_by_rec=unique_by_rec,
        amb_by_rec=amb_by_rec,
        first_key=first_key,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "has_mrq", "has_mkq", "has_mg", "with_aggregate", "packed"),
)
def align_batch(
    probe_tab,
    set_member,
    codes,
    qual,
    lengths,
    row_valid,
    m, p, mrq, mkq, mg,
    *,
    k: int,
    has_mrq: bool,
    has_mkq: bool,
    has_mg: bool,
    with_aggregate: bool = True,
    packed: bool = False,
):
    """Batch entry point: per-read results and (optionally) aggregation.

    One jitted program for every probe structure; all device work is
    async and the return values are unfetched device arrays.

    ``packed``: codes are 2-bit packed [B, L/4] (4x smaller host->device
    transfer; see ``unpack_codes_2bit``).  When neither quality gate is
    active, callers may additionally pass a zero [B, 1] dummy as ``qual``
    -- the gates are the only consumers.
    """
    res = align_batch_core(
        probe_tab, set_member, codes, qual, lengths, m, p, mrq, mkq, mg,
        k=k, has_mrq=has_mrq, has_mkq=has_mkq, has_mg=has_mg, packed=packed,
    )
    if with_aggregate:
        return res, aggregate_batch(res, row_valid)
    return res
