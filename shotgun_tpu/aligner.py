"""Pseudo-alignment: per-read API (``Read``) and aggregator (``PseudoAlignment``).

``Read.pseudo_align`` is an exact host-side implementation of the per-read
algorithm (reference kmer.py:357-526) against the array index -- used for
the single-read API and as a readable specification.  Bulk alignment goes
through the batched device pipeline (models/pipeline.py); both paths agree
bit-for-bit (tested differentially).

``PseudoAlignment`` keeps integer aggregation state (counters, per-record
vectors, first-encounter order keys) that reconstructs the reference's
dumpalign JSON -- including dict insertion orders and the downgrade
double-count quirk (reference kmer.py:464-480,622-657) -- without holding
Python dicts per read.
"""

from __future__ import annotations

import io
import json
import os
from collections import namedtuple
from enum import Enum
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

from shotgun_tpu.index.build import rolling_encode_words, sort_keys_from_words
from shotgun_tpu.io.packing import ReadBatch, encode_bases, pack_reads
from shotgun_tpu.errors import UserInputError
from shotgun_tpu.io.records import SeqRecord
from shotgun_tpu.reference import KDBFormatError, KmerReference

_INF = np.iinfo(np.int64).max


def _prefetch_iter(it, depth: int = 2):
    """Run an iterator on a producer thread, yielding through a bounded
    queue.  The native chunk fills release the GIL, so the producer
    genuinely overlaps the consumer's device transfers/dispatch; ``depth``
    bounds the number of filled-but-unconsumed chunks (each chunk is a
    fresh buffer, so in-flight chunks are never overwritten).  Exceptions
    from the iterator (e.g. LmaxExceeded from an overrun-safe lazy fill)
    re-raise at the consumer's next pull.

    If the consumer abandons the loop (e.g. a device error outside this
    iterator), the generator's ``finally`` sets a cancel flag and drains
    the queue so the producer's bounded ``put`` can never block forever.
    The PRODUCER thread closes the source iterator in its own finally --
    it is the thread driving the iterator, so the close is safe and
    happens even if a blocked native fill outlives the consumer's wait."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    holder: List[BaseException] = []
    cancelled = threading.Event()

    def cancellable_put(item) -> bool:
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            for item in it:
                if not cancellable_put(item):
                    return
        except BaseException as exc:  # re-raised on the consumer side
            holder.append(exc)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass
            cancellable_put(done)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if holder:
                    raise holder[0]
                return
            yield item
    finally:
        cancelled.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)


def _auto_batch(est_reads: int) -> int:
    """Resolve batch_size=0 (auto): big inputs get the large batch (the
    per-batch table re-sort amortizes over more query windows), small
    inputs keep the small fast-compiling program (output is batch-size
    invariant either way; tests pin that).  The sizes were tuned on the
    previous accelerator and await an H100 re-measurement."""
    return 32768 if est_reads >= 131_072 else 2048


class NotValidatingUniqueMapping(Exception):
    def __init__(self, message: str) -> None:
        super().__init__(message)


class AddingExistingRead(Exception):
    def __init__(self, message: str) -> None:
        super().__init__(message)


class ReadMappingType(Enum):
    UNMAPPED = 1
    UNIQUELY_MAPPED = 2
    AMBIGUOUSLY_MAPPED = 3


class KmerSpecifity(Enum):
    SPECIFIC = 1
    UNSPECIFIC = 2


ReadKmer = namedtuple("ReadKmer", ["specifity", "references"])
ReadMapping = namedtuple("ReadMapping", ["type", "genomes_mapped_to"])

# device mtype codes (models/pipeline.py) -> ReadMappingType
_MTYPE_FROM_CODE = {
    0: ReadMappingType.UNMAPPED,
    1: ReadMappingType.UNIQUELY_MAPPED,
    2: ReadMappingType.AMBIGUOUSLY_MAPPED,
}
_CODE_FROM_MTYPE = {v: k for k, v in _MTYPE_FROM_CODE.items()}


class Read:
    """One sequencing read (reference kmer.py:357-526)."""

    def __init__(self, fastaq_record: SeqRecord) -> None:
        self.identifier: str = fastaq_record.identifier
        self.mapping = ReadMapping(ReadMappingType.UNMAPPED, [])
        self.kmers: Dict[str, ReadKmer] = {}
        self._seq: str = fastaq_record["sequence"]
        self._qual: str = fastaq_record["quality_sequence"]
        self.num_quality_filtered_kmers: int = 0
        self.num_redundant_kmers: int = 0
        self._record_ids: List[int] = []  # mapping list as record indices
        self._stored: Dict[int, bool] = {}  # kmer id -> specific?
        self._ref: Optional[KmerReference] = None

    def mean_quality(self) -> float:
        return sum(map(ord, self._qual)) / len(self._qual)

    def kmer_quality(self, start: int, k: int) -> float:
        return sum(map(ord, self._qual[start: start + k])) / k

    def pseudo_align(
        self,
        kmer_reference: KmerReference,
        m: int = 1,
        p: int = 1,
        min_read_quality: Optional[int] = None,
        min_kmer_quality: Optional[int] = None,
        max_genomes: Optional[int] = None,
        debug: bool = False,
    ) -> ReadMappingType:
        if not (
            isinstance(kmer_reference, KmerReference)
            and isinstance(m, int)
            and isinstance(p, int)
            and (min_read_quality is None or isinstance(min_read_quality, int))
            and (min_kmer_quality is None or isinstance(min_kmer_quality, int))
            and (max_genomes is None or isinstance(max_genomes, int))
            and isinstance(debug, bool)
        ):
            raise TypeError(
                f"Invalid types given to pseudo align: {type(kmer_reference)}, "
                f"{type(p)}, {type(m)}, {type(debug)}"
            )
        if m < 0:
            raise UserInputError("m must be bigger than or equal to 0")
        if min_read_quality is not None and self.mean_quality() < min_read_quality:
            return ReadMappingType.UNMAPPED

        self.extract_kmer_references(kmer_reference, min_kmer_quality, max_genomes)
        if not self._stored:
            return ReadMappingType.UNMAPPED
        if self.try_to_align_specific(m):
            if debug:
                print(
                    "[DEBUG pseudo_align]: After try_to_align_specific "
                    f"self.mapping: {self.mapping.type}"
                )
            self.validate_unique_mappings(p)
            return self.mapping.type
        if debug:
            print(
                "[DEBUG pseudo_align]: After try_to_align_specific "
                f"self.mapping: {self.mapping.type}, mapped to: {self.mapping}"
            )
        return ReadMappingType.AMBIGUOUSLY_MAPPED

    def extract_kmer_references(
        self,
        kmer_reference: KmerReference,
        min_kmer_quality: Optional[int] = None,
        max_genomes: Optional[int] = None,
    ) -> None:
        """Probe every window, apply MKQ/MG gates in occurrence order, and
        store surviving k-mers by first occurrence
        (reference kmer.py:410-429)."""
        self._ref = kmer_reference
        idx = kmer_reference.index
        k = idx.k
        codes = encode_bases(self._seq)
        words, _ = rolling_encode_words(codes, k)
        keys = sort_keys_from_words(words)
        table_keys = idx.sort_keys()
        if keys.size and table_keys.size:
            pos = np.searchsorted(table_keys, keys)
            clamped = np.minimum(pos, table_keys.size - 1)
            hits = np.where(table_keys[clamped] == keys, clamped, -1)
        else:
            hits = np.full(keys.size, -1, dtype=np.int64)

        genome_counts = idx.genome_counts()
        qual_ord = np.frombuffer(
            self._qual.encode("ascii"), dtype=np.uint8
        ).astype(np.int32)
        qual_cs = np.concatenate([[0], np.cumsum(qual_ord)])

        # ordered per-read k-mer store: kid -> specific?
        self._stored: Dict[int, bool] = {}
        for w in range(hits.size):
            if min_kmer_quality is not None:
                if qual_cs[w + k] - qual_cs[w] < min_kmer_quality * k:
                    self.num_quality_filtered_kmers += 1
                    continue
            kid = int(hits[w])
            if kid < 0:
                continue
            if max_genomes is not None and genome_counts[kid] > max_genomes:
                self.num_redundant_kmers += 1
                continue
            if kid not in self._stored:
                self._stored[kid] = bool(genome_counts[kid] == 1)

        recs = kmer_reference._materialized_records()
        for kid, specific in self._stored.items():
            self.kmers[idx.kmer_string(kid)] = ReadKmer(
                specifity=(
                    KmerSpecifity.SPECIFIC if specific else KmerSpecifity.UNSPECIFIC
                ),
                references={
                    recs[r]: set(int(x) for x in idx.positions_of(kid, r))
                    for r in idx.records_of_kmer(kid)
                },
            )

    def _genome_count_ids(self, map_count: bool = False) -> Dict[int, int]:
        """Per-record distinct-k-mer counts in insertion order
        (record ids; reference kmer.py:431-442)."""
        idx = self._ref.index
        counts: Dict[int, int] = {}
        for kid, specific in self._stored.items():
            if map_count and not specific:
                continue
            for r in idx.records_of_kmer(kid):
                r = int(r)
                counts[r] = counts.get(r, 0) + 1
        return counts

    def generate_genome_counts(self, map_count: bool = False):
        """Reference-parity accessor: counts keyed by genome records."""
        recs = self._ref._materialized_records()
        return {
            recs[r]: c for r, c in self._genome_count_ids(map_count).items()
        }

    def try_to_align_specific(self, m: int) -> bool:
        """The m-decision over specific k-mer counts
        (reference kmer.py:444-462)."""
        if m < 0:
            raise UserInputError("m must be non-negative")
        spec = self._genome_count_ids(map_count=True)
        recs = self._ref._materialized_records()
        if len(spec) == 1:
            self._set_mapping(
                ReadMappingType.UNIQUELY_MAPPED, [next(iter(spec))], recs)
            return True
        if len(spec) > 1:
            ranked = sorted(spec, key=lambda r: spec[r], reverse=True)
            if spec[ranked[0]] >= spec[ranked[1]] + m:
                self._set_mapping(
                    ReadMappingType.UNIQUELY_MAPPED, [ranked[0]], recs)
                return True
        self._set_mapping(
            ReadMappingType.AMBIGUOUSLY_MAPPED, list(spec.keys()), recs)
        return False

    def validate_unique_mappings(self, p: int) -> None:
        """p-validation; downgrades to ambiguous with the winner listed
        twice (reference kmer.py:464-480)."""
        if self.mapping.type != ReadMappingType.UNIQUELY_MAPPED or p < 0:
            return
        total = self._genome_count_ids(map_count=False)
        winner = self._record_ids[0]
        mt = total.get(winner, 0)
        max_total = max(total.values(), default=0)
        if max_total - mt > p:
            amb = [winner] + [r for r, c in total.items() if c >= mt]
            self._set_mapping(
                ReadMappingType.AMBIGUOUSLY_MAPPED, amb,
                self._ref._materialized_records())

    def _set_mapping(
        self, mtype: ReadMappingType, record_ids: List[int], recs: List[SeqRecord]
    ) -> None:
        self._record_ids = [int(r) for r in record_ids]
        self.mapping = ReadMapping(mtype, [recs[r] for r in self._record_ids])


class PseudoAlignment:
    """Aggregates read alignments against one KmerReference
    (reference kmer.py:532-699)."""

    def __init__(self, kmer_reference: KmerReference) -> None:
        self.kmer_reference = kmer_reference
        r = kmer_reference.index.num_records
        # read store (arrays, not dicts)
        self._read_ids: List[str] = []
        self._mtypes: List[int] = []
        self._list_flat: List[np.ndarray] = []
        self._list_counts: List[int] = []
        self._seen_ids: set = set()
        self._store_reads = True
        # aggregation state
        self.filtered_quality_reads = 0
        self.filtered_quality_kmers = 0
        self.filtered_hr_kmers = 0
        self._n_unique = 0
        self._n_ambiguous = 0
        self._n_unmapped = 0
        self._unique_by_rec = np.zeros(r, dtype=np.int64)
        self._amb_by_rec = np.zeros(r, dtype=np.int64)
        self._first_batch = np.full(r, _INF, dtype=np.int64)
        self._first_key = np.full(r, _INF, dtype=np.int64)
        self._batch_no = 0

        self.filter_read_quality_flag = False
        self.filter_kmer_quality_flag = False
        self.filter_max_genomes_flag = False

    # -- single-read API ----------------------------------------------------

    def add_read(self, read: Read) -> None:
        if read.identifier in self._seen_ids:
            raise AddingExistingRead(
                f"There already exists a read with identifier: {read.identifier}"
            )
        self._seen_ids.add(read.identifier)
        self._read_ids.append(read.identifier)
        code = _CODE_FROM_MTYPE[read.mapping.type]
        self._mtypes.append(code)
        ids = np.asarray(read._record_ids, dtype=np.int64)
        self._list_flat.append(ids)
        self._list_counts.append(ids.size)
        self._fold_single(code, ids)

    def _fold_single(self, code: int, record_ids: np.ndarray) -> None:
        if code == 1:
            self._n_unique += 1
        elif code == 2:
            self._n_ambiguous += 1
        else:
            self._n_unmapped += 1
        if code != 0:
            np.add.at(self._amb_by_rec if code == 2 else self._unique_by_rec,
                      record_ids, 1)
            for pos, r in enumerate(record_ids):
                key = pos  # within-read position
                if self._first_batch[r] == _INF:
                    self._first_batch[r] = self._batch_no
                    self._first_key[r] = key
        self._batch_no += 1

    def add_read_from_read_record(
        self,
        read_record: SeqRecord,
        m: int = 1,
        p: int = 1,
        min_read_quality: Optional[int] = None,
        min_kmer_quality: Optional[int] = None,
        max_genomes: Optional[int] = None,
    ) -> None:
        if min_read_quality is not None:
            self.filter_read_quality_flag = True
        if min_kmer_quality is not None:
            self.filter_kmer_quality_flag = True
        if max_genomes is not None:
            self.filter_max_genomes_flag = True
        read = Read(read_record)
        if min_read_quality is not None and read.mean_quality() < min_read_quality:
            self.filtered_quality_reads += 1
            return
        read.pseudo_align(
            self.kmer_reference, m=m, p=p,
            min_read_quality=min_read_quality,
            min_kmer_quality=min_kmer_quality,
            max_genomes=max_genomes,
        )
        if min_kmer_quality is not None:
            self.filtered_quality_kmers += read.num_quality_filtered_kmers
        if max_genomes is not None:
            self.filtered_hr_kmers += read.num_redundant_kmers
        self.add_read(read)

    # -- batched device API ---------------------------------------------------

    def align_reads_from_container(
        self,
        reads_container: Iterable[SeqRecord],
        m: int = 1,
        p: int = 1,
        min_read_quality: Optional[int] = None,
        min_kmer_quality: Optional[int] = None,
        max_genomes: Optional[int] = None,
        batch_size: int = 1024,
        store_reads: bool = True,
    ) -> None:
        if hasattr(reads_container, "to_read_batch"):
            batch = reads_container.to_read_batch()
        else:
            batch = pack_reads(list(reads_container))
        self.align_packed_reads(
            batch, m=m, p=p,
            min_read_quality=min_read_quality,
            min_kmer_quality=min_kmer_quality,
            max_genomes=max_genomes,
            batch_size=batch_size,
            store_reads=store_reads,
        )

    def align_packed_reads(
        self,
        batch: ReadBatch,
        m: int = 1,
        p: int = 1,
        min_read_quality: Optional[int] = None,
        min_kmer_quality: Optional[int] = None,
        max_genomes: Optional[int] = None,
        batch_size: int = 1024,
        store_reads: bool = True,
        mesh=None,
    ) -> None:
        """Align a packed batch on device.

        ``mesh``: optional ``jax.sharding.Mesh`` with a 'data' axis -- reads
        are sharded across it and merged with exact integer collectives
        (requires ``store_reads=False``; output is shard-count invariant).
        """
        import jax.numpy as jnp

        from shotgun_tpu.models.pipeline import align_batch

        if mesh is not None and store_reads:
            raise ValueError("mesh-sharded alignment requires store_reads=False")

        if not isinstance(m, int) or not isinstance(p, int):
            raise TypeError("m and p must be ints")
        if m < 0:
            raise UserInputError("m must be bigger than or equal to 0")
        if min_read_quality is not None:
            self.filter_read_quality_flag = True
        if min_kmer_quality is not None:
            self.filter_kmer_quality_flag = True
        if max_genomes is not None:
            self.filter_max_genomes_flag = True

        ref = self.kmer_reference
        idx = ref.index
        k = idx.k
        probe_tab = ref.device_probe_tables()
        set_member = ref.set_member_dense()
        r = idx.num_records

        if batch_size == 0:
            batch_size = _auto_batch(batch.num_reads)
        n = batch.num_reads
        # bucket the padded read length to a multiple of 32: padded windows
        # are masked by per-read lengths (output-neutral), and executables
        # become reusable across read files with nearby max lengths --
        # with the persistent compilation cache this makes warm CLI runs
        # skip XLA compilation entirely
        lpad = ((max(batch.max_len, k) + 31) // 32) * 32
        b = batch_size
        if mesh is not None:
            n_shards = mesh.shape["data"]
            b = ((b + n_shards - 1) // n_shards) * n_shards
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P

            from shotgun_tpu.parallel.mesh import (
                align_aggregate_sharded,
                shard_read_arrays,
            )
            rep = NamedSharding(mesh, P())
            probe_tab = jax.tree.map(
                lambda a: jax.device_put(a, rep), probe_tab)
            member_dev = jax.device_put(set_member, rep)
        else:
            member_dev = jnp.asarray(set_member)
        # numpy scalars: a jnp.int32() literal compiles (and every warm
        # CLI run must LOAD) a convert_element_type program; numpy args
        # transfer without any executable
        m_t = np.int32(m)
        p_t = np.int32(p)
        mrq_t = np.int32(min_read_quality or 0)
        mkq_t = np.int32(min_kmer_quality or 0)
        mg_t = np.int32(max_genomes or 0)

        # transfer diet: codes ship 2-bit packed (unpacked on device) and
        # the quality plane ships only when a quality gate consumes it
        from shotgun_tpu.models.pipeline import fold_agg_device, init_fold_carry
        from shotgun_tpu.ops.encode import pack_codes_2bit

        use_qual = (min_read_quality is not None
                    or min_kmer_quality is not None)
        dummy_qual = np.zeros((b, 1), dtype=np.uint8)

        # single-device paths fold AggResults on device, one fetch at the
        # end (see align_stream); the store path additionally packs the
        # per-read outputs into TWO device arrays per batch, concatenated
        # on device and fetched once
        device_fold = mesh is None
        carry = (init_fold_carry(int(np.asarray(member_dev).shape[1]),
                                 start_batch=self._batch_no)
                 if device_fold else None)
        n_batches = 0
        packs = []

        # align-task superbatching: S sub-batches ship as one transfer
        # and run as ONE lax.scan dispatch with the packed per-read store
        # outputs stacked as scan ys, as in the dumpalign stream path
        sb_store = 8 if (store_reads and mesh is None and n >= 8 * b) else 1
        if sb_store > 1:
            from shotgun_tpu.models.pipeline import align_fold_superbatch

            dummy_qual_dev = None if use_qual else jnp.asarray(dummy_qual)
            group = sb_store * b
            for gstart in range(0, n, group):
                grows = min(group, n - gstart)
                codes = np.zeros((group, lpad), dtype=np.uint8)
                codes[:grows, : batch.max_len] = \
                    batch.codes[gstart: gstart + grows]
                lengths = np.zeros(group, dtype=np.int32)
                lengths[:grows] = batch.lengths[gstart: gstart + grows]
                codes_p = pack_codes_2bit(codes)
                if use_qual:
                    qual = np.zeros((group, lpad), dtype=np.uint8)
                    qual[:grows, : batch.max_len] = \
                        batch.qual[gstart: gstart + grows]
                    qual_dev = jnp.asarray(qual.reshape(sb_store, b, -1))
                else:
                    qual_dev = dummy_qual_dev
                carry, words, keys = align_fold_superbatch(
                    carry, probe_tab, member_dev,
                    jnp.asarray(codes_p.reshape(sb_store, b, -1)),
                    qual_dev,
                    jnp.asarray(lengths.reshape(sb_store, b)),
                    m_t, p_t, mrq_t, mkq_t, mg_t,
                    k=k, packed=True, store=True,
                    has_mrq=min_read_quality is not None,
                    has_mkq=min_kmer_quality is not None,
                    has_mg=max_genomes is not None,
                )
                packs.append((words.reshape(group),
                              keys.reshape(group, -1)))
                n_batches += sb_store
            import jax

            words_d = jnp.concatenate([p[0] for p in packs])
            keys_d = jnp.concatenate([p[1] for p in packs])
            words_np, keys_np = jax.device_get((words_d, keys_d))
            # groups fill contiguously: rows [0, n) ARE the reads
            self._store_packed_reads(
                words_np[:n], keys_np[:n], batch.ids, r)
            self._merge_fold_carry(jax.device_get(carry), r)
            self._batch_no += n_batches
            return

        pending = []
        for start in range(0, n, b):
            rows = min(b, n - start)
            codes = np.zeros((b, lpad), dtype=np.uint8)
            qual = np.zeros((b, lpad), dtype=np.uint8) if use_qual else dummy_qual
            lengths = np.zeros(b, dtype=np.int32)
            codes[:rows, : batch.max_len] = batch.codes[start: start + rows]
            if use_qual:
                qual[:rows, : batch.max_len] = batch.qual[start: start + rows]
            lengths[:rows] = batch.lengths[start: start + rows]
            row_valid = np.zeros(b, dtype=bool)
            row_valid[:rows] = True
            codes_p = pack_codes_2bit(codes)

            if mesh is not None:
                codes_d, qual_d, len_d, rv_d = shard_read_arrays(
                    mesh, codes_p, qual, lengths, row_valid)
                agg = align_aggregate_sharded(
                    probe_tab, member_dev,
                    codes_d, qual_d, len_d, rv_d,
                    m_t, p_t, mrq_t, mkq_t, mg_t,
                    mesh=mesh, k=k,
                    has_mrq=min_read_quality is not None,
                    has_mkq=min_kmer_quality is not None,
                    has_mg=max_genomes is not None,
                    packed=True,
                )
            else:
                res, agg = align_batch(
                    probe_tab, member_dev,
                    jnp.asarray(codes_p), jnp.asarray(qual),
                    jnp.asarray(lengths), jnp.asarray(row_valid),
                    m_t, p_t, mrq_t, mkq_t, mg_t,
                    k=k,
                    has_mrq=min_read_quality is not None,
                    has_mkq=min_kmer_quality is not None,
                    has_mg=max_genomes is not None,
                    packed=True,
                )
                carry = fold_agg_device(carry, agg)
                n_batches += 1
                if store_reads:
                    from shotgun_tpu.models.pipeline import pack_store_words

                    packs.append(pack_store_words(
                        res, max_w=lpad - k + 1))
                continue
            pending.append((agg, None, start, rows))

        if device_fold:
            import jax

            if packs:
                # device concat -> exactly TWO fetched arrays for the run
                words_d = jnp.concatenate([p[0] for p in packs])
                keys_d = jnp.concatenate([p[1] for p in packs])
                words_np, keys_np = jax.device_get((words_d, keys_d))
                # drop the tail padding of each batch (lengths-0 rows)
                sel = np.concatenate([
                    np.arange(j * b, j * b + min(b, n - j * b))
                    for j in range(n_batches)
                ]) if n else np.zeros(0, np.int64)
                self._store_packed_reads(
                    words_np[sel], keys_np[sel], batch.ids, r)
            self._merge_fold_carry(jax.device_get(carry), r)
            self._batch_no += n_batches
            return

        # mesh path: fold after all batches are dispatched with ONE bulk
        # device_get
        import jax

        pending = jax.device_get(pending)
        for agg, _res, start, rows in pending:
            self._fold_agg(agg, r)
            self._batch_no += 1

    def align_stream(
        self,
        stream,
        m: int = 1,
        p: int = 1,
        min_read_quality: Optional[int] = None,
        min_kmer_quality: Optional[int] = None,
        max_genomes: Optional[int] = None,
        batch_size: int = 1024,
        store_reads: bool = False,
    ) -> None:
        """Pipeline-parallel alignment from a ``FASTAQStream``.

        The input-pipeline overlap of SURVEY.md §2.2 (PP row): each chunk
        is filled by the native scanner directly into device-shaped
        [batch, lpad] arrays while the accelerator runs the previous
        chunk's (async-dispatched) align program.  Only O(R) aggregation
        ships back per batch (dumpalign semantics by default).

        ``store_reads=True`` (the -t align task): per-read results ride
        the same stream as packed store words (models.pipeline
        pack_store_words), ids extract in one native side pass after the
        validation completes, and the read store fills vectorized -- the
        align task gets the stream path's fill/dispatch overlap instead
        of the full string parse."""
        import jax
        import jax.numpy as jnp

        from shotgun_tpu.models.pipeline import align_batch

        if not isinstance(m, int) or not isinstance(p, int):
            raise TypeError("m and p must be ints")
        if m < 0:
            raise UserInputError("m must be bigger than or equal to 0")
        if min_read_quality is not None:
            self.filter_read_quality_flag = True
        if min_kmer_quality is not None:
            self.filter_kmer_quality_flag = True
        if max_genomes is not None:
            self.filter_max_genomes_flag = True

        ref = self.kmer_reference
        idx = ref.index
        k = idx.k
        probe_tab = ref.device_probe_tables()
        member_dev = jnp.asarray(ref.set_member_dense())
        r = idx.num_records

        b = batch_size
        if b == 0:
            b = _auto_batch(stream.est_records()
                            if hasattr(stream, "est_records") else 0)
        # numpy scalars: a jnp.int32() literal compiles (and every warm
        # CLI run must LOAD) a convert_element_type program; numpy args
        # transfer without any executable
        m_t = np.int32(m)
        p_t = np.int32(p)
        mrq_t = np.int32(min_read_quality or 0)
        mkq_t = np.int32(min_kmer_quality or 0)
        mg_t = np.int32(max_genomes or 0)

        from shotgun_tpu.io.native import LmaxExceeded
        from shotgun_tpu.models.pipeline import (
            align_fold_batch,
            align_fold_superbatch,
            fold_agg_device,
            init_fold_carry,
        )
        from shotgun_tpu.ops.encode import pack_codes_2bit

        use_qual = (min_read_quality is not None
                    or min_kmer_quality is not None)
        dummy_qual = np.zeros((b, 1), dtype=np.uint8)
        # no quality gate -> ship the zero dummy plane ONCE instead of
        # once per batch
        dummy_qual_dev = None if use_qual else jnp.asarray(dummy_qual)
        # both probe families stream through the fused one-dispatch fold.
        # Superbatching: fill S sub-batches contiguously
        # and ship them as ONE [S, b, ...] transfer + ONE lax.scan dispatch
        # -- divides the per-batch transfer and dispatch count by S while
        # the on-device batch shape stays b.  S=1 disables.  Default 8 at
        # b <= 16384, 4 at bigger b; both were tuned on the previous
        # accelerator and await an H100 A/B against S=1.
        sb_default = 8 if b <= 16384 else 4
        try:
            sb_env = int(os.environ.get("SHOTGUN_TPU_SUPERBATCH",
                                        str(sb_default)))
        except ValueError:
            # malformed env value: fall back to the default
            sb_env = sb_default
        sb = max(sb_env, 1) \
            if hasattr(stream, "chunks_packed") else 1
        if sb > 1 and hasattr(stream, "est_records"):
            # small inputs: don't pad (and compile) an S-wide scan the
            # file can't fill -- cap S at the estimated chunk count
            est_chunks = -(-stream.est_records() // b)
            sb = max(min(sb, est_chunks), 1)
        if 1 < sb < 4:
            # the lax.scan wrapper costs extra cold compile time; only
            # pay it when S is large enough to cut the dispatch count
            # meaningfully
            sb = 1

        # lazy-scan overlap: the whole-input validation scan runs on a
        # worker thread (the ctypes call releases the GIL) concurrently
        # with the fill + dispatch loop; a validation failure surfaces
        # from finish_validation and discards the run (the CLI falls back
        # to the regex engine for the reference's exact errors)
        if hasattr(stream, "start_validation"):
            stream.start_validation()

        def run_all(lpad: int):
            """One full pass at the given row stride.  Device-resident
            accumulation: per-batch AggResults fold into one donated carry
            on device, fetched ONCE after the whole stream.

            Both probe families run the FUSED one-dispatch program
            (align_fold_batch / align_fold_superbatch): one transfer +
            one dispatch per (super)batch, and XLA drops every per-read
            buffer."""
            carry = init_fold_carry(int(member_dev.shape[1]),
                                    start_batch=self._batch_no)
            n_batches = 0
            packs, gots = [], []
            if hasattr(stream, "chunks_packed"):
                # native packed fill: the host never materializes the
                # 1-byte code plane, and qual fills only when a gate
                # consumes it.  With superbatching the native fill writes
                # sb*b contiguous rows; the host reshape to [sb, b, ...]
                # is free (same buffer).  The fill runs on a producer
                # thread (the ctypes call releases the GIL) so chunk i+1
                # fills while chunk i's transfers/dispatch are in flight
                # -- without it the device queue drains during every fill
                chunk_iter = stream.chunks_packed(b * sb, lpad, use_qual)
                if os.environ.get("SHOTGUN_TPU_PREFETCH", "1") == "1":
                    chunk_iter = _prefetch_iter(chunk_iter)
            else:
                chunk_iter = (
                    (pack_codes_2bit(codes),
                     qual if use_qual else dummy_qual, lengths, got)
                    for codes, qual, lengths, got in stream.chunks(b, lpad)
                )
            has = dict(
                has_mrq=min_read_quality is not None,
                has_mkq=min_kmer_quality is not None,
                has_mg=max_genomes is not None,
            )
            zero_len = np.int32(0)  # placeholder under len_in_codes
            for codes_p, qual, lengths, got in chunk_iter:
                # one combined upload per chunk: lengths ride as 4 byte
                # columns appended to the packed codes
                combined = np.concatenate(
                    [codes_p, lengths.astype("<i4").view(np.uint8)
                     .reshape(codes_p.shape[0], 4)], axis=1)
                if sb > 1:
                    out = align_fold_superbatch(
                        carry, probe_tab, member_dev,
                        jnp.asarray(combined.reshape(sb, b, -1)),
                        (jnp.asarray(qual.reshape(sb, b, -1))
                         if use_qual else dummy_qual_dev),
                        zero_len,
                        m_t, p_t, mrq_t, mkq_t, mg_t,
                        k=k, packed=True, len_in_codes=True,
                        store=store_reads, **has,
                    )
                    if store_reads:
                        carry, words, keys = out
                        packs.append((words.reshape(sb * b),
                                      keys.reshape(sb * b, -1)))
                        gots.append(got)
                    else:
                        carry = out
                    n_batches += sb
                    continue
                if store_reads:
                    # small inputs: per-chunk two-program form with the
                    # packed store outputs collected like the superbatch
                    from shotgun_tpu.models.pipeline import (
                        pack_store_words,
                    )

                    res, agg = align_batch(
                        probe_tab, member_dev,
                        jnp.asarray(codes_p),
                        jnp.asarray(qual) if use_qual else dummy_qual_dev,
                        jnp.asarray(lengths),
                        jnp.asarray(lengths > 0),
                        m_t, p_t, mrq_t, mkq_t, mg_t,
                        k=k, packed=True, **has,
                    )
                    carry = fold_agg_device(carry, agg)
                    packs.append(pack_store_words(
                        res, max_w=lpad - k + 1))
                    gots.append(got)
                else:
                    carry = align_fold_batch(
                        carry, probe_tab, member_dev,
                        jnp.asarray(combined),
                        jnp.asarray(qual) if use_qual else dummy_qual_dev,
                        zero_len,
                        m_t, p_t, mrq_t, mkq_t, mg_t,
                        k=k, packed=True, len_in_codes=True, **has,
                    )
                n_batches += 1
            return carry, n_batches, packs, gots

        # same length bucketing as align_packed_reads: the native fill
        # writes rows at this stride, so chunks arrive device-shaped.  In
        # lazy mode max_len is a first-record peek; a longer record midway
        # restarts the pass at double the stride (rare: reads are near-
        # uniform length in practice)
        lpad = ((max(stream.max_len, k) + 31) // 32) * 32
        while True:
            try:
                carry, n_batches, packs, gots = run_all(lpad)
                break
            except LmaxExceeded:
                lpad *= 2

        if hasattr(stream, "finish_validation"):
            stream.finish_validation()  # NativeParseError discards the run
        if store_reads and packs:
            from shotgun_tpu.io import native as _native
            from shotgun_tpu.io.native import NativeParseError

            n_total = int(sum(gots))
            raw_fn = getattr(stream, "raw_bytes", None)
            ids = (_native.fastq_ids(raw_fn(), n_total)
                   if raw_fn is not None else None)
            if ids is None:
                # walker disagreed with the validated stream (should not
                # happen): discard the run, caller re-parses exactly
                raise NativeParseError(_native.STATUS_NON_ASCII, 0, 0)
            words_d = jnp.concatenate([p[0] for p in packs])
            keys_d = jnp.concatenate([p[1] for p in packs])
            words_np, keys_np = jax.device_get((words_d, keys_d))
            stride = packs[0][0].shape[0] if packs else 0
            sel = np.concatenate([
                np.arange(j * stride, j * stride + g)
                for j, g in enumerate(gots)
            ]) if gots else np.zeros(0, np.int64)
            self._store_packed_reads(
                words_np[sel], keys_np[sel], ids, r)
        self._merge_fold_carry(jax.device_get(carry), r)
        self._batch_no += n_batches

    def _merge_fold_carry(self, carry, r: int) -> None:
        """Fold a fetched device FoldCarry (models.pipeline.FoldCarry as
        numpy arrays) into the host totals -- the one-fetch-per-run
        counterpart of per-batch ``_fold_agg``."""
        cnt = [int(x) for x in np.asarray(carry.counters)]
        self._n_unique += cnt[0]
        self._n_ambiguous += cnt[1]
        self._n_unmapped += cnt[2]
        if self.filter_read_quality_flag:
            self.filtered_quality_reads += cnt[3]
        if self.filter_kmer_quality_flag:
            self.filtered_quality_kmers += cnt[4]
        if self.filter_max_genomes_flag:
            self.filtered_hr_kmers += cnt[5]
        self._unique_by_rec += np.asarray(carry.unique_by_rec, dtype=np.int64)[:r]
        self._amb_by_rec += np.asarray(carry.amb_by_rec, dtype=np.int64)[:r]
        fb = np.asarray(carry.first_batch, dtype=np.int64)[:r]
        fk = np.asarray(carry.first_key, dtype=np.int64)[:r]
        fresh = (fb < int(0x7FFFFFFF)) & (self._first_batch == _INF)
        self._first_batch[fresh] = fb[fresh]
        self._first_key[fresh] = fk[fresh]

    def _fold_agg(self, agg, r: int) -> None:
        self._n_unique += int(agg.n_unique)
        self._n_ambiguous += int(agg.n_ambiguous)
        self._n_unmapped += int(agg.n_unmapped)
        if self.filter_read_quality_flag:
            self.filtered_quality_reads += int(agg.n_filtered_reads)
        if self.filter_kmer_quality_flag:
            self.filtered_quality_kmers += int(agg.n_filtered_kmers)
        if self.filter_max_genomes_flag:
            self.filtered_hr_kmers += int(agg.n_hr_kmers)
        self._unique_by_rec += np.asarray(agg.unique_by_rec, dtype=np.int64)[:r]
        self._amb_by_rec += np.asarray(agg.amb_by_rec, dtype=np.int64)[:r]
        key = np.asarray(agg.first_key, dtype=np.int64)[:r]
        fresh = (key < int(0x3FFFFFFF)) & (self._first_batch == _INF)
        self._first_batch[fresh] = self._batch_no
        self._first_key[fresh] = key[fresh]

    def _store_packed_reads(
        self, word: np.ndarray, keys: np.ndarray, ids: Sequence[str],
        r: int,
    ) -> None:
        """Unpack the device store words (models.pipeline.pack_store_words)
        for a whole align run and extend the read store -- vectorized
        except the rare duplicate-id error walk."""
        rows = word.size
        mtype = word & 3
        downgraded = ((word >> 2) & 1).astype(bool)
        filtered = ((word >> 3) & 1).astype(bool)
        winner = word >> 4

        # sentinel depends on the key dtype (int16 when window counts
        # fit -- pipeline.pack_store_words)
        sent = (int(np.iinfo(np.int16).max) if keys.dtype == np.int16
                else int(0x3FFFFFFF))
        in_list = keys[:, :r] < sent
        r_iota = np.arange(r, dtype=np.int64)[None, :]
        key = np.where(in_list, keys[:, :r].astype(np.int64) * r + r_iota,
                       _INF)
        ar = np.arange(rows)
        key[ar, winner] = np.where(downgraded, -1, key[ar, winner])
        order = np.argsort(key, axis=1, kind="stable")
        in_sorted = np.take_along_axis(in_list, order, axis=1)

        # one row-major boolean select yields every read's mapping list
        # (sorted-key order within each row) concatenated; the store
        # keeps the whole-batch BLOCK (``_list_flat`` is only ever
        # concatenated -- save(), load(), summary never index per read),
        # so no np.split into 500k+ per-read views on the hot path
        in_sorted &= ~filtered[:, None]
        counts = in_sorted.sum(axis=1)
        flat_all = order[in_sorted]

        # bulk duplicate-id check: set ops instead of a per-read probe --
        # the slow per-read walk runs only to name the offending id
        # (reference semantics: raise at the FIRST duplicate, earlier
        # reads of the batch stay added, kmer.py:551-561)
        kept_idx = np.nonzero(~filtered)[0]
        kept_ids = ([ids[i] for i in kept_idx] if filtered.any()
                    else list(ids[:rows]))
        new_ids = set(kept_ids)
        if len(new_ids) != len(kept_ids) or not new_ids.isdisjoint(
                self._seen_ids):
            # rare error path: materialize per-read views only here
            splits = np.split(flat_all, np.cumsum(counts)[:-1])
            for i, rid in zip(kept_idx, kept_ids):
                if rid in self._seen_ids:
                    raise AddingExistingRead(
                        "There already exists a read with identifier: "
                        f"{rid}")
                self._seen_ids.add(rid)
                self._read_ids.append(rid)
                self._mtypes.append(int(mtype[i]))
                self._list_flat.append(splits[i])
                self._list_counts.append(int(counts[i]))
            raise AssertionError("duplicate detected by set check but "
                                 "not found in walk")
        self._seen_ids |= new_ids
        self._read_ids.extend(kept_ids)
        # filtered rows contribute zero elements to flat_all (their
        # in_sorted row is all-False), so the block concatenation equals
        # the per-read-view concatenation either way
        self._list_flat.append(flat_all)
        if filtered.any():
            keep = ~filtered
            self._mtypes.extend(mtype[keep].tolist())
            self._list_counts.extend(counts[keep].tolist())
        else:
            self._mtypes.extend(mtype.tolist())
            self._list_counts.extend(counts.tolist())

    # -- summary (reference kmer.py:622-657) --------------------------------

    def get_summary(self) -> Dict[str, Any]:
        stats: Dict[str, int] = {
            "unique_mapped_reads": self._n_unique,
            "ambiguous_mapped_reads": self._n_ambiguous,
            "unmapped_reads": self._n_unmapped,
        }
        if self.filter_read_quality_flag:
            stats["filtered_quality_reads"] = self.filtered_quality_reads
        if self.filter_kmer_quality_flag:
            stats["filtered_quality_kmers"] = self.filtered_quality_kmers
        if self.filter_max_genomes_flag:
            stats["filtered_hr_kmers"] = self.filtered_hr_kmers

        descs = self.kmer_reference.index.descriptions
        order = np.lexsort((self._first_key, self._first_batch))
        genome_mapping: Dict[str, Dict[str, int]] = {}
        for rec in order:
            if self._first_batch[rec] == _INF:
                continue
            desc = descs[rec]
            entry = genome_mapping.setdefault(
                desc, {"unique_reads": 0, "ambiguous_reads": 0}
            )
            entry["unique_reads"] += int(self._unique_by_rec[rec])
            entry["ambiguous_reads"] += int(self._amb_by_rec[rec])
        return {"Statistics": stats, "Summary": genome_mapping}

    def get_reads_by_mapping_type(self, mapping_type: ReadMappingType) -> List[str]:
        code = _CODE_FROM_MTYPE[mapping_type]
        return [
            rid for rid, c in zip(self._read_ids, self._mtypes) if c == code
        ]

    def export_summary_to_json(self, json_file: str) -> None:
        with open(json_file, "w") as fh:
            json.dump(self.get_summary(), fh, indent=4)

    def __repr__(self) -> str:
        return json.dumps(self.get_summary(), indent=4)

    # -- persistence (.aln) --------------------------------------------------

    def save(self, align_file: str) -> None:
        buf = io.BytesIO()
        self.kmer_reference.save_to(buf)
        flat = (
            np.concatenate(self._list_flat)
            if self._list_flat else np.zeros(0, dtype=np.int64)
        )
        offsets = np.concatenate(
            [[0], np.cumsum(np.asarray(self._list_counts, dtype=np.int64))]
        )
        meta = {
            "format": "shotgun-tpu-aln",
            "version": 1,
            "flags": [
                self.filter_read_quality_flag,
                self.filter_kmer_quality_flag,
                self.filter_max_genomes_flag,
            ],
            "counters": [
                self._n_unique, self._n_ambiguous, self._n_unmapped,
                self.filtered_quality_reads, self.filtered_quality_kmers,
                self.filtered_hr_kmers, self._batch_no,
            ],
        }
        with open(align_file, "wb") as fh:
            np.savez(  # uncompressed: see KmerReference.save_to
                fh,
                meta=np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8),
                read_ids=np.frombuffer(
                    "\n".join(self._read_ids).encode("utf-8"), dtype=np.uint8
                ),
                mtypes=np.asarray(self._mtypes, dtype=np.int32),
                list_flat=flat,
                list_offsets=offsets,
                unique_by_rec=self._unique_by_rec,
                amb_by_rec=self._amb_by_rec,
                first_batch=self._first_batch,
                first_key=self._first_key,
                kdb=np.frombuffer(buf.getvalue(), dtype=np.uint8),
            )

    @classmethod
    def load(cls, align_file: str) -> "PseudoAlignment":
        try:
            with np.load(align_file, allow_pickle=False) as data:
                meta = json.loads(bytes(data["meta"]).decode("utf-8"))
                if meta.get("format") != "shotgun-tpu-aln":
                    raise KDBFormatError("not a shotgun-tpu aln file")
                kdb_bytes = bytes(data["kdb"])
                ref = KmerReference.load(io.BytesIO(kdb_bytes))
                out = cls(ref)
                ids_blob = bytes(data["read_ids"]).decode("utf-8")
                out._read_ids = ids_blob.split("\n") if ids_blob else []
                out._mtypes = data["mtypes"].tolist()
                offsets = data["list_offsets"]
                flat = data["list_flat"]
                # one block: _list_flat is only ever concatenated
                out._list_flat = [flat] if flat.size else []
                out._list_counts = np.diff(offsets).tolist()
                out._seen_ids = set(out._read_ids)
                out._unique_by_rec = data["unique_by_rec"]
                out._amb_by_rec = data["amb_by_rec"]
                out._first_batch = data["first_batch"]
                out._first_key = data["first_key"]
                (out._n_unique, out._n_ambiguous, out._n_unmapped,
                 out.filtered_quality_reads, out.filtered_quality_kmers,
                 out.filtered_hr_kmers, out._batch_no) = meta["counters"]
                (out.filter_read_quality_flag, out.filter_kmer_quality_flag,
                 out.filter_max_genomes_flag) = meta["flags"]
                return out
        except KDBFormatError:
            raise
        except Exception as exc:
            raise KDBFormatError(f"cannot read alignment file: {exc}") from exc
