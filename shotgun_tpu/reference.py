"""Public ``KmerReference``: the k-mer reference database facade.

API-compatible with the reference's class of the same name
(reference kmer.py:109-351): build from a FASTA container, optional EXTSIM
filtering, string-keyed lookup, dumpref summary with exact dict orders,
and save/load.  Internally everything is the array index of index/build.py
plus a lazily-built device probe table.

The on-disk ``.kdb`` container is an npz of the index arrays with a JSON
metadata header -- same CLI role as the reference's gzipped pickle
(reference kmer.py:265-282), but a portable, pickle-free format.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional, Set

import numpy as np

from shotgun_tpu import constants
from shotgun_tpu.errors import UserInputError
from shotgun_tpu.index.build import (
    KmerIndex,
    build_index,
    num_key_words,
    sort_keys_from_words,
)
from shotgun_tpu.index.extsim import apply_similarity_filter
from shotgun_tpu.index.hashtable import ProbeTable, build_probe_table
from shotgun_tpu.io.packing import pack_genomes
from shotgun_tpu.io.records import SeqRecord


class KDBFormatError(Exception):
    """Raised when a .kdb/.aln container cannot be read (CLI maps this to
    the reference's 'Error: Incorrect format of input file.' message)."""


def reverse_complement(seq: str) -> str:
    """Reverse complement of a nucleotide string (reference kmer.py:96-103)."""
    return seq.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def extract_kmers_from_genome(k: int, genome: str):
    """Iterate (position, k-mer) windows (reference kmer.py:84-94)."""
    if k > len(genome) or k <= 0:
        return iter([])
    return ((i, genome[i: i + k]) for i in range(len(genome) - k + 1))


_BASE_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)


def _decode_kmer_strings(words: np.ndarray, k: int) -> List[str]:
    """[C, nw] key-word rows -> k-mer strings, vectorized over rows.

    Inverse of index.build.rolling_encode_words' layout: word j holds
    window bases t in [k-16(j+1), k-16j), leftmost base in the most-
    significant bits.  O(k) vector passes over the chunk instead of
    get_summary's per-k-mer ``decode_kmer_words`` Python loop."""
    c = words.shape[0]
    out = np.empty((c, k), dtype=np.uint8)
    for j in range(words.shape[1]):
        t_hi = k - 16 * j
        if t_hi <= 0:
            break
        t_lo = max(t_hi - 16, 0)
        wcol = words[:, j]
        for t in range(t_lo, t_hi):
            shift = np.uint32(2 * (t_hi - 1 - t))
            out[:, t] = ((wcol >> shift) & np.uint32(3)).astype(np.uint8)
    ascii_rows = np.ascontiguousarray(_BASE_ASCII[out])
    return np.char.decode(ascii_rows.view(f"S{k}").reshape(-1),
                          "ascii").tolist()


class _DeviceIndexStub:
    """Minimal index facade for a device-built reference: the align and
    summary paths need only scalar metadata (k, record descriptions and
    lengths); the key-shaped arrays live on device inside the probe
    table.  Anything that needs host k-mer arrays raises."""

    def __init__(self, k, descriptions, record_lengths, num_kmers,
                 num_sets):
        self.k = k
        self.descriptions = descriptions
        self.record_lengths = record_lengths
        self.kept = np.ones(len(descriptions), dtype=bool)
        self.num_kmers = num_kmers
        self.num_sets = num_sets
        self.similarity_info = None

    @property
    def num_records(self) -> int:
        return len(self.descriptions)

    def __getattr__(self, name):
        raise AttributeError(
            f"device-built reference has no host index array '{name}'; "
            "rebuild with the host builder (KmerReference(k, container)) "
            "for dumpref/EXTSIM/.kdb workflows"
        )


class KmerReference:
    def __init__(
        self,
        k: int,
        fasta_record_container: Optional[Iterable[SeqRecord]] = None,
        filter_similar: bool = False,
        similarity_threshold: float = 0.95,
        _index: Optional[KmerIndex] = None,
    ) -> None:
        if filter_similar and not (0 <= similarity_threshold <= 1):
            raise UserInputError("similarity_threshold must be between 0 and 1")
        self._container = None
        if _index is not None:
            self.index = _index
        else:
            if hasattr(fasta_record_container, "to_genome_arrays"):
                # native/array-backed container: no string round-trip
                genomes = fasta_record_container.to_genome_arrays()
                self._container = fasta_record_container
                self._records: Optional[List[SeqRecord]] = None
            else:
                records = list(fasta_record_container)
                genomes = pack_genomes(records)
                self._records = records
            self.index = build_index(genomes, k)
            if filter_similar:
                self.index = apply_similarity_filter(self.index, similarity_threshold)
        if not hasattr(self, "_records"):
            self._records = None
        self._probe_table: Optional[ProbeTable] = None
        self._set_member_dense: Optional[np.ndarray] = None
        # method -> device probe structure; index is immutable after
        # construction (EXTSIM runs inside __init__), so no invalidation
        self._device_tables: dict = {}

    @classmethod
    def from_device_build(cls, genomes, k: int) -> Optional["KmerReference"]:
        """Reference whose probe tables were built ON DEVICE
        (index.device_build) -- the postings-free dumpalign fast path.

        The returned object aligns and summarizes identically to a
        host-built reference (tested), but has no host k-mer arrays:
        dumpref-style enumeration, string lookup, EXTSIM and .kdb save
        raise.  Returns None when the device build does not support the
        input (k > 31, more than index.device_build.R_CAP records, or
        past the multi-set caps) -- callers fall back to the host
        builder."""
        from shotgun_tpu.index.device_build import device_build_tables

        built = device_build_tables(genomes, k, cls._pad_rows)
        if built is None:
            return None
        import jax.numpy as jnp

        from shotgun_tpu.ops.probe_sort import SortedTableDev

        self = cls.__new__(cls)
        self._container = None
        self._records = None
        self._probe_table = None
        self.index = _DeviceIndexStub(
            k=k,
            descriptions=list(genomes.descriptions),
            record_lengths=np.diff(genomes.offsets).astype(np.int64),
            num_kmers=built["num_kmers"],
            num_sets=built["num_sets"],
        )
        r = self.index.num_records
        rp = self._pad_rows(max(r, 8), lo=8)
        sp = self._pad_rows(max(built["num_sets"], 1), lo=8)
        bits = np.unpackbits(built["set_masks"], axis=1, bitorder="little")
        dense = np.zeros((sp, rp), dtype=np.uint8)
        if built["num_sets"]:
            dense[: built["num_sets"], :r] = bits[:, :r]
        self._set_member_dense = dense
        self._device_tables = {
            "sort": SortedTableDev(
                klo=built["klo"], khi=built["khi"],
                sid=built["sid"], gc=built["gc"],
            )
        }
        # keep the device build products for the lazy hash-table assembly
        # (device_probe_tables builds it on first use above the auto
        # threshold; building eagerly would charge align-side work to
        # every build, including builds that never align)
        self._built_dev = built
        return self

    # ------------------------------------------------------------------
    # reference-parity accessors
    # ------------------------------------------------------------------

    @property
    def kmer_len(self) -> int:
        return self.index.k

    @property
    def similarity_info(self) -> Optional[Dict[str, Dict[str, Any]]]:
        return self.index.similarity_info

    @property
    def genomes(self) -> List[SeqRecord]:
        """Kept genome records, input order (reference kmer.py:245-250)."""
        recs = self._materialized_records()
        return [recs[r] for r in range(self.index.num_records) if self.index.kept[r]]

    def _materialized_records(self) -> List[SeqRecord]:
        if self._records is None:
            if self._container is not None:
                self._records = list(self._container.records)
            else:
                # reconstructed from a .kdb: genome strings are not retained
                self._records = [
                    SeqRecord([("description", d), ("genome", "")])
                    for d in self.index.descriptions
                ]
        return self._records

    def _encode_query(self, kmer: str) -> Optional[int]:
        """k-mer string -> k-mer id, or None on miss/invalid."""
        if len(kmer) != self.index.k:
            return None
        raw = np.frombuffer(kmer.encode("ascii", errors="replace"), dtype=np.uint8)
        codes = constants.BASE_CODE_LUT[raw]
        if (codes >= constants.BASE_N).any():
            return None
        val = 0
        for c in codes:
            val = (val << 2) | int(c)
        nw = num_key_words(self.index.k)
        qwords = np.asarray(
            [(val >> (32 * j)) & 0xFFFFFFFF for j in range(nw)], dtype=np.uint32
        )[None, :]
        key = sort_keys_from_words(qwords)[0]
        keys = self.index.sort_keys()
        pos = int(np.searchsorted(keys, key))
        if pos < keys.size and keys[pos] == key:
            return pos
        return None

    def __getitem__(self, kmer: str) -> Optional[Dict[SeqRecord, Set[int]]]:
        kid = self._encode_query(kmer)
        if kid is None:
            return None
        return self._kmer_mapping(kid)

    def get_kmer_references(self, kmer: str) -> Dict[SeqRecord, Set[int]]:
        kid = self._encode_query(kmer)
        return {} if kid is None else self._kmer_mapping(kid)

    def _kmer_mapping(self, kid: int) -> Dict[SeqRecord, Set[int]]:
        recs = self._materialized_records()
        out: Dict[SeqRecord, Set[int]] = {}
        for r in self.index.records_of_kmer(kid):
            out[recs[r]] = set(int(x) for x in self.index.positions_of(kid, r))
        return out

    def get_kmer_and_reverse_references(self, kmer: str) -> Dict[SeqRecord, Set[int]]:
        """Merged references of a k-mer and its reverse complement
        (reference kmer.py:331-351; default-off EXT functionality)."""
        result: Dict[SeqRecord, Set[int]] = {}
        for rec, positions in self.get_kmer_references(kmer).items():
            result[rec] = set(positions)
        rev = reverse_complement(kmer)
        if rev != kmer:
            for rec, positions in self.get_kmer_references(rev).items():
                if rec in result:
                    result[rec].update(positions)
                else:
                    result[rec] = set(positions)
        return result

    # ------------------------------------------------------------------
    # dumpref summary (exact dict orders; reference kmer.py:300-329)
    # ------------------------------------------------------------------

    def write_summary(self, fh, chunk: int = 1 << 16) -> None:
        """Stream the dumpref JSON to ``fh``, byte-identical to
        ``json.dumps(self.get_summary(), indent=4)``.

        ``get_summary`` materializes every k-mer string and the whole
        nested dict in RAM via a per-k-mer Python loop -- hours of work
        and >100 GB of JSON at the 100M-key scale this engine's bulk
        proof runs at.  This writer walks ``display_order`` in chunks:
        k-mer strings decode vectorized, CSR postings gather per chunk,
        per-genome stats accumulate in flat arrays, and each chunk's
        text writes out immediately, so peak extra memory is O(chunk).
        Replaces the loop of reference kmer.py:300-329 for the dumpref
        task; all dict-insertion orders (k-mer first-seen, per-k-mer
        record order, Summary first-encounter order, duplicate-
        description collisions) are reproduced exactly -- byte-equality
        is pinned by the recorded CLI goldens and a randomized
        differential test (tests/test_index.py).

        Size envelope: output is ~(k + 40) bytes per k-mer -- a 10M-key
        DB streams ~0.6 GB of JSON in bounded RSS; at 100M keys plan for
        ~6 GB of OUTPUT (pipe it somewhere) but flat memory here.
        """
        idx = self.index
        gc_all = np.asarray(idx.genome_counts())
        disp = idx.display_order()
        u = int(disp.size)
        r_count = idx.num_records
        # collapse duplicate descriptions exactly like dict keys do
        desc_ids: Dict[str, int] = {}
        rec2desc = np.empty(max(r_count, 1), np.int64)
        for rci, d in enumerate(idx.descriptions):
            rec2desc[rci] = desc_ids.setdefault(d, len(desc_ids))
        nd = max(len(desc_ids), 1)
        desc_json = [json.dumps(d) for d in desc_ids]  # insertion order
        uniq_d = np.zeros(nd, np.int64)
        tot_d = np.zeros(nd, np.int64)
        last_rec_d = np.full(nd, -1, np.int64)
        first_pair_d = np.full(nd, np.iinfo(np.int64).max, np.int64)
        pair_counter = 0

        w = fh.write
        w('{\n    "Kmers": {')
        first_entry = True
        for c0 in range(0, u, chunk):
            kids = disp[c0: c0 + chunk]
            starts = idx.post_offsets[kids].astype(np.int64)
            lens = (idx.post_offsets[kids + 1] - starts).astype(np.int64)
            total = int(lens.sum())
            # flat posting gather: one index vector instead of per-kid
            # slicing (postings of a kid are contiguous; within a kid
            # they are (record asc, position asc) by construction)
            step = np.ones(total, np.int64)
            step[0] = 0
            cs = np.cumsum(lens)[:-1]
            step[cs] = starts[1:] - (starts[:-1] + lens[:-1] - 1)
            flat_idx = np.cumsum(step) + starts[0]
            recs = idx.post_record[flat_idx].astype(np.int64)
            poss = idx.post_pos[flat_idx]
            kid_local = np.repeat(np.arange(kids.size, dtype=np.int64),
                                  lens)
            newrec = np.empty(total, bool)
            newrec[0] = True
            newrec[1:] = ((kid_local[1:] != kid_local[:-1])
                          | (recs[1:] != recs[:-1]))
            b_idx = np.flatnonzero(newrec)
            seg_end = np.append(b_idx[1:], total)
            b_kid = kid_local[b_idx]
            b_rec = recs[b_idx]
            b_desc = rec2desc[b_rec]
            # per-genome stats over distinct (kid, desc) pairs
            ukey = np.unique(b_kid * np.int64(nd) + b_desc)
            ud = ukey % nd
            spec = gc_all[kids[(ukey // nd)]] == 1
            tot_d += np.bincount(ud, minlength=nd)
            uniq_d += np.bincount(ud[spec], minlength=nd)
            last_rec_d[b_desc] = b_rec  # fancy assign: last writer wins
            np.minimum.at(first_pair_d, b_desc,
                          pair_counter + np.arange(b_idx.size))
            pair_counter += int(b_idx.size)

            kstrs = _decode_kmer_strings(idx.kmer_words[kids], idx.k)
            # per-kid boundary ranges (b_kid is nondecreasing)
            b_start = np.searchsorted(b_kid, np.arange(kids.size + 1))
            pos_l = poss.tolist()
            parts: List[str] = []
            ap = parts.append
            for i in range(kids.size):
                ap("," if not first_entry else "")
                first_entry = False
                ap('\n        "')
                ap(kstrs[i])
                ap('": {')
                bs, be = int(b_start[i]), int(b_start[i + 1])
                if be - bs == 1:
                    # single record (the common case)
                    j = bs
                    ap('\n            ')
                    ap(desc_json[b_desc[j]])
                    ap(': [\n                ')
                    ap(",\n                ".join(
                        map(str, pos_l[b_idx[j]: seg_end[j]])))
                    ap('\n            ]\n        }')
                else:
                    # multiple records; duplicate descriptions keep the
                    # FIRST slot but the LAST record's positions
                    inner: Dict[int, str] = {}
                    for j in range(bs, be):
                        body = (
                            '[\n                '
                            + ",\n                ".join(
                                map(str, pos_l[b_idx[j]: seg_end[j]]))
                            + '\n            ]')
                        inner[int(b_desc[j])] = body
                    ap('\n            ')
                    ap(',\n            '.join(
                        f'{desc_json[di]}: {body}'
                        for di, body in inner.items()))
                    ap('\n        }')
            w("".join(parts))
        w('\n    }' if not first_entry else '}')

        # Summary: genomes in first-encounter order over the k-mer walk
        live = np.flatnonzero(first_pair_d < np.iinfo(np.int64).max)
        order = live[np.argsort(first_pair_d[live], kind="stable")]
        rl = np.asarray(idx.record_lengths)
        summary = {
            list(desc_ids)[di]: {
                "total_bases": int(rl[last_rec_d[di]]),
                "unique_kmers": int(uniq_d[di]),
                "multi_mapping_kmers": int(tot_d[di] - uniq_d[di]),
            }
            for di in order
        }
        w(',\n    "Summary": ')
        w(json.dumps(summary, indent=4).replace("\n", "\n    "))
        if idx.similarity_info is not None:
            w(',\n    "Similarity": ')
            w(json.dumps(idx.similarity_info, indent=4)
              .replace("\n", "\n    "))
        w("\n}")

    def get_summary(self) -> Dict[str, Any]:
        idx = self.index
        genome_counts = idx.genome_counts()
        kmer_details: Dict[str, Dict[str, List[int]]] = {}
        genome_summary: Dict[str, Dict[str, int]] = {}
        genome_kmer_sets: Dict[str, Set[int]] = {}
        for kid in idx.display_order():
            kid = int(kid)
            inner: Dict[str, List[int]] = {}
            for r in idx.records_of_kmer(kid):
                desc = idx.descriptions[r]
                inner[desc] = sorted(int(x) for x in idx.positions_of(kid, r))
                entry = genome_summary.setdefault(
                    desc,
                    {"total_bases": 0, "unique_kmers": 0, "multi_mapping_kmers": 0},
                )
                entry["total_bases"] = int(idx.record_lengths[r])
                genome_kmer_sets.setdefault(desc, set()).add(kid)
            kmer_details[idx.kmer_string(kid)] = inner
        for desc, kset in genome_kmer_sets.items():
            unique = sum(1 for kid in kset if genome_counts[kid] == 1)
            genome_summary[desc]["unique_kmers"] = unique
            genome_summary[desc]["multi_mapping_kmers"] = len(kset) - unique
        summary: Dict[str, Any] = {"Kmers": kmer_details, "Summary": genome_summary}
        if idx.similarity_info is not None:
            summary["Similarity"] = idx.similarity_info
        return summary

    # ------------------------------------------------------------------
    # persistence (.kdb)
    # ------------------------------------------------------------------

    def save(self, ref_file) -> None:
        """Write the .kdb container to a path or binary file object."""
        if hasattr(ref_file, "write"):
            self.save_to(ref_file)
            return
        with open(ref_file, "wb") as fh:
            self.save_to(fh)

    def save_to(self, fh) -> None:
        idx = self.index
        meta = {
            "format": "shotgun-tpu-kdb",
            "version": 2,
            "k": idx.k,
            "descriptions": idx.descriptions,
            "similarity_info": idx.similarity_info,
        }
        # uncompressed npz: the key arrays are high-entropy 2-bit packs
        # that deflate barely touches, while compression costs seconds at
        # realistic DB sizes (np.load reads either)
        np.savez(
            fh,
            meta=np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8),
            record_lengths=idx.record_lengths,
            kept=idx.kept,
            kmer_words=idx.kmer_words,
            first_seen=idx.first_seen,
            post_offsets=idx.post_offsets,
            post_record=idx.post_record,
            post_pos=idx.post_pos,
            set_id=idx.set_id,
            set_masks=idx.set_masks,
            set_sizes=idx.set_sizes,
        )

    @classmethod
    def load(cls, ref_file: str) -> "KmerReference":
        idx = cls._load_index(ref_file)
        return cls(idx.k, _index=idx)

    @staticmethod
    def _load_index(ref_file: str) -> KmerIndex:
        try:
            with np.load(ref_file, allow_pickle=False) as data:
                meta = json.loads(bytes(data["meta"]).decode("utf-8"))
                if meta.get("format") != "shotgun-tpu-kdb":
                    raise KDBFormatError("not a shotgun-tpu kdb file")
                if "kmer_words" in data:
                    kmer_words = data["kmer_words"]
                else:  # version-1 container: (lo, hi) columns
                    kmer_words = np.stack(
                        [data["kmer_lo"], data["kmer_hi"]], axis=1)
                return KmerIndex(
                    k=int(meta["k"]),
                    descriptions=list(meta["descriptions"]),
                    record_lengths=data["record_lengths"],
                    kept=data["kept"],
                    kmer_words=kmer_words,
                    first_seen=data["first_seen"],
                    post_offsets=data["post_offsets"],
                    post_record=data["post_record"],
                    post_pos=data["post_pos"],
                    set_id=data["set_id"],
                    set_masks=data["set_masks"],
                    set_sizes=data["set_sizes"],
                    similarity_info=meta.get("similarity_info"),
                )
        except KDBFormatError:
            raise
        except Exception as exc:  # zip/npz/json corruption
            raise KDBFormatError(f"cannot read reference file: {exc}") from exc

    # ------------------------------------------------------------------
    # device-side arrays
    # ------------------------------------------------------------------

    @staticmethod
    def _pad_rows(n: int, lo: int = 1024, linear_past: int = 1 << 24) -> int:
        """Shape bucket for device-table row counts.

        Array extents are baked into compiled XLA executables, so an
        unpadded table forces a full recompile for EVERY new reference
        DB.  Bucketing the row
        count to a power of two (linear 2^24 steps past 16M rows, keeping
        waste <= 256 MB at scale) makes executables -- and the persistent
        compile cache -- reusable across DBs of similar size."""
        n = max(int(n), lo)
        if n <= linear_past:
            return 1 << (n - 1).bit_length()
        return -(-n // linear_past) * linear_past

    #: auto probe crossover: the sort-merge join re-sorts the TABLE rows
    #: into every batch (cost grows with U + B*W), while the hash gather
    #: costs the same per query regardless of U.  The 8M-key crossover
    #: was tuned on the previous accelerator and awaits a re-measurement
    #: with a cell on each side of it.
    AUTO_HASH_MIN_KEYS = 8_000_000

    def device_probe_tables(self, method: Optional[str] = None):
        """Device probe structure for the align pipeline.

        'auto' (default): 'sort' below ``AUTO_HASH_MIN_KEYS`` distinct
        k-mers, 'hash' above (k <= 31 only -- larger k always uses the
        multi-word sorted table).  'sort': gather-free sort-merge probe,
        fastest for small/medium tables and only 16 B/key.  'hash':
        bucketized single-gather table whose probe cost is independent of
        the table size (16-slot dense layout, 64 B/key, for the auto big
        path).  ``method`` defaults to env SHOTGUN_TPU_PROBE or 'auto'."""
        import jax.numpy as jnp

        from shotgun_tpu.ops.probe import HashTableDev
        from shotgun_tpu.ops.probe_sort import (
            SortedTableDev,
            SortedTableDevW,
            sorted_table_host,
            sorted_table_host_words,
        )

        method = method or os.environ.get("SHOTGUN_TPU_PROBE", "auto")
        if method == "auto":
            big = (self.index.num_kmers > self.AUTO_HASH_MIN_KEYS
                   and self.index.k <= 31)
            if big and isinstance(self.index, _DeviceIndexStub):
                # device-built references carry no host key arrays; the
                # 16-slot hash table assembles ON DEVICE from the build
                # products, lazily on first use (the sort-join probe
                # re-sorts the whole table into every batch and collapses
                # above ~8M keys, so the one-time hash assembly pays for
                # itself within one big align batch)
                if ("hash16" not in self._device_tables
                        and "hash16_failed" not in self._device_tables):
                    from shotgun_tpu.index.device_build import (
                        device_hash_table,
                    )
                    from shotgun_tpu.ops.probe import HashTableDev

                    ht = device_hash_table(self._built_dev)
                    if ht is not None:
                        self._device_tables["hash16"] = HashTableDev(
                            table=ht[0], stash=ht[1])
                    else:
                        # negative-cache the failure (device-memory
                        # budget, stash overflow): retrying seconds of
                        # device sorts on every later align call would
                        # never succeed
                        self._device_tables["hash16_failed"] = True
                big = "hash16" in self._device_tables
            method = "hash16" if big else "sort"
        # cache per method: reference data is built once and aligned many
        # times, so the table (16 B/key -> tens of MB) uploads once
        cached = self._device_tables.get(method)
        if cached is not None:
            return cached
        if self.index.k > 31:
            if method == "hash":
                raise ValueError(
                    "the bucketized hash probe supports k <= 31 only; "
                    "use the sort-merge probe (SHOTGUN_TPU_PROBE=sort) for "
                    f"k={self.index.k}"
                )
            cols, sid, gc = sorted_table_host_words(self.index)
            # pad rows to the shape bucket: all-ones keys with gc == 0
            # (the probe's tag-3 pad contract; sorts after every real key)
            up = self._pad_rows(sid.size) - sid.size
            if up:
                ones = np.full(up, 0xFFFFFFFF, dtype=np.uint32)
                cols = tuple(np.concatenate([c, ones]) for c in cols)
                sid = np.concatenate([sid, np.zeros(up, np.int32)])
                gc = np.concatenate([gc, np.zeros(up, np.int32)])
            tab = SortedTableDevW(
                kws=tuple(jnp.asarray(c) for c in cols),
                sid=jnp.asarray(sid), gc=jnp.asarray(gc),
            )
        elif method == "sort":
            klo, khi, sid, gc = sorted_table_host(self.index)
            # pad rows to the shape bucket: (0xFFFF..., 0xFFFF...) keys
            # are unreachable by any real 62-bit k-mer (hi < 2**30) and
            # carry gc == 0 so the probe treats them as dead rows
            up = self._pad_rows(sid.size) - sid.size
            if up:
                ones = np.full(up, 0xFFFFFFFF, dtype=np.uint32)
                klo = np.concatenate([klo, ones])
                khi = np.concatenate([khi, ones])
                sid = np.concatenate([sid, np.zeros(up, np.int32)])
                gc = np.concatenate([gc, np.zeros(up, np.int32)])
            tab = SortedTableDev(
                klo=jnp.asarray(klo), khi=jnp.asarray(khi),
                sid=jnp.asarray(sid), gc=jnp.asarray(gc),
            )
        else:
            if method == "hash16":
                idx = self.index
                pt = build_probe_table(
                    idx.kmer_lo, idx.kmer_hi, idx.set_id,
                    idx.genome_counts(), slots_per_bucket=16)
            else:
                pt = self.probe_table()
            # stash rows are compared all-lanes; pad to the fixed cap with
            # unreachable all-ones keys so the executable shape is stable
            stash = pt.stash
            if stash.shape[0] < 64:
                pad = np.full((64 - stash.shape[0], 4), 0xFFFFFFFF,
                              dtype=np.uint32)
                stash = np.concatenate([stash, pad])
            tab = HashTableDev(
                table=jnp.asarray(pt.table), stash=jnp.asarray(stash)
            )
        self._device_tables[method] = tab
        return tab

    def probe_table(self) -> ProbeTable:
        if self.index.k > 31:
            raise ValueError(
                "the bucketized hash table packs keys as (lo, hi) pairs "
                f"and supports k <= 31 only (k={self.index.k})"
            )
        if self._probe_table is None:
            idx = self.index
            self._probe_table = build_probe_table(
                idx.kmer_lo, idx.kmer_hi, idx.set_id, idx.genome_counts()
            )
        return self._probe_table

    def set_member_dense(self, pad_to_multiple: int = 8) -> np.ndarray:
        """[S_padded, R_padded] uint8 record-membership matrix.

        Both extents are shape-bucketed to powers of two (min 8): they are
        baked into every align executable, and bucketing keeps compiled
        programs reusable across reference DBs (see ``_pad_rows``).  Pad
        sets are all-zero rows (never any set id's target); pad records
        accumulate nothing and the host slices aggregation back to the
        real record count."""
        if self._set_member_dense is None:
            idx = self.index
            bits = np.unpackbits(idx.set_masks, axis=1, bitorder="little")
            r = idx.num_records
            rp = self._pad_rows(max(r, pad_to_multiple), lo=pad_to_multiple)
            sp = self._pad_rows(max(idx.num_sets, 1), lo=pad_to_multiple)
            dense = np.zeros((sp, rp), dtype=np.uint8)
            if idx.num_sets:
                dense[: idx.num_sets, :r] = bits[:, :r]
            self._set_member_dense = dense
        return self._set_member_dense
