"""Large genome-count classification: the chunk-scan set reduction.

An early pipeline unrolled the set-table
reduction (compile blow-up past ~1k sets) and fell back to a [B, W, R]
gather (OOM at thousands of genomes).  These tests build a G=4096-genome
reference whose set table is wide enough to force the lax.scan path and
check the device pipeline end-to-end against the independent dict oracle.
"""

import random

import numpy as np
import pytest

from oracle_model import align_read, build_db, summarize

from shotgun_tpu.io.packing import pack_reads
from shotgun_tpu.io.records import SeqRecord
from shotgun_tpu.aligner import PseudoAlignment
from shotgun_tpu.reference import KmerReference

K = 31
G = 4096


def _fasta_records(genomes):
    return [
        SeqRecord(
            [("description", d), ("genome", s)])
        for d, s in genomes
    ]


def _read_records(reads):
    return [
        SeqRecord(
            [
                ("identifier", f"r{i}"),
                ("sequence", seq),
                ("space", ""),
                ("quality_sequence", qual),
            ])
        for i, (seq, qual) in enumerate(reads)
    ]


@pytest.fixture(scope="module")
def big_corpus():
    rng = random.Random(4242)
    bases = "ACGT"
    # a shared 31-mer between neighbor pairs adds non-singleton sets on
    # top of the ~G singleton sets, so S > G > 1024 -> scan path
    shared = "".join(rng.choice(bases) for _ in range(K))
    genomes = []
    for g in range(G):
        seq = "".join(rng.choice(bases) for _ in range(50))
        if g % 7 == 0:
            seq = seq[:10] + shared + seq[10 + K:]
        genomes.append((f"g{g}", seq))

    reads = []
    n_reads = 8192
    for i in range(n_reads):
        kind = i % 4
        if kind in (0, 1):  # clean substring of one genome -> unique-ish
            src = genomes[rng.randrange(G)][1]
            reads.append(src)
        elif kind == 2:  # chimera of two genome halves -> mixed evidence
            a = genomes[rng.randrange(G)][1]
            b = genomes[rng.randrange(G)][1]
            reads.append(a[:25] + b[25:])
        else:  # random -> almost surely unmapped
            reads.append("".join(rng.choice(bases) for _ in range(50)))
    reads = [(s, "I" * len(s)) for s in reads]
    return genomes, reads


def test_scan_path_matches_oracle_at_4096_genomes(big_corpus):
    genomes, reads = big_corpus
    ref = KmerReference(K, _fasta_records(genomes))
    idx = ref.index
    assert idx.num_records == G
    # wide set table: must exceed the unrolled-chunk budget (16 * 64)
    from shotgun_tpu.models.pipeline import SET_CHUNK, SET_UNROLL_CHUNKS

    assert idx.num_sets > SET_CHUNK * SET_UNROLL_CHUNKS

    aln = PseudoAlignment(ref)
    aln.align_packed_reads(
        pack_reads(_read_records(reads)),
        m=1,
        p=1,
        batch_size=1024,
        store_reads=False,
    )

    db = build_db(genomes, K)
    results = []
    for seq, qual in reads:
        outcome, glist, _, _ = align_read(db, seq, qual, K, m=1, p=1)
        results.append((outcome, glist))
    expected = summarize(genomes, results, (False, False, False), (0, 0, 0))

    got = aln.get_summary()
    assert got["Statistics"] == expected["Statistics"]
    assert got["Summary"] == expected["Summary"]
    # sanity: the corpus actually exercises every outcome class
    assert expected["Statistics"]["unique_mapped_reads"] > 0
    assert expected["Statistics"]["ambiguous_mapped_reads"] > 0
    assert expected["Statistics"]["unmapped_reads"] > 0


def test_extsim_device_matrix_matches_host_at_4096_genomes(big_corpus, monkeypatch):
    """EXTSIM at G=4096: the accelerator bitset-matmul overlap matrix must
    reproduce the host path (which is golden-verified vs the reference)
    bit-for-bit -- scores, keep/filter verdicts, and the filtered index."""
    import shotgun_tpu.index.extsim as extsim

    genomes, _ = big_corpus
    # add near-duplicates so the greedy filter actually drops genomes
    rng = random.Random(7)
    dup = [(f"d{i}", genomes[rng.randrange(G)][1]) for i in range(64)]
    recs = _fasta_records(genomes + dup)

    monkeypatch.setattr(extsim, "_DEVICE_MIN_G", 1 << 30)  # force host
    ref_host = KmerReference(K, recs, filter_similar=True,
                             similarity_threshold=0.75)
    monkeypatch.setattr(extsim, "_DEVICE_MIN_G", 1)        # force device
    ref_dev = KmerReference(K, recs, filter_similar=True,
                            similarity_threshold=0.75)

    assert ref_dev.similarity_info == ref_host.similarity_info
    n_filtered = sum(
        1 for v in ref_dev.similarity_info.values() if v["kept"] == "no")
    assert n_filtered >= 32  # the near-duplicates were dropped
    np.testing.assert_array_equal(ref_dev.index.kept, ref_host.index.kept)
    np.testing.assert_array_equal(
        ref_dev.index.kmer_words, ref_host.index.kmer_words)
    np.testing.assert_array_equal(
        ref_dev.index.post_record, ref_host.index.post_record)


def test_scan_path_with_filters_matches_oracle(big_corpus):
    genomes, reads = big_corpus
    # degrade some qualities so MRQ/MKQ fire, and use MG so the shared
    # k-mer (~G/7 genomes) trips the redundancy gate.  i%11: all-low ->
    # MRQ filters the read; i%5: low head, high tail -> read mean passes
    # MRQ but head windows fail MKQ
    def qual_of(i, s):
        if i % 11 == 0:
            return "5" * len(s)
        if i % 5 == 0:
            return "5" * K + "I" * (len(s) - K)
        return "I" * len(s)

    reads = [(s, qual_of(i, s)) for i, (s, _) in enumerate(reads[:2048])]
    ref = KmerReference(K, _fasta_records(genomes))
    aln = PseudoAlignment(ref)
    aln.align_packed_reads(
        pack_reads(_read_records(reads)),
        m=1,
        p=1,
        min_read_quality=60,
        min_kmer_quality=55,
        max_genomes=4,
        batch_size=1024,
        store_reads=False,
    )

    db = build_db(genomes, K)
    results, nq, nr, nf = [], 0, 0, 0
    for seq, qual in reads:
        outcome, glist, q, r = align_read(
            db, seq, qual, K, m=1, p=1,
            min_read_quality=60, min_kmer_quality=55, max_genomes=4,
        )
        if outcome == "filtered":
            nf += 1
        else:
            nq += q
            nr += r
        results.append((outcome, glist))
    expected = summarize(genomes, results, (True, True, True), (nf, nq, nr))

    got = aln.get_summary()
    assert got["Statistics"] == expected["Statistics"]
    assert got["Summary"] == expected["Summary"]
    assert expected["Statistics"]["filtered_quality_reads"] > 0
    assert expected["Statistics"]["filtered_hr_kmers"] > 0


def test_capacity_math_at_bulk_scale():
    """Table-capacity math at real-metagenomics sizes:
    shape buckets, carry-word layout, and sharding pads must all hold at
    a 100 Mbp-class DB (tens of millions of distinct k-mers) without
    silent overflow."""
    from shotgun_tpu.ops.probe_sort2 import _carry_layout
    from shotgun_tpu.reference import KmerReference

    pad = KmerReference._pad_rows
    # pow2 buckets below 16M rows, 16M-linear above; never smaller than n
    assert pad(1) == 1024
    assert pad(999_850) == 1 << 20
    assert pad(16_000_000) == 1 << 24
    assert pad(100_000_000) == -(-100_000_000 // (1 << 24)) * (1 << 24)
    for n in (1 << 20, 50_000_000, 120_000_000):
        assert pad(n) >= n

    # carry layout: rank + payload chunk must fit an int32 word for a
    # 120M-row table with a large batch and thousands of genome sets
    n_queries = 16384 * 130
    pb, gc_bits, payload_bits, n_words, gc_cap = _carry_layout(
        pad(120_000_000), n_queries, num_sets=4096, max_genome_count=512)
    assert pb >= 1 and n_words >= 1
    assert gc_cap == 512  # counts up to R are exact
    # the full payload reconstructs from n_words pb-bit chunks
    assert n_words * pb >= payload_bits

    # device memory: a 100 Mbp DB's sorted table is 16 B/key -- under
    # 2 GiB, a small share of one card with room for the batch working
    # set
    rows = pad(100_000_000)
    assert rows * 16 < 2 * 1024**3


def test_sharded_pad_at_16m_keys():
    """pad_table_for_sharding at a 16M-key table: pads are inert rows
    (max key, gc 0) and every shard gets an equal contiguous range."""
    import numpy as np

    from shotgun_tpu.parallel.table_sharded import pad_table_for_sharding

    u = 16_000_001  # deliberately not divisible by 8
    klo = np.arange(u, dtype=np.uint32)
    khi = np.zeros(u, dtype=np.uint32)
    sid = np.zeros(u, dtype=np.int32)
    gc = np.ones(u, dtype=np.int32)
    tab = pad_table_for_sharding((klo, khi, sid, gc), 8)
    up = tab.klo.shape[0]
    assert up % 8 == 0 and up >= u
    assert (np.asarray(tab.gc[u:]) == 0).all()
    assert (np.asarray(tab.klo[u:]) == np.uint32(0xFFFFFFFF)).all()


def test_auto_probe_picks_hash_for_big_tables(monkeypatch):
    """Probe auto-selection: big k<=31 tables get the 16-slot hash table
    (probe cost independent of table size -- r4 bulk proof measured the
    sort join collapsing 90x at 100M keys), small ones the sort join;
    both produce identical aggregation."""
    import jax.numpy as jnp
    import numpy as np

    from shotgun_tpu.models.pipeline import align_batch
    from shotgun_tpu.ops.probe import HashTableDev
    from shotgun_tpu.ops.probe_sort import SortedTableDev
    from shotgun_tpu.reference import KmerReference
    from shotgun_tpu.index.build import build_index
    from shotgun_tpu.ops.encode import pack_codes_2bit
    from shotgun_tpu.utils.synth import synth_genomes, synth_reads

    rng = np.random.default_rng(9)
    genomes = synth_genomes(rng, 3, 4_000)
    idx = build_index(genomes, 21)
    ref = KmerReference(21, _index=idx)
    assert isinstance(ref.device_probe_tables("auto"), SortedTableDev)

    monkeypatch.setattr(KmerReference, "AUTO_HASH_MIN_KEYS", 100)
    ref2 = KmerReference(21, _index=idx)
    tab_h = ref2.device_probe_tables("auto")
    assert isinstance(tab_h, HashTableDev)
    assert tab_h.table.shape[1] == 16  # dense big-table layout
    assert tab_h.stash.shape[0] == 64  # fixed stash shape bucket

    reads = synth_reads(rng, genomes, 64, 60)
    member = jnp.asarray(ref.set_member_dense())
    lpad = 64
    codes = np.zeros((64, lpad), dtype=np.uint8)
    codes[:, :60] = reads.codes
    cp = jnp.asarray(pack_codes_2bit(codes))
    qd = jnp.asarray(np.zeros((64, 1), np.uint8))
    ld = jnp.asarray(reads.lengths)
    rv = jnp.asarray(np.ones(64, bool))
    one, z = jnp.int32(1), jnp.int32(0)
    kw = dict(k=21, has_mrq=False, has_mkq=False, has_mg=False,
              packed=True, with_aggregate=True)
    _, a_sort = align_batch(ref.device_probe_tables("sort"), member,
                            cp, qd, ld, rv, one, one, z, z, z, **kw)
    _, a_hash = align_batch(tab_h, member, cp, qd, ld, rv,
                            one, one, z, z, z, **kw)
    assert int(a_sort.n_unique) == int(a_hash.n_unique)
    assert int(a_sort.n_ambiguous) == int(a_hash.n_ambiguous)
    assert int(a_sort.n_unmapped) == int(a_hash.n_unmapped)
    np.testing.assert_array_equal(np.asarray(a_sort.unique_by_rec),
                                  np.asarray(a_hash.unique_by_rec))
    np.testing.assert_array_equal(np.asarray(a_sort.first_key),
                                  np.asarray(a_hash.first_key))
