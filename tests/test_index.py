"""Index-layer tests: build correctness vs a naive dict model, EXTSIM,
hash table integrity, persistence."""

import numpy as np
import pytest

from shotgun_tpu.index.build import build_index, pack_key64, rolling_encode
from shotgun_tpu.index.hashtable import SLOTS, build_probe_table
from shotgun_tpu.io.packing import encode_bases, pack_genomes
from shotgun_tpu.io.records import FASTAParser
from shotgun_tpu.reference import KDBFormatError, KmerReference

from oracle_model import build_db


def _parse(text):
    p = FASTAParser()
    p.parse_records(text)
    return list(p)


def _genomes_of(records):
    return [(r["description"], r["genome"]) for r in records]


FASTA = (
    ">gA\nACGTACGTAACCGGTTNACGT\n"
    ">gB\nACGTACGTAAGGTTTT\n"
    ">gA\nACGTACGTA\n"  # duplicate description, distinct record
)


def test_rolling_encode_matches_strings():
    codes = encode_bases("ACGTNACGTT")
    lo, hi, valid = rolling_encode(codes, 4)
    assert lo.size == 7
    # windows containing the N at position 4 are invalid
    assert list(valid) == [True, False, False, False, False, True, True]
    # window at pos 5 = ACGT -> A=0 C=1 G=2 T=3 -> 0b00011011 = 27
    assert lo[5] == 0b00011011


def test_index_matches_dict_model():
    records = _parse(FASTA)
    idx = build_index(pack_genomes(records), 5)
    model = build_db(_genomes_of(records), 5)
    assert idx.num_kmers == len(model)
    disp = idx.display_order()
    model_kmers = list(model.keys())  # first-seen order
    for rank, kid in enumerate(disp):
        km = idx.kmer_string(int(kid))
        assert km == model_kmers[rank]
        recs = list(idx.records_of_kmer(int(kid)))
        assert recs == list(model[km].keys())
        for rec in recs:
            assert list(idx.positions_of(int(kid), rec)) == model[km][rec]
    # genome counts = number of distinct records per k-mer
    gc = idx.genome_counts()
    for kid in range(idx.num_kmers):
        km = idx.kmer_string(kid)
        assert gc[kid] == len(model[km])


@pytest.mark.parametrize("k", [1, 4, 15, 16, 17, 31])
def test_index_k_sizes(k):
    records = _parse(">g1\nACGTACGTACGTACGTACGTACGTACGTACGTACGT\n>g2\nTTTTACGTACGTACGTACGTACGTACGTACGTACGTCC\n")
    idx = build_index(pack_genomes(records), k)
    model = build_db(_genomes_of(records), k)
    assert idx.num_kmers == len(model)
    for kid in range(idx.num_kmers):
        assert idx.kmer_string(kid) in model


def test_k_larger_than_genome():
    records = _parse(">tiny\nACGT\n")
    idx = build_index(pack_genomes(records), 10)
    assert idx.num_kmers == 0


def test_probe_table_finds_every_key():
    records = _parse(FASTA)
    idx = build_index(pack_genomes(records), 5)
    pt = build_probe_table(idx.kmer_lo, idx.kmer_hi, idx.set_id,
                           idx.genome_counts())
    # every key must be present exactly once with correct payload
    flat = pt.table.reshape(-1, 4)
    occupied = flat[flat[:, 2] != np.uint32(0xFFFFFFFF)]
    assert occupied.shape[0] == idx.num_kmers
    stored = {(int(a), int(b)): (int(c), int(d)) for a, b, c, d in occupied}
    for kid in range(idx.num_kmers):
        key = (int(idx.kmer_lo[kid]), int(idx.kmer_hi[kid]))
        assert stored[key] == (int(idx.set_id[kid]), int(idx.genome_counts()[kid]))


def test_extsim_identical_genomes_filtered():
    records = _parse(">g1\nACGTACGTACGTACGT\n>g2\nACGTACGTACGTACGT\n")
    ref = KmerReference(5, records, filter_similar=True, similarity_threshold=0.9)
    info = ref.similarity_info
    kept = [g for g, i in info.items() if i["kept"] == "yes"]
    dropped = [g for g, i in info.items() if i["kept"] == "no"]
    assert len(kept) == 1 and len(dropped) == 1
    assert info[dropped[0]]["similarity_score"] == 1.0
    assert info[kept[0]]["similarity_score"] == "NA"
    assert len(ref.genomes) == 1


def test_extsim_disabled_keeps_all():
    records = _parse(">g1\nACGTACGTACGTACGT\n>g2\nACGTACGTACGTACGT\n")
    ref = KmerReference(5, records)
    assert ref.similarity_info is None
    assert len(ref.genomes) == 2


def test_extsim_threshold_validation():
    records = _parse(">g1\nACGT\n")
    with pytest.raises(ValueError):
        KmerReference(3, records, filter_similar=True, similarity_threshold=1.5)


def test_kdb_roundtrip(tmp_path):
    records = _parse(FASTA)
    ref = KmerReference(5, records)
    path = tmp_path / "db.kdb"
    ref.save(str(path))
    loaded = KmerReference.load(str(path))
    assert loaded.get_summary() == ref.get_summary()


def test_kdb_corrupt_raises(tmp_path):
    path = tmp_path / "bad.kdb"
    path.write_bytes(b"this is not a kdb file")
    with pytest.raises(KDBFormatError):
        KmerReference.load(str(path))


def test_getitem_api():
    records = _parse(">g1\nACGTACG\n")
    ref = KmerReference(3, records)
    hit = ref["ACG"]
    assert hit is not None
    (rec, positions), = hit.items()
    assert positions == {0, 4}
    assert ref["GGG"] is None
    assert ref.get_kmer_references("GGG") == {}
    assert ref["TOOLONG"] is None


def test_write_summary_streams_byte_identical():
    """The streaming dumpref writer (KmerReference.write_summary) must
    byte-match json.dumps(get_summary(), indent=4) -- including duplicate
    descriptions, genomes shorter than k, all-N genomes, EXTSIM, and
    chunk boundaries (reference kmer.py:300-329)."""
    import io
    import json as _json

    import numpy as _np

    from shotgun_tpu.io.records import FASTAParser
    from shotgun_tpu.reference import KmerReference

    rng = _np.random.default_rng(11)
    parts = []
    for i in range(30):
        seq = "".join(rng.choice(list("ACGTN"), size=int(rng.integers(3, 300)),
                                 p=[0.24, 0.24, 0.24, 0.24, 0.04]))
        parts.append(f">genome {i % 7}\n{seq}\n")
    fa = "".join(parts)
    for k, fs in ((6, False), (31, False), (40, False), (6, True)):
        c = FASTAParser()
        c.parse_records(fa)
        ref = KmerReference(k, c, filter_similar=fs,
                            similarity_threshold=0.4)
        buf = io.StringIO()
        ref.write_summary(buf, chunk=13)
        assert buf.getvalue() == _json.dumps(ref.get_summary(), indent=4)
