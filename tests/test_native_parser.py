"""Native C++ parser vs regex engine: cross-validation fuzz.

The native scanner must agree with the regex engine on every input:
same accept/reject decision, same records (ids, sequences, qualities,
descriptions, cleaned genomes), and on the CLI path the same final
exception type.  Mutations cover the grammar's edge cases: blank lines,
trailing whitespace, resync on '@'/'>' lines, illegal chars, \r\n endings,
duplicate ids, length mismatches, whitespace-only genome bodies.
"""

import random

import numpy as np

import pytest

from shotgun_tpu.io import native
from shotgun_tpu.io.records import (
    FASTAParser,
    FASTQParser,
    NoRecordsInData,
)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native parser unavailable"
)

QUALITY_CHARS = (
    r"`1234567890-=qwertyuiop[]\asdfghjkl;'zxcvbnm,./"
    r'~!@#$%^&*()_+QWERTYUIOP{}|ASDFGHJKL:"ZXCVBNM<>?'
)


def regex_fastq(text):
    p = FASTQParser()
    try:
        p.parse_records(text)
    except Exception as exc:
        return ("error", type(exc).__name__)
    return ("ok", [
        (r.identifier, r["sequence"], r["space"], r["quality_sequence"])
        for r in p
    ])


def native_fastq(text):
    try:
        res = native.fastq_parse(text.encode("utf-8"))
    except native.NativeParseError as exc:
        return ("error", exc.status)
    if res is None:
        return ("fallback", None)
    p = FASTQParser.from_native(*res)
    return ("ok", [
        (r.identifier, r["sequence"], r["space"], r["quality_sequence"])
        for r in p
    ])


def regex_fasta(text):
    p = FASTAParser()
    try:
        p.parse_records(text)
    except Exception as exc:
        return ("error", type(exc).__name__)
    return ("ok", [(r.identifier, r["genome"]) for r in p])


def native_fasta(text):
    try:
        res = native.fasta_parse(text.encode("utf-8"))
    except native.NativeParseError as exc:
        return ("error", exc.status)
    if res is None:
        return ("fallback", None)
    p = FASTAParser.from_native(*res)
    return ("ok", [(r.identifier, r["genome"]) for r in p])


def check_agree(text, kind):
    if kind == "fastq":
        ref, nat = regex_fastq(text), native_fastq(text)
    else:
        ref, nat = regex_fasta(text), native_fasta(text)
    if nat[0] == "fallback":
        return  # non-ASCII etc: regex path used either way
    if ref[0] == "error":
        assert nat[0] == "error", (
            f"regex rejected ({ref[1]}) but native accepted: {text!r}"
        )
    else:
        assert nat[0] == "ok", (
            f"regex accepted but native rejected ({nat[1]}): {text!r}"
        )
        assert nat[1] == ref[1], f"record mismatch on {text!r}"


FASTQ_SEEDS = [
    "@r1\nACGT\n+\nIIII\n",
    "@r1\nACGT\n+\nIIII\n@r2\nTTTT\n+\n!!!!\n",
    "@r1\nACGT\n+...\nIIII\n",
    "@r one  \nACGT\n+\nIIII\n",
]
FASTA_SEEDS = [
    ">g1\nACGT\n",
    ">g1\nACGT\nNNAC\n>g2\nTTTT\n",
    ">g1 desc here\nACGT\n\n>g2\nTT\n",
    ">g1\n \n>g2\nACGT\n",
]
MUTATIONS = [
    lambda s, rng: s + "\n",
    lambda s, rng: s + "\n\n",
    lambda s, rng: s + "   \n",
    lambda s, rng: s + "trailing",
    lambda s, rng: "\n" + s,
    lambda s, rng: " \n" + s,
    lambda s, rng: "garbage\n" + s,
    lambda s, rng: s.rstrip("\n"),
    lambda s, rng: s.replace("\n", "\r\n"),
    lambda s, rng: s[: rng.randrange(max(len(s), 1))],
    lambda s, rng: s[: rng.randrange(max(len(s), 1))] + s,
    lambda s, rng: s.replace("ACGT", "ACXT", 1),
    lambda s, rng: s.replace("ACGT", "AC GT", 1),
    lambda s, rng: s.replace("ACGT", "", 1),
    lambda s, rng: s.replace("IIII", "III", 1),
    lambda s, rng: s.replace("IIII", "II I", 1),
    lambda s, rng: s.replace("@r2", "@r1", 1),
    lambda s, rng: s.replace("+", "-", 1),
    lambda s, rng: s.replace("+", "+..", 1),
    lambda s, rng: s + "@x\nACGT\n+\nIIII\n",
    lambda s, rng: s + ">x\nACGT\n",
    lambda s, rng: s.replace("\n", "\n\n", 1),
    lambda s, rng: "@I\nIIII\n" + s,   # quality-lookalike resync case
    lambda s, rng: s.replace("g1", "g1\tx", 1),
    lambda s, rng: s.replace("r1", "r1 \t", 1),
    lambda s, rng: s.replace("T", "N", 1),
]


@pytest.mark.parametrize("kind,seeds", [
    ("fastq", FASTQ_SEEDS), ("fasta", FASTA_SEEDS),
])
def test_seeds_and_single_mutations(kind, seeds):
    rng = random.Random(0)
    for seed in seeds:
        check_agree(seed, kind)
        for mut in MUTATIONS:
            check_agree(mut(seed, rng), kind)


@pytest.mark.parametrize("kind", ["fastq", "fasta"])
def test_random_mutation_chains(kind):
    seeds = FASTQ_SEEDS if kind == "fastq" else FASTA_SEEDS
    rng = random.Random(42)
    for trial in range(400):
        s = rng.choice(seeds)
        for _ in range(rng.randrange(1, 4)):
            s = rng.choice(MUTATIONS)(s, rng)
        check_agree(s, kind)


def test_random_line_soup():
    """Random lines assembled from grammar fragments."""
    rng = random.Random(7)
    frags = ["@r{}", "ACGT", "ACG", "+", "+...", "IIII", "III", ">g{}",
             "", " ", "NNNN", "xyz", "@", ">", "ACGTN"]
    for trial in range(400):
        n = rng.randrange(1, 10)
        lines = [rng.choice(frags).format(rng.randrange(4)) for _ in range(n)]
        text = "\n".join(lines) + rng.choice(["", "\n", "\r\n", "\n\n"])
        check_agree(text, "fastq")
        check_agree(text, "fasta")


def test_native_throughput_sanity():
    """Native path should parse a moderately large file correctly."""
    import numpy as np

    from shotgun_tpu.utils.synth import synth_genomes, synth_reads, to_fastq
    rng = np.random.default_rng(0)
    g = synth_genomes(rng, 2, 5000)
    reads = synth_reads(rng, g, 500, 100)
    text = to_fastq(reads)
    res = native.fastq_parse(text.encode())
    codes, qual, lengths, ids, _ = res
    assert len(ids) == 500
    assert (lengths == 100).all()
    assert (codes[:, :100] == reads.codes).all()


def test_fastq_stream_chunks_match_full_parse():
    """Streamed chunk fills must concatenate to the full-parse arrays,
    including a partial last chunk and a wider row stride."""
    import numpy as np

    from shotgun_tpu.utils.synth import synth_genomes, synth_reads, to_fastq
    rng = np.random.default_rng(1)
    g = synth_genomes(rng, 2, 3000)
    reads = synth_reads(rng, g, 333, 90)
    data = to_fastq(reads).encode()

    full = native.fastq_parse(data)
    assert full is not None
    f_codes, f_qual, f_lengths, _, _ = full

    info = native.fastq_scan(data)
    assert info.n_records == 333 and info.max_len == 90
    lmax = 128  # stride wider than max_len, as the aligner's bucketing uses
    got_total = 0
    all_codes, all_qual, all_lengths = [], [], []
    for codes, qual, lengths, got in native.fastq_stream_chunks(data, 128, lmax):
        assert codes.shape == (128, lmax)
        all_codes.append(codes[:got, :90])
        all_qual.append(qual[:got, :90])
        all_lengths.append(lengths[:got])
        # padding beyond each row's length must be zero
        assert (codes[:got, 90:] == 0).all() and (qual[:got, 90:] == 0).all()
        got_total += got
    assert got_total == 333
    assert (np.concatenate(all_codes) == f_codes).all()
    assert (np.concatenate(all_qual) == f_qual).all()
    assert (np.concatenate(all_lengths) == f_lengths).all()


def test_streaming_dumpalign_matches_container_path(tmp_path):
    """align_stream (PP-overlap path) output == align_reads_from_container."""
    import json

    import numpy as np

    from shotgun_tpu.aligner import PseudoAlignment
    from shotgun_tpu.index.build import build_index
    from shotgun_tpu.io.data_file import FASTAQFile, open_fastq_stream
    from shotgun_tpu.reference import KmerReference
    from shotgun_tpu.utils.synth import synth_genomes, synth_reads, to_fastq

    rng = np.random.default_rng(5)
    g = synth_genomes(rng, 3, 2000)
    reads = synth_reads(rng, g, 200, 60)
    fq = tmp_path / "reads.fq"
    fq.write_text(to_fastq(reads))
    k = 11
    ref = KmerReference(k, _index=build_index(g, k))

    for filters in ({}, dict(min_read_quality=60, min_kmer_quality=58,
                             max_genomes=2)):
        a1 = PseudoAlignment(ref)
        a1.align_reads_from_container(
            FASTAQFile(str(fq)).container, 1, 1, store_reads=False,
            batch_size=64, **filters)
        a2 = PseudoAlignment(ref)
        stream = open_fastq_stream(str(fq))
        assert stream is not None
        a2.align_stream(stream, 1, 1, batch_size=64, **filters)
        assert json.dumps(a1.get_summary()) == json.dumps(a2.get_summary())


def test_streaming_superbatch_matches_per_batch(tmp_path, monkeypatch):
    """align_stream with superbatching (one [S, b, ...] transfer + one
    lax.scan dispatch per S sub-batches) is byte-identical to the
    per-batch fold path, including quality gates, lazy validation, and a
    ragged tail that zero-pads both sub-batch rows and whole sub-batches."""
    import json

    import numpy as np

    from shotgun_tpu.aligner import PseudoAlignment
    from shotgun_tpu.index.build import build_index
    from shotgun_tpu.io.data_file import open_fastq_stream
    from shotgun_tpu.reference import KmerReference
    from shotgun_tpu.utils.synth import synth_genomes, synth_reads, to_fastq

    rng = np.random.default_rng(11)
    g = synth_genomes(rng, 4, 3000)
    reads = synth_reads(rng, g, 500, 80)  # 500 % (64*4) != 0 -> ragged tail
    fq = tmp_path / "reads.fq"
    fq.write_text(to_fastq(reads))
    k = 15
    ref = KmerReference(k, _index=build_index(g, k))

    for filters in ({}, dict(min_read_quality=59, min_kmer_quality=60,
                             max_genomes=2)):
        outs = []
        for sb in ("1", "4"):
            monkeypatch.setenv("SHOTGUN_TPU_SUPERBATCH", sb)
            for lazy in (False, True):
                a = PseudoAlignment(ref)
                stream = open_fastq_stream(str(fq), lazy=lazy)
                assert stream is not None
                a.align_stream(stream, 1, 1, batch_size=64, **filters)
                outs.append(json.dumps(a.get_summary(), indent=4))
        assert all(o == outs[0] for o in outs[1:])


# ---------------------------------------------------------------------------
# validating packed fill (vstream): validation inside the fill pass
# ---------------------------------------------------------------------------

def _vpacked_all(data: bytes, chunk: int = 64, lmax: int = 32,
                 with_qual: bool = True):
    out = []
    for codes, qual, lengths, got in native.fastq_stream_chunks_vpacked(
            data, chunk, lmax, with_qual):
        out.append((codes.copy(), qual.copy(), lengths.copy(), got))
    return out


def test_vpacked_matches_plain_packed():
    data = b"".join(
        b"@r%d\nACGTACGTACGTACGT\n+\nIIIIIIIIIIIIIIII\n" % i
        for i in range(200)
    )
    a = _vpacked_all(data)
    b = []
    for codes, qual, lengths, got in native.fastq_stream_chunks_packed(
            data, 64, 32, True):
        b.append((codes.copy(), qual.copy(), lengths.copy(), got))
    assert len(a) == len(b)
    for (ca, qa, la, ga), (cb, qb, lb, gb) in zip(a, b):
        assert ga == gb
        np.testing.assert_array_equal(ca, cb)
        np.testing.assert_array_equal(qa, qb)
        np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("data,desc", [
    (b"@r1\nACGT\n+\nIIII\n@r1\nACGT\n+\nIIII\n", "duplicate id"),
    (b"@r1\nACGX\n+\nIIII\n", "bad seq char"),
    (b"@r1\nACGN\n+\nIIII\n", "N illegal in reads"),
    (b"@r1\nACGT\n+\nII\x07I\n", "bad quality char"),
    (b"@r1\nACGT\n+\nIIIII\n", "length mismatch"),
    (b"@r1\nACGT\n+\nIIII\njunk\n", "trailing garbage"),
    (b"@r1\nACGT\nIIII\n", "missing + line"),
    (b"", "empty input"),
    (b"  \n\t\n", "whitespace only"),
])
def test_vpacked_rejects_invalid(data, desc):
    with pytest.raises(native.NativeParseError):
        _vpacked_all(data)


def test_vpacked_lmax_exceeded():
    data = b"@r1\n" + b"A" * 64 + b"\n+\n" + b"I" * 64 + b"\n"
    with pytest.raises(native.LmaxExceeded):
        _vpacked_all(data, lmax=32)
    # retry at a wider stride succeeds
    out = _vpacked_all(data, lmax=64)
    assert out[0][3] == 1


def test_vpacked_valid_multichunk_thread_split():
    # enough records to engage the multithreaded encode phase
    n = 9000
    data = b"".join(
        b"@read%08d\nACGTACGTACGTACGTACGTACGTACGTACGT\n+\n"
        b"IIIIIIIIIIIIIIIIIIIIIIIIIIIIIIII\n" % i for i in range(n)
    )
    tot = 0
    for codes, qual, lengths, got in native.fastq_stream_chunks_vpacked(
            data, 8192, 32, False, n_threads=2):
        assert (lengths[:got] == 32).all()
        tot += got
    assert tot == n


def test_prefetch_iter_consumer_abandon_cleanup():
    """Abandoning the consumer mid-stream must cancel the
    producer (no blocked put), drain the queue, and close the source."""
    import threading
    import time

    from shotgun_tpu.aligner import _prefetch_iter

    closed = {"v": False}
    produced = {"n": 0}

    def source():
        try:
            for i in range(1000):
                produced["n"] += 1
                yield i
        finally:
            closed["v"] = True

    start_threads = threading.active_count()
    it = _prefetch_iter(source(), depth=2)
    got = [next(it), next(it)]
    assert got == [0, 1]
    it.close()  # consumer abandons: generator finally runs
    deadline = time.time() + 5.0
    while threading.active_count() > start_threads and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= start_threads
    assert closed["v"], "source generator must be closed on abandon"
    # bounded production: the producer stopped near the queue depth
    assert produced["n"] < 100


def test_prefetch_iter_propagates_source_error():
    from shotgun_tpu.aligner import _prefetch_iter

    def source():
        yield 1
        raise ValueError("boom")

    it = _prefetch_iter(source(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        for _ in it:
            pass
