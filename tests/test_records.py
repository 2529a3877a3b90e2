"""Parser-layer unit tests (coverage model: reference test_records.py)."""

import pytest

from shotgun_tpu.io.records import (
    DuplicateRecordError,
    FASTAParser,
    FASTQParser,
    FieldSpec,
    InvalidRecordData,
    NoRecordsInData,
    SchemaParser,
    SeqRecord,
    UnparsedDataError,
)


class MockParser(SchemaParser):
    FIELD_SPECS = (
        FieldSpec(name="header", header="@", required=True,
                  legal_chars=r"\S\t ", unique=True),
        FieldSpec(name="body", header="", required=True,
                  legal_chars="ACGT", strip_chars=r"\s"),
    )


# --- SeqRecord -------------------------------------------------------------

def test_record_identifier_is_first_field():
    rec = SeqRecord([("name", "abc"), ("seq", "ACGT")])
    assert rec.identifier == "abc"
    assert rec["seq"] == "ACGT"


def test_record_empty_fields_raises():
    with pytest.raises(InvalidRecordData):
        SeqRecord([])


def test_record_duplicate_field_raises():
    with pytest.raises(InvalidRecordData):
        SeqRecord([("a", "1"), ("a", "2")])


def test_records_hash_by_identity():
    a = SeqRecord([("d", "x")])
    b = SeqRecord([("d", "x")])
    assert a != b and len({a, b}) == 2


# --- generic schema engine -------------------------------------------------

def test_mock_schema_parses_multiple_records():
    p = MockParser()
    p.parse_records("@one\nACGT\nACGT\n@two\nTTTT\n")
    recs = list(p)
    assert [r.identifier for r in recs] == ["one", "two"]
    assert recs[0]["body"] == "ACGTACGT"  # whitespace removed, joined


def test_mock_schema_duplicate_unique_index():
    p = MockParser()
    with pytest.raises(DuplicateRecordError):
        p.parse_records("@one\nACGT\n@one\nTTTT\n")


def test_mock_schema_no_records():
    with pytest.raises(NoRecordsInData):
        MockParser().parse_records("nothing to see\n" if False else "")


def test_line_ending_variants():
    for text in ("@a\nACGT\n", "@a\r\nACGT\r\n", "@a\nACGT"):
        p = MockParser()
        p.parse_records(text)
        assert list(p)[0]["body"] == "ACGT"


def test_unparsed_garbage_between_records():
    p = MockParser()
    with pytest.raises(UnparsedDataError) as err:
        p.parse_records("@one\nACGT\nxxxx garbage\n@two\nTTTT\n")
    assert "Unparsed data found at index" in str(err.value)


# --- FASTA -----------------------------------------------------------------

def test_fasta_multiline_and_n():
    p = FASTAParser()
    p.parse_records(">g1 desc here\nACGT\nNNAC\n>g2\nTTTT\n")
    recs = list(p)
    assert recs[0].identifier == "g1 desc here"
    assert recs[0]["genome"] == "ACGTNNAC"
    assert recs[1]["genome"] == "TTTT"


def test_fasta_duplicate_description_allowed():
    p = FASTAParser()
    p.parse_records(">same\nACGT\n>same\nTTTT\n")
    assert len(list(p)) == 2


def test_fasta_illegal_chars_rejected():
    # a lone invalid record -> no valid records at all
    with pytest.raises(NoRecordsInData):
        FASTAParser().parse_records(">g\nACGTX\n")
    # invalid record next to a valid one -> unparsed leftover
    with pytest.raises(UnparsedDataError):
        FASTAParser().parse_records(">ok\nACGT\n>bad\nACGTX\n")


def test_fasta_empty_raises():
    with pytest.raises(NoRecordsInData):
        FASTAParser().parse_records("\n\n")


# --- FASTQ -----------------------------------------------------------------

FASTQ_OK = "@r1\nACGT\n+\nIIII\n@r2\nTTTT\n+\n!!!!\n"


def test_fastq_valid_parse():
    p = FASTQParser()
    p.parse_records(FASTQ_OK)
    recs = list(p)
    assert [r.identifier for r in recs] == ["r1", "r2"]
    assert recs[0]["sequence"] == "ACGT"
    assert recs[1]["quality_sequence"] == "!!!!"


def test_fastq_full_quality_alphabet():
    from shotgun_tpu.constants import PHRED33_CHARS
    seq = "A" * len(PHRED33_CHARS)
    p = FASTQParser()
    p.parse_records(f"@r\n{seq}\n+\n{PHRED33_CHARS}\n")
    assert list(p)[0]["quality_sequence"] == PHRED33_CHARS


def test_fastq_n_is_illegal_in_reads():
    with pytest.raises((UnparsedDataError, NoRecordsInData)):
        FASTQParser().parse_records("@r\nACGN\n+\nIIII\n")


def test_fastq_length_mismatch():
    with pytest.raises(InvalidRecordData) as err:
        FASTQParser().parse_records("@r\nACGT\n+\nIII\n")
    assert "Mismatch in record 1" in str(err.value)


def test_fastq_duplicate_identifier():
    with pytest.raises(DuplicateRecordError):
        FASTQParser().parse_records("@r\nACGT\n+\nIIII\n@r\nTTTT\n+\nIIII\n")


def test_fastq_missing_plus_line():
    with pytest.raises((UnparsedDataError, NoRecordsInData)):
        FASTQParser().parse_records("@r\nACGT\nIIII\n")


def test_fastq_embedded_whitespace_in_sequence():
    with pytest.raises((UnparsedDataError, NoRecordsInData, InvalidRecordData)):
        FASTQParser().parse_records("@r\nAC GT\n+\nIIIII\n")


def test_fastq_trailing_garbage():
    with pytest.raises(UnparsedDataError):
        FASTQParser().parse_records(FASTQ_OK + "trailing garbage")


def test_fastq_space_line_dots_allowed():
    p = FASTQParser()
    p.parse_records("@r\nACGT\n+...\nIIII\n")
    assert list(p)[0]["space"] == "..."


# --- reference-ported parity tests ------------------------------------------

class RefMockParser(SchemaParser):
    """Mirror of the reference's MockRecordContainer schema
    (reference test_records.py:104-122)."""

    FIELD_SPECS = (
        FieldSpec(name="header", header=">", required=True,
                  legal_chars="AGCT", unique=True),
        FieldSpec(name="sequence", header="", required=True,
                  legal_chars="AGCT", strip_chars=r"\s"),
    )


def test_schema_pattern_exact_string():
    """The derived regex is byte-identical to the reference engine's for
    the same schema (reference test_records.py:125-134)."""
    expected = (
        r"^>((?:[AGCT])+?)"
        r"\r?\n((?:[AGCT\s])+?)"
        r"(?=(?=\r?\n>)|(?=(?:\r?\n)?\Z))"
    )
    assert RefMockParser().pattern == expected


def test_fastq_ten_record_full_alphabet():
    """10-record FASTQ parse incl. the full 94-char quality alphabet on
    the regex engine (port of reference test_records.py:272-338)."""
    # 95 chars spanning the printable PHRED class, incl. backslash + quote
    # (the reference's raw literal "\"" is two characters)
    qual94a = (
        r"`1234567890-=qwertyuiop[]\asdfghjkl;'zxcvbnm,./"
        r"~!@#$%^&*()_+QWERTYUIOP{}|ASDFGHJKL:\"ZXCVBNM<>?"
    )
    seq7 = ("TTTTTTTTTTTTTTTTTGCTGCAGATCGTGGGTTTATGGATGATGTAGTGTAGAGTGAG"
            "TAGTAGTGATGGATTATGGATTGATTGAGTCAGCCG")
    seq8 = ("TTTTTTTTTTTTTTTTTTTTAAAAAAAAAAAAAAACCAGGGGGGGGGGGGGGGGGGGGG"
            "GGGGCCCCCCCCCCCCCCCCCCCCCCCCCCCCCCCCTTTTTTTTTTTTTTTTTTTTTT")
    entries = [
        ("Read1", "GGGTGATGGCCGCTGCCGATGGCGTCAAATCCCACCAA", "I" * 38),
        ("Read2", "ATCGATCGATCGATCGATCGAA", "I" * 22),
        ("Read3", "GCGCGCGCGCGCGCGCGCGCGG", "I" * 22),
        ("Read4", "AGCTAGCTAGCTAGCTAGCTTT", "I" * 22),
        ("Read5", "TTTTTTTTTTTTTTTTTTTTAA", "I" * 22),
        ("Read6", "AGGGGGGGGGGGGGGGGGGGGG", "I" * 22),
        ("Read7", seq7, qual94a),
        ("Read8", seq8, qual94a + "I" * 22),
        ("Read9", "TTTTTTTTTTTTTTTTTTTTAA", "I" * 22),
        ("Read10", "TTTTTTTTTTTTTTTTTTTTAA", "I" * 22),
    ]
    data = "".join(f"@{i}\n{s}\n+\n{q}\n" for i, s, q in entries)
    data = data[:-1]  # last record without trailing newline, as in the ref
    p = FASTQParser()
    p.parse_records(data)
    records = list(p)
    assert len(records) == 10
    for rec, (rid, seq, qual) in zip(records, entries):
        assert rec["identifier"] == rid
        assert rec["sequence"] == seq
        assert rec["quality_sequence"] == qual
