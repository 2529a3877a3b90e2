"""CLI integration tests: subprocess task grid, error-string contracts, and
byte-exact golden comparison against recorded reference outputs
(coverage model: reference test_main.py; goldens recorded by
tests/tools/make_goldens.py)."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "golden")


def run_cli(args, cwd=REPO):
    env = dict(os.environ)
    env["SHOTGUN_TPU_PLATFORM"] = "cpu"
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "main.py")] + args,
        cwd=cwd, capture_output=True, text=True, env=env, timeout=600,
    )


@pytest.fixture(scope="module")
def corpus():
    return (
        os.path.join(GOLDEN, "data", "corpus.fa"),
        os.path.join(GOLDEN, "data", "corpus.fq"),
    )


# --- golden byte-equality ---------------------------------------------------

with open(os.path.join(GOLDEN, "manifest.json")) as _fh:
    _MANIFEST = json.load(_fh)


@pytest.mark.parametrize("name", sorted(_MANIFEST))
def test_golden(name):
    args = [
        a.replace("data/", os.path.join(GOLDEN, "data") + "/")
        for a in _MANIFEST[name]["args"]
    ]
    out = run_cli(args + ["--batch-size", "64"])
    assert out.returncode == 0, out.stderr
    expected = open(os.path.join(GOLDEN, f"{name}.out")).read()
    assert out.stdout == expected


# --- RUN_LOG acceptance grid (k=31/75/150, 150+ bp reads, MRQ/MKQ/MG,
# sim 0.75, m/p variations; reference src/RUN_LOG:1-115; corpus + goldens
# recorded by tests/tools/make_goldens_runlog.py) -----------------------------

RUNLOG = os.path.join(GOLDEN, "runlog")
with open(os.path.join(RUNLOG, "manifest.json")) as _fh:
    _RUNLOG_MANIFEST = json.load(_fh)


@pytest.mark.parametrize("name", sorted(_RUNLOG_MANIFEST))
def test_runlog_golden(name):
    import gzip as _gzip

    args = [
        a.replace("data/", os.path.join(RUNLOG, "data") + "/")
        for a in _RUNLOG_MANIFEST[name]["args"]
    ]
    out = run_cli(args + ["--batch-size", "512"])
    assert out.returncode == 0, out.stderr
    with _gzip.open(os.path.join(RUNLOG, f"{name}.out.gz"), "rt") as fh:
        expected = fh.read()
    assert out.stdout == expected


# --- full task grid with files ---------------------------------------------

def test_reference_then_dumpref_roundtrip(tmp_path, corpus):
    fa, _ = corpus
    kdb = str(tmp_path / "db.kdb")
    out = run_cli(["-t", "reference", "-g", fa, "-k", "11", "-r", kdb])
    assert out.returncode == 0, out.stderr
    assert os.path.exists(kdb)
    dump1 = run_cli(["-t", "dumpref", "-r", kdb])
    dump2 = run_cli(["-t", "dumpref", "-g", fa, "-k", "11"])
    assert dump1.returncode == 0 and dump2.returncode == 0
    assert dump1.stdout == dump2.stdout


def test_align_then_dumpalign_roundtrip(tmp_path, corpus):
    fa, fq = corpus
    kdb = str(tmp_path / "db.kdb")
    aln = str(tmp_path / "out.aln")
    assert run_cli(["-t", "reference", "-g", fa, "-k", "11", "-r", kdb]).returncode == 0
    out = run_cli(["-t", "align", "-r", kdb, "--reads", fq, "-a", aln])
    assert out.returncode == 0, out.stderr
    dump_a = run_cli(["-t", "dumpalign", "-a", aln])
    dump_direct = run_cli(["-t", "dumpalign", "-r", kdb, "--reads", fq])
    assert dump_a.returncode == 0, dump_a.stderr
    assert dump_a.stdout == dump_direct.stdout
    expected = open(os.path.join(GOLDEN, "plain.out")).read()
    assert dump_a.stdout == expected


# --- error contracts (reference main.py:30-54,321-342,399-402) --------------

def test_missing_genome_file():
    out = run_cli(["-t", "dumpref", "-g", "/nope/missing.fa", "-k", "11"])
    assert out.returncode != 0
    assert "does not exist or is not a file" in out.stderr


def test_bad_extension(tmp_path):
    bad = tmp_path / "genome.txt"
    bad.write_text(">g\nACGT\n")
    out = run_cli(["-t", "dumpref", "-g", str(bad), "-k", "3"])
    assert out.returncode != 0
    assert "Invalid file extension" in out.stderr


def test_unsupported_task():
    out = run_cli(["-t", "frobnicate"])
    assert out.returncode != 0
    assert "Error: Unsupported task." in out.stderr


def test_reference_task_rejects_align_flags(corpus):
    fa, fq = corpus
    out = run_cli(["-t", "reference", "-g", fa, "-k", "11", "-r", "/tmp/x.kdb",
                   "--reads", fq])
    assert out.returncode != 0
    assert "For task 'reference'" in out.stderr


def test_align_task_requires_alignfile(corpus):
    fa, fq = corpus
    out = run_cli(["-t", "align", "-g", fa, "-k", "11", "--reads", fq])
    assert out.returncode != 0
    assert "For task 'align'" in out.stderr


def test_corrupt_reference_file(tmp_path, corpus):
    _, fq = corpus
    bad = tmp_path / "bad.kdb"
    bad.write_bytes(b"garbage bytes here")
    out = run_cli(["-t", "dumpalign", "-r", str(bad), "--reads", fq])
    assert out.returncode != 0
    assert "Error: Incorrect format of input file." in out.stderr


def test_zero_thresholds_coerced_to_defaults(corpus):
    """-m 0 / -p 0 silently become 1/1 (reference main.py:337-342)."""
    fa, fq = corpus
    z = run_cli(["-t", "dumpalign", "-g", fa, "-k", "11", "--reads", fq,
                 "-m", "0", "-p", "0"])
    d = run_cli(["-t", "dumpalign", "-g", fa, "-k", "11", "--reads", fq])
    assert z.returncode == 0
    assert z.stdout == d.stdout


def test_dumpalign_without_inputs_errors():
    out = run_cli(["-t", "dumpalign"])
    assert out.returncode != 0
    assert "provide either -r and --reads" in out.stderr


def test_gzip_inputs_match_plain_golden(tmp_path, corpus):
    """.fa.gz / .fq.gz inputs produce byte-identical dumpalign output
    (reference data_file.py:117-128 gzip transparency)."""
    import gzip as _gzip

    fa, fq = corpus
    fagz = str(tmp_path / "corpus.fa.gz")
    fqgz = str(tmp_path / "corpus.fq.gz")
    with open(fa, "rb") as src, _gzip.open(fagz, "wb") as dst:
        dst.write(src.read())
    with open(fq, "rb") as src, _gzip.open(fqgz, "wb") as dst:
        dst.write(src.read())
    out = run_cli(["-t", "dumpalign", "-g", fagz, "-k", "11",
                   "--reads", fqgz])
    assert out.returncode == 0, out.stderr
    expected = open(os.path.join(GOLDEN, "plain.out")).read()
    assert out.stdout == expected


def test_gzip_dumpref_matches_plain_golden(tmp_path, corpus):
    fa, _ = corpus
    import gzip as _gzip

    fagz = str(tmp_path / "corpus.fa.gz")
    with open(fa, "rb") as src, _gzip.open(fagz, "wb") as dst:
        dst.write(src.read())
    out = run_cli(["-t", "dumpref", "-g", fagz, "-k", "11"])
    assert out.returncode == 0, out.stderr
    expected = open(os.path.join(GOLDEN, "dumpref.out")).read()
    assert out.stdout == expected


def test_corrected_spelling_alias_rejected():
    """Only the reference's typo'd --ambiguous-threhold long flag exists;
    the corrected spelling is NOT part of the surface (main.py:70)."""
    out = run_cli(["-t", "dumpalign", "-a", "x.aln",
                   "--ambiguous-threshold", "1"])
    assert out.returncode != 0
    assert "unrecognized arguments" in out.stderr


def test_user_input_valueerror_exits_cleanly(corpus):
    """Engine ValueErrors that are part of the reference's user contract
    (UserInputError) funnel to a clean exit with the message, exactly as
    the reference's bare-ValueError catch does (reference main.py:401)."""
    fa, fq = corpus
    out = run_cli(["-t", "dumpalign", "-g", fa, "-k", "31", "--reads", fq,
                   "-m", "-1"])
    assert out.returncode != 0
    assert "Traceback" not in out.stderr
    assert "m must be bigger than or equal to 0" in out.stderr


def test_internal_valueerror_is_not_swallowed(tmp_path, corpus):
    """An unexpected internal ValueError must produce a traceback, not a
    clean user-error exit: the CLI catches only the
    UserInputError subclass, unlike the reference's bare-ValueError
    funnel."""
    fa, fq = corpus
    env = dict(os.environ)
    env["SHOTGUN_TPU_PLATFORM"] = "cpu"
    # inject a ValueError deep in the engine via sitecustomize-free -c:
    # patch PseudoAlignment.align_stream/align_packed_reads to blow up
    code = (
        "import shotgun_tpu.aligner as A\n"
        "def boom(self, *a, **k):\n"
        "    raise ValueError('internal bug: bad reshape')\n"
        "A.PseudoAlignment.align_stream = boom\n"
        "A.PseudoAlignment.align_packed_reads = boom\n"
        "import sys\n"
        "from shotgun_tpu.cli import main\n"
        f"sys.argv = ['main.py', '-t', 'dumpalign', '-g', {fa!r}, "
        f"'-k', '31', '--reads', {fq!r}]\n"
        "main()\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode != 0
    assert "Traceback" in out.stderr
    assert "internal bug: bad reshape" in out.stderr


def test_golden_plain_via_device_build():
    """The dumpalign -g device-build route (cli.py size window forced
    open) byte-matches the recorded reference golden -- the default
    window skips tiny corpora, so this pins the CLI wiring explicitly."""
    args = [
        a.replace("data/", os.path.join(GOLDEN, "data") + "/")
        for a in _MANIFEST["plain"]["args"]
    ]
    env = dict(os.environ)
    env["SHOTGUN_TPU_PLATFORM"] = "cpu"
    env["SHOTGUN_TPU_DEVICE_BUILD_MIN"] = "0"
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "main.py")]
        + args + ["--batch-size", "64"],
        cwd=REPO, capture_output=True, text=True, env=env, timeout=600,
    )
    assert out.returncode == 0, out.stderr
    expected = open(os.path.join(GOLDEN, "plain.out")).read()
    assert out.stdout == expected
