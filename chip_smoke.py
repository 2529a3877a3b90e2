#!/usr/bin/env python3
"""End-to-end smoke run of the pseudo-alignment CLI on one CUDA GPU.

    python chip_smoke.py              # one card: all four phases
    python chip_smoke.py --cards 4    # four cards: the multi-card paths only
    python chip_smoke.py --rehearse   # tiny sizes on the host CPU (no result)

Every phase drives the real entry point, ``shotgun_tpu.cli.main(argv)``,
in this one process (so only one process ever holds the card), with its
stdout captured and compared byte for byte against a reference:

* ``goldens`` -- every recorded reference output under ``tests/golden/``
  (k = 11, 31, 75, 150), dumpalign cases under both the sort-merge and
  the hash probe (k <= 31; larger k has only the sorted multi-word table);
* ``sort``    -- device DB build + sort-merge probe over a 7.5 Mbp
  strain-level collection and 1,048,576 error-bearing 150 bp reads with
  the quality and max-genomes filters on, against the host build; 16
  reads of 4 kbp check the exactness of counts above 2048 windows;
* ``hash``    -- a 60 Mbp collection (about 50 M distinct 31-mers) whose
  hash table is assembled on the device, against the upstream
  ``reference`` -> ``align`` -> ``dumpalign -a`` workflow;
* ``extsim``  -- ``--filter-similar`` over 300 identifiers in strain
  clusters, whose overlap matrix is the device matrix product.

Sampled reads of the ``sort`` and ``hash`` phases are also checked one by
one against the host specification ``Read.pseudo_align``.  All data is
generated from ``--seed``.  Each phase prints one JSON line; the last line
is ``{"ok": ..., "device": {...}}``.  The script exits non-zero, and prints
no result, when JAX finds no GPU or the package cannot be imported.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import gzip
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")

#: filters of the sort and hash phases (upstream RUN_LOG-style settings)
FLAGS = ["--min-read-quality", "60", "--min-kmer-quality", "55",
         "--max-genomes", "2"]
MRQ, MKQ, MG = 60, 55, 2

SCALES = {
    # base genomes 12 x 4 Mbp (+3 strains) for ``hash``; ``sort`` takes
    # the first 2.5 Mbp of bases 0 and 1 and of strain 0, so its reads
    # map in both collections
    "full": dict(n_base=12, base_len=4_000_000, n_strain=3,
                 sort_len=2_500_000, n_reads=1 << 20, read_len=150,
                 n_long=16, long_len=4000, ext_ids=300, ext_len=20_000,
                 sample=256, sharded_batch=65536),
    "tiny": dict(n_base=12, base_len=60_000, n_strain=3,
                 sort_len=40_000, n_reads=6000, read_len=150,
                 n_long=4, long_len=2400, ext_ids=300, ext_len=1500,
                 sample=48, sharded_batch=2048),
}

_ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# data, generated from the seed
# ---------------------------------------------------------------------------

def make_genomes(seed: int, sc: dict):
    """Base genomes with a few N runs, and strains: copies of bases
    0..n_strain-1 with 1 % of their bases substituted.  Base 1 carries a
    copy of a segment of base 0 (a shared mobile element), so some k-mers
    sit in three genomes and the max-genomes gate has work.  Returns a
    list of (description, uint8 code array), codes 0-3 = ACGT, 4 = N."""
    out = []
    for i in range(sc["n_base"]):
        rng = np.random.default_rng([seed, 1, i])
        g = rng.integers(0, 4, size=sc["base_len"], dtype=np.uint8)
        for s in rng.integers(0, sc["base_len"] - 64, size=8):
            g[s: s + int(rng.integers(1, 64))] = 4
        out.append((f"base_{i} strain-level reference genome", g))
    seg = sc["base_len"] // 80
    out[1][1][2 * seg: 3 * seg] = out[0][1][seg: 2 * seg]
    for j in range(sc["n_strain"]):
        rng = np.random.default_rng([seed, 2, j])
        g = out[j][1].copy()
        sub = rng.random(g.size) < 0.01
        g[sub] = (g[sub] + rng.integers(1, 4, size=int(sub.sum()),
                                        dtype=np.uint8)) % 4
        out.append((f"strain_{j} of base_{j}", g))
    return out


def sort_collection(genomes, sc: dict):
    """``sort`` phase collection: bases 0, 1 and strain 0, cut short."""
    n = sc["sort_len"]
    strain0 = genomes[sc["n_base"]]
    return [(d, g[:n]) for d, g in (genomes[0], genomes[1], strain0)]


def write_fasta(path: str, genomes) -> int:
    with open(path, "wb") as fh:
        for desc, g in genomes:
            fh.write(b">" + desc.encode() + b"\n")
            seq = _ASCII[g]
            lines = [seq[i: i + 80].tobytes() for i in range(0, g.size, 80)]
            fh.write(b"\n".join(lines) + b"\n")
    return sum(int(g.size) for _, g in genomes)


def make_reads(seed: int, genomes, n: int, length: int, tag: str):
    """Reads sampled from ``genomes`` with 0.5 % substitutions (N -> a
    random base: FASTQ reads carry no N).  Qualities '#'..'I': a fifth
    of the reads sit in a low band (mean below the read-quality gate)
    and a third carry a low-quality dip that fails the k-mer gate.
    Returns (ids, codes [n, length], qual [n, length])."""
    rng = np.random.default_rng([seed, 3, length, n])
    sizes = np.array([g.size for _, g in genomes], dtype=np.int64)
    gi = rng.choice(len(genomes), size=n, p=sizes / sizes.sum())
    start = (rng.random(n) * (sizes[gi] - length)).astype(np.int64)
    codes = np.empty((n, length), dtype=np.uint8)
    for j, (_, g) in enumerate(genomes):
        sel = np.flatnonzero(gi == j)
        codes[sel] = g[start[sel, None] + np.arange(length)[None, :]]
    bad = codes == 4
    codes[bad] = rng.integers(0, 4, size=int(bad.sum()), dtype=np.uint8)
    err = rng.random(codes.shape) < 0.005
    codes[err] = (codes[err] + rng.integers(
        1, 4, size=int(err.sum()), dtype=np.uint8)) % 4
    band = np.where(rng.random(n) < 0.2, 50, 68).astype(np.int16)
    qual = band[:, None] + rng.integers(-10, 8, size=(n, length),
                                        dtype=np.int16)
    dip = np.flatnonzero(rng.random(n) < 0.33)
    dstart = rng.integers(0, length - 34, size=dip.size)
    for off in range(34):
        qual[dip, dstart + off] = 40
    qual = np.clip(qual, 35, 73).astype(np.uint8)
    ids = [f"{tag}{i}" for i in range(n)]
    return ids, codes, qual


def write_fastq(path: str, ids, codes, qual) -> None:
    seq = _ASCII[codes]
    with open(path, "wb") as fh:
        for i in range(0, len(ids), 65536):
            parts = []
            for j in range(i, min(i + 65536, len(ids))):
                parts.append(b"@" + ids[j].encode() + b"\n"
                             + seq[j].tobytes() + b"\n+\n"
                             + qual[j].tobytes() + b"\n")
            fh.write(b"".join(parts))


def make_strain_clusters(seed: int, n_ids: int, length: int):
    """EXTSIM input: clusters of 5 identifiers around one ancestor, each
    member diverged by 0.2-3 % so overlap scores straddle 0.75."""
    rng = np.random.default_rng([seed, 4])
    out = []
    for c in range(-(-n_ids // 5)):
        anc = rng.integers(0, 4, size=length, dtype=np.uint8)
        for m in range(5):
            if len(out) == n_ids:
                break
            g = anc.copy()
            sub = rng.random(length) < rng.uniform(0.002, 0.03)
            g[sub] = (g[sub] + 1) % 4
            out.append((f"cluster{c}_member{m}", g))
    return out


# ---------------------------------------------------------------------------
# running the CLI in this process
# ---------------------------------------------------------------------------

class _Sha:
    """stdout stand-in that hashes what is written (dumpref is large)."""

    def __init__(self):
        self.h = hashlib.sha256()
        self.n = 0

    def write(self, s):
        self.h.update(s.encode())
        self.n += len(s)
        return len(s)

    def flush(self):
        pass


class ProbeLog:
    """Records which device probe structure each align call used."""

    def __init__(self):
        from shotgun_tpu.reference import KmerReference, _DeviceIndexStub

        self.used = []
        orig = KmerReference.device_probe_tables
        log_ = self

        def wrapped(ref, method=None):
            tab = orig(ref, method)
            name = type(tab).__name__
            if (isinstance(ref.index, _DeviceIndexStub)
                    and ref._device_tables.get("hash16") is tab):
                name += "(device-assembled)"
            elif isinstance(ref.index, _DeviceIndexStub):
                name += "(device-built)"
            log_.used.append(name)
            return tab

        KmerReference.device_probe_tables = wrapped

    def take(self):
        used, self.used = sorted(set(self.used)), []
        return used


def cli(argv, env=None, digest=False):
    """Run ``shotgun_tpu.cli.main(argv)`` with ``env`` applied to
    os.environ; return its stdout (or its sha256 when ``digest``)."""
    from shotgun_tpu.cli import main

    env = env or {}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = _Sha() if digest else io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            main(list(argv))
    except SystemExit as exc:
        raise RuntimeError(f"CLI exited ({exc.code}): {argv}") from None
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        gc.collect()
    return out.h.hexdigest() if digest else out.getvalue()


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# per-read check against the host specification
# ---------------------------------------------------------------------------

def _records(ids, codes, qual, rows):
    from shotgun_tpu.io.records import SeqRecord

    seq = _ASCII[codes]
    return [SeqRecord([("identifier", ids[i]),
                       ("sequence", seq[i].tobytes().decode()),
                       ("space", ""),
                       ("quality_sequence", qual[i].tobytes().decode())])
            for i in rows]


def _stored_lists(al):
    """read id -> (mtype code, record ids) from a PseudoAlignment."""
    flat = (np.concatenate(al._list_flat) if al._list_flat
            else np.zeros(0, np.int64))
    offs = np.concatenate([[0], np.cumsum(al._list_counts)]).astype(np.int64)
    return {rid: (int(al._mtypes[i]),
                  [int(x) for x in flat[offs[i]: offs[i + 1]]])
            for i, rid in enumerate(al._read_ids)}


def check_reads_against_spec(records, stored, host_ref) -> int:
    """Each record's device result (``stored``: read id -> (mtype code,
    record list); MRQ-filtered reads are absent) must equal
    ``Read.pseudo_align`` on ``host_ref``."""
    from shotgun_tpu.aligner import _CODE_FROM_MTYPE, Read

    gcs = host_ref.index.genome_counts()
    host_ref.index.genome_counts = lambda: gcs  # per-read recompute: slow
    for rec in records:
        read = Read(rec)
        if read.mean_quality() < MRQ:
            check(rec.identifier not in stored,
                  f"{rec.identifier}: MRQ-filtered read was stored")
            continue
        mtype = read.pseudo_align(host_ref, 1, 1, MRQ, MKQ, MG)
        want = (_CODE_FROM_MTYPE[mtype], read._record_ids)
        got = stored.get(rec.identifier)
        check(got == want, f"{rec.identifier}: device {got} != spec {want}")
    return len(records)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_goldens(ctx) -> dict:
    n = 0
    for sub, suffix in (("", ".out"), ("runlog", ".out.gz")):
        base = os.path.join(GOLDEN, sub)
        with open(os.path.join(base, "manifest.json")) as fh:
            manifest = json.load(fh)
        for name, case in sorted(manifest.items()):
            args = [a.replace("data/", os.path.join(base, "data") + "/")
                    for a in case["args"]]
            opener = gzip.open if suffix.endswith(".gz") else open
            with opener(os.path.join(base, name + suffix), "rt") as fh:
                want = fh.read()
            k = int(args[args.index("-k") + 1])
            variants = [{}]
            if args[1] == "dumpalign":
                variants = [{"SHOTGUN_TPU_PROBE": "sort"},
                            {"SHOTGUN_TPU_PROBE": "sort",
                             "SHOTGUN_TPU_DEVICE_BUILD_MIN": "0"}]
                if k <= 31:
                    variants.append({"SHOTGUN_TPU_PROBE": "hash"})
            for env in variants:
                got = cli(args, env)
                check(got == want, f"golden {name} {env}: output differs")
                n += 1
    return {"cases_run": n}


def _sorted_equal_runs(ctx, fa, fq, extra=()) -> str:
    """dumpalign -g with the device build, then with the host build:
    byte-equal outputs."""
    argv = ["-t", "dumpalign", "-g", fa, "-k", "31", "--reads", fq,
            *FLAGS, *extra]
    dev = cli(argv)
    used = ctx["probes"].take()
    check(used == ["SortedTableDev(device-built)"],
          f"dumpalign -g probe was {used}, not the device-built table")
    host = cli(argv, {"SHOTGUN_TPU_DEVICE_BUILD": "0"})
    used = ctx["probes"].take()
    check(used == ["SortedTableDev"], f"host-build probe was {used}")
    check(dev == host, f"device-build summary != host-build summary ({fq})")
    check('"unique_mapped_reads"' in dev, "summary malformed")
    return dev


def phase_sort(ctx) -> dict:
    from shotgun_tpu.aligner import PseudoAlignment
    from shotgun_tpu.io.data_file import FASTAFile
    from shotgun_tpu.reference import KmerReference

    sc, wd = ctx["scale"], ctx["workdir"]
    coll = sort_collection(ctx["genomes"], sc)
    fa = os.path.join(wd, "sort.fa")
    bases = write_fasta(fa, coll)
    summary = _sorted_equal_runs(ctx, fa, ctx["reads_fq"])
    _sorted_equal_runs(ctx, fa, ctx["long_fq"],
                       ("--batch-size", str(sc["n_long"])))
    log(json.dumps(json.loads(summary)["Statistics"]))

    # sampled reads (all long ones among them) vs the host spec: device
    # results from the device-built reference, spec on a host build
    container = FASTAFile(fa).container
    host_ref = KmerReference(31, container)
    dev_ref = KmerReference.from_device_build(
        container.to_genome_arrays(), 31)
    check(dev_ref is not None, "device build declined the collection")
    ids, codes, qual = ctx["reads"]
    rows = ctx["sample_rows"]
    recs = _records(ids, codes, qual, rows)
    lids, lcodes, lqual = ctx["long"]
    recs_long = _records(lids, lcodes, lqual, range(len(lids)))
    n = 0
    for batch in (recs, recs_long):
        al = PseudoAlignment(dev_ref)
        al.align_reads_from_container(batch, 1, 1, MRQ, MKQ, MG,
                                      batch_size=len(batch))
        n += check_reads_against_spec(batch, _stored_lists(al), host_ref)
    return {"bases": bases, "reads": len(ids) + len(lids),
            "reads_checked_against_spec": n,
            "distinct_kmers": int(host_ref.index.num_kmers)}


def phase_hash(ctx) -> dict:
    from shotgun_tpu.aligner import PseudoAlignment
    from shotgun_tpu.reference import KmerReference

    sc, wd = ctx["scale"], ctx["workdir"]
    fa = os.path.join(wd, "hash.fa")
    bases = write_fasta(fa, ctx["genomes"])
    kdb = os.path.join(wd, "db.kdb")
    out = {"bases": bases}
    runs = ((ctx["reads_fq"], "reads.aln", ()),
            (ctx["long_fq"], "long.aln", ("--batch-size", str(sc["n_long"]))))
    alns = []
    for fq, aln_name, extra in runs:
        dev = cli(["-t", "dumpalign", "-g", fa, "-k", "31", "--reads", fq,
                   *FLAGS, *extra])
        used = ctx["probes"].take()
        check(used == ["HashTableDev(device-assembled)"],
              f"dumpalign -g probe was {used}, not the device hash table")
        if not os.path.exists(kdb):
            cli(["-t", "reference", "-g", fa, "-k", "31", "-r", kdb])
        aln = os.path.join(wd, aln_name)
        cli(["-t", "align", "-r", kdb, "--reads", fq, "-a", aln,
             *FLAGS, *extra])
        used_host = ctx["probes"].take()
        check(used_host == ["HashTableDev"],
              f"align -r probe was {used_host}, not the host hash table")
        wf = cli(["-t", "dumpalign", "-a", aln])
        check(dev == wf, f"dumpalign -g != reference/align/dumpalign -a "
                         f"({os.path.basename(fq)})")
        alns.append(aln)
    out["probe"] = "HashTableDev(device-assembled)"

    host_ref = KmerReference.load(kdb)
    out["distinct_kmers"] = int(host_ref.index.num_kmers)
    check(out["distinct_kmers"] > KmerReference.AUTO_HASH_MIN_KEYS,
          "collection below the hash-probe threshold")
    ids, codes, qual = ctx["reads"]
    lids, lcodes, lqual = ctx["long"]
    n = check_reads_against_spec(
        _records(ids, codes, qual, ctx["sample_rows"]),
        _stored_lists(PseudoAlignment.load(alns[0])), host_ref)
    n += check_reads_against_spec(
        _records(lids, lcodes, lqual, range(len(lids))),
        _stored_lists(PseudoAlignment.load(alns[1])), host_ref)
    out["reads"] = len(ids) + len(lids)
    out["reads_checked_against_spec"] = n
    return out


def phase_extsim(ctx) -> dict:
    from shotgun_tpu.index import extsim
    from shotgun_tpu.io.data_file import FASTAFile
    from shotgun_tpu.reference import KmerReference

    sc, wd = ctx["scale"], ctx["workdir"]
    coll = make_strain_clusters(ctx["seed"], sc["ext_ids"], sc["ext_len"])
    fa = os.path.join(wd, "extsim.fa")
    write_fasta(fa, coll)
    idx = KmerReference(31, FASTAFile(fa).container).index
    idents, _, kmer_u, ident_u = extsim._ident_pairs(idx)
    g = len(idents)
    check(g >= extsim._DEVICE_MIN_G, "too few identifiers for the device")
    dev = extsim._overlap_matrix_device(kmer_u, ident_u, g, idx.num_kmers)
    host = extsim._overlap_matrix_host(kmer_u, ident_u, g, idx.num_kmers)
    check(np.array_equal(dev, host), "device overlap matrix != host")
    argv = ["-t", "dumpref", "-g", fa, "-k", "31", "--filter-similar",
            "--similarity-threshold", "0.75"]
    got_dev = cli(argv, digest=True)
    saved = extsim._DEVICE_MIN_G
    extsim._DEVICE_MIN_G = 1 << 30
    try:
        got_host = cli(argv, digest=True)
    finally:
        extsim._DEVICE_MIN_G = saved
    check(got_dev == got_host, "dumpref --filter-similar: device != host")
    return {"identifiers": g, "distinct_kmers": int(idx.num_kmers),
            "max_overlap": int(host.max())}


def phase_data_mesh(ctx) -> dict:
    """Reads sharded over every card (SHOTGUN_TPU_MESH=data) against the
    same CLI run on one card."""
    import jax

    wd = ctx["workdir"]
    fa = os.path.join(wd, "sort.fa")
    write_fasta(fa, sort_collection(ctx["genomes"], ctx["scale"]))
    argv = ["-t", "dumpalign", "-g", fa, "-k", "31", "--reads",
            ctx["reads_fq"], *FLAGS]
    one = cli(argv)
    mesh = cli(argv, {"SHOTGUN_TPU_MESH": "data"})
    check(one == mesh, "data-mesh summary != one-card summary")
    return {"devices": len(jax.devices()), "reads": len(ctx["reads"][0])}


def phase_table_sharded(ctx) -> dict:
    """The sorted table range-partitioned on a 2 x 2 ('data', 'table')
    mesh against the unsharded probe, batch by batch."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from shotgun_tpu.io.data_file import FASTAFile
    from shotgun_tpu.models.pipeline import align_batch
    from shotgun_tpu.ops.probe_sort import sorted_table_host
    from shotgun_tpu.parallel.table_sharded import (
        align_aggregate_table_sharded,
        device_put_sharded_table,
        make_mesh_2d,
        pad_table_for_sharding,
    )
    from shotgun_tpu.reference import KmerReference

    wd, sc = ctx["workdir"], ctx["scale"]
    fa = os.path.join(wd, "sort.fa")
    ref = KmerReference(31, FASTAFile(fa).container)
    devs = jax.devices()[:4]
    mesh = make_mesh_2d(devs, data=2, table=2)
    tab = device_put_sharded_table(
        mesh, pad_table_for_sharding(sorted_table_host(ref.index), 2))
    member = ref.set_member_dense()
    member_m = jax.device_put(member, NamedSharding(mesh, P()))
    one_tab = ref.device_probe_tables("sort")
    member_1 = jnp.asarray(member)
    ids, codes, qual = ctx["reads"]
    b = sc["sharded_batch"]
    lpad = ((codes.shape[1] + 31) // 32) * 32
    scal = [np.int32(v) for v in (1, 1, MRQ, MKQ, MG)]
    kw = dict(k=31, has_mrq=True, has_mkq=True, has_mg=True)
    n_batches = 0
    for s in range(0, len(ids) - b + 1, b):
        c = np.zeros((b, lpad), np.uint8)
        q = np.zeros((b, lpad), np.uint8)
        c[:, : codes.shape[1]] = codes[s: s + b]
        q[:, : codes.shape[1]] = qual[s: s + b]
        ln = np.full(b, codes.shape[1], np.int32)
        rv = np.ones(b, bool)
        dp = lambda a: jax.device_put(
            a, NamedSharding(mesh, P("data", *([None] * (a.ndim - 1)))))
        agg_m = align_aggregate_table_sharded(
            tab, member_m, dp(c), dp(q), dp(ln), dp(rv), *scal,
            mesh=mesh, **kw)
        _, agg_1 = align_batch(
            one_tab, member_1, jnp.asarray(c), jnp.asarray(q),
            jnp.asarray(ln), jnp.asarray(rv), *scal, **kw)
        for f in agg_1._fields:
            check(np.array_equal(np.asarray(getattr(agg_m, f)),
                                 np.asarray(getattr(agg_1, f))),
                  f"table-sharded AggResult.{f} != unsharded (batch {s})")
        n_batches += 1
    return {"mesh": "2x2 (data, table)", "batches": n_batches,
            "reads": n_batches * b}


# ---------------------------------------------------------------------------

def nvidia_smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="",
                    help="comma-separated subset of the phases to run")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the host CPU; prints no result")
    args = ap.parse_args()

    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["SHOTGUN_TPU_PLATFORM"] = "cpu"
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        os.environ["SHOTGUN_TPU_DEVICE_BUILD_MIN"] = "0"
    else:
        os.environ.setdefault("JAX_PLATFORMS", "cuda")

    from shotgun_tpu.io import native
    from shotgun_tpu.reference import KmerReference
    from shotgun_tpu.utils.platform import (
        COMPILE_STATS,
        configure_platform,
        enable_compile_stats,
    )

    enable_compile_stats()
    configure_platform()
    import jax

    devices = jax.devices()
    dev = devices[0]
    if not args.rehearse and dev.platform != "gpu":
        log(f"no GPU: JAX reports {dev.platform}")
        return 2
    if len(devices) < args.cards:
        log(f"--cards {args.cards}: only {len(devices)} devices")
        return 2
    smi = nvidia_smi_line()
    print(f"card: {smi}", flush=True)
    if not native.available():
        log("native library failed to build or load")
        return 2

    sc = dict(SCALES["tiny" if args.rehearse else "full"])
    if args.rehearse:
        # tiny collections must still take the hash-table route
        KmerReference.AUTO_HASH_MIN_KEYS = 100_000
    if args.cards == 4:
        names = ["data_mesh", "table_sharded"]
    else:
        names = ["goldens", "sort", "hash", "extsim"]
    if args.phases:
        names = [p for p in args.phases.split(",") if p in names]
    phases = {"goldens": phase_goldens, "sort": phase_sort,
              "hash": phase_hash, "extsim": phase_extsim,
              "data_mesh": phase_data_mesh,
              "table_sharded": phase_table_sharded}

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    ok = True
    try:
        t0 = time.perf_counter()
        ctx = {"scale": sc, "workdir": workdir, "seed": args.seed,
               "probes": ProbeLog()}
        if set(names) - {"goldens", "extsim"}:
            ctx["genomes"] = make_genomes(args.seed, sc)
            reads = make_reads(args.seed, sort_collection(ctx["genomes"], sc),
                               sc["n_reads"], sc["read_len"], "read")
            long_ = make_reads(args.seed,
                               sort_collection(ctx["genomes"], sc)[:1],
                               sc["n_long"], sc["long_len"], "long")
            ctx["reads"], ctx["long"] = reads, long_
            ctx["reads_fq"] = os.path.join(workdir, "reads.fq")
            ctx["long_fq"] = os.path.join(workdir, "long.fq")
            write_fastq(ctx["reads_fq"], *reads)
            write_fastq(ctx["long_fq"], *long_)
            ctx["sample_rows"] = np.random.default_rng(
                [args.seed, 5]).choice(len(reads[0]), sc["sample"],
                                       replace=False)
        log(f"data generated in {time.perf_counter() - t0:.1f}s")
        for name in names:
            before = dict(COMPILE_STATS)
            t0 = time.perf_counter()
            rec = {"phase": name}
            try:
                rec.update(phases[name](ctx))
                rec["ok"] = True
            except Exception as exc:  # reported below, then fails the run
                import traceback

                traceback.print_exc()
                rec["ok"] = False
                rec["error"] = f"{type(exc).__name__}: {exc}"[:400]
                ok = False
            rec["seconds"] = round(time.perf_counter() - t0, 3)
            rec.setdefault("probe", ctx["probes"].take())
            stats = dev.memory_stats() or {}
            if "peak_bytes_in_use" in stats:
                rec["peak_bytes_in_use"] = int(stats["peak_bytes_in_use"])
            rec["xla_compiles"] = (COMPILE_STATS["backend_compiles"]
                                   - before["backend_compiles"])
            rec["compile_cache_hits"] = (COMPILE_STATS["cache_hits"]
                                         - before["cache_hits"])
            print(json.dumps(rec), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    print(f"card: {smi}", flush=True)
    if args.rehearse:
        log(f"rehearsal {'passed' if ok else 'FAILED'} on {dev.platform}")
        return 0 if ok else 1
    print(json.dumps({"ok": ok, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
