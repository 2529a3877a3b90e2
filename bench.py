#!/usr/bin/env python3
"""Benchmark: pseudo-align throughput on the attached accelerator.

Workload mirrors BASELINE.md: 5 genomes x 200 kbp (1 Mbp), k=31,
error-free 150 bp reads, no filters.  The reference's measured CPU
baseline on this exact workload is ~4,900 reads/s (BASELINE.md).

Prints ONE JSON line (the LAST line of stdout):
  {"metric": ..., "value": N, "unit": "reads/s", "vs_baseline": N,
   "device": {"platform", "device_kind", "count", "power_limit"},
   "extra": {...}}

Only one process holds the card at a time: the cold/warm CLI compile
probe runs its CLI children BEFORE this process first touches the
device, and every device section runs in this process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

BASELINE_READS_PER_SEC = 4900.0

N_GENOMES = int(os.environ.get("BENCH_GENOMES", 5))
GENOME_LEN = int(os.environ.get("BENCH_GENOME_LEN", 200_000))
# 2x the r1-r3 read count: the stream path's fill/dispatch ramp is a
# fixed cost, and the steady-state claim deserves a longer steady state
N_READS = int(os.environ.get("BENCH_READS", 524_288))
READ_LEN = int(os.environ.get("BENCH_READ_LEN", 150))
K = int(os.environ.get("BENCH_K", 31))
# the auto batch size for inputs this large; override with BENCH_BATCH
BATCH = int(os.environ.get("BENCH_BATCH", 32768))
SLOTS = int(os.environ.get("BENCH_SLOTS", 0))  # 0 = library default


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def card_info() -> dict:
    """Platform, device kind and count as JAX reports them, plus the
    card's name and power limit as nvidia-smi reports them (a card set
    below its maximum power runs slower under load)."""
    import jax

    devs = jax.devices()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = ""
    return {"platform": devs[0].platform,
            "device_kind": devs[0].device_kind,
            "count": len(devs),
            "power_limit": smi.splitlines()[0] if smi else "not available"}


def main():
    # the CLI children of the compile probe open the card themselves, so
    # they run before this process first touches the device
    warm_compile = (_warm_compile_probe()
                    if os.environ.get("BENCH_WARM", "1") == "1" else None)

    import jax
    import jax.numpy as jnp

    from shotgun_tpu.index.build import build_index
    from shotgun_tpu.index.hashtable import build_probe_table
    from shotgun_tpu.models.pipeline import align_batch
    from shotgun_tpu.reference import KmerReference
    from shotgun_tpu.utils.synth import synth_genomes, synth_reads

    device = card_info()
    log(f"devices: {jax.devices()} {device}")
    rng = np.random.default_rng(0)

    t0 = time.perf_counter()
    genomes = synth_genomes(rng, N_GENOMES, GENOME_LEN)
    reads = synth_reads(rng, genomes, N_READS, READ_LEN)
    log(f"synth data: {time.perf_counter() - t0:.2f}s")

    # steady-state build rate: first call warms the native lib + page
    # tables (first-touch faults dominate a cold call on this host), the
    # timed second call is the build-once-align-many regime the .kdb
    # workflow amortizes into
    idx = build_index(genomes, K)
    t0 = time.perf_counter()
    idx = build_index(genomes, K)
    build_s = time.perf_counter() - t0
    total_mbp = N_GENOMES * GENOME_LEN / 1e6
    log(f"DB build (warm): {build_s:.2f}s  ({total_mbp / build_s:.2f} Mbp/s, "
        f"{idx.num_kmers} kmers, {idx.num_sets} sets)")

    ref = KmerReference(K, _index=idx)

    # end-to-end: raw FASTQ bytes -> native scan -> streamed chunk fill
    # overlapped with async device dispatch -> folded summary (the actual
    # CLI dumpalign path, PseudoAlignment.align_stream)
    from shotgun_tpu.aligner import PseudoAlignment
    from shotgun_tpu.utils.synth import to_fastq

    from shotgun_tpu.io.data_file import open_fastq_stream

    t0 = time.perf_counter()
    fq_bytes = to_fastq(reads).encode()
    fq_dir = tempfile.mkdtemp()
    fq_path = os.path.join(fq_dir, "bench.fq")
    with open(fq_path, "wb") as f:
        f.write(fq_bytes)
    fq_mb = len(fq_bytes) / 1e6
    del fq_bytes  # ~200 MB; the stream passes re-read from the file
    log(f"fastq serialize: {time.perf_counter() - t0:.2f}s "
        f"({fq_mb:.0f} MB)")

    # warm the streamed executables (packed codes + device fold differ
    # from the staged headline programs); steady-state is what the metric
    # claims -- cold-compile behavior is covered by the warm_compile probe
    warm = PseudoAlignment(ref)
    warm.align_stream(open_fastq_stream(fq_path, lazy=True), 1, 1,
                      batch_size=BATCH)

    # timed region is the REAL CLI dumpalign read path (cli.py:177):
    # lazy open (validation scan overlaps the fill/dispatch loop on a
    # worker thread), native packed chunk fill, fused align dispatch,
    # device-resident fold, one fetch, summary.  Median of 7 passes: the
    # metric claims steady-state throughput.
    pass_times = []
    for rep in range(7):
        t0 = time.perf_counter()
        stream = open_fastq_stream(fq_path, lazy=True)
        alignment = PseudoAlignment(ref)
        alignment.align_stream(stream, 1, 1, batch_size=BATCH)
        summary = alignment.get_summary()
        rep_s = time.perf_counter() - t0
        n_uniq = summary["Statistics"]["unique_mapped_reads"]
        log(f"end-to-end stream pass {rep + 1}/7: {rep_s:.2f}s "
            f"({N_READS / rep_s:,.0f} reads/s, unique={n_uniq})")
        pass_times.append(rep_s)
    # the MEDIAN is the steady-state number; best-of is recorded
    # separately as the low-jitter bound
    e2e_s = sorted(pass_times)[len(pass_times) // 2]
    e2e_reads_per_s = N_READS / e2e_s
    e2e_best = N_READS / min(pass_times)
    log(f"end-to-end stream (parse+align+summary): "
        f"{e2e_reads_per_s:,.0f} reads/s median of 7 "
        f"(best {e2e_best:,.0f})")

    # align TASK (store_reads=True) + dumpalign -a: the reference's
    # primary workflow is align-then-dumpalign (reference RUN_LOG:13-61);
    # this measures the .aln-producing path -- full parse with per-read id
    # retention, per-read mapping-list store, .aln save, reload + summary.
    # Warm pass timed (executables already built).
    align_task = {}
    try:
        aln_path = os.path.join(fq_dir, "bench.aln")
        # warm-up pass: the superbatched store program compiles/loads
        # here; the timed pass is the steady state (as everywhere else)
        warm_al = PseudoAlignment(ref)
        warm_al.align_stream(open_fastq_stream(fq_path, lazy=True), 1, 1,
                             batch_size=BATCH, store_reads=True)
        # warm the save too: the first ~80 MB .aln write pays the page-
        # cache/file-system cold cost (measured 2.9s first vs 0.3s after)
        warm_al.save(aln_path)
        del warm_al
        # timed: the CLI -t align route (stream fill + packed store
        # words + native id side pass) then .aln save, then -a load
        t0 = time.perf_counter()
        alignment = PseudoAlignment(ref)
        alignment.align_stream(open_fastq_stream(fq_path, lazy=True),
                               1, 1, batch_size=BATCH, store_reads=True)
        align_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        alignment.save(aln_path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = PseudoAlignment.load(aln_path)
        summary2 = loaded.get_summary()
        dump_s = time.perf_counter() - t0
        assert summary2 == summary, "align-task summary != stream summary"
        task_s = align_s + save_s
        align_task = {
            "align_task_reads_per_sec": round(N_READS / task_s, 1),
            "align_task_s": round(task_s, 2),
            "align_task_align_s": round(align_s, 2),
            "align_task_save_s": round(save_s, 2),
            "dumpalign_a_s": round(dump_s, 2),
            "align_task_vs_stream": round(task_s / e2e_s, 2),
        }
        log(f"align task (stream-store): align {align_s:.2f}s + "
            f"save {save_s:.2f}s = {task_s:.2f}s "
            f"({N_READS / task_s:,.0f} reads/s, "
            f"{task_s / e2e_s:.2f}x stream); dumpalign -a {dump_s:.2f}s")
        del alignment, loaded
    except Exception as exc:
        align_task = {"error": repr(exc)}
        log(f"align task bench failed: {exc!r}")

    t0 = time.perf_counter()
    method = os.environ.get("SHOTGUN_TPU_PROBE", "sort")
    if SLOTS and method == "hash":
        from shotgun_tpu.ops.probe import HashTableDev
        pt = build_probe_table(idx.kmer_lo, idx.kmer_hi, idx.set_id,
                               idx.genome_counts(), slots_per_bucket=SLOTS)
        probe_tab = HashTableDev(table=jnp.asarray(pt.table),
                                 stash=jnp.asarray(pt.stash))
        log(f"hash table: {pt.n_buckets} buckets, stash={pt.stash.shape[0]}, "
            f"{pt.table.nbytes / 1e6:.1f} MB")
    else:
        probe_tab = ref.device_probe_tables(method)
        # .nbytes on the jax array -- np.asarray here would fetch the
        # whole table back just to log its size
        nbytes = sum(a.nbytes for a in jax.tree.leaves(probe_tab))
        log(f"probe tables ({method}): {nbytes / 1e6:.1f} MB")
    member = ref.set_member_dense()
    log(f"probe prep: {time.perf_counter() - t0:.2f}s")

    member_d = jnp.asarray(member)
    zero = jnp.int32(0)
    one = jnp.int32(1)

    def run_batch(codes_d, qual_d, len_d, rv_d):
        return align_batch(
            probe_tab, member_d, codes_d, qual_d, len_d, rv_d,
            one, one, zero, zero, zero,
            k=K, has_mrq=False, has_mkq=False, has_mg=False,
            with_aggregate=True,
        )[1]

    # pre-stage batches on device
    n_batches = N_READS // BATCH
    staged = []
    t0 = time.perf_counter()
    for i in range(n_batches):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        staged.append((
            jnp.asarray(reads.codes[sl]),
            jnp.asarray(reads.qual[sl]),
            jnp.asarray(reads.lengths[sl]),
            jnp.ones(BATCH, dtype=bool),
        ))
    jax.block_until_ready(staged[-1])
    log(f"staging {n_batches} batches: {time.perf_counter() - t0:.2f}s")

    # compile + warmup
    t0 = time.perf_counter()
    agg = run_batch(*staged[0])
    jax.block_until_ready(agg)
    compile_s = time.perf_counter() - t0
    log(f"compile+first batch: {compile_s:.2f}s")
    log(f"sanity: unique={int(agg.n_unique)} amb={int(agg.n_ambiguous)} "
        f"unmapped={int(agg.n_unmapped)} of {BATCH}")

    # timed steady-state: async dispatch all, block at end
    t0 = time.perf_counter()
    results = [run_batch(*s) for s in staged]
    jax.block_until_ready(results)
    align_s = time.perf_counter() - t0
    reads_per_s = n_batches * BATCH / align_s
    probes_per_s = reads_per_s * (READ_LEN - K + 1)
    log(f"aligned {n_batches * BATCH} reads in {align_s:.3f}s")
    log(f"throughput: {reads_per_s:,.0f} reads/s, {probes_per_s / 1e6:,.1f} M probes/s")

    # release the staged headline buffers (holding ~160 MB of dead
    # batches + AggResults on device measurably slows later sections)
    del staged, results, agg
    import gc
    gc.collect()


    # per-stage device profile of the default path: is XLA at the
    # bound, and where does align time go?  Times each stage
    # as its own jitted program on data already on device.
    stage_ms = {}
    try:
        from shotgun_tpu.models import pipeline as _pl
        from shotgun_tpu.ops.encode import (
            rolling_encode_jnp, unpack_codes_2bit)
        from shotgun_tpu.ops.probe_sort import SortedTableDev
        from shotgun_tpu.ops.probe_sort2 import probe_dedupe_sorted

        if isinstance(probe_tab, SortedTableDev):
            from shotgun_tpu.ops.encode import pack_codes_2bit as _pk

            lpad = ((READ_LEN + 31) // 32) * 32
            c0 = np.zeros((BATCH, lpad), dtype=np.uint8)
            c0[:, :READ_LEN] = reads.codes[:BATCH]
            cp_d = jnp.asarray(_pk(c0))
            len_d = jnp.asarray(reads.lengths[:BATCH])
            q_d = jnp.asarray(np.zeros((BATCH, 1), np.uint8))

            def timed(fn, *args, iters=8):
                jfn = jax.jit(fn)
                jax.block_until_ready(jfn(*args))
                t0 = time.perf_counter()
                out = None
                for _ in range(iters):
                    out = jfn(*args)
                jax.block_until_ready(out)
                return (time.perf_counter() - t0) / iters * 1e3

            def enc(cp, ln):
                c = unpack_codes_2bit(cp)
                lo, hi = rolling_encode_jnp(c, K)
                ok = _pl._window_ok(q_d, ln, K, c.shape[1] - K + 1,
                                    zero, False)
                return lo, hi, ok
            stage_ms["encode"] = round(timed(enc, cp_d, len_d), 3)
            lo, hi, okm = jax.jit(enc)(cp_d, len_d)

            def probe(lo, hi, ok):
                return probe_dedupe_sorted(
                    probe_tab, lo, hi, ok, num_sets=member.shape[0],
                    max_genome_count=member.shape[1])
            stage_ms["probe_sort_join"] = round(timed(probe, lo, hi, okm), 3)
            hit, sid_q, gc_q, focc = jax.jit(probe)(lo, hi, okm)

            def classify(hit, sid_q, gc_q, focc, ln):
                return _pl.core_from_probe(
                    (hit, sid_q, gc_q, None), member_d, q_d, ln,
                    one, one, zero, zero, zero, k=K, has_mrq=False,
                    has_mkq=False, has_mg=False, pre_first_occ=focc)
            stage_ms["classify"] = round(
                timed(classify, hit, sid_q, gc_q, focc, len_d), 3)
            res0 = jax.jit(classify)(hit, sid_q, gc_q, focc, len_d)
            rv0 = jnp.ones(BATCH, dtype=bool)
            stage_ms["aggregate"] = round(
                timed(_pl.aggregate_batch, res0, rv0), 3)
            log(f"stage profile (ms/batch of {BATCH}): {stage_ms}")
    except Exception as exc:
        log(f"stage profile failed: {exc!r}")

    extra = {
        "stage_profile_ms": stage_ms,
        "end_to_end_reads_per_sec": round(e2e_reads_per_s, 1),
        "end_to_end_reads_per_sec_best": round(e2e_best, 1),
        "e2e_pass_times_s": [round(t, 3) for t in pass_times],
        "kmer_probes_per_sec": round(probes_per_s, 1),
        "db_build_mbp_per_sec": round(total_mbp / build_s, 2),
        "db_build_vs_baseline": round(total_mbp / build_s / 0.05, 1),
        "end_to_end_vs_baseline": round(
            e2e_reads_per_s / BASELINE_READS_PER_SEC, 2),
        "compile_first_batch_s": round(compile_s, 2),
    }
    extra.update(align_task)

    def emit():
        # the harness takes the LAST stdout line; print + flush NOW so a
        # kill during any later optional section cannot lose the number
        # (round 2 lost its metric exactly this way, round 3 nearly did
        # to a harness timeout landing inside the warm-compile probe)
        print(json.dumps({
            "metric": "pseudo_align_reads_per_sec_k31",
            "value": round(reads_per_s, 1),
            "unit": "reads/s",
            "vs_baseline": round(reads_per_s / BASELINE_READS_PER_SEC, 2),
            "device": device,
            "extra": extra,
        }), flush=True)

    emit()

    # Later sections each re-emit the headline line (with the extras
    # gathered so far) as the new last stdout line.
    if warm_compile is not None:
        extra["warm_compile"] = warm_compile
        emit()
    if os.environ.get("BENCH_DEVBUILD", "1") == "1":
        try:
            extra.update(_devbuild_measure())
        except Exception as exc:  # recorded in the output, bench goes on
            extra["db_build_device"] = {"error": repr(exc)[:300]}
            log(f"device build bench failed: {exc!r}")
        emit()
    # multi-chip: measure for real when this process sees >1 device;
    # otherwise run the same code on a virtual 8-device CPU mesh in a
    # CPU-only subprocess (it never opens the card) so the plumbing is
    # proven: right code, no speed.
    if len(jax.devices()) > 1:
        extra["multichip"] = _multichip_measure()
        emit()
    elif os.environ.get("BENCH_MULTICHIP_CPU8", "1") == "1":
        res = _run_sub("multichip", timeout=600, env_extra={
            "JAX_PLATFORMS": "cpu",
            "SHOTGUN_TPU_PLATFORM": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
            "BENCH_READS": "16384",
            "BENCH_GENOMES": "3",
            "BENCH_GENOME_LEN": "30000",
            "BENCH_BATCH": "4096",
        })
        res["plumbing_check_only"] = True  # CPU mesh: wrong speed, right code
        if "scaling_efficiency" in res:
            # 8 VIRTUAL devices share the host's cores, so wall time
            # grows with total work regardless of sharding quality: no
            # efficiency is measurable here, only that the sharded
            # program compiles, runs, and sums correctly.
            res["wall_ratio_note"] = (
                "8 virtual CPU devices share the host cores; ratio "
                "reflects core oversubscription, not sharding overhead")
            res["per_chip_vs_1dev_ratio_virtual_smp"] = res.pop(
                "scaling_efficiency")
        extra["multichip_cpu8"] = res
        emit()


def _run_sub(mode: str, timeout: int, env_extra=None):
    """Run `python bench.py` in BENCH_MODE=<mode> as an isolated child;
    return its one-line JSON result or an error record."""
    env = dict(os.environ)
    env["BENCH_MODE"] = mode
    env.update(env_extra or {})
    try:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__)],
            capture_output=True, text=True, timeout=timeout, env=env,
        )
    except subprocess.TimeoutExpired:
        log(f"[{mode}] timed out after {timeout}s")
        return {"error": f"timeout after {timeout}s"}
    tail = (out.stderr or "")[-2000:]
    if out.returncode != 0:
        log(f"[{mode}] child failed rc={out.returncode}; stderr tail:\n{tail}")
        return {"error": f"rc={out.returncode}", "stderr_tail": tail[-500:]}
    line = (out.stdout or "").strip().splitlines()
    try:
        return json.loads(line[-1])
    except Exception as exc:
        log(f"[{mode}] unparseable child output: {exc}; stderr tail:\n{tail}")
        return {"error": f"unparseable output: {exc}"}


def _multichip_measure() -> dict:
    """WEAK-scaling sharded-align throughput: a fixed per-device read
    count (BENCH_READS) on 1 device vs every visible device, via the
    production ``align_aggregate_sharded`` path.  Weak scaling keeps the
    per-device work identical across both legs, so ``scaling_efficiency``
    measures collective/dispatch overhead rather than a fixed workload's
    inability to amortize N-way dispatch.  Runs on
    whatever mesh this process sees -- real chips or the virtual CPU mesh
    (BENCH_MODE=multichip child)."""
    import jax
    import jax.numpy as jnp

    from shotgun_tpu.index.build import build_index
    from shotgun_tpu.ops.encode import pack_codes_2bit
    from shotgun_tpu.parallel.mesh import (
        align_aggregate_sharded,
        make_mesh,
        shard_read_arrays,
    )
    from shotgun_tpu.reference import KmerReference
    from shotgun_tpu.utils.synth import synth_genomes, synth_reads

    n_dev_all = len(jax.devices())
    per_dev = N_READS
    n_total = per_dev * n_dev_all
    rng = np.random.default_rng(3)
    genomes = synth_genomes(rng, N_GENOMES, GENOME_LEN)
    reads = synth_reads(rng, genomes, n_total, READ_LEN)
    idx = build_index(genomes, K)
    ref = KmerReference(K, _index=idx)
    probe_tab = ref.device_probe_tables("sort")
    member = ref.set_member_dense()

    lpad = ((READ_LEN + 31) // 32) * 32
    codes = np.zeros((n_total, lpad), dtype=np.uint8)
    codes[:, :READ_LEN] = reads.codes
    codes_p = pack_codes_2bit(codes)
    qual = np.zeros((n_total, 1), dtype=np.uint8)
    valid = np.ones(n_total, dtype=bool)
    m_t = p_t = jnp.int32(1)
    z = jnp.int32(0)

    def rate(devs) -> float:
        from jax.sharding import NamedSharding, PartitionSpec as P

        mesh = make_mesh(devs)
        rep = NamedSharding(mesh, P())
        tab_r = jax.tree.map(lambda a: jax.device_put(a, rep), probe_tab)
        mem_r = jax.device_put(member, rep)
        b = per_dev * len(devs)  # weak scaling: fixed per-device shard
        sh = shard_read_arrays(
            mesh, codes_p[:b], qual[:b], reads.lengths[:b], valid[:b])
        kw = dict(mesh=mesh, k=K, has_mrq=False, has_mkq=False,
                  has_mg=False, packed=True)

        def run():
            return align_aggregate_sharded(
                tab_r, mem_r, *sh, m_t, p_t, z, z, z, **kw)
        jax.block_until_ready(run())  # compile
        t0 = time.perf_counter()
        agg = run()
        n_u = int(agg.n_unique) + int(agg.n_ambiguous) + int(agg.n_unmapped)
        dt = time.perf_counter() - t0
        assert n_u == b, (n_u, b)
        return b / dt

    devs = jax.devices()
    r1 = rate(devs[:1])
    rn = rate(devs)
    eff = (rn / len(devs)) / r1
    out = {
        "n_devices": len(devs),
        "reads_per_device": per_dev,
        "scaling_mode": "weak",
        "reads_per_sec_1dev": round(r1, 1),
        "reads_per_sec_total": round(rn, 1),
        "reads_per_sec_per_chip": round(rn / len(devs), 1),
        "scaling_efficiency": round(eff, 3),
    }
    log(f"multichip: {out}")
    return out


def _devbuild_measure() -> dict:
    """Device-side DB build rate at 1 Mbp (baseline-parity corpus) and a
    larger scale point, in this process.  Warm calls timed (the
    build-once regime)."""
    from shotgun_tpu.reference import KmerReference
    from shotgun_tpu.utils.synth import synth_genomes

    rng = np.random.default_rng(0)
    out = {}

    def timed_build(genomes):
        # compile/load once, then best-of-3 warm calls: the metric claims
        # the steady-state build rate
        KmerReference.from_device_build(genomes, K)
        best, dref = float("inf"), None
        for _ in range(3):
            t0 = time.perf_counter()
            dref = KmerReference.from_device_build(genomes, K)
            best = min(best, time.perf_counter() - t0)
        return best, dref

    genomes = synth_genomes(rng, N_GENOMES, GENOME_LEN)
    total_mbp = N_GENOMES * GENOME_LEN / 1e6
    dt, dref = timed_build(genomes)
    out["db_build_device_mbp_per_sec"] = round(total_mbp / dt, 2)
    out["db_build_device_vs_baseline"] = round(total_mbp / dt / 0.05, 1)
    log(f"device build {total_mbp:.0f} Mbp (warm): {dt:.3f}s "
        f"({total_mbp / dt:.1f} Mbp/s, {dref.index.num_kmers} kmers)")
    del dref
    bulk_mbp = int(os.environ.get("BENCH_DEVBUILD_MBP", 32))
    if bulk_mbp:
        bulk = synth_genomes(rng, 8, bulk_mbp * 1_000_000 // 8)
        dt, dref = timed_build(bulk)
        out["db_build_device_bulk_mbp_per_sec"] = round(bulk_mbp / dt, 2)
        log(f"device build {bulk_mbp} Mbp (warm): {dt:.3f}s "
            f"({bulk_mbp / dt:.1f} Mbp/s, {dref.index.num_kmers} kmers)")
        # lazy device hash-table assembly at this scale (the auto probe
        # picks it above 8M keys; one-time cost, then aligns run at
        # hash speed instead of the per-batch table re-sort)
        try:
            import jax as _jax
            import time as _t

            t0 = _t.perf_counter()
            tab = dref.device_probe_tables("auto")
            _jax.block_until_ready(_jax.tree.leaves(tab))
            out["db_build_device_hash_assembly_s"] = round(
                _t.perf_counter() - t0, 2)
            out["db_build_device_auto_table"] = type(tab).__name__
        except Exception as exc:
            out["db_build_device_hash_assembly_error"] = repr(exc)[:200]
        del dref
        # many-records point: same total bases split over 1024 records.
        # Same gp bucket -> executable reused.
        bulk_r = synth_genomes(rng, 1024, bulk_mbp * 1_000_000 // 1024)
        dt, dref = timed_build(bulk_r)
        out["db_build_device_r1024_mbp_per_sec"] = round(bulk_mbp / dt, 2)
        log(f"device build {bulk_mbp} Mbp / 1024 records (warm): "
            f"{dt:.3f}s ({bulk_mbp / dt:.1f} Mbp/s, "
            f"{dref.index.num_kmers} kmers, {dref.index.num_sets} sets)")
    return out


def _warm_compile_probe():
    """Cold vs warm CLI dumpalign wall-clock with a fresh persistent
    compile cache: the warm run should skip XLA compilation entirely.

    Runs the real CLI (main.py -t dumpalign -g ... -k ... --reads ...) as
    subprocesses on a small corpus, one after another, while this process
    stays off the device; the only difference between the runs is the
    now-populated cache directory.  The cache is a private empty
    directory (JAX_COMPILATION_CACHE_DIR) because the probe measures a
    cold start on purpose.
    """
    from shotgun_tpu.utils.synth import synth_genomes, synth_reads, to_fasta, to_fastq

    rng = np.random.default_rng(7)
    genomes = synth_genomes(rng, 3, 30_000)
    reads = synth_reads(rng, genomes, 4096, READ_LEN)
    repo = os.path.dirname(os.path.abspath(__file__))
    result = {}
    with tempfile.TemporaryDirectory() as td:
        fa = os.path.join(td, "warm.fa")
        fq = os.path.join(td, "warm.fq")
        open(fa, "w").write(to_fasta(genomes))
        open(fq, "w").write(to_fastq(reads))
        env = dict(os.environ)
        env["JAX_COMPILATION_CACHE_DIR"] = os.path.join(td, "xla_cache")
        # count XLA compiles + persistent-cache hits inside each run via
        # jax.monitoring (utils/platform.enable_compile_stats): the warm
        # run must prove compile_count_warm == 0
        env["SHOTGUN_TPU_COMPILE_STATS"] = "1"
        cmd = [sys.executable, os.path.join(repo, "main.py"),
               "-t", "dumpalign", "-g", fa, "-k", str(K), "--reads", fq]
        outs = []

        def one_run(label):
            t0 = time.perf_counter()
            try:
                out = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=560, env=env)
            except subprocess.TimeoutExpired:
                result["error"] = f"{label} run timed out"
                return None
            dt = time.perf_counter() - t0
            if out.returncode != 0:
                result["error"] = (f"{label} rc={out.returncode}: "
                                   f"{(out.stderr or '')[-300:]}")
                return None
            outs.append(out.stdout)
            stats = {}
            for line in (out.stderr or "").splitlines():
                if line.startswith("SHOTGUN_TPU_COMPILE_STATS "):
                    try:
                        stats = json.loads(
                            line[len("SHOTGUN_TPU_COMPILE_STATS "):])
                    except ValueError:
                        pass
            result[f"compile_count_{label}"] = stats.get("backend_compiles")
            result[f"compile_secs_{label}"] = (
                round(stats["backend_compile_secs"], 2)
                if "backend_compile_secs" in stats else None)
            result[f"cache_hits_{label}"] = stats.get("cache_hits")
            log(f"warm-compile probe: {label} CLI dumpalign {dt:.2f}s "
                f"(compiles={stats.get('backend_compiles')}, "
                f"cache_hits={stats.get('cache_hits')}, "
                f"compile_secs={stats.get('backend_compile_secs')})")
            return round(dt, 2)

        cold = one_run("cold")
        if cold is None:
            return result
        result["cold_s"] = cold
        warm = one_run("warm")
        if warm is None:
            return result
        result["warm_s"] = warm
        result["output_identical"] = all(o == outs[0] for o in outs[1:])
    return result


if __name__ == "__main__":
    mode = os.environ.get("BENCH_MODE", "")
    if mode == "multichip":
        from shotgun_tpu.utils.platform import configure_platform

        configure_platform()
        print(json.dumps(_multichip_measure()), flush=True)
    else:
        main()
