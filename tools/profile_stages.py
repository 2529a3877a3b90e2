#!/usr/bin/env python3
"""Per-stage device timing of the default (sort-merge) align path.

Answers "is XLA at the bound on the production path, and which stage
dominates?"  Times each stage of
models/pipeline.align_batch_core (sorted v2 probe) as its own jitted
program on the attached device, then the fused whole for reference.

Usage: python tools/profile_stages.py [iters]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from shotgun_tpu.index.build import build_index
from shotgun_tpu.models import pipeline as pl
from shotgun_tpu.ops.encode import (
    pack_codes_2bit,
    rolling_encode_jnp,
    unpack_codes_2bit,
)
from shotgun_tpu.ops.probe_sort2 import probe_dedupe_sorted, _shift_pack, _bits_for
from shotgun_tpu.reference import KmerReference
from shotgun_tpu.utils.synth import synth_genomes, synth_reads

K = int(os.environ.get("BENCH_K", 31))
B = int(os.environ.get("BENCH_BATCH", 16384))
L = 150
ITERS = int(sys.argv[1]) if len(sys.argv) > 1 else 20


def timed(label, fn, *args):
    jfn = jax.jit(fn)
    out = jfn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = jfn(*args)
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) / ITERS * 1e3
    print(f"{label:34s} {ms:8.3f} ms")
    return ms


def main():
    print(f"device: {jax.devices()[0]}  B={B} L={L} K={K}")
    rng = np.random.default_rng(0)
    genomes = synth_genomes(rng, 5, 200_000)
    reads = synth_reads(rng, genomes, B, L)
    idx = build_index(genomes, K)
    ref = KmerReference(K, _index=idx)
    tab = ref.device_probe_tables("sort")
    member = jnp.asarray(ref.set_member_dense())
    print(f"table keys: {int(tab.klo.shape[0]):,}  sets: {member.shape}")

    lpad = ((L + 31) // 32) * 32
    codes = np.zeros((B, lpad), dtype=np.uint8)
    codes[:, :L] = reads.codes
    lengths = jnp.asarray(reads.lengths)
    codes_p = jnp.asarray(pack_codes_2bit(codes))
    qual_d = jnp.asarray(np.zeros((B, 1), dtype=np.uint8))

    w = lpad - K + 1
    n = B * w
    u = int(tab.klo.shape[0])
    print(f"join size: u={u:,} + n={n:,} = {u + n:,} rows")

    # --- stage 1: unpack + rolling encode + window mask ---
    def enc(codes_p, lengths):
        c = unpack_codes_2bit(codes_p)
        lo, hi = rolling_encode_jnp(c, K)
        ok = pl._window_ok(qual_d, lengths, K, c.shape[1] - K + 1,
                           jnp.int32(0), False)
        return lo, hi, ok
    t_enc = timed("1 unpack+encode+mask", enc, codes_p, lengths)
    lo, hi, ok = jax.jit(enc)(codes_p, lengths)

    # --- stage 2: the sorted join probe, whole ---
    def probe(lo, hi, ok):
        return probe_dedupe_sorted(tab, lo, hi, ok,
                                   num_sets=member.shape[0],
                                   max_genome_count=member.shape[1])
    t_probe = timed("2 probe_dedupe_sorted (join)", probe, lo, hi, ok)
    hit, sid, gc, focc = jax.jit(probe)(lo, hi, ok)

    # --- stage 2 split: main sort alone ---
    def join_sort(lo, hi, ok):
        qkh, qkl = _shift_pack(lo.reshape(-1), hi.reshape(-1), 1)
        ones = jnp.uint32(0xFFFFFFFF)
        okf = ok.reshape(-1)
        qkh = jnp.where(okf, qkh, ones)
        qkl = jnp.where(okf, qkl, ones)
        tkh, tkl = _shift_pack(tab.klo, tab.khi, 0)
        ckh = jnp.concatenate([tkh, qkh])
        ckl = jnp.concatenate([tkl, qkl])
        val = jnp.concatenate([
            jnp.arange(n, n + u, dtype=jnp.int32),
            jnp.arange(n, dtype=jnp.int32)])
        rbits = _bits_for(u)
        pb = 31 - rbits
        rank = jnp.arange(u, dtype=jnp.uint32)
        w0 = ((rank << jnp.uint32(pb))
              | (tab.sid.astype(jnp.uint32) & jnp.uint32((1 << pb) - 1))
              ).astype(jnp.int32)
        wq = jnp.full(n, np.int32(-1), jnp.int32)
        word = jnp.concatenate([w0, wq])
        return jax.lax.sort((ckh, ckl, val, word), num_keys=2,
                            is_stable=True)
    t_sort = timed("2a   main 2-key sort (4 ops)", join_sort, lo, hi, ok)

    # --- stage 2 split: restore sort alone ---
    sval = jnp.asarray(rng.permutation(n + u).astype(np.int32))
    aux1 = jnp.asarray(rng.integers(0, 1 << 30, n + u, dtype=np.int32))
    aux2 = jnp.asarray(rng.integers(0, 1 << 30, n + u, dtype=np.int32))
    aux3 = jnp.asarray(rng.integers(0, 4, n + u, dtype=np.int32))
    def restore(v, a, b_, c):
        return jax.lax.sort((v, a, b_, c), num_keys=1, is_stable=True)
    t_restore = timed("2b   restore 1-key sort (4 ops)", restore,
                      sval, aux1, aux2, aux3)

    # --- stage 3: classify (set reduction + m/p decision) ---
    zero = jnp.int32(0)
    one = jnp.int32(1)
    def classify(hit, sid, gc, focc, lengths):
        return pl.core_from_probe(
            (hit, sid, gc, None), member, qual_d, lengths,
            one, one, zero, zero, zero,
            k=K, has_mrq=False, has_mkq=False, has_mg=False,
            pre_first_occ=focc)
    t_cls = timed("3 classify (counts + m/p)", classify,
                  hit, sid, gc, focc, lengths)
    res = jax.jit(classify)(hit, sid, gc, focc, lengths)

    # --- stage 4: aggregate ---
    rv = jnp.ones(B, dtype=bool)
    t_agg = timed("4 aggregate_batch", pl.aggregate_batch, res, rv)

    # --- fused whole program (align_fold_batch body) ---
    carry = pl.init_fold_carry(member.shape[1])
    def fused(carry, codes_p, lengths):
        res = pl.align_batch_core(
            tab, member, codes_p, qual_d, lengths,
            one, one, zero, zero, zero,
            k=K, has_mrq=False, has_mkq=False, has_mg=False, packed=True)
        return pl._fold_agg(carry, pl.aggregate_batch(res, lengths > 0))
    t_all = timed("= fused align_fold_batch", fused, carry, codes_p, lengths)

    print(f"\nsum of stages: {t_enc + t_probe + t_cls + t_agg:.3f} ms"
          f"  (fused: {t_all:.3f} ms)")
    print(f"reads/s at fused: {B / t_all * 1e3:,.0f}")
    print(f"join sort share of probe: {t_sort / t_probe * 100:.0f}%"
          f"  restore share: {t_restore / t_probe * 100:.0f}%")


if __name__ == "__main__":
    main()
