"""The per-window device ops and the count products against plain numpy
references: rolling encode, window quality sums, the bucket-row hash
probe, and the exactness of per-record counts above 2048 windows."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from shotgun_tpu.index.build import rolling_encode_words
from shotgun_tpu.index.hashtable import EMPTY, build_probe_table
from shotgun_tpu.models.pipeline import UNIQUELY_MAPPED, core_from_probe
from shotgun_tpu.ops.encode import (
    mix32,
    rolling_encode_jnp,
    rolling_encode_words_jnp,
    window_quality_sums,
)
from shotgun_tpu.ops.probe import probe_kmers


@pytest.mark.parametrize("k", [7, 11, 31])
def test_rolling_encode_matches_host_encoder(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=(6, 97), dtype=np.uint8)
    lo, hi = rolling_encode_jnp(jnp.asarray(codes), k)
    for r in range(codes.shape[0]):
        words, valid = rolling_encode_words(codes[r], k)
        assert valid.all()
        np.testing.assert_array_equal(np.asarray(lo[r]), words[:, 0])
        np.testing.assert_array_equal(np.asarray(hi[r]), words[:, 1])


def test_rolling_encode_words_matches_host_encoder_k75():
    rng = np.random.default_rng(75)
    codes = rng.integers(0, 4, size=(3, 160), dtype=np.uint8)
    got = rolling_encode_words_jnp(jnp.asarray(codes), 75)
    for r in range(codes.shape[0]):
        words, _ = rolling_encode_words(codes[r], 75)
        # device tuple is most-significant word first
        for j, w in enumerate(got[::-1]):
            np.testing.assert_array_equal(np.asarray(w[r]), words[:, j])


@pytest.mark.parametrize("k", [11, 31])
def test_window_quality_sums_matches_sliding_sum(k):
    rng = np.random.default_rng(100 + k)
    qual = rng.integers(33, 127, size=(5, 150), dtype=np.uint8)
    got = np.asarray(window_quality_sums(jnp.asarray(qual), k))
    want = np.stack([
        np.array([int(qual[r, w: w + k].astype(np.int64).sum())
                  for w in range(150 - k + 1)])
        for r in range(qual.shape[0])])
    np.testing.assert_array_equal(got, want)


def _scan_reference(table, stash, lo, hi):
    """Plain bucket scan: the primary bucket's slots, then the stash."""
    nb = table.shape[0]
    hit = np.zeros(lo.shape, bool)
    sid = np.full(lo.shape, -1, np.int64)
    gc = np.zeros(lo.shape, np.int64)
    bucket = mix32(lo, hi) & np.uint32(nb - 1)
    for idx in np.ndindex(lo.shape):
        b = int(bucket[idx])
        rows = [table[b, s] for s in range(table.shape[1])
                if table[b, s, 2] != EMPTY] + list(stash)
        for row in rows:
            if row[0] == lo[idx] and row[1] == hi[idx]:
                hit[idx], sid[idx], gc[idx] = True, int(row[2]), int(row[3])
                break
    return hit, sid, gc


@pytest.mark.parametrize("with_stash", [False, True])
def test_hash_probe_matches_bucket_scan(with_stash):
    rng = np.random.default_rng(7 + with_stash)
    u = 3000
    klo = rng.integers(0, 2**32, size=u, dtype=np.uint32)
    khi = rng.integers(0, 2**30, size=u, dtype=np.uint32)
    sid = rng.integers(0, 500, size=u).astype(np.int32)
    gcs = rng.integers(1, 9, size=u).astype(np.int32)
    pt = build_probe_table(klo, khi, sid, gcs, slots_per_bucket=4)
    table, stash = pt.table.copy(), np.zeros((0, 4), np.uint32)
    if with_stash:
        # move some placed keys out of their buckets into the stash
        occ = np.argwhere(table[:, :, 2] != EMPTY)[:40]
        stash = np.stack([table[b, s] for b, s in occ])
        for b, s in occ:
            table[b, s, 2] = EMPTY
    # queries: half table keys, half random misses
    q = rng.integers(0, u, size=(8, 60))
    lo = klo[q].copy()
    hi = khi[q].copy()
    miss = rng.random(q.shape) < 0.5
    lo[miss] = rng.integers(0, 2**32, size=int(miss.sum()), dtype=np.uint32)
    hit, got_sid, got_gc, pos = jax.jit(probe_kmers)(
        jnp.asarray(table), jnp.asarray(stash), jnp.asarray(lo),
        jnp.asarray(hi))
    want_hit, want_sid, want_gc = _scan_reference(table, stash, lo, hi)
    np.testing.assert_array_equal(np.asarray(hit), want_hit)
    np.testing.assert_array_equal(np.asarray(got_sid), want_sid)
    np.testing.assert_array_equal(np.asarray(got_gc)[want_hit],
                                  want_gc[want_hit])
    # slot positions identify keys: equal keys <-> equal positions
    pos = np.asarray(pos)
    assert ((pos >= 0) == want_hit).all()
    keys = (lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32)))
    for p in np.unique(pos[pos >= 0]):
        assert np.unique(keys[pos == p]).size == 1


def count_exactness_case():
    """One read whose per-record totals sit just past 2048 windows in one
    genome-set: records r0..r3; set 0 = {r0, r2} on 2051 windows, set 1 =
    {r1, r3} on 2048 windows, set 2 = {r1} (the only specific set) on 2
    windows.  Exact totals: r0 = r2 = 2051, r1 = 2050, so r1 wins and
    2051 - 2050 = 1 is not above p = 1: a unique mapping.  Rounded to
    TF32's 11-bit significand 2051 becomes 2052, the gap becomes 2, and
    the read would be downgraded to ambiguous."""
    w = 2051 + 2048 + 2
    sid = np.concatenate([np.zeros(2051), np.ones(2048),
                          np.full(2, 2)]).astype(np.int32)[None, :]
    gcount = np.where(sid == 2, 1, 2).astype(np.int32)
    hit = np.ones((1, w), bool)
    member = np.zeros((8, 8), np.uint8)
    member[0, [0, 2]] = 1
    member[1, [1, 3]] = 1
    member[2, 1] = 1
    args = ((jnp.asarray(hit), jnp.asarray(sid), jnp.asarray(gcount), None),
            jnp.asarray(member), jnp.zeros((1, 1), jnp.uint8),
            jnp.asarray([w + 30], jnp.int32),
            jnp.int32(1), jnp.int32(1), jnp.int32(0), jnp.int32(0),
            jnp.int32(0))
    kw = dict(k=31, has_mrq=False, has_mkq=False, has_mg=False,
              pre_first_occ=jnp.asarray(hit))
    return args, kw


def _dot_precisions(jaxpr):
    """precision of every dot_general, nested jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for x in (v if isinstance(v, (tuple, list)) else (v,)):
                sub = getattr(x, "jaxpr", x)
                if hasattr(sub, "eqns"):
                    out.extend(_dot_precisions(sub))
    return out


def test_counts_exact_above_2048_windows_in_one_set():
    args, kw = count_exactness_case()
    res = core_from_probe(*args, **kw)
    assert int(res.mtype[0]) == UNIQUELY_MAPPED
    assert int(res.winner[0]) == 1
    assert not bool(res.downgraded[0])
    # every count product asks for full float32 precision (on a GPU the
    # default may be TF32, which this case would catch as a downgrade)
    jaxpr = jax.make_jaxpr(lambda *a: core_from_probe(*a, **kw))(*args)
    precisions = _dot_precisions(jaxpr.jaxpr)
    assert precisions
    highest = jax.lax.Precision.HIGHEST
    assert all(p == (highest, highest) for p in precisions), precisions


@pytest.mark.gpu
def test_counts_exact_above_2048_windows_on_gpu(gpu_device):
    args, kw = count_exactness_case()
    args = jax.device_put(args, gpu_device)
    res = jax.jit(lambda *a: core_from_probe(*a, **kw))(*args)
    assert int(res.mtype[0]) == UNIQUELY_MAPPED
    assert int(res.winner[0]) == 1


@pytest.mark.gpu
def test_hash_probe_matches_bucket_scan_on_gpu(gpu_device):
    rng = np.random.default_rng(11)
    u = 5000
    klo = rng.integers(0, 2**32, size=u, dtype=np.uint32)
    khi = rng.integers(0, 2**30, size=u, dtype=np.uint32)
    pt = build_probe_table(klo, khi, np.arange(u, dtype=np.int32),
                           np.ones(u, np.int32), slots_per_bucket=16)
    q = rng.integers(0, u, size=(4, 50))
    lo, hi = klo[q], khi[q]
    dev = jax.device_put((pt.table, pt.stash, lo, hi), gpu_device)
    hit, sid, _, _ = jax.jit(probe_kmers)(*dev)
    want_hit, want_sid, _ = _scan_reference(pt.table, pt.stash, lo, hi)
    np.testing.assert_array_equal(np.asarray(hit), want_hit)
    np.testing.assert_array_equal(np.asarray(sid), want_sid)
