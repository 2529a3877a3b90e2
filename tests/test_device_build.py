"""Device-side index build vs the host builder: exact equality of the
align-relevant structures (sorted keys, genome counts, set membership,
first-seen order) on randomized corpora including N runs, short records,
and duplicate genomes."""

import numpy as np
import pytest

from shotgun_tpu.index.build import build_index
from shotgun_tpu.index.device_build import device_build_tables
from shotgun_tpu.io.packing import pack_genomes
from shotgun_tpu.io.records import SeqRecord
from shotgun_tpu.reference import KmerReference
from shotgun_tpu.utils.synth import synth_genomes, synth_reads


def _genomes_from_strings(seqs):
    recs = [
        SeqRecord([("description", f"g{i}"), ("genome", s)])
        for i, s in enumerate(seqs)
    ]
    return pack_genomes(recs)


def _check_equal(genomes, k):
    host = build_index(genomes, k)
    dev = device_build_tables(genomes, k, KmerReference._pad_rows)
    assert dev is not None

    # v2 tables keep duplicate key rows (one per occurrence) -- the
    # probe's cummax join reads the last row of a run; dedupe on host
    # for the comparison and check payload consistency within groups
    klo = np.asarray(dev["klo"])
    khi = np.asarray(dev["khi"])
    sid = np.asarray(dev["sid"])
    gc = np.asarray(dev["gc"])
    live = gc > 0
    assert not ((khi < (1 << 31)) & ~live & (klo != 0xFFFFFFFF)).any()
    new = np.empty(klo.size, dtype=bool)
    new[0] = True
    new[1:] = (klo[1:] != klo[:-1]) | (khi[1:] != khi[:-1])
    dist = live & new
    assert dev["num_kmers"] == host.num_kmers == int(dist.sum())
    np.testing.assert_array_equal(klo[dist], host.kmer_lo)
    np.testing.assert_array_equal(khi[dist], host.kmer_hi)
    np.testing.assert_array_equal(gc[dist], host.genome_counts())
    # every duplicate row of a group carries the group's payload
    gid = np.cumsum(dist) - 1
    np.testing.assert_array_equal(sid[live], sid[dist][gid[live]])
    np.testing.assert_array_equal(gc[live], gc[dist][gid[live]])

    # set membership: the device's per-key mask must equal the host's
    masks_d = dev["set_masks"]
    width = max(masks_d.shape[1], host.set_masks.shape[1])
    md = np.zeros((masks_d.shape[0], width), dtype=np.uint8)
    md[:, : masks_d.shape[1]] = masks_d
    mh = np.zeros((host.num_sets, width), dtype=np.uint8)
    mh[:, : host.set_masks.shape[1]] = host.set_masks
    np.testing.assert_array_equal(md[sid[dist]], mh[host.set_id])


def test_device_build_matches_host_synthetic():
    rng = np.random.default_rng(0)
    genomes = synth_genomes(rng, 5, 3_000)
    _check_equal(genomes, 31)


def test_device_build_small_k():
    rng = np.random.default_rng(1)
    genomes = synth_genomes(rng, 3, 500)
    _check_equal(genomes, 11)


def test_device_build_with_ns_and_short_records():
    seqs = [
        "ACGTACGTACGTNNACGTACGTACGTACGT",
        "TTT",  # shorter than k -> contributes nothing at k=11
        "ACGTACGTACGTACGTACGTACGTACGTACGT",
        "NNNNNNNNNNNNNNNN",
        "ACGTACGTACGTACGT" * 4,
    ]
    _check_equal(_genomes_from_strings(seqs), 11)


def test_device_build_duplicate_genomes_share_sets():
    seqs = ["ACGTACGTACGTACGTACGTACG"] * 3 + ["TTTTTTTTTTTTTTTTTTTTTTT"]
    _check_equal(_genomes_from_strings(seqs), 21)


def test_device_build_rejects_unsupported():
    rng = np.random.default_rng(2)
    genomes = synth_genomes(rng, 2, 400)
    assert device_build_tables(genomes, 75, KmerReference._pad_rows) is None


def test_device_build_align_summary_matches():
    """End-to-end: aligning against a device-built reference produces the
    identical dumpalign summary as the host-built one."""
    from shotgun_tpu.aligner import PseudoAlignment

    rng = np.random.default_rng(3)
    genomes = synth_genomes(rng, 4, 2_000)
    reads = synth_reads(rng, genomes, 256, 100)

    ref_host = KmerReference(31, _index=build_index(genomes, 31))
    pa_host = PseudoAlignment(ref_host)
    pa_host.align_packed_reads(reads, 1, 1, store_reads=False)

    ref_dev = KmerReference.from_device_build(genomes, 31)
    assert ref_dev is not None
    pa_dev = PseudoAlignment(ref_dev)
    pa_dev.align_packed_reads(reads, 1, 1, store_reads=False)

    assert pa_host.get_summary() == pa_dev.get_summary()


def test_device_build_many_records():
    """R > 64: the v2 build is general in the record count (the r4 build
    capped R at 64 via its two-word mask scan)."""
    rng = np.random.default_rng(7)
    genomes = synth_genomes(rng, 200, 300)
    _check_equal(genomes, 21)


def test_device_build_r1024_with_shared_sets():
    """R >= 1024 with heavy multi-record sets (duplicated genomes force
    shared k-mers across many records) and N runs."""
    rng = np.random.default_rng(8)
    base = ["".join(rng.choice(list("ACGT"), size=60)) for _ in range(64)]
    seqs = []
    for i in range(1024):
        s = base[i % 64]
        if i % 5 == 0:
            s = s[:20] + "NN" + s[20:]
        seqs.append(s)
    _check_equal(_genomes_from_strings(seqs), 15)


def test_device_build_rejects_too_many_records():
    from shotgun_tpu.index.device_build import R_CAP

    seqs = ["ACGTACGTACGTACGT"] * (R_CAP + 1)
    genomes = _genomes_from_strings(seqs)
    assert device_build_tables(genomes, 11, KmerReference._pad_rows) is None


def test_device_build_align_summary_matches_many_records():
    """End-to-end at R = 96 (> the old 64-record cap) with multi sets."""
    from shotgun_tpu.aligner import PseudoAlignment

    rng = np.random.default_rng(9)
    genomes = synth_genomes(rng, 96, 400)
    reads = synth_reads(rng, genomes, 128, 60)

    ref_host = KmerReference(21, _index=build_index(genomes, 21))
    pa_host = PseudoAlignment(ref_host)
    pa_host.align_packed_reads(reads, 1, 1, store_reads=False)

    ref_dev = KmerReference.from_device_build(genomes, 21)
    assert ref_dev is not None
    pa_dev = PseudoAlignment(ref_dev)
    pa_dev.align_packed_reads(reads, 1, 1, store_reads=False)

    assert pa_host.get_summary() == pa_dev.get_summary()


def test_host_prep_native_equals_numpy(monkeypatch):
    """The native stpu_pack2 upload buffer must byte-match the numpy
    fallback (codes pack + sparse N-run deltas + offsets)."""
    from shotgun_tpu.index import device_build as db
    from shotgun_tpu.io import native as nat

    seqs = [
        "ACGTNNACGTACGTNACGTACGTACGTNNNNACGT",
        "NNNN",
        "ACGTACGTACGTACGTACGTACGTACGTACG",
        "TTTTNTTTT",
    ]
    genomes = _genomes_from_strings(seqs)
    out_nat = db._host_prep(genomes, 11, KmerReference._pad_rows)
    monkeypatch.setattr(nat, "pack2", lambda *a, **k: None)
    out_np = db._host_prep(genomes, 11, KmerReference._pad_rows)
    assert out_nat is not None and out_np is not None
    buf_a, gp_a = out_nat
    buf_b, gp_b = out_np
    assert gp_a == gp_b
    # run lists may order differently across threads; compare the delta
    # planes they imply plus the code/offset regions byte-for-byte
    nc = gp_a // 4
    np.testing.assert_array_equal(buf_a[:nc], buf_b[:nc])
    np.testing.assert_array_equal(buf_a[nc + 8 * db.NRUNS_CAP:],
                                  buf_b[nc + 8 * db.NRUNS_CAP:])

    def delta(buf):
        rr = buf[nc: nc + 8 * db.NRUNS_CAP].view("<i4")
        starts, ends = rr[:db.NRUNS_CAP], rr[db.NRUNS_CAP:]
        d = np.zeros(gp_a + 1, np.int64)
        np.add.at(d, starts, 1)
        np.add.at(d, ends, -1)
        return np.cumsum(d[:gp_a]) > 0
    np.testing.assert_array_equal(delta(buf_a), delta(buf_b))


def test_device_hash_table_probe_matches_host(monkeypatch):
    """Device-assembled 16-slot hash table: probing it returns the same
    (hit, sid, gc) as the host truth for present and absent keys, and
    the auto probe of a big device-built reference selects it."""
    import jax.numpy as jnp

    from shotgun_tpu.index.device_build import device_hash_table
    from shotgun_tpu.ops.probe import resolve_rows
    from shotgun_tpu.ops.encode import mix32

    rng = np.random.default_rng(21)
    genomes = synth_genomes(rng, 6, 5_000)
    k = 21
    host = build_index(genomes, k)
    built = device_build_tables(genomes, k, KmerReference._pad_rows)
    assert built is not None
    ht = device_hash_table(built)
    assert ht is not None
    table, stash = ht
    nb = table.shape[0]

    # queries: every distinct key + perturbed absent keys
    qlo = host.kmer_lo.copy()
    qhi = host.kmer_hi.copy()
    absent_lo = qlo ^ np.uint32(0x5)
    lo = jnp.asarray(np.concatenate([qlo, absent_lo])[None, :])
    hi = jnp.asarray(np.concatenate([qhi, qhi])[None, :])
    bidx = (mix32(lo, hi, jnp) & jnp.uint32(nb - 1)).astype(jnp.int32)
    rows = jnp.take(table, bidx, axis=0)
    hit, sid, gc, _pos = resolve_rows(rows, bidx, stash, lo, hi)
    hit = np.asarray(hit)[0]
    sid = np.asarray(sid)[0]
    gc = np.asarray(gc)[0]
    u = qlo.size

    assert hit[:u].all()
    np.testing.assert_array_equal(gc[:u], host.genome_counts())
    # sid numbering differs from the host's; compare via the member masks
    dev_masks = built["set_masks"]
    host_masks = np.zeros((host.num_sets, dev_masks.shape[1]), np.uint8)
    host_masks[:, : host.set_masks.shape[1]] = host.set_masks
    np.testing.assert_array_equal(
        dev_masks[sid[:u]], host_masks[host.set_id])
    # absent keys miss unless the perturbation collided with a real key
    present = set(zip(qlo.tolist(), qhi.tolist()))
    expect_absent = np.array(
        [(l, h) not in present
         for l, h in zip(absent_lo.tolist(), qhi.tolist())])
    assert not (hit[u:] & expect_absent).any()

    # auto selection: a device-built ref above the (patched) threshold
    # assembles and picks the hash16 table lazily on first use
    monkeypatch.setattr(KmerReference, "AUTO_HASH_MIN_KEYS", 1000)
    ref = KmerReference.from_device_build(genomes, k)
    assert "hash16" not in ref._device_tables  # lazy until first probe
    from shotgun_tpu.ops.probe import HashTableDev

    assert isinstance(ref.device_probe_tables("auto"), HashTableDev)
    assert "hash16" in ref._device_tables


def test_device_hash_aligns_like_host(monkeypatch):
    """End-to-end: dumpalign summary via the device hash table equals the
    host-built reference's."""
    from shotgun_tpu.aligner import PseudoAlignment

    monkeypatch.setattr(KmerReference, "AUTO_HASH_MIN_KEYS", 500)
    rng = np.random.default_rng(22)
    genomes = synth_genomes(rng, 4, 2_000)
    reads = synth_reads(rng, genomes, 256, 80)

    ref_host = KmerReference(21, _index=build_index(genomes, 21))
    pa_host = PseudoAlignment(ref_host)
    pa_host.align_packed_reads(reads, 1, 1, store_reads=False)

    ref_dev = KmerReference.from_device_build(genomes, 21)
    from shotgun_tpu.ops.probe import HashTableDev

    assert isinstance(ref_dev.device_probe_tables("auto"), HashTableDev)
    pa_dev = PseudoAlignment(ref_dev)
    pa_dev.align_packed_reads(reads, 1, 1, store_reads=False)
    assert pa_host.get_summary() == pa_dev.get_summary()
