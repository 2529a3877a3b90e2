"""Tensor-parallel (sharded-table) probe: output must be invariant to the
('data', 'table') mesh shape and equal the single-device result exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from shotgun_tpu.index.build import build_index
from shotgun_tpu.models.pipeline import align_batch
from shotgun_tpu.ops.probe_sort import SortedTableDev, sorted_table_host
from shotgun_tpu.parallel.mesh import replicate, shard_read_arrays
from shotgun_tpu.parallel.table_sharded import (
    align_aggregate_table_sharded,
    device_put_sharded_table,
    make_mesh_2d,
    pad_table_for_sharding,
)
from shotgun_tpu.reference import KmerReference
from shotgun_tpu.utils.synth import synth_genomes, synth_reads

K, L, B = 11, 60, 64


def _setup():
    rng = np.random.default_rng(7)
    genomes = synth_genomes(rng, 4, 3000)
    reads = synth_reads(rng, genomes, B, L)
    idx = build_index(genomes, K)
    ref = KmerReference(K, _index=idx)
    member = ref.set_member_dense()
    tab_host = sorted_table_host(idx)
    return reads, member, tab_host


@pytest.mark.parametrize("data,table", [(4, 2), (2, 4), (1, 8), (8, 1)])
def test_table_sharded_matches_single_device(data, table):
    if len(jax.devices()) < data * table:
        pytest.skip("needs 8 virtual devices")
    reads, member, tab_host = _setup()
    one = jnp.int32(1)
    zero = jnp.int32(0)
    kw = dict(k=K, has_mrq=False, has_mkq=True, has_mg=True)

    # single-device reference result
    tab1 = SortedTableDev(*map(jnp.asarray, tab_host))
    _, agg1 = align_batch(
        tab1, jnp.asarray(member),
        jnp.asarray(reads.codes), jnp.asarray(reads.qual),
        jnp.asarray(reads.lengths), jnp.ones(B, bool),
        one, one, zero, jnp.int32(60), jnp.int32(2),
        with_aggregate=True, **kw)

    mesh = make_mesh_2d(jax.devices()[: data * table], data=data, table=table)
    tab_p = pad_table_for_sharding(tab_host, table)
    tab_d = device_put_sharded_table(mesh, tab_p)
    (member_d,) = replicate(mesh, member)
    codes_d, qual_d, len_d, rv_d = shard_read_arrays(
        mesh, reads.codes, reads.qual, reads.lengths, np.ones(B, bool))
    agg_n = align_aggregate_table_sharded(
        tab_d, member_d, codes_d, qual_d, len_d, rv_d,
        one, one, zero, jnp.int32(60), jnp.int32(2),
        mesh=mesh, **kw)

    for field in agg1._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(agg1, field)), np.asarray(getattr(agg_n, field)),
            err_msg=f"{field} differs on {data}x{table} mesh")


def test_hash_probe_rejected_under_table_sharding():
    """The bucketized hash table cannot range-partition; the TP entry
    points reject it with a clear error instead of failing opaquely."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    from shotgun_tpu.io.records import SeqRecord
    from shotgun_tpu.reference import KmerReference as KR

    recs = [SeqRecord([("description", "g"), ("genome", "ACGTACGTACGTACG")])]
    ref = KR(K, recs)
    hash_tab = ref.device_probe_tables("hash")
    mesh = make_mesh_2d(jax.devices()[:2], data=1, table=2)
    with pytest.raises(TypeError, match="sort-merge probe only"):
        device_put_sharded_table(mesh, hash_tab)
    with pytest.raises(TypeError, match="sort-merge probe only"):
        align_aggregate_table_sharded(
            hash_tab, jnp.zeros((1, 8), jnp.uint8),
            jnp.zeros((8, 32), jnp.uint8), jnp.zeros((8, 32), jnp.uint8),
            jnp.zeros(8, jnp.int32), jnp.ones(8, bool),
            jnp.int32(1), jnp.int32(1), jnp.int32(0), jnp.int32(0),
            jnp.int32(0),
            mesh=mesh, k=K, has_mrq=False, has_mkq=False, has_mg=False)


def _downgrade_corpus():
    """Reads engineered to exercise MRQ filtering and the p-downgrade
    quirk: genome A has a read-specific prefix; genomes B and C share a
    segment, so a read = A-prefix + shared-segment wins on specific
    k-mers (A) but loses on totals (B, C) -> downgraded ambiguous with
    the winner double-counted (reference kmer.py:464-480)."""
    rng = np.random.default_rng(99)
    bases = np.array(list("ACGT"))
    mk = lambda n: "".join(rng.choice(bases, size=n))
    a = mk(200)
    shared = mk(120)
    b = mk(60) + shared + mk(40)
    c = shared + mk(100)
    genomes = [("gA", a), ("gB", b), ("gC", c)]

    reads = []
    for i in range(B):
        kind = i % 4
        if kind == 0:      # downgrade candidate: 20bp of A + 40bp shared
            seq = a[:20] + shared[:40]
            qual = "I" * 60
        elif kind == 1:    # MRQ-filtered: low mean quality
            seq = a[20:80]
            qual = "#" * 60
        elif kind == 2:    # clean unique read from A
            start = rng.integers(0, len(a) - L)
            seq = a[start: start + L]
            qual = "I" * 60
        else:              # unmapped noise
            seq = mk(L)
            qual = "I" * 60
        reads.append((f"r{i}", seq, qual))
    return genomes, reads


@pytest.mark.parametrize("data,table", [(4, 2), (2, 4)])
def test_table_sharded_mrq_and_downgrade(data, table):
    """TP result equals single-device with MRQ on and downgrade-quirk
    reads present (MKQ/MG alone leave these paths uncovered)."""
    if len(jax.devices()) < data * table:
        pytest.skip("needs 8 virtual devices")
    from shotgun_tpu.io.packing import pack_reads
    from shotgun_tpu.io.records import SeqRecord
    from shotgun_tpu.reference import KmerReference as KR

    genomes, reads = _downgrade_corpus()
    recs = [SeqRecord([("description", d), ("genome", s)])
            for d, s in genomes]
    ref = KR(K, recs)
    batch = pack_reads([
        SeqRecord([("identifier", rid), ("sequence", s), ("space", ""),
                   ("quality_sequence", q)])
        for rid, s, q in reads
    ])
    member = ref.set_member_dense()
    idx = ref.index
    tab_host = sorted_table_host(idx)
    one = jnp.int32(1)
    mrq = jnp.int32(60)
    kw = dict(k=K, has_mrq=True, has_mkq=False, has_mg=False)

    tab1 = SortedTableDev(*map(jnp.asarray, tab_host))
    res1, agg1 = align_batch(
        tab1, jnp.asarray(member),
        jnp.asarray(batch.codes), jnp.asarray(batch.qual),
        jnp.asarray(batch.lengths), jnp.ones(B, bool),
        one, one, mrq, jnp.int32(0), jnp.int32(0),
        with_aggregate=True, **kw)
    # the corpus actually exercises what it claims to
    assert bool(np.asarray(res1.downgraded).any())
    assert int(agg1.n_filtered_reads) > 0
    assert int(agg1.n_ambiguous) > 0 and int(agg1.n_unique) > 0

    mesh = make_mesh_2d(jax.devices()[: data * table], data=data, table=table)
    tab_d = device_put_sharded_table(mesh, pad_table_for_sharding(tab_host, table))
    (member_d,) = replicate(mesh, member)
    codes_d, qual_d, len_d, rv_d = shard_read_arrays(
        mesh, batch.codes, batch.qual, batch.lengths, np.ones(B, bool))
    agg_n = align_aggregate_table_sharded(
        tab_d, member_d, codes_d, qual_d, len_d, rv_d,
        one, one, mrq, jnp.int32(0), jnp.int32(0),
        mesh=mesh, **kw)
    for field in agg1._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(agg1, field)), np.asarray(getattr(agg_n, field)),
            err_msg=f"{field} differs on {data}x{table} mesh")
