"""Multi-chip tests on a virtual 8-device CPU mesh: dumpalign aggregation
must be invariant to shard count (exact integer collectives)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from shotgun_tpu.index.hashtable import build_probe_table
from shotgun_tpu.io.packing import pack_genomes, pack_reads
from shotgun_tpu.io.records import FASTAParser, FASTQParser
from shotgun_tpu.models.pipeline import align_batch
from shotgun_tpu.parallel.mesh import (
    align_aggregate_sharded,
    make_mesh,
    replicate,
    shard_read_arrays,
)
from shotgun_tpu.reference import KmerReference

import random

QUALITY_CHARS = (
    r"`1234567890-=qwertyuiop[]\asdfghjkl;'zxcvbnm,./"
    r'~!@#$%^&*()_+QWERTYUIOP{}|ASDFGHJKL:"ZXCVBNM<>?'
)


def _setup(seed=0, n_reads=64, read_len=40, k=11):
    rng = random.Random(seed)
    shared = "".join(rng.choice("ACGT") for _ in range(120))
    fasta = ""
    genomes = []
    for gi in range(4):
        seq = (shared[:60] if gi % 2 else "") + "".join(
            rng.choice("ACGT") for _ in range(120))
        genomes.append(seq)
        fasta += f">g{gi}\n{seq}\n"
    fastq_lines = []
    for ri in range(n_reads):
        if rng.random() < 0.7:
            src = genomes[rng.randrange(4)]
            s = rng.randrange(0, len(src) - read_len)
            seq = src[s: s + read_len]
        else:
            seq = "".join(rng.choice("ACGT") for _ in range(read_len))
        qual = "".join(rng.choice(QUALITY_CHARS) for _ in range(read_len))
        fastq_lines += [f"@r{ri}", seq, "+", qual]
    fp = FASTAParser(); fp.parse_records(fasta)
    qp = FASTQParser(); qp.parse_records("\n".join(fastq_lines) + "\n")
    ref = KmerReference(k, list(fp))
    batch = pack_reads(list(qp))
    return ref, batch


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_shard_count_invariance(n_shards):
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    ref, batch = _setup()
    k = ref.index.k
    probe_tab = ref.device_probe_tables()
    member = ref.set_member_dense()
    b = 64
    codes = batch.codes[:b]
    qual = batch.qual[:b]
    lengths = batch.lengths[:b].astype(np.int32)
    row_valid = np.ones(b, dtype=bool)

    # single-device truth
    _, agg1 = align_batch(
        probe_tab, jnp.asarray(member),
        jnp.asarray(codes), jnp.asarray(qual), jnp.asarray(lengths),
        jnp.asarray(row_valid),
        jnp.int32(1), jnp.int32(1), jnp.int32(0), jnp.int32(0), jnp.int32(0),
        k=k, has_mrq=False, has_mkq=False, has_mg=False,
    )

    mesh = make_mesh(jax.devices()[:n_shards])
    from jax.sharding import NamedSharding, PartitionSpec as P
    rep = NamedSharding(mesh, P())
    probe_rep = jax.tree.map(lambda a: jax.device_put(a, rep), probe_tab)
    (member_d,) = replicate(mesh, member)
    codes_d, qual_d, len_d, rv_d = shard_read_arrays(
        mesh, codes, qual, lengths, row_valid)
    agg_n = align_aggregate_sharded(
        probe_rep, member_d, codes_d, qual_d, len_d, rv_d,
        jnp.int32(1), jnp.int32(1), jnp.int32(0), jnp.int32(0), jnp.int32(0),
        mesh=mesh, k=k, has_mrq=False, has_mkq=False, has_mg=False,
    )

    for field in agg1._fields:
        a = np.asarray(getattr(agg1, field))
        bfield = np.asarray(getattr(agg_n, field))
        np.testing.assert_array_equal(a, bfield, err_msg=field)


def test_sharded_summary_matches_host_path():
    """Full PseudoAlignment through an 8-way mesh-sharded aggregation must
    equal the plain path's summary."""
    ref, batch = _setup(seed=3, n_reads=48)
    from shotgun_tpu.aligner import PseudoAlignment

    plain = PseudoAlignment(ref)
    plain.align_packed_reads(batch, batch_size=48)

    mesh = make_mesh(jax.devices()[:8])
    sharded = PseudoAlignment(ref)
    sharded.align_packed_reads(batch, batch_size=48, mesh=mesh,
                               store_reads=False)
    assert sharded.get_summary() == plain.get_summary()
