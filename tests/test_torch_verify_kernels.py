"""The plain versions of the verify's two kernels against the JAX
package's device programs, on the CPU.

galah_tpu_torch/ops/pair_table.py::_pair_table_plain is what K7
(csrc/pair_table_verify.cu) is held to on the card, bit for bit;
ops/fragment_ani.py::_forward_plain what K8 (csrc/grouped_verify.cu) is
held to. Batches are made with numpy from a seed: fragment streams laid
out in an arena (with junk before and between them, so streams start at
non-zero offsets), target bitmaps that hold a parent source's buckets at
a per-fragment rate plus random background bits, and rows of a bitmap
pool in random order. The same arrays go through the JAX package's
_pair_table_kernel and _forward_kernel, run on the CPU as its own tests
run them. Pair table: AF and ANI exact (every sum is an integer in
2^-14 fixed point). Grouped: AF exact, ANI within ANI_TOL = 1e-3
percentage points, as tests/test_torch_verify.py holds the float32
identity sums of the two frameworks. The pair-table batches come from
galah_tpu_torch/utils/synth.py::pair_table_batch, as the card's checks
of K7 do. The file also holds the kernels' launch plan
(verify_launch_plan, check_rows) to its table, and every producer of
the verify's streams to the order the kernels' row slices need."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from galah_tpu.ops import fragment_ani as jax_fa
from galah_tpu.ops import pair_table as jax_pt
from galah_tpu_torch.ops import fragment_ani as fa
from galah_tpu_torch.ops import pair_table as pt
from galah_tpu_torch.utils.synth import (
    fragment_sources,
    pair_table_args,
    pair_table_batch,
    target_bitmaps,
)

ANI_TOL = 1e-3
BITS = 1 << 20        # a width where popcount bits - 1 meets the 1e-6 clamp
K = 15
MIN_HASHES = 8
MIN_IDENT = fa.FragmentAniConfig().min_fragment_identity


def _all_pairs(n_src, g):
    return [(s, t) for s in range(n_src) for t in range(g)]


PAIR_CASES = {
    "random": dict(n_src=4, frags=12, sizes=(30, 60, 120), g=4,
                   pairs=_all_pairs(4, 4)),
    "ragged": dict(n_src=5, frags=9, sizes=(0, 1, 7, 8, 9, 33, 400), g=3,
                   pairs=[(0, 0), (0, 2), (3, 1), (4, 0), (1, 1), (2, 2),
                          (4, 2)]),
    "one-pair": dict(n_src=2, frags=20, sizes=(50, 80), g=2,
                     pairs=[(1, 1)]),
    "shared-source": dict(n_src=1, frags=15, sizes=(40, 90), g=6,
                          pairs=_all_pairs(1, 6)),
    "under-min-hashes": dict(n_src=3, frags=10, sizes=(2, 5, 7, 8, 9), g=3,
                             pairs=_all_pairs(3, 3)),
    "near-full-bitmap": dict(n_src=3, frags=10, sizes=(20, 60), g=3,
                             pairs=_all_pairs(3, 3), full=True),
    "arena-offsets": dict(n_src=3, frags=8, sizes=(25, 70), g=2,
                          pairs=[(2, 0), (1, 1), (2, 1)], lead=1234),
    "single-fragment": dict(n_src=1, frags=1, sizes=(300,), g=1,
                            pairs=[(0, 0)], lead=17),
}


def _batch(seed, **case):
    return pair_table_batch(seed, bits=BITS, **case)


def _port_pair_table(b, fn):
    return fn(*pair_table_args(b, "cpu"), BITS, K, MIN_HASHES, MIN_IDENT)


def _jax_pair_table(b):
    ani, af = jax_pt._pair_table_kernel(
        jnp.asarray(b["ustream"]), jnp.asarray(b["ufrag_offsets"]),
        jnp.asarray(b["pool"]), jnp.asarray(b["popcounts"]),
        jnp.asarray(b["psrc"]), jnp.asarray(b["pfs"]), jnp.asarray(b["puf"]),
        jnp.asarray(b["pffs"]), jnp.asarray(b["pref"].astype(np.int32)),
        jnp.asarray(b["prow"].astype(np.int32)), jnp.int32(b["n_flat"]),
        jnp.int32(b["n_flat_frags"]), flatn=b["n_flat"],
        flatf=b["n_flat_frags"], bits=BITS, k=K, min_hashes=MIN_HASHES,
        min_ident=MIN_IDENT)
    return np.asarray(ani), np.asarray(af)


@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_pair_table_plain_matches_jax(case):
    b = _batch(sum(map(ord, case)), **PAIR_CASES[case])
    got_ani, got_af = _port_pair_table(b, pt._pair_table_plain)
    want_ani, want_af = _jax_pair_table(b)
    np.testing.assert_array_equal(got_af.numpy(), want_af)
    np.testing.assert_array_equal(got_ani.numpy(), want_ani)
    assert got_ani.dtype == got_af.dtype == torch.float32
    if case == "random":
        # parents give aligned fragments, the other pairs mostly none
        assert (want_af > 0.3).any() and (want_af < 0.1).any()


def test_pair_table_wrapper_takes_the_plain_version_on_the_cpu():
    b = _batch(3, **PAIR_CASES["random"])
    before = pt._pair_table_kernel.launches
    got = _port_pair_table(
        b, lambda *a: pt._pair_table_kernel(*a, shard=3))
    want = _port_pair_table(b, pt._pair_table_plain)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert pt._pair_table_kernel.launches == before
    assert pt._pair_table_kernel.per_shard[3] == 0


@pytest.mark.parametrize("bits,flat_frags,match", [
    (3 << 12, 10, "power of two"),
    (BITS, 1 << 17, "overflow"),
])
def test_pair_table_wrapper_rejects_what_the_kernel_does_not_take(
        bits, flat_frags, match):
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        pt._pair_table_kernel(z, z, z[None], z.float(), z[:1], z, z[:1], z,
                              z[:1].long(), z[:1].long(), 0, flat_frags,
                              bits, K, MIN_HASHES, MIN_IDENT)


# ------------------------------------------------------------- grouped

GROUPED_CASES = {
    "random": dict(frags=40, sizes=(30, 90, 200), refs=6),
    "ragged": dict(frags=25, sizes=(0, 1, 7, 8, 9, 500), refs=3),
    "under-min-hashes": dict(frags=12, sizes=(3, 6, 7), refs=2),
    "near-full-bitmap": dict(frags=15, sizes=(40, 120), refs=3, full=True),
    "single-fragment": dict(frags=1, sizes=(250,), refs=1),
}


def _grouped(seed, *, frags, sizes, refs, full=False):
    """One query stream of `frags` fragments against `refs` targets (the
    first refs - 1 hold it at per-fragment rates) in a pool of 2 refs + 1
    rows in random order."""
    rng = np.random.default_rng(seed)
    src = fragment_sources(rng, 1, frags, sizes, BITS)
    words, popc = target_bitmaps(
        rng, src * (refs - 1) + fragment_sources(rng, 1, 3, (50,), BITS),
        refs, BITS, full) if refs > 1 else target_bitmaps(rng, src, refs,
                                                          BITS, full)
    buckets = np.concatenate(src[0]).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum([len(f) for f in src[0]])]
                             ).astype(np.int32)
    rows = rng.permutation(2 * refs + 1)[:refs].astype(np.int64)
    pool = np.zeros((2 * refs + 1, BITS // 32), np.uint32)
    pool[rows] = words
    return dict(words=words, popc=popc, buckets=buckets, offsets=offsets,
                rows=rows, pool=pool)


def _port_grouped(g, fn):
    return fn(torch.from_numpy(g["pool"].view(np.int32)),
              torch.from_numpy(g["rows"]), torch.from_numpy(g["popc"]),
              torch.from_numpy(g["buckets"]), torch.from_numpy(g["offsets"]),
              bits=BITS, k=K, min_hashes=MIN_HASHES, min_ident=MIN_IDENT)


def _jax_grouped(g):
    n, f = len(g["buckets"]), len(g["offsets"]) - 1
    npad = jax_fa._round_up(n, 1 << 14)
    fpad = jax_fa._round_up(f, 1 << 9)
    buckets = np.zeros(npad, np.int32)
    buckets[:n] = g["buckets"]
    offsets = np.full(fpad + 1, n, np.int32)
    offsets[:f + 1] = g["offsets"]
    ani, af = jax_fa._forward_kernel(
        jnp.asarray(g["words"]), jnp.asarray(g["popc"]), jnp.asarray(buckets),
        jnp.asarray(offsets), jnp.int32(n), bits=BITS, k=K,
        min_hashes=MIN_HASHES, min_ident=MIN_IDENT)
    return np.asarray(ani), np.asarray(af)


@pytest.mark.parametrize("case", sorted(GROUPED_CASES))
def test_forward_plain_matches_jax(case):
    g = _grouped(sum(map(ord, case)), **GROUPED_CASES[case])
    got_ani, got_af = _port_grouped(g, fa._forward_plain)
    want_ani, want_af = _jax_grouped(g)
    np.testing.assert_array_equal(got_af.numpy(), want_af)
    np.testing.assert_allclose(got_ani.numpy(), want_ani, rtol=0,
                               atol=ANI_TOL)
    if case == "random":
        # the query's holders over the unrelated target (small fragments
        # over random background bits align now and then)
        assert want_af[:-1].min() > 0.3 and want_af[:-1].min() > want_af[-1]


def test_forward_wrapper_takes_the_plain_version_on_the_cpu():
    g = _grouped(5, **GROUPED_CASES["random"])
    before = fa._forward_kernel.launches
    got = _port_grouped(g, lambda *a, **k: fa._forward_kernel(
        *a, shard=2, **k))
    want = _port_grouped(g, fa._forward_plain)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert fa._forward_kernel.launches == before
    assert fa._forward_kernel.per_shard[2] == 0


def test_forward_wrapper_rejects_a_width_not_a_power_of_two():
    g = _grouped(6, **GROUPED_CASES["single-fragment"])
    with pytest.raises(ValueError, match="power of two"):
        fa._forward_kernel(
            torch.from_numpy(g["pool"].view(np.int32)),
            torch.from_numpy(g["rows"]), torch.from_numpy(g["popc"]),
            torch.from_numpy(g["buckets"]), torch.from_numpy(g["offsets"]),
            bits=3 << 12, k=K, min_hashes=MIN_HASHES, min_ident=MIN_IDENT)


# ----------------------------------------------- the kernels' launch plan

# bits -> (cluster, slice_bits, smem_bytes): one block holds a row of up
# to 2^20 bits (128 KiB), a cluster of 2 or 4 blocks the rows of 2^21 and
# 2^22 bits, the widest the sketch parameters give.
PLAN_TABLE = {**{1 << e: (1, 1 << e, 1 << (e - 3)) for e in range(7, 21)},
              1 << 21: (2, 1 << 20, 1 << 17),
              1 << 22: (4, 1 << 20, 1 << 17)}


@pytest.mark.parametrize("bits", sorted(PLAN_TABLE))
def test_verify_launch_plan(bits):
    plan = pt.verify_launch_plan(bits)
    assert tuple(plan) == PLAN_TABLE[bits]
    assert plan.cluster * plan.slice_bits == bits
    assert plan.smem_bytes == plan.slice_bits // 8 <= 1 << 17


@pytest.mark.parametrize("bits", [0, 1 << 5, 1 << 6, 1 << 23, 1 << 24,
                                  3 << 12])
def test_verify_launch_plan_refuses_other_widths(bits):
    with pytest.raises(ValueError):
        pt.verify_launch_plan(bits)


@pytest.mark.parametrize("lead,words,match", [
    (0, 1 << 14, "words for"),
    (1, 1 << 15, "16-byte aligned"),
])
def test_check_rows(lead, words, match):
    """The rows the kernels' bulk copies take: exactly `bits` bits each,
    from a 16-byte aligned start (not one word into an allocation)."""
    pool = torch.zeros(lead + 2 * words, dtype=torch.int32)[lead:]
    with pytest.raises(ValueError, match=match):
        pt.check_rows(pool.view(2, words), 1 << 20)
    pt.check_rows(torch.zeros((2, 1 << 15), dtype=torch.int32), 1 << 20)


# ------------------------------------------- stream order, as K7/K8 need it

def _jax_directory_sketches(paths, params, directory):
    """The JAX package's sketches of `paths`, written to a sketch
    directory by its PersistentSketchStore and read back by the port's."""
    import dataclasses

    from galah_tpu.sketch import fracminhash as jax_fmh
    from galah_tpu.sketch import store as jax_store
    from galah_tpu_torch.sketch import store

    jparams = jax_fmh.NativeSketchParams(**dataclasses.asdict(params))
    writer = jax_store.PersistentSketchStore(directory, jparams)
    for p in paths:
        writer.put(p, jax_fmh.sketch_file_native(p, jparams))
    reader = store.PersistentSketchStore(directory, params)
    return [reader.get(p) for p in paths]


def _stream_sketches(producer, tmp_path):
    """Sketches of a synthetic genome corpus and contig corpus from one
    producer of the verify's streams, at the widths the CLI picks."""
    from galah_tpu_torch.engines.native import _shrink_bits
    from galah_tpu_torch.ops import device_sketch as ds
    from galah_tpu_torch.sketch import store
    from galah_tpu_torch.sketch.fracminhash import (
        NativeSketchParams,
        sketch_contigs_native,
        sketch_file_native,
        small_genome_params,
    )
    from galah_tpu_torch.utils.synth import make_contig_corpus, make_families

    genomes, _ = make_families(str(tmp_path / "g"), 2, 2,
                               genome_length=60_000, seed=4)
    contigs = str(tmp_path / "c.fna")
    make_contig_corpus(contigs, 6, 3, contig_length=5_000, seed=5)
    gp = _shrink_bits(NativeSketchParams(), 60_000)
    cp = small_genome_params()
    cpu = torch.device("cpu")
    if producer == "host sketcher":
        return ([sketch_file_native(p, gp) for p in genomes]
                + sketch_contigs_native(contigs, cp))
    if producer == "K5 plain version":
        return (ds.device_sketch_files(genomes, gp, cpu)
                + ds.device_sketch_contig_files([contigs], cp, cpu)[0])
    if producer == "contig bundle":
        bundle = str(tmp_path / "bundle.npz")
        store.save_contig_sketches(bundle,
                                   sketch_contigs_native(contigs, cp))
        return store.load_contig_sketches(bundle)
    return _jax_directory_sketches(genomes, gp, str(tmp_path / "sk"))


@pytest.mark.parametrize("producer", [
    "host sketcher", "K5 plain version", "contig bundle",
    "JAX-written sketch directory"])
def test_streams_ascend_within_each_fragment(producer, tmp_path):
    """K7 and K8 find each block's slice of a fragment by a search, so
    every producer of the verify's streams must give buckets strictly
    ascending within each fragment, below the member bits."""
    sketches = _stream_sketches(producer, tmp_path)
    assert len(sketches) >= 4
    for sk in sketches:
        b = np.asarray(sk.frag_buckets, np.int64)
        off = np.asarray(sk.frag_offsets, np.int64)
        assert sk.n_fragments > 0 and off[-1] == len(b)
        rising = np.diff(b) > 0
        starts = off[1:-1]
        rising[starts[(starts > 0) & (starts < len(b))] - 1] = True
        assert rising.all(), sk.name
        assert b.size == 0 or (b.min() >= 0
                               and b.max() < sk.params.member_bits)
