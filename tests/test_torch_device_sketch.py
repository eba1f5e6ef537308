"""The port's device sketching (galah_tpu_torch/ops/device_sketch.py) on
the CPU, where it runs K5's plain version, sketch_batch_reference.

Each case gives the same NativeSketch arrays, bit for bit, from three
places: the port's device sketch, the port's host sketcher
(sketch_sequences_native, or the C++ one through the file entry points)
and the JAX package's device_sketch_batch, carried across with
native_sketch_from_fields. The engine's adoption of device-born rows
(the verify bitmap pool and the resident screen matrix) is held to the
host-filled rows."""

import dataclasses
import gzip

import numpy as np
import pytest
import torch

from galah_tpu.ops import device_sketch as jax_ds
from galah_tpu.sketch import fracminhash as jax_fmh
from galah_tpu_torch.ops import device_sketch as ds
from galah_tpu_torch.sketch import fracminhash as fmh
from galah_tpu_torch.sketch.fracminhash import (
    NativeSketchParams,
    mix64,
    sketch_contigs_native,
    sketch_file_native,
    sketch_sequences_native,
)
from galah_tpu_torch.utils.convert import (
    native_sketch_from_fields,
    pack_indicator,
    words_to_torch,
)

CPU = torch.device("cpu")
FIELDS = ("prefilter_buckets", "member_buckets", "frag_offsets", "frag_buckets")
_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _random_seq(rng, length, n_prob=0.0, lower_prob=0.0):
    seq = _BASES[rng.integers(0, 4, size=length)].copy()
    if n_prob:
        seq[rng.random(length) < n_prob] = ord("N")
    if lower_prob:
        seq[rng.random(length) < lower_prob] += 32
    return seq.tobytes()


def _params(kind: str, mod):
    """The same parameters as the port's and as the JAX package's
    NativeSketchParams."""
    if kind == "medium":
        return mod.NativeSketchParams(
            genome_scale=50, fragment_scale=4, fragment_length=700,
            prefilter_bits=1 << 12, member_bits=1 << 14,
            min_fragment_hashes=4, min_fragment_length=100,
        )
    return dataclasses.replace(mod.small_genome_params(fragment_length=1000),
                               prefilter_bits=1 << 12, member_bits=1 << 14)


def _assert_equal(got, want, check_dtype=True):
    assert got.total_len == want.total_len
    for f in FIELDS:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        if check_dtype:
            assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def _three_way(names, seq_lists, kind="medium"):
    """The port's device sketches of a batch, after checking them against
    the host sketcher and the JAX package's device_sketch_batch."""
    pp, jp = _params(kind, fmh), _params(kind, jax_fmh)
    got = ds.device_sketch_batch(names, seq_lists, pp, CPU)
    jax = jax_ds.device_sketch_batch(names, seq_lists, jp)
    for n, seqs, g, j in zip(names, seq_lists, got, jax):
        assert g.name == n
        _assert_equal(g, sketch_sequences_native(n, seqs, pp))
        _assert_equal(g, native_sketch_from_fields(j), check_dtype=False)
    return got


def test_mix64_int64_matches_numpy_uint64():
    """The plain version's splitmix64 in int64 (logical shifts by masking,
    products wrapping in two's complement) equals numpy's uint64 one."""
    x = np.concatenate([
        np.arange(1 << 16, dtype=np.uint64),
        np.array([0, 2**30 - 1, 2**32 - 1, 2**64 - 1], dtype=np.uint64),
    ])
    got = ds.mix64_torch(torch.from_numpy(x.view(np.int64))).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), mix64(x))


@pytest.mark.parametrize("t", [0, 1, 2**63 - 1, 2**63, 2**63 + 5,
                               2**64 // 10, 2**64 - 1])
def test_lt_u64_compares_as_unsigned(t):
    vals = np.array([0, 1, 2**31, 2**63 - 1, 2**63, 2**63 + 4, 2**63 + 6,
                     2**64 // 10 - 1, 2**64 // 10, 2**64 - 2, 2**64 - 1],
                    dtype=np.uint64)
    got = ds.lt_u64(torch.from_numpy(vals.view(np.int64)), t).numpy()
    np.testing.assert_array_equal(got, vals < np.uint64(t))


def test_single_contig():
    rng = np.random.default_rng(1)
    (got,) = _three_way(["g"], [[_random_seq(rng, 5000)]])
    assert got.n_fragments > 3 and got.frag_buckets.size > 50


def test_contigs_with_n_runs_and_lowercase():
    rng = np.random.default_rng(2)
    body = bytearray(_random_seq(rng, 3001, n_prob=0.01, lower_prob=0.3))
    body[500:540] = b"N" * 40
    _three_way(["g"], [[bytes(body), _random_seq(rng, 1234),
                        _random_seq(rng, 799, n_prob=0.05)]])


def test_edge_contigs():
    """Shorter than k, exactly k, under min_fragment_length, a remainder
    just under and just at L/2 (L = 700), an empty contig, k-mers that
    would span a separator, and a unit with no contig at all."""
    rng = np.random.default_rng(3)
    cases = [
        [_random_seq(rng, 10)],
        [b"A" * 15],                               # one k-mer, hash 0
        [_random_seq(rng, 60)],
        [_random_seq(rng, 100)],
        [_random_seq(rng, 1049)],                 # remainder 349 < 350
        [_random_seq(rng, 1050)],                 # remainder 350 kept
        [b"", _random_seq(rng, 500)],
        [_random_seq(rng, 500), _random_seq(rng, 20)],
        [_random_seq(rng, 8), _random_seq(rng, 9), _random_seq(rng, 730)],
        [],
    ]
    names = [f"g{i}" for i in range(len(cases))]
    got = _three_way(names, cases)
    assert got[-1].n_fragments == 0 and got[1].member_buckets.size == 1


def test_spanning_kmers_are_dropped():
    """Two contigs whose joined bytes would form selected k-mers: a
    window across the separator counts in no set."""
    rng = np.random.default_rng(4)
    a, b = _random_seq(rng, 700), _random_seq(rng, 700)
    (joined,) = _three_way(["j"], [[a + b]])
    (split,) = _three_way(["s"], [[a, b]])
    assert split.member_buckets.size < joined.member_buckets.size


def test_small_genome_params_and_mixed_lengths():
    rng = np.random.default_rng(5)
    lists = [[_random_seq(rng, ln, n_prob=0.005)]
             for ln in (350, 5000, 1200, 16000, 777)]
    lists.append([_random_seq(rng, 5200, n_prob=0.002)])
    names = [f"g{i}" for i in range(len(lists))]
    _three_way(names, lists, kind="medium")
    _three_way(names, lists, kind="small")


def test_repeat_rich_genome_has_no_overflow():
    """A homopolymer selects every one of its k-mers (mix64(0) == 0): the
    reference's selected-hash capacity overflows (it falls back to the
    host); the port's key buffer holds one slot per start, so the batch
    simply completes."""
    rng = np.random.default_rng(6)
    seqs = [b"A" * 4096, _random_seq(rng, 3000) + b"ACGTTG" * 400]
    pp, jp = (dataclasses.replace(_params("medium", mod), fragment_scale=8)
              for mod in (fmh, jax_fmh))
    with pytest.raises(jax_ds.DeviceSketchOverflow):
        jax_ds.device_sketch_batch(["g"], [seqs[:1]], jp)
    got = ds.device_sketch_batch(["h", "g"], [seqs[:1], seqs], pp, CPU)
    for g, name, s in zip(got, ("h", "g"), (seqs[:1], seqs)):
        _assert_equal(g, sketch_sequences_native(name, s, pp))


def test_plan_matches_jax_package():
    """Each unit's fragment bins in concatenated coordinates, planned for
    a whole batch at once: the JAX package's _plan_genome, plus the
    trailing bin that keeps bounds and bin2frag of one length, with
    batch-global fragment ids."""
    units = [[b"ACGT" * 300], [b"A" * 20, b"", b"acgtn" * 100, b"C" * 3000],
             [], [b""], [b"G" * 60, b"T" * 700, b"A" * 349],
             [b"C" * 1400, b"G" * 1050]]
    hb = ds.plan_batch([f"u{i}" for i in range(len(units))], units,
                       _params("medium", fmh))
    for u, seqs in enumerate(units):
        want = jax_ds._plan_genome(seqs, _params("medium", jax_fmh))
        lo, hi = hb.bin_off[u], hb.bin_off[u + 1]
        np.testing.assert_array_equal(hb.bounds[lo:hi], want.bounds)
        ids = hb.bin2frag[lo:hi].astype(np.int64)
        ids[ids >= 0] -= hb.frag_off[u]
        np.testing.assert_array_equal(ids[:-1], want.bin2frag)
        assert ids[-1] == -1
        assert hb.unit_off[u + 1] - hb.unit_off[u] == want.codes.shape[0]
        assert hb.frag_off[u + 1] - hb.frag_off[u] == want.n_frags
        assert hb.total_lens[u] == want.total_len


def test_plan_batch_layout():
    p = _params("medium", fmh)
    hb = ds.plan_batch(["a", "b", "c"],
                       [[b"ACGT" * 100, b"GG"], [], [b"T" * 600]], p)
    np.testing.assert_array_equal(hb.unit_off, [0, 403, 403, 1003])
    assert hb.seq[400] == ds.SEPARATOR and hb.seq[:4].tobytes() == b"ACGT"
    starts = [403 - 14, 0, 600 - 14]
    assert hb.starts == sum(starts)
    np.testing.assert_array_equal(
        hb.run_off, np.cumsum([0] + [-(-s // ds.RUN_LEN) for s in starts]))
    assert hb.bin_off[-1] == len(hb.bounds) == len(hb.bin2frag)


def test_batches_respect_bytes_and_unit_cap(monkeypatch):
    p = _params("medium", fmh)
    buckets = {1024: list(range(10)), 64: list(range(10, 13))}
    assert ds._chunks(buckets, 4096, p, CPU) == [
        [10, 11, 12], [0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    monkeypatch.setattr(ds, "_batch_genome_cap", lambda P, params, dev: 3)
    assert ds._chunks(buckets, 4096, p, CPU)[1] == [0, 1, 2]


@pytest.mark.parametrize("kw,match", [
    (dict(k=16), "30 bits"),
    (dict(genome_scale=2, fragment_scale=8), "genome_scale"),
    (dict(prefilter_bits=1 << 15, member_bits=1 << 14), "prefilter_bits"),
    (dict(member_bits=3 << 12), "powers of two"),
])
def test_params_outside_the_kernel_are_refused(kw, match):
    base = dict(member_bits=1 << 14, prefilter_bits=1 << 12)
    with pytest.raises(ValueError, match=match):
        ds.plan_batch(["g"], [[b"ACGT"]],
                      NativeSketchParams(**{**base, **kw}))


def test_wrapper_refuses_other_devices():
    p = _params("medium", fmh)
    batch = ds.upload_batch(ds.plan_batch(["g"], [[b"ACGT" * 10]], p), p,
                            torch.device("meta"))
    before = ds.sketch_batch.launches
    with pytest.raises(ValueError, match="unsupported device"):
        ds.sketch_batch(batch)
    assert ds.sketch_batch.launches == before


# ------------------------------------------------------------------ files


def _write_fasta(path, records, gz=False):
    text = "".join(f">{name}\n{seq.decode()}\n" for name, seq in records)
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    return str(path)


def test_device_sketch_files_match_host(tmp_path, monkeypatch):
    """Length-bucketed batches over gzipped and tab-header files, a file
    with no record and one shorter than k."""
    rng = np.random.default_rng(8)
    pp, jp = _params("medium", fmh), _params("medium", jax_fmh)
    specs = [(4000, 900), (2100,), (15000, 50, 3000), (), (10,)]
    paths = [
        _write_fasta(tmp_path / (f"g{i}.fna" + (".gz" if i == 1 else "")),
                     [(f"c{j}\tcomment x", _random_seq(rng, n, n_prob=0.002))
                      for j, n in enumerate(lens)], gz=i == 1)
        for i, lens in enumerate(specs)
    ]
    monkeypatch.setitem(ds.GENOME_BATCH_BYTES, "cpu", 5000)
    got = ds.device_sketch_files(paths, pp, CPU, threads=3)
    jax = jax_ds.device_sketch_files(paths, jp)
    for p, g, j in zip(paths, got, jax):
        assert g.name == p
        _assert_equal(g, sketch_file_native(p, pp))
        _assert_equal(g, native_sketch_from_fields(j), check_dtype=False)


def test_device_sketch_contig_files_match_host(tmp_path, monkeypatch):
    """One sketch per contig, file order, tab-split names; contigs of
    several length buckets, an empty one, batches cut by bytes."""
    rng = np.random.default_rng(9)
    pp, jp = _params("small", fmh), _params("small", jax_fmh)
    paths = [
        _write_fasta(tmp_path / (f"c{i}.fna" + (".gz" if i == 1 else "")),
                     [(f"f{i}_c{j}\textra tab comment",
                       _random_seq(rng, n, n_prob=0.002))
                      for j, n in enumerate(lens)], gz=i == 1)
        for i, lens in enumerate([(3000, 900, 5100, 20, 0), (2100,),
                                  (700, 7000, 650)])
    ]
    seen = []
    monkeypatch.setitem(ds.CONTIG_BATCH_BYTES, "cpu", 9000)
    got = ds.device_sketch_contig_files(
        paths, pp, CPU,
        on_batch=lambda names, sks, dev: seen.append(len(names)))
    assert len(seen) > 2 and sum(seen) == 9
    jax = jax_ds.device_sketch_contig_files(paths, jp)
    for p, glist, jlist in zip(paths, got, jax):
        want = sketch_contigs_native(p, pp)
        assert [s.name for s in glist] == [s.name for s in want]
        assert [s.name for s in glist] == [s.name for s in jlist]
        for g, w, j in zip(glist, want, jlist):
            _assert_equal(g, w)
            _assert_equal(g, native_sketch_from_fields(j), check_dtype=False)


@pytest.mark.parametrize("native", [True, False])
def test_open_files_parse_once_within_their_budget(tmp_path, monkeypatch,
                                                   native):
    """The length pass's parses serve the read pass while their bytes fit
    the budget; past it the least recently used file goes, and is parsed
    again when asked for. Both readers give the same records."""
    from galah_tpu_torch import native_ext

    if not native:
        monkeypatch.setattr(native_ext, "available", lambda: False)
    rng = np.random.default_rng(10)
    recs = [[(f"f{i}c{j}\tx", _random_seq(rng, 50 + j)) for j in range(4)]
            for i in range(3)]
    paths = [_write_fasta(tmp_path / f"f{i}.fna", r) for i, r in enumerate(recs)]
    monkeypatch.setattr(ds, "OPEN_FILE_BYTES", 2 * 4 * 52)
    files = ds._OpenFiles(paths)
    for i in range(3):
        src = files.get(i)
        assert src.lengths == [50, 51, 52, 53]
        assert [src.name(j) for j in range(4)] == [n for n, _ in recs[i]]
        out = np.zeros(52, dtype=np.uint8)
        src.copy_into(2, out)
        assert out.tobytes() == recs[i][2][1]
    files.get(2)
    files.get(1)
    assert files.parsed == 3
    files.get(0)                            # evicted by file 2: parsed again
    assert files.parsed == 4


# ------------------------------------------------------- engine adoption


@pytest.fixture
def genome_corpus(tmp_path):
    from galah_tpu_torch.utils.synth import make_families

    paths, _ = make_families(str(tmp_path / "g"), 2, 3, genome_length=20_000,
                             seed=11)
    return paths


def _context(**kw):
    from galah_tpu_torch.engines.native import NativeContext

    return NativeContext(CPU, max_genome_length=20_000, **kw)


def test_engine_gate(monkeypatch):
    from galah_tpu_torch.engines.native import _use_device_sketch

    monkeypatch.delenv("GALAH_TPU_DEVICE_SKETCH", raising=False)
    assert not _use_device_sketch(CPU)
    assert _use_device_sketch(torch.device("cuda", 0))
    monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "1")
    assert _use_device_sketch(CPU)
    monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "0")
    assert not _use_device_sketch(torch.device("cuda", 0))


@pytest.mark.parametrize("low_memory", [False, True])
def test_engine_device_sketches_equal_host_and_count_work(
        genome_corpus, monkeypatch, low_memory):
    from galah_tpu_torch.utils import metrics

    monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "1")
    m = metrics.reset()
    before = ds.sketch_batch.launches
    ctx = _context(low_memory=low_memory)
    got = list(ctx.sketch_many(genome_corpus))
    assert ds.sketch_batch.launches == before  # the CPU runs the plain version
    assert m.counters["genomes_sketched"] == len(genome_corpus)
    assert m.counters["sketch_bases"] == sum(s.total_len for s in got)
    assert m.counters["sketch_device_batches"] >= 1
    for p, g in zip(genome_corpus, got):
        _assert_equal(g, sketch_file_native(p, ctx.params))


def test_adopted_pool_rows_and_screen_matrix_equal_host_filled(
        genome_corpus, monkeypatch):
    from galah_tpu_torch.ops.fragment_ani import _BitmapPool

    monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "1")
    ctx = _context()
    sketches = ctx.sketch_many(genome_corpus)
    pool = ctx.frag_engine.pool
    host = _BitmapPool(pool.words, CPU, capacity=8, hard_cap=8)
    host.ensure(genome_corpus, sketches)
    rows, popc = pool.rows(genome_corpus)
    hrows, hpopc = host.rows(genome_corpus)
    assert torch.equal(pool.buffer[torch.from_numpy(rows)],
                       host.buffer[torch.from_numpy(hrows)])
    np.testing.assert_array_equal(popc, hpopc)
    bits = ctx.params.prefilter_bits
    want = words_to_torch(np.stack([pack_indicator(s.prefilter_buckets, bits)
                                    for s in sketches]))
    build = ctx.pref_matrix_builder(sketches)
    assert build is not None
    assert torch.equal(build(len(sketches)), want)


def test_adoption_survives_evictions_and_can_be_turned_off(
        genome_corpus, monkeypatch):
    """A row cache that kept only the last batch and a pool that had to
    evict: the matrix takes the lost rows from the host sketches, the
    pool refills evicted keys from them, and both still equal the
    host-filled rows. GALAH_TPU_RESIDENT=0 adopts nothing."""
    from galah_tpu_torch.engines import native
    from galah_tpu_torch.ops import device_sketch
    from galah_tpu_torch.utils import metrics

    monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "1")
    monkeypatch.setitem(device_sketch.GENOME_BATCH_BYTES, "cpu", 40_000)
    ctx = _context()
    ctx._pref_cache = native._PrefRowCache(ctx.params.prefilter_bits // 8 * 2)
    pool = ctx.frag_engine.pool
    pool.hard_cap = pool.capacity = 2
    pool.buffer = pool.buffer[:2]
    pool._popc = pool._popc[:2]
    sketches = ctx.sketch_many(genome_corpus)
    assert len(pool._rows) == 2 and len(ctx._pref_cache) == 2
    m = metrics.reset()
    bits = ctx.params.prefilter_bits
    want = words_to_torch(np.stack([pack_indicator(s.prefilter_buckets, bits)
                                    for s in sketches]))
    assert torch.equal(ctx.pref_matrix_builder(sketches)(len(sketches)), want)
    assert m.counters["screen_rows_host_uploaded"] == len(sketches) - 2
    for key, sk in zip(genome_corpus, sketches):
        pool.ensure([key], [sk])
        (r,), _ = pool.rows([key])
        np.testing.assert_array_equal(
            pool.buffer[r].numpy().view(np.uint32), sk.member_bitmap_words())

    monkeypatch.setenv("GALAH_TPU_RESIDENT", "0")
    ctx = _context()
    sketches = ctx.sketch_many(genome_corpus)
    assert ctx.pref_matrix_builder(sketches) is None
    assert len(ctx.frag_engine.pool._rows) == 0 and len(ctx._pref_cache) == 0
