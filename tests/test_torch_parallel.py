"""The port's sharded sweeps and verify fan-out on several CPU shards
(repeated torch.device("cpu") entries), held to the port's single-device
sweeps and to the JAX package's sharded functions on the 8 virtual CPU
devices of tests/conftest.py: the same pairs in the same order, the
same ANI (compared as int32 views) and AF, bit for bit, an overflowing
tile included; and the engine's clusters at 1, 2 and 8 shards."""

import numpy as np
import pytest
import torch

import jax
from galah_tpu.parallel import distance as jax_dist
from galah_tpu.parallel.mesh import make_mesh
from galah_tpu_torch import api
from galah_tpu_torch.ops import fragment_ani as fa
from galah_tpu_torch.ops import prefilter as pf
from galah_tpu_torch.parallel import distance as dist
from galah_tpu_torch.parallel import mesh, mp
from galah_tpu_torch.utils.synth import make_families

CPU = torch.device("cpu")


def _shards(n):
    return [CPU] * n


def _mesh(n):
    return make_mesh(jax.devices()[:n])


def _pack(x):
    return list(np.packbits(x.astype(bool), axis=1,
                            bitorder="little").view(np.uint32))


def _assert_same(got, want, ordered=True):
    """Pairs and ANI bit for bit; in the same order unless not
    `ordered` (then both are sorted by pair first)."""
    gp, ga = np.asarray(got.pairs), np.asarray(got.ani_est, np.float32)
    wp, wa = np.asarray(want.pairs), np.asarray(want.ani_est, np.float32)
    if not ordered:
        go, wo = (np.lexsort((p[:, 1], p[:, 0])) for p in (gp, wp))
        gp, ga, wp, wa = gp[go], ga[go], wp[wo], wa[wo]
    assert gp.shape == wp.shape
    assert np.array_equal(gp, wp)
    assert np.array_equal(ga.view(np.int32), wa.view(np.int32))


def _planted(n=700, bits=2048, seed=3):
    """tests/test_parallel.py's many-tile input: random rows with 10
    planted duplicate pairs."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, bits)) < 0.08).astype(np.uint8)
    for src in range(0, 40, 4):
        x[src + 1] = x[src]
    return _pack(x), x.sum(axis=1), bits


def _overflowing(n=300, bits=1024, seed=4):
    """Random rows whose first 20 are one set thinned at random: their
    tile has 190 pairs over a cap of 64, some of them near the cutoff,
    so the dense rule (bfloat16 containment) decides them."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, bits)) < 0.08).astype(np.uint8)
    base = (rng.random(bits) < 0.3).astype(np.uint8)
    for i in range(20):
        x[i] = base * (rng.random(bits) < 0.6 + 0.02 * i)
    return _pack(x), x.sum(axis=1), bits


def _rect(nq=700, nr=300, bits=2048, seed=7):
    """tests/test_parallel.py's rectangle: cross-group near-duplicates
    spanning several tiles."""
    rng = np.random.default_rng(seed)
    q = (rng.random((nq, bits)) < 0.08).astype(np.uint8)
    r = (rng.random((nr, bits)) < 0.08).astype(np.uint8)
    for t in range(0, min(280, nr), 17):
        q[t * 2 % nq] = r[t]
    return _pack(q), q.sum(axis=1), _pack(r), r.sum(axis=1), bits


# ------------------------------------------------------------- replicated


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_sharded_triangle_matches_single_device_and_jax(n_shards):
    packed, sizes, bits = _planted()
    got = dist.sharded_screen_triangle_packed(
        packed, sizes, 15, 0.2, bits, devices=_shards(n_shards), block=128)
    single = pf.screen_triangle_packed(packed, sizes, 15, 0.2, bits,
                                       device=CPU, block=128)
    want = jax_dist.sharded_screen_triangle_packed(
        packed, sizes, 15, 0.2, bits, mesh=_mesh(n_shards), block=128)
    _assert_same(got, single)
    _assert_same(got, want)
    assert len(got.pairs) >= 10


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_sharded_triangle_overflow_tile(n_shards, monkeypatch):
    """A tile past its cap is decided on its bfloat16 containment, as the
    single-device sweep (its cap lowered to the same 64) and the JAX
    package decide it."""
    packed, sizes, bits = _overflowing()
    got = dist.sharded_screen_triangle_packed(
        packed, sizes, 15, 0.2, bits, devices=_shards(n_shards), block=128,
        cap=64)
    want = jax_dist.sharded_screen_triangle_packed(
        packed, sizes, 15, 0.2, bits, mesh=_mesh(n_shards), block=128,
        cap=64)
    monkeypatch.setattr(pf, "_screen_cap_for", lambda block: 64)
    single = pf.screen_triangle_packed(packed, sizes, 15, 0.2, bits,
                                       device=CPU, block=128)
    _assert_same(got, want)
    _assert_same(got, single)
    assert np.sum(got.pairs[:, 1] < 20) > 64


def test_sharded_triangle_all_pairs_overflow():
    """tests/test_parallel.py's all-identical rows: every pair passes and
    the one tile overflows its cap of 64."""
    n, bits = 96, 1024
    x = np.zeros((n, bits), dtype=np.uint8)
    x[:, :64] = 1
    packed, sizes = _pack(x), x.sum(axis=1)
    got = dist.sharded_screen_triangle_packed(
        packed, sizes, 15, 0.2, bits, devices=_shards(2), block=128, cap=64)
    want = jax_dist.sharded_screen_triangle_packed(
        packed, sizes, 15, 0.2, bits, mesh=_mesh(2), block=128, cap=64)
    _assert_same(got, want)
    assert len(got.pairs) == n * (n - 1) // 2


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_rectangle_matches_single_device_and_jax(n_shards):
    qp, qs, rp, rs, bits = _rect()
    got = dist.sharded_screen_rectangle_packed(
        qp, qs, rp, rs, 15, 0.2, bits, devices=_shards(n_shards), block=128)
    single = pf.screen_rectangle_packed(qp, qs, rp, rs, 15, 0.2, bits,
                                        device=CPU, block=128)
    want = jax_dist.sharded_screen_rectangle_packed(
        qp, qs, rp, rs, 15, 0.2, bits, mesh=_mesh(n_shards), block=128)
    _assert_same(got, single)
    _assert_same(got, want)
    assert len(got.pairs) >= 15


def test_sharded_rectangle_overflow_tile():
    nq, nr, bits = 96, 96, 1024
    rng = np.random.default_rng(8)
    base = (rng.random(bits) < 0.1).astype(np.uint8)
    q, r = np.tile(base, (nq, 1)), np.tile(base, (nr, 1))
    args = (_pack(q), q.sum(axis=1), _pack(r), r.sum(axis=1), 15, 0.2, bits)
    got = dist.sharded_screen_rectangle_packed(*args, devices=_shards(8),
                                               block=128, cap=64)
    want = jax_dist.sharded_screen_rectangle_packed(*args, mesh=_mesh(8),
                                                    block=128, cap=64)
    _assert_same(got, want)
    assert len(got.pairs) == nq * nr


def test_sharded_triangle_splits_tiles_round_robin(monkeypatch):
    """Tile t goes to shard t mod the shard count, each shard's tiles to
    its own queue (shards on one device are told apart by index)."""
    packed, sizes, bits = _planted(n=500)
    seen = []
    real = pf._TileQueue.issue

    def issue(self, *a, **kw):
        seen.append((self.shard, kw["row0"] // 128, kw["col0"] // 128))
        return real(self, *a, **kw)

    monkeypatch.setattr(pf._TileQueue, "issue", issue)
    dist.sharded_screen_triangle_packed(packed, sizes, 15, 0.2, bits,
                                        devices=_shards(3), block=128)
    tiles = [(bi, bj) for bi in range(4) for bj in range(bi, 4)]
    assert seen == [(t % 3, *tile) for t, tile in enumerate(tiles)]


def test_sharded_indicator_wrapper():
    """sharded_screen_triangle packs 0/1 indicator rows and sweeps them:
    tests/test_parallel.py's planted pairs, as the JAX wrapper finds
    them."""
    rng = np.random.default_rng(0)
    x = (rng.random((24, 4096)) < 0.08).astype(np.uint8)
    x[1] = np.where(rng.random(4096) < 0.01, 1 - x[0], x[0])
    x[5] = x[4] * (rng.random(4096) < 0.5)
    got = dist.sharded_screen_triangle(x, x.sum(axis=1), 15, 0.2,
                                       devices=_shards(8))
    want = jax_dist.sharded_screen_triangle(x, x.sum(axis=1), 15, 0.2,
                                            mesh=_mesh(8))
    _assert_same(got, want)
    assert {(0, 1), (4, 5)} <= set(map(tuple, got.pairs.tolist()))
    with pytest.raises(ValueError, match="multiple of 32"):
        dist.sharded_screen_triangle(x[:, :100], x.sum(axis=1), 15, 0.2,
                                     devices=_shards(2))


# ------------------------------------------------------------ row-sharded


@pytest.mark.parametrize("n_shards", [2, 8])
def test_rowsharded_triangle_matches_single_device_and_jax(n_shards):
    packed, sizes, bits = _planted()
    got = dist.sharded_screen_triangle_rowsharded(
        packed, sizes, 15, 0.2, bits, devices=_shards(n_shards), block=128)
    want = jax_dist.sharded_screen_triangle_rowsharded(
        packed, sizes, 15, 0.2, bits, mesh=_mesh(n_shards), block=128)
    single = pf.screen_triangle_packed(packed, sizes, 15, 0.2, bits,
                                       device=CPU, block=128)
    _assert_same(got, want)
    _assert_same(got, single, ordered=False)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_rowsharded_triangle_overflow_tile(n_shards):
    packed, sizes, bits = _overflowing()
    got = dist.sharded_screen_triangle_rowsharded(
        packed, sizes, 15, 0.2, bits, devices=_shards(n_shards), block=128,
        cap=64)
    want = jax_dist.sharded_screen_triangle_rowsharded(
        packed, sizes, 15, 0.2, bits, mesh=_mesh(n_shards), block=128,
        cap=64)
    _assert_same(got, want)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_rowsharded_stage_stream_overflow(n_shards, caplog):
    """A shard's stage whose hits would have overflowed the JAX package's
    compacted stream is decided densely in every tile, as the JAX
    package decides it: pairs and ANI. One row in 8 is a thinned copy of
    one set, so every tile of 16 rows holds a few pairs; cap 2 and a
    stage_cap of 4 overflow a shard's stage from its third tile with a
    hit on."""
    rng = np.random.default_rng(5)
    n, bits = 256, 1024
    x = (rng.random((n, bits)) < 0.08).astype(np.uint8)
    base = (rng.random(bits) < 0.3).astype(np.uint8)
    for i in range(0, n, 8):
        x[i] = base * (rng.random(bits) < 0.5 + i / 600)
    packed, sizes = _pack(x), x.sum(axis=1)
    kw = dict(block=16, cap=2, stage_cap=4)
    got = dist.sharded_screen_triangle_rowsharded(
        packed, sizes, 15, 0.2, bits, devices=_shards(n_shards), **kw)
    want = jax_dist.sharded_screen_triangle_rowsharded(
        packed, sizes, 15, 0.2, bits, mesh=_mesh(n_shards), **kw)
    _assert_same(got, want)
    assert "stream overflow" in caplog.text
    assert len(got.pairs) > 400


def test_rowsharded_all_pairs_stream_overflow():
    """tests/test_parallel.py's stream overflow: 1024 identical rows."""
    n, bits = 1024, 1024
    x = np.zeros((n, bits), dtype=np.uint8)
    x[:, :64] = 1
    packed, sizes = _pack(x), x.sum(axis=1)
    kw = dict(block=128, cap=16384, stage_cap=16384)
    got = dist.sharded_screen_triangle_rowsharded(
        packed, sizes, 15, 0.2, bits, devices=_shards(2), **kw)
    want = jax_dist.sharded_screen_triangle_rowsharded(
        packed, sizes, 15, 0.2, bits, mesh=_mesh(2), **kw)
    _assert_same(got, want)
    assert len(got.pairs) == n * (n - 1) // 2


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_rowsharded_zero_slot_after_clamp(n_shards):
    """tests/test_parallel.py's clobber regression: the exact pairs."""
    n, bits = 16, 1024
    rng = np.random.default_rng(0)
    x = (rng.random((n, bits)) < 0.5).astype(np.uint8)
    x[8] = x[0]; x[9] = x[1]; x[10] = x[2]; x[5] = x[4]; x[11] = x[4]
    packed, sizes = _pack(x), x.sum(axis=1)
    kw = dict(block=4, cap=4, stage_cap=8)
    got = dist.sharded_screen_triangle_rowsharded(
        packed, sizes, 15, 0.5, bits, devices=_shards(n_shards), **kw)
    want = jax_dist.sharded_screen_triangle_rowsharded(
        packed, sizes, 15, 0.5, bits, mesh=_mesh(n_shards), **kw)
    _assert_same(got, want)
    assert sorted(map(tuple, got.pairs.tolist())) == sorted(
        [(0, 8), (1, 9), (2, 10), (4, 5), (4, 11), (5, 11)])


@pytest.mark.parametrize("n_shards", [2, 8])
def test_rowsharded_rectangle_matches_single_device_and_jax(n_shards):
    qp, qs, rp, rs, bits = _rect(nq=500, seed=11)
    got = dist.sharded_screen_rectangle_rowsharded(
        qp, qs, rp, rs, 15, 0.2, bits, devices=_shards(n_shards), block=128)
    want = jax_dist.sharded_screen_rectangle_rowsharded(
        qp, qs, rp, rs, 15, 0.2, bits, mesh=_mesh(n_shards), block=128)
    single = pf.screen_rectangle_packed(qp, qs, rp, rs, 15, 0.2, bits,
                                        device=CPU, block=128)
    _assert_same(got, want)
    _assert_same(got, single, ordered=False)
    assert len(got.pairs) >= 15


def test_rowsharded_rectangle_overflow_tile():
    nq, nr, bits = 96, 96, 1024
    rng = np.random.default_rng(12)
    base = (rng.random(bits) < 0.1).astype(np.uint8)
    q, r = np.tile(base, (nq, 1)), np.tile(base, (nr, 1))
    args = (_pack(q), q.sum(axis=1), _pack(r), r.sum(axis=1), 15, 0.2, bits)
    got = dist.sharded_screen_rectangle_rowsharded(
        *args, devices=_shards(2), block=128, cap=64)
    want = jax_dist.sharded_screen_rectangle_rowsharded(
        *args, mesh=_mesh(2), block=128, cap=64)
    _assert_same(got, want)
    assert len(got.pairs) == nq * nr


@pytest.mark.parametrize("shape", ["triangle", "rectangle"])
def test_rowshard_env_forces_the_rowsharded_sweep(shape, monkeypatch):
    """GALAH_TPU_ROWSHARD=1 routes the packed entry points through the
    row-sharded sweep (block capped at 1024, cap 8192), which gives the
    replicated sweep's pairs and the JAX package's forced ones."""
    if shape == "triangle":
        packed, sizes, bits = _planted(n=300)
        args = (packed, sizes, 15, 0.2, bits)
        port, jaxf = (dist.sharded_screen_triangle_packed,
                      jax_dist.sharded_screen_triangle_packed)
        inner = "sharded_screen_triangle_rowsharded"
    else:
        qp, qs, rp, rs, bits = _rect(nq=300, nr=200, seed=13)
        args = (qp, qs, rp, rs, 15, 0.2, bits)
        port, jaxf = (dist.sharded_screen_rectangle_packed,
                      jax_dist.sharded_screen_rectangle_packed)
        inner = "sharded_screen_rectangle_rowsharded"
    base = port(*args, devices=_shards(8), block=128)
    calls = []
    real = getattr(dist, inner)
    monkeypatch.setattr(dist, inner,
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    monkeypatch.setenv("GALAH_TPU_ROWSHARD", "1")
    forced = port(*args, devices=_shards(8), block=128)
    want = jaxf(*args, mesh=_mesh(8), block=128)
    assert [c["block"] for c in calls] == [128]
    _assert_same(forced, want)
    _assert_same(forced, base, ordered=False)


# ------------------------------------------------------------- checkpoint


def test_sharded_sweep_checkpoint_resumes(tmp_path, monkeypatch):
    """A sharded sweep killed mid-way logs its drained tiles; the resumed
    sweep replays them (issuing only the rest) and gives the unbroken
    sweep's pairs and ANI in the same order; a complete log issues
    nothing."""
    packed, sizes, bits = _planted(n=600)
    names = [f"g{i}" for i in range(len(packed))]
    args = (packed, sizes, 15, 0.2, bits)
    kw = dict(devices=_shards(2), block=128)
    unbroken = dist.sharded_screen_triangle_packed(*args, **kw)
    log = str(tmp_path / "sweep.ckpt")
    real = pf.packed_intersect_counts
    calls = {"n": 0, "crash": 7}

    def counting(a, b, **k):
        calls["n"] += 1
        if calls["n"] > calls["crash"]:
            raise RuntimeError("injected crash mid-sweep")
        return real(a, b, **k)

    monkeypatch.setattr(pf, "packed_intersect_counts", counting)
    monkeypatch.setattr(pf, "TILE_WINDOW", 2)  # drain as the sweep goes
    with pytest.raises(RuntimeError, match="injected"):
        dist.sharded_screen_triangle_packed(
            *args, **kw, checkpoint_path=log, unit_names=names)
    calls.update(n=0, crash=1 << 30)
    resumed = dist.sharded_screen_triangle_packed(
        *args, **kw, checkpoint_path=log, unit_names=names)
    tiles = 5 * 6 // 2
    assert 0 < calls["n"] < tiles
    _assert_same(resumed, unbroken)
    calls["n"] = 0
    replayed = dist.sharded_screen_triangle_packed(
        *args, **kw, checkpoint_path=log, unit_names=names)
    assert calls["n"] == 0
    _assert_same(replayed, unbroken)


# ----------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    paths, _ = make_families(str(tmp_path_factory.mktemp("corpus")),
                             n_families=4, members_per_family=3,
                             genome_length=30_000, within_ani=0.97, seed=12)
    return paths


def _clusters_tsv(res):
    return "".join(f"{c[0]}\t{m}\n" for c in res.memberships() for m in c)


def _spy(monkeypatch, name):
    calls = []
    real = getattr(dist, name)

    def spy(rows, *a, **kw):
        calls.append((type(rows).__name__, len(kw["devices"])))
        return real(rows, *a, **kw)

    monkeypatch.setattr(dist, name, spy)
    return calls


def test_engine_clusters_equal_at_1_2_and_8_shards(corpus, monkeypatch):
    """The same clusters.tsv on one device and over 2 and 8 shards; the
    shards take the sharded triangle, one device the single-device
    screen (with its phases overlapped under GALAH_TPU_PIPELINE=1)."""
    calls = _spy(monkeypatch, "sharded_screen_triangle_packed")
    params = api.ClusterParameters(ani=95, threads=1)
    got = {n: _clusters_tsv(api.cluster_genomes(corpus, params,
                                                device=_shards(n)))
           for n in (1, 2, 8)}
    assert calls == [("_LazyPackedRows", 2), ("_LazyPackedRows", 8)]
    assert got[1] == got[2] == got[8]
    assert len(api.cluster_genomes(corpus, params, device=CPU).clusters) == 4


def test_engine_reference_mode_uses_the_sharded_rectangle(corpus,
                                                          monkeypatch):
    from galah_tpu_torch.engines.native import (
        NativeContext,
        NativePreclusterer,
    )

    refs = [corpus[0], corpus[3], corpus[6], corpus[9]]
    calls = _spy(monkeypatch, "sharded_screen_rectangle_packed")

    def run(devices):
        pre = NativePreclusterer(90.0, 0.15, NativeContext(devices, threads=1))
        return sorted(pre.distances_with_references(corpus, refs).items())

    multi = run(_shards(2))
    assert calls == [("list", 2)]
    assert multi == run(CPU)
    assert len(multi) >= 8
    monkeypatch.setenv("GALAH_TPU_SCREEN", "packed")
    assert run(_shards(2)) == multi
    assert len(calls) == 1  # an explicit screen keeps one device


def test_engine_low_memory_uses_the_rowsharded_sweep(corpus, monkeypatch):
    calls = _spy(monkeypatch, "sharded_screen_triangle_rowsharded")
    params = api.ClusterParameters(ani=95, threads=1)
    normal = _clusters_tsv(api.cluster_genomes(corpus, params,
                                               device=_shards(2)))
    assert calls == []
    params.low_memory = True
    lowmem = _clusters_tsv(api.cluster_genomes(corpus, params,
                                               device=_shards(2)))
    assert calls == [("_LazyPackedRows", 2)]
    assert lowmem == normal


def test_pipeline_is_off_over_several_shards(corpus, monkeypatch):
    from galah_tpu_torch.engines.native import (
        NativeContext,
        NativePreclusterer,
    )

    monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "1")
    for devices, want in ((CPU, True), (_shards(2), False)):
        pre = NativePreclusterer(95.0, 0.15, NativeContext(devices))
        assert pre._pipeline_enabled(len(corpus)) is want


# ----------------------------------------------------------------- verify


@pytest.fixture(scope="module")
def verify_inputs(tmp_path_factory):
    from galah_tpu_torch.engines.native import NativeContext

    paths, _ = make_families(str(tmp_path_factory.mktemp("verify")),
                             n_families=3, members_per_family=3,
                             genome_length=30_000, within_ani=0.97, seed=5)
    ctx = NativeContext(CPU, threads=1)
    sketches = ctx.sketch_many(paths)
    return ctx.params, {s.name: s for s in sketches}, [s.name for s in sketches]


def _engine(params, n_shards):
    return fa.FragmentAniEngine(fa.FragmentAniConfig(
        k=params.k, member_bits=params.member_bits,
        min_fragment_hashes=params.min_fragment_hashes), _shards(n_shards))


@pytest.mark.parametrize("mode", ["grouped", "pairtable"])
def test_verify_fans_out_over_shards(mode, verify_inputs, monkeypatch):
    """The grouped verify's sources and the pair table's batches (eight
    pairs a batch, so there are several) go round robin over the shards:
    work lands on more than one shard and the results equal one
    shard's, and GALAH_TPU_VERIFY_DEVICES=1 keeps it on the first."""
    params, by_key, keys = verify_inputs
    pairs = [(keys[i], keys[j]) for i in range(len(keys))
             for j in range(i + 1, len(keys))]
    monkeypatch.setenv("GALAH_TPU_VERIFY", mode)

    def run(n_shards):
        eng = _engine(params, n_shards)
        eng.pair_table.cfg = eng.pair_table.cfg.__class__(
            **{**eng.pair_table.cfg.__dict__, "max_pairs": 8})
        return eng.bidirectional(pairs, by_key), [
            s.used for s in eng.shards]

    single, used1 = run(1)
    multi, used4 = run(4)
    assert single == multi
    assert used1 == [True] and used4 == [True] * 4
    monkeypatch.setenv("GALAH_TPU_VERIFY_DEVICES", "1")
    capped, used = run(4)
    assert capped == single and used == [True, False, False, False]
    assert max(v[0] for v in single.values()) > 95.0


# ------------------------------------------------------------ mesh and mp


def test_no_process_group_is_one_process(monkeypatch):
    assert (mesh.process_count(), mesh.process_index()) == (1, 0)
    shards = mesh.shard_list(_shards(3))
    assert [(s.rank, s.local, s.device) for s in shards] == [
        (0, i, CPU) for i in range(3)]
    monkeypatch.setenv("GALAH_TPU_MP_VERIFY", "0")
    assert mp.governed_flag("GALAH_TPU_MP_VERIFY") is False
    monkeypatch.delenv("GALAH_TPU_MP_VERIFY")
    assert mp.governed_flag("GALAH_TPU_MP_VERIFY") is True
