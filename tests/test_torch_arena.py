"""galah_tpu_torch's stream arena (ops/fragment_ani.py::StreamArena).

Allocation, reset and the reset-safety rule of `ensure` at tiny
capacities; device-born streams adopted into the arena laid out exactly
as the host fill lays them out; and verify of a device-sketched corpus
on the CPU (K5's plain version) reading every stream from the arena,
with every stream upload patched to raise: the pair table's and the
grouped kernel's results equal, exactly, those of the host-sketched
corpus and of GALAH_TPU_ARENA=0, and the JAX package's within the verify
tests' tolerance (ANI 1e-3 percentage points, AF exact)."""

import dataclasses

import numpy as np
import pytest
import torch

from galah_tpu.ops import fragment_ani as jax_fa
from galah_tpu.sketch.fracminhash import NativeSketchParams as JaxParams
from galah_tpu.sketch.fracminhash import sketch_file_native as jax_sketch
from galah_tpu_torch.ops import fragment_ani as fa
from galah_tpu_torch.ops import pair_table as pt
from galah_tpu_torch.sketch.fracminhash import NativeSketch

CPU = torch.device("cpu")
ANI_TOL = 1e-3


def _sketch(name, n_frags, rng, bits=1 << 16):
    """A synthetic sketch of n_frags fragments of 3..9 sorted buckets."""
    lens = rng.integers(3, 10, size=n_frags)
    buckets = np.concatenate([np.sort(rng.choice(bits, n, replace=False))
                              for n in lens]).astype(np.int32)
    offs = np.zeros(n_frags + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    return NativeSketch(name=name, total_len=0,
                        prefilter_buckets=np.zeros(0, np.int32),
                        frag_buckets=buckets, frag_offsets=offs,
                        member_buckets=np.unique(buckets))


def _span_contents(arena, key, sk):
    h, o = arena.span(key)
    n, f = len(sk.frag_buckets), sk.n_fragments
    return arena.hashes[h:h + n].numpy(), arena.offsets[o:o + f + 1].numpy(), h


def _assert_resident_exactly(arena, key, sk):
    got, offs, h = _span_contents(arena, key, sk)
    np.testing.assert_array_equal(got, sk.frag_buckets)
    np.testing.assert_array_equal(offs, sk.frag_offsets + h)
    b, o = arena.query(key, sk)
    np.testing.assert_array_equal(b.numpy(), sk.frag_buckets)
    np.testing.assert_array_equal(o.numpy(), sk.frag_offsets)


def test_alloc_reset_and_ensure_across_a_reset():
    rng = np.random.default_rng(0)
    sks = {f"g{i}": _sketch(f"g{i}", 8, rng) for i in range(6)}
    big = _sketch("big", 40, rng)
    sks["big"] = big
    n = {k: len(s.frag_buckets) for k, s in sks.items()}
    cap = n["g0"] + n["g1"] + n["g2"] + 2
    arena = fa.StreamArena(CPU, cap, 64)
    spans = arena.ensure(["g0", "g1"], sks)
    assert spans == {"g0": (0, 0), "g1": (n["g0"], 9)}
    assert arena.resets == 0
    assert not arena.would_reset(["g0", "g2"], sks)
    assert arena.would_reset(["g3", "g4"], sks)
    # g3 and g4 do not fit beside g0, g1: the arena resets, and g0, which
    # the request also needs, is allocated again after the reset.
    spans = arena.ensure(["g3", "g0", "g4"], sks)
    assert arena.resets >= 1 and set(spans) == {"g3", "g0", "g4"}
    assert arena.span("g1") is None
    for key in spans:
        _assert_resident_exactly(arena, key, sks[key])
    # A stream larger than the arena is never resident.
    assert "big" not in arena.ensure(["big", "g3"], sks)
    _assert_resident_exactly(arena, "g3", sks["g3"])
    # The offsets buffer binds too: 64 slots hold 7 streams of 8 frags.
    arena = fa.StreamArena(CPU, 1 << 12, 20)
    arena.ensure(["g0", "g1"], sks)
    assert arena.resets == 0 and arena.would_reset(["g2", "g3"], sks)
    spans = arena.ensure(["g2", "g3"], sks)
    assert arena.resets == 1 and set(arena.spans(list(sks))) == {"g2", "g3"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two families of three 60 kb genomes and three 100 kb ones, so the
    default routing sends some pairs to each kernel, at a pair-table
    budget that holds the small streams but not the large ones."""
    from galah_tpu_torch.utils.synth import make_families

    d = tmp_path_factory.mktemp("arena_corpus")
    small, _ = make_families(str(d / "s"), 2, 3, genome_length=60_000, seed=3)
    large, _ = make_families(str(d / "l"), 1, 3, genome_length=100_000,
                             seed=4)
    return small + large


def _device_context(monkeypatch, paths):
    """A context that sketched `paths` with device sketching (K5's plain
    version on the CPU) and adopted every batch."""
    from galah_tpu_torch.engines.native import NativeContext

    monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "1")
    ctx = NativeContext(CPU, max_genome_length=100_000)
    sketches = ctx.sketch_many(paths)
    return ctx, dict(zip(paths, sketches))


def test_adopt_lays_out_streams_as_the_host_fill_does(monkeypatch, corpus):
    from galah_tpu_torch.ops import device_sketch as ds

    monkeypatch.setitem(ds.GENOME_BATCH_BYTES, "cpu", 300_000)
    ctx, sks = _device_context(monkeypatch, corpus)
    assert ctx.frag_engine.pool is not None
    adopted = ctx.frag_engine.stream_arena()
    host = fa.StreamArena(CPU, *fa._arena_capacities(CPU))
    host.ensure(corpus, sks)
    for key in corpus:
        assert adopted.span(key) == host.span(key)
        _assert_resident_exactly(adopted, key, sks[key])
    n = sum(len(s.frag_buckets) for s in sks.values())
    assert torch.equal(adopted.hashes[:n], host.hashes[:n])
    f = sum(s.n_fragments + 1 for s in sks.values())
    assert torch.equal(adopted.offsets[:f], host.offsets[:f])


def _no_stream_uploads(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a fragment stream was uploaded")

    monkeypatch.setattr(fa.StreamArena, "_fill_host", refuse)
    monkeypatch.setattr(pt, "upload_streams", refuse)
    monkeypatch.setattr(fa, "sketch_tensors", refuse)


# A pair-table budget that holds the 60 kb genomes' streams (~7.5k
# hashes) and not the 100 kb ones' (~12.5k) under the default routing.
SMALL_FLAT = 1 << 16


def _verify(engine, table, pairs, sks, monkeypatch, mode):
    monkeypatch.setenv("GALAH_TPU_VERIFY", mode)
    table.cfg = dataclasses.replace(table.cfg, max_flat_hashes=SMALL_FLAT)
    return engine.bidirectional(pairs, sks)


@pytest.mark.parametrize("mode", ["pairtable", "grouped", "auto"])
def test_verify_of_device_born_streams_uploads_none(monkeypatch, corpus,
                                                    mode):
    """Every stream read from the arena; results equal those of the
    host-sketched corpus (its streams uploaded into the arena), of
    GALAH_TPU_ARENA=0 and of the JAX package."""
    ctx, sks = _device_context(monkeypatch, corpus)
    pairs = [(a, b) for i, a in enumerate(corpus) for b in corpus[i + 1:]]
    cfg = ctx.frag_engine.cfg
    with monkeypatch.context() as mp:
        _no_stream_uploads(mp)
        got = _verify(ctx.frag_engine, ctx.frag_engine.pair_table, pairs, sks,
                      mp, mode)
    assert ctx.frag_engine.stream_arena().resets == 0

    from galah_tpu_torch.sketch.fracminhash import sketch_file_native

    host_sks = {p: sketch_file_native(p, ctx.params) for p in corpus}
    heng = fa.FragmentAniEngine(cfg, CPU)
    assert _verify(heng, heng.pair_table, pairs, host_sks, monkeypatch,
                   mode) == got

    monkeypatch.setenv("GALAH_TPU_ARENA", "0")
    off_ctx, off_sks = _device_context(monkeypatch, corpus)
    off = off_ctx.frag_engine
    assert _verify(off, off.pair_table, pairs, off_sks, monkeypatch,
                   mode) == got
    assert off.shards[0]._arena is None

    monkeypatch.setenv("GALAH_TPU_VERIFY_DEVICES", "1")
    jeng = jax_fa.FragmentAniEngine(jax_fa.FragmentAniConfig(
        k=cfg.k, member_bits=cfg.member_bits,
        min_fragment_hashes=cfg.min_fragment_hashes))
    jparams = JaxParams(**dataclasses.asdict(ctx.params))
    jsks = {p: jax_sketch(p, jparams) for p in corpus}
    want = _verify(jeng, jeng._pair_table(), pairs, jsks, monkeypatch, mode)
    assert got.keys() == want.keys()
    for key in want:
        assert abs(got[key][0] - want[key][0]) <= ANI_TOL, key
        assert got[key][1:] == want[key][1:], key
    assert max(v[0] for v in got.values()) > 95.0
