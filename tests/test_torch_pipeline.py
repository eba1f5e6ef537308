"""galah_tpu_torch's overlapped phases against its sequential ones and
the JAX package.

The same numpy-seeded packed rows go through the port's
IncrementalPackedScreen (fed in shuffled, uneven batches, from the host
and device to device), its screen_triangle_packed and the JAX package's
screen_triangle_packed on the CPU: candidate pairs and screen ANI must
be identical, bit for bit. The engine's pipelined distances
(GALAH_TPU_PIPELINE=1) must give exactly the cache of its sequential
run (GALAH_TPU_PIPELINE=0) and of the JAX package's, in genome and
contig mode."""

import numpy as np
import pytest
import torch

from galah_tpu.ops import prefilter as jax_pf
from galah_tpu_torch.ops import prefilter as pf
from galah_tpu_torch.utils.convert import words_to_torch

CPU = torch.device("cpu")
K = 15


def _corpus(n=300, bits=4096, seed=7, dup_frac=0.25):
    rng = np.random.default_rng(seed)
    ind = (rng.random((n, bits)) < 0.06).astype(np.uint8)
    ind[:int(n * dup_frac)] = ind[0]  # a clique, so some pairs survive
    return _packed(ind), ind.sum(axis=1)


def _packed(ind):
    return [np.packbits(r.astype(bool), bitorder="little").view(np.uint32)
            for r in ind]


def _sorted(res):
    order = np.lexsort((res.pairs[:, 1], res.pairs[:, 0]))
    return res.pairs[order], res.ani_est[order]


def _assert_same(got, want):
    pw, aw = _sorted(want)
    pg, ag = _sorted(got)
    np.testing.assert_array_equal(pg, pw)
    np.testing.assert_array_equal(ag.view(np.int32), aw.view(np.int32))
    return pg


def _references(packed, sizes, cut, block, bits=4096, cache_blocks=True):
    """The port's and the JAX package's screen_triangle_packed."""
    kw = dict(k=K, min_containment=cut, bits=bits, block=block,
              cache_blocks=cache_blocks)
    return (pf.screen_triangle_packed(packed, sizes, device=CPU, **kw),
            jax_pf.screen_triangle_packed(packed, sizes, **kw))


def _feed_host(scr, packed, sizes, idxs):
    scr.add_host_rows(idxs, [packed[i] for i in idxs],
                      [float(sizes[i]) for i in idxs])


def test_incremental_feed_matches_sequential_and_jax():
    packed, sizes = _corpus()
    n = len(packed)
    seq, want = _references(packed, sizes, 0.3, block=128)
    scr = pf.IncrementalPackedScreen(n, K, 0.3, 4096, CPU, block=128)
    order = np.random.default_rng(3).permutation(n).tolist()
    cuts = [0, 37, 61, 140, 141, 220, n]  # uneven, one of a single row
    for lo, hi in zip(cuts, cuts[1:]):
        _feed_host(scr, packed, sizes, order[lo:hi])
    assert scr.window == pf._pipeline_window() == 2
    got = scr.finish()
    _assert_same(seq, want)
    pairs = _assert_same(got, want)
    assert len(pairs) >= 75 * 74 // 2


def test_screen_dispatches_before_feed_completes():
    packed, sizes = _corpus(n=512)
    n = len(packed)
    scr = pf.IncrementalPackedScreen(n, K, 0.3, 4096, CPU, block=128)
    drained = []
    scr.on_pairs = lambda p, a: drained.append(len(p))
    for lo in range(0, n, 128):
        _feed_host(scr, packed, sizes, list(range(lo, lo + 128)))
        if lo == 0:
            first = scr.rows_at_first_dispatch
    res = scr.finish()
    assert first == scr.rows_at_first_dispatch == 128 < n
    assert sum(drained) == len(res.pairs) >= 2


def test_device_rows_and_host_rows_mix():
    packed, sizes = _corpus(n=200, seed=11)
    n = len(packed)
    _, want = _references(packed, sizes, 0.3, block=64)
    scr = pf.IncrementalPackedScreen(n, K, 0.3, 4096, CPU, block=64)
    rows = words_to_torch(np.stack(packed))
    # rows 0..69 in order, 70..119 reversed inside their batch, then a
    # repeat of rows already fed, then the rest from the host
    scr.add_device_rows(list(range(70)), rows[:70], list(range(70)),
                        [float(sizes[i]) for i in range(70)])
    b2 = list(range(70, 120))
    scr.add_device_rows(b2, rows[70:120].flip(0), [119 - i for i in b2],
                        [float(sizes[i]) for i in b2])
    scr.add_device_rows([5, 6], rows[:2], [0, 1], [0.0, 0.0])
    assert scr.missing_rows() == list(range(120, n))
    _feed_host(scr, packed, sizes, scr.missing_rows())
    _assert_same(scr.finish(), want)


def _near_duplicates(rng, n, n_near, bits=4096):
    base = rng.random(bits) < 0.2
    keep = rng.uniform(0.5, 0.95, size=(n_near, 1))
    ind = rng.random((n, bits)) < 0.05
    ind[:n_near] = base & (rng.random((n_near, bits)) < keep)
    return ind.astype(np.uint8)


def _knife(packed, sizes, rows, bf16_above, lo=0.5, hi=0.75):
    """A cutoff midway between one pair's float32 containment and its
    bfloat16 rounding (above or below it), among the first `rows`."""
    from galah_tpu_torch.ops.packed_matmul import (
        packed_intersect_counts_reference,
    )

    x = words_to_torch(np.stack(packed[:rows]))
    s = torch.from_numpy(np.asarray(sizes[:rows], np.float32))
    cont = pf._containment(packed_intersect_counts_reference(x, x).float(),
                           s, s, 4096.0)
    c16 = pf._bf16(cont)
    upper = torch.ones_like(cont, dtype=torch.bool).triu(1)
    side = (c16 > cont) if bf16_above else (c16 < cont)
    i, j = map(int, torch.nonzero(upper & side & (cont > lo) & (cont < hi))[0])
    cut = float((cont[i, j].double() + c16[i, j].double()) / 2)
    return (i, j), cut, cont, upper


@pytest.mark.parametrize("window", [1, 16])
def test_tile_over_cap_decided_on_bfloat16(monkeypatch, window):
    """A 260-row diagonal tile with more than cap hits, fed in two
    batches: decided on its bfloat16 containment, as the JAX package
    decides it, at either window."""
    rng = np.random.default_rng(5)
    n, bits = 260, 4096
    base = (rng.random(bits) < 0.2).astype(np.uint8)
    keep = rng.random((n, 1)) < rng.uniform(0.55, 1.0, size=(n, 1))
    ind = (base[None, :] & (rng.random((n, bits))
                            < np.where(keep, 0.97, 0.8))).astype(np.uint8)
    packed, sizes = _packed(ind), ind.sum(axis=1)
    (i, j), cut, cont, upper = _knife(packed, sizes, n, bf16_above=True)
    assert int((upper & (cont >= cut)).sum()) > pf._screen_cap_for(1024)
    monkeypatch.setenv("GALAH_TPU_PIPELINE_WINDOW", str(window))
    scr = pf.IncrementalPackedScreen(n, K, cut, bits, CPU, block=1024)
    _feed_host(scr, packed, sizes, list(range(0, n, 2)))
    _feed_host(scr, packed, sizes, list(range(1, n, 2)))
    assert scr.window == window
    _, want = _references(packed, sizes, cut, block=1024)
    pairs = _assert_same(scr.finish(), want)
    assert (i, j) in set(map(tuple, pairs.tolist()))


@pytest.mark.parametrize("window", [1, 16])
def test_streaming_tile_over_row_sel_decided_on_bfloat16(monkeypatch,
                                                         window):
    """300 rows, 150 near-duplicates: the streaming sweep's first
    diagonal tile has hits in more than _row_sel(256) rows, under cap,
    so it is decided on bfloat16 and drops a pair the resident screen
    keeps; both equal the JAX package's at either window."""
    ind = _near_duplicates(np.random.default_rng(2), 300, 150)
    packed, sizes = _packed(ind), ind.sum(axis=1)
    (i, j), cut, cont, upper = _knife(packed, sizes, 300, bf16_above=False,
                                      lo=0.65)
    hits = (upper & (cont >= cut))[:256, :256]
    assert int(hits.sum()) <= pf._screen_cap_for(256)
    assert int(hits.any(dim=1).sum()) > pf._row_sel(256)
    monkeypatch.setattr(pf, "TILE_WINDOW", window)
    streaming = _assert_same(*_references(packed, sizes, cut, block=256,
                                          cache_blocks=False))
    resident = _assert_same(*_references(packed, sizes, cut, block=256))
    assert (i, j) in set(map(tuple, resident.tolist()))
    assert (i, j) not in set(map(tuple, streaming.tolist()))


def test_finish_raises_on_rows_never_fed():
    packed, sizes = _corpus(n=64)
    scr = pf.IncrementalPackedScreen(64, K, 0.3, 4096, CPU, block=64)
    _feed_host(scr, packed, sizes, [0, 1])
    with pytest.raises(RuntimeError, match="62 rows never fed"):
        scr.finish()
    with pytest.raises(RuntimeError, match="already finished"):
        _feed_host(scr, packed, sizes, [2])


# ------------------------------------------------------------ the engine

ENV = ("GALAH_TPU_PIPELINE", "GALAH_TPU_DEVICE_SKETCH", "GALAH_TPU_SCREEN",
       "GALAH_TPU_VERIFY_FLUSH", "GALAH_TPU_VERIFY_DEVICES")


def _run_port(monkeypatch, pipeline, call, max_len, device_sketch="1"):
    """(cache dict, counters) of one port run of call(preclusterer), with
    8-row screen blocks so the corpus spans several row blocks."""
    from galah_tpu_torch.engines.native import (
        NativeContext,
        NativePreclusterer,
    )
    from galah_tpu_torch.utils import metrics

    monkeypatch.setattr(pf, "DEFAULT_BLOCK", 8)
    for var, val in zip(ENV, (pipeline, device_sketch, "packed", "4", "1")):
        monkeypatch.setenv(var, val)
    m = metrics.reset()
    pre = NativePreclusterer(90.0, 0.15,
                             NativeContext(CPU, max_genome_length=max_len))
    return dict(call(pre).items()), dict(m.counters)


def _run_jax(monkeypatch, call, max_len):
    from galah_tpu.engines.native import NativeContext, NativePreclusterer

    for var, val in zip(ENV, ("0", "0", "packed", "4", "1")):
        monkeypatch.setenv(var, val)
    pre = NativePreclusterer(90.0, 0.15,
                             NativeContext(max_genome_length=max_len))
    return dict(call(pre).items())


def _assert_pipelined_equal(monkeypatch, call, max_len, n):
    seq, _ = _run_port(monkeypatch, "0", call, max_len)
    pipe, counters = _run_port(monkeypatch, "1", call, max_len)
    want = _run_jax(monkeypatch, call, max_len)
    assert pipe == seq == want
    assert counters["phases_overlapped"] == 1
    assert counters["screen_rows_device_born"] == n
    assert "verify_streams_uploaded" not in counters  # all from the arena
    return pipe, counters


def test_engine_pipelined_distances_match_sequential_and_jax(
        monkeypatch, tmp_path):
    """Two length buckets, so two device-sketch batches: the first
    completes the leading row blocks while the second is sketched."""
    from galah_tpu_torch.utils.synth import make_families

    small, _ = make_families(str(tmp_path / "s"), 3, 3, genome_length=24_000,
                             within_ani=0.97, seed=5)
    big, _ = make_families(str(tmp_path / "b"), 3, 3, genome_length=40_000,
                           within_ani=0.97, seed=6)
    paths = sorted(small) + sorted(big)
    pipe, counters = _assert_pipelined_equal(
        monkeypatch, lambda pre: pre.distances(paths), 40_000, len(paths))
    assert len(pipe) >= 6 * 3  # every within-family pair
    assert counters["screen_rows_at_first_dispatch"] == len(small)
    assert counters["screen_tiles"] == 3 * 4 // 2


def test_engine_pipelined_contig_mode_matches_sequential_and_jax(
        monkeypatch, tmp_path):
    """Files of long unrelated contigs and of short related ones,
    alternating: the short ones' batch comes first and completes row
    blocks 1 and 3, the long ones' then blocks 0 and 2."""
    from galah_tpu_torch.io.fasta import contig_names
    from galah_tpu_torch.utils.synth import (
        mutate,
        random_genome,
        write_fasta_contigs,
    )

    rng = np.random.default_rng(17)
    base = random_genome(rng, 12_000)
    paths = []
    for f in range(4):
        p = str(tmp_path / f"g{f}.fna")
        write_fasta_contigs(p, [mutate(rng, base, 0.97) if f % 2
                                else random_genome(rng, 30_000)
                                for c in range(8)], f"g{f}")
        paths.append(p)
    names = [nm for p in paths for nm in contig_names(p)]
    pipe, counters = _assert_pipelined_equal(
        monkeypatch, lambda pre: pre.distances_contigs(paths, names),
        30_000, len(names))
    assert counters["screen_rows_at_first_dispatch"] == 16
    assert len(pipe) >= 16 * 15 // 2  # the mutated-base contigs all relate


def test_pipelined_duplicate_paths_emit_every_index_pair(monkeypatch,
                                                          tmp_path):
    """A path given twice: both of its rows are fed, and every index
    pair of the key pair is emitted (the shared _emit_verified rule)."""
    from galah_tpu_torch.utils.synth import make_families

    paths, _ = make_families(str(tmp_path / "c"), 2, 3, genome_length=24_000,
                             within_ani=0.97, seed=8)
    dup = list(paths) + [paths[0]]
    pipe, _ = _assert_pipelined_equal(
        monkeypatch, lambda pre: pre.distances(dup), 24_000, len(dup))
    assert any(len(dup) - 1 in key for key in pipe)


def test_pipeline_back_fills_rows_the_sink_never_saw(monkeypatch, tmp_path):
    """Host sketches under GALAH_TPU_PIPELINE=1, and a second run over
    sketches already in the store: every row reaches the screen after
    sketching, and the cache is the sequential one."""
    from galah_tpu_torch.engines.native import (
        NativeContext,
        NativePreclusterer,
        _use_device_sketch,
    )
    from galah_tpu_torch.utils import metrics
    from galah_tpu_torch.utils.synth import make_families

    paths, _ = make_families(str(tmp_path / "c"), 3, 3, genome_length=24_000,
                             within_ani=0.97, seed=9)
    call = lambda pre: pre.distances(paths)  # noqa: E731
    seq, _ = _run_port(monkeypatch, "0", call, 24_000)
    host, counters = _run_port(monkeypatch, "1", call, 24_000,
                               device_sketch="0")
    assert host == seq
    assert counters["screen_rows_host_uploaded"] == len(paths)
    assert counters["screen_rows_at_first_dispatch"] == len(paths)
    monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "1")
    assert _use_device_sketch(CPU)
    ctx = NativeContext(CPU, max_genome_length=24_000)
    pre = NativePreclusterer(90.0, 0.15, ctx)
    ctx.sketch_many(paths)
    m = metrics.reset()
    again = pre.distances(paths)
    assert dict(again.items()) == seq
    assert m.counters["screen_rows_host_uploaded"] == len(paths)


@pytest.mark.parametrize("env,want", [
    ({}, True),
    ({"GALAH_TPU_PIPELINE": "0"}, False),
    ({"GALAH_TPU_DEVICE_SKETCH": "0"}, False),
    ({"GALAH_TPU_DEVICE_SKETCH": "0", "GALAH_TPU_PIPELINE": "1"}, True),
    ({"GALAH_TPU_RESIDENT": "0", "GALAH_TPU_PIPELINE": "1"}, False),
    ({"GALAH_TPU_SCREEN": "popcount"}, False),
    ({"low_memory": True}, False),
])
def test_pipeline_enabled_follows_the_reference_rule(monkeypatch, env, want):
    from galah_tpu_torch.engines.native import (
        NativeContext,
        NativePreclusterer,
    )

    for var in ("GALAH_TPU_PIPELINE", "GALAH_TPU_RESIDENT",
                "GALAH_TPU_SCREEN"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "1")
    env = dict(env)
    low_memory = env.pop("low_memory", False)
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    pre = NativePreclusterer(95.0, 0.15, NativeContext(
        CPU, low_memory=low_memory, max_genome_length=24_000))
    assert pre._pipeline_enabled(10) == want
    assert not pre._pipeline_enabled(1)
    monkeypatch.setattr(pf, "_device_resident_budget", lambda device: 0)
    import galah_tpu_torch.engines.native as native

    monkeypatch.setattr(native, "_device_resident_budget", lambda device: 0)
    assert not pre._pipeline_enabled(10)


@pytest.mark.parametrize("pipeline", ["0", "1"])
def test_engine_frees_its_context_after_a_run(monkeypatch, tmp_path,
                                              pipeline):
    """A run leaves no reference cycle through its tile queue or its
    pair table, so the NativeContext and its fragment-ANI engine (on a
    card: the 2 GiB stream arena and the bitmap pools) are freed as soon
    as the caller drops them, without waiting for the cyclic
    collector."""
    import gc
    import weakref

    from galah_tpu_torch.engines.native import (
        NativeContext,
        NativePreclusterer,
    )
    from galah_tpu_torch.utils.synth import make_families

    paths, _ = make_families(str(tmp_path), 2, 3, genome_length=24_000,
                             within_ani=0.97, seed=5)
    monkeypatch.setattr(pf, "DEFAULT_BLOCK", 4)
    for var, val in zip(ENV, (pipeline, "1", "packed", "4", "1")):
        monkeypatch.setenv(var, val)
    gc.collect()
    gc.disable()
    try:
        ctx = NativeContext(CPU, max_genome_length=24_000)
        alive = [weakref.ref(ctx), weakref.ref(ctx.frag_engine)]
        assert len(NativePreclusterer(90.0, 0.15, ctx).distances(paths)) >= 6
        del ctx
        assert [r() for r in alive] == [None, None]
    finally:
        gc.enable()
