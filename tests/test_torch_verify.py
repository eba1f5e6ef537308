"""galah_tpu_torch's verify kernels against the JAX package's.

Sketches of small synthetic family corpora go through both packages on
the CPU. Tolerance: ANI within 1e-3 percentage points, AF exact. The
ANI tolerance covers float32 `pow` results that may differ by an ulp
between XLA and torch, which can move one fragment's 2^-14 fixed-point
identity."""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from galah_tpu.ops import fragment_ani as jax_fa
from galah_tpu.sketch.fracminhash import NativeSketchParams, sketch_file_native
from galah_tpu.utils import metrics as jax_metrics
from galah_tpu.utils.synth import make_families
from galah_tpu_torch.engines.native import _shrink_bits
from galah_tpu_torch.ops import fragment_ani as fa
from galah_tpu_torch.utils import metrics
from galah_tpu_torch.utils.convert import native_sketch_from_fields, words_to_torch

CPU = torch.device("cpu")
ANI_TOL = 1e-3
# A pair-table budget small enough that the 100 kb genomes' streams
# (~12.5k hashes) exceed max_flat_hashes // 8 while the 60 kb ones
# (~7.5k) do not, so both kernels take part.
SMALL_FLAT = 1 << 16


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("verify_corpus")
    small, _ = make_families(str(d / "s"), 4, 4, genome_length=60_000, seed=3)
    large, _ = make_families(str(d / "l"), 1, 3, genome_length=100_000, seed=4)
    params = _shrink_bits(NativeSketchParams(), 100_000)
    sketches = {p: sketch_file_native(p, params) for p in small + large}
    return small, large, params, sketches


@pytest.fixture(scope="module")
def port_sketches(corpus):
    """The JAX package's sketches as the port's NativeSketch."""
    return {p: native_sketch_from_fields(s) for p, s in corpus[3].items()}


def _engines(params, monkeypatch):
    monkeypatch.setenv("GALAH_TPU_VERIFY_DEVICES", "1")
    kw = dict(k=params.k, member_bits=params.member_bits,
              min_fragment_hashes=params.min_fragment_hashes)
    return (
        jax_fa.FragmentAniEngine(jax_fa.FragmentAniConfig(**kw)),
        fa.FragmentAniEngine(fa.FragmentAniConfig(**kw), CPU),
    )


def _assert_close(got, want):
    assert got.keys() == want.keys()
    for key in want:
        g, w = got[key], want[key]
        assert abs(g[0] - w[0]) <= ANI_TOL, (key, g, w)
        assert g[1:] == w[1:], (key, g, w)


def test_pair_table_matches_jax(corpus, port_sketches, monkeypatch):
    small, _, params, sk = corpus
    pairs = [(a, b) for a in small for b in small if a != b][:150]
    jeng, peng = _engines(params, monkeypatch)
    want = jeng._pair_table().run(pairs, sk)
    got = peng.pair_table.run(pairs, port_sketches)
    _assert_close(got, want)
    # within-family pairs sit near 98% ANI; cross-family near nothing
    assert max(v[0] for v in got.values()) > 95.0
    assert min(v[1] for v in got.values()) < 0.1


def test_pair_table_batching_does_not_change_results(
    corpus, port_sketches, monkeypatch
):
    small, _, params, _ = corpus
    sk = port_sketches
    pairs = [(a, b) for a in small[:8] for b in small[:8] if a != b]
    _, peng = _engines(params, monkeypatch)
    whole = peng.pair_table.run(pairs, sk)
    peng.pair_table.cfg = dataclasses.replace(
        peng.pair_table.cfg, max_flat_hashes=20_000, max_bitmaps=3
    )
    assert len(peng.pair_table._plan_batches(pairs, sk)) > 5
    assert peng.pair_table.run(pairs, sk) == whole


def test_forward_kernel_matches_jax(corpus, port_sketches):
    small, large, params, sk = corpus
    q = sk[large[0]]
    refs = [sk[p] for p in large[1:] + small[:5]]
    pq = port_sketches[large[0]]
    bm = np.stack([s.member_bitmap_words() for s in refs])
    pc = np.array([s.member_popcount for s in refs], np.float32)
    n, f = len(q.frag_buckets), q.n_fragments
    npad = jax_fa._round_up(n, 1 << 14)
    fpad = jax_fa._round_up(f, 1 << 9)
    buckets = np.zeros(npad, np.int32)
    buckets[:n] = q.frag_buckets
    offsets = np.full(fpad + 1, n, np.int32)
    offsets[: f + 1] = q.frag_offsets
    kw = dict(bits=params.member_bits, k=params.k,
              min_hashes=params.min_fragment_hashes,
              min_ident=jax_fa.FragmentAniConfig().min_fragment_identity)
    want_ani, want_af = jax_fa._forward_kernel(
        jnp.asarray(bm), jnp.asarray(pc), jnp.asarray(buckets),
        jnp.asarray(offsets), jnp.int32(n), **kw,
    )
    got_ani, got_af = fa._forward_kernel(
        words_to_torch(bm), torch.arange(len(refs)), torch.from_numpy(pc),
        torch.from_numpy(np.asarray(pq.frag_buckets, np.int32)),
        torch.from_numpy(np.asarray(pq.frag_offsets, np.int32)), **kw,
    )
    np.testing.assert_allclose(got_ani.numpy(), np.asarray(want_ani),
                               rtol=0, atol=ANI_TOL)
    np.testing.assert_array_equal(got_af.numpy(), np.asarray(want_af))
    assert got_ani.numpy()[:2].min() > 95.0  # same-family refs


def test_one_to_many_matches_jax(corpus, port_sketches, monkeypatch):
    small, large, params, sk = corpus
    refs = large[1:] + small[:6]
    jeng, peng = _engines(params, monkeypatch)
    want = jeng.one_to_many(sk[large[0]], large[0], [sk[p] for p in refs],
                            refs)
    psk = port_sketches
    got = peng.one_to_many(psk[large[0]], large[0], [psk[p] for p in refs],
                           refs)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ANI_TOL)
    np.testing.assert_array_equal(got[1], want[1])


def _bidirectional(eng, table, pairs, sk, registry):
    """Results and (pair-table, grouped) directed-pair counts, read from
    `registry`: the metrics module of the package that `eng` is from."""
    table.cfg = dataclasses.replace(table.cfg, max_flat_hashes=SMALL_FLAT)
    registry.reset()
    out = eng.bidirectional(pairs, sk)
    c = registry.current().counters
    return out, (c.get("verify_directed_pairtable", 0),
                 c.get("verify_directed_grouped", 0))


def test_bidirectional_matches_jax_with_routing(
    corpus, port_sketches, monkeypatch
):
    small, large, params, sk = corpus
    units = small[:8] + large
    pairs = [(a, b) for i, a in enumerate(units) for b in units[i + 1:]]
    thresh = SMALL_FLAT // 8
    assert max(len(sk[p].frag_buckets) for p in small) <= thresh
    assert min(len(sk[p].frag_buckets) for p in large) > thresh
    jeng, peng = _engines(params, monkeypatch)
    want, want_routes = _bidirectional(jeng, jeng._pair_table(), pairs, sk,
                                       jax_metrics)
    got, got_routes = _bidirectional(peng, peng.pair_table, pairs,
                                     port_sketches, metrics)
    assert got_routes == want_routes
    n_small = 8 * 7 // 2
    assert got_routes == (2 * n_small, 2 * (len(pairs) - n_small))
    _assert_close(got, want)

    def family(path):
        return os.path.dirname(path), os.path.basename(path).split("_m")[0]

    fam = [(a, b) for a, b in pairs if family(a) == family(b)]
    assert all(got[p][0] > 95.0 for p in fam)


def test_low_memory_engine_matches_default(corpus, monkeypatch):
    """Low-memory mode: sketches round-trip through the disk store, the
    screen streams, and verify runs in batches of three genomes. The
    distance cache must equal the default mode's."""
    from galah_tpu_torch.engines import native
    from galah_tpu_torch.sketch.store import DiskSketchStore

    small, large, _, _ = corpus
    params = _shrink_bits(native.NativeSketchParams(), 100_000)
    monkeypatch.setattr(native, "LOW_MEMORY_VERIFY_KEYS", 3)
    batches = []
    run = fa.FragmentAniEngine.bidirectional
    monkeypatch.setattr(
        fa.FragmentAniEngine, "bidirectional",
        lambda self, pairs, sk: batches.append(len(sk)) or run(self, pairs, sk),
    )
    out = []
    for low_memory in (False, True):
        ctx = native.NativeContext(CPU, params=params, threads=2,
                                   low_memory=low_memory)
        cache = native.NativePreclusterer(95.0, 0.15, ctx).distances(
            small + large
        )
        assert isinstance(ctx._store, DiskSketchStore) == low_memory
        out.append(dict(cache.items()))
    assert out[0] == out[1]
    assert len(out[0]) >= 16
    assert len(batches) > 2 and max(batches[1:]) <= 4
