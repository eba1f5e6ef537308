"""The port's GALAH_TPU_* switches against the JAX package's behaviour,
on the CPU: GALAH_TPU_SCREEN_BLOCK (the screens' tile edge),
GALAH_TPU_VERIFY_GATHER (word or bit-transposed gathers in the grouped
verify), GALAH_TPU_VERIFY_REFS (the grouped verify's width cap),
GALAH_TPU_PREF_CACHE_BYTES (the device-born screen-row cache) and
GALAH_TPU_PROFILE (a torch.profiler trace of a cluster run).

Screens: pairs identical and ANI bit for bit. Verify: ANI within the
1e-3 percentage points of tests/test_torch_verify.py (float32 `pow` may
differ by an ulp between XLA and torch), AF exact, and the port's
gather modes and widths bit-identical to one another."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galah_tpu.ops import fragment_ani as jax_fa
from galah_tpu.ops import prefilter as jax_pf
from galah_tpu.parallel import distance as jax_dist
from galah_tpu.parallel.mesh import make_mesh
from galah_tpu_torch.cli.main import main as torch_main
from galah_tpu_torch.ops import fragment_ani as fa
from galah_tpu_torch.ops import prefilter as pf
from galah_tpu_torch.parallel import distance as dist
from galah_tpu_torch.utils import metrics
from galah_tpu_torch.utils.convert import words_to_torch
from galah_tpu_torch.utils.synth import make_families
from test_torch_prefilter import _packed_rows, near_duplicates
from test_torch_verify import ANI_TOL, _engines, corpus, port_sketches  # noqa: F401

CPU = torch.device("cpu")


def _bitwise(got, want):
    """Pairs in the same order, ANI as int32 views."""
    assert np.array_equal(got.pairs, np.asarray(want.pairs))
    assert np.array_equal(np.asarray(got.ani_est, np.float32).view(np.int32),
                          np.asarray(want.ani_est, np.float32).view(np.int32))


# ------------------------------------------------------ GALAH_TPU_SCREEN_BLOCK


@pytest.fixture(scope="module")
def block_corpus():
    """2,100 packed rows of 1,024 bits: three tiles at an edge of 2,048
    (six at the default 1,024). The first 300 rows are one family of
    near-duplicates, so tile (0, 0) holds about 45,000 pairs above the
    cutoff, past the 2,048 edge's cap of 32,768, and is decided on its
    bfloat16 containment."""
    ind = near_duplicates(np.random.default_rng(5), 2100, 300, bits=1024)
    return _packed_rows(ind), ind.sum(axis=1), 1024


@pytest.mark.parametrize("sweep", ["resident", "streaming", "sharded"])
def test_screen_block_env_matches_jax(block_corpus, sweep, monkeypatch):
    """GALAH_TPU_SCREEN_BLOCK=2048 sets both packages' tile edge: the
    single-device sweeps (resident and streaming) and the sharded sweep
    over 2 shards give the JAX package's pairs under the same variable,
    over three tiles with an overflowing one."""
    packed, sizes, bits = block_corpus
    monkeypatch.setenv("GALAH_TPU_SCREEN_BLOCK", "2048")
    assert pf._screen_block() == 2048
    cut = 0.3
    m = metrics.reset()
    if sweep == "sharded":
        got = dist.sharded_screen_triangle_packed(
            packed, sizes, 15, cut, bits, devices=[CPU] * 2)
        want = jax_dist.sharded_screen_triangle_packed(
            packed, sizes, 15, cut, bits, mesh=make_mesh(jax.devices()[:2]))
    else:
        cache = sweep == "resident"
        got = pf.screen_triangle_packed(packed, sizes, 15, cut, bits,
                                        device=CPU, cache_blocks=cache)
        want = jax_pf.screen_triangle_packed(packed, sizes, 15, cut, bits,
                                             cache_blocks=cache)
    _bitwise(got, want)
    if sweep == "resident":
        assert m.counters["screen_tiles"] == 3
    assert np.sum(got.pairs[:, 1] < 300) > pf._screen_cap_for(2048)


def test_screen_block_env_sets_every_fallback(monkeypatch):
    """Every packed sweep that takes no edge reads the variable: the
    incremental screen, the single-device sweeps (their queues' edge)
    and the sharded ones (before _pick_block); the indicator sweeps keep
    DEFAULT_BLOCK, as the JAX package's do."""
    edges = []
    real = pf._TileQueue.__init__

    def spy(self, bits, min_containment, block, *a, **k):
        edges.append(block)
        real(self, bits, min_containment, block, *a, **k)

    monkeypatch.setattr(pf._TileQueue, "__init__", spy)
    monkeypatch.setenv("GALAH_TPU_SCREEN_BLOCK", "512")
    ind = near_duplicates(np.random.default_rng(1), 600, 10, bits=1024)
    packed, sizes = _packed_rows(ind), ind.sum(axis=1)
    assert pf.IncrementalPackedScreen(600, 15, 0.3, 1024, CPU).block == 512
    pf.screen_triangle_packed(packed, sizes, 15, 0.3, 1024, device=CPU)
    pf.screen_rectangle_packed(packed, sizes, packed, sizes, 15, 0.3, 1024,
                               device=CPU)
    dist.sharded_screen_triangle_packed(packed, sizes, 15, 0.3, 1024,
                                        devices=[CPU] * 2)
    dist.sharded_screen_rectangle_packed(packed, sizes, packed, sizes, 15,
                                         0.3, 1024, devices=[CPU] * 2)
    assert set(edges) == {512}
    edges.clear()
    pf.screen_triangle(list(ind), sizes, 15, 0.3, CPU)
    pf.screen_rectangle(list(ind), sizes, list(ind), sizes, 15, 0.3, CPU)
    assert edges == [pf.DEFAULT_BLOCK] * 2


# ------------------------------------------------ bit-transposed verify


@pytest.mark.parametrize("r", [32, 96])
def test_bit_transpose_table_matches_jax(r):
    rng = np.random.default_rng(r)
    bm = rng.integers(0, 1 << 32, size=(r, 96), dtype=np.uint32)
    bm[0] = 0xFFFFFFFF  # every sign bit set
    want = np.asarray(jax_fa._bit_transpose_table(jnp.asarray(bm)))
    got = fa._bit_transpose_table(words_to_torch(bm))
    assert got.dtype == torch.int32 and got.shape == (96 * 32, r // 32)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    with pytest.raises(ValueError, match="multiple of 32"):
        fa._bit_transpose_table(words_to_torch(bm[:20]))


def test_forward_kernel_bt_matches_jax_and_word(corpus, port_sketches):
    """The bit-transposed kernel over 8 references padded to 32: JAX's
    bit-transposed kernel's values, and the port's word kernel's bit for
    bit."""
    small, large, params, sk = corpus
    refs = [sk[p] for p in large[1:] + small[:6]]
    q, pq = sk[large[0]], port_sketches[large[0]]
    bm = np.zeros((32, params.member_bits // 32), np.uint32)
    bm[:len(refs)] = np.stack([s.member_bitmap_words() for s in refs])
    pc = np.zeros(32, np.float32)
    pc[:len(refs)] = [s.member_popcount for s in refs]
    n, f = len(q.frag_buckets), q.n_fragments
    buckets = np.zeros(jax_fa._round_up(n, 1 << 14), np.int32)
    buckets[:n] = q.frag_buckets
    offsets = np.full(jax_fa._round_up(f, 1 << 9) + 1, n, np.int32)
    offsets[: f + 1] = q.frag_offsets
    kw = dict(bits=params.member_bits, k=params.k,
              min_hashes=params.min_fragment_hashes,
              min_ident=jax_fa.FragmentAniConfig().min_fragment_identity)
    want_ani, want_af = jax_fa._forward_kernel_bt(
        jax_fa._bit_transpose_table(jnp.asarray(bm)), jnp.asarray(pc),
        jnp.asarray(buckets), jnp.asarray(offsets), jnp.int32(n), **kw)
    b = torch.from_numpy(np.asarray(pq.frag_buckets, np.int32))
    o = torch.from_numpy(np.asarray(pq.frag_offsets, np.int32))
    r = len(refs)
    got = fa._forward_kernel_bt(
        fa._bit_transpose_table(words_to_torch(bm)),
        torch.from_numpy(pc[:r]), b, o, **kw)
    word = fa._forward_kernel(words_to_torch(bm), torch.arange(r),
                              torch.from_numpy(pc[:r]), b, o, **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_ani)[:r],
                               rtol=0, atol=ANI_TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_af)[:r])
    for g, w in zip(got, word):
        assert torch.equal(g, w)
    assert got[0][:2].min() > 95.0  # same-family references


@pytest.mark.parametrize("refs_cap", [None, "8"])
@pytest.mark.parametrize("mode", ["word", "bt", "auto"])
def test_one_to_many_gather_modes_and_widths(corpus, port_sketches,
                                             monkeypatch, mode, refs_cap):
    """one_to_many under each GALAH_TPU_VERIFY_GATHER value and
    GALAH_TPU_VERIFY_REFS width: the JAX package's ANI and AF under the
    same variable, each chunk taking the route the mode names (auto
    gathers words, as the JAX package's does on the CPU), and the
    port's word result bit for bit."""
    small, large, params, sk = corpus
    names = large[1:] + small[:11]
    if refs_cap:
        monkeypatch.setenv("GALAH_TPU_VERIFY_REFS", refs_cap)
    jeng, peng = _engines(params, monkeypatch)
    monkeypatch.setenv("GALAH_TPU_VERIFY_GATHER", mode)
    want = jeng.one_to_many(sk[large[0]], large[0], [sk[p] for p in names],
                            names)
    psk = port_sketches

    def run():
        reg = metrics.reset()
        out = peng.one_to_many(psk[large[0]], large[0],
                               [psk[p] for p in names], names)
        return out, {k: v for k, v in reg.counters.items()
                     if k.startswith("verify_grouped_")}

    got, counters = run()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ANI_TOL)
    np.testing.assert_array_equal(got[1], want[1])
    chunks = 2 if refs_cap else 1
    route = "bt" if mode == "bt" else "word"
    assert counters == {f"verify_grouped_{route}_dispatches": chunks}
    monkeypatch.setenv("GALAH_TPU_VERIFY_GATHER", "word")
    word, _ = run()
    for g, w in zip(got, word):
        assert np.array_equal(g.view(np.int32), w.view(np.int32))


def test_bt_table_per_dispatch_and_budget(corpus, port_sketches,
                                          monkeypatch):
    """Under bt each dispatch builds its reference group's table (none
    is cached, so nothing outlives the dispatch); a chunk whose padded
    (references, stream) intermediates exceed the budget gathers words
    even under bt."""
    small, large, params, _ = corpus
    _, peng = _engines(params, monkeypatch)
    psk = port_sketches
    names = small[:5]
    monkeypatch.setenv("GALAH_TPU_VERIFY_GATHER", "bt")
    built = []
    real = fa._bit_transpose_table
    monkeypatch.setattr(fa, "_bit_transpose_table",
                        lambda x: built.append(x.shape) or real(x))
    for q in large:
        peng.one_to_many(psk[q], q, [psk[p] for p in names], names)
    assert built == [(32, params.member_bits // 32)] * len(large)
    monkeypatch.setattr(fa, "_GROUPED_BUDGET", 32 * (1 << 14) - 1)
    reg = metrics.reset()
    peng.one_to_many(psk[large[0]], large[0], [psk[p] for p in names], names)
    assert reg.counters["verify_grouped_word_dispatches"] == 1
    assert "verify_grouped_bt_dispatches" not in reg.counters


@pytest.mark.parametrize("value", [None, "bt", "word", "auto", "other"])
def test_gather_mode_defaults(monkeypatch, value):
    """Words on every device unless the variable says bt; unset, auto
    and any other value gather words."""
    if value is None:
        monkeypatch.delenv("GALAH_TPU_VERIFY_GATHER", raising=False)
    else:
        monkeypatch.setenv("GALAH_TPU_VERIFY_GATHER", value)
    assert fa._verify_gather_mode() == ("bt" if value == "bt" else "word")


# ---------------------------------- GALAH_TPU_PREF_CACHE_BYTES and _PROFILE


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    d = tmp_path_factory.mktemp("switch_corpus")
    paths, fams = make_families(str(d), 3, 3, genome_length=30_000, seed=9)
    return str(d), paths, fams


def test_pref_cache_bytes_evicts_and_keeps_results(genomes, monkeypatch):
    """A row cache of two rows' bytes keeps the last two device-born
    rows; the screen takes the rest from the host sketches, and the
    distances equal those of the default budget."""
    from galah_tpu_torch.engines import native
    from galah_tpu_torch.ops import device_sketch

    _, paths, _ = genomes
    monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "1")
    monkeypatch.setenv("GALAH_TPU_PIPELINE", "0")
    monkeypatch.setitem(device_sketch.GENOME_BATCH_BYTES, "cpu", 40_000)

    def run():
        ctx = native.NativeContext(CPU, max_genome_length=30_000)
        pre = native.NativePreclusterer(95.0, 0.15, ctx)
        m = metrics.reset()
        cache = pre.distances(paths)
        return ctx, dict(cache.items()), m.counters

    ctx, want, c_default = run()
    assert ctx._pref_cache._budget == native.PREF_CACHE_BYTES
    assert len(ctx._pref_cache) == len(paths)
    two_rows = ctx.params.prefilter_bits // 8 * 2
    monkeypatch.setenv("GALAH_TPU_PREF_CACHE_BYTES", str(two_rows))
    ctx, got, c_small = run()
    assert ctx._pref_cache._budget == two_rows
    assert len(ctx._pref_cache) == 2
    assert c_small["screen_rows_host_uploaded"] == len(paths) - 2
    assert not c_default.get("screen_rows_host_uploaded")
    assert got == want and len(got) > 0


def test_profile_writes_a_trace(genomes, tmp_path, monkeypatch):
    """GALAH_TPU_PROFILE=<dir>: a Chrome trace of the run lands in
    <dir> after the outputs, with the CPU activity only on the CPU, and
    clusters.tsv is the same as without it."""
    from galah_tpu_torch.cli import cluster_cmd

    d, _, _ = genomes
    monkeypatch.setenv("GALAH_TPU_PLATFORM", "cpu")
    argv = ["cluster", "-d", d, "-x", "fna", "--ani", "95", "-q",
            "--output-cluster-definition"]
    assert torch_main(argv + [str(tmp_path / "plain.tsv")]) == 0
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("GALAH_TPU_PROFILE", str(trace_dir))
    assert torch_main(argv + [str(tmp_path / "traced.tsv")]) == 0
    assert ((tmp_path / "traced.tsv").read_bytes()
            == (tmp_path / "plain.tsv").read_bytes())
    (trace,) = trace_dir.glob("galah_tpu_torch.*.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert not cluster_cmd._on_card(None)
    assert cluster_cmd._on_card([CPU, torch.device("cuda", 0)])
