"""galah_tpu_torch on a CUDA device: the hand-written kernels against
their plain versions, and the screens and verify on the card against the
same code on the CPU.

Every test needs a card and skips without one (the `cuda_device`
fixture decides at run time). This file imports neither JAX nor
anything of the JAX package, so a GPU machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from galah_tpu_torch.ops.packed_matmul import (
    packed_intersect_counts,
    packed_intersect_counts_reference,
)
from galah_tpu_torch.ops.popcount_screen import (
    popcount_tile_counts,
    popcount_tile_counts_reference,
)

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _random_words(gen, shape, device):
    return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen,
                         dtype=torch.int64, device=device).to(torch.int32)


@pytest.mark.parametrize(
    "m,n,w", [(1024, 1024, 4096), (1000, 777, 1000), (1, 65, 33), (64, 64, 32)]
)
def test_kernel_matches_plain_version(cuda_device, m, n, w):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(m + n + w)
    a = _random_words(gen, (m, w), cuda_device)
    b = _random_words(gen, (n, w), cuda_device)
    a[0] = 0
    b[-1] = -1
    before = packed_intersect_counts.launches
    got = packed_intersect_counts(a, b)
    torch.cuda.synchronize()
    assert packed_intersect_counts.launches == before + 1
    assert got.device.type == "cuda"
    assert torch.equal(got, packed_intersect_counts_reference(a, b))


@pytest.mark.parametrize(
    "m,n,w",
    [(2048, 2048, 4096), (1000, 777, 1000), (1, 33, 513), (9, 300, 8192)],
)
def test_popcount_kernel_matches_plain_version(cuda_device, m, n, w):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(m + n + w)
    a = _random_words(gen, (m, w), cuda_device)
    b = _random_words(gen, (n, w), cuda_device)
    a[0] = 0
    b[-1] = -1
    before = popcount_tile_counts.launches
    got = popcount_tile_counts(a, b)
    torch.cuda.synchronize()
    assert popcount_tile_counts.launches == before + 1
    assert torch.equal(got, popcount_tile_counts_reference(a, b))
    assert torch.equal(got, packed_intersect_counts(a, b))


@pytest.mark.parametrize("rows,ns", [(1 << 17, 1 << 17), (1000, 1), (7, 4097),
                                     (1 << 20, 333_333)])
@pytest.mark.parametrize("kernel,unroll", [
    ("gather_xor", 1), ("gather_xor", 4), ("gather_xor", 8),
    ("gather_xor_chains", 8), ("gather_xor_chains", 16),
    ("gather_xor_chains", 32),
])
def test_gather_kernels_match_plain_version(cuda_device, kernel, unroll, rows,
                                            ns):
    from galah_tpu_torch.ops import gather_probe as gp

    fn = getattr(gp, kernel)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(rows + ns + unroll)
    idx = torch.randint(0, rows, (ns,), generator=gen, dtype=torch.int32,
                        device=cuda_device)
    table = _random_words(gen, (rows, gp.ROW_WORDS), cuda_device)
    before = fn.launches
    got = fn(idx, table, unroll)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.device.type == "cuda" and got.shape == (1, gp.ROW_WORDS)
    assert torch.equal(got, gp.gather_xor_reference(idx, table))


def _gather_case(case, gen, device):
    """(idx, table) of one edge of the gather kernel: no index, one, an
    odd count, every index in one 112 KiB stretch of rows, the last row,
    a table whose rows are no multiple of the warp's 32, and a table
    view at a 16-byte offset."""
    from galah_tpu_torch.ops import gather_probe as gp

    stretch = 3584
    wt, ns = {"ns0": (1000, 0), "ns1": (1, 1), "odd": (4000, 4097),
              "one stretch": (3 * stretch + 100, 12_001),
              "last row": (2 * stretch + 1, 9_001),
              "ragged": (5 * stretch + 77, 70_001),
              "offset view": (3000, 5_555)}[case]
    idx = torch.randint(0, wt, (ns,), generator=gen, dtype=torch.int32,
                        device=device)
    if case == "one stretch":
        idx = idx % stretch + stretch
    elif case == "last row":
        idx[::7] = wt - 1
    words = _random_words(gen, (wt + 1, gp.ROW_WORDS), device).reshape(-1)
    if case == "offset view":
        table = words[4:4 + wt * gp.ROW_WORDS].view(wt, gp.ROW_WORDS)
        assert table.data_ptr() % 32 == 16
    else:
        table = words[:wt * gp.ROW_WORDS].view(wt, gp.ROW_WORDS)
    return idx, table


@pytest.mark.parametrize("case", ["ns0", "ns1", "odd", "one stretch",
                                  "last row", "ragged", "offset view"])
@pytest.mark.parametrize("kernel", ["gather_xor", "gather_xor_chains"])
def test_gather_kernels_at_their_edges(cuda_device, kernel, case):
    """Both entry points at every unroll, bit-exact against the plain
    version; one launch a call (none for NS = 0)."""
    from galah_tpu_torch.ops import gather_probe as gp

    fn = getattr(gp, kernel)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(len(case))
    idx, table = _gather_case(case, gen, cuda_device)
    want = gp.gather_xor_reference(idx, table)
    for unroll in gp.UNROLLS:
        before = fn.launches
        got = fn(idx, table, unroll)
        torch.cuda.synchronize()
        assert fn.launches == before + int(idx.numel() > 0)
        assert got.shape == (1, gp.ROW_WORDS)
        assert torch.equal(got, want), unroll


@pytest.mark.parametrize("kernel", ["gather_xor", "gather_xor_chains"])
def test_gather_index_out_of_range_raises(cuda_device, kernel):
    """An index past the table traps in the kernel and the caller sees a
    CUDA error. In a child process: a trap leaves its CUDA context
    unusable."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import torch\n"
        "from galah_tpu_torch.ops import gather_probe as gp\n"
        "idx = torch.randint(0, 5000, (6000,), dtype=torch.int32, "
        "device='cuda')\n"
        "idx[4321] = 5000\n"
        "table = torch.ones((5000, 8), dtype=torch.int32, device='cuda')\n"
        "try:\n"
        f"    gp.{kernel}(idx, table, 8)\n"
        "    torch.cuda.synchronize()\n"
        "except RuntimeError as e:\n"
        "    print('raised:', str(e).splitlines()[0])\n"
        "else:\n"
        "    print('no error')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=repo, env=env)
    assert "raised:" in done.stdout, done.stdout + done.stderr


def test_kernel_reads_row_slices_of_a_resident_matrix(cuda_device):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    x = _random_words(gen, (300, 96), cuda_device)
    got = packed_intersect_counts(x[128:256], x[256:300])
    want = packed_intersect_counts_reference(x[128:256], x[256:300])
    assert torch.equal(got, want)


def test_wrapper_rejects_mixed_devices(cuda_device):
    a = torch.zeros((4, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="different devices"):
        packed_intersect_counts(a, a.cpu())


def test_screen_on_card_matches_cpu(cuda_device):
    from galah_tpu_torch.ops.prefilter import screen_triangle_packed

    rng = np.random.default_rng(17)
    n, bits = 700, 4096
    ind = (rng.random((n, bits)) < 0.06).astype(np.uint8)
    ind[1] = ind[0]
    ind[650] = ind[649]
    ind[300] = ind[5] & (rng.random(bits) < 0.9)
    sizes = ind.sum(axis=1)
    packed = [np.packbits(r.astype(bool), bitorder="little").view(np.uint32)
              for r in ind]
    args = (packed, sizes, 15, 0.3, bits)
    cpu = screen_triangle_packed(*args, device=CPU, block=128)
    gpu = screen_triangle_packed(*args, device=cuda_device, block=128)
    np.testing.assert_array_equal(gpu.pairs, cpu.pairs)
    np.testing.assert_array_equal(gpu.ani_est, cpu.ani_est)
    assert len(cpu.pairs) >= 3


def _near_duplicate_rows(seed, n, n_near, bits=4096):
    rng = np.random.default_rng(seed)
    base = rng.random(bits) < 0.2
    keep = rng.uniform(0.5, 0.95, size=(n_near, 1))
    ind = rng.random((n, bits)) < 0.05
    ind[:n_near] = base & (rng.random((n_near, bits)) < keep)
    return ind, [np.packbits(r, bitorder="little").view(np.uint32) for r in ind]


@pytest.mark.parametrize("cache_blocks", [True, False])
def test_triangle_screens_on_card_match_cpu(cuda_device, cache_blocks):
    from galah_tpu_torch.ops.popcount_screen import screen_triangle_popcount
    from galah_tpu_torch.ops.prefilter import screen_triangle_packed

    ind, packed = _near_duplicate_rows(2, 300, 150)
    args = (packed, ind.sum(axis=1), 15, 0.69, ind.shape[1])
    for screen, kw in (
        (screen_triangle_packed, dict(block=256, cache_blocks=cache_blocks)),
        (screen_triangle_popcount, dict(block=128)),
    ):
        cpu = screen(*args, device=CPU, **kw)
        gpu = screen(*args, device=cuda_device, **kw)
        np.testing.assert_array_equal(gpu.pairs, cpu.pairs)
        np.testing.assert_array_equal(gpu.ani_est, cpu.ani_est)
        assert len(cpu.pairs) > 1000


@pytest.mark.parametrize("cache_blocks", [True, False])
def test_rectangle_screen_on_card_matches_cpu(cuda_device, cache_blocks):
    from galah_tpu_torch.ops.prefilter import screen_rectangle_packed

    ind, packed = _near_duplicate_rows(4, 500, 250)
    sizes = ind.sum(axis=1)
    q = list(range(150)) + list(range(250, 400))
    r = list(range(150, 250)) + list(range(400, 500))
    args = ([packed[i] for i in q], sizes[q], [packed[i] for i in r],
            sizes[r], 15, 0.69, ind.shape[1])
    cpu = screen_rectangle_packed(*args, device=CPU, block=256,
                                  cache_blocks=cache_blocks)
    gpu = screen_rectangle_packed(*args, device=cuda_device, block=256,
                                  cache_blocks=cache_blocks)
    np.testing.assert_array_equal(gpu.pairs, cpu.pairs)
    np.testing.assert_array_equal(gpu.ani_est, cpu.ani_est)
    assert len(cpu.pairs) > 1000


def test_verify_on_card_matches_cpu(cuda_device, tmp_path):
    from galah_tpu_torch.engines.native import _shrink_bits
    from galah_tpu_torch.ops import fragment_ani as fa
    from galah_tpu_torch.sketch.fracminhash import (
        NativeSketchParams,
        sketch_file_native,
    )
    from galah_tpu_torch.utils.synth import make_families

    small, _ = make_families(str(tmp_path / "s"), 3, 3, genome_length=60_000,
                             seed=3)
    large, _ = make_families(str(tmp_path / "l"), 1, 3, genome_length=100_000,
                             seed=4)
    params = _shrink_bits(NativeSketchParams(), 100_000)
    sk = {p: sketch_file_native(p, params) for p in small + large}
    units = small + large
    pairs = [(a, b) for i, a in enumerate(units) for b in units[i + 1:]]
    cfg = fa.FragmentAniConfig(k=params.k, member_bits=params.member_bits,
                               min_fragment_hashes=params.min_fragment_hashes)
    out = []
    for dev in (CPU, cuda_device):
        eng = fa.FragmentAniEngine(cfg, dev)
        # route the 100 kb genomes (~12.5k hashes) to the grouped kernel
        eng.pair_table.cfg = dataclasses.replace(
            eng.pair_table.cfg, max_flat_hashes=1 << 16
        )
        out.append(eng.bidirectional(pairs, sk))
    cpu, gpu = out
    assert cpu.keys() == gpu.keys()
    for key in cpu:
        assert abs(cpu[key][0] - gpu[key][0]) <= 1e-3, key
        assert cpu[key][1:] == gpu[key][1:], key


def test_screen_issue_never_syncs(cuda_device):
    """A window of screen tiles is issued (K1, containment, cutoff, hit
    extraction and the copy home) under sync debug mode "error": the
    issue step never waits for the card. The drained pairs equal the
    same screen's on the CPU."""
    from galah_tpu_torch.ops import prefilter as pf

    ind, packed = _near_duplicate_rows(6, 3000, 400)
    sizes = ind.sum(axis=1).astype(np.float32)
    bits = ind.shape[1]
    x = torch.from_numpy(np.stack(packed).view(np.int32)).to(cuda_device)
    s = torch.from_numpy(sizes).to(cuda_device)
    warm = pf.IncrementalPackedScreen(8, 15, 0.69, bits, cuda_device)
    warm.set_prebuilt(x[:8].clone(), s[:8].clone())
    warm.finish()
    scr = pf.IncrementalPackedScreen(3000, 15, 0.69, bits, cuda_device)
    assert scr.nblocks * (scr.nblocks + 1) // 2 <= pf.TILE_WINDOW
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        scr.set_prebuilt(x, s)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(scr._queue._pending) == 6
    got = scr.finish()
    want = pf.screen_triangle_packed(packed, sizes, 15, 0.69, bits,
                                     device=CPU)
    np.testing.assert_array_equal(got.pairs, want.pairs)
    np.testing.assert_array_equal(got.ani_est, want.ani_est)
    assert len(want.pairs) > 1000


@pytest.mark.parametrize("window", ["1", "16"])
def test_incremental_screen_on_card_matches_cpu(cuda_device, monkeypatch,
                                                window):
    """Rows fed out of order, device to device and from the host, with
    tiles in flight: the card's pairs and ANI equal the CPU's sequential
    sweep, including the streaming sweep's."""
    from galah_tpu_torch.ops import prefilter as pf

    monkeypatch.setenv("GALAH_TPU_PIPELINE_WINDOW", window)
    ind, packed = _near_duplicate_rows(2, 700, 300)
    sizes = ind.sum(axis=1)
    x = torch.from_numpy(np.stack(packed).view(np.int32)).to(cuda_device)
    scr = pf.IncrementalPackedScreen(700, 15, 0.69, ind.shape[1],
                                     cuda_device, block=128)
    order = np.random.default_rng(1).permutation(700)
    for lo, hi in ((0, 250), (250, 251), (251, 600)):
        idx = order[lo:hi].tolist()
        scr.add_device_rows(idx, x, idx, [float(sizes[i]) for i in idx])
    rest = order[600:].tolist()
    scr.add_host_rows(rest, [packed[i] for i in rest],
                      [float(sizes[i]) for i in rest])
    got = scr.finish()
    args = (packed, sizes, 15, 0.69, ind.shape[1])
    want = pf.screen_triangle_packed(*args, device=CPU, block=128)
    o = np.lexsort((got.pairs[:, 1], got.pairs[:, 0]))
    w = np.lexsort((want.pairs[:, 1], want.pairs[:, 0]))
    np.testing.assert_array_equal(got.pairs[o], want.pairs[w])
    np.testing.assert_array_equal(got.ani_est[o], want.ani_est[w])
    monkeypatch.setattr(pf, "TILE_WINDOW", int(window))
    for cache_blocks in (True, False):
        cpu = pf.screen_triangle_packed(*args, device=CPU, block=128,
                                        cache_blocks=cache_blocks)
        gpu = pf.screen_triangle_packed(*args, device=cuda_device, block=128,
                                        cache_blocks=cache_blocks)
        np.testing.assert_array_equal(gpu.pairs, cpu.pairs)
        np.testing.assert_array_equal(gpu.ani_est, cpu.ani_est)


def test_pipelined_distances_on_card_read_streams_from_the_arena(
        cuda_device, tmp_path, monkeypatch):
    """Device sketching with the phases overlapped on the card, every
    verify stream read from the arena (uploads patched to raise), against
    the CPU's sequential run on host sketches: the same pairs, ANI
    within 1e-3 percentage points."""
    from galah_tpu_torch.engines.native import (
        NativeContext,
        NativePreclusterer,
    )
    from galah_tpu_torch.ops import fragment_ani as fa
    from galah_tpu_torch.ops import pair_table as pt
    from galah_tpu_torch.ops import prefilter as pf
    from galah_tpu_torch.utils import metrics
    from galah_tpu_torch.utils.synth import make_families

    paths, _ = make_families(str(tmp_path / "c"), 4, 4, genome_length=60_000,
                             within_ani=0.97, seed=5)
    monkeypatch.setattr(pf, "DEFAULT_BLOCK", 8)
    for var in ("GALAH_TPU_PIPELINE", "GALAH_TPU_DEVICE_SKETCH",
                "GALAH_TPU_ARENA", "GALAH_TPU_SCREEN"):
        monkeypatch.delenv(var, raising=False)
    out = []
    for dev in (cuda_device, CPU):
        m = metrics.reset()
        pre = NativePreclusterer(90.0, 0.15,
                                 NativeContext(dev, max_genome_length=60_000))
        with monkeypatch.context() as mp:
            if dev.type == "cuda":
                def refuse(*a, **k):
                    raise AssertionError("a fragment stream was uploaded")

                mp.setattr(fa.StreamArena, "_fill_host", refuse)
                mp.setattr(pt, "upload_streams", refuse)
                mp.setattr(fa, "sketch_tensors", refuse)
            out.append(dict(pre.distances(paths).items()))
        assert m.counters.get("phases_overlapped") == (
            1 if dev.type == "cuda" else None)
    gpu, cpu = out
    assert gpu.keys() == cpu.keys() and len(cpu) >= 4 * 6
    for key in cpu:
        assert abs(gpu[key] - cpu[key]) <= 1e-3, key


COUNT_KERNELS = [
    pytest.param("galah_tpu_torch.ops.packed_matmul",
                 "packed_intersect_counts", 4, id="K1"),
    pytest.param("galah_tpu_torch.ops.popcount_screen",
                 "popcount_tile_counts", 32, id="K2"),
]


def _count_kernel(module):
    import importlib

    return importlib.import_module(module)


@pytest.mark.parametrize("module,name,panel", COUNT_KERNELS)
@pytest.mark.parametrize("m,n,w", [
    (1024, 1024, 4097),   # one word past a panel and a split boundary
    (300, 200, 1028),     # one panel past a split boundary, 16-byte rows
    (896, 128, 4096),     # the reference-mode tile: split W across 224+ blocks
    (1, 1000, 4096),      # m = 1
    (129, 1, 33),         # n = 1, one word past K2's panel
])
def test_count_kernels_at_their_edges(cuda_device, module, name, panel, m,
                                      n, w):
    fn = getattr(_count_kernel(module), name)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(m * 7 + n * 3 + w)
    a = _random_words(gen, (m, w), cuda_device)
    b = _random_words(gen, (n, w), cuda_device)
    a[-1] = -1
    b[0] = -1
    before = fn.launches
    got = fn(a, b)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, packed_intersect_counts_reference(a, b))


@pytest.mark.parametrize("module,name,panel", COUNT_KERNELS)
def test_count_kernels_all_ones_at_w8192(cuda_device, module, name, panel):
    fn = getattr(_count_kernel(module), name)
    a = torch.full((3, 8192), -1, dtype=torch.int32, device=cuda_device)
    got = fn(a, a[:2].clone())
    torch.cuda.synchronize()
    assert torch.equal(got, torch.full((3, 2), 32 * 8192, dtype=torch.int32,
                                       device=cuda_device))


@pytest.mark.parametrize("module,name,panel", COUNT_KERNELS)
@pytest.mark.parametrize("rows", [slice(1, 200), slice(3, 50)])
def test_count_kernels_read_unaligned_row_slices(cuda_device, module, name,
                                                 panel, rows):
    """Odd w: a row slice starts off a 16-byte boundary, so the kernel
    stages its words one by one."""
    fn = getattr(_count_kernel(module), name)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(rows.start)
    x = _random_words(gen, (300, 97), cuda_device)
    a, b = x[rows], x[250:]
    assert a.data_ptr() % 16 != 0
    got = fn(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, packed_intersect_counts_reference(a, b))


def test_k1_timing_variants_launch_outside_the_kernel_library(cuda_device):
    """The unpack-only and product-only halves exist only in the library
    built with GALAH_TIMING_VARIANTS; there the full entry still counts
    bit-exact."""
    from galah_tpu_torch.ops._build import load_library
    from galah_tpu_torch.tools import k1_split_timing

    assert not hasattr(load_library(), "galah_packed_popcount_variant")
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(5)
    r = k1_split_timing.split_times(k1_split_timing.load_variant_library(),
                                    130, 9, 1000, 2, gen, cuda_device)
    assert r["blocks"] > 1
    assert all(r[k] > 0 for k in ("ms", "unpack_only_ms", "product_only_ms"))


@pytest.mark.parametrize("module,name,panel", COUNT_KERNELS)
def test_count_kernels_raise_on_a_refused_launch(cuda_device, monkeypatch,
                                                 module, name, panel):
    """A grid the card refuses (z past 65,535) raises; it never returns
    the zeroed output as counts."""
    from galah_tpu_torch.ops.packed_matmul import LaunchPlan

    mod = _count_kernel(module)
    fn = getattr(mod, name)
    splits = 70_000
    plan = LaunchPlan(grid=(1, 1, splits), splits=splits, split_words=panel,
                      ranges=())
    monkeypatch.setattr(mod, "_launch_plan", lambda *args: plan)
    a = torch.full((1, splits * panel), -1, dtype=torch.int32,
                   device=cuda_device)
    before = fn.launches
    with pytest.raises(RuntimeError, match="launch failed: CUDA error"):
        fn(a, a)
    assert fn.launches == before


# ------------------------------------------------------------ K5 sketching

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _seq(rng, n, n_prob=0.0, lower_prob=0.0):
    s = _BASES[rng.integers(0, 4, size=n)].copy()
    if n_prob:
        s[rng.random(n) < n_prob] = ord("N")
    if lower_prob:
        s[rng.random(n) < lower_prob] += 32
    return s.tobytes()


def _sketch_params(kind):
    from galah_tpu_torch.sketch.fracminhash import (
        NativeSketchParams,
        small_genome_params,
    )

    return NativeSketchParams() if kind == "genome" else small_genome_params()


def _k5_units(kind, seed):
    """Ragged units: whole genomes with N runs and lowercase at the
    default widths, or many single contigs at the small-genome ones, with
    units of exactly k, under k, empty, and one of 2,000 short contigs
    (many fragment bins in one thread's run)."""
    rng = np.random.default_rng(seed)
    if kind == "genome":
        units = [[_seq(rng, 300_000, 0.001, 0.2), _seq(rng, 40_000)]
                 for _ in range(5)]
        units.append([_seq(rng, 150) for _ in range(2000)])
    else:
        units = [[_seq(rng, int(n), 0.002)]
                 for n in rng.integers(200, 9000, size=37)]
    units += [[_seq(rng, 15)], [b"A" * 15], [_seq(rng, 9)], [],
              [b"A" * 5000]]
    return units


def _k5_check(batch, scratch=None):
    """K5's products on `batch` against the plain version's, exactly;
    returns them."""
    from galah_tpu_torch.ops import device_sketch as ds

    before = ds.sketch_batch.launches
    got = ds.sketch_batch(batch, scratch)
    torch.cuda.synchronize()
    assert ds.sketch_batch.launches == before + 1
    want = ds.sketch_batch_reference(batch)
    for name, g, w in zip(("member", "pref", "counts", "buckets"), got, want):
        assert g.dtype == w.dtype == torch.int32, name
        assert torch.equal(g, w), name
    return got


@pytest.mark.parametrize("kind", ["genome", "contig"])
def test_k5_matches_plain_version(cuda_device, kind):
    from galah_tpu_torch.ops import device_sketch as ds

    params = _sketch_params(kind)
    units = _k5_units(kind, 3 if kind == "genome" else 4)
    hb = ds.plan_batch([f"u{i}" for i in range(len(units))], units, params)
    batch = ds.upload_batch(hb, params, cuda_device)
    _, _, counts, buckets = _k5_check(batch)
    assert buckets.numel() > 1000
    assert int(counts.sum()) == buckets.numel()
    blocks, _, smem, narrow = ds.k5_launch_shape(batch)
    # Contig widths (2^16 member bits) take the instance with the member
    # bitmap in shared memory.
    assert (blocks, narrow) == (hb.tile_unit.size, kind == "contig")
    assert 0 < smem < 228 << 10


@pytest.mark.parametrize("kind", ["genome", "contig"])
@pytest.mark.parametrize("tile", [1000, 64])
def test_k5_tile_edges_and_repeats(cuda_device, monkeypatch, tile, kind):
    """Tiles cut every `tile` starts (each cut inside a fragment moved
    to its start), so k-mers straddle tile ends and need the halo; a
    homopolymer fragment (every start selects bucket 0: one radix bin of
    equal buckets, or past 1024 of them the bitonic sort) and an all-N one. At the contig widths a multi-tile
    unit's member bits go to device memory, a one-tile unit's through a
    bitmap in shared memory. One scratch serves both batches, the larger
    first."""
    from galah_tpu_torch.ops import device_sketch as ds

    monkeypatch.setattr(ds, "TILE_POSITIONS", tile)
    rng = np.random.default_rng(tile)
    params = _sketch_params(kind)
    units = [[_seq(rng, 50_000, 0.001)], [b"A" * 9000],
             [b"N" * 4000, _seq(rng, 3100)], [_seq(rng, 2999) + b"ACGT"],
             [_seq(rng, 200) for _ in range(30)]]
    scratch = ds.SlotScratch()
    for lo in (0, 2):
        hb = ds.plan_batch([f"u{i}" for i in range(len(units) - lo)],
                           units[lo:], params)
        assert hb.tile_cap <= tile + params.fragment_length - 1
        _, _, counts, _ = _k5_check(ds.upload_batch(hb, params, cuda_device),
                                    scratch)
        if lo == 0:
            assert int(counts[hb.frag_off[1]]) == 1   # the homopolymer
    assert scratch.buffer.numel() >= hb.frag_slot[-1]


@pytest.mark.parametrize("kind", ["genome", "contig"])
def test_device_sketch_on_card_equals_host_sketcher(cuda_device, kind):
    from galah_tpu_torch.ops import device_sketch as ds
    from galah_tpu_torch.sketch.fracminhash import sketch_sequences_native

    params = _sketch_params(kind)
    units = _k5_units(kind, 5)
    names = [f"u{i}" for i in range(len(units))]
    got, dev = ds.device_sketch_batch(names, units, params, cuda_device,
                                      return_device=True)
    assert dev["member_words"].device.type == "cuda"
    for name, seqs, g in zip(names, units, got):
        want = sketch_sequences_native(name, seqs, params)
        assert g.total_len == want.total_len
        for f in ("prefilter_buckets", "member_buckets", "frag_offsets",
                  "frag_buckets"):
            np.testing.assert_array_equal(getattr(g, f), getattr(want, f),
                                          err_msg=f"{name} {f}")


def test_sketch_clock_waits_for_its_last_mark(cuda_device):
    """The sketch's split reads CUDA events; its last mark may still be
    queued behind work when the split is read, and elapsed_time refuses
    an event that has not completed."""
    from galah_tpu_torch.ops.device_sketch import _Clock

    clock = _Clock(cuda_device)
    clock.mark()
    x = torch.ones((4096, 4096), device=cuda_device)
    for _ in range(8):
        x = x @ x / 4096
    clock.mark()
    (seconds,) = clock.seconds()
    assert seconds > 0


@pytest.mark.parametrize("refused", ["threads", "shared memory"])
def test_k5_raises_on_a_refused_launch(cuda_device, monkeypatch, refused):
    """More threads a block than the kernel's bound allows, or a tile
    whose block needs more shared memory than the card has: the launch
    is refused and the wrapper raises, counting no launch."""
    from galah_tpu_torch.ops import device_sketch as ds

    params = _sketch_params("contig")
    if refused == "threads":
        monkeypatch.setattr(ds, "K5_THREADS", 2048)
        seq = b"ACGT" * 500
    else:
        monkeypatch.setattr(ds, "TILE_POSITIONS", 1 << 20)
        seq = b"ACGT" * (1 << 18)
    hb = ds.plan_batch(["u"], [[seq]], params)
    batch = ds.upload_batch(hb, params, cuda_device)
    if refused == "shared memory":
        assert ds.k5_launch_shape(batch)[2] > 228 << 10
    before = ds.sketch_batch.launches
    with pytest.raises(RuntimeError, match="launch failed: CUDA error"):
        ds.sketch_batch(batch)
    assert ds.sketch_batch.launches == before


# ------------------------------------------------------- resume artifacts


def _cli_on_card(tmp_path, tag, inputs, *flags):
    """(exit code, clusters.tsv bytes, metrics counters) of one `cluster`
    run of the port's CLI on the card."""
    import json

    from galah_tpu_torch.cli.main import main

    tsv, mjson = tmp_path / f"{tag}.tsv", tmp_path / f"{tag}.json"
    rc = main(["cluster", *inputs, "--ani", "95", "-q",
               "--output-cluster-definition", str(tsv),
               "--metrics-json", str(mjson), *flags])
    if rc:
        return rc, None, {}
    return rc, tsv.read_bytes(), json.loads(mjson.read_text())["counters"]


def _card_corpus(tmp_path, monkeypatch):
    from galah_tpu_torch.ops import prefilter as pf
    from galah_tpu_torch.utils.synth import make_families

    paths, _ = make_families(str(tmp_path / "c"), 4, 4, genome_length=60_000,
                             within_ani=0.98, seed=5)
    monkeypatch.setattr(pf, "DEFAULT_BLOCK", 4)  # 4 row blocks, 10 tiles
    for var in ("GALAH_TPU_PLATFORM", "GALAH_TPU_PIPELINE", "GALAH_TPU_SCREEN",
                "GALAH_TPU_DEVICE_SKETCH", "GALAH_TPU_ARENA"):
        monkeypatch.delenv(var, raising=False)
    return ["-f", *paths]


def test_kill_and_resume_on_card(cuda_device, tmp_path, monkeypatch):
    """The overlapped phases on the card with --sweep-checkpoint: a crash
    after 5 of 10 K1 launches exits 1 with the drained tiles logged; the
    resume launches K1 for the other tiles only and gives the clusters of
    a run without a checkpoint; a complete log launches K1 no more."""
    import json

    from galah_tpu_torch.ops import prefilter as pf
    from galah_tpu_torch.ops.sweep_checkpoint import SweepCheckpoint

    inputs = _card_corpus(tmp_path, monkeypatch)
    rc, want, counters = _cli_on_card(tmp_path, "ref", inputs)
    assert rc == 0 and counters["phases_overlapped"] == 1
    assert counters["screen_tiles"] == 10
    log = tmp_path / "sweep.ckpt"
    real = pf.packed_intersect_counts
    calls = {"n": 0}

    def crashing(a, b, **kw):
        calls["n"] += 1
        if calls["n"] > 5:
            raise RuntimeError("injected crash mid-sweep")
        return real(a, b, **kw)

    with monkeypatch.context() as mp:
        mp.setattr(pf, "packed_intersect_counts", crashing)
        rc, _, _ = _cli_on_card(tmp_path, "killed", inputs,
                                "--sweep-checkpoint", str(log))
    assert rc == 1
    with open(log, "rb") as f:
        f.read(len(b"GTSWEEP1\n"))
        (n,) = np.frombuffer(f.read(4), np.int32)
        fp = json.loads(f.read(int(n)))
    logged = len(SweepCheckpoint(str(log), fp))
    assert 0 < logged <= 5
    for tag, launches in (("resumed", 10 - logged), ("replayed", 0)):
        before = real.launches
        rc, got, counters = _cli_on_card(tmp_path, tag, inputs,
                                         "--sweep-checkpoint", str(log))
        assert rc == 0 and got == want
        assert real.launches - before == launches
        assert counters.get("screen_tiles", 0) == launches


@pytest.mark.parametrize("mode", ["genomes", "contigs"])
def test_warm_sketch_directory_on_card(cuda_device, tmp_path, monkeypatch,
                                       mode):
    """A second run over a warm --sketch-directory launches K5 no more;
    its screen rows and verify streams are uploaded from the host, and
    its clusters are the first run's."""
    from galah_tpu_torch.ops.device_sketch import sketch_batch
    from galah_tpu_torch.utils.synth import make_contig_corpus

    inputs = _card_corpus(tmp_path, monkeypatch)
    n = 16
    if mode == "contigs":
        path = str(tmp_path / "contigs.fna")
        make_contig_corpus(path, 30, 5, contig_length=5_000, seed=21)
        inputs, n = ["-f", path, "--cluster-contigs", "--small-contigs"], 150
    flags = ("--sketch-directory", str(tmp_path / "sketches"))
    before = sketch_batch.launches
    rc, first, c1 = _cli_on_card(tmp_path, "first", inputs, *flags)
    assert rc == 0 and sketch_batch.launches > before
    assert c1["screen_rows_device_born"] == n
    before = sketch_batch.launches
    rc, second, c2 = _cli_on_card(tmp_path, "second", inputs, *flags)
    assert rc == 0 and second == first
    assert sketch_batch.launches == before
    assert c2["screen_rows_host_uploaded"] == n
    assert c2["screen_host_row_bytes"] > 0
    assert c2["verify_streams_uploaded"] > 0


@pytest.mark.parametrize("rowshard", ["0", "1"])
def test_sharded_triangle_two_shards_on_one_card(cuda_device, monkeypatch,
                                                 rowshard):
    """Two shards that share the card (told apart by index) give the
    single-device sweep's pairs and ANI bit for bit, in its order for
    the replicated sweep; each shard launches K1 for its own tiles
    (GALAH_TPU_ROWSHARD=1: the row-sharded sweep, whose blocks of 256
    rows hold no tile past its cap here)."""
    from galah_tpu_torch.ops.prefilter import screen_triangle_packed
    from galah_tpu_torch.parallel.distance import (
        sharded_screen_triangle_packed,
    )

    ind, packed = _near_duplicate_rows(4, 1500, 60)
    perm = np.random.default_rng(5).permutation(len(packed))
    ind, packed = ind[perm], [packed[i] for i in perm]
    args = (packed, ind.sum(axis=1), 15, 0.69, ind.shape[1])
    single = screen_triangle_packed(*args, device=cuda_device, block=256)
    monkeypatch.setenv("GALAH_TPU_ROWSHARD", rowshard)
    packed_intersect_counts.per_shard.clear()
    got = sharded_screen_triangle_packed(
        *args, devices=[cuda_device, cuda_device], block=256)
    tiles = 6 * 7 // 2
    per = packed_intersect_counts.per_shard
    assert sorted(per) == [0, 1] and per[0] + per[1] == tiles
    if rowshard == "1":
        got, single = (_lexsorted(r) for r in (got, single))
    np.testing.assert_array_equal(got.pairs, single.pairs)
    np.testing.assert_array_equal(got.ani_est.view(np.int32),
                                  single.ani_est.view(np.int32))
    assert len(single.pairs) > 700


def _lexsorted(res):
    o = np.lexsort((res.pairs[:, 1], res.pairs[:, 0]))
    return type(res)(res.pairs[o], res.ani_est[o])


# ------------------------------------------- indicator screen and dtypes


def _exact_counts(x, y):
    """Intersection counts of two uint8 0/1 blocks on the card, int64."""
    return x.to(torch.float64) @ y.to(torch.float64).t()


@pytest.mark.parametrize("m,n,bits", [
    (1024, 672, 1 << 15),   # the contig path's edge tile
    (896, 128, 1 << 17),    # the reference-mode tile
    (5, 1024, 1 << 18),     # a last row block of 5 rows
    (1024, 5, 1 << 18),     # and as the column block
])
def test_int8_product_pads_for_int_mm(cuda_device, m, n, bits):
    """The int8 route (torch._int_mm on the bytes as int8) at shapes
    _int_mm refuses unpadded: exact counts, cut back to (m, n)."""
    from galah_tpu_torch.ops.prefilter import _indicator_counts

    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(m + n)
    x = (torch.rand((m, bits), generator=gen, device=cuda_device)
         < 0.05).to(torch.uint8)
    y = (torch.rand((n, bits), generator=gen, device=cuda_device)
         < 0.05).to(torch.uint8)
    y[0] = x[0]
    got = _indicator_counts("int8")(x, y)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert torch.equal(got.to(torch.float64), _exact_counts(x, y))


def test_bf16_product_counts_are_exact(cuda_device):
    """The bfloat16 route keeps float32 sums: counts above 2^8 and 2^16
    (up to 2^18, a full row) come out exact."""
    from galah_tpu_torch.ops.prefilter import _indicator_counts

    bits = 1 << 18
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    x = (torch.rand((64, bits), generator=gen, device=cuda_device)
         < 0.6).to(torch.uint8)
    x[0] = 1
    x[1, :300] = 1
    x[1, 300:] = 0
    want = _exact_counts(x, x[:16])
    assert want.max() == bits and want[1, 1] == 300
    assert (want > 1 << 16).sum() > 900
    for dtype in ("bf16", "f32", "int8x"):
        got = _indicator_counts(dtype)(x, x[:16])
        assert torch.equal(got.to(torch.float64), want), dtype


@pytest.mark.parametrize("dtype", ["int8", "bf16", "f32"])
def test_indicator_screens_on_card_match_cpu(cuda_device, monkeypatch, dtype):
    """screen_triangle (cached and streamed) and screen_rectangle on the
    card give the CPU's pairs and ANI bit for bit, in order, under each
    dtype."""
    from galah_tpu_torch.ops.prefilter import screen_rectangle, screen_triangle

    monkeypatch.setenv("GALAH_TPU_SCREEN_DTYPE", dtype)
    ind, _ = _near_duplicate_rows(8, 700, 200)
    ind = ind.astype(np.uint8)
    rows, sizes = list(ind), ind.sum(axis=1)
    for cache in (True, False):
        got = screen_triangle(rows, sizes, 15, 0.69, cuda_device, block=256,
                              cache_blocks=cache)
        want = screen_triangle(rows, sizes, 15, 0.69, CPU, block=256,
                               cache_blocks=cache)
        np.testing.assert_array_equal(got.pairs, want.pairs)
        np.testing.assert_array_equal(got.ani_est.view(np.int32),
                                      want.ani_est.view(np.int32))
    got = screen_rectangle(rows[:500], sizes[:500], rows[100:300],
                           sizes[100:300], 15, 0.69, cuda_device, block=256)
    want = screen_rectangle(rows[:500], sizes[:500], rows[100:300],
                            sizes[100:300], 15, 0.69, CPU, block=256)
    np.testing.assert_array_equal(got.pairs, want.pairs)
    np.testing.assert_array_equal(got.ani_est.view(np.int32),
                                  want.ani_est.view(np.int32))
    assert len(want.pairs) > 1000


def test_bt_matches_word_on_a_large_stream(cuda_device):
    """The grouped verify's two gathers on a 1.25M-hash stream (sorted
    buckets within 3,000 fragments) against 32 references of 2^22 bits,
    the first 16 holding 90% of the stream's buckets: bit-identical ANI
    and AF."""
    from galah_tpu_torch.ops import fragment_ani as fa
    from galah_tpu_torch.utils.convert import words_to_torch

    bits, r, n, frags = 1 << 22, 32, 1_250_000, 3_000
    rng = np.random.default_rng(8)
    offsets = np.linspace(0, n, frags + 1).round().astype(np.int32)
    buckets = rng.integers(0, bits, n).astype(np.int32)
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        buckets[lo:hi].sort()
    bm = (rng.integers(0, 1 << 32, (r, bits // 32), dtype=np.uint32)
          & rng.integers(0, 1 << 32, (r, bits // 32), dtype=np.uint32))
    for i in range(16):
        sel = buckets[rng.random(n) < 0.9]
        np.bitwise_or.at(bm[i], sel >> 5,
                         np.uint32(1) << (sel & 31).astype(np.uint32))
    bitmaps = words_to_torch(bm).to(cuda_device)
    popc = torch.from_numpy(np.unpackbits(bm.view(np.uint8), axis=1).sum(
        axis=1).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy(buckets).to(cuda_device)
    o = torch.from_numpy(offsets).to(cuda_device)
    kw = dict(bits=bits, k=15, min_hashes=8,
              min_ident=fa.FragmentAniConfig().min_fragment_identity)
    word = fa._forward_kernel(bitmaps, torch.arange(r, device=cuda_device),
                              popc, b, o, **kw)
    bt = fa._forward_kernel_bt(fa._bit_transpose_table(bitmaps), popc, b, o,
                               **kw)
    for w, t in zip(word, bt):
        assert torch.equal(w, t)
    assert (word[1][:16] > 0.9).all() and (word[1][16:] < 0.2).all()
