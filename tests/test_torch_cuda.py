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
from galah_tpu_torch.utils.synth import epilogue_block_edge_cases

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
    the first 16 holding 90% of the stream's buckets: the plain word
    version and bt bit-identical in ANI and AF; K8 with the same AF and
    ANI within 1e-4 percentage points."""
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
    rows = torch.arange(r, device=cuda_device)
    word = fa._forward_plain(bitmaps, rows, popc, b, o, **kw)
    bt = fa._forward_kernel_bt(fa._bit_transpose_table(bitmaps), popc, b, o,
                               **kw)
    for w, t in zip(word, bt):
        assert torch.equal(w, t)
    assert (word[1][:16] > 0.9).all() and (word[1][16:] < 0.2).all()
    k8 = fa._forward_kernel(bitmaps, rows, popc, b, o, **kw)
    assert torch.equal(k8[1], word[1])
    assert float((k8[0] - word[0]).abs().max()) <= 1e-4


# ------------------------------------------------ K6 the screen epilogue


def _epilogue_cases(m, n, w, device):
    """(name, counts, a, b, cutoff, cap, diag) at one tile shape: K1's
    counts of random rows with planted copies (also as a diagonal tile
    when square) under a screen-like cutoff, all-zero counts (no hit),
    cutoff 0 (every pair a hit, past the cap and past a cap of 7), and
    counts drawn up to min(a, b) with the cutoff set exactly to one of
    their containment values."""
    from galah_tpu_torch.ops.popcount_screen import _popc32
    from galah_tpu_torch.ops.screen_epilogue import screen_epilogue_reference

    gen = torch.Generator(device=device)
    gen.manual_seed(m * 7 + n * 3 + w)
    x = (torch.rand((m, w * 32), generator=gen, device=device) < 0.06)
    y = (torch.rand((n, w * 32), generator=gen, device=device) < 0.06)
    k = min(m, n) // 4
    y[:k] = x[m - k:]                   # copies across the tile
    x[:k // 2] = x[k // 2:k // 2 * 2]   # and inside x
    weights = (1 << torch.arange(32, device=device, dtype=torch.int64))

    def pack(ind):
        words = (ind.view(ind.shape[0], w, 32).to(torch.int64)
                 * weights).sum(dim=2)
        return torch.where(words >= 1 << 31, words - (1 << 32),
                           words).to(torch.int32)

    xp, yp = pack(x), pack(y)
    sx, sy = (_popc32(r).sum(dim=1).to(torch.float32) for r in (xp, yp))
    cap = 16384
    k1 = packed_intersect_counts(xp, yp)
    cases = [("k1", k1, sx, sy, 0.3, cap, False),
             ("none", torch.zeros_like(k1), sx, sy, 0.3, cap, False),
             ("over-cap", k1, sx, sy, 0.0, cap, False),
             ("over-small-cap", k1, sx, sy, 0.0, 7, False)]
    if m == n:
        cases.append(("k1-diagonal", packed_intersect_counts(xp, xp), sx,
                      sx, 0.3, cap, True))
        cases.append(("diagonal-cutoff-0", packed_intersect_counts(xp, xp),
                      sx, sx, 0.0, 7, True))
    hi = torch.minimum(sx[:, None], sy[None, :]).to(torch.int64) + 1
    drawn = (torch.rand((m, n), generator=gen, device=device) * hi).to(
        torch.int32)
    cont, _ = screen_epilogue_reference(
        drawn, sx, sy, bits_f=float(w * 32), min_cont_f=2.0, diag=False,
        cap=cap, streaming=False)
    knife = float(cont.reshape(-1).sort().values[-(m * n + 3) // 4])
    cases.append(("knife", drawn, sx, sy, knife, cap, False))
    return cases + epilogue_block_edge_cases(m, n, cap, device)


@pytest.mark.parametrize("m,n,w", [
    (1024, 1024, 1024),   # the contig path's tile
    (1024, 672, 1024),    # its edge tile
    (896, 128, 4096),     # the reference-mode tile
    (300, 257, 16),       # nothing a multiple of a block edge
    (1, 1, 8),
    (1024, 1021, 1024),   # n not a multiple of 4: K6's scalar path
    (1000, 777, 1024),    # K1's ragged shape, a screen's 2^k-bit rows
    (1021, 1024, 64),     # m not a multiple of K6's rows a block
])
def test_screen_epilogue_matches_plain_version(cuda_device, m, n, w):
    """K6 against its plain version on every bit of the containment and
    every word of the hit buffer, int32 and float32 counts, streaming
    and not, at K6's block edges too (epilogue_block_edge_cases)."""
    from galah_tpu_torch.ops.screen_epilogue import (
        screen_epilogue,
        screen_epilogue_reference,
    )

    seen = set()
    for name, counts, a, b, cut, cap, diag in _epilogue_cases(
            m, n, w, cuda_device):
        for dtype in (torch.int32, torch.float32):
            for streaming in (False, True):
                kw = dict(bits_f=float(w * 32), min_cont_f=cut, diag=diag,
                          cap=cap, streaming=streaming)
                c = counts.to(dtype)
                before = screen_epilogue.launches
                got = screen_epilogue(c, a, b, **kw)
                want = screen_epilogue_reference(c, a, b, **kw)
                torch.cuda.synchronize()
                assert screen_epilogue.launches == before + 1
                assert torch.equal(got[0].view(torch.int32),
                                   want[0].view(torch.int32)), name
                assert torch.equal(got[1], want[1]), name
                seen.add((name, int(want[1][0]) > cap, int(want[1][0]) > 0))
    if m * n > 7:
        assert ("none", False, False) in seen
        assert ("over-small-cap", True, True) in seen
    if m >= 1000:
        assert ("stage-overflow", False, True) in seen
        assert ("cap-mid-block", True, True) in seen


def _hit_case(device, m=1024, n=1024, w=64):
    """(counts, a, b, kw) of a diagonal tile with hits (the "k1-diagonal"
    case of _epilogue_cases), streaming."""
    name, counts, a, b, cut, cap, diag = next(
        c for c in _epilogue_cases(m, n, w, device) if c[0] == "k1-diagonal")
    return counts, a, b, dict(bits_f=float(w * 32), min_cont_f=cut,
                              diag=diag, cap=cap, streaming=True)


def test_screen_epilogue_back_to_back_on_two_streams(cuda_device):
    """Launches issued in turns on two streams (each with its own
    scratch), each output against the plain version."""
    from galah_tpu_torch.ops.screen_epilogue import (
        screen_epilogue,
        screen_epilogue_reference,
    )

    counts, a, b, kw = _hit_case(cuda_device)
    other = counts.clone()
    other[::3] = 0
    want = [screen_epilogue_reference(c, a, b, **kw) for c in (counts, other)]
    streams = (torch.cuda.Stream(cuda_device), torch.cuda.Stream(cuda_device))
    torch.cuda.synchronize()
    got = []
    for call in range(16):
        with torch.cuda.stream(streams[call % 2]):
            got.append(screen_epilogue((counts, other)[call // 2 % 2], a, b,
                                       **kw))
    torch.cuda.synchronize()
    for call, (cont, hits) in enumerate(got):
        w_cont, w_hits = want[call // 2 % 2]
        assert torch.equal(cont.view(torch.int32), w_cont.view(torch.int32))
        assert torch.equal(hits, w_hits), call
    assert int(want[0][1][0]) > 0 and not torch.equal(want[0][1], want[1][1])


def test_screen_epilogue_in_a_cuda_graph(cuda_device):
    """50 launches captured in a CUDA graph and replayed, the input
    changed in place between replays: the first and the last launch of
    each replay equal the plain version, so each launch left its scratch
    ready for the next."""
    from galah_tpu_torch.ops.screen_epilogue import (
        screen_epilogue,
        screen_epilogue_reference,
    )

    counts, a, b, kw = _hit_case(cuda_device)
    inputs = (counts.clone(), counts.clone())
    inputs[1][1::2] = 0
    static = inputs[0].clone()
    screen_epilogue(static, a, b, **kw)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = [screen_epilogue(static, a, b, **kw) for _ in range(50)]
    for replay in range(4):
        static.copy_(inputs[replay % 2])
        g.replay()
        torch.cuda.synchronize()
        want = screen_epilogue_reference(static, a, b, **kw)
        for cont, hits in (outs[0], outs[-1]):
            assert torch.equal(cont.view(torch.int32),
                               want[0].view(torch.int32)), replay
            assert torch.equal(hits, want[1]), replay
        assert int(want[1][0]) > 0


@pytest.mark.parametrize("m,n", [(0, 5), (5, 0)])
def test_screen_epilogue_on_an_empty_tile(cuda_device, m, n):
    from galah_tpu_torch.ops.screen_epilogue import screen_epilogue

    counts = torch.zeros((m, n), dtype=torch.int32, device=cuda_device)
    ones = torch.ones(max(m, n), device=cuda_device)
    cont, hits = screen_epilogue(counts, ones[:m], ones[:n], bits_f=64.0,
                                 min_cont_f=0.0, diag=False, cap=4,
                                 streaming=True)
    assert cont.shape == (m, n)
    assert torch.equal(hits.cpu(), torch.zeros(10, dtype=torch.int32))


def test_screen_epilogue_counts_its_launches_by_shard(cuda_device):
    from galah_tpu_torch.ops.screen_epilogue import screen_epilogue

    counts = torch.zeros((8, 8), dtype=torch.int32, device=cuda_device)
    s = torch.ones(8, device=cuda_device)
    before = screen_epilogue.launches
    shard0, shard1 = (screen_epilogue.per_shard[i] for i in (0, 1))
    for shard in (0, 1, 1, None):
        screen_epilogue(counts, s, s, bits_f=64.0, min_cont_f=0.5, diag=True,
                        cap=4, streaming=False, shard=shard)
    assert screen_epilogue.launches == before + 4
    assert screen_epilogue.per_shard[0] == shard0 + 1
    assert screen_epilogue.per_shard[1] == shard1 + 2


def test_screen_epilogue_raises_on_a_failed_launch(cuda_device, monkeypatch):
    """A CUDA error from K6's entry raises with its code and counts no
    launch: there is no fallback to the plain version."""
    from types import SimpleNamespace

    from galah_tpu_torch.ops import _build
    from galah_tpu_torch.ops.screen_epilogue import screen_epilogue

    monkeypatch.setattr(_build, "load_library", lambda: SimpleNamespace(
        galah_screen_epilogue=lambda *args: 98))
    counts = torch.zeros((8, 8), dtype=torch.int32, device=cuda_device)
    s = torch.ones(8, device=cuda_device)
    before = screen_epilogue.launches
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        screen_epilogue(counts, s, s, bits_f=64.0, min_cont_f=0.5,
                        diag=False, cap=4, streaming=False)
    assert screen_epilogue.launches == before


def test_screen_issue_runs_k1_k6_and_the_copy_only(cuda_device):
    """Under torch.profiler one packed tile's issue step runs K1 (and
    the zeroing of its output when W is split), K6's one kernel and the
    copy home, nothing else on the card."""
    from torch.profiler import ProfilerActivity, profile

    from galah_tpu_torch.ops import prefilter as pf

    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(12)
    x = _random_words(gen, (1024, 1024), cuda_device)
    s = torch.full((1024,), 16384.0, device=cuda_device)
    queue = pf._TileQueue(1 << 15, 0.5, 1024, 15, streaming=False)
    queue.issue(x, x, s, s, diag=True, row0=0, col0=0)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        queue.issue(x, x, s, s, diag=False, row0=0, col0=1024)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [n for n in names if "emcpy" not in n]
    assert sum("screen_epilogue_tile" in n for n in kernels) == 1, names
    assert any("packed_popcount" in n for n in kernels), names
    assert all(any(k in n for k in ("screen_epilogue_tile",
                                    "packed_popcount", "fill", "Fill"))
               for n in kernels), names
    assert len(kernels) <= 3 and len(names) - len(kernels) == 1, names
    queue.result()


@pytest.mark.parametrize("dtype", ["int8", "f32"])
def test_indicator_screen_issue_never_syncs(cuda_device, monkeypatch, dtype):
    """The indicator screen's tiles (the product, then K6 on its float32
    counts, then the copy home) are issued under sync debug mode
    "error"; the drained pairs equal the CPU's."""
    from galah_tpu_torch.ops import prefilter as pf

    monkeypatch.setenv("GALAH_TPU_SCREEN_DTYPE", dtype)
    ind, _ = _near_duplicate_rows(9, 600, 200)
    ind = ind.astype(np.uint8)
    sizes = torch.from_numpy(ind.sum(axis=1).astype(np.float32))
    rows = torch.from_numpy(ind)
    counts = pf._indicator_counts(dtype)

    def screen(device):
        q = pf._TileQueue(ind.shape[1], 0.69, 256, 15, streaming=True,
                          counts=counts)
        x, s = rows.to(device), sizes.to(device)
        q.issue(x[:8], x[:8], s[:8], s[:8], diag=True, row0=0, col0=0)
        q.result()
        q.pairs.clear()
        q.anis.clear()
        torch.cuda.synchronize()
        if device.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            for bi in range(3):
                for bj in range(bi, 3):
                    q.issue(x[bi * 256:(bi + 1) * 256],
                            x[bj * 256:(bj + 1) * 256],
                            s[bi * 256:(bi + 1) * 256],
                            s[bj * 256:(bj + 1) * 256], diag=bi == bj,
                            row0=bi * 256, col0=bj * 256)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert len(q._pending) == 6
        return q.result()

    got, want = screen(cuda_device), screen(CPU)
    np.testing.assert_array_equal(got.pairs, want.pairs)
    np.testing.assert_array_equal(got.ani_est.view(np.int32),
                                  want.ani_est.view(np.int32))
    assert len(want.pairs) > 1000


# ------------------------------------------ K7 and K8, the verify kernels


def _one_pair(device):
    """A pair-table batch of one pair, one fragment of 300 hashes."""
    from galah_tpu_torch.utils.synth import pair_table_args, pair_table_batch

    return pair_table_args(pair_table_batch(
        1, n_src=1, frags=1, sizes=(300,), g=1, pairs=[(0, 0)],
        bits=1 << 16), device)


_VERIFY_KW = dict(k=15, min_hashes=8, min_ident=0.8)


def _slice_edges(rng, bits, size):
    """Three sorted fragments of `size` buckets below `bits` for the
    slices of K7's and K8's launch plan: the first holds each slice's
    first two and last two buckets (hashes on both sides of every slice
    boundary, and of the row's ends), the second lies wholly in the
    second slice (or the first, for a row of one), the third wholly in
    the last."""
    from galah_tpu_torch.ops.pair_table import verify_launch_plan

    plan = verify_launch_plan(bits)
    sb = plan.slice_bits
    edges = np.unique(np.concatenate(
        [[k * sb - 2, k * sb - 1, k * sb, k * sb + 1]
         for k in range(plan.cluster + 1)]).clip(0, bits - 1))
    fill = rng.integers(0, bits, size - len(edges))
    inner = min(1, plan.cluster - 1) * sb
    return [np.sort(np.concatenate([edges, fill])).astype(np.int32),
            np.sort(rng.integers(inner, inner + sb, size)).astype(np.int32),
            np.sort(rng.integers(bits - sb, bits, size)).astype(np.int32)]


def _edge_pair_batch(seed, bits):
    """A pair_table_batch of 2 sources and 2 targets whose first
    source's first three fragments are _slice_edges, with the targets'
    bits set on both sides of each boundary (popcounts recounted)."""
    from galah_tpu_torch.utils.synth import pair_table_batch

    b = pair_table_batch(seed, n_src=2, frags=6, sizes=(40,), g=2,
                         pairs=[(0, 0), (0, 1), (1, 0), (1, 1)], bits=bits)
    rng = np.random.default_rng(seed)
    off = b["ufrag_offsets"]
    for f, frag in enumerate(_slice_edges(rng, bits, 40)):
        b["ustream"][off[f]:off[f + 1]] = frag
    row_of = dict(zip(b["pref"].tolist(), b["prow"].tolist()))
    for t, row in row_of.items():
        mine = b["ustream"][off[0]:off[3]][t::2].astype(np.int64)
        np.bitwise_or.at(b["pool"][row], mine >> 5,
                         (1 << (mine & 31)).astype(np.uint32))
        b["popcounts"][t] = np.unpackbits(b["pool"][row].view(np.uint8)).sum()
    return b


@pytest.mark.parametrize("case", [
    # (n_src, frags, sizes, g, pairs, bits, lead)
    (4, 40, (100, 300, 400), 4, [(s, t) for s in range(4) for t in range(4)],
     1 << 22, 0),
    (6, 9, (0, 1, 7, 8, 9, 33, 700), 3,
     [(0, 0), (0, 2), (3, 1), (5, 0), (1, 1), (2, 2), (5, 2), (4, 1)],
     1 << 20, 999),
    (1, 25, (40, 90), 5, [(0, t) for t in range(5)], 1 << 20, 3),
    (1, 1, (300,), 1, [(0, 0)], 1 << 16, 17),
    (300, 2, (30, 330, 700), 64, [(s, (s * 7 + j) % 64) for s in range(300)
                                  for j in range(3)], 1 << 18, 5),
    (3, 30, (20, 200), 3, [(s, t) for s in range(3) for t in range(3)],
     1 << 17, 1),
    (3, 40, (100, 400, 1100), 3, [(s, t) for s in range(3) for t in range(3)],
     1 << 21, 2),
    (512, 1, (5, 20, 60), 8, [(s, (s + j) % 8) for s in range(512)
                              for j in range(8)], 1 << 22, 4),
    (64, 2, (8, 30), 64, [(s, t) for s in range(64) for t in range(64)],
     1 << 16, 9),
    (5, 4, (0, 9, 500, 1300), 7, [(s % 5, (s * 3) % 7) for s in range(23)],
     1 << 16, 11),
    "edges 2^20", "edges 2^21", "edges 2^22",
], ids=["random", "ragged", "shared-source", "single-fragment", "contig-like",
        "width-2^17", "width-2^21", "max-pairs-2^22", "max-pairs-2^16",
        "alternating-sources-2^16", "slice-edges-2^20", "slice-edges-2^21",
        "slice-edges-2^22"])
def test_k7_matches_plain_version(cuda_device, case):
    """K7 against _pair_table_plain on the card, bit for bit, at every
    row width the widen rule picks (2^16 to 2^22): where a case has two
    targets or more, the last has every bit but one set; the edge cases
    put hashes on both sides of every slice boundary and fragments wholly
    in one slice; two batches hold max_pairs pairs; one batch alternates
    sources between neighbouring pairs."""
    from galah_tpu_torch.ops import pair_table as pt
    from galah_tpu_torch.utils.synth import pair_table_args, pair_table_batch

    if isinstance(case, str):
        bits = 1 << int(case.split("^")[1])
        pairs = [0] * 4
        args = pair_table_args(_edge_pair_batch(bits, bits), cuda_device)
    else:
        n_src, frags, sizes, g, pairs, bits, lead = case
        args = pair_table_args(pair_table_batch(
            len(pairs), n_src=n_src, frags=frags, sizes=sizes, g=g,
            pairs=pairs, bits=bits, lead=lead, full=g > 1), cuda_device)
    before = pt._pair_table_kernel.launches
    got = pt._pair_table_kernel(*args, bits=bits, **_VERIFY_KW)
    want = pt._pair_table_plain(*args, bits=bits, **_VERIFY_KW)
    torch.cuda.synchronize()
    assert pt._pair_table_kernel.launches == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert len(pairs) == 1 or (want[1] > 0.3).any()


def test_k7_on_an_empty_batch(cuda_device):
    from galah_tpu_torch.ops import pair_table as pt

    z = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    e = z[:0]
    ani, af = pt._pair_table_kernel(
        z, z, torch.zeros((1, 8), dtype=torch.int32, device=cuda_device),
        z.float(), e, z, e, z, e.long(), e.long(), 0, 0, bits=256,
        **_VERIFY_KW)
    assert ani.shape == af.shape == (0,)


def _popcounts(words):
    """float32 popcount of each row of int32 words."""
    x = words.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum(dim=1).float()


def _grouped_inputs(seed, refs, n, frags, bits, device, edges=False):
    """A query of n buckets, sorted within each of `frags` fragments (a
    few under min_hashes; with `edges` the first three are _slice_edges
    of 40), against `refs` rows of a pool in random order: random bits
    of density 1/8 and, in the first half of the rows, 60-100% of the
    query's buckets. Made with numpy and a torch generator from `seed`,
    the rows on the card."""
    rng = np.random.default_rng(seed)
    lead = [40, 80, 120] if edges else []
    cuts = np.sort(rng.integers(lead[-1] if edges else 0, n,
                                frags - 1 - len(lead)))
    offsets = np.concatenate([[0], lead, cuts, [n]]).astype(np.int32)
    buckets = rng.integers(0, bits, n).astype(np.int32)
    if edges:
        buckets[:120] = np.concatenate(_slice_edges(rng, bits, 40))
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        buckets[lo:hi].sort()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    words = [_random_words(gen, (refs, bits // 32), device) for _ in range(3)]
    words = words[0] & words[1] & words[2]
    b = torch.from_numpy(buckets).to(device).long()
    for r in range(refs // 2):
        keep = torch.from_numpy(rng.random(n) < rng.uniform(0.6, 1.0))
        held = torch.unique(b[keep.to(device)])
        words[r] |= torch.zeros(bits // 32, dtype=torch.int64,
                                device=device).index_add_(
            0, held >> 5, torch.ones_like(held) << (held & 31)).to(
                torch.int32)
    rows = torch.from_numpy(rng.permutation(refs + 5)[:refs]).to(device)
    pool = torch.zeros((refs + 5, bits // 32), dtype=torch.int32,
                       device=device)
    pool[rows] = words
    return [pool, rows, _popcounts(words), b.to(torch.int32),
            torch.from_numpy(offsets).to(device)]


@pytest.mark.parametrize("refs,n,frags,bits,edges", [
    (8, 1_250_000, 3_333, 1 << 22, False),
    (128, 200_000, 600, 1 << 22, False),
    (3, 5_000, 40, 1 << 16, False),
    (1, 300, 1, 1 << 16, False),
    (1, 1_250_000, 3_333, 1 << 22, False),
    (128, 1_250_000, 3_333, 1 << 22, False),
    (1024, 200_000, 600, 1 << 22, False),
    (8, 50_000, 150, 1 << 17, False),
    (8, 100_000, 300, 1 << 20, False),
    (8, 200_000, 600, 1 << 21, False),
    (4, 20_000, 60, 1 << 20, True),
    (4, 20_000, 60, 1 << 21, True),
    (4, 20_000, 60, 1 << 22, True),
])
def test_k8_matches_plain_version(cuda_device, refs, n, frags, bits, edges):
    """K8 against _forward_plain on the card: AF equal, ANI within 1e-4
    percentage points (its identity sum runs in another order than
    torch.sum), and K8 equal to itself over two calls; at every row
    width the widen rule picks, R = 1 to 1,024 at 2^22 bits, and
    fragments on both sides of every slice boundary and wholly in one
    slice."""
    from galah_tpu_torch.ops import fragment_ani as fa

    args = _grouped_inputs(refs + n, refs, n, frags, bits, cuda_device,
                           edges)
    before = fa._forward_kernel.launches
    got = fa._forward_kernel(*args, bits=bits, **_VERIFY_KW)
    again = fa._forward_kernel(*args, bits=bits, **_VERIFY_KW)
    want = fa._forward_plain(*args, bits=bits, **_VERIFY_KW)
    torch.cuda.synchronize()
    assert fa._forward_kernel.launches == before + 2
    assert torch.equal(got[1], want[1])
    assert float((got[0] - want[0]).abs().max()) <= 1e-4
    for x, y in zip(got, again):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert (want[1][:refs // 2] > 0.5).all()


def test_k8_with_no_fragments(cuda_device):
    from galah_tpu_torch.ops import fragment_ani as fa

    pool = torch.zeros((2, 8), dtype=torch.int32, device=cuda_device)
    rows = torch.arange(2, device=cuda_device)
    ani, af = fa._forward_kernel(
        pool, rows, torch.ones(2, device=cuda_device),
        torch.zeros(0, dtype=torch.int32, device=cuda_device),
        torch.zeros(1, dtype=torch.int32, device=cuda_device), bits=256,
        **_VERIFY_KW)
    assert torch.equal(ani.cpu(), torch.zeros(2))
    assert torch.equal(af.cpu(), torch.zeros(2))


def test_k7_and_k8_count_their_launches_by_shard(cuda_device):
    from galah_tpu_torch.ops import fragment_ani as fa
    from galah_tpu_torch.ops import pair_table as pt

    args = _one_pair(cuda_device)
    grouped = _grouped_inputs(2, 3, 500, 4, 1 << 16, cuda_device)
    for fn, a in ((pt._pair_table_kernel, args), (fa._forward_kernel,
                                                  grouped)):
        before = fn.launches
        shard0, shard1 = fn.per_shard[0], fn.per_shard[1]
        for shard in (0, 1, 1, None):
            fn(*a, bits=1 << 16, shard=shard, **_VERIFY_KW)
        assert fn.launches == before + 4
        assert fn.per_shard[0] == shard0 + 1
        assert fn.per_shard[1] == shard1 + 2


def test_k7_and_k8_count_on_themselves_under_a_wrapped_name(cuda_device,
                                                            monkeypatch):
    """A caller that replaces the module's name with a wrapper (as the
    smoke's recording does) still sees each launch counted on the
    original function."""
    from galah_tpu_torch.ops import fragment_ani as fa
    from galah_tpu_torch.ops import pair_table as pt

    args = _one_pair(cuda_device)
    grouped = _grouped_inputs(2, 3, 500, 4, 1 << 16, cuda_device)
    for mod, name, a in ((pt, "_pair_table_kernel", args),
                         (fa, "_forward_kernel", grouped)):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *x, _f=real, **k: _f(*x, **k))
        before = real.launches
        getattr(mod, name)(*a, bits=1 << 16, shard=0, **_VERIFY_KW)
        assert real.launches == before + 1


@pytest.mark.parametrize("failure", [
    "error code", "plan", "shared memory", "cluster size"])
@pytest.mark.parametrize("entry", ["galah_pair_table_verify",
                                   "galah_grouped_verify"])
def test_k7_and_k8_raise_on_a_failed_launch(cuda_device, monkeypatch, entry,
                                            failure):
    """A CUDA error from either entry raises with its code and counts no
    launch: there is no fallback to the plain version. "error code" is
    any code the entry returns; the others are the real entries given a
    launch plan that they refuse (a row that is not cluster x slice
    bits), or that the card refuses: a cluster of blocks with 300,000
    bytes of shared memory each, a cluster of 16 blocks."""
    from types import SimpleNamespace

    from galah_tpu_torch.ops import _build
    from galah_tpu_torch.ops import fragment_ani as fa
    from galah_tpu_torch.ops import pair_table as pt

    plans = {"plan": pt.VerifyPlan(2, 1 << 16, 1 << 13),
             "shared memory": pt.VerifyPlan(4, 1 << 14, 300_000),
             "cluster size": pt.VerifyPlan(16, 1 << 12, 1 << 9)}
    if failure == "error code":
        monkeypatch.setattr(_build, "load_library", lambda: SimpleNamespace(
            **{entry: lambda *args: 98,
               "galah_grouped_verify_scratch_words": lambda f, r: 3 * f * r}))
    else:
        for mod in (pt, fa):
            monkeypatch.setattr(mod, "verify_launch_plan",
                                lambda bits: plans[failure])
    if entry == "galah_pair_table_verify":
        fn = pt._pair_table_kernel
        args = _one_pair(cuda_device)
    else:
        fn = fa._forward_kernel
        args = _grouped_inputs(2, 3, 500, 4, 1 << 16, cuda_device)
    before = fn.launches
    with pytest.raises(RuntimeError, match="CUDA error 98" if failure ==
                       "error code" else "CUDA error [1-9]"):
        fn(*args, bits=1 << 16, **_VERIFY_KW)
    torch.cuda.synchronize()
    assert fn.launches == before
    # the card took nothing from the refused launch: the next one runs
    monkeypatch.undo()
    fn(*args, bits=1 << 16, **_VERIFY_KW)
    torch.cuda.synchronize()
    assert fn.launches == before + 1


def test_verify_issue_steps_never_sync(cuda_device, tmp_path, monkeypatch):
    """A pair-table batch's dispatch (K7) and a grouped issue (K8) run
    under sync debug mode "error" once their streams and bitmaps are
    resident: neither waits for the card. Their results equal the same
    engine's on the CPU (AF equal, ANI within 1e-3 percentage points)."""
    from galah_tpu_torch.engines.native import _shrink_bits
    from galah_tpu_torch.ops import fragment_ani as fa
    from galah_tpu_torch.ops import pair_table as pt
    from galah_tpu_torch.sketch.fracminhash import (
        NativeSketchParams,
        sketch_file_native,
    )
    from galah_tpu_torch.utils.synth import make_families

    monkeypatch.setenv("GALAH_TPU_VERIFY_DEVICES", "1")
    paths, _ = make_families(str(tmp_path / "g"), 2, 3, genome_length=60_000,
                             seed=7)
    params = _shrink_bits(NativeSketchParams(), 60_000)
    sk = {p: sketch_file_native(p, params) for p in paths}
    cfg = fa.FragmentAniConfig(k=params.k, member_bits=params.member_bits,
                               min_fragment_hashes=params.min_fragment_hashes)
    batch = [(a, b) for a in paths for b in paths if a != b]
    out = {}
    for dev in (CPU, cuda_device):
        eng = fa.FragmentAniEngine(cfg, dev)
        shard = eng.verify_shards()[0]

        def issue():
            return (eng.pair_table._dispatch(batch, sk, shard, 0),
                    eng.one_to_many_issue(sk[paths[0]], paths[0],
                                          [sk[p] for p in paths[1:]],
                                          paths[1:]))

        issue()                      # makes every stream and bitmap resident
        if dev.type == "cuda":
            k7, k8 = pt._pair_table_kernel.launches, fa._forward_kernel.launches
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = issue()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if dev.type == "cuda":
            assert pt._pair_table_kernel.launches == k7 + 1
            assert fa._forward_kernel.launches == k8 + 1
        out[dev.type] = [t.cpu() for pair in got for t in pair]
    cpu, gpu = out["cpu"], out["cuda"]
    for i in (1, 3):                # the pair table's AF, the grouped AF
        assert torch.equal(cpu[i], gpu[i]), i
    for i in (0, 2):                # ANI, as test_verify_on_card_matches_cpu
        assert float((cpu[i] - gpu[i]).abs().max()) <= 1e-3, i
    assert (cpu[1] > 0.5).any()
