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
