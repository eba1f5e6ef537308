"""galah_tpu_torch's popcount screen against the JAX package's.

screen_triangle_popcount runs the Pallas kernel in interpret mode on the
CPU (as tests/test_popcount_screen.py does) and the port its plain torch
counts; pairs must be identical and ANI bit-identical. Its semantics are
not the packed screen's: float32 containment decides every pair and
gives its ANI, with no cap and no bfloat16. The port's two plain count
versions (SWAR popcount here, unpack + matmul for the packed screen) are
checked against each other and a numpy oracle. The CUDA kernel itself
runs only on a card: its tests are in test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from galah_tpu.ops import popcount_screen as jax_pc
from galah_tpu_torch.ops import popcount_screen as pc
from galah_tpu_torch.ops.packed_matmul import packed_intersect_counts_reference
from galah_tpu_torch.utils.convert import words_to_torch
from test_torch_prefilter import (
    _assert_same,
    _cont,
    _packed_rows,
    knife_cutoff,
    near_duplicates,
)

CPU = torch.device("cpu")


def _run_both(ind, min_cont, block=128, k=15):
    bits = ind.shape[1]
    sizes = ind.sum(axis=1)
    packed = _packed_rows(ind)
    want = jax_pc.screen_triangle_popcount(packed, sizes, k, min_cont, bits,
                                           block=block)
    got = pc.screen_triangle_popcount(packed, sizes, k, min_cont, bits,
                                      device=CPU, block=block)
    pairs = _assert_same(got, want)
    assert (pairs[:, 0] < pairs[:, 1]).all()
    return got


def test_popcount_screen_matches_jax_on_a_float32_knife_edge():
    """300 rows at 2^12 bits, block 128 (six tiles, three of them
    diagonal). The cutoff lies between a pair's float32 containment and
    its lower bfloat16 rounding: the popcount screen decides on float32,
    so both packages keep the pair, and its ANI is that of the float32
    value, not of the bfloat16 one the packed screen reports."""
    ind = near_duplicates(np.random.default_rng(12), 300, 150)
    cont = _cont(ind, ind)
    (i, j), cut = knife_cutoff(cont, bf16_above=False)
    got = _run_both(ind, cut)
    kept = {tuple(p): a for p, a in zip(got.pairs.tolist(), got.ani_est)}
    assert (i, j) in kept
    assert kept[(i, j)] == np.float32(
        np.float32(cont[i, j].item()) ** (1 / 15) * 100.0
    )
    assert {(a, b) for a, b in kept if b >= 128 > a}  # off-diagonal tiles
    assert {(a, b) for a, b in kept if b < 128}       # the first diagonal tile


def test_popcount_screen_cutoff_zero_keeps_every_pair():
    ind = near_duplicates(np.random.default_rng(13), 140, 40, bits=2048)
    got = _run_both(ind, 0.0)
    assert len(got.pairs) == 140 * 139 // 2


def test_popcount_screen_empty():
    res = pc.screen_triangle_popcount([], np.zeros(0), 15, 0.3, 4096,
                                      device=CPU)
    assert res.pairs.shape == (0, 2) and res.ani_est.shape == (0,)


@pytest.mark.parametrize(
    "m,n,w", [(1, 1, 1), (7, 3, 5), (100, 77, 33), (65, 130, 600), (3, 0, 4)]
)
def test_plain_counts_agree_with_each_other_and_numpy(m, n, w):
    rng = np.random.default_rng(m * 1000 + n * 10 + w)
    a = rng.integers(0, 1 << 32, size=(m, w), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint64).astype(np.uint32)
    if m > 2 and n > 2:
        a[0], a[1], b[2] = 0xFFFFFFFF, 0, 0x80000000  # all-ones, empty, top bit
    a_bits = np.unpackbits(a.view(np.uint8), axis=1).astype(np.int64)
    b_bits = np.unpackbits(b.view(np.uint8), axis=1).astype(np.int64)
    at, bt = words_to_torch(a), words_to_torch(b)
    got = pc.popcount_tile_counts_reference(at, bt)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), a_bits @ b_bits.T)
    assert torch.equal(got, packed_intersect_counts_reference(at, bt))


def test_plain_counts_match_the_pallas_kernel():
    rng = np.random.default_rng(21)
    ind = rng.random((16, 8192)) < 0.3
    ind[3] = True
    ind[4] = False
    x = np.stack(_packed_rows(ind.astype(np.uint8)))
    cols = np.concatenate([x, x[::-1]] * 4)  # 128 column rows
    want = np.asarray(jax_pc._popcount_tile_counts(
        jnp.asarray(x), jnp.asarray(cols), interpret=True
    ))
    got = pc.popcount_tile_counts(words_to_torch(x), words_to_torch(cols))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_take_the_plain_version_without_launching():
    rng = np.random.default_rng(3)
    a = words_to_torch(np.stack(_packed_rows(
        (rng.random((9, 256)) < 0.3).astype(np.uint8))))
    before = pc.popcount_tile_counts.launches
    got = pc.popcount_tile_counts(a, a)
    assert pc.popcount_tile_counts.launches == before
    assert torch.equal(got, pc.popcount_tile_counts_reference(a, a))
    with pytest.raises(ValueError, match="width mismatch"):
        pc.popcount_tile_counts(a, a[:, :4].contiguous())


@pytest.mark.parametrize("m,n,w", [
    (1, 1, 1), (1, 33, 513), (1000, 777, 1000), (896, 128, 4096),
    (1024, 1024, 4096), (2048, 2048, 4096), (2048, 2048, 8192),
])
def test_launch_plan_covers_outputs_and_words(m, n, w):
    from test_torch_packed_matmul import H100_SMS, check_launch_plan

    check_launch_plan(pc._launch_plan(m, n, w, H100_SMS), m, n, w, H100_SMS,
                      pc.K2_TILE, pc.K2_PANEL_WORDS, pc.K2_BLOCKS_PER_SM)
