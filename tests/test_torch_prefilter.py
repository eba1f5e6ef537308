"""galah_tpu_torch's packed triangle screen against the JAX package's.

The same numpy-seeded packed rows go through both screens on the CPU;
candidate pairs must be identical and the screen ANI estimates equal
(both round containment to bfloat16 and take v ** (1/k) * 100 in numpy
float32)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from galah_tpu.ops import prefilter as jax_pf
from galah_tpu_torch.ops import prefilter as pf
from galah_tpu_torch.ops.packed_matmul import packed_intersect_counts_reference
from galah_tpu_torch.utils.convert import words_to_torch

CPU = torch.device("cpu")


def _packed_rows(ind: np.ndarray):
    return [
        np.packbits(row.astype(bool), bitorder="little").view(np.uint32)
        for row in ind
    ]


def _sorted(res):
    order = np.lexsort((res.pairs[:, 1], res.pairs[:, 0]))
    return res.pairs[order], res.ani_est[order]


def _run_both(ind, min_cont, block, k=15):
    bits = ind.shape[1]
    sizes = ind.sum(axis=1)
    packed = _packed_rows(ind)
    want = jax_pf.screen_triangle_packed(
        packed, sizes, k=k, min_containment=min_cont, bits=bits, block=block
    )
    got = pf.screen_triangle_packed(
        packed, sizes, k=k, min_containment=min_cont, bits=bits,
        device=CPU, block=block,
    )
    assert got.pairs.dtype == np.int64 and got.ani_est.dtype == np.float32
    pw, aw = _sorted(want)
    pg, ag = _sorted(got)
    np.testing.assert_array_equal(pg, pw)
    np.testing.assert_array_equal(ag, aw)
    assert (pg[:, 0] < pg[:, 1]).all()
    return pg


def test_containment_matches_jax_bitwise():
    rng = np.random.default_rng(0)
    bits = 1 << 14
    a = rng.integers(0, 3000, size=96).astype(np.float32)
    b = rng.integers(0, 3000, size=80).astype(np.float32)
    a[:3] = 0.0  # empty sets: the denominator floor
    counts = np.minimum(
        rng.integers(0, 3000, size=(96, 80)), np.minimum.outer(a, b)
    ).astype(np.float32)
    want = np.asarray(jax_pf._containment(
        jnp.asarray(counts), jnp.asarray(a), jnp.asarray(b), jnp.float32(bits)
    ))
    got = pf._containment(
        torch.from_numpy(counts), torch.from_numpy(a), torch.from_numpy(b),
        float(bits),
    ).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_screen_planted_duplicates_including_diagonal_tile():
    rng = np.random.default_rng(17)
    n, bits = 700, 4096
    ind = (rng.random((n, bits)) < 0.06).astype(np.uint8)
    ind[1] = ind[0]        # inside diagonal tile (0, 0)
    ind[650] = ind[649]    # inside the ragged last diagonal tile
    ind[300] = ind[5]      # off-diagonal tile (0, 2)
    pairs = _run_both(ind, 0.3, block=128)
    assert {(0, 1), (5, 300), (649, 650)} <= set(map(tuple, pairs.tolist()))


def test_screen_identical_rows_every_pair_hits():
    rng = np.random.default_rng(31)
    n, bits = 600, 4096
    base = (rng.random(bits) < 0.06).astype(np.uint8)
    ind = np.tile(base, (n, 1))
    pairs = _run_both(ind, 0.0, block=128)
    assert len(pairs) == n * (n - 1) // 2


@pytest.mark.parametrize("n,block", [(300, 128), (200, 64), (5, 128)])
def test_screen_n_not_a_multiple_of_block(n, block):
    rng = np.random.default_rng(n + block)
    bits = 2048
    ind = (rng.random((n, bits)) < 0.06).astype(np.uint8)
    for i in range(0, n - 1, 7):
        ind[i + 1] = ind[i] & (rng.random(bits) < 0.9)  # ~0.9 containment
    pairs = _run_both(ind, 0.3, block=block)
    assert len(pairs) >= (n - 1) // 7


def test_screen_tile_over_cap_uses_the_bfloat16_rule():
    """A tile with more hits than _screen_cap_for(block) is decided on
    its bfloat16 containment (the reference's dense fallback). Build a
    1024-row tile with > 16384 hits and a cutoff that falls between one
    pair's float32 containment and its (higher) bfloat16 rounding: both
    packages must keep that pair, which the float32 rule would drop."""
    rng = np.random.default_rng(5)
    n, bits = 260, 4096
    base = (rng.random(bits) < 0.2).astype(np.uint8)
    keep = rng.random((n, 1)) < rng.uniform(0.55, 1.0, size=(n, 1))
    ind = (base[None, :] & (rng.random((n, bits)) < np.where(keep, 0.97, 0.8))).astype(np.uint8)
    sizes = ind.sum(axis=1).astype(np.float32)
    x = words_to_torch(np.stack(_packed_rows(ind)))
    cont = pf._containment(
        packed_intersect_counts_reference(x, x).float(),
        torch.from_numpy(sizes), torch.from_numpy(sizes), float(bits),
    )
    upper = torch.ones_like(cont, dtype=torch.bool).triu(1)
    c16 = cont.to(torch.bfloat16).float()
    knife = upper & (c16 > cont) & (cont > 0.5)
    i, j = map(int, torch.nonzero(knife)[0])
    min_cont = float((cont[i, j].double() + c16[i, j].double()) / 2)
    assert float(np.float32(min_cont)) > float(cont[i, j])
    assert int((upper & (cont >= min_cont)).sum()) > pf._screen_cap_for(1024)
    pairs = _run_both(ind, min_cont, block=1024)
    assert (i, j) in set(map(tuple, pairs.tolist()))


def test_screen_empty_and_cap():
    res = pf.screen_triangle_packed([], np.zeros(0), 15, 0.3, 2048, device=CPU)
    assert res.pairs.shape == (0, 2) and res.ani_est.shape == (0,)
    assert pf._screen_cap_for(128) == jax_pf._screen_cap_for(128)
    assert pf._screen_cap_for(4096) == jax_pf._screen_cap_for(4096)
