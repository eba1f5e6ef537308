"""galah_tpu_torch's packed screens against the JAX package's.

The same numpy-seeded packed rows go through both packages' triangle and
rectangle screens, resident and streaming, on the CPU; candidate pairs
must be identical and the screen ANI estimates equal (both round
containment to bfloat16 and take v ** (1/k) * 100 in numpy float32)."""

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


def _assert_same(got, want):
    assert got.pairs.dtype == np.int64 and got.ani_est.dtype == np.float32
    pw, aw = _sorted(want)
    pg, ag = _sorted(got)
    np.testing.assert_array_equal(pg, pw)
    np.testing.assert_array_equal(ag.view(np.int32), aw.view(np.int32))
    return pg


def _run_both(ind, min_cont, block, k=15, cache_blocks=True):
    bits = ind.shape[1]
    sizes = ind.sum(axis=1)
    packed = _packed_rows(ind)
    want = jax_pf.screen_triangle_packed(
        packed, sizes, k=k, min_containment=min_cont, bits=bits, block=block,
        cache_blocks=cache_blocks,
    )
    got = pf.screen_triangle_packed(
        packed, sizes, k=k, min_containment=min_cont, bits=bits,
        device=CPU, block=block, cache_blocks=cache_blocks,
    )
    pg = _assert_same(got, want)
    assert (pg[:, 0] < pg[:, 1]).all()
    return pg


def near_duplicates(rng, n, n_near, bits=4096):
    """n indicator rows: the first n_near are random 50-95% subsamples of
    one base bitmap (pairwise containment ~0.5-0.95), the rest sparse
    unrelated rows."""
    base = rng.random(bits) < 0.2
    keep = rng.uniform(0.5, 0.95, size=(n_near, 1))
    ind = rng.random((n, bits)) < 0.05
    ind[:n_near] = base & (rng.random((n_near, bits)) < keep)
    return ind.astype(np.uint8)


def _cont(ind_i, ind_j):
    bits = ind_i.shape[1]
    counts = packed_intersect_counts_reference(
        words_to_torch(np.stack(_packed_rows(ind_i))),
        words_to_torch(np.stack(_packed_rows(ind_j))),
    ).float()
    return pf._containment(
        counts, torch.from_numpy(ind_i.sum(axis=1).astype(np.float32)),
        torch.from_numpy(ind_j.sum(axis=1).astype(np.float32)), float(bits),
    )


def knife_cutoff(cont, bf16_above, lo=0.65, hi=0.75):
    """((i, j), cutoff) with the cutoff midway between pair (i, j)'s
    float32 containment and its bfloat16 rounding, which lies above
    (bf16_above) or below it; the pair is the first with containment in
    (lo, hi), so the cutoff keeps a predictable share of the pairs."""
    c16 = cont.to(torch.bfloat16).float()
    side = (c16 > cont) if bf16_above else (c16 < cont)
    cand = side & (cont > lo) & (cont < hi)
    i, j = map(int, torch.nonzero(cand)[0])
    cut = float((cont[i, j].double() + c16[i, j].double()) / 2)
    assert (float(np.float32(cut)) > float(cont[i, j])) == bf16_above
    return (i, j), cut


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
    assert pf._device_resident_budget(CPU) == 4 << 30
    assert pf._row_sel(4096) == 256 and pf._row_sel(200) == 128


def test_streaming_triangle_keeps_the_row_overflow_rule():
    """300 rows, 150 of them near-duplicates: the 256-row diagonal tile
    has hits in 149 rows (over the reference's 128-row extraction) but
    fewer than cap hits. The resident sweep decides it on float32
    containment; the streaming sweep (cache_blocks=False) densely, on
    bfloat16. With the cutoff between a pair's float32 containment and
    its lower bfloat16 rounding, the two sweeps keep different pair
    sets, and each package's sweep must match the other's."""
    ind = near_duplicates(np.random.default_rng(2), 300, 150)
    cont = _cont(ind, ind)
    (i, j), cut = knife_cutoff(cont, bf16_above=False)
    upper = torch.ones_like(cont, dtype=torch.bool).triu(1)
    hits = upper[:256, :256] & (cont[:256, :256] >= cut)
    assert int(hits.sum()) <= pf._screen_cap_for(256)
    assert int(hits.any(dim=1).sum()) > pf._row_sel(256)
    resident = _run_both(ind, cut, block=256)
    streaming = _run_both(ind, cut, block=256, cache_blocks=False)
    assert (i, j) in set(map(tuple, resident.tolist()))
    assert (i, j) not in set(map(tuple, streaming.tolist()))
    assert len(streaming) < len(resident)


def test_over_budget_matrix_streams(monkeypatch):
    """A packed matrix over _device_resident_budget takes the streaming
    sweep in both packages, with its overflow rule."""
    ind = near_duplicates(np.random.default_rng(2), 300, 150)
    _, cut = knife_cutoff(_cont(ind, ind), bf16_above=False)
    streaming = _run_both(ind, cut, block=256, cache_blocks=False)
    monkeypatch.setattr(jax_pf, "_device_resident_budget", lambda: 4096)
    monkeypatch.setattr(pf, "_device_resident_budget", lambda device: 4096)
    over = _run_both(ind, cut, block=256)
    np.testing.assert_array_equal(over, streaming)


def _run_rectangle(q, r, cut, block, cache_blocks, k=15):
    bits = q.shape[1]
    args = (_packed_rows(q), q.sum(axis=1), _packed_rows(r), r.sum(axis=1))
    want = jax_pf.screen_rectangle_packed(
        *args, k=k, min_containment=cut, bits=bits, block=block,
        cache_blocks=cache_blocks,
    )
    got = pf.screen_rectangle_packed(
        *args, k=k, min_containment=cut, bits=bits, device=CPU, block=block,
        cache_blocks=cache_blocks,
    )
    pairs = _assert_same(got, want)
    assert (pairs[:, 0] < len(q)).all() and (pairs[:, 1] < len(r)).all()
    return set(map(tuple, pairs.tolist()))


def test_rectangle_row_overflow_resident_and_streaming():
    """300 queries x 200 references, ragged at block 256; 150 and 100 of
    them near-duplicates of one base. The (0, 0) tile has hits in 150
    rows, under cap: the resident rectangle decides it on float32, the
    streaming one on bfloat16."""
    rng = np.random.default_rng(4)
    ind = near_duplicates(rng, 500, 250)
    q = np.concatenate([ind[:150], ind[250:400]])
    r = np.concatenate([ind[150:250], ind[400:]])
    (i, j), cut = knife_cutoff(_cont(q, r), bf16_above=False)
    resident = _run_rectangle(q, r, cut, 256, cache_blocks=True)
    streaming = _run_rectangle(q, r, cut, 256, cache_blocks=False)
    assert (i, j) in resident and (i, j) not in streaming
    assert streaming < resident


@pytest.mark.parametrize("cache_blocks", [True, False])
def test_rectangle_cap_overflow(cache_blocks):
    """A rectangle tile with more hits than cap is decided on bfloat16
    in both sweeps: a pair whose float32 containment is just under the
    cutoff and whose bfloat16 rounding is over it is kept."""
    rng = np.random.default_rng(6)
    ind = near_duplicates(rng, 520, 460)
    q = np.concatenate([ind[:256], ind[460:500]])
    r = np.concatenate([ind[256:460], ind[500:]])
    (i, j), cut = knife_cutoff(_cont(q, r), bf16_above=True)
    assert int((_cont(q[:256], r) >= cut).sum()) > pf._screen_cap_for(256)
    assert (i, j) in _run_rectangle(q, r, cut, 256, cache_blocks)


def test_rectangle_over_budget_and_small(monkeypatch):
    rng = np.random.default_rng(8)
    ind = near_duplicates(rng, 90, 30, bits=2048)
    q, r = ind[::2], ind[1::2]
    streaming = _run_rectangle(q, r, 0.3, 32, cache_blocks=False)
    assert _run_rectangle(q, r, 0.3, 32, cache_blocks=True) == streaming
    monkeypatch.setattr(jax_pf, "_device_resident_budget", lambda: 4096)
    monkeypatch.setattr(pf, "_device_resident_budget", lambda device: 4096)
    assert _run_rectangle(q, r, 0.3, 32, cache_blocks=True) == streaming
    assert len(streaming) >= 100
    empty = pf.screen_rectangle_packed(
        [], np.zeros(0), _packed_rows(r), r.sum(axis=1), 15, 0.3, 2048,
        device=CPU,
    )
    assert empty.pairs.shape == (0, 2)
