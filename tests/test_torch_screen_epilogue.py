"""The screen tile's epilogue (galah_tpu_torch/ops/screen_epilogue.py)
against the JAX package's, on the CPU.

screen_epilogue_reference, the plain version K6 is held to on the card,
takes a tile's intersection counts (int32 as K1 gives them, or float32
as the indicator product does) and the rows' sizes, and gives the
float32 containment and the hit buffer. The same numpy-seeded packed
rows go through the JAX package's device programs, run on the CPU as
its own tests run them: _resident_screen_extract for a resident tile,
_block_screen_extract_packed for a streaming one, _containment for the
matrix. The containment must be equal bit for bit; the count, the first
hits' (i, j) and their bfloat16 values exactly; the slots past the count
zeros. A streaming tile's hit-row count passes _row_sel exactly where
the JAX streaming program flags the tile with a negative count."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from galah_tpu.ops import prefilter as jax_pf
from galah_tpu_torch.ops import prefilter as pf
from galah_tpu_torch.ops import screen_epilogue as se
from galah_tpu_torch.ops.packed_matmul import packed_intersect_counts
from galah_tpu_torch.utils.convert import words_to_torch

CPU = torch.device("cpu")
WORDS = 32                 # 1,024 bits a row
BITS = WORDS * 32


def _rows(seed, n, families=0, at=()):
    """n packed uint32 rows, sparse and unrelated but for the rows in
    the [lo, hi) ranges of `at`: the k-th of those is a random 60-98%
    subsample of family k % families's base bitmap, so two members of a
    family have containment ~0.6-0.98."""
    rng = np.random.default_rng(seed)
    ind = rng.random((n, BITS)) < 0.06
    members = np.concatenate([np.arange(lo, hi) for lo, hi in at] or [[]])
    for f in range(families):
        rows = members[f::families].astype(np.int64)
        base = rng.random(BITS) < 0.25
        frac = rng.uniform(0.6, 0.98, size=(len(rows), 1))
        ind[rows] = base & (rng.random((len(rows), BITS)) < frac)
    return np.packbits(ind, axis=1, bitorder="little").view(np.uint32)


def _sizes(rows):
    return np.unpackbits(rows.view(np.uint8), axis=1).sum(axis=1).astype(
        np.float32)


def _counts(x, y, dtype):
    """K1's counts (its plain version) of uint32 rows x, y in `dtype`."""
    got = packed_intersect_counts(words_to_torch(x), words_to_torch(y))
    return got.to(dtype)


def _port(x, y, cut, *, diag, cap, streaming, dtype):
    a, b = (torch.from_numpy(_sizes(r)) for r in (x, y))
    return se.screen_epilogue_reference(
        _counts(x, y, dtype), a, b, bits_f=float(BITS),
        min_cont_f=float(np.float32(cut)), diag=diag, cap=cap,
        streaming=streaming)


def _jax_cont(x, y):
    counts = _counts(x, y, torch.float32).numpy()
    return np.asarray(jax_pf._containment(
        jnp.asarray(counts), jnp.asarray(_sizes(x)), jnp.asarray(_sizes(y)),
        jnp.float32(BITS)))


def _assert_hits(hits, cap, n, cnt, ii, jj, vals):
    """The port's hit buffer against the JAX package's (cnt, ii, jj,
    vals): the count, the first min(cnt, cap) hits and values, zeros
    past them."""
    hits = hits.numpy()
    assert hits.dtype == np.int32 and hits.shape == (2 + 2 * cap,)
    assert int(hits[0]) == cnt
    k = min(cnt, cap)
    flat = hits[2:2 + k].astype(np.int64)
    np.testing.assert_array_equal(flat // n, np.asarray(ii)[:k])
    np.testing.assert_array_equal(flat % n, np.asarray(jj)[:k])
    want = np.asarray(jnp.asarray(vals).astype(jnp.float32))[:k]
    np.testing.assert_array_equal(hits[2 + cap:2 + cap + k],
                                  want.view(np.int32))
    assert not hits[2 + k:2 + cap].any() and not hits[2 + cap + k:].any()


# (name, rows, block, (bi, bj), cutoff, cap) of the resident cases: a
# 2 x block matrix, tile (bi, bj) of it.
RESIDENT = [
    ("off-diagonal", dict(seed=1, families=4, at=[(0, 50), (128, 178)]),
     128, (0, 1), 0.5, None),
    ("diagonal", dict(seed=2, families=4, at=[(0, 80)]), 128, (0, 0), 0.5,
     None),
    ("diagonal-cutoff-0", dict(seed=3), 64, (1, 1), 0.0, None),
    ("no-hit", dict(seed=4), 128, (0, 1), 0.5, None),
    ("hits-over-cap", dict(seed=5, families=2, at=[(0, 100), (128, 228)]),
     128, (0, 1), 0.5, 37),
    ("diagonal-over-cap", dict(seed=6), 64, (0, 0), 0.0, 100),
    ("many-hit-rows", dict(seed=7, families=3, at=[(0, 200), (256, 456)]),
     256, (0, 1), 0.5, None),
]


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32],
                         ids=["int32", "float32"])
@pytest.mark.parametrize("name,spec,block,tile,cut,cap", RESIDENT,
                         ids=[c[0] for c in RESIDENT])
def test_resident_tile_matches_jax(name, spec, block, tile, cut, cap, dtype):
    x_all = _rows(n=2 * block, **spec)
    cap = cap or pf._screen_cap_for(block)
    bi, bj = tile
    diag = bi == bj
    x = x_all[bi * block:(bi + 1) * block]
    y = x_all[bj * block:(bj + 1) * block]
    cont, hits = _port(x, y, cut, diag=diag, cap=cap, streaming=False,
                       dtype=dtype)
    np.testing.assert_array_equal(cont.numpy().view(np.int32),
                                  _jax_cont(x, y).view(np.int32))

    def extract(direct):
        return jax_pf._resident_screen_extract(
            jnp.asarray(x_all), jnp.asarray(_sizes(x_all)), jnp.int32(bi),
            jnp.int32(bj), jnp.float32(BITS), jnp.float32(cut),
            block=block, cap=cap, is_diag=diag, dtname="f32", direct=direct)

    cnt, ii, jj, vals = extract(False)
    if int(cnt) < 0:
        # Hits past the JAX row capacity: its drain extracts the tile
        # again, directly, and so the resident port never flags it.
        cnt, ii, jj, vals = extract(True)
    _assert_hits(hits, cap, block, int(cnt), ii, jj, vals)
    assert int(hits[1]) == 0
    live = int(hits[0])
    if name == "no-hit":
        assert live == 0
    elif name == "diagonal-cutoff-0":
        assert live == block * (block - 1) // 2
    elif "over-cap" in name:
        assert live > cap
    elif name == "many-hit-rows":
        assert int((cont >= np.float32(cut)).any(dim=1).sum()) > \
            pf._row_sel(block)
    else:
        assert 0 < live <= cap


# (name, rows, m, n, cutoff, cap, diag) of the streaming cases: rows
# [0, m) against rows [m, m + n) of one matrix, or, on a diagonal tile,
# rows [0, m) against themselves.
STREAMING = [
    ("ragged", dict(seed=11, families=3, at=[(0, 60), (96, 200)]), 96, 200,
     0.5, None, False),
    ("ragged-tall", dict(seed=12, families=2, at=[(0, 100), (256, 328)]),
     256, 72, 0.5, None, False),
    ("diagonal", dict(seed=13, families=3, at=[(0, 90)]), 150, 150, 0.5,
     None, True),
    ("few-hit-rows", dict(seed=14, families=1, at=[(0, 60)]), 256, 256,
     0.5, None, True),
    ("more-hit-rows-than-row-sel", dict(seed=15, families=4,
                                        at=[(0, 256)]), 256, 256, 0.5, None,
     True),
    ("over-cap", dict(seed=16, families=2, at=[(0, 120)]), 120, 120, 0.5,
     25, True),
]


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32],
                         ids=["int32", "float32"])
@pytest.mark.parametrize("name,spec,m,n,cut,cap,diag", STREAMING,
                         ids=[c[0] for c in STREAMING])
def test_streaming_tile_matches_jax(name, spec, m, n, cut, cap, diag, dtype):
    rows = _rows(n=m + n, **spec)
    x = rows[:m]
    y = x if diag else rows[m:m + n]
    cap = cap or pf._screen_cap_for(max(m, n))
    cont, hits = _port(x, y, cut, diag=diag, cap=cap, streaming=True,
                       dtype=dtype)
    np.testing.assert_array_equal(cont.numpy().view(np.int32),
                                  _jax_cont(x, y).view(np.int32))
    cnt, ii, jj, vals = jax_pf._block_screen_extract_packed(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(_sizes(x)),
        jnp.asarray(_sizes(y)), jnp.float32(BITS), jnp.float32(cut),
        cap=cap, is_diag=diag, dtname="f32")
    cnt = int(cnt)
    hit_rows = int(hits[1])
    over = hit_rows > pf._row_sel(m)
    assert over == (cnt < 0)
    if over:
        # The JAX streaming program has extracted the first row_sel hit
        # rows only and encodes the count as -(count + 1); the drain
        # decides such a tile densely in both packages.
        assert int(hits[0]) == -cnt - 1
        assert name == "more-hit-rows-than-row-sel"
    else:
        _assert_hits(hits, cap, n, cnt, ii, jj, vals)
        assert name != "more-hit-rows-than-row-sel"
    mask = cont >= np.float32(cut)
    if diag:
        mask &= torch.ones_like(mask).triu_(1)
    assert hit_rows == int(mask.any(dim=1).sum())
    if name == "over-cap":
        assert int(hits[0]) > cap


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32],
                         ids=["int32", "float32"])
@pytest.mark.parametrize("diag", [False, True], ids=["off", "diagonal"])
def test_a_value_exactly_on_the_cutoff_is_a_hit(diag, dtype):
    """The cutoff set to one pair's float32 containment exactly: that
    pair is a hit in both packages, and the pairs just below it are
    not."""
    block = 128
    x_all = _rows(21 + diag, 2 * block, families=4,
                  at=[(0, 60), (128, 188)])
    bj = 0 if diag else 1
    x, y = x_all[:block], x_all[bj * block:(bj + 1) * block]
    cont = torch.from_numpy(_jax_cont(x, y).copy())
    upper = torch.ones_like(cont, dtype=torch.bool)
    if diag:
        upper = upper.triu(1)
    mid = (cont > 0.55) & (cont < 0.9) & upper
    i, j = map(int, torch.nonzero(mid)[len(torch.nonzero(mid)) // 2])
    cut = float(cont[i, j])
    assert float(np.float32(cut)) == cut
    cap = pf._screen_cap_for(block)
    got, hits = _port(x, y, cut, diag=diag, cap=cap, streaming=False,
                      dtype=dtype)
    cnt, ii, jj, vals = jax_pf._resident_screen_extract(
        jnp.asarray(x_all), jnp.asarray(_sizes(x_all)), jnp.int32(0),
        jnp.int32(bj), jnp.float32(BITS), jnp.float32(cut), block=block,
        cap=cap, is_diag=diag, dtname="f32")
    _assert_hits(hits, cap, block, int(cnt), ii, jj, vals)
    flat = hits[2:2 + int(hits[0])].numpy()
    assert i * block + j in set(flat.tolist())
    below = upper & (got < cut) & (got > cut - 1e-3)
    assert not set((torch.nonzero(below) @ torch.tensor([block, 1])).tolist()
                   ) & set(flat.tolist())


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors screen_epilogue is its plain version, and counts
    no launch."""
    x = _rows(31, 100, families=2, at=[(0, 60)])
    a = torch.from_numpy(_sizes(x))
    counts = _counts(x, x, torch.int32)
    kw = dict(bits_f=float(BITS), min_cont_f=0.5, diag=True, cap=64,
              streaming=True)
    before = se.screen_epilogue.launches
    got = se.screen_epilogue(counts, a, a, shard=3, **kw)
    want = se.screen_epilogue_reference(counts, a, a, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert se.screen_epilogue.launches == before
    assert se.screen_epilogue.per_shard[3] == 0


@pytest.mark.parametrize("m,n", [(0, 5), (5, 0)])
def test_an_empty_tile_has_an_empty_buffer(m, n):
    counts = torch.zeros((m, n), dtype=torch.int32)
    cont, hits = se.screen_epilogue(
        counts, torch.ones(m), torch.ones(n), bits_f=64.0, min_cont_f=0.0,
        diag=False, cap=4, streaming=True)
    assert cont.shape == (m, n)
    assert torch.equal(hits, torch.zeros(10, dtype=torch.int32))


@pytest.mark.parametrize("bad,error", [
    (dict(counts=torch.zeros((4, 5), dtype=torch.int64)), TypeError),
    (dict(a=torch.ones(3)), ValueError),
    (dict(b=torch.ones(5, dtype=torch.float64)), TypeError),
    (dict(counts=torch.zeros((5, 4), dtype=torch.int32).t()), ValueError),
    (dict(cap=-1), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, error):
    args = dict(counts=torch.zeros((4, 5), dtype=torch.int32),
                a=torch.ones(4), b=torch.ones(5), cap=8)
    args.update(bad)
    with pytest.raises(error):
        se.screen_epilogue(args["counts"], args["a"], args["b"],
                           bits_f=64.0, min_cont_f=0.5, diag=False,
                           cap=args["cap"], streaming=False)


@pytest.mark.parametrize("m,n,rows,blocks", [
    (1024, 1024, 4, 256),   # the contig tile: about two blocks an SM
    (1024, 672, 4, 256),    # its edge tile
    (896, 128, 8, 112),     # the reference tile: 1,024 elements a block
    (2048, 2048, 8, 256),
    (1021, 1024, 4, 256),   # the last block holds one row
    (300, 257, 4, 75),
    (16384, 64, 32, 512),   # at most 32 rows a block
    (1, 1, 32, 1),
    (0, 5, 32, 1),          # an empty tile still takes one block
    (5, 0, 32, 1),
])
def test_epilogue_plan(m, n, rows, blocks):
    """K6's launch plan: each row in one block, the last block not
    empty, at most MAX_ROWS rows a block; its scratch holds the two
    counters, a status word and a zeroed flag a block."""
    assert se.epilogue_plan(m, n) == (rows, blocks)
    assert 1 <= rows <= se.MAX_ROWS
    assert (blocks - 1) * rows < max(m, 1) <= blocks * rows
    assert 8 * se.scratch_words(blocks) >= 8 + 8 * blocks + 4 * blocks
