"""All-vs-all sketch-intersection screen (counterpart of galah_tpu/ops/prefilter.py).

Genome prefilter sketches are packed uint32 bitmap rows (int32 tensors
holding the same bits). A sweep walks (block x block) tiles: the upper
triangle of one matrix (screen_triangle_packed) or every (query block,
reference block) tile of a rectangle (screen_rectangle_packed); per tile:

1. intersection counts, from the packed-popcount kernel
   (ops/packed_matmul.py);
2. collision-corrected max containment, in the reference's float32
   operation order (_containment);
3. the float32 cutoff and, on diagonal tiles, the strict-upper mask;
4. hit extraction with torch.nonzero on the device, row-major; only
   the hits leave the device, their values rounded to bfloat16;
5. host decode under the reference's emit rules (_emit_tile).

Resident sweeps upload the packed matrix once (or take it from the
engine's matrix builder, which assembles it from device-born sketch
rows) and slice its tiles;
streaming sweeps (low-memory mode, or a matrix over the device budget)
upload each tile's row blocks from the host row sequence. The two keep
the reference's two overflow rules (_screen_tile): a resident tile is
decided on its bfloat16-rounded containment (the reference's dense
fallback) only past `cap` hits; a streaming tile also when its hits
span more than `_row_sel(rows)` rows, because the reference has no
resident matrix to re-extract such a tile from.

Pairs come out tile by tile in sweep order, row-major within a tile,
exactly as the reference's sweeps emit them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from galah_tpu_torch.ops.packed_matmul import packed_intersect_counts
from galah_tpu_torch.utils import metrics
from galah_tpu_torch.utils.convert import words_to_torch

DEFAULT_BLOCK = 1024

# Hit-row capacity of the reference's two-level sparse extraction
# (galah_tpu/ops/prefilter.py ROW_SEL): a streaming tile whose hits span
# more rows is decided densely.
ROW_SEL = 128

# (packed rows, sizes) of one block on the device.
Block = Tuple[torch.Tensor, torch.Tensor]
# One tile's decision: (si, sj, ai, aj, diag) -> (ii, jj, vals) host
# arrays of its hits, row-major.
TileFn = Callable[
    [torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, bool],
    Tuple[np.ndarray, np.ndarray, np.ndarray],
]


@dataclass(frozen=True)
class ScreenResult:
    """Above-cutoff candidate pairs with containment-ANI estimates."""

    pairs: np.ndarray    # (P, 2) int64 — (i, j) with i < j, or (query, ref)
    ani_est: np.ndarray  # (P,) float32 — percentage scale


def _empty_result() -> ScreenResult:
    return ScreenResult(np.empty((0, 2), np.int64), np.empty(0, np.float32))


def _screen_cap_for(block: int) -> int:
    """Per-tile hit capacity of the reference's sparse extraction,
    linear in the tile edge. Past it the reference decides the tile on
    its bfloat16 containment (the dense fallback); _screen_tile keeps
    that rule so the pair set matches at any hit count."""
    return 16384 * max(1, block // 1024)


def _row_sel(rows: int) -> int:
    """Hit rows the reference's two-level extraction holds for a tile
    of `rows` rows (galah_tpu/ops/prefilter.py _extract_above_cutoff)."""
    return min(rows, max(ROW_SEL, rows // 16))


def _device_resident_budget(device: torch.device) -> int:
    """Bytes the packed matrix may take on `device` and stay resident:
    half the card's memory on CUDA, 4 GiB on the CPU (the reference's
    rule and CPU figure)."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[1] // 2
    return 4 << 30


def _containment(
    counts: torch.Tensor, a: torch.Tensor, b: torch.Tensor, bits_f: float
) -> torch.Tensor:
    """Collision-corrected max containment, float32.

    counts: (bi, bj); a: (bi,) sizes; b: (bj,) sizes.
    Two-step correction: E[c_obs] ~= c + (a-c)(b-c)/B."""
    a = a[:, None]
    b = b[None, :]
    c1 = torch.clamp(counts - a * b / bits_f, min=0.0)
    c = torch.clamp(counts - (a - c1) * (b - c1) / bits_f, min=0.0)
    denom = torch.clamp(torch.minimum(a, b), min=1.0)
    return torch.clamp(c / denom, max=1.0)


def _screen_tile(
    si: torch.Tensor,
    sj: torch.Tensor,
    ai: torch.Tensor,
    aj: torch.Tensor,
    bits_f: float,
    min_cont_f: float,
    cap: int,
    diag: bool,
    streaming: bool,
):
    """One tile: (ii, jj, vals) host arrays of its hits, row-major, with
    vals the bfloat16-rounded containment as float32.

    The tile is decided on its float32 containment unless it has more
    than `cap` hits or, when `streaming`, its hits span more than
    _row_sel rows: then on its bfloat16 containment, against the same
    float32 cutoff (the reference's dense path)."""
    counts = packed_intersect_counts(si, sj).to(torch.float32)
    cont = _containment(counts, ai, aj, bits_f)
    upper = None
    if diag:
        upper = torch.ones(
            cont.shape, dtype=torch.bool, device=cont.device
        ).triu_(1)
    mask = cont >= min_cont_f
    if upper is not None:
        mask &= upper
    dense = int(mask.sum()) > cap
    if streaming and not dense:
        dense = int(mask.any(dim=1).sum()) > _row_sel(mask.shape[0])
    if dense:
        mask = cont.to(torch.bfloat16).to(torch.float32) >= min_cont_f
        if upper is not None:
            mask &= upper
    hit = torch.nonzero(mask)
    vals = cont[hit[:, 0], hit[:, 1]].to(torch.bfloat16).to(torch.float32)
    hit = hit.cpu().numpy()
    return hit[:, 0], hit[:, 1], vals.cpu().numpy()


def _emit_tile(
    ii: np.ndarray,
    jj: np.ndarray,
    vals: np.ndarray,
    *,
    row0: int,
    col0: int,
    inv_k: float,
    pairs: List[np.ndarray],
    anis: List[np.ndarray],
) -> None:
    """The reference's _drain_tile emit rules: rebase by row0/col0 and
    convert containment to ANI as v ** (1/k) * 100 in numpy float32.
    Tiles are exact row slices here, never zero-padded, so the
    reference's drop of padding rows (keep_rows/keep_cols) has nothing
    to remove."""
    gi = ii.astype(np.int64) + row0
    gj = jj.astype(np.int64) + col0
    v = vals.astype(np.float32)
    if len(gi):
        pairs.append(np.stack([gi, gj], axis=1).astype(np.int64))
        anis.append((v ** inv_k * 100.0).astype(np.float32))


def _packed_tile(
    bits: int, min_containment: float, block: int, streaming: bool
) -> TileFn:
    """The packed screens' per-tile decision (_screen_tile) for _sweep."""
    cap = _screen_cap_for(block)
    min_cont_f = float(np.float32(min_containment))
    return lambda si, sj, ai, aj, diag: _screen_tile(
        si, sj, ai, aj, float(bits), min_cont_f, cap,
        diag=diag, streaming=streaming,
    )


def _sweep(
    row_block: Callable[[int], Block],
    col_block: Callable[[int], Block],
    n_rows: int,
    n_cols: int,
    *,
    triangle: bool,
    tile: TileFn,
    block: int,
    k: int,
) -> ScreenResult:
    """Every tile of a sweep, in the reference's order: row block bi
    once per row of tiles, then column blocks bj >= bi (triangle; the
    diagonal tile reuses the row block) or every bj (rectangle).
    `tile(si, sj, ai, aj, diag)` decides one tile: its hits (ii, jj)
    and their containment values, row-major."""
    inv_k = 1.0 / k
    pairs: List[np.ndarray] = []
    anis: List[np.ndarray] = []
    for bi in range(-(-n_rows // block)):
        si, ai = row_block(bi)
        for bj in range(bi if triangle else 0, -(-n_cols // block)):
            diag = triangle and bj == bi
            sj, aj = (si, ai) if diag else col_block(bj)
            ii, jj, vals = tile(si, sj, ai, aj, diag)
            _emit_tile(
                ii, jj, vals, row0=bi * block, col0=bj * block,
                inv_k=inv_k, pairs=pairs, anis=anis,
            )
    if pairs:
        return ScreenResult(np.concatenate(pairs), np.concatenate(anis))
    return _empty_result()


def _row_width(packed: Sequence[np.ndarray]) -> int:
    """Words per row, from the sequence's `row_width` hint when it has
    one (lazy rows), else from row 0."""
    return getattr(packed, "row_width", None) or len(packed[0])


def _host_block(
    packed: Sequence[np.ndarray], sizes_f: np.ndarray, lo: int, hi: int,
    device: torch.device,
) -> Block:
    """Rows [lo, hi) of a host row sequence, uploaded to `device`."""
    mat = np.stack([np.asarray(packed[t]) for t in range(lo, hi)])
    return (
        words_to_torch(mat).to(device),
        torch.from_numpy(sizes_f[lo:hi]).to(device),
    )


def _streamer(
    packed: Sequence[np.ndarray], sizes_f: np.ndarray, block: int,
    device: torch.device,
) -> Callable[[int], Block]:
    n = len(packed)
    return lambda b: _host_block(
        packed, sizes_f, b * block, min(n, (b + 1) * block), device
    )


def _slicer(x: torch.Tensor, s: torch.Tensor, block: int):
    return lambda b: (x[b * block:(b + 1) * block], s[b * block:(b + 1) * block])


def screen_triangle_packed(
    packed: Sequence[np.ndarray],
    sizes: np.ndarray,
    k: int,
    min_containment: float,
    bits: int,
    device: torch.device,
    block: int = DEFAULT_BLOCK,
    cache_blocks: bool = True,
    matrix_builder: Optional[Callable[[int], torch.Tensor]] = None,
) -> ScreenResult:
    """Upper-triangle screen over packed uint32 bitmap rows.

    packed: n rows of (bits/32,) uint32 words (any sequence; rows are
    read by index); sizes: (n,) set sizes. The packed matrix is uploaded
    to `device` once and the tiles are slices of it, unless
    cache_blocks=False (low-memory mode) or the matrix exceeds
    _device_resident_budget: then each tile's blocks stream from the
    host (the reference's streaming branch, with its overflow rule).
    matrix_builder(n), when given, supplies the resident (n, W) int32
    matrix on `device` instead of the upload (the engine builds it from
    device-born sketch rows)."""
    n = len(packed)
    if n == 0:
        return _empty_result()
    sizes_f = np.asarray(sizes).astype(np.float32)
    w = _row_width(packed)
    kw = dict(triangle=True, block=block, k=k)
    if cache_blocks and n * w * 4 <= _device_resident_budget(device):
        if matrix_builder is not None:
            x = matrix_builder(n)
            s = torch.from_numpy(sizes_f).to(device)
        else:
            x, s = _host_block(packed, sizes_f, 0, n, device)
        tiles = -(-n // block) * (-(-n // block) + 1) // 2
        m = metrics.current()
        m.count("screen_tiles", tiles)
        m.count("screen_pairs_computed", tiles * block * block)
        get = _slicer(x, s, block)
        tile = _packed_tile(bits, min_containment, block, streaming=False)
        return _sweep(get, get, n, n, tile=tile, **kw)
    stream = _streamer(packed, sizes_f, block, device)
    tile = _packed_tile(bits, min_containment, block, streaming=True)
    return _sweep(stream, stream, n, n, tile=tile, **kw)


def screen_rectangle_packed(
    query_packed: Sequence[np.ndarray],
    query_sizes: np.ndarray,
    ref_packed: Sequence[np.ndarray],
    ref_sizes: np.ndarray,
    k: int,
    min_containment: float,
    bits: int,
    device: torch.device,
    block: int = DEFAULT_BLOCK,
    cache_blocks: bool = True,
) -> ScreenResult:
    """Cross-group screen (reference-genome mode): every (query block,
    reference block) tile, never a diagonal. Returns (query_idx,
    ref_idx) pairs. Queries and references form one resident matrix,
    unless cache_blocks=False (low-memory mode) or the rectangle
    exceeds _device_resident_budget: then blocks stream from the host,
    with the streaming overflow rule. The budget check counts the
    block-padded rows the reference's resident matrix holds, so both
    packages take the same branch."""
    nq, nr = len(query_packed), len(ref_packed)
    if nq == 0 or nr == 0:
        return _empty_result()
    qs = np.asarray(query_sizes).astype(np.float32)
    rs = np.asarray(ref_sizes).astype(np.float32)
    w = _row_width(query_packed)
    kw = dict(triangle=False, block=block, k=k)
    padded_rows = -(-nq // block) * block + -(-nr // block) * block
    if cache_blocks and padded_rows * w * 4 <= _device_resident_budget(device):
        mat = np.stack([np.asarray(query_packed[t]) for t in range(nq)]
                       + [np.asarray(ref_packed[t]) for t in range(nr)])
        x = words_to_torch(mat).to(device)
        s = torch.from_numpy(np.concatenate([qs, rs])).to(device)
        del mat
        return _sweep(
            _slicer(x[:nq], s[:nq], block), _slicer(x[nq:], s[nq:], block),
            nq, nr,
            tile=_packed_tile(bits, min_containment, block, streaming=False),
            **kw,
        )
    return _sweep(
        _streamer(query_packed, qs, block, device),
        _streamer(ref_packed, rs, block, device),
        nq, nr,
        tile=_packed_tile(bits, min_containment, block, streaming=True),
        **kw,
    )

