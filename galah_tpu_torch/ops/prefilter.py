"""All-vs-all sketch-intersection screen (counterpart of galah_tpu/ops/prefilter.py).

Genome prefilter sketches are packed uint32 bitmap rows (int32 tensors
holding the same bits). The packed matrix is uploaded once and the
upper triangle of (block x block) tiles is swept in order; per tile:

1. intersection counts, from the packed-popcount kernel
   (ops/packed_matmul.py);
2. collision-corrected max containment, in the reference's float32
   operation order (_containment);
3. the float32 cutoff and, on diagonal tiles, the strict-upper mask;
4. hit extraction with torch.nonzero on the device, row-major; only
   the hits leave the device, their values rounded to bfloat16;
5. host decode under the reference's emit rules (_emit_tile), including
   its overflow rule: a tile with more than `cap` hits is decided on the
   bfloat16-rounded containment, as the reference's dense fallback does.

Pairs come out tile by tile in (bi, bj >= bi) order, row-major within a
tile, with i < j, exactly as the reference's resident sweep emits them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from galah_tpu.utils import metrics
from galah_tpu_torch.ops.packed_matmul import packed_intersect_counts
from galah_tpu_torch.utils.convert import words_to_torch

DEFAULT_BLOCK = 1024


@dataclass(frozen=True)
class ScreenResult:
    """Above-cutoff candidate pairs with containment-ANI estimates."""

    pairs: np.ndarray    # (P, 2) int64 — indices, i < j
    ani_est: np.ndarray  # (P,) float32 — percentage scale


def _empty_result() -> ScreenResult:
    return ScreenResult(np.empty((0, 2), np.int64), np.empty(0, np.float32))


def _screen_cap_for(block: int) -> int:
    """Per-tile hit capacity of the reference's sparse extraction,
    linear in the tile edge. Past it the reference decides the tile on
    its bfloat16 containment (the dense fallback); _screen_tile keeps
    that rule so the pair set matches at any hit count."""
    return 16384 * max(1, block // 1024)


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
):
    """One tile: (ii, jj, vals) host arrays of its hits, row-major, with
    vals the bfloat16-rounded containment as float32."""
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
    if int(mask.sum()) > cap:
        # The reference's overflow path: the tile's bfloat16 containment
        # against the same float32 cutoff.
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


def screen_triangle_packed(
    packed: Sequence[np.ndarray],
    sizes: np.ndarray,
    k: int,
    min_containment: float,
    bits: int,
    device: torch.device,
    block: int = DEFAULT_BLOCK,
) -> ScreenResult:
    """Upper-triangle screen over packed uint32 bitmap rows.

    packed: n rows of (bits/32,) uint32 words; sizes: (n,) set sizes.
    The whole packed matrix is uploaded to `device` once and the tiles
    are slices of it."""
    n = len(packed)
    if n == 0:
        return _empty_result()
    x = words_to_torch(np.stack([np.asarray(r) for r in packed])).to(device)
    s = torch.from_numpy(np.asarray(sizes).astype(np.float32)).to(device)
    inv_k = 1.0 / k
    cap = _screen_cap_for(block)
    min_cont_f = float(np.float32(min_containment))
    bits_f = float(bits)
    nblocks = -(-n // block)
    m = metrics.current()
    pairs: List[np.ndarray] = []
    anis: List[np.ndarray] = []
    for bi in range(nblocks):
        ri = slice(bi * block, min(n, (bi + 1) * block))
        for bj in range(bi, nblocks):
            rj = slice(bj * block, min(n, (bj + 1) * block))
            m.count("screen_tiles", 1)
            m.count("screen_pairs_computed", block * block)
            ii, jj, vals = _screen_tile(
                x[ri], x[rj], s[ri], s[rj], bits_f, min_cont_f, cap,
                diag=bi == bj,
            )
            _emit_tile(
                ii, jj, vals, row0=bi * block, col0=bj * block,
                inv_k=inv_k, pairs=pairs, anis=anis,
            )
    if pairs:
        return ScreenResult(np.concatenate(pairs), np.concatenate(anis))
    return _empty_result()
