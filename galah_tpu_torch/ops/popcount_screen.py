"""The popcount screen (counterpart of galah_tpu/ops/popcount_screen.py).

An alternative all-vs-all screen over the same packed uint32 bitmap rows
as ops/prefilter.py, selected with GALAH_TPU_SCREEN=popcount. Its
intersection counts come from AND + population count, on a CUDA tensor
in the hand-written kernel csrc/popcount_screen.cu (the tensor cores'
single-bit AND-popcount product) and on a CPU tensor
in the plain torch version below (a SWAR popcount: a different
formulation from packed_matmul's unpack + matmul, so the two plain
versions check each other).

Its semantics are the reference's, not the packed screen's: there is no
hit cap and no bfloat16 anywhere. A pair is kept when its float32
containment reaches the cutoff, and its ANI is cont ** (1/k) * 100 of
that float32 value in numpy. The diagonal tile keeps only i < j.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from galah_tpu_torch.ops.packed_matmul import (
    LaunchPlan,
    _check,
    launch_counts,
    plan_split_k,
)
from galah_tpu_torch.ops.prefilter import (
    ScreenResult,
    _containment,
    _empty_result,
    _streamer,
    _sweep,
)

DEFAULT_BLOCK = 2048

# Elements of the (rows, n, W) AND temporaries per step of the plain
# version (~64 MB of int32 each).
_REF_CHUNK_ELEMS = 1 << 24


def _popc32(x: torch.Tensor) -> torch.Tensor:
    """Per-element population count of int32 words (SWAR): the uint32
    word's set bits. Bit 31 is counted apart, so the SWAR steps run on
    non-negative values and no int32 step overflows."""
    top = (x >> 31) & 1
    x = x & 0x7FFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return (x & 0x3F) + top


def popcount_tile_counts_reference(
    x_rows: torch.Tensor, x_cols: torch.Tensor
) -> torch.Tensor:
    """Plain torch version: out[i, j] = sum_k popc(x_rows[i, k] &
    x_cols[j, k]), over chunks of rows, exact int32."""
    _check(x_rows, x_cols)
    m, w = x_rows.shape
    n = x_cols.shape[0]
    out = torch.zeros((m, n), dtype=torch.int32, device=x_rows.device)
    if m == 0 or n == 0 or w == 0:
        return out
    step = max(1, _REF_CHUNK_ELEMS // (n * w))
    for lo in range(0, m, step):
        both = x_rows[lo:lo + step, None, :] & x_cols[None, :, :]
        out[lo:lo + step] = _popc32(both).sum(dim=2, dtype=torch.int32)
    return out


def popcount_tile_counts(
    x_rows: torch.Tensor, x_cols: torch.Tensor
) -> torch.Tensor:
    """(M, N) int32 intersection counts of (M, W) and (N, W) int32 word
    rows. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises."""
    _check(x_rows, x_cols)
    if x_rows.device.type == "cpu":
        return popcount_tile_counts_reference(x_rows, x_cols)
    if x_rows.device.type != "cuda":
        raise ValueError(f"unsupported device {x_rows.device}")
    from galah_tpu_torch.ops._build import load_library

    out = launch_counts(load_library().galah_popcount_screen, _launch_plan,
                        x_rows, x_cols)
    popcount_tile_counts.launches += 1
    return out


popcount_tile_counts.launches = 0

# The kernel's tile, K-panel and blocks per SM (csrc/popcount_screen.cu:
# 96 KiB of shared memory and <= 128 registers a thread, two blocks an
# SM).
K2_TILE = 128
K2_PANEL_WORDS = 32
K2_BLOCKS_PER_SM = 2


@functools.lru_cache(maxsize=1024)
def _launch_plan(m: int, n: int, w: int, sms: int) -> LaunchPlan:
    return plan_split_k(m, n, w, sms, tile=K2_TILE,
                        panel_words=K2_PANEL_WORDS,
                        blocks_per_sm=K2_BLOCKS_PER_SM)


def screen_triangle_popcount(
    packed: Sequence[np.ndarray],
    sizes: np.ndarray,
    k: int,
    min_containment: float,
    bits: int,
    device: torch.device,
    block: int = DEFAULT_BLOCK,
) -> ScreenResult:
    """Upper-triangle popcount screen over packed uint32 bitmap rows.

    As in the reference, row block bi is uploaded once per row of tiles
    and each column block per tile, from the host row sequence; no
    block is padded. Pairs are (i, j) with i < j, tile by tile in
    (bi, bj >= bi) order and row-major within a tile."""
    n = len(packed)
    if n == 0:
        return _empty_result()
    bits_f = float(bits)
    min_cont_f = float(np.float32(min_containment))

    def tile(si, sj, ai, aj, diag):
        counts = popcount_tile_counts(si, sj).to(torch.float32)
        cont = _containment(counts, ai, aj, bits_f)
        mask = cont >= min_cont_f
        if diag:
            mask &= torch.ones_like(mask).triu_(1)
        hit = torch.nonzero(mask)
        vals = cont[hit[:, 0], hit[:, 1]].cpu().numpy()
        hit = hit.cpu().numpy()
        return hit[:, 0], hit[:, 1], vals

    stream = _streamer(packed, np.asarray(sizes).astype(np.float32), block,
                       device)
    return _sweep(stream, stream, n, n, triangle=True, tile=tile,
                  block=block, k=k)
