"""Pairwise intersection counts between packed bitmap rows.

Counterpart of galah_tpu/ops/packed_matmul.py: out[i, j] =
popcount(a[i] AND b[j]) over (M, W) and (N, W) int32 tensors that hold
uint32 words. On a CUDA tensor the count runs in the hand-written kernel
csrc/packed_popcount.cu (unpack to int8 in shared memory + s8 wgmma); on
a CPU tensor in the plain torch version below. Counts are exact integers
either way.

Both count kernels (this one and csrc/popcount_screen.cu) tile the
output in 128 x 128 blocks and may split W across blocks so that a few
tiles still fill the card; `plan_split_k` picks that split.
"""

from __future__ import annotations

import functools
from collections import Counter
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

# Words unpacked per matmul step of the plain version: bounds the
# (rows, chunk * 32) float32 temporaries to ~64 MB per 1024 rows.
_REF_CHUNK_WORDS = 512


def packed_intersect_counts_reference(
    a: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Plain torch version: unpack K-chunks of words to 0/1 float32 and
    accumulate matmuls. Exact, because every count stays below 2^24."""
    _check(a, b)
    m, w = a.shape
    n = b.shape[0]
    out = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    shifts = torch.arange(32, dtype=torch.int32, device=a.device)
    for lo in range(0, w, _REF_CHUNK_WORDS):
        hi = min(w, lo + _REF_CHUNK_WORDS)
        au = ((a[:, lo:hi, None] >> shifts) & 1).to(torch.float32)
        bu = ((b[:, lo:hi, None] >> shifts) & 1).to(torch.float32)
        k = (hi - lo) * 32
        out += au.reshape(m, k) @ bu.reshape(n, k).T
    return out.to(torch.int32)


def packed_intersect_counts(a: torch.Tensor, b: torch.Tensor,
                            shard: Optional[int] = None) -> torch.Tensor:
    """(M, N) int32 intersection counts. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises. `shard`, the
    index of the sharded sweep's shard that issued the tile, is where
    the launch is also counted in `per_shard` (shards that share a card
    are told apart by it)."""
    _check(a, b)
    if a.device.type == "cpu":
        return packed_intersect_counts_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    from galah_tpu_torch.ops._build import load_library

    out = launch_counts(load_library().galah_packed_popcount, _launch_plan,
                        a, b)
    packed_intersect_counts.launches += 1
    if shard is not None:
        packed_intersect_counts.per_shard[shard] += 1
    return out


packed_intersect_counts.launches = 0
packed_intersect_counts.per_shard = Counter()

# The kernel's tile, K-panel and blocks per SM (csrc/packed_popcount.cu:
# 81 KiB of shared memory and <= 128 registers a thread, two blocks an
# SM).
K1_TILE = 128
K1_PANEL_WORDS = 4
K1_BLOCKS_PER_SM = 2


@dataclass(frozen=True)
class LaunchPlan:
    grid: Tuple[int, int, int]     # (column tiles, row tiles, W splits)
    splits: int
    split_words: int               # W words per split, panel-aligned
    ranges: Tuple[Tuple[int, int], ...]  # each split's [lo, hi) words


def plan_split_k(m: int, n: int, w: int, sms: int, *, tile: int,
                 panel_words: int, blocks_per_sm: int) -> LaunchPlan:
    """Grid and W split of a count kernel with `tile`-square output
    blocks and `panel_words`-word K-panels on a card of `sms` SMs.

    W is cut into the most panel-aligned ranges whose blocks still fit
    one wave (tiles x splits <= sms x blocks_per_sm), each range as even
    as the panels allow and none empty."""
    tiles = -(-m // tile) * -(-n // tile)
    panels = -(-w // panel_words)
    most = max(1, min(panels, sms * blocks_per_sm // max(tiles, 1)))
    split_words = max(1, -(-panels // most)) * panel_words
    splits = max(1, -(-w // split_words))
    ranges = tuple((lo, min(w, lo + split_words))
                   for lo in range(0, max(w, 1), split_words))
    return LaunchPlan(grid=(-(-n // tile), -(-m // tile), splits),
                      splits=splits, split_words=split_words, ranges=ranges)


@functools.lru_cache(maxsize=1024)
def _launch_plan(m: int, n: int, w: int, sms: int) -> LaunchPlan:
    return plan_split_k(m, n, w, sms, tile=K1_TILE,
                        panel_words=K1_PANEL_WORDS,
                        blocks_per_sm=K1_BLOCKS_PER_SM)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_counts(entry, plan_fn, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Launch a count kernel's C entry on (a, b) as plan_fn plans it; the
    (M, N) int32 counts. The output is zeroed when W is split (the splits
    add into it). Raises with the CUDA error if the launch is refused."""
    m, w = a.shape
    n = b.shape[0]
    plan = plan_fn(m, n, w, sm_count(a.device))
    alloc = torch.zeros if plan.splits > 1 else torch.empty
    out = alloc((m, n), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = entry(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, w,
                    plan.split_words, stream)
    if err != 0:
        raise RuntimeError(
            f"{entry.__name__} launch failed: CUDA error {err} "
            f"(m={m}, n={n}, w={w}, grid={plan.grid})"
        )
    return out


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(
            f"packed rows must be 2-D, got {tuple(a.shape)} and {tuple(b.shape)}"
        )
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(
            f"packed words must be int32, got {a.dtype} and {b.dtype}"
        )
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, {b.device}")
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"word width mismatch: {a.shape[1]} vs {b.shape[1]}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("packed rows must be contiguous")
