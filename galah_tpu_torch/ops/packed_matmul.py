"""Pairwise intersection counts between packed bitmap rows.

Counterpart of galah_tpu/ops/packed_matmul.py: out[i, j] =
popcount(a[i] AND b[j]) over (M, W) and (N, W) int32 tensors that hold
uint32 words. On a CUDA tensor the count runs in the hand-written kernel
csrc/packed_popcount.cu; on a CPU tensor in the plain torch version
below. Counts are exact integers either way.
"""

from __future__ import annotations

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


def packed_intersect_counts(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, N) int32 intersection counts. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    _check(a, b)
    if a.device.type == "cpu":
        return packed_intersect_counts_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    from galah_tpu_torch.ops._build import load_library

    m, w = a.shape
    n = b.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.galah_packed_popcount(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, w, stream
        )
    if err != 0:
        raise RuntimeError(
            f"galah_packed_popcount launch failed: CUDA error {err} "
            f"(m={m}, n={n}, w={w})"
        )
    packed_intersect_counts.launches += 1
    return out


packed_intersect_counts.launches = 0


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
