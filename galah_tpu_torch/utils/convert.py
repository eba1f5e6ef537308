"""Host numpy <-> torch conversions for sketch state.

torch's uint32 supports too few operations to rely on, so packed bitmap
words live in int32 tensors that hold the same bits. A bit test is
`(w >> s) & 1`, exact under torch's arithmetic shift too, and the CUDA
kernels read the same memory as `const uint32_t*`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from galah_tpu_torch.sketch.fracminhash import NativeSketch, NativeSketchParams


def words_to_torch(words: np.ndarray) -> torch.Tensor:
    """(..., W) uint32 words -> int32 CPU tensor holding the same bits
    (a view, no copy, when `words` is contiguous)."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    return torch.from_numpy(words.view(np.int32))


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array on `device`. A CUDA copy goes through pinned host
    memory without blocking: a pageable copy would wait for every kernel
    queued before it, and the screen keeps tiles in flight."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of values in [0, 2^32) -> int32 with the same low
    32 bits (exact two's-complement reinterpretation)."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def pack_indicator(buckets: np.ndarray, bits: int) -> np.ndarray:
    """Sorted distinct bucket indices -> (bits/32,) uint32 bitmap,
    word-major bit-minor (bucket b sets bit b % 32 of word b // 32).
    Same layout as the JAX package's ops/popcount_screen.py
    pack_indicator."""
    words = np.zeros(bits // 32, dtype=np.uint32)
    np.bitwise_or.at(
        words, buckets >> 5, np.uint32(1) << (buckets & 31).astype(np.uint32)
    )
    return words


@dataclass(frozen=True)
class SketchTensors:
    """One sketch's query-side verify stream on a device."""

    frag_buckets: torch.Tensor  # (N,) int32 member buckets, fragment-major
    frag_offsets: torch.Tensor  # (F+1,) int32 offsets into frag_buckets


def sketch_tensors(sk: NativeSketch, device: torch.device) -> SketchTensors:
    """Upload a host sketch's fragment stream to `device`."""
    return SketchTensors(
        frag_buckets=torch.from_numpy(
            np.ascontiguousarray(sk.frag_buckets, dtype=np.int32)
        ).to(device),
        frag_offsets=torch.from_numpy(
            np.ascontiguousarray(sk.frag_offsets, dtype=np.int32)
        ).to(device),
    )


def native_sketch_from_fields(sk) -> NativeSketch:
    """The port's NativeSketch holding the same state as `sk`, any
    object with NativeSketch's fields (a sketch made by the JAX package,
    say): its name, length and numpy arrays, and its params read field
    by field into the port's NativeSketchParams."""
    params = None
    if sk.params is not None:
        params = NativeSketchParams(**{
            f.name: getattr(sk.params, f.name)
            for f in dataclasses.fields(NativeSketchParams)
        })
    return NativeSketch(
        name=sk.name,
        total_len=int(sk.total_len),
        prefilter_buckets=np.asarray(sk.prefilter_buckets),
        frag_buckets=np.asarray(sk.frag_buckets),
        frag_offsets=np.asarray(sk.frag_offsets),
        member_buckets=np.asarray(sk.member_buckets),
        params=params,
    )
