"""Vectorized MurmurHash3 x64_128 over fixed-length keys.

Mash (and finch, whose exact distances the reference golden-tests,
src/finch.rs:107-129) hash each canonical k-mer's byte string with
MurmurHash3_x64_128 and keep the low 64 bits. This module reproduces
that bit-for-bit, vectorized with NumPy over N keys at once, using
in-place ops to avoid allocation churn on multi-million-key batches.

The C++ native extension provides the same function; this is the
portable fallback and the parity oracle for tests.

The port's own copy of galah_tpu/sketch/murmur3.py, so that the port
imports nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

import numpy as np

_C1 = np.uint64(0x87C37B91114253D5)
_C2 = np.uint64(0x4CF5AD432745937F)
_F1 = np.uint64(0xFF51AFD7ED558CCD)
_F2 = np.uint64(0xC4CEB9FE1A85EC53)
_U64 = np.uint64


def _rotl64_(x: np.ndarray, r: int, tmp: np.ndarray) -> None:
    """x = rotl(x, r) in place, using tmp as scratch."""
    np.right_shift(x, _U64(64 - r), out=tmp)
    x <<= _U64(r)
    x |= tmp


def _fmix64_(k: np.ndarray, tmp: np.ndarray) -> None:
    np.right_shift(k, _U64(33), out=tmp)
    k ^= tmp
    k *= _F1
    np.right_shift(k, _U64(33), out=tmp)
    k ^= tmp
    k *= _F2
    np.right_shift(k, _U64(33), out=tmp)
    k ^= tmp


def _le_u64(block: np.ndarray, out: np.ndarray, tmp: np.ndarray) -> None:
    """(N, 8) uint8 -> (N,) uint64 little-endian, into out."""
    out[:] = 0
    for i in range(8):
        np.left_shift(block[:, i].astype(np.uint64), _U64(8 * i), out=tmp)
        out |= tmp


def murmur3_x64_128(keys: np.ndarray, seed: int = 0) -> np.ndarray:
    """Hash N fixed-length keys; returns (N,) uint64 (the h1 half).

    keys: (N, L) uint8 array; every row is one key of length L.
    """
    if keys.ndim != 2:
        raise ValueError("keys must be (N, L) uint8")
    n, length = keys.shape
    nblocks = length // 16

    with np.errstate(over="ignore"):
        h1 = np.full(n, seed, dtype=np.uint64)
        h2 = np.full(n, seed, dtype=np.uint64)
        k1 = np.empty(n, dtype=np.uint64)
        k2 = np.empty(n, dtype=np.uint64)
        tmp = np.empty(n, dtype=np.uint64)

        for b in range(nblocks):
            _le_u64(keys[:, b * 16 : b * 16 + 8], k1, tmp)
            _le_u64(keys[:, b * 16 + 8 : b * 16 + 16], k2, tmp)

            k1 *= _C1
            _rotl64_(k1, 31, tmp)
            k1 *= _C2
            h1 ^= k1

            _rotl64_(h1, 27, tmp)
            h1 += h2
            h1 *= _U64(5)
            h1 += _U64(0x52DCE729)

            k2 *= _C2
            _rotl64_(k2, 33, tmp)
            k2 *= _C1
            h2 ^= k2

            _rotl64_(h2, 31, tmp)
            h2 += h1
            h2 *= _U64(5)
            h2 += _U64(0x38495AB5)

        tail = keys[:, nblocks * 16 :]
        rem = length & 15
        if rem > 0:
            k1[:] = 0
            k2[:] = 0
            for i in range(min(rem, 8)):
                np.left_shift(tail[:, i].astype(np.uint64), _U64(8 * i), out=tmp)
                k1 |= tmp
            for i in range(8, rem):
                np.left_shift(tail[:, i].astype(np.uint64), _U64(8 * (i - 8)), out=tmp)
                k2 |= tmp
            if rem > 8:
                k2 *= _C2
                _rotl64_(k2, 33, tmp)
                k2 *= _C1
                h2 ^= k2
            k1 *= _C1
            _rotl64_(k1, 31, tmp)
            k1 *= _C2
            h1 ^= k1

        h1 ^= _U64(length)
        h2 ^= _U64(length)
        h1 += h2
        h2 += h1
        _fmix64_(h1, tmp)
        _fmix64_(h2, tmp)
        h1 += h2
        # (h2 += h1 would give the high half; not needed for 64-bit use)

    return h1
