"""Canonical k-mer extraction.

Converts raw sequence bytes into canonical 2-bit-packed k-mer integers
(k <= 31 fits in a uint64). Canonical = min(kmer, revcomp(kmer)) in
lexicographic byte order, which for the A<C<G<T alphabet equals numeric
order on the 2-bit packing — so canonical selection is one integer min.

K-mers containing non-ACGT characters are skipped, matching Mash/finch
semantics (the distance golden in the reference, src/finch.rs:107-129,
depends on this).

The port's own copy of galah_tpu/sketch/kmers.py, so that the port
imports nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

import numpy as np

# Base byte -> 2-bit code; 255 marks invalid.
_CODE_LUT = np.full(256, 255, dtype=np.uint8)
for _b, _c in ((ord("A"), 0), (ord("C"), 1), (ord("G"), 2), (ord("T"), 3)):
    _CODE_LUT[_b] = _c
    _CODE_LUT[_b + 32] = _c  # lowercase

_DECODE_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)

_CHUNK = 1 << 20


def encode_bases(seq: bytes) -> np.ndarray:
    """Sequence bytes -> (L,) uint8 2-bit codes (255 for non-ACGT)."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    return _CODE_LUT[arr]


def canonical_kmers(seq: bytes, k: int) -> np.ndarray:
    """All valid canonical k-mers of one sequence as uint64 (with
    duplicates, in sequence order)."""
    return canonical_kmers_with_positions(seq, k)[0]


def canonical_kmers_with_positions(seq: bytes, k: int):
    """Like canonical_kmers but also returns the start positions of the
    valid k-mers. Used by the native engine to assign k-mers to
    fragments for the fragment-containment ANI stage."""
    if k > 31:
        raise ValueError("k must be <= 31 to fit 2 bits/base in uint64")
    code = encode_bases(seq)
    n = len(code) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.int64)

    bad = (code == 255).astype(np.int32)
    bad_csum = np.concatenate([[0], np.cumsum(bad)])
    valid = (bad_csum[k:] - bad_csum[:-k]) == 0
    if not valid.any():
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.int64)

    code64 = (code & np.uint8(3)).astype(np.uint64)
    rc_code64 = np.uint64(3) - code64
    two = np.uint64(2)
    fwd = np.zeros(n, dtype=np.uint64)
    rev = np.zeros(n, dtype=np.uint64)
    for j in range(k):
        fwd <<= two
        fwd |= code64[j : j + n]
    for j in range(k - 1, -1, -1):
        rev <<= two
        rev |= rc_code64[j : j + n]
    np.minimum(fwd, rev, out=fwd)
    positions = np.nonzero(valid)[0].astype(np.int64)
    return fwd[valid], positions


def distinct_canonical_kmers(seqs, k: int) -> np.ndarray:
    """Distinct canonical k-mers across all sequences, sorted ascending."""
    parts = [canonical_kmers(s, k) for s in seqs]
    parts = [p for p in parts if p.size]
    if not parts:
        return np.empty(0, dtype=np.uint64)
    return np.unique(np.concatenate(parts))


def decode_kmers(kmers: np.ndarray, k: int) -> np.ndarray:
    """(N,) uint64 packed k-mers -> (N, k) uint8 ACGT bytes."""
    n = kmers.shape[0]
    out = np.empty((n, k), dtype=np.uint8)
    for j in range(k):
        shift = np.uint64(2 * (k - 1 - j))
        out[:, j] = _DECODE_LUT[((kmers >> shift) & np.uint64(3)).astype(np.uint8)]
    return out
