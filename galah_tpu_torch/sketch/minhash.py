"""Mash-style bottom-k MinHash sketches and the Mash distance.

Exact behavioral parity with the reference's finch preclusterer
(src/finch.rs:48-97): k=21, 1000 hashes, MurmurHash3 x64_128 seed 0
over canonical k-mer byte strings, bottom-k of the distinct hash set,
Mash distance d = -ln(2j/(1+j))/k with j estimated over the bottom
`sketch_size` elements of the merged union. ANI = 1 - d
(src/finch.rs:78-86); pairs with ANI >= min_ani are kept.

The golden: distance(1mbp, 500kb) ANI == 0.9808188 (src/finch.rs:107-129).

The port's own copy of galah_tpu/sketch/minhash.py, so that the port
imports nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from galah_tpu_torch import defaults
from galah_tpu_torch.io.fasta import read_fasta_sequences
from galah_tpu_torch.sketch.kmers import decode_kmers, distinct_canonical_kmers
from galah_tpu_torch.sketch.murmur3 import murmur3_x64_128


@dataclass
class MashSketch:
    hashes: np.ndarray  # sorted ascending uint64, len <= sketch_size
    kmer_length: int
    sketch_size: int


def hash_kmer_set(kmers: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """Hash packed canonical k-mers via their byte-string form; returns
    the distinct hash set, sorted ascending."""
    if kmers.size == 0:
        return np.empty(0, dtype=np.uint64)
    keys = decode_kmers(kmers, k)
    h = murmur3_x64_128(keys, seed=seed)
    return np.unique(h)


def sketch_sequences(
    seqs: Sequence[bytes],
    sketch_size: int = defaults.MASH_NUM_HASHES,
    k: int = defaults.MASH_KMER_LENGTH,
    seed: int = defaults.MASH_HASH_SEED,
) -> MashSketch:
    kmers = distinct_canonical_kmers(seqs, k)
    hashes = hash_kmer_set(kmers, k, seed=seed)
    if hashes.size > sketch_size:
        bottom = np.partition(hashes, sketch_size - 1)[:sketch_size]
        bottom.sort()
        hashes = bottom
    return MashSketch(hashes=hashes, kmer_length=k, sketch_size=sketch_size)


def sketch_file(
    path: str,
    sketch_size: int = defaults.MASH_NUM_HASHES,
    k: int = defaults.MASH_KMER_LENGTH,
    seed: int = defaults.MASH_HASH_SEED,
) -> MashSketch:
    from galah_tpu_torch import native_ext

    if native_ext.available():
        f = native_ext.NativeFasta(path)
        hashes = f.mash_hashes(k, sketch_size, seed)
        return MashSketch(hashes=hashes, kmer_length=k, sketch_size=sketch_size)
    return sketch_sequences(read_fasta_sequences(path), sketch_size, k, seed)


def mash_jaccard(a: MashSketch, b: MashSketch) -> float:
    """Jaccard estimate over the bottom `sketch_size` of the union."""
    sketch_size = min(a.sketch_size, b.sketch_size)
    ha, hb = a.hashes, b.hashes
    union = np.union1d(ha, hb)
    bound = min(union.size, sketch_size)
    if bound == 0:
        return 0.0
    prefix = union[:bound]
    in_a = np.isin(prefix, ha, assume_unique=True)
    in_b = np.isin(prefix, hb, assume_unique=True)
    common = int(np.count_nonzero(in_a & in_b))
    return common / bound


def mash_distance(a: MashSketch, b: MashSketch) -> float:
    j = mash_jaccard(a, b)
    if j <= 0.0:
        return 1.0
    d = -math.log(2.0 * j / (1.0 + j)) / a.kmer_length
    return min(d, 1.0)


def mash_ani(a: MashSketch, b: MashSketch) -> float:
    """ANI = 1 - mash_distance, as the reference computes it
    (src/finch.rs:78-86)."""
    return 1.0 - mash_distance(a, b)
