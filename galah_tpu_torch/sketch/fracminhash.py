"""FracMinHash sketching for the native TPU engine.

The native engine replaces the reference's external skani/fastANI
processes (src/skani.rs, src/fastani.rs) with an on-device two-stage
estimator:

1. genome-level FracMinHash (keep hashes h < 2**64/scale) packed into a
   fixed-width bucket indicator — the all-vs-all screen runs as a
   blocked indicator matmul on the MXU;
2. fragment-level denser FracMinHash, assigned to fixed-length
   fragments — per-fragment containment against the other genome's
   membership bitmap yields per-fragment identity, giving ANI and a
   fragment-count aligned fraction with the same combination semantics
   galah uses for fastANI (bidirectional max ANI, either-direction AF
   pass; src/fastani.rs:31-73).

The hash is splitmix64's finalizer over the packed canonical k-mer —
cheap, statistically strong, and identical across the numpy, C++ and
device implementations.

The port's own copy of galah_tpu/sketch/fracminhash.py, so that the port
imports nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from galah_tpu_torch import defaults
from galah_tpu_torch.io.fasta import read_fasta
from galah_tpu_torch.sketch.kmers import canonical_kmers_with_positions

_U64 = np.uint64
_M1 = _U64(0xBF58476D1CE4E5B9)
_M2 = _U64(0x94D049BB133111EB)


def mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, in place on a copy; maps packed k-mers to
    uniform uint64 hashes."""
    h = x.copy()
    tmp = np.empty_like(h)
    with np.errstate(over="ignore"):
        np.right_shift(h, _U64(30), out=tmp)
        h ^= tmp
        h *= _M1
        np.right_shift(h, _U64(27), out=tmp)
        h ^= tmp
        h *= _M2
        np.right_shift(h, _U64(31), out=tmp)
        h ^= tmp
    return h


def _scale_threshold(scale: int) -> np.uint64:
    """Keep hashes h < 2**64/scale; scale 1 keeps everything."""
    if scale <= 1:
        return _U64(2**64 - 1)
    return _U64(2**64 // scale)


@dataclass(frozen=True)
class NativeSketchParams:
    k: int = defaults.NATIVE_KMER_LENGTH
    genome_scale: int = defaults.NATIVE_SCALE
    fragment_scale: int = defaults.NATIVE_FRAGMENT_SCALE
    fragment_length: int = defaults.DEFAULT_FRAGMENT_LENGTH
    prefilter_bits: int = defaults.NATIVE_PREFILTER_BITS
    member_bits: int = defaults.NATIVE_MEMBER_BITS
    # A fragment participates in ANI estimation only if it carries at
    # least this many sampled hashes (guards against N-runs).
    min_fragment_hashes: int = 8
    # Minimum sequence length to emit a (single, short) fragment.
    min_fragment_length: int = 100

    @property
    def genome_threshold(self) -> np.uint64:
        return _scale_threshold(self.genome_scale)

    @property
    def fragment_threshold(self) -> np.uint64:
        return _scale_threshold(self.fragment_scale)


def small_genome_params(fragment_length: Optional[int] = None) -> NativeSketchParams:
    """Denser sampling for sequences < 20kb (--small-genomes; the
    reference forwards this to skani's dense-marker preset,
    src/skani.rs:152-154)."""
    return NativeSketchParams(
        genome_scale=defaults.NATIVE_SMALL_SCALE,
        fragment_scale=defaults.NATIVE_SMALL_FRAGMENT_SCALE,
        fragment_length=fragment_length or 1000,
        prefilter_bits=defaults.NATIVE_SMALL_PREFILTER_BITS,
        member_bits=defaults.NATIVE_SMALL_MEMBER_BITS,
        min_fragment_hashes=8,
    )


@dataclass
class NativeSketch:
    """Per-genome (or per-contig) sketch data for both stages."""

    name: str
    total_len: int
    # Stage 1: distinct prefilter bucket indices (int32, sorted) over
    # `prefilter_bits` buckets.
    prefilter_buckets: np.ndarray
    # Stage 2 query side: flattened fragment hash buckets over
    # `member_bits` buckets, deduped within fragment.
    frag_buckets: np.ndarray      # (N,) int32
    frag_offsets: np.ndarray      # (F+1,) int64 into frag_buckets
    # Stage 2 ref side: distinct membership buckets (int32, sorted).
    member_buckets: np.ndarray    # (M,) int32
    params: NativeSketchParams = field(repr=False, default=None)

    @property
    def n_fragments(self) -> int:
        return len(self.frag_offsets) - 1

    @property
    def n_prefilter(self) -> int:
        return len(self.prefilter_buckets)

    @property
    def member_popcount(self) -> int:
        return len(self.member_buckets)

    def member_bitmap_words(self) -> np.ndarray:
        """(member_bits/32,) uint32 packed membership bitmap."""
        words = np.zeros(self.params.member_bits // 32, dtype=np.uint32)
        b = self.member_buckets
        np.bitwise_or.at(
            words, b >> 5, (np.uint32(1) << (b & 31).astype(np.uint32))
        )
        return words

    def prefilter_indicator(self) -> np.ndarray:
        """(prefilter_bits,) uint8 0/1 indicator row."""
        row = np.zeros(self.params.prefilter_bits, dtype=np.uint8)
        row[self.prefilter_buckets] = 1
        return row


def _fragment_boundaries(length: int, params: NativeSketchParams) -> np.ndarray:
    """Fragment start offsets within one contig. Full windows of
    fragment_length; a trailing remainder >= L/2 becomes its own
    fragment; contigs shorter than L yield one fragment when >=
    min_fragment_length."""
    L = params.fragment_length
    if length < L:
        if length >= params.min_fragment_length:
            return np.array([0, length], dtype=np.int64)
        return np.array([0], dtype=np.int64)  # no fragments
    nfull = length // L
    rem = length - nfull * L
    bounds = [i * L for i in range(nfull + 1)]
    if rem >= L // 2:
        bounds.append(length)
    return np.asarray(bounds, dtype=np.int64)


def sketch_sequences_native(
    name: str,
    seqs: Sequence[bytes],
    params: NativeSketchParams,
) -> NativeSketch:
    k = params.k
    gthresh = params.genome_threshold
    fthresh = params.fragment_threshold
    member_mask = _U64(params.member_bits - 1)
    pref_mask = _U64(params.prefilter_bits - 1)

    pref_parts: List[np.ndarray] = []
    member_parts: List[np.ndarray] = []
    fragkey_parts: List[np.ndarray] = []  # frag_global_id * member_bits + bucket
    frag_base = 0
    frag_counts_per_contig: List[int] = []

    for seq in seqs:
        kmers, positions = canonical_kmers_with_positions(seq, k)
        bounds = _fragment_boundaries(len(seq), params)
        nfrag = max(0, len(bounds) - 1)
        frag_counts_per_contig.append(nfrag)
        if kmers.size:
            h = mix64(kmers)
            fmask = h < fthresh
            hf = h[fmask]
            if hf.size:
                buckets = (hf & member_mask).astype(np.int64)
                member_parts.append(buckets)
                if nfrag > 0:
                    pos_f = positions[fmask]
                    # fragment id by start position; kmers spanning a
                    # boundary belong to the fragment of their start
                    frag_id = np.searchsorted(bounds, pos_f, side="right") - 1
                    inb = frag_id < nfrag  # kmers past last boundary dropped
                    key = (frag_id[inb] + frag_base) * np.int64(
                        params.member_bits
                    ) + buckets[inb]
                    fragkey_parts.append(key)
            gmask = h < gthresh
            hg = h[gmask]
            if hg.size:
                pref_parts.append((hg & pref_mask).astype(np.int64))
        frag_base += nfrag

    total_frags = frag_base
    member_buckets = (
        np.unique(np.concatenate(member_parts)).astype(np.int32)
        if member_parts
        else np.empty(0, dtype=np.int32)
    )
    prefilter_buckets = (
        np.unique(np.concatenate(pref_parts)).astype(np.int32)
        if pref_parts
        else np.empty(0, dtype=np.int32)
    )

    if fragkey_parts:
        keys = np.unique(np.concatenate(fragkey_parts))
        frag_ids = (keys // params.member_bits).astype(np.int64)
        frag_buckets = (keys % params.member_bits).astype(np.int32)
        counts = np.bincount(frag_ids, minlength=total_frags).astype(np.int64)
        frag_offsets = np.concatenate([[0], np.cumsum(counts)])
    else:
        frag_buckets = np.empty(0, dtype=np.int32)
        frag_offsets = np.zeros(total_frags + 1, dtype=np.int64)

    return NativeSketch(
        name=name,
        total_len=sum(len(s) for s in seqs),
        prefilter_buckets=prefilter_buckets,
        frag_buckets=frag_buckets,
        frag_offsets=frag_offsets,
        member_buckets=member_buckets,
        params=params,
    )


def _from_raw(name: str, raw: dict, params: NativeSketchParams) -> NativeSketch:
    return NativeSketch(
        name=name,
        total_len=raw["total_len"],
        prefilter_buckets=raw["prefilter_buckets"],
        frag_buckets=raw["frag_buckets"],
        frag_offsets=raw["frag_offsets"],
        member_buckets=raw["member_buckets"],
        params=params,
    )


def sketch_file_native(path: str, params: NativeSketchParams) -> NativeSketch:
    from galah_tpu_torch import native_ext

    if native_ext.available():
        f = native_ext.NativeFasta(path)
        raw = f.native_sketch(0, params)
        return _from_raw(path, raw[0], params)
    seqs = [rec.seq for rec in read_fasta(path)]
    return sketch_sequences_native(path, seqs, params)


def sketch_contigs_native(
    path: str, params: NativeSketchParams, threads: int = 1
) -> List[NativeSketch]:
    """One sketch per contig (for --cluster-contigs; the reference runs
    `skani triangle -i`, src/skani.rs:379-498). Contig names follow the
    reference's tab-split rule. `threads` parallelizes sketching across
    contigs in the native library (deterministic: each contig's sketch
    is independent and lands at its fixed index)."""
    from galah_tpu_torch import native_ext

    if native_ext.available():
        f = native_ext.NativeFasta(path)
        raws = f.native_sketch(1, params, threads=threads)
        return [
            _from_raw(f.name(i).split("\t")[0], raw, params)
            for i, raw in enumerate(raws)
        ]
    out = []
    for rec in read_fasta(path):
        out.append(sketch_sequences_native(rec.contig_name, [rec.seq], params))
    return out
