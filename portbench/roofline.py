"""The yardstick of the rooflines: the card's peak and the bytes each
layer's kernels need for the cell's corpus, counted from what the
generator wrote (unit lengths, families, the configuration's sketch
rules), never from the program's counters or launch shapes.

Each input byte is counted read once and each output byte written
once, whatever a kernel reads again (the principle of
``chip_smoke.py::_counts_bound`` and ``_k7_bound``).
"""

from __future__ import annotations

from typing import Iterable

from portbench.corpus import Corpus, expected_hashes

# NVIDIA H100 SXM, 80 GB HBM3: published bandwidth (data sheet, at the
# full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12


def _sum(xs: Iterable[float]) -> float:
    return float(sum(xs))


def prefilter_bits(sketch: dict, max_file_bytes: int) -> int:
    """The screen's row width: the configured width, or for genomes
    (``shrink``) the smallest power of two over 16 bits a genome-scale
    hash of the largest file, floored at 2^13 and capped at the
    configured width."""
    bits = int(sketch["prefilter_bits"])
    if not sketch.get("shrink"):
        return bits
    need = (max_file_bytes // int(sketch["genome_scale"]) + 1) * 16
    return min(bits, 1 << max(int(need - 1).bit_length(), 13))


def _contig_lengths(corpus: Corpus):
    for u in corpus.units:
        yield from (u.contig_lengths or [u.length])


def sketch_bytes(corpus: Corpus, sketch: dict) -> float:
    """K5: every base read once (one byte), every kept hash written once
    as an int32 bucket: fragment-scale and genome-scale hashes."""
    k = int(sketch["k"])
    bases = corpus.total_bases()
    kept = _sum(expected_hashes(n, k, int(sketch["fragment_scale"]))
                + expected_hashes(n, k, int(sketch["genome_scale"]))
                for n in _contig_lengths(corpus))
    return bases + 4.0 * kept


def screen_bytes(corpus: Corpus, sketch: dict, max_file_bytes: int) -> float:
    """K1 and K6 together: each unit's packed prefilter row read once,
    each within-family pair's hit (flat index and value, 8 bytes)
    written once."""
    row = prefilter_bits(sketch, max_file_bytes) / 8
    hits = corpus.within_family_directed_pairs() / 2
    return len(corpus.units) * row + 8.0 * hits


def verify_bytes(corpus: Corpus, sketch: dict, member_bits: int) -> float:
    """K7 and K8 together, over the within-family pairs: each unit's
    fragment stream (int32 buckets) and its offsets read once, each
    unit's member bitmap row read once, and each directed pair's ANI and
    AF (two float32) written once."""
    k = int(sketch["k"])
    L = int(sketch["fragment_length"])
    scale = int(sketch["fragment_scale"])
    stream = 0.0
    rows = 0
    for fam in corpus.families:
        if len(fam) < 2:
            continue
        for u in fam:
            cl = corpus.units[u].contig_lengths or [corpus.units[u].length]
            frags = sum(max(1, n // L) for n in cl)
            stream += 4.0 * _sum(expected_hashes(n, k, scale) for n in cl)
            stream += 4.0 * (frags + 1)
            rows += 1
    return stream + rows * member_bits / 8 + 8.0 * \
        corpus.within_family_directed_pairs()


def share(bytes_moved: float, device_seconds: float):
    """% of the byte bound that `device_seconds` reaches; None without
    device time."""
    if not device_seconds or device_seconds <= 0:
        return None
    return 100.0 * (bytes_moved / HBM_BYTES_PER_S) / device_seconds
