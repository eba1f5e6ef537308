"""Genome assembly statistics: contig count, ambiguous bases, N50.

Behavioral parity with the reference (src/genome_stats.rs:11-51):
- ambiguous bases are literal 'N'/'n' counts (not all non-ACGT);
- N50 is computed over contig lengths sorted *ascending*, taking the
  first length at which the cumulative sum reaches total_length/2
  (integer division).

The port's own copy of galah_tpu/io/genome_stats.py, so that the port
imports nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from galah_tpu_torch.io.fasta import read_fasta


@dataclass(frozen=True)
class GenomeAssemblyStats:
    num_contigs: int
    num_ambiguous_bases: int
    n50: int


def calculate_genome_stats(fasta_path: str) -> GenomeAssemblyStats:
    from galah_tpu_torch import native_ext

    if native_ext.available():
        f = native_ext.NativeFasta(fasta_path)
        num_contigs, num_ambiguous, n50 = f.genome_stats()
        if num_contigs == 0 or (n50 == 0 and num_contigs > 0):
            raise ValueError(f"Failed to calculate N50 from {fasta_path}")
        return GenomeAssemblyStats(num_contigs, num_ambiguous, n50)

    num_contigs = 0
    num_ambiguous = 0
    contig_lengths = []
    total_length = 0

    for rec in read_fasta(fasta_path):
        num_contigs += 1
        arr = np.frombuffer(rec.seq, dtype=np.uint8)
        num_ambiguous += int(np.count_nonzero((arr == ord("N")) | (arr == ord("n"))))
        contig_lengths.append(len(rec.seq))
        total_length += len(rec.seq)

    contig_lengths.sort()
    n50_cutoff = total_length // 2
    n50 = None
    acc = 0
    for length in contig_lengths:
        acc += length
        if acc >= n50_cutoff:
            n50 = length
            break
    if n50 is None:
        raise ValueError(f"Failed to calculate N50 from {fasta_path}")

    return GenomeAssemblyStats(
        num_contigs=num_contigs,
        num_ambiguous_bases=num_ambiguous,
        n50=n50,
    )
