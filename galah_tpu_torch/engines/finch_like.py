"""Mash MinHash preclusterer with exact finch parity.

Reproduces the reference's finch backend (src/finch.rs:4-97) —
bit-identical hashes and distances (golden: ANI(1mbp,500kb) ==
0.9808188, src/finch.rs:107-129). Like the reference, it does not
support contig comparisons (returns an empty cache, src/finch.rs:26-33),
reference-genome mode (src/finch.rs:35-41), or low-memory mode
(src/finch.rs:14-15).

The O(n^2) pairwise loop runs over bottom-k sketches; for large n use
the native engine's tiled device kernel instead — this backend exists
for exact parity with the reference's finch numbers.

The port's own copy of galah_tpu/engines/finch_like.py, so that the port
imports nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

from galah_tpu_torch import defaults
from galah_tpu_torch.cluster.cache import SortedPairDistanceCache
from galah_tpu_torch.engines.base import PreclusterDistanceFinder
from galah_tpu_torch.sketch.minhash import mash_ani, sketch_file

logger = logging.getLogger(__name__)


class FinchPreclusterer(PreclusterDistanceFinder):
    supports_contigs = False

    def __init__(
        self,
        min_ani: float,
        num_kmers: int = defaults.MASH_NUM_HASHES,
        kmer_length: int = defaults.MASH_KMER_LENGTH,
        low_memory: bool = False,
        threads: int = 0,
    ) -> None:
        """min_ani is a fraction (0-1), as in the reference
        (src/finch.rs:5-6)."""
        self.min_ani = min_ani
        self.num_kmers = num_kmers
        self.kmer_length = kmer_length
        self.low_memory = low_memory
        self.threads = threads

    def distances(self, genome_fasta_paths: Sequence[str]) -> SortedPairDistanceCache:
        if self.low_memory:
            raise ValueError(
                "Low-memory clustering currently only supported with the native "
                "or skani preclusterer"
            )
        logger.info("Sketching MinHash representations of each genome ..")
        if self.threads and self.threads > 1 and len(genome_fasta_paths) > 1:
            with ThreadPoolExecutor(max_workers=self.threads) as ex:
                sketches = list(
                    ex.map(
                        lambda p: sketch_file(p, self.num_kmers, self.kmer_length),
                        genome_fasta_paths,
                    )
                )
        else:
            sketches = [
                sketch_file(p, self.num_kmers, self.kmer_length)
                for p in genome_fasta_paths
            ]
        logger.info("Finished sketching genomes")

        cache = SortedPairDistanceCache()
        for i in range(len(sketches)):
            for j in range(i + 1, len(sketches)):
                ani = mash_ani(sketches[i], sketches[j])
                logger.debug(
                    "Comparing %s and %s, distance %s",
                    genome_fasta_paths[i],
                    genome_fasta_paths[j],
                    ani,
                )
                if ani >= self.min_ani:
                    # f32 rounding parity with the reference's `as f32`
                    import numpy as np

                    cache.insert((i, j), float(np.float32(ani)))
        return cache

    def distances_contigs(self, genome_fasta_paths, contig_names):
        # Finch doesn't offer high-quality ANI with self-self comparisons
        # (src/finch.rs:26-33).
        return SortedPairDistanceCache()

    def distances_with_references(self, genome_fasta_paths, reference_genomes):
        raise ValueError(
            "Reference genome clustering currently only supported with the "
            "native or skani preclusterer"
        )

    def method_name(self) -> str:
        return "finch"
