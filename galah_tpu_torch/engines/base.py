"""The plugin interfaces of the framework.

Python equivalents of the reference's trait layer (src/lib.rs:29-76):
PreclusterDistanceFinder, ClusterDistanceFinder, QualityFinder,
TrnaFinder, RrnaFinder. One TPU-motivated extension: clusterers expose a
batched ANI entry point (`calculate_ani_batch`) because on-device pair
evaluation is cheaper in batches than the reference's one-subprocess-
per-pair model (src/clusterer.rs:276-296 short-circuits sequentially;
on TPU evaluating the whole candidate batch at once is faster).

The port's own copy of galah_tpu/engines/base.py, so that the port
imports nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

import abc
from typing import List, Optional, Sequence, Tuple

from galah_tpu_torch.cluster.cache import SortedPairDistanceCache


class PreclusterDistanceFinder(abc.ABC):
    @abc.abstractmethod
    def distances(self, genome_fasta_paths: Sequence[str]) -> SortedPairDistanceCache:
        ...

    @abc.abstractmethod
    def distances_contigs(
        self, genome_fasta_paths: Sequence[str], contig_names: Sequence[str]
    ) -> SortedPairDistanceCache:
        ...

    @abc.abstractmethod
    def distances_with_references(
        self, genome_fasta_paths: Sequence[str], reference_genomes: Sequence[str]
    ) -> SortedPairDistanceCache:
        ...

    @abc.abstractmethod
    def method_name(self) -> str:
        ...


class ClusterDistanceFinder(abc.ABC):
    def initialise(self) -> None:
        pass

    @abc.abstractmethod
    def method_name(self) -> str:
        ...

    @abc.abstractmethod
    def get_ani_threshold(self) -> float:
        """Threshold as a percentage (e.g. 95.0)."""

    @abc.abstractmethod
    def calculate_ani(self, fasta1: str, fasta2: str) -> Optional[float]:
        ...

    def calculate_ani_batch(
        self, pairs: Sequence[Tuple[str, str]]
    ) -> List[Optional[float]]:
        """Batched pair ANI; default implementation loops. Device-backed
        engines override this to evaluate all pairs in one dispatch."""
        return [self.calculate_ani(a, b) for a, b in pairs]


class QualityFinder(abc.ABC):
    @abc.abstractmethod
    def prepare_comp_cont(
        self, genome_paths: Sequence[str], threads: int, tmp_path: str
    ) -> None:
        ...

    @abc.abstractmethod
    def find_comp_cont(self, genome_path: str) -> Tuple[float, float]:
        """(completeness, contamination), percentages 0-100."""

    @abc.abstractmethod
    def method_name(self) -> str:
        ...


class TrnaFinder(abc.ABC):
    @abc.abstractmethod
    def find_trnas(self, genome_path: str, tmp_path: str) -> int:
        ...

    @abc.abstractmethod
    def method_name(self) -> str:
        ...


class RrnaFinder(abc.ABC):
    @abc.abstractmethod
    def find_rrnas(self, genome_path: str, tmp_path: str) -> Tuple[int, int, int]:
        """(5S, 16S, 23S) counts."""

    @abc.abstractmethod
    def method_name(self) -> str:
        ...
