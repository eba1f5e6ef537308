"""Embeddable library API.

The reference is consumed as a library by CoverM through its
GalahClustererCommandDefinition indirection
(src/cluster_argument_parsing.rs:117-169, 1538); this module is the
equivalent surface for Python embedders: construct engines and run the
greedy clustering without touching the CLI.

Each entry point takes `device`, where its native engines run: None
resolves it as the CLI does (utils/device.py), so the API runs on the
card unless the caller passes torch.device("cpu") or sets
GALAH_TPU_PLATFORM=cpu, and stops without a CUDA device otherwise. The
finch, skani and fastANI methods never touch the device.

The port's own copy of galah_tpu/api.py, so that the port imports
nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from galah_tpu_torch import defaults


@dataclass
class ClusterParameters:
    ani: float = defaults.DEFAULT_ANI                       # percent
    precluster_ani: float = defaults.DEFAULT_PRETHRESHOLD_ANI
    min_aligned_fraction: float = defaults.DEFAULT_ALIGNED_FRACTION
    fragment_length: Optional[int] = None  # None: engine default (3000, or 1000 with small_genomes)
    precluster_method: str = defaults.DEFAULT_PRECLUSTER_METHOD
    cluster_method: str = defaults.DEFAULT_CLUSTER_METHOD
    small_genomes: bool = False
    low_memory: bool = False
    threads: int = 4


@dataclass
class ClusterResult:
    clusters: List[List[int]]          # indices into `genomes`, rep first
    genomes: List[str]                 # the (priority-ordered) inputs

    @property
    def representatives(self) -> List[str]:
        return [self.genomes[c[0]] for c in self.clusters]

    def memberships(self) -> List[List[str]]:
        return [[self.genomes[i] for i in c] for c in self.clusters]


def cluster_genomes(
    genome_fasta_paths: Sequence[str],
    params: Optional[ClusterParameters] = None,
    reference_genomes: Optional[Sequence[str]] = None,
    device: Optional[torch.device] = None,
) -> ClusterResult:
    """Dereplicate genomes given in priority order (highest quality
    first — order the list yourself or use
    galah_tpu_torch.quality.filter.filter_and_order_genomes).

    Returns clusters of indices with the representative first, exactly
    the reference's `clusterer::cluster` contract (src/clusterer.rs:14-21).
    """
    p = params or ClusterParameters()
    from galah_tpu_torch.cluster.greedy import cluster as run_clustering

    pre, clu = _build_engines(p, device)
    genomes = list(genome_fasta_paths)
    clusters = run_clustering(
        genomes,
        pre,
        clu,
        reference_genomes=list(reference_genomes) if reference_genomes else None,
    )
    return ClusterResult(clusters=clusters, genomes=genomes)


def cluster_contigs(
    fasta_paths: Sequence[str],
    params: Optional[ClusterParameters] = None,
    device: Optional[torch.device] = None,
) -> "ContigClusterResult":
    """Cluster individual contigs across the given FASTA files
    (--cluster-contigs). params.small_genomes selects the dense
    small-sequence presets (recommended below 20kb)."""
    p = params or ClusterParameters()
    from galah_tpu_torch.cluster.greedy import cluster as run_clustering
    from galah_tpu_torch.io.fasta import read_fasta

    contig_names: List[str] = []
    seen = set()
    for path in fasta_paths:
        for rec in read_fasta(path):
            if rec.contig_name in seen:
                raise ValueError(
                    f"Duplicate contig name found in file '{path}': {rec.contig_name}"
                )
            seen.add(rec.contig_name)
            contig_names.append(rec.contig_name)

    pre, clu = _build_engines(p, device)
    clusters = run_clustering(
        list(fasta_paths),
        pre,
        clu,
        cluster_contigs=True,
        contig_names=contig_names,
    )
    return ContigClusterResult(clusters=clusters, contig_names=contig_names)


@dataclass
class ContigClusterResult:
    clusters: List[List[int]]
    contig_names: List[str]

    @property
    def representatives(self) -> List[str]:
        return [self.contig_names[c[0]] for c in self.clusters]

    def memberships(self) -> List[List[str]]:
        return [[self.contig_names[i] for i in c] for c in self.clusters]


def pairwise_ani(
    fasta1: str,
    fasta2: str,
    params: Optional[ClusterParameters] = None,
    device: Optional[torch.device] = None,
) -> Optional[float]:
    """Single-pair ANI through the native engine (percent, or None when
    the aligned-fraction filter fails)."""
    p = params or ClusterParameters()
    from galah_tpu_torch.engines.native import NativeClusterer, NativeContext

    ctx = NativeContext(
        _device(device),
        small_genomes=p.small_genomes,
        fragment_length=p.fragment_length,
        threads=p.threads,
    )
    clu = NativeClusterer(
        threshold=p.ani if p.ani > 1 else p.ani * 100.0,
        min_aligned_threshold=_frac(p.min_aligned_fraction),
        ctx=ctx,
        af_fail_result=None,
    )
    return clu.calculate_ani(fasta1, fasta2)


def _frac(x: float) -> float:
    return x / 100.0 if x > 1.0 else x


def _device(device: Optional[torch.device]) -> torch.device:
    from galah_tpu_torch.utils.device import resolve_device

    return device if device is not None else resolve_device()


def _build_engines(p: ClusterParameters,
                   device: Optional[torch.device] = None):
    ani_frac = _frac(p.ani)
    pre_frac = _frac(p.precluster_ani)
    af_frac = _frac(p.min_aligned_fraction)
    skip_clusterer = p.precluster_method == p.cluster_method
    pre_pct = (ani_frac if skip_clusterer else pre_frac) * 100.0

    native_ctx = None

    def ctx():
        nonlocal native_ctx
        if native_ctx is None:
            from galah_tpu_torch.engines.native import NativeContext

            native_ctx = NativeContext(
                _device(device),
                small_genomes=p.small_genomes,
                fragment_length=p.fragment_length,
                threads=p.threads,
                low_memory=p.low_memory,
            )
        return native_ctx

    if p.precluster_method == "native":
        from galah_tpu_torch.engines.native import NativePreclusterer

        pre = NativePreclusterer(pre_pct, af_frac, ctx())
    elif p.precluster_method == "finch":
        from galah_tpu_torch.engines.finch_like import FinchPreclusterer

        pre = FinchPreclusterer(min_ani=pre_frac, threads=p.threads)
    elif p.precluster_method == "skani":
        from galah_tpu_torch.engines.subprocess_backends import SkaniPreclusterer

        pre = SkaniPreclusterer(
            pre_pct, af_frac, p.small_genomes, p.threads, p.low_memory
        )
    else:
        raise ValueError(f"Unknown precluster method {p.precluster_method}")

    if p.cluster_method == "native":
        from galah_tpu_torch.engines.native import NativeClusterer

        clu = NativeClusterer(ani_frac * 100.0, af_frac, ctx())
    elif p.cluster_method == "skani":
        from galah_tpu_torch.engines.subprocess_backends import SkaniClusterer

        clu = SkaniClusterer(ani_frac * 100.0, af_frac, p.small_genomes)
    elif p.cluster_method == "fastani":
        from galah_tpu_torch.engines.subprocess_backends import FastaniClusterer

        clu = FastaniClusterer(
            ani_frac * 100.0,
            af_frac,
            p.fragment_length
            if p.fragment_length is not None
            else defaults.DEFAULT_FRAGMENT_LENGTH,
        )
    else:
        raise ValueError(f"Unknown cluster method {p.cluster_method}")

    return pre, clu
