"""The `cluster` subcommand on the torch engine
(counterpart of galah_tpu/cli/cluster_cmd.py).

Argument parsing, quality filtering and output writing are the JAX
package's host code, imported unchanged; only the engine differs. The
native engine is the only method. Genome mode, reference-genome mode
(--reference-genomes, --reference-genomes-list) and --low-memory run;
other precluster/cluster methods and the modes the port has not reached
raise "not yet supported".
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

import torch

from galah_tpu import defaults
from galah_tpu.cli.cluster_cmd import (
    determine_small_genomes_setting,
    filter_genomes_through_quality,
    setup_galah_outputs,
    write_galah_outputs,
)
from galah_tpu.cli.common import (
    parse_list_of_genome_fasta_files,
    parse_percentage,
    set_log_level,
)
from galah_tpu.cluster.greedy import cluster as run_clustering
from galah_tpu.utils import metrics
from galah_tpu_torch.engines.native import (
    NativeClusterer,
    NativeContext,
    NativePreclusterer,
    not_supported,
)

logger = logging.getLogger(__name__)

# (argument attribute, flag) of the modes the port refuses.
_UNSUPPORTED_FLAGS = (
    ("cluster_contigs", "--cluster-contigs"),
    ("sketch_directory", "--sketch-directory"),
    ("sweep_checkpoint", "--sweep-checkpoint"),
    ("output_distance_cache", "--output-distance-cache"),
    ("input_distance_cache", "--input-distance-cache"),
)


def _refuse_unsupported(args: argparse.Namespace) -> None:
    for attr, flag in _UNSUPPORTED_FLAGS:
        if getattr(args, attr, None):
            raise not_supported(flag)
    for attr, flag in (("precluster_method", "--precluster-method"),
                       ("cluster_method", "--cluster-method")):
        if getattr(args, attr) != "native":
            raise not_supported(f"{flag} {getattr(args, attr)}")


def run_cluster(args: argparse.Namespace, device: torch.device) -> None:
    set_log_level(args)
    run_metrics = metrics.reset()
    genome_fasta_files = parse_list_of_genome_fasta_files(args)

    # Reference genomes come first in the genome list, as in the
    # reference CLI.
    reference_genomes = _reference_genomes(args)
    if reference_genomes is not None:
        logger.info("Clustering against %d reference genomes",
                    len(reference_genomes))
        if args.cluster_contigs:
            print("Error: Reference genome clustering is not currently "
                  "supported with --cluster-contigs", file=sys.stderr)
            raise SystemExit(1)
        genome_fasta_files = list(reference_genomes) + genome_fasta_files

    galah = generate_galah_clusterer(
        genome_fasta_files, args, device, reference_genomes
    )

    # Open outputs before heavy compute, as the reference does.
    outputs = setup_galah_outputs(args)

    logger.info("Clustering %d genomes on %s ..",
                len(galah["genome_fasta_paths"]), device)
    clusters = run_clustering(
        galah["genome_fasta_paths"],
        galah["preclusterer"],
        galah["clusterer"],
        reference_genomes=galah["reference_genomes"],
    )
    logger.info("Found %d genome clusters", len(clusters))

    write_galah_outputs(outputs, clusters, galah["genome_fasta_paths"], None)
    if getattr(args, "metrics_json", None):
        run_metrics.count("clusters", len(clusters))
        run_metrics.dump_json(args.metrics_json)
    logger.info("Finished printing genome clusters")


def _reference_genomes(args: argparse.Namespace) -> Optional[List[str]]:
    """Paths from --reference-genomes or --reference-genomes-list (the
    first tab-separated field of each line), or None."""
    if args.reference_genomes and args.reference_genomes_list:
        raise SystemExit(
            "Error: --reference-genomes and --reference-genomes-list are "
            "mutually exclusive"
        )
    if args.reference_genomes:
        return [p.split("\t")[0] for p in args.reference_genomes]
    if args.reference_genomes_list:
        with open(args.reference_genomes_list) as f:
            return [
                line.rstrip("\n").split("\t")[0] for line in f if line.strip()
            ]
    return None


def generate_galah_clusterer(
    genome_fasta_paths: List[str],
    args: argparse.Namespace,
    device: torch.device,
    reference_genomes: Optional[List[str]] = None,
) -> dict:
    """Quality-order genomes and construct the native engine pair. Both
    methods are native, so the precluster pass runs at the final ANI.
    Reference genomes that fail the quality filter are dropped."""
    _refuse_unsupported(args)
    v2 = filter_genomes_through_quality(genome_fasta_paths, args, None, False)
    small_genomes = determine_small_genomes_setting(args, False)
    if reference_genomes is not None:
        passing = set(v2)
        reference_genomes = [r for r in reference_genomes if r in passing]

    ani = parse_percentage(args.ani, "ani")
    min_af = parse_percentage(args.min_aligned_fraction, "min-aligned-fraction")
    threshold_pct = ani * 100.0

    # Approximate the largest genome from file sizes so bitmap widths
    # fit the dataset (the reference's rule).
    from galah_tpu.io.fasta import decompressed_size_estimate

    try:
        max_len = max(decompressed_size_estimate(p) for p in v2) if v2 else None
    except OSError:
        max_len = None
    ctx = NativeContext(
        device,
        small_genomes=small_genomes,
        fragment_length=args.fragment_length,
        threads=args.threads,
        low_memory=args.low_memory,
        max_genome_length=max_len,
    )
    ani_semantics = getattr(args, "ani_semantics", defaults.DEFAULT_ANI_SEMANTICS)
    preclusterer = NativePreclusterer(
        threshold=threshold_pct,
        min_aligned_threshold=min_af,
        ctx=ctx,
        ani_semantics=ani_semantics,
    )
    clusterer = NativeClusterer(
        threshold=threshold_pct,
        min_aligned_threshold=min_af,
        ctx=ctx,
        ani_semantics=ani_semantics,
    )
    return {
        "genome_fasta_paths": v2,
        "preclusterer": preclusterer,
        "clusterer": clusterer,
        "reference_genomes": reference_genomes,
    }
