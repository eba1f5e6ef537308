"""The `process` subcommand: analyse + cluster fused (src/process.rs).

The quality report produced by the analyse stage is injected into
clustering so CheckM2 runs only once (src/process.rs:128-137).

The port's own copy of galah_tpu/cli/process_cmd.py, so that the port
imports nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
from typing import Optional

import torch

from galah_tpu_torch.cli.analyse_cmd import (
    add_analyse_arguments,
    run_analysis,
    write_analyse_outputs,
)
from galah_tpu_torch.cli.cluster_cmd import (
    add_cluster_arguments,
    generate_galah_clusterer,
    setup_galah_outputs,
    write_galah_outputs,
)
from galah_tpu_torch.cli.common import parse_list_of_genome_fasta_files, set_log_level

logger = logging.getLogger(__name__)


def add_process_arguments(sub: argparse.ArgumentParser) -> None:
    add_cluster_arguments(sub)
    add_analyse_arguments(sub, for_process=True)


def run_process(args: argparse.Namespace,
                device: Optional[torch.device] = None) -> None:
    """The `process` subcommand. device: where a native engine runs;
    None resolves it when one is built."""
    set_log_level(args)
    if args.cluster_contigs:
        raise SystemExit(
            "Clustering contigs is not yet implemented in process command"
        )
    genome_fasta_files = parse_list_of_genome_fasta_files(args)
    logger.info("Processing %d genomes ..", len(genome_fasta_files))

    # Open output handles early (process_argument_parsing.rs:490-493)
    summary_file = (
        open(args.output_mimag_summary, "w") if args.output_mimag_summary else None
    )
    cluster_outputs = setup_galah_outputs(args)

    with tempfile.TemporaryDirectory() as td:
        # A quality report path is needed for injection even when the
        # user didn't ask for one (src/process.rs:128-137).
        quality_report_path = args.output_quality_report or os.path.join(
            td, "quality_report.tsv"
        )
        analysis = run_analysis(args, genome_fasta_files, quality_report_path)

        reference_genomes = None
        if args.reference_genomes:
            reference_genomes = [p.split("\t")[0] for p in args.reference_genomes]
        elif args.reference_genomes_list:
            with open(args.reference_genomes_list) as f:
                reference_genomes = [
                    line.rstrip("\n").split("\t")[0]
                    for line in f
                    if line.strip()
                ]
        if reference_genomes is not None:
            logger.info("Clustering against %d reference genomes", len(reference_genomes))
            combined = list(reference_genomes) + genome_fasta_files
        else:
            combined = genome_fasta_files

        injected = quality_report_path if os.path.exists(quality_report_path) else None
        galah = generate_galah_clusterer(
            combined,
            args,
            device,
            reference_genomes=reference_genomes,
            injected_quality_report=injected,
        )

        from galah_tpu_torch.cluster.greedy import cluster as run_clustering

        logger.info("Clustering %d genomes ..", len(galah["genome_fasta_paths"]))
        clusters = run_clustering(
            galah["genome_fasta_paths"],
            galah["preclusterer"],
            galah["clusterer"],
            reference_genomes=galah["reference_genomes"],
        )
        logger.info("Found %d genome clusters", len(clusters))

    write_analyse_outputs(summary_file, analysis, genome_fasta_files)
    write_galah_outputs(cluster_outputs, clusters, galah["genome_fasta_paths"], None)
    logger.info("Finished processing genomes")
