"""The `analyse` subcommand (src/analyse_argument_parsing.rs:297-552).

The port's own copy of galah_tpu/cli/analyse_cmd.py, so that the port
imports nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Dict, List, Optional

from galah_tpu_torch import defaults
from galah_tpu_torch.cli.common import (
    add_genome_specification_arguments,
    add_verbosity_flags,
    parse_list_of_genome_fasta_files,
    set_log_level,
)

logger = logging.getLogger(__name__)


def add_analyse_arguments(sub: argparse.ArgumentParser, for_process: bool = False) -> None:
    if not for_process:
        from galah_tpu_torch.cli.common import add_full_help_flags

        add_full_help_flags(sub)
        add_verbosity_flags(sub)
        add_genome_specification_arguments(sub)
        sub.add_argument("-t", "--threads", type=int, default=1, metavar="N",
                         help="Number of CPU threads to use [default: 1]")
    sub.add_argument("--output-mimag-summary", metavar="SUMMARY",
                     help="Path to output MIMAG summary file")
    sub.add_argument("--output-quality-report", metavar="REPORT",
                     help="Path to output CheckM2-format quality report")
    sub.add_argument("--rrna-method", default=defaults.DEFAULT_RRNA_METHOD,
                     choices=list(defaults.RRNA_METHODS),
                     help="Method for rRNA analysis")
    sub.add_argument("--trna-method", default=defaults.DEFAULT_TRNA_METHOD,
                     choices=list(defaults.TRNA_METHODS),
                     help="Method for tRNA analysis")
    sub.add_argument("--quality-method", default=defaults.DEFAULT_QUALITY_METHOD,
                     choices=list(defaults.QUALITY_METHODS),
                     help="Method for quality analysis")
    if not for_process:
        sub.add_argument("--checkm2-db-path", metavar="CHECKM2DB",
                         help="Path to CheckM2 database [default: CHECKM2DB env var]")
        sub.add_argument("--checkm2-quality-report", metavar="FILE",
                         help="CheckM2 quality_report.tsv; prevents the quality method being run")
        sub.add_argument("--checkm-tab-table", metavar="FILE",
                         help="CheckM tab table file; prevents the quality method being run")
    sub.add_argument("--barrnap-gff-list", metavar="FILE",
                     help="Two-column TSV mapping genome paths to Barrnap GFF paths; "
                          "prevents the rRNA method being run")
    sub.add_argument("--trnascan-out-list", metavar="FILE",
                     help="Two-column TSV mapping genome paths to tRNAscan-SE output paths; "
                          "prevents the tRNA method being run")


def run_analyse(args: argparse.Namespace) -> None:
    set_log_level(args)
    if not args.output_mimag_summary and not args.output_quality_report:
        raise SystemExit(
            "Error: one of --output-mimag-summary or --output-quality-report "
            "must be specified"
        )
    genome_fasta_files = parse_list_of_genome_fasta_files(args)

    # Open output handles early (src/analyse_argument_parsing.rs:542-543)
    summary_file = (
        open(args.output_mimag_summary, "w") if args.output_mimag_summary else None
    )

    logger.info("Analysing %d genomes ..", len(genome_fasta_files))
    analysis = run_analysis(args, genome_fasta_files, args.output_quality_report)

    write_analyse_outputs(summary_file, analysis, genome_fasta_files)
    logger.info("Finished printing genome analysis")


def run_analysis(
    args: argparse.Namespace,
    genome_fasta_files: List[str],
    output_quality_report_path: Optional[str],
):
    from galah_tpu_torch.annotate.analyse import analyse
    from galah_tpu_torch.annotate.barrnap import BarrnapAnalyser
    from galah_tpu_torch.annotate.trnascan import TrnascanAnalyser

    quality_finder = None
    if not args.checkm2_quality_report and not args.checkm_tab_table:
        from galah_tpu_torch.annotate.checkm2_runner import CheckM2Analyser

        db_path = args.checkm2_db_path or os.environ.get("CHECKM2DB")
        if not db_path:
            raise SystemExit(
                "CheckM2 database path must be provided via --checkm2-db-path "
                "or CHECKM2DB env var"
            )
        quality_finder = CheckM2Analyser(db_path)

    return analyse(
        genome_fasta_files,
        args.threads,
        quality_finder,
        BarrnapAnalyser(),
        TrnascanAnalyser(),
        checkm2_quality_report=args.checkm2_quality_report,
        output_quality_report_path=output_quality_report_path,
        checkm_tab_table=args.checkm_tab_table,
        barrnap_gff_list=args.barrnap_gff_list,
        trnascan_out_list=args.trnascan_out_list,
    )


def write_analyse_outputs(summary_file, analysis: Dict, genome_fasta_files: List[str]) -> None:
    """8-column TSV in input order; missing genomes get the placeholder
    row (src/analyse_argument_parsing.rs:625-656)."""
    if summary_file is None:
        return
    with summary_file as f:
        f.write(
            "genome\tcompleteness\tcontamination\trRNA_5S\trRNA_16S\trRNA_23S\ttRNAs\tMIMAG_quality\n"
        )
        for genome in genome_fasta_files:
            data = analysis.get(genome)
            if data is not None:
                f.write(
                    f"{genome}\t{data.completeness:.2f}\t{data.contamination:.2f}\t"
                    f"{data.r5s}\t{data.r16s}\t{data.r23s}\t{data.trnas}\t{data.mimag_quality}\n"
                )
            else:
                f.write(f"{genome}\t0.0\t0.0\t0\t0\t0\t0\tMedium quality\n")
