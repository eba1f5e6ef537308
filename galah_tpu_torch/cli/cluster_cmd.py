"""The `cluster` subcommand on the torch engine
(counterpart of galah_tpu/cli/cluster_cmd.py).

Argument parsing, quality filtering and output writing are copies of
the JAX package's helpers (add_cluster_arguments,
determine_small_genomes_setting, filter_genomes_through_quality,
setup_galah_outputs, write_galah_outputs), unchanged; only the engine
differs. The native engine is the only method. Genome mode, contig mode
(--cluster-contigs with --small-contigs or --large-contigs),
reference-genome mode (--reference-genomes, --reference-genomes-list)
and --low-memory run; other precluster/cluster methods and the modes
the port has not reached raise "not yet supported".
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys
import time
from typing import List, Optional

import torch

from galah_tpu_torch import defaults
from galah_tpu_torch.cli.common import (
    add_full_help_flags,
    add_genome_specification_arguments,
    add_verbosity_flags,
    parse_list_of_genome_fasta_files,
    parse_percentage,
    set_log_level,
)
from galah_tpu_torch.cluster.greedy import cluster as run_clustering
from galah_tpu_torch.engines.native import (
    NativeClusterer,
    NativeContext,
    NativePreclusterer,
    not_supported,
)
from galah_tpu_torch.io.fasta import decompressed_size_estimate, read_fasta
from galah_tpu_torch.utils import metrics

logger = logging.getLogger(__name__)

# (argument attribute, flag) of the modes the port refuses.
_UNSUPPORTED_FLAGS = (
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


def add_cluster_arguments(sub: argparse.ArgumentParser) -> None:
    add_full_help_flags(sub)
    add_verbosity_flags(sub)
    add_genome_specification_arguments(sub)
    sub.add_argument("-t", "--threads", type=int, default=1, metavar="N",
                     help="Number of CPU threads to use [default: 1]")

    filtering = sub.add_argument_group("filtering parameters")
    filtering.add_argument("--checkm2-quality-report", metavar="PATH",
                           help="CheckM2 quality_report.tsv for defining genome quality")
    filtering.add_argument("--checkm-tab-table", metavar="PATH",
                           help="CheckM1 tab table (output of checkm .. --tab_table -f PATH ..)")
    filtering.add_argument("--genome-info", metavar="PATH",
                           help="dRep-style genome info table for defining quality")
    filtering.add_argument("--min-completeness", type=float, metavar="FLOAT",
                           help="Ignore genomes with less completeness than this percentage")
    filtering.add_argument("--max-contamination", type=float, metavar="FLOAT",
                           help="Ignore genomes with more contamination than this percentage")
    filtering.add_argument("--run-checkm2", action="store_true",
                           help="Run CheckM2 to generate quality scoring used for clustering")
    filtering.add_argument("--checkm2-db-path", metavar="DB_PATH",
                           help="Path to CheckM2 database [default: CHECKM2DB env var]")

    clustering = sub.add_argument_group("clustering parameters")
    clustering.add_argument("--ani", type=float, default=defaults.DEFAULT_ANI, metavar="FLOAT",
                            help=f"Overall ANI level to dereplicate at [default: {defaults.DEFAULT_ANI:g}]")
    clustering.add_argument("--min-aligned-fraction", type=float,
                            default=defaults.DEFAULT_ALIGNED_FRACTION, metavar="FLOAT",
                            help=f"Min aligned fraction of two genomes for clustering [default: {defaults.DEFAULT_ALIGNED_FRACTION:g}]")
    clustering.add_argument("--small-genomes", action="store_true",
                            help="Use small-genomes settings. Recommended for sequences < 20kb")
    # default=None distinguishes "not given" from "explicitly 3000" so
    # --small-genomes --fragment-length 3000 is honored, not replaced by
    # the preset's 1000bp default.
    clustering.add_argument("--fragment-length", type=int,
                            default=None, metavar="FLOAT",
                            help=f"Length of fragment used in ANI calculation [default: {defaults.DEFAULT_FRAGMENT_LENGTH}]")
    clustering.add_argument("--quality-formula", default=defaults.DEFAULT_QUALITY_FORMULA,
                            choices=["Parks2020_reduced", "completeness-4contamination",
                                     "completeness-5contamination", "dRep"], metavar="FORMULA",
                            help=f"Scoring function for genome quality [default: {defaults.DEFAULT_QUALITY_FORMULA}]")
    clustering.add_argument("--precluster-ani", type=float,
                            default=defaults.DEFAULT_PRETHRESHOLD_ANI, metavar="FLOAT",
                            help=f"Require at least this ANI for preclustering [default: {defaults.DEFAULT_PRETHRESHOLD_ANI:g}]")
    clustering.add_argument("--ani-semantics", default=defaults.DEFAULT_ANI_SEMANTICS,
                            choices=list(defaults.ANI_SEMANTICS), metavar="NAME",
                            help="How the native engine's ANI thresholds are interpreted: "
                                 "'window' compares its event-inclusive k-mer-window ANI against "
                                 "the thresholds verbatim; 'skani-calibrated' shifts thresholds by "
                                 "the documented indel bias so --ani cuts match gap-excluded "
                                 "skani-style ANI. The shift assumes a FIXED typical indel load "
                                 f"({defaults.CALIBRATION_INDEL_EVENTS_PER_SUB:g} indel events per "
                                 f"substitution, mean length {defaults.CALIBRATION_MEAN_INDEL_LEN:g}); "
                                 "the run reports your corpus's apparent load in the log and "
                                 "--metrics-json so you can see when that default is off. Only "
                                 "affects the native methods "
                                 f"[default: {defaults.DEFAULT_ANI_SEMANTICS}]")
    clustering.add_argument("--precluster-method", default=defaults.DEFAULT_PRECLUSTER_METHOD,
                            choices=list(defaults.PRECLUSTER_METHODS), metavar="NAME",
                            help="Method of calculating rough ANI: 'native' (TPU), 'finch' (MinHash), 'skani' (external binary) "
                                 f"[default: {defaults.DEFAULT_PRECLUSTER_METHOD}]")
    clustering.add_argument("--cluster-method", default=defaults.DEFAULT_CLUSTER_METHOD,
                            choices=list(defaults.CLUSTER_METHODS), metavar="NAME",
                            help="Method of calculating ANI: 'native' (TPU), 'skani'/'fastani' (external binaries) "
                                 f"[default: {defaults.DEFAULT_CLUSTER_METHOD}]")
    clustering.add_argument("--cluster-contigs", action="store_true",
                            help="Cluster contigs within FASTA files instead of genomes")
    clustering.add_argument("--small-contigs", action="store_true",
                            help="Use small-genomes settings when clustering contigs (< 20kb)")
    clustering.add_argument("--large-contigs", action="store_true",
                            help="Do not use small-genomes settings when clustering contigs (>= 20kb)")
    clustering.add_argument("--low-memory", action="store_true",
                            help="Reduce memory use by streaming sketches instead of holding them resident")
    clustering.add_argument("--sketch-directory", metavar="PATH",
                            help="Persistent sketch cache: sketches are written to (and "
                                 "reused from) this directory across runs, keyed by input "
                                 "file, sketch parameters and file signature — a re-run or "
                                 "a resumed crash skips the whole sketch phase. Stale "
                                 "entries (changed file or parameters) are never reused. "
                                 "Note: cached sketches upload from the host instead of "
                                 "being born on-device, so on slow accelerator links "
                                 "re-sketching can be cheaper; pair with --sweep-checkpoint "
                                 "to skip the upload too")
    clustering.add_argument("--sweep-checkpoint", metavar="PATH",
                            help="Mid-sweep checkpoint log for the native screen: drained "
                                 "tile results append to PATH as the all-vs-all sweep runs, "
                                 "and a killed run re-invoked with the same PATH resumes the "
                                 "sweep instead of recomputing it (byte-identical output). "
                                 "Complements --output/--input-distance-cache, which "
                                 "checkpoint BETWEEN phases; this checkpoints inside the "
                                 "O(n^2) screen itself. The log is only replayed for an "
                                 "identical corpus and sweep geometry. Applies to the "
                                 "single-device resident native screen (a warning is "
                                 "logged when another screen path is taken)")
    clustering.add_argument("--reference-genomes", nargs="+", metavar="PATH",
                            help="Reference genomes to cluster against (pre-clustered at the chosen ANI)")
    clustering.add_argument("--reference-genomes-list", metavar="PATH",
                            help="File of reference genome paths, one per line")

    output = sub.add_argument_group("output parameters")
    output.add_argument("-o", "--output-cluster-definition", metavar="PATH",
                        help="Output a file of representative<TAB>member lines")
    output.add_argument("--output-representative-fasta-directory", metavar="PATH",
                        help="Symlink representative genomes into this directory")
    output.add_argument("--output-representative-fasta-directory-copy", metavar="PATH",
                        help="Copy representative genomes into this directory")
    output.add_argument("--output-representative-list", metavar="PATH",
                        help="Print newline-separated list of paths to representatives into this file")
    output.add_argument("--metrics-json", metavar="PATH",
                        help="Write phase timings and throughput counters as JSON")
    output.add_argument("--output-distance-cache", metavar="PATH",
                        help="Save the verified sparse ANI pair list (npz) for later "
                             "--input-distance-cache resume")
    output.add_argument("--input-distance-cache", metavar="PATH",
                        help="Resume from a saved distance cache instead of recomputing "
                             "the sketch/screen/verify phases (genome list must match)")


def run_cluster(args: argparse.Namespace, device: torch.device) -> None:
    set_log_level(args)
    run_metrics = metrics.reset()
    genome_fasta_files = parse_list_of_genome_fasta_files(args)
    cluster_contigs = args.cluster_contigs
    contig_names = None
    if cluster_contigs:
        t0 = time.perf_counter()
        contig_names = _contig_names(args, genome_fasta_files)
        run_metrics.phases["contig_names"] = time.perf_counter() - t0

    # Reference genomes come first in the genome list, as in the
    # reference CLI.
    reference_genomes = _reference_genomes(args)
    if reference_genomes is not None:
        logger.info("Clustering against %d reference genomes",
                    len(reference_genomes))
        if cluster_contigs:
            print("Error: Reference genome clustering is not currently "
                  "supported with --cluster-contigs", file=sys.stderr)
            raise SystemExit(1)
        genome_fasta_files = list(reference_genomes) + genome_fasta_files

    galah = generate_galah_clusterer(
        genome_fasta_files, args, device, reference_genomes, cluster_contigs
    )

    # Open outputs before heavy compute, as the reference does.
    outputs = setup_galah_outputs(args)

    logger.info("Clustering %d genomes on %s ..",
                len(galah["genome_fasta_paths"]), device)
    clusters = run_clustering(
        galah["genome_fasta_paths"],
        galah["preclusterer"],
        galah["clusterer"],
        cluster_contigs=cluster_contigs,
        contig_names=contig_names,
        reference_genomes=galah["reference_genomes"],
    )
    logger.info("Found %d genome clusters", len(clusters))

    write_galah_outputs(outputs, clusters, galah["genome_fasta_paths"],
                        contig_names)
    if getattr(args, "metrics_json", None):
        run_metrics.count("clusters", len(clusters))
        run_metrics.dump_json(args.metrics_json)
    logger.info("Finished printing genome clusters")


def _contig_names(args: argparse.Namespace, paths: List[str]) -> List[str]:
    """Contig mode's checks, with the JAX CLI's messages and exit codes:
    one of --small-contigs/--large-contigs, no representative FASTA
    directory; then every contig's name (the header up to its first
    tab), in file order, refusing a duplicate."""
    if args.small_contigs and args.large_contigs:
        print("Error: Cannot specify both --small-contigs and --large-contigs.",
              file=sys.stderr)
        raise SystemExit(1)
    if not (args.small_contigs or args.large_contigs):
        print("Error: When --cluster-contigs is used, either --small-contigs or "
              "--large-contigs must be specified.", file=sys.stderr)
        print("Use --small-contigs for contigs < 20kb, --large-contigs for "
              "contigs >= 20kb.", file=sys.stderr)
        raise SystemExit(1)
    if (args.output_representative_fasta_directory
            or args.output_representative_fasta_directory_copy):
        raise SystemExit(
            "Cannot specify --cluster-contigs with "
            "--output-representative-fasta-directory "
            "or --output-representative-fasta-directory-copy"
        )
    names: List[str] = []
    seen = set()
    for path in paths:
        for rec in read_fasta(path):
            cname = rec.contig_name
            if cname in seen:
                raise SystemExit(
                    f"Duplicate contig name found in file '{path}': {cname}"
                )
            seen.add(cname)
            names.append(cname)
    return names


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
    cluster_contigs: bool = False,
) -> dict:
    """Quality-order genomes and construct the native engine pair. Both
    methods are native, so the precluster pass runs at the final ANI.
    Reference genomes that fail the quality filter are dropped; in
    contig mode the files keep their order."""
    _refuse_unsupported(args)
    v2 = filter_genomes_through_quality(genome_fasta_paths, args, None,
                                        cluster_contigs)
    small_genomes = determine_small_genomes_setting(args, cluster_contigs)
    if reference_genomes is not None:
        passing = set(v2)
        reference_genomes = [r for r in reference_genomes if r in passing]

    ani = parse_percentage(args.ani, "ani")
    min_af = parse_percentage(args.min_aligned_fraction, "min-aligned-fraction")
    threshold_pct = ani * 100.0

    # Approximate the largest genome from file sizes so bitmap widths
    # fit the dataset (the reference's rule).
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


def determine_small_genomes_setting(args: argparse.Namespace, cluster_contigs: bool) -> bool:
    """src/cluster_argument_parsing.rs:1760-1782."""
    if cluster_contigs:
        if args.small_contigs and not args.large_contigs:
            return True
        if args.large_contigs and not args.small_contigs:
            return False
        raise SystemExit(
            "When --cluster-contigs is used, either --small-contigs or "
            "--large-contigs must be specified"
        )
    return args.small_genomes


def filter_genomes_through_quality(
    genome_fasta_files: List[str],
    args: argparse.Namespace,
    injected_quality_report: Optional[str],
    cluster_contigs: bool,
) -> List[str]:
    """src/cluster_argument_parsing.rs:863-1157."""
    from galah_tpu_torch.quality.checkm import (
        read_checkm1_tab_table,
        read_checkm2_quality_report,
        read_genome_info_file,
    )
    from galah_tpu_torch.quality.filter import filter_and_order_genomes

    if cluster_contigs:
        return list(genome_fasta_files)

    has_quality = (
        args.checkm_tab_table
        or args.genome_info
        or args.checkm2_quality_report
        or injected_quality_report
        or args.run_checkm2
    )
    if not has_quality:
        logger.warning(
            "Since CheckM input has not been provided and CheckM2 has been "
            "disabled, genomes are not being ordered by quality. Instead the "
            "order of their input is being used"
        )
        return list(genome_fasta_files)

    checkm1 = None
    if args.checkm_tab_table:
        logger.info("Reading CheckM tab table ..")
        checkm = checkm1 = read_checkm1_tab_table(args.checkm_tab_table)
    elif args.checkm2_quality_report:
        logger.info("Reading CheckM2 Quality report ..")
        checkm = read_checkm2_quality_report(args.checkm2_quality_report)
    elif args.genome_info:
        if args.quality_formula == "dRep":
            raise SystemExit("The dRep quality formula cannot be used with --genome-info")
        logger.info("Reading genome info file %s", args.genome_info)
        checkm = read_genome_info_file(args.genome_info)
    elif injected_quality_report:
        logger.info("Reading injected CheckM2 Quality report ..")
        checkm = read_checkm2_quality_report(injected_quality_report)
    elif args.run_checkm2:
        import tempfile

        from galah_tpu_torch.annotate.checkm2_runner import run_checkm2_predict

        db_path = args.checkm2_db_path or os.environ.get("CHECKM2DB")
        if not db_path:
            raise SystemExit(
                "CheckM2 database path must be provided via --checkm2-db-path "
                "or CHECKM2DB env var"
            )
        with tempfile.TemporaryDirectory() as td:
            report = run_checkm2_predict(genome_fasta_files, args.threads, td, db_path)
            checkm = read_checkm2_quality_report(report)
    else:
        raise AssertionError("Programming error")

    if args.quality_formula == "dRep" and checkm1 is None:
        raise SystemExit(
            "dRep quality formula only works with CheckM v1 quality scoring "
            "since it includes strain heterogeneity"
        )

    max_contamination = parse_percentage(args.max_contamination, "max-contamination")
    min_completeness = parse_percentage(args.min_completeness, "min-completeness")

    return filter_and_order_genomes(
        genome_fasta_files,
        checkm,
        args.quality_formula,
        min_completeness=min_completeness,
        max_contamination=max_contamination,
        threads=args.threads,
        checkm1_for_drep=checkm1,
    )


def setup_galah_outputs(args: argparse.Namespace) -> dict:
    """Open output files / validate output dirs up front
    (src/cluster_argument_parsing.rs:516-543, 778-813)."""
    out = {
        "clusters_file": None,
        "rep_dir": None,
        "rep_dir_copy": None,
        "rep_list": None,
    }
    if args.output_cluster_definition:
        out["clusters_file"] = open(args.output_cluster_definition, "w")
    out["rep_dir"] = _setup_representative_output_directory(
        args.output_representative_fasta_directory, "--output-representative-fasta-directory"
    )
    out["rep_dir_copy"] = _setup_representative_output_directory(
        args.output_representative_fasta_directory_copy,
        "--output-representative-fasta-directory-copy",
    )
    if args.output_representative_list:
        out["rep_list"] = open(args.output_representative_list, "w")
    return out


def _setup_representative_output_directory(d: Optional[str], argname: str) -> Optional[str]:
    if d is None:
        return None
    if os.path.exists(d):
        if os.path.isdir(d):
            if os.listdir(d):
                logger.error("The %s specified (%s) exists and is not empty", argname, d)
                raise SystemExit(1)
            logger.info("Using pre-existing but empty %s", argname)
        else:
            logger.error("The %s path specified (%s) exists but is not a directory", argname, d)
            raise SystemExit(1)
    else:
        logger.info("Creating %s ..", argname)
        os.makedirs(d, exist_ok=True)
    return d


def write_galah_outputs(
    outputs: dict,
    clusters: List[List[int]],
    passed_genomes: List[str],
    contig_names: Optional[List[str]],
) -> None:
    """src/cluster_argument_parsing.rs:718-776."""
    references = contig_names if contig_names is not None else passed_genomes
    if outputs["clusters_file"] is not None:
        with outputs["clusters_file"] as f:
            for cluster in clusters:
                rep = references[cluster[0]]
                for genome_index in cluster:
                    f.write(f"{rep}\t{references[genome_index]}\n")

    _write_cluster_reps_to_directory(
        clusters, references, outputs["rep_dir"],
        lambda src, dst: os.symlink(src, dst),
    )
    _write_cluster_reps_to_directory(
        clusters, references, outputs["rep_dir_copy"],
        lambda src, dst: shutil.copy(src, dst),
    )

    if outputs["rep_list"] is not None:
        with outputs["rep_list"] as f:
            for cluster in clusters:
                f.write(f"{references[cluster[0]]}\n")


def _write_cluster_reps_to_directory(clusters, passed_genomes, directory, create_fn):
    """Symlink/copy reps with `.1.fna`-style clash renaming
    (src/cluster_argument_parsing.rs:815-849)."""
    if directory is None:
        return
    warned = False
    for cluster in clusters:
        rep = passed_genomes[cluster[0]]
        link = os.path.realpath(rep)
        basename = os.path.basename(rep)
        target = os.path.join(directory, basename)
        counter = 0
        while os.path.lexists(target):
            if not warned:
                logger.warning(
                    "One or more sequence files have the same file name. "
                    "Renaming clashes by adding .1.fna, .2.fna etc."
                )
                warned = True
            counter += 1
            target = os.path.join(directory, basename) + f".{counter}.fna"
        create_fn(link, target)
