"""The `cluster` subcommand on the torch engine
(counterpart of galah_tpu/cli/cluster_cmd.py).

Argument parsing, quality filtering, the engine factory's method
dispatch, the distance caches and output writing are copies of the JAX
package's (add_cluster_arguments, determine_small_genomes_setting,
filter_genomes_through_quality, generate_galah_clusterer,
_RecordingPreclusterer, _PrecomputedPreclusterer, setup_galah_outputs,
write_galah_outputs); only the native engine differs. Every mode runs:
genome, contig (--cluster-contigs with --small-contigs or
--large-contigs), reference-genome (--reference-genomes,
--reference-genomes-list) and --low-memory; the precluster methods
native, finch and skani and the cluster methods native, skani and
fastani; the resume artifacts --sketch-directory, --sweep-checkpoint,
--output-distance-cache and --input-distance-cache, in the JAX
package's file formats.

The devices are resolved only when a native engine is built, so a
finch/skani/fastANI run never touches the card; a native run stops
without a CUDA device unless GALAH_TPU_PLATFORM=cpu. Every visible card
is a shard (utils/device.py::resolve_devices): with one card and one
process the run takes the single-device path.
"""

from __future__ import annotations

import argparse
import contextlib
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
from galah_tpu_torch.io.fasta import decompressed_size_estimate, read_fasta
from galah_tpu_torch.utils import metrics

logger = logging.getLogger(__name__)


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


def run_cluster(args: argparse.Namespace,
                device: Optional[torch.device] = None) -> None:
    """The `cluster` subcommand. device: where a native engine runs (a
    device or the shards); None resolves every local device
    (utils/device.py) when one is built. GALAH_TPU_PROFILE=<dir> traces
    the run with torch.profiler and writes a Chrome trace into <dir>
    after the outputs (_profiled)."""
    set_log_level(args)
    run_metrics = metrics.reset()
    profile_dir = os.environ.get("GALAH_TPU_PROFILE")
    if not profile_dir:
        return _run_cluster(args, device, run_metrics)
    with _profiled(profile_dir, device):
        _run_cluster(args, device, run_metrics)


def _on_card(device: Optional[torch.device]) -> bool:
    """Whether the run's engine will be on a CUDA device: the given
    device or shards, else what utils/device.py would resolve."""
    if device is not None:
        devices = [device] if isinstance(device, torch.device) else device
        return any(d.type == "cuda" for d in devices)
    platform = os.environ.get("GALAH_TPU_PLATFORM", "").strip().lower()
    return platform != "cpu" and torch.cuda.is_available()


@contextlib.contextmanager
def _profiled(profile_dir: str, device: Optional[torch.device]):
    """torch.profiler over the body (the JAX package's
    jax.profiler.start_trace/stop_trace): the CPU activity always, the
    CUDA activity when the run is on the card. A body that finishes
    writes <dir>/galah_tpu_torch.<pid>.trace.json; one that raises
    stops the profiler and writes nothing."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if _on_card(device):
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir,
                        f"galah_tpu_torch.{os.getpid()}.trace.json")
    prof.export_chrome_trace(path)
    logger.info("Wrote torch profiler trace to %s", path)


def _run_cluster(args: argparse.Namespace, device, run_metrics) -> None:
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
        genome_fasta_files, args, device, reference_genomes, cluster_contigs,
        injected_quality_report=getattr(args, "_injected_quality_report",
                                        None),
    )

    # Open outputs before heavy compute, as the reference does.
    outputs = setup_galah_outputs(args)

    logger.info("Clustering %d genomes ..", len(galah["genome_fasta_paths"]))
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


class _RecordingPreclusterer:
    """Wraps a preclusterer and saves its sparse result to disk: the
    phase checkpoint of --output-distance-cache. Records the flags the
    pairs were filtered under (threshold, min-AF, method, mode) so that
    the resume path can refuse an incompatible run."""

    def __init__(
        self,
        inner,
        out_path: str,
        threshold: Optional[float] = None,
        min_af: Optional[float] = None,
    ) -> None:
        self._inner = inner
        self._out_path = out_path
        self._threshold = threshold
        self._min_af = min_af
        self.supports_contigs = getattr(inner, "supports_contigs", True)

    def _save(self, cache, names, mode):
        from galah_tpu_torch.sketch.store import save_distance_cache

        save_distance_cache(
            cache, self._out_path, names=names, threshold=self._threshold,
            min_af=self._min_af, method=self._inner.method_name(), mode=mode,
        )
        logger.info("Saved distance cache (%d pairs) to %s", len(cache),
                    self._out_path)

    def distances(self, paths):
        cache = self._inner.distances(paths)
        self._save(cache, paths, "triangle")
        return cache

    def distances_contigs(self, paths, contig_names):
        cache = self._inner.distances_contigs(paths, contig_names)
        self._save(cache, contig_names, "contigs")
        return cache

    def distances_with_references(self, paths, refs):
        cache = self._inner.distances_with_references(paths, refs)
        self._save(cache, paths, "references")
        return cache

    def method_name(self):
        return self._inner.method_name()


class _PrecomputedPreclusterer:
    """Serves a previously saved distance cache, remapped by unit name
    to the current ordering: the --input-distance-cache resume path."""

    supports_contigs = True

    def __init__(self, cache, names, method_name: str) -> None:
        self._old_index = {n: i for i, n in enumerate(names)}
        self._cache = cache
        self._method = method_name

    def _remap(self, units):
        from galah_tpu_torch.cluster.cache import SortedPairDistanceCache

        missing = [u for u in units if u not in self._old_index]
        if missing:
            raise SystemExit(
                f"--input-distance-cache does not cover {len(missing)} input "
                f"unit(s), e.g. {missing[0]}"
            )
        new_of_old = {}
        for new_i, u in enumerate(units):
            new_of_old[self._old_index[u]] = new_i
        out = SortedPairDistanceCache()
        for (i, j), v in self._cache.items():
            if i in new_of_old and j in new_of_old:
                out.insert((new_of_old[i], new_of_old[j]), v)
        return out

    def distances(self, paths):
        return self._remap(list(paths))

    def distances_contigs(self, paths, contig_names):
        return self._remap(list(contig_names))

    def distances_with_references(self, paths, refs):
        return self._remap(list(paths))

    def method_name(self):
        return self._method


def generate_galah_clusterer(
    genome_fasta_paths: List[str],
    args: argparse.Namespace,
    device: Optional[torch.device] = None,
    reference_genomes: Optional[List[str]] = None,
    cluster_contigs: bool = False,
    injected_quality_report: Optional[str] = None,
) -> dict:
    """Quality-order genomes and construct the engine pair (the JAX
    package's method dispatch). When the precluster and cluster methods
    coincide the precluster pass runs at the final ANI, otherwise at
    --precluster-ani. Reference genomes that fail the quality filter are
    dropped; in contig mode the files keep their order. The native
    engines share one NativeContext, built on `device` (None: resolved
    then) only when a native method is chosen. --input-distance-cache
    replaces the preclusterer after checking the cache's recorded flags;
    --output-distance-cache wraps it."""
    skip_clusterer = args.precluster_method == args.cluster_method
    v2 = filter_genomes_through_quality(genome_fasta_paths, args,
                                        injected_quality_report,
                                        cluster_contigs)
    small_genomes = determine_small_genomes_setting(args, cluster_contigs)
    if reference_genomes is not None:
        passing = set(v2)
        reference_genomes = [r for r in reference_genomes if r in passing]

    ani = parse_percentage(args.ani, "ani")
    precluster_ani = parse_percentage(args.precluster_ani, "precluster-ani")
    min_af = parse_percentage(args.min_aligned_fraction, "min-aligned-fraction")
    pre_threshold_pct = (ani if skip_clusterer else precluster_ani) * 100.0

    native_ctx = None

    def get_native_ctx():
        nonlocal native_ctx
        if native_ctx is None:
            from galah_tpu_torch.engines.native import NativeContext
            from galah_tpu_torch.utils.device import resolve_devices

            # Approximate the largest genome from file sizes so bitmap
            # widths fit the dataset (the reference's rule).
            try:
                max_len = (max(decompressed_size_estimate(p) for p in v2)
                           if v2 else None)
            except OSError:
                max_len = None
            native_ctx = NativeContext(
                device if device is not None else resolve_devices(),
                small_genomes=small_genomes,
                fragment_length=args.fragment_length,
                threads=args.threads,
                low_memory=args.low_memory,
                max_genome_length=max_len,
                sketch_directory=getattr(args, "sketch_directory", None),
            )
            logger.info("Native engine on %s",
                        ", ".join(map(str, native_ctx.devices)))
        return native_ctx

    ani_semantics = getattr(args, "ani_semantics",
                            defaults.DEFAULT_ANI_SEMANTICS)
    if (ani_semantics == "window"
            and "native" in (args.precluster_method, args.cluster_method)
            and min(ani, precluster_ani) * 100.0 < 99.0):
        logger.info(
            "ANI thresholds use the native estimator's window "
            "(event-inclusive) semantics; vs gap-excluded skani ANI "
            "they read ~0.1x(100-ANI) lower on typical indel loads. "
            "Use --ani-semantics skani-calibrated to reproduce "
            "gap-excluded cuts."
        )
    elif (ani_semantics == "skani-calibrated"
          and args.precluster_method == "native"):
        logger.info(
            "skani-calibrated thresholds assume a fixed typical indel "
            "load (%g indel events per substitution, mean length %g); "
            "the native preclustering pass reports this corpus's "
            "apparent load after verification.",
            defaults.CALIBRATION_INDEL_EVENTS_PER_SUB,
            defaults.CALIBRATION_MEAN_INDEL_LEN,
        )

    if args.precluster_method == "native":
        from galah_tpu_torch.engines.native import NativePreclusterer

        preclusterer = NativePreclusterer(
            threshold=pre_threshold_pct,
            min_aligned_threshold=min_af,
            ctx=get_native_ctx(),
            ani_semantics=ani_semantics,
            sweep_checkpoint=getattr(args, "sweep_checkpoint", None),
        )
    elif args.precluster_method == "finch":
        from galah_tpu_torch.engines.finch_like import FinchPreclusterer

        preclusterer = FinchPreclusterer(
            min_ani=precluster_ani,
            low_memory=args.low_memory,
            threads=args.threads,
        )
    elif args.precluster_method == "skani":
        from galah_tpu_torch.engines.subprocess_backends import (
            SkaniPreclusterer,
        )

        preclusterer = SkaniPreclusterer(
            threshold=pre_threshold_pct,
            min_aligned_threshold=min_af,
            small_genomes=small_genomes,
            threads=args.threads,
            low_memory=args.low_memory,
        )
    else:
        raise SystemExit(f"Unknown precluster method {args.precluster_method}")

    if args.cluster_method == "native":
        from galah_tpu_torch.engines.native import NativeClusterer

        clusterer = NativeClusterer(
            threshold=ani * 100.0,
            min_aligned_threshold=min_af,
            ctx=get_native_ctx(),
            ani_semantics=ani_semantics,
        )
    elif args.cluster_method == "skani":
        from galah_tpu_torch.engines.subprocess_backends import SkaniClusterer

        clusterer = SkaniClusterer(
            threshold=ani * 100.0,
            min_aligned_threshold=min_af,
            small_genomes=small_genomes,
        )
    elif args.cluster_method == "fastani":
        from galah_tpu_torch.engines.subprocess_backends import (
            FastaniClusterer,
        )

        clusterer = FastaniClusterer(
            threshold=ani * 100.0,
            min_aligned_threshold=min_af,
            fraglen=(args.fragment_length
                     if args.fragment_length is not None
                     else defaults.DEFAULT_FRAGMENT_LENGTH),
        )
    else:
        raise SystemExit(f"Unknown cluster method {args.cluster_method}")

    run_mode = (
        "references" if reference_genomes is not None
        else "contigs" if cluster_contigs else "triangle"
    )
    if getattr(args, "input_distance_cache", None):
        preclusterer = _precomputed(args, pre_threshold_pct, min_af,
                                    run_mode)
    elif getattr(args, "output_distance_cache", None):
        preclusterer = _RecordingPreclusterer(
            preclusterer, args.output_distance_cache,
            threshold=pre_threshold_pct, min_af=min_af,
        )

    return {
        "genome_fasta_paths": v2,
        "preclusterer": preclusterer,
        "clusterer": clusterer,
        "reference_genomes": reference_genomes,
    }


def _precomputed(args: argparse.Namespace, pre_threshold_pct: float,
                 min_af: float, run_mode: str) -> _PrecomputedPreclusterer:
    """The --input-distance-cache preclusterer, after refusing a cache
    recorded at a higher ANI threshold or at another AF, method or mode,
    with the JAX package's messages. A changed AF, method or mode
    changes which pairs the recording run emitted; a cache that predates
    a field (None) skips its check."""
    from galah_tpu_torch.sketch.store import load_distance_cache

    logger.info("Loading distance cache from %s", args.input_distance_cache)
    cache, names, meta = load_distance_cache(args.input_distance_cache)
    if names is None:
        raise SystemExit(
            "The distance cache has no unit names and cannot be remapped"
        )
    saved_threshold = meta["threshold"]
    if (saved_threshold is not None
            and pre_threshold_pct < saved_threshold - 1e-6):
        raise SystemExit(
            f"--input-distance-cache was recorded at ANI {saved_threshold:g} "
            f"but this run needs pairs down to {pre_threshold_pct:g}; "
            "re-run without the cache to recompute"
        )
    if meta["min_af"] is not None and abs(meta["min_af"] - min_af) > 1e-9:
        raise SystemExit(
            f"--input-distance-cache was recorded at --min-aligned-"
            f"fraction {meta['min_af']:g} but this run uses {min_af:g}; "
            "re-run without the cache to recompute"
        )
    if meta["method"] is not None and meta["method"] != args.precluster_method:
        raise SystemExit(
            f"--input-distance-cache was recorded with precluster "
            f"method '{meta['method']}' but this run uses "
            f"'{args.precluster_method}'; re-run without the cache"
        )
    if meta["mode"] is not None and meta["mode"] != run_mode:
        raise SystemExit(
            f"--input-distance-cache was recorded in {meta['mode']} "
            f"mode but this run is {run_mode} mode; re-run without "
            "the cache"
        )
    return _PrecomputedPreclusterer(cache, names, args.precluster_method)


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
