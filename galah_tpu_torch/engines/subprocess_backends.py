"""Subprocess passthrough backends for users with skani / fastANI
installed.

The native engine is the default and needs no external tools; these
backends reproduce the reference's exact subprocess contracts for
drop-in compatibility:
- skani triangle --sparse (src/skani.rs:109-225), skani sketch+search
  low-memory (src/skani.rs:229-377), per-pair skani dist
  (src/skani.rs:718-788);
- fastANI both directions with fragment-count aligned fraction and
  bidirectional max (src/fastani.rs:31-152).

Tab-containing FASTA headers are sanitized to spaces via tempfiles
before invoking skani, since tabs corrupt its TSV output
(src/skani.rs:80-107).

The port's own copy of galah_tpu/engines/subprocess_backends.py, so that
the port imports nothing of galah_tpu: same behaviour, file formats and
numerics.
"""

from __future__ import annotations

import csv
import logging
import os
import shutil
import subprocess
import tempfile
from typing import List, Optional, Sequence, Tuple

from galah_tpu_torch import defaults
from galah_tpu_torch.cluster.cache import SortedPairDistanceCache
from galah_tpu_torch.engines.base import ClusterDistanceFinder, PreclusterDistanceFinder
from galah_tpu_torch.io.fasta import read_fasta

logger = logging.getLogger(__name__)


def check_for_binary(name: str) -> None:
    if shutil.which(name) is None:
        raise SystemExit(
            f"Error: the external tool '{name}' was not found on PATH. "
            "Install it, or use the TPU-native engine "
            "(--precluster-method native --cluster-method native)."
        )


def _sanitize_fasta_headers(path: str, tmpdir: str) -> str:
    """Copy to a tempfile with tabs in headers replaced by spaces."""
    fd, out = tempfile.mkstemp(
        prefix="galah-sanitized-fasta", suffix=".fna", dir=tmpdir
    )
    with os.fdopen(fd, "w") as f:
        for rec in read_fasta(path):
            f.write(f">{rec.sanitized_name}\n")
            f.write(rec.seq.decode("ascii", errors="replace"))
            f.write("\n")
    return out


def _run_checked(cmd: List[str], **kw) -> subprocess.CompletedProcess:
    logger.debug("Running command: %s", " ".join(cmd))
    proc = subprocess.run(cmd, capture_output=True, text=True, **kw)
    if proc.returncode != 0:
        logger.error(
            "Command %s failed with status %d\nstderr:\n%s",
            cmd[0],
            proc.returncode,
            proc.stderr,
        )
        raise RuntimeError(f"{cmd[0]} did not run successfully")
    return proc


class SkaniPreclusterer(PreclusterDistanceFinder):
    supports_contigs = True

    def __init__(
        self,
        threshold: float,
        min_aligned_threshold: float,
        small_genomes: bool = False,
        threads: int = 1,
        low_memory: bool = False,
    ) -> None:
        if threshold < defaults.MIN_SUPPORTED_PRECLUSTER_ANI:
            raise ValueError(
                "Error: skani produces inaccurate results with ANI less than "
                f"85%. Provided: {threshold:g}"
            )
        self.threshold = threshold
        self.min_aligned_threshold = min_aligned_threshold
        self.small_genomes = small_genomes
        self.threads = threads
        self.low_memory = low_memory

    def method_name(self) -> str:
        return "skani"

    def distances(self, genome_fasta_paths: Sequence[str]) -> SortedPairDistanceCache:
        check_for_binary("skani")
        if self.low_memory:
            return self._distances_lowmem(genome_fasta_paths)
        return self._distances_triangle(genome_fasta_paths)

    def _distances_triangle(self, paths: Sequence[str]) -> SortedPairDistanceCache:
        with tempfile.TemporaryDirectory() as td:
            sanitized = [_sanitize_fasta_headers(p, td) for p in paths]
            listfile = os.path.join(td, "genomes.txt")
            with open(listfile, "w") as f:
                f.write("\n".join(sanitized) + "\n")
            cmd = [
                "skani", "triangle", "-t", str(self.threads),
                "--sparse", "--min-af", str(self.min_aligned_threshold * 100.0),
                "-l", listfile,
            ]
            if self.small_genomes:
                cmd.append("--small-genomes")
            proc = _run_checked(cmd)
            index = {s: i for i, s in enumerate(sanitized)}
            return self._parse_sparse_tsv(proc.stdout, index)

    def _distances_lowmem(self, paths: Sequence[str]) -> SortedPairDistanceCache:
        """skani sketch to disk, then search the database
        (src/skani.rs:229-377)."""
        if self.small_genomes:
            # reference refuses this combination up front (src/skani.rs:243-245)
            raise ValueError(
                "Error: skani does not support small genomes with "
                "low-memory preclustering"
            )
        with tempfile.TemporaryDirectory() as td:
            sanitized = [_sanitize_fasta_headers(p, td) for p in paths]
            listfile = os.path.join(td, "genomes.txt")
            with open(listfile, "w") as f:
                f.write("\n".join(sanitized) + "\n")
            db = os.path.join(td, "sketches")
            cmd = ["skani", "sketch", "-t", str(self.threads), "-l", listfile, "-o", db]
            _run_checked(cmd)
            cmd = [
                "skani", "search", "-t", str(self.threads),
                "--min-af", str(self.min_aligned_threshold * 100.0),
                "--ql", listfile, "-d", db,
            ]
            proc = _run_checked(cmd)
            index = {s: i for i, s in enumerate(sanitized)}
            cache = self._parse_sparse_tsv(proc.stdout, index, skip_self=True)
            return cache

    def distances_contigs(
        self, genome_fasta_paths: Sequence[str], contig_names: Sequence[str]
    ) -> SortedPairDistanceCache:
        """skani triangle -i compares individual contigs; matches are by
        contig *name* (src/skani.rs:379-498)."""
        check_for_binary("skani")
        with tempfile.TemporaryDirectory() as td:
            sanitized = [_sanitize_fasta_headers(p, td) for p in genome_fasta_paths]
            listfile = os.path.join(td, "genomes.txt")
            with open(listfile, "w") as f:
                f.write("\n".join(sanitized) + "\n")
            cmd = [
                "skani", "triangle", "-t", str(self.threads),
                "--sparse", "--min-af", str(self.min_aligned_threshold * 100.0),
                "-i", "-l", listfile,
            ]
            if self.small_genomes:
                cmd.append("--small-genomes")
            proc = _run_checked(cmd)
            # Match the FULL sanitized contig name (tabs -> spaces) and
            # treat a miss as fatal, exactly like the reference
            # (src/skani.rs:455-474 panics "Failed to find contig name").
            name_index = {
                n.replace("\t", " "): i for i, n in enumerate(contig_names)
            }
            cache = SortedPairDistanceCache()
            reader = csv.reader(proc.stdout.splitlines(), delimiter="\t")
            header = next(reader, None)
            for row in reader:
                if not row:
                    continue
                # columns 5/6 are Ref_name / Query_name
                n1 = row[5].replace("\t", " ")
                n2 = row[6].replace("\t", " ")
                for n_, raw in ((n1, row[5]), (n2, row[6])):
                    if n_ not in name_index:
                        raise RuntimeError(
                            "Failed to find contig name in contig_names: "
                            f"{raw}"
                        )
                ani = float(row[2])
                if ani >= self.threshold:
                    i, j = name_index[n1], name_index[n2]
                    if i != j:
                        cache.insert((i, j), ani)
            return cache

    def distances_with_references(
        self, genome_fasta_paths: Sequence[str], reference_genomes: Sequence[str]
    ) -> SortedPairDistanceCache:
        """Sketch references, then search non-reference genomes against
        the reference DB — cross-group comparisons only
        (src/skani.rs:502-687)."""
        check_for_binary("skani")
        if self.small_genomes:
            raise ValueError(
                "Error: skani does not support small genomes with reference "
                "genome preclustering"
            )
        ref_set = set(reference_genomes)
        with tempfile.TemporaryDirectory() as td:
            sanitized = {p: _sanitize_fasta_headers(p, td) for p in genome_fasta_paths}
            ref_list = os.path.join(td, "refs.txt")
            with open(ref_list, "w") as f:
                f.write(
                    "\n".join(sanitized[p] for p in genome_fasta_paths if p in ref_set)
                    + "\n"
                )
            db = os.path.join(td, "refdb")
            _run_checked(["skani", "sketch", "-t", str(self.threads), "-l", ref_list, "-o", db])
            query_list = os.path.join(td, "queries.txt")
            with open(query_list, "w") as f:
                f.write(
                    "\n".join(sanitized[p] for p in genome_fasta_paths if p not in ref_set)
                    + "\n"
                )
            proc = _run_checked(
                [
                    "skani", "search", "-t", str(self.threads),
                    "--min-af", str(self.min_aligned_threshold * 100.0),
                    "--ql", query_list, "-d", db,
                ]
            )
            index = {sanitized[p]: i for i, p in enumerate(genome_fasta_paths)}
            return self._parse_sparse_tsv(proc.stdout, index, skip_self=True)

    def _parse_sparse_tsv(
        self, stdout: str, index, skip_self: bool = False
    ) -> SortedPairDistanceCache:
        cache = SortedPairDistanceCache()
        reader = csv.reader(stdout.splitlines(), delimiter="\t")
        next(reader, None)  # header
        for row in reader:
            if not row:
                continue
            p1, p2 = row[0], row[1]
            for p_ in (p1, p2):
                if p_ not in index:
                    # reference panics on an unmatched path
                    # (src/skani.rs:184-201) — corruption must surface,
                    # not silently drop pairs
                    raise RuntimeError(
                        f"Failed to find sanitized genome path: {p_}"
                    )
            i, j = index[p1], index[p2]
            if skip_self and i == j:
                continue
            ani = float(row[2])
            if ani >= self.threshold and i != j:
                cache.insert((i, j), ani)
        return cache


class SkaniClusterer(ClusterDistanceFinder):
    def __init__(
        self,
        threshold: float,
        min_aligned_threshold: float,
        small_genomes: bool = False,
    ) -> None:
        self.threshold = threshold
        self.min_aligned_threshold = min_aligned_threshold
        self.small_genomes = small_genomes

    def initialise(self) -> None:
        assert self.threshold > 1.0
        check_for_binary("skani")

    def method_name(self) -> str:
        return "skani"

    def get_ani_threshold(self) -> float:
        return self.threshold

    def calculate_ani(self, fasta1: str, fasta2: str) -> Optional[float]:
        """skani dist; an empty result (below --min-af) returns 0.0
        (src/skani.rs:758-787)."""
        with tempfile.TemporaryDirectory() as td:
            s1 = _sanitize_fasta_headers(fasta1, td)
            s2 = _sanitize_fasta_headers(fasta2, td)
            cmd = ["skani", "dist", "--min-af", str(self.min_aligned_threshold * 100.0)]
            if self.small_genomes:
                cmd.append("--small-genomes")
            cmd += ["-q", s1, "-r", s2]
            proc = _run_checked(cmd)
            reader = csv.reader(proc.stdout.splitlines(), delimiter="\t")
            next(reader, None)
            ani = 0.0
            for row in reader:
                if row:
                    ani = float(row[2])
                    break
            return ani


class FastaniClusterer(ClusterDistanceFinder):
    def __init__(
        self,
        threshold: float,
        min_aligned_threshold: float,
        fraglen: int = defaults.DEFAULT_FRAGMENT_LENGTH,
    ) -> None:
        self.threshold = threshold
        self.min_aligned_threshold = min_aligned_threshold
        self.fraglen = fraglen

    def initialise(self) -> None:
        assert self.threshold > 1.0
        check_for_binary("fastANI")

    def method_name(self) -> str:
        return "FastANI"

    def get_ani_threshold(self) -> float:
        return self.threshold

    def calculate_ani(self, fasta1: str, fasta2: str) -> Optional[float]:
        one = self._one_way(fasta1, fasta2)
        if one is None:
            return None
        two = self._one_way(fasta2, fasta1)
        if two is None:
            return None
        ani1, match1, total1 = one
        ani2, match2, total2 = two
        # AF from fragment counts, pass if either direction passes; ANI
        # is the max of the two directions (src/fastani.rs:55-65, the
        # fix for galah issue #7).
        if (
            match1 / total1 >= self.min_aligned_threshold
            or match2 / total2 >= self.min_aligned_threshold
        ):
            return max(ani1, ani2)
        return None

    def _one_way(self, q: str, r: str) -> Optional[Tuple[float, int, int]]:
        proc = _run_checked(
            [
                "fastANI", "-o", "/dev/stdout",
                "--fragLen", str(self.fraglen),
                "--query", q, "--ref", r,
            ]
        )
        for line in proc.stdout.splitlines():
            parts = line.split("\t")
            if len(parts) == 5:
                return float(parts[2]), int(parts[3]), int(parts[4])
        return None
