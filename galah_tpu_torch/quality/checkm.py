"""CheckM1 / CheckM2 / dRep-genome-info quality parsers.

Replaces the reference's linked `checkm` crate plus
src/genome_info_file.rs. Behavior parity:
- completeness/contamination stored as 0-1 fractions (multiplied by 100
  at use; src/checkm2.rs:132-134, src/cluster_argument_parsing.rs:1078);
- lookups are keyed by genome name with a fasta-path stem fallback
  (src/checkm2.rs:123-154, src/analyse.rs:52-81);
- the genome-info CSV requires the exact header
  `genome,completeness,contamination`, stores values /100, and rejects
  duplicate genomes (src/genome_info_file.rs:20-79).

The port's own copy of galah_tpu/quality/checkm.py, so that the port
imports nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class GenomeQuality:
    completeness: float        # fraction 0-1
    contamination: float       # fraction 0-1
    strain_heterogeneity: Optional[float] = None  # 0-100, CheckM1 only


_FASTA_EXTENSIONS = (
    ".fna", ".fa", ".fasta", ".fna.gz", ".fa.gz", ".fasta.gz", ".gz",
)


def _stems(path: str):
    """Candidate lookup keys for a fasta path: basename, basename minus
    the final extension, and minus any known fasta extension chain."""
    base = os.path.basename(path)
    yield base
    stem, ext = os.path.splitext(base)
    if ext:
        yield stem
    low = base.lower()
    for e in _FASTA_EXTENSIONS:
        if low.endswith(e):
            yield base[: -len(e)]


class CheckMResult:
    """Genome-name-keyed quality map with path-stem retrieval."""

    def __init__(self, genome_to_quality: Dict[str, GenomeQuality]) -> None:
        self.genome_to_quality = genome_to_quality

    def retrieve_via_fasta_path(self, path: str) -> GenomeQuality:
        for key in _stems(path):
            q = self.genome_to_quality.get(key)
            if q is not None:
                return q
        raise KeyError(f"Failed to find quality statistics for {path}")

    def contains_fasta_path(self, path: str) -> bool:
        return any(k in self.genome_to_quality for k in _stems(path))

    def __len__(self) -> int:
        return len(self.genome_to_quality)


def read_checkm1_tab_table(path: str) -> CheckMResult:
    """CheckM v1 `--tab_table` output: columns looked up by header name
    (`Bin Id`, `Completeness`, `Contamination`, `Strain heterogeneity`)."""
    out: Dict[str, GenomeQuality] = {}
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter="\t")
        header = next(reader)
        try:
            bin_col = header.index("Bin Id")
            comp_col = header.index("Completeness")
            cont_col = header.index("Contamination")
        except ValueError as e:
            raise ValueError(f"Unexpected CheckM tab table header in {path}: {e}")
        het_col = header.index("Strain heterogeneity") if "Strain heterogeneity" in header else None
        for row in reader:
            if not row:
                continue
            out[row[bin_col]] = GenomeQuality(
                completeness=float(row[comp_col]) / 100.0,
                contamination=float(row[cont_col]) / 100.0,
                strain_heterogeneity=(
                    float(row[het_col]) if het_col is not None else None
                ),
            )
    return CheckMResult(out)


def read_checkm2_quality_report(path: str) -> CheckMResult:
    """CheckM2 `quality_report.tsv`: `Name`, `Completeness`,
    `Contamination` columns."""
    out: Dict[str, GenomeQuality] = {}
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter="\t")
        header = next(reader)
        try:
            name_col = header.index("Name")
            comp_col = header.index("Completeness")
            cont_col = header.index("Contamination")
        except ValueError as e:
            raise ValueError(f"Unexpected CheckM2 quality report header in {path}: {e}")
        for row in reader:
            if not row:
                continue
            out[row[name_col]] = GenomeQuality(
                completeness=float(row[comp_col]) / 100.0,
                contamination=float(row[cont_col]) / 100.0,
            )
    return CheckMResult(out)


def read_genome_info_file(path: str) -> CheckMResult:
    """dRep-style genome info CSV (src/genome_info_file.rs:20-79)."""
    out: Dict[str, GenomeQuality] = {}
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        if header != ["genome", "completeness", "contamination"]:
            raise ValueError("Incorrect headers found in genomeInfo file")
        for row in reader:
            if not row:
                continue
            if len(row) != 3:
                raise ValueError(
                    f"Parsing error in genomeInfo file - didn't find 3 columns in line {row!r}"
                )
            if row[0] in out:
                raise ValueError(
                    f"The genome {row[0]} was found multiple times in the checkm file {path}"
                )
            out[row[0]] = GenomeQuality(
                completeness=float(row[1]) / 100.0,
                contamination=float(row[2]) / 100.0,
            )
    return CheckMResult(out)
