"""CheckM2 subprocess backend (completeness/contamination estimator).

Same subprocess contract as the reference (src/checkm2.rs:59-156):
genomes are symlinked as `<stem>.fna` into a staging dir, `checkm2
predict` runs once over the directory, and the quality_report.tsv is
parsed with path-stem fallback lookups. CheckM2 remains an external
pluggable tool — it is an ML model, not TPU kernel work.

The port's own copy of galah_tpu/annotate/checkm2_runner.py, so that the
port imports nothing of galah_tpu: same behaviour, file formats and
numerics.
"""

from __future__ import annotations

import logging
import os
import subprocess
from typing import Dict, Sequence, Tuple

from galah_tpu_torch.engines.base import QualityFinder
from galah_tpu_torch.quality.checkm import read_checkm2_quality_report

logger = logging.getLogger(__name__)


def run_checkm2_predict(
    genome_paths: Sequence[str], threads: int, tmp_path: str, database_path: str
) -> str:
    """Run checkm2 predict; returns the quality_report.tsv path."""
    genomes_dir = os.path.join(tmp_path, "genomes")
    os.makedirs(genomes_dir, exist_ok=True)
    for fasta in genome_paths:
        stem = os.path.splitext(os.path.basename(fasta))[0]
        os.symlink(os.path.realpath(fasta), os.path.join(genomes_dir, stem + ".fna"))

    checkm2_out = os.path.join(tmp_path, "checkm2")
    logger.info("Running CheckM2 on provided genomes...")
    proc = subprocess.run(
        [
            "checkm2", "predict",
            "-o", checkm2_out,
            "--threads", str(threads),
            "-i", genomes_dir,
            "--database_path", database_path,
        ],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        logger.info(
            "CheckM2 failed with %d.\nstdout:\n%s\nstderr:\n%s",
            proc.returncode, proc.stdout, proc.stderr,
        )
        raise RuntimeError("CheckM2 did not run successfully")

    report = os.path.join(checkm2_out, "quality_report.tsv")
    if not os.path.isfile(report):
        raise RuntimeError(
            f"CheckM2 did not produce quality_report.tsv at expected location: {report}"
        )
    return report


class CheckM2Analyser(QualityFinder):
    def __init__(self, database_path: str) -> None:
        self.database_path = database_path
        self.comp_cont_cache: Dict[str, Tuple[float, float]] = {}
        self.quality_report_source_path = None

    def prepare_comp_cont(
        self, genome_paths: Sequence[str], threads: int, tmp_path: str
    ) -> None:
        report = run_checkm2_predict(genome_paths, threads, tmp_path, self.database_path)
        self.quality_report_source_path = report
        result = read_checkm2_quality_report(report)
        for p in genome_paths:
            q = result.retrieve_via_fasta_path(p)
            self.comp_cont_cache[p] = (q.completeness * 100.0, q.contamination * 100.0)

    def find_comp_cont(self, genome_path: str) -> Tuple[float, float]:
        return self.comp_cont_cache[genome_path]

    def method_name(self) -> str:
        return "CheckM2"
