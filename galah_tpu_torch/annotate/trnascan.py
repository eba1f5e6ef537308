"""tRNAscan-SE backend (src/trnascan.rs).

Runs both bacterial (-B) and archaeal (-A) modes, keeps the higher
unique-standard-tRNA count (the 20 standard amino acids, column 5,
3 header lines skipped).

The port's own copy of galah_tpu/annotate/trnascan.py, so that the port
imports nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

import logging
import os
import subprocess

from galah_tpu_torch.engines.base import TrnaFinder

logger = logging.getLogger(__name__)

STANDARD_TRNAS = frozenset(
    [
        "Ala", "Arg", "Asn", "Asp", "Cys", "Gln", "Glu", "Gly", "His", "Ile",
        "Leu", "Lys", "Met", "Phe", "Pro", "Ser", "Thr", "Trp", "Tyr", "Val",
    ]
)


class TrnascanAnalyser(TrnaFinder):
    def find_trnas(self, genome_path: str, tmp_path: str) -> int:
        best = 0
        for mode in ("B", "A"):
            out_path = run_trnascan(genome_path, mode, tmp_path)
            count = count_unique_standard_trnas(out_path)
            best = max(best, count)
        return best

    def method_name(self) -> str:
        return "tRNAscan-SE"


def run_trnascan(genome_path: str, mode: str, out_dir: str) -> str:
    stem = os.path.splitext(os.path.basename(genome_path))[0]
    out_path = os.path.join(out_dir, f"{stem}.{mode}.trna.out")
    proc = subprocess.run(
        ["tRNAscan-SE", f"-{mode}", "-o", out_path, genome_path, "--thread", "1"],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        logger.info(
            "tRNAscan-SE run on %s failed with %d.\nstdout:\n%s\nstderr:\n%s",
            genome_path, proc.returncode, proc.stdout, proc.stderr,
        )
        raise RuntimeError("tRNAscan-SE did not run successfully")
    return out_path


def count_unique_standard_trnas(out_path: str) -> int:
    """src/trnascan.rs:64-83."""
    unique = set()
    with open(out_path) as f:
        lines = f.read().splitlines()
    for line in lines[3:]:
        fields = line.split("\t")
        if len(fields) < 6:
            continue
        trna_type = fields[4]
        if trna_type in STANDARD_TRNAS:
            unique.add(trna_type)
    return len(unique)
