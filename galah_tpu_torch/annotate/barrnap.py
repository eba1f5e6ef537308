"""Barrnap rRNA detection backend (src/barrnap.rs).

Runs both kingdoms (bac, arc), keeps the kingdom with the higher total
count, and counts 5S/16S/23S entries via the GFF `Name=` attribute.

The port's own copy of galah_tpu/annotate/barrnap.py, so that the port
imports nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

import logging
import os
import subprocess
from typing import Tuple

from galah_tpu_torch.engines.base import RrnaFinder

logger = logging.getLogger(__name__)


class BarrnapAnalyser(RrnaFinder):
    def find_rrnas(self, genome_path: str, tmp_path: str) -> Tuple[int, int, int]:
        best = (0, 0, 0)
        for kingdom in ("bac", "arc"):
            gff = run_barrnap(genome_path, kingdom, 1, tmp_path)
            counts = parse_rrna_types(gff)
            if sum(counts) > sum(best):
                best = counts
        return best

    def method_name(self) -> str:
        return "Barrnap"


def run_barrnap(genome_path: str, kingdom: str, threads: int, out_dir: str) -> str:
    stem = os.path.splitext(os.path.basename(genome_path))[0]
    gff_path = os.path.join(out_dir, f"{stem}.{kingdom}.gff")
    proc = subprocess.run(
        ["barrnap", "--kingdom", kingdom, "--threads", str(threads), genome_path],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        logger.info(
            "Barrnap run on %s failed with %d.\nstdout:\n%s\nstderr:\n%s",
            genome_path, proc.returncode, proc.stdout, proc.stderr,
        )
        raise RuntimeError("Barrnap did not run successfully")
    with open(gff_path, "w") as f:
        f.write(proc.stdout)
    return gff_path


def parse_rrna_types(gff_path: str) -> Tuple[int, int, int]:
    """Count 5S/16S/23S rRNA entries in a barrnap GFF
    (src/barrnap.rs:71-94)."""
    r5s = r16s = r23s = 0
    with open(gff_path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 9:
                continue
            for kv in fields[8].split(";"):
                if kv.startswith("Name="):
                    name = kv[len("Name="):]
                    if name == "5S_rRNA":
                        r5s += 1
                    elif name == "16S_rRNA":
                        r16s += 1
                    elif name == "23S_rRNA":
                        r23s += 1
                    break
    return (r5s, r16s, r23s)
