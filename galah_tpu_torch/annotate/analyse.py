"""MIMAG analysis: quality + rRNA + tRNA -> MIMAG tier.

Parity with src/analyse.rs:
- precomputed-input bypasses for the CheckM2 report / CheckM1 table
  (:45-120), barrnap GFF list (:151-159), trnascan out list (:162-170);
- the MIMAG rule (:187-199): Low if completeness < 50 or
  contamination >= 10; Medium if completeness <= 90 or
  contamination >= 5 or any rRNA == 0 or tRNAs < 18; else High.

The port's own copy of galah_tpu/annotate/analyse.py, so that the port
imports nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from galah_tpu_torch.engines.base import QualityFinder, RrnaFinder, TrnaFinder
from galah_tpu_torch.quality.checkm import (
    read_checkm1_tab_table,
    read_checkm2_quality_report,
)

logger = logging.getLogger(__name__)


@dataclass
class GenomeOutput:
    completeness: float  # percentage
    contamination: float  # percentage
    r5s: int
    r16s: int
    r23s: int
    trnas: int
    mimag_quality: str


def mimag_tier(
    completeness: float, contamination: float, r5s: int, r16s: int, r23s: int, trnas: int
) -> str:
    """src/analyse.rs:187-199 (percent inputs)."""
    if completeness < 50.0 or contamination >= 10.0:
        return "Low quality"
    if (
        completeness <= 90.0
        or contamination >= 5.0
        or r5s == 0
        or r16s == 0
        or r23s == 0
        or trnas < 18
    ):
        return "Medium quality"
    return "High quality"


def analyse(
    genomes: Sequence[str],
    threads: int,
    quality_finder: Optional[QualityFinder],
    rrna_finder: RrnaFinder,
    trna_finder: TrnaFinder,
    checkm2_quality_report: Optional[str] = None,
    output_quality_report_path: Optional[str] = None,
    checkm_tab_table: Optional[str] = None,
    barrnap_gff_list: Optional[str] = None,
    trnascan_out_list: Optional[str] = None,
) -> Dict[str, GenomeOutput]:
    with tempfile.TemporaryDirectory() as tmp_path:
        # Quality: precomputed bypasses first (src/analyse.rs:45-120)
        if checkm2_quality_report:
            logger.info("Using pre-generated CheckM2 quality report: %s", checkm2_quality_report)
            result = read_checkm2_quality_report(checkm2_quality_report)
            quality_cache = _cache_from_result(result, genomes, "CheckM2")
        elif checkm_tab_table:
            logger.info("Using pre-generated CheckM tab table: %s", checkm_tab_table)
            result = read_checkm1_tab_table(checkm_tab_table)
            quality_cache = _cache_from_result(result, genomes, "CheckM1")
        else:
            quality_finder.prepare_comp_cont(list(genomes), threads, tmp_path)
            if output_quality_report_path:
                # Ask the finder where it wrote its report rather than
                # assuming the CheckM2 layout — any QualityFinder
                # implementation must work here.
                src = getattr(
                    quality_finder, "quality_report_source_path", None
                ) or os.path.join(tmp_path, "checkm2", "quality_report.tsv")
                parent = os.path.dirname(output_quality_report_path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                shutil.copy(src, output_quality_report_path)
            quality_cache = {
                g: quality_finder.find_comp_cont(g) for g in genomes
            }

        # rRNA (src/analyse.rs:151-159)
        if barrnap_gff_list:
            logger.info("Using pre-generated Barrnap GFF list: %s", barrnap_gff_list)
            rrna_cache = parse_barrnap_gff_list(barrnap_gff_list)
        else:
            rrna_cache = {g: rrna_finder.find_rrnas(g, tmp_path) for g in genomes}

        # tRNA (src/analyse.rs:162-170)
        if trnascan_out_list:
            logger.info("Using pre-generated tRNAscan-SE output list: %s", trnascan_out_list)
            trna_cache = parse_trnascan_out_list(trnascan_out_list)
        else:
            trna_cache = {g: trna_finder.find_trnas(g, tmp_path) for g in genomes}

    outputs: Dict[str, GenomeOutput] = {}
    for genome in genomes:
        completeness, contamination = quality_cache[genome]
        r5s, r16s, r23s = rrna_cache[genome]
        trnas = trna_cache[genome]
        outputs[genome] = GenomeOutput(
            completeness=completeness,
            contamination=contamination,
            r5s=r5s,
            r16s=r16s,
            r23s=r23s,
            trnas=trnas,
            mimag_quality=mimag_tier(
                completeness, contamination, r5s, r16s, r23s, trnas
            ),
        )
    return outputs


def _cache_from_result(result, genomes, label) -> Dict[str, Tuple[float, float]]:
    cache = {}
    for g in genomes:
        try:
            q = result.retrieve_via_fasta_path(g)
        except KeyError:
            raise ValueError(
                f"No {label} quality found for genome {g} "
                f"(stem {os.path.splitext(os.path.basename(g))[0]})"
            )
        cache[g] = (q.completeness * 100.0, q.contamination * 100.0)
    return cache


def parse_barrnap_gff_list(list_path: str) -> Dict[str, Tuple[int, int, int]]:
    """Two-column TSV genome -> GFF file (src/analyse.rs:217-242)."""
    from galah_tpu_torch.annotate.barrnap import parse_rrna_types

    cache = {}
    with open(list_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            fields = line.split("\t")
            if len(fields) != 2:
                raise ValueError(
                    f"Invalid line in Barrnap GFF list (expected 2 columns): {line}"
                )
            cache[fields[0]] = parse_rrna_types(fields[1])
    return cache


def parse_trnascan_out_list(list_path: str) -> Dict[str, int]:
    """Two-column TSV genome -> tRNAscan output (src/analyse.rs:245-268)."""
    from galah_tpu_torch.annotate.trnascan import count_unique_standard_trnas

    cache = {}
    with open(list_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            fields = line.split("\t")
            if len(fields) != 2:
                raise ValueError(
                    f"Invalid line in tRNAscan-SE output list (expected 2 columns): {line}"
                )
            cache[fields[0]] = count_unique_standard_trnas(fields[1])
    return cache
