"""Quality filtering and greedy-priority ordering.

Parity with filter_genomes_through_checkm
(src/cluster_argument_parsing.rs:863-1157): genomes are filtered by
min-completeness/max-contamination and sorted descending by one of four
quality formulas; the resulting *order* is the greedy clustering
priority — the only coupling between quality and clustering.

Formulas (src/cluster_argument_parsing.rs:976-1137):
- completeness-4contamination:  comp - 4*cont
- completeness-5contamination:  comp - 5*cont
- Parks2020_reduced (default):  comp*100 - 5*cont*100
                                - 5*num_contigs/100
                                - 5*num_ambiguous_bases/100000
- dRep (CheckM1 only):          comp*100 - 5*cont*100
                                + cont*strain_heterogeneity
                                + 0.5*log10(N50)

(comp/cont are 0-1 fractions; descending stable sort.)

The port's own copy of galah_tpu/quality/filter.py, so that the port
imports nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

import logging
import math
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

from galah_tpu_torch.io.genome_stats import calculate_genome_stats
from galah_tpu_torch.quality.checkm import CheckMResult

logger = logging.getLogger(__name__)

QUALITY_FORMULAS = (
    "Parks2020_reduced",
    "completeness-4contamination",
    "completeness-5contamination",
    "dRep",
)


def _passes(q, min_completeness: Optional[float], max_contamination: Optional[float]) -> bool:
    if min_completeness is not None and q.completeness < min_completeness:
        return False
    if max_contamination is not None and q.contamination > max_contamination:
        return False
    return True


def filter_and_order_genomes(
    genome_paths: Sequence[str],
    checkm: CheckMResult,
    quality_formula: str,
    min_completeness: Optional[float] = None,  # fraction
    max_contamination: Optional[float] = None,  # fraction
    threads: int = 1,
    checkm1_for_drep: Optional[CheckMResult] = None,
) -> List[str]:
    """Returns surviving genome paths sorted descending by quality."""
    qualities = []
    for p in genome_paths:
        q = checkm.retrieve_via_fasta_path(p)  # raises if missing, like the reference
        qualities.append(q)

    kept = [
        (p, q)
        for p, q in zip(genome_paths, qualities)
        if _passes(q, min_completeness, max_contamination)
    ]

    if quality_formula in ("completeness-4contamination", "completeness-5contamination"):
        mult = 4.0 if quality_formula.startswith("completeness-4") else 5.0
        scored = [(p, q.completeness - mult * q.contamination) for p, q in kept]
    elif quality_formula == "Parks2020_reduced":
        logger.info("Calculating num_contigs etc. for genome quality assessment ..")
        stats = _genome_stats_parallel([p for p, _ in kept], threads)
        scored = [
            (
                p,
                q.completeness * 100.0
                - 5.0 * q.contamination * 100.0
                - 5.0 * st.num_contigs / 100.0
                - 5.0 * st.num_ambiguous_bases / 100000.0,
            )
            for (p, q), st in zip(kept, stats)
        ]
    elif quality_formula == "dRep":
        src = checkm1_for_drep or checkm
        logger.info("Calculating num_contigs etc. for genome quality assessment ..")
        stats = _genome_stats_parallel([p for p, _ in kept], threads)
        scored = []
        for (p, q), st in zip(kept, stats):
            het = src.retrieve_via_fasta_path(p).strain_heterogeneity
            if het is None:
                raise ValueError(
                    "dRep quality formula only works with CheckM v1 quality "
                    "scoring since it includes strain heterogeneity"
                )
            scored.append(
                (
                    p,
                    q.completeness * 100.0
                    - 5.0 * q.contamination * 100.0
                    + q.contamination * het
                    + 0.5 * math.log10(st.n50),
                )
            )
    else:
        raise ValueError(f"Unknown quality formula: {quality_formula}")

    # stable descending sort: ties keep input order (Rust sort_by parity,
    # src/cluster_argument_parsing.rs:1090-1094)
    scored.sort(key=lambda t: -t[1])
    logger.info(
        "Read in genome qualities for %d genomes. %d passed quality thresholds",
        len(checkm),
        len(scored),
    )
    return [p for p, _ in scored]


def _genome_stats_parallel(paths: Sequence[str], threads: int):
    if threads > 1 and len(paths) > 1:
        with ThreadPoolExecutor(max_workers=threads) as ex:
            return list(ex.map(calculate_genome_stats, paths))
    return [calculate_genome_stats(p) for p in paths]
