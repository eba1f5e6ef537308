"""The output check: what the timed job wrote, against the plain
reference (``reference.py``).

The job writes two outputs the check reads: ``clusters.tsv``
(representative, member) and the distance cache (``--output-distance-
cache``: every pair that passed the ANI and AF thresholds, with its
ANI). They carry the whole pipeline's result: a unit sketched wrongly
moves its ANI; a pair the screen dropped or the verify failed is
missing; a pair let through wrongly is extra; the clustering shows in
clusters.tsv. AF enters only through which pairs pass: the cache holds
ANI alone.

The check covers the units of a sample of families drawn from the seed,
the largest family always among them. For those units the reference
sketches every unit, works out every within-family pair, pairs with
other sampled families drawn from the seed, and every pair the job
reported for them, and clusters them greedily. The numbers compared:

- ``ani_gap``: the largest |ANI| gap (percentage points) over the pairs
  both report;
- ``pairs_missing``: pairs the reference passes that the job left out;
- ``pairs_extra``: pairs the job reported that the reference fails;
- ``clusters_differ``: checked units whose cluster (representative and
  members) differs;
- ``jobs_differ``: window jobs whose clusters.tsv differs from the
  checked job's.
"""

from __future__ import annotations

import csv
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from portbench import reference as ref
from portbench.corpus import Corpus, cross_pairs, sample_families

# Pairs the job reports for checked units with a partner outside the
# sample are sketched and judged up to this many partners; the rest
# count as extra unjudged.
MAX_OUTSIDE = 64


@dataclass
class JobOutput:
    """What one job wrote: {(u, v) with u < v: ANI} over unit indices,
    and each unit's cluster as (representative, members)."""

    pairs: Dict[Tuple[int, int], float]
    cluster_of: Dict[int, Tuple[int, frozenset]]


def read_job_output(corpus: Corpus, clusters_tsv: str,
                    cache_npz: str) -> JobOutput:
    index = {u.name: i for i, u in enumerate(corpus.units)}
    with np.load(cache_npz, allow_pickle=False) as z:
        names = [str(n) for n in z["names"]]
        ii, jj, vals = z["i"], z["j"], z["values"]
    units = [index[n] for n in names]
    pairs = {}
    for i, j, v in zip(ii.tolist(), jj.tolist(), vals.tolist()):
        a, b = units[i], units[j]
        pairs[(min(a, b), max(a, b))] = float(v)
    members: Dict[int, Set[int]] = {}
    with open(clusters_tsv, newline="") as fh:
        for rep, mem in csv.reader(fh, delimiter="\t"):
            members.setdefault(index[rep], set()).add(index[mem])
    cluster_of = {}
    for rep, ms in members.items():
        fz = frozenset(ms)
        for m in ms:
            cluster_of[m] = (rep, fz)
    return JobOutput(pairs, cluster_of)


def priority_order(corpus: Corpus, units: Sequence[int],
                   records: Dict[int, List[Tuple[str, np.ndarray]]]
                   ) -> List[int]:
    """The units in the job's priority order. Contigs: file order.
    Genomes: descending Parks2020_reduced score from the quality report
    and each genome's own contig and ambiguous-base counts, ties in
    input order (a stable sort)."""
    units = sorted(units)
    if corpus.kind == "contigs":
        return units
    quality = {}
    with open(corpus.paths["quality"], newline="") as fh:
        rd = csv.reader(fh, delimiter="\t")
        head = next(rd)
        n, c, x = (head.index("Name"), head.index("Completeness"),
                   head.index("Contamination"))
        for row in rd:
            quality[row[n]] = (float(row[c]) / 100.0, float(row[x]) / 100.0)
    scored = []
    for u in units:
        stem = corpus.units[u].name.rsplit("/", 1)[-1].rsplit(".", 1)[0]
        comp, cont = quality[stem]
        recs = records[u]
        ambiguous = sum(int(np.count_nonzero((s == ord("N")) | (s == ord("n"))))
                        for _, s in recs)
        score = (comp * 100.0 - 5.0 * cont * 100.0 - 5.0 * len(recs) / 100.0
                 - 5.0 * ambiguous / 100000.0)
        scored.append((u, score))
    scored.sort(key=lambda t: -t[1])
    return [u for u, _ in scored]


class Reference:
    """The reference's sketches of the checked units, made on demand."""

    def __init__(self, corpus: Corpus, sketch: dict,
                 device: torch.device) -> None:
        self.corpus = corpus
        self.device = device
        files = ([u.name for u in corpus.units] if corpus.kind == "genomes"
                 else [corpus.paths["fasta"]])
        self.rules = ref.rules_for(sketch, ref.file_bytes(files))
        self.records: Dict[int, List[Tuple[str, np.ndarray]]] = {}
        self.sketches: Dict[int, ref.UnitSketch] = {}
        self.bitmaps: Dict[int, torch.Tensor] = {}

    def load(self, units: Sequence[int]) -> None:
        todo = sorted(set(units) - set(self.records))
        if not todo:
            return
        if self.corpus.kind == "genomes":
            for u in todo:
                self.records[u] = ref.read_fasta_records(
                    self.corpus.units[u].name)
        else:
            recs = ref.read_fasta_records(self.corpus.paths["fasta"], todo)
            for u, rec in zip(todo, recs):
                if rec[0] != self.corpus.units[u].name:
                    raise ValueError(f"record {u} is {rec[0]}")
                self.records[u] = [rec]
        made = ref.sketch_units(
            [[s for _, s in self.records[u]] for u in todo], self.rules,
            self.device)
        for u, (sk, bm) in zip(todo, made):
            self.sketches[u] = sk
            self.bitmaps[u] = bm

    def results(self, pairs, dtype=torch.float64):
        return ref.pair_results(self.sketches, self.bitmaps, pairs,
                                self.rules, dtype)


@dataclass
class Limits:
    ani_gap: float
    pairs_missing: int = 0
    pairs_extra: int = 0
    clusters_differ: int = 0
    jobs_differ: int = 0


@dataclass
class CheckResult:
    numbers: Dict[str, float]
    limits: Dict[str, float]
    info: Dict[str, float]

    @property
    def correct(self) -> bool:
        return all(self.numbers[k] <= self.limits[k] for k in self.limits)

    def lines(self) -> List[str]:
        return [f"check {k} {self.numbers[k]!r} limit {self.limits[k]!r}"
                for k in self.limits]

    def as_json(self) -> dict:
        return {k: {"value": self.numbers[k], "limit": self.limits[k]}
                for k in self.limits}


def check_job(corpus: Corpus, traffic: dict, config: dict, seed: int,
              job: JobOutput, jobs_differ: int, device: torch.device,
              limits: Limits, program: Optional[str] = "job",
              dtype=torch.float64) -> CheckResult:
    """Judge `job` against the reference. With program="control" the
    job's outputs are replaced by the reference's own in `dtype`
    (bfloat16: the control)."""
    t0 = time.perf_counter()
    check = traffic["check"]
    ani_pct = float(config["check"]["ani"])
    min_af = float(config["check"]["min_af"])
    fams = sample_families(corpus, check, seed)
    units = sorted(u for f in fams for u in corpus.families[f])
    unit_set = set(units)
    reference = Reference(corpus, config["sketch"], device)
    reference.load(units)

    pairs: Set[Tuple[int, int]] = set()
    for f in fams:
        fam = sorted(corpus.families[f])
        pairs.update((a, b) for i, a in enumerate(fam) for b in fam[i + 1:])
    pairs.update(cross_pairs(corpus, units, int(check["cross_per_unit"]),
                             seed))
    outside_unjudged = 0
    if program == "job":
        reported = [p for p in job.pairs if p[0] in unit_set or p[1] in
                    unit_set]
        outside = sorted({v for p in reported for v in p} - unit_set)
        judged_outside = set(outside[:MAX_OUTSIDE])
        reference.load(judged_outside)
        for p in reported:
            if all(v in unit_set or v in judged_outside for v in p):
                pairs.add(p)
            else:
                outside_unjudged += 1
    pairs_l = sorted(pairs)
    res = reference.results(pairs_l)
    ref_pass = {p: r[0] for p, r in res.items()
                if ref.passes(r, ani_pct, min_af)}

    if program == "control":
        ctl = reference.results(pairs_l, dtype)
        prog_pairs = {p: float(np.float32(r[0])) for p, r in ctl.items()
                      if ref.passes(r, ani_pct, min_af)}
        order = priority_order(corpus, units, reference.records)
        ctl_clusters = ref.greedy_clusters(order, prog_pairs, ani_pct)
        cluster_of = {}
        for rep, ms in ctl_clusters.items():
            for m in ms:
                cluster_of[m] = (rep, frozenset(ms))
    else:
        prog_pairs = {p: v for p, v in job.pairs.items()
                      if p[0] in unit_set or p[1] in unit_set}
        cluster_of = job.cluster_of

    missing = sum(1 for p in ref_pass if p not in prog_pairs)
    extra = outside_unjudged + sum(1 for p in prog_pairs
                                   if p in res and p not in ref_pass)
    both = [p for p in ref_pass if p in prog_pairs]
    gap = max((abs(prog_pairs[p] - ref_pass[p]) for p in both), default=0.0)

    in_sample = {p: v for p, v in ref_pass.items()
                 if p[0] in unit_set and p[1] in unit_set}
    order = priority_order(corpus, units, reference.records)
    ref_clusters = ref.greedy_clusters(order, in_sample, ani_pct)
    ref_of = {}
    for rep, ms in ref_clusters.items():
        for m in ms:
            ref_of[m] = (rep, frozenset(ms))
    differ = sum(1 for u in units if cluster_of.get(u) != ref_of[u])

    anis = list(ref_pass.values())
    info = {
        "families": len(fams), "units": len(units), "pairs": len(pairs_l),
        "pairs_passing": len(ref_pass), "pairs_compared": len(both),
        "reference_clusters": len(ref_clusters),
        "ani_min": min(anis) if anis else float("nan"),
        "seconds": time.perf_counter() - t0,
    }
    numbers = {"ani_gap": float(gap), "pairs_missing": missing,
               "pairs_extra": extra, "clusters_differ": differ,
               "jobs_differ": jobs_differ}
    return CheckResult(numbers, vars(limits).copy(), info)
