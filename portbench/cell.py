"""A cell as BENCHMARK.json names it: its configuration and traffic
files, the job's argument list, one job run in this process, and the
per-layer readers.

Everything is found by name: ``configs/<config>.json``,
``traffic/<config>.<traffic>.json`` and ``metrics/<metric>.py``, where
a metric's name up to its first dot names its reader: ``sketch_s.setup``
is ``sketch_s`` split off for cells whose metric it moves differs. A
cell added later adds files and entries; no file here names a cell.
"""

from __future__ import annotations

import importlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    manifest: dict
    workload: dict
    config: dict
    traffic: dict

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    @property
    def threads(self) -> int:
        return int(self.config["threads"])

    def per_layer(self) -> List[dict]:
        """The per-layer metrics this cell reports."""
        return [m for m in self.manifest["per_layer"]
                if self.name in m.get("workloads", [self.name])]

    def end_to_end(self) -> List[dict]:
        return [m for m in self.manifest["end_to_end"]
                if self.name in m.get("workloads", [self.name])]


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, root: str = ROOT) -> Cell:
    manifest = _json(os.path.join(root, "BENCHMARK.json"))
    workloads = {w["name"]: w for w in manifest["workloads"]}
    if name not in workloads:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = workloads[name]
    cfg = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = _json(os.path.join(root, cfg["file"]))
    traffic = _json(os.path.join(
        HERE, "traffic", f"{w['config']}.{w['traffic']}.json"))
    if traffic["kind"] != config["inputs"]:
        raise SystemExit(f"traffic {w['traffic']} makes {traffic['kind']}, "
                         f"configuration {w['config']} reads "
                         f"{config['inputs']}")
    return Cell(name, manifest, w, config, traffic)


def job_argv(cell: Cell, corpus, out_dir: str) -> List[str]:
    """The `cluster` command line a user would type for this corpus."""
    argv = ["cluster", *cell.config["flags"], "--threads", str(cell.threads)]
    if corpus.kind == "genomes":
        argv += ["--genome-fasta-list", corpus.paths["list"],
                 "--checkm2-quality-report", corpus.paths["quality"]]
    else:
        argv += ["-f", corpus.paths["fasta"]]
    return argv + [
        "--output-cluster-definition", os.path.join(out_dir, "clusters.tsv"),
        "--output-distance-cache", os.path.join(out_dir, "distances.npz"),
    ]


@dataclass
class JobRecord:
    wall_s: float
    rc: int
    out_dir: str
    phases: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)


# The work counters printed for each job; they must repeat across seeds.
WORK_COUNTERS = ("sketch_bases", "screen_tiles", "screen_pairs_computed",
                 "verify_directed_pairtable", "verify_directed_grouped")


def run_job(argv: Sequence[str], out_dir: str) -> JobRecord:
    """One `cluster` job through the port's CLI entry, in this process.
    The wall runs from the call to its return, after clusters.tsv is
    written."""
    from galah_tpu_torch.cli.main import main as cli_main
    from galah_tpu_torch.utils import metrics

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    try:
        rc = cli_main(list(argv))
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    wall = time.perf_counter() - t0
    m = metrics.current()
    return JobRecord(wall, int(rc or 0), out_dir, dict(m.phases),
                     dict(m.counters))


def work_line(job: JobRecord, clusters: int) -> str:
    counts = {k: int(job.counters.get(k, 0)) for k in WORK_COUNTERS}
    counts["clusters"] = clusters
    return json.dumps(counts, sort_keys=True)


@dataclass
class LayerContext:
    """What a per-layer reader may read: the traced job's phases and
    counters, the trace, and the corpus with the configuration's sketch
    rules."""

    phases: Dict[str, float]
    counters: Dict[str, float]
    trace: object
    corpus: object
    sketch: dict
    max_file_bytes: int
    member_bits: int
    wall_s: Optional[float] = None

    def device_seconds(self, names: Sequence[str]) -> float:
        if self.trace is None:
            return 0.0
        return sum(s for n, s in self.trace.device_s.items()
                   if any(k in n for k in names))


def reader(metric: str):
    base = metric.split(".", 1)[0]
    return importlib.import_module(f"portbench.metrics.{base}")


def all_kernel_names(metrics: Sequence[dict]) -> List[str]:
    out: List[str] = []
    for m in metrics:
        out += list(getattr(reader(m["name"]), "KERNELS", ()))
    return out
