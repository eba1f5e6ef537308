"""Shared fixtures of the benchmark's CPU tests: tiny cells that the
harness runs end to end on the CPU, with the look for a card skipped."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

with open(os.path.join(ROOT, "BENCHMARK.json")) as _fh:
    MANIFEST = json.load(_fh)

# The cells BENCHMARK.json runs; each has tiny traffic below.
CELLS = sorted(w["name"] for w in MANIFEST["workloads"])

# Tiny traffic of each kind, shaped as the cells' traffic files are.
TINY = {
    "mag-catalogue.gut-skew": {
        "kind": "genomes", "families": [[1, 4], [1, 3], [3, 1]],
        "length_min": 30000, "length_max": 50000, "identity": 0.985,
        "contigs_per_genome": 5, "contig_min": 2000, "line_width": 80,
        "check": {"families": {"4": 1, "3": 1, "1": 2}, "cross_per_unit": 2}},
    "viral-contigs.votu": {
        "kind": "contigs", "families": [[2, 5], [3, 2], [10, 1]],
        "length": 5000, "identity": 0.985, "line_width": 80,
        "check": {"families": {"5": 1, "2": 2, "1": 3}, "cross_per_unit": 2}},
}


@pytest.fixture
def tiny_cell(monkeypatch, tmp_path):
    """load_cell with the named cell's traffic swapped for a tiny one;
    TMPDIR under the test's own directory."""
    from portbench import cell as cellmod
    from portbench import readings, run

    real = cellmod.load_cell

    def load(name, root=cellmod.ROOT):
        c = real(name, root)
        c.traffic = json.loads(json.dumps(TINY[name]))
        return c

    monkeypatch.setattr(run, "load_cell", load)
    monkeypatch.setattr(readings, "load_cell", load)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    for var in list(os.environ):
        if var.startswith("GALAH_TPU_"):
            monkeypatch.delenv(var)
    import torch

    saved, threads = dict(os.environ), torch.get_num_threads()
    yield load
    os.environ.clear()
    os.environ.update(saved)
    torch.set_num_threads(threads)


def run_cell(capsys, name, trace=0, seed=3000000019, seconds=0.5):
    """Run the harness on the CPU; (exit code, last stdout line as JSON
    or None, stderr)."""
    import torch

    from portbench import run

    rc = run.main(["--workload", name, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)],
                  device=torch.device("cpu"))
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines else None), err
