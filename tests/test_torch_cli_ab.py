"""The A/B runner of the port's CLI (galah_tpu_torch/tools/cli_ab.py) on
the CPU, at a small contig corpus: one tree run twice agrees with
itself, and each run reports its phases, sketch split and work, and
each tree its medians."""

import json
import os

from galah_tpu_torch.tools import cli_ab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_one_tree_twice_agrees(tmp_path, capsys, monkeypatch):
    # Device sketching on the CPU (K5's plain version), for its split.
    monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "1")
    rc = cli_ab.main([REPO, REPO, "--order", "AB", "--platform", "cpu",
                      "--out", str(tmp_path), "--families", "6",
                      "--members", "2", "--length", "3000"])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0
    runs = [json.loads(x) for x in lines if x.startswith('{"run"')]
    assert [r["run"] for r in runs] == ["0A", "1B"]
    for r in runs:
        assert r["tree"] == REPO
        assert r["peak_rss_bytes"] > 1 << 20
        assert r["work"]["contigs_sketched"] == 12
        assert r["work"]["clusters"] == 6
        assert "sketch" in r["phases_s"]
        assert {"lengths", "read", "kernel", "copy"} <= set(r["sketch_s"])
    last = json.loads(lines[-1])
    assert last["ok"] is True
    for letter, run in (("A", runs[0]), ("B", runs[1])):
        med = last["medians"][letter]
        assert med["runs"] == 1
        assert med["wall_clock_s"] == run["wall_clock_s"]
        assert med["phases_s.sketch"] == run["phases_s"]["sketch"]


def test_low_memory_runs_report_their_peak_rss(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "1")
    rc = cli_ab.main([REPO, REPO, "--order", "A", "--platform", "cpu",
                      "--corpus", "main", "--low-memory",
                      "--out", str(tmp_path), "--families", "2",
                      "--members", "2", "--length", "20000"])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0
    (run,) = [json.loads(x) for x in lines if x.startswith('{"run"')]
    assert run["work"]["genomes_sketched"] == 4
    assert run["work"]["clusters"] == 2
    last = json.loads(lines[-1])
    assert last["low_memory"] is True
    assert last["medians"]["A"]["peak_rss_bytes"] == run["peak_rss_bytes"]
