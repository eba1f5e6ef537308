"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
finds its files."""

import json
import os
import re

from conftest import ROOT, TINY

with open(os.path.join(ROOT, "BENCHMARK.json")) as _fh:
    MANIFEST = json.load(_fh)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(MANIFEST) == TOP
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    for word in MANIFEST["command"]:
        assert not word.startswith("/") and ".." not in word
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_and_units_use_allowed_characters():
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[key]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
            for text in ("why", "layer", "source"):
                if text in entry:
                    assert 1 <= len(entry[text]) <= 200
                    assert "\n" not in entry[text] and "\t" not in entry[text]
    assert len(names) == len(set(names))
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_every_cell_finds_its_files():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        with open(os.path.join(ROOT, c["file"])) as fh:
            assert json.load(fh)["reduced"] == c["reduced"]
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in configs
        assert w["name"] in TINY, "the CPU tests run each cell at tiny size"
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "traffic", f"{w['config']}.{w['traffic']}.json"))
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(MANIFEST["workloads"])


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert set(e2e) == {"job_s", "setup_s", "host_peak_gib"}
    for m in MANIFEST["end_to_end"]:
        assert m["source"] == "host_clock" and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for cell in cells:
        names = {n for n, m in e2e.items() if _reports(m, cell)}
        assert "setup_s" in names and len(names) >= 2, cell
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)
        base = m["name"].split(".", 1)[0]
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           base + ".py"))
        if base.endswith("_roofline"):
            assert m["unit"] == "%" and m["source"] == "device_trace"
    for cell in cells:
        assert any(cell in m["workloads"] for m in MANIFEST["per_layer"])


def test_file_names_use_name_characters():
    for dp, _, fs in os.walk(os.path.join(ROOT, "portbench")):
        for f in fs:
            rel = os.path.relpath(os.path.join(dp, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel
