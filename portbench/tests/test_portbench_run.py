"""The harness end to end on the CPU at a tiny corpus: the result line,
the traced path, the import rules, and faults planted under the timed
path that the output check must catch."""

import ast
import os
import subprocess
import sys

import pytest

from conftest import CELLS, MANIFEST, ROOT, run_cell

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(tiny_cell, capsys, name, trace):
    rc, res, err = run_cell(capsys, name, trace=trace)
    assert rc == 0, err
    keys = list(res)
    want = REQUIRED + (["breakdown"] if trace else []) + ["check"]
    assert keys == want
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    if trace:
        assert res["attempted"] == 1
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(res["device"])
        listed = {m["name"]: m["source"] for m in MANIFEST["per_layer"]
                  if name in m["workloads"]}
        spans = {n for n, src in listed.items() if src == "program_span"}
        # Device-trace metrics read nothing on the CPU and are left out.
        assert spans <= set(res["metrics"]) <= set(listed)
    else:
        want = {m["name"] for m in MANIFEST["end_to_end"]
                if name in m.get("workloads", [name])}
        assert set(res["metrics"]) == want
        if "host_peak_gib" in want:
            assert res["metrics"]["host_peak_gib"]["value"] > 0.05
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    tail = err.strip().splitlines()[-len(res["check"]):]
    assert [t.split()[1] for t in tail] == list(res["check"])
    assert "work" in err


def test_work_counters_repeat_across_seeds(tiny_cell, capsys):
    works = []
    for seed in (11, 12, 2**31 + 1):
        rc, res, err = run_cell(capsys, "mag-catalogue.gut-skew", seed=seed,
                                seconds=0)
        assert rc == 0 and res["correct"]
        works.append([ln.split(" work ", 1)[1] for ln in err.splitlines()
                      if " work " in ln][0])
    assert works[0] == works[1] == works[2]


def test_no_card_no_result(monkeypatch, capsys):
    from portbench import run

    monkeypatch.setattr(run, "require_devices", lambda n: "no CUDA device")
    rc = run.main(["--workload", CELLS[0], "--seed", "1",
                   "--seconds", "1"])
    out, _ = capsys.readouterr()
    assert rc != 0 and out.strip() == ""


def _faults():
    """(name, patch) pairs; each patch breaks the verify under the timed
    path in one way."""
    from galah_tpu_torch.ops import fragment_ani

    real = fragment_ani.FragmentAniEngine.bidirectional

    def unchanged(self, pairs, sketches_by_key):
        return {}

    def half(self, pairs, sketches_by_key):
        pairs = list(pairs)
        return real(self, pairs[: len(pairs) // 2], sketches_by_key)

    def altered(self, pairs, sketches_by_key):
        # Every answer 0.1 points off, twice the widest ani_gap limit: the
        # check samples families, so a single altered pair may lie
        # outside its sample.
        out = real(self, pairs, sketches_by_key)
        return {k: (ani + 0.1, f, r) for k, (ani, f, r) in out.items()}

    return fragment_ani.FragmentAniEngine, {
        "returns_nothing": unchanged, "half_the_batch": half,
        "answer_altered": altered}


@pytest.mark.parametrize("fault", ["returns_nothing", "half_the_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(tiny_cell, capsys, monkeypatch, name,
                                      fault):
    cls, patches = _faults()
    monkeypatch.setattr(cls, "bidirectional", patches[fault])
    rc, res, err = run_cell(capsys, name)
    assert rc == 0, err
    assert res["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny_cell, capsys, name):
    import json

    from portbench import readings

    import torch

    rc = readings.main(["--workload", name, "--seeds", "21,22,23",
                        "--control"], device=torch.device("cpu"))
    out, _ = capsys.readouterr()
    rows = [json.loads(ln) for ln in out.splitlines() if ln.strip()]
    assert rc == 0 and len(rows) == 6
    program = [r for r in rows if r["side"] == "program"]
    control = [r for r in rows if r["side"] == "control"]
    assert all(r["correct"] for r in program)
    assert len(control) == 3 and not any(r["correct"] for r in control)
    assert all(r["numbers"]["ani_gap"] > 0.01 for r in control)


def test_harness_process_loads_no_jax(tmp_path):
    """A CPU run in a fresh process: no module named jax, jaxlib, flax or
    galah_tpu (whole top-level names) is loaded."""
    code = f"""
import json, sys, torch
sys.path.insert(0, {ROOT!r}); sys.path.insert(0, {os.path.join(ROOT, 'portbench', 'tests')!r})
from conftest import TINY
from portbench import cell as cellmod, run
real = cellmod.load_cell
def load(name, root=cellmod.ROOT):
    c = real(name, root); c.traffic = TINY[name]; return c
run.load_cell = load
rc = run.main(["--workload", {CELLS[0]!r}, "--seed", "5",
               "--seconds", "0"], device=torch.device("cpu"))
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"rc": rc, "tops": tops}}))
"""
    env = dict(os.environ, TMPDIR=str(tmp_path))
    env.pop("GALAH_TPU_PLATFORM", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    import json

    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["rc"] == 0, out.stderr[-2000:]
    assert "galah_tpu_torch" in res["tops"] and "portbench" in res["tops"]
    for bad in ("jax", "jaxlib", "flax", "galah_tpu"):
        assert bad not in res["tops"]


@pytest.mark.parametrize("module", ["reference.py", "check.py", "corpus.py",
                                    "roofline.py"])
def test_reference_imports_nothing_of_the_program(module):
    with open(os.path.join(ROOT, "portbench", module)) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"galah_tpu_torch", "galah_tpu", "jax", "jaxlib"}


@pytest.mark.cuda
def test_cell_on_the_card(capsys, tmp_path, monkeypatch):
    """Every cell's traced run on the card with the cell's own corpus;
    run it there with `python -m pytest --noconftest ... -m cuda`."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark runs on the card")
    import json

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        names = [w["name"] for w in json.load(fh)["workloads"]]
    for name in names:
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
             "--workload", name, "--seed", "77", "--seconds", "1",
             "--trace", "1"], capture_output=True, text=True, timeout=900,
            cwd=ROOT)
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
