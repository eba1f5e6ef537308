"""galah_tpu_torch's kernel build, driven by a stand-in for nvcc.

The stand-in records its arguments and writes the file named by -o.
Every start of an nvcc process and every wait on one is logged in
order, so a test sees whether all compiles were started before the
build waited on any. The real nvcc runs on the card's machine
(chip_smoke.py, tests/test_torch_cuda.py)."""

import json
import sys
import textwrap

import pytest

from galah_tpu_torch.ops import _build

FAKE_NVCC = textwrap.dedent("""\
    import json, os, sys
    args = sys.argv[1:]
    log = os.environ["FAKE_NVCC_DIR"]
    with open(os.path.join(log, "calls.jsonl"), "a") as f:
        f.write(json.dumps(args) + "\\n")
    if "-c" in args:
        src = args[args.index("-c") + 1]
        if "broken" in src:
            print("error: broken source")
            sys.exit(2)
        print("ptxas info    : Used 40 registers")
    with open(args[args.index("-o") + 1], "w") as f:
        f.write("built")
""")


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    script = tmp_path / "nvcc.py"
    script.write_text(FAKE_NVCC)
    log = tmp_path / "log"
    log.mkdir()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setenv("FAKE_NVCC_DIR", str(log))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_find_nvcc", lambda: str(script))
    events = []

    class Popen(_real_popen):
        """Runs the stand-in under this Python; logs starts and waits."""

        def __init__(self, cmd, *a, **k):
            events.append("start")
            super().__init__([sys.executable, *cmd], *a, **k)

        def communicate(self, *a, **k):
            events.append("wait")
            return super().communicate(*a, **k)

    monkeypatch.setattr(_build.subprocess, "Popen", Popen)

    def calls():
        return [json.loads(line)
                for line in (log / "calls.jsonl").read_text().splitlines()]

    return csrc, calls, events


_real_popen = _build.subprocess.Popen


def test_one_nvcc_per_source_started_together_then_one_link(fake_nvcc):
    csrc, calls, events = fake_nvcc
    for name in ("a.cu", "b.cu", "c.cu"):
        (csrc / name).write_text(f"// {name}\n")
    res = _build.build_library()
    # Three compiles started before the first wait, then the link.
    assert events == ["start"] * 3 + ["wait"] * 3 + ["start", "wait"]
    assert not res.cached and res.path.read_text() == "built"
    assert res.log.count("Used 40 registers") == 3
    compiles, link = calls()[:3], calls()[3]
    assert sorted(c[c.index("-c") + 1].rsplit("/", 1)[1] for c in compiles) \
        == ["a.cu", "b.cu", "c.cu"]
    for c in compiles:
        assert "arch=compute_90a,code=sm_90a" in c and "-shared" not in c
    assert "-shared" in link and "arch=compute_90a,code=sm_90a" in link
    assert sorted(x.rsplit("/", 1)[1] for x in link if x.endswith(".o")) \
        == ["a.o", "b.o", "c.o"]
    assert sorted(p.name for p in res.path.parent.iterdir()) \
        == ["build.log", _build.LIB_NAME]
    again = _build.build_library()
    assert again.cached and again.path == res.path and len(calls()) == 4


def test_a_failed_compile_raises_with_its_output(fake_nvcc):
    csrc, calls, _ = fake_nvcc
    (csrc / "broken.cu").write_text("// broken\n")
    (csrc / "fine.cu").write_text("// fine\n")
    with pytest.raises(RuntimeError, match="error: broken source"):
        _build.build_library()
    assert not any(p.name == _build.LIB_NAME
                   for p in (_build.BUILD_ROOT).rglob("*"))
    assert not any("-shared" in c for c in calls())
