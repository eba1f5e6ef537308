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


def test_digest_follows_headers_and_flags(fake_nvcc, monkeypatch):
    """A changed header, a new header or changed flags give a new build
    directory, so a library built from an old header is never reused."""
    csrc, calls, _ = fake_nvcc
    (csrc / "k.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// v1\n")
    first = _build._digest()
    assert _build._digest() == first
    (csrc / "common.cuh").write_text("// v2\n")
    second = _build._digest()
    assert second != first
    (csrc / "extra.h").write_text("// new\n")
    third = _build._digest()
    assert third not in (first, second)
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-lineinfo"])
    assert _build._digest() != third
    res = _build.build_library()
    assert res.path.parent.name == _build._digest()
    compile_cmd = calls()[0]
    assert compile_cmd[compile_cmd.index("-I") + 1] == str(csrc)


def test_defines_build_a_library_of_their_own(fake_nvcc):
    """Extra defines reach every compile and give their own build
    directory, beside the kernel library's."""
    csrc, calls, _ = fake_nvcc
    (csrc / "k.cu").write_text("// k\n")
    plain = _build.build_library()
    timed = _build.build_library(("GALAH_TIMING_VARIANTS",))
    assert not timed.cached and timed.path.parent != plain.path.parent
    assert timed.path.parent.name == _build._digest(("GALAH_TIMING_VARIANTS",))
    compiles = [c for c in calls() if "-c" in c]
    assert "-DGALAH_TIMING_VARIANTS" not in compiles[0]
    assert "-DGALAH_TIMING_VARIANTS" in compiles[1]
    assert _build.build_library().cached
