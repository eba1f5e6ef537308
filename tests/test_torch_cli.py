"""The port's `cluster` CLI as a whole, against the JAX package's.

The same synthetic corpus through `galah_tpu` and `galah_tpu_torch`
must give byte-identical clusters.tsv with the families exact. The JAX
side is pinned to the path the port implements: the packed screen on
one device (this test session exposes 8 virtual CPU devices, which
would otherwise send it down the sharded sweep)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from galah_tpu.cli.main import main as jax_main
from galah_tpu.utils.synth import make_contig_corpus, make_families
from galah_tpu_torch.cli.main import main as torch_main
from galah_tpu_torch.utils.device import NO_CUDA_MESSAGE, resolve_device

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_corpus")
    paths, fams = make_families(str(d), 4, 4, genome_length=60_000, seed=3)
    return str(d), paths, fams


@pytest.fixture(scope="module")
def contig_corpus(tmp_path_factory):
    """40 families of 5 contigs of 5 kb in one FASTA."""
    path = tmp_path_factory.mktemp("contig_corpus") / "contigs.fna"
    names, fams = make_contig_corpus(str(path), 40, 5, contig_length=5_000,
                                     seed=21)
    return str(path), names, fams


def _cluster_argv(corpus_dir: str, out: Path):
    return ["cluster", "-d", corpus_dir, "-x", "fna", "--ani", "95",
            "--output-cluster-definition", str(out), "-q"]


def test_clusters_tsv_identical_to_jax_package(corpus, tmp_path, monkeypatch):
    d, paths, fams = corpus
    monkeypatch.setenv("GALAH_TPU_SCREEN", "packed")
    monkeypatch.setenv("GALAH_TPU_VERIFY_DEVICES", "1")
    monkeypatch.delenv("GALAH_TPU_PLATFORM", raising=False)
    assert jax_main(_cluster_argv(d, tmp_path / "jax.tsv")) == 0
    monkeypatch.setenv("GALAH_TPU_PLATFORM", "cpu")
    assert torch_main(_cluster_argv(d, tmp_path / "torch.tsv")) == 0
    got = (tmp_path / "torch.tsv").read_bytes()
    assert got == (tmp_path / "jax.tsv").read_bytes()
    fam_of = dict(zip(paths, fams))
    clusters = {}
    for line in got.decode().splitlines():
        rep, member = line.split("\t")
        clusters.setdefault(rep, set()).add(fam_of[member])
    assert len(clusters) == 4
    assert all(len(f) == 1 for f in clusters.values())
    assert sorted(f.pop() for f in clusters.values()) == [0, 1, 2, 3]


def _both_clis(argv, tmp_path, monkeypatch, screen, expect):
    """clusters.tsv of the JAX CLI and the port's on the same argv,
    after checking that the port ran the screen `expect` names, as
    (function, cache_blocks): a sequential screen, or the overlapped
    phases (_run_pipelined)."""
    from galah_tpu_torch.engines import native

    calls = []

    def spy(fn):
        def run(*a, **k):
            calls.append((fn.__name__, k.get("cache_blocks")))
            return fn(*a, **k)
        return run

    for name in ("screen_triangle_packed", "screen_triangle_popcount",
                 "screen_rectangle_packed"):
        monkeypatch.setattr(native, name, spy(getattr(native, name)))
    monkeypatch.setattr(native.NativePreclusterer, "_run_pipelined",
                        spy(native.NativePreclusterer._run_pipelined))
    monkeypatch.setenv("GALAH_TPU_SCREEN", screen)
    monkeypatch.setenv("GALAH_TPU_VERIFY_DEVICES", "1")
    monkeypatch.delenv("GALAH_TPU_PLATFORM", raising=False)
    out = []
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        if name == "torch":
            monkeypatch.setenv("GALAH_TPU_PLATFORM", "cpu")
        tsv = tmp_path / f"{name}.tsv"
        assert main(argv + ["--output-cluster-definition", str(tsv)]) == 0
        out.append(tsv.read_bytes())
    assert calls == [expect]
    assert out[0] == out[1]
    return out[1].decode()


def _families(tsv, paths, fams):
    """{representative: set of member families}, every cluster one family."""
    fam_of = dict(zip(paths, fams))
    clusters = {}
    for line in tsv.splitlines():
        rep, member = line.split("\t")
        clusters.setdefault(rep, set()).add(fam_of[member])
    assert all(len(f) == 1 for f in clusters.values())
    return clusters


@pytest.mark.parametrize("mode,screen,expect", [
    (["--low-memory"], "packed", ("screen_triangle_packed", False)),
    ([], "popcount", ("screen_triangle_popcount", None)),
])
def test_low_memory_and_popcount_match_jax_package(
    corpus, tmp_path, monkeypatch, mode, screen, expect
):
    d, paths, fams = corpus
    argv = ["cluster", "-d", d, "-x", "fna", "--ani", "95", "-q"] + mode
    tsv = _both_clis(argv, tmp_path, monkeypatch, screen, expect)
    assert len(_families(tsv, paths, fams)) == 4


def test_reference_genomes_list_matches_jax_package(
    corpus, tmp_path, monkeypatch
):
    """The first genome of each family is a reference; the rest are
    clustered against them: one cluster per family, holding its
    reference."""
    d, paths, fams = corpus
    refs = [paths[fams.index(f)] for f in sorted(set(fams))]
    (tmp_path / "refs.txt").write_text("".join(p + "\n" for p in refs))
    (tmp_path / "genomes.txt").write_text(
        "".join(p + "\n" for p in paths if p not in refs))
    argv = ["cluster", "--genome-fasta-list", str(tmp_path / "genomes.txt"),
            "--reference-genomes-list", str(tmp_path / "refs.txt"),
            "--ani", "95", "-q"]
    tsv = _both_clis(argv, tmp_path, monkeypatch, "packed",
                     ("screen_rectangle_packed", True))
    clusters = _families(tsv, paths, fams)
    assert len(clusters) == 4
    members = {}
    for line in tsv.splitlines():
        rep, member = line.split("\t")
        members.setdefault(rep, set()).add(member)
    assert all(len(set(refs) & m) == 1 for m in members.values())


def test_reference_flags_are_exclusive_and_refuse_contigs(
    corpus, tmp_path, monkeypatch
):
    d, paths, _ = corpus
    monkeypatch.setenv("GALAH_TPU_PLATFORM", "cpu")
    base = _cluster_argv(d, tmp_path / "x.tsv")
    with pytest.raises(SystemExit, match="mutually exclusive"):
        torch_main(base + ["--reference-genomes", paths[0],
                           "--reference-genomes-list", "refs.txt"])
    with pytest.raises(SystemExit):
        torch_main(base + ["--reference-genomes", paths[0],
                           "--cluster-contigs", "--small-contigs"])
    assert not (tmp_path / "x.tsv").exists()


def test_indicator_screen_is_refused(corpus, tmp_path, monkeypatch, capsys):
    """The u8 indicator screen, which earlier slices of the port
    refused, now runs under GALAH_TPU_SCREEN=indicator and gives the JAX
    CLI's clusters.tsv (tests/test_torch_indicator.py holds its other
    modes and dtypes)."""
    d, paths, fams = corpus
    monkeypatch.setenv("GALAH_TPU_SCREEN", "indicator")
    monkeypatch.setenv("GALAH_TPU_VERIFY_DEVICES", "1")
    monkeypatch.delenv("GALAH_TPU_PLATFORM", raising=False)
    assert jax_main(_cluster_argv(d, tmp_path / "jax.tsv")) == 0
    monkeypatch.setenv("GALAH_TPU_PLATFORM", "cpu")
    assert torch_main(_cluster_argv(d, tmp_path / "x.tsv")) == 0
    assert "not yet supported" not in capsys.readouterr().err
    got = (tmp_path / "x.tsv").read_text()
    assert got == (tmp_path / "jax.tsv").read_text()
    assert len(_families(got, paths, fams)) == 4


@pytest.mark.parametrize("device_sketch", ["1", "0"])
def test_contig_mode_matches_jax_package(contig_corpus, tmp_path, monkeypatch,
                                         device_sketch):
    """--cluster-contigs --small-contigs: the port, sketching on the
    "device" (the plain version of K5 on the CPU, with the phases
    overlapped) or on the host, gives the JAX CLI's clusters.tsv, one
    cluster per contig family."""
    from galah_tpu_torch.ops import device_sketch as ds

    path, names, fams = contig_corpus
    monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", device_sketch)
    argv = ["cluster", "-f", path, "--cluster-contigs", "--small-contigs",
            "--ani", "95", "-q"]
    spied = []
    real = ds.sketch_host_batch
    monkeypatch.setattr(ds, "sketch_host_batch",
                        lambda *a, **k: spied.append(1) or real(*a, **k))
    expect = (("_run_pipelined", None) if device_sketch == "1"
              else ("screen_triangle_packed", True))
    tsv = _both_clis(argv, tmp_path, monkeypatch, "packed", expect)
    assert bool(spied) == (device_sketch == "1")
    clusters = _families(tsv, names, fams)
    assert len(clusters) == 40
    assert len(tsv.splitlines()) == len(names)


def _write_contigs(path: Path, names):
    path.write_text("".join(f">{n}\nACGTACGTTTGACCA\n" for n in names))
    return str(path)


CONTIG_ERRORS = {
    "both-sizes": ["--small-contigs", "--large-contigs"],
    "no-size": [],
    "rep-dir": ["--small-contigs", "--output-representative-fasta-directory",
                "reps"],
    "rep-dir-copy": ["--small-contigs",
                     "--output-representative-fasta-directory-copy", "reps"],
    "duplicate": ["--small-contigs"],
    "references": ["--small-contigs", "--reference-genomes", "ref.fna"],
}


@pytest.mark.parametrize("case", sorted(CONTIG_ERRORS))
def test_contig_errors_match_jax_package(tmp_path, monkeypatch, capsys, case):
    """Each contig-mode refusal: the JAX CLI's exit code and message."""
    a = _write_contigs(tmp_path / "a.fna", ["x1", "x2\tcomment"])
    b = _write_contigs(tmp_path / "b.fna",
                       ["x2", "x3"] if case == "duplicate" else ["x3"])
    monkeypatch.chdir(tmp_path)
    argv = ["cluster", "-f", a, b, "--cluster-contigs", *CONTIG_ERRORS[case],
            "--output-cluster-definition", str(tmp_path / "x.tsv")]
    got = []
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        monkeypatch.setenv("GALAH_TPU_PLATFORM", "cpu")
        with pytest.raises(SystemExit) as e:
            main(argv)
        got.append((e.value.code, capsys.readouterr().err))
    assert got[0] == got[1]
    assert got[1][0] not in (0, None)
    assert not (tmp_path / "x.tsv").exists()


# The modes the port runs, as (extra flags or None for reference mode,
# GALAH_TPU_SCREEN, GALAH_TPU_DEVICE_SKETCH, contig mode).
PORT_MODES = {
    "genome": ([], "packed", "0", False),
    "low-memory": (["--low-memory"], "packed", "0", False),
    "popcount": ([], "popcount", "0", False),
    "reference": (None, "packed", "0", False),
    "device-sketch": ([], "packed", "1", False),
    "device-sketch-low-memory": (["--low-memory"], "packed", "1", False),
    "contig": (["--cluster-contigs", "--small-contigs"], "packed", "0", True),
    "contig-device-sketch": (["--cluster-contigs", "--small-contigs"],
                             "packed", "1", True),
}


@pytest.mark.parametrize("mode", sorted(PORT_MODES))
def test_module_entry_point_never_imports_jax(corpus, contig_corpus, tmp_path,
                                              mode):
    """`python -m galah_tpu_torch cluster` in each mode the port runs,
    in a fresh interpreter that first imports every module of the port:
    neither JAX nor anything of the JAX package gets imported."""
    d, paths, fams = corpus
    flags, screen, device_sketch, contigs = PORT_MODES[mode]
    out = tmp_path / "sub.tsv"
    want_lines = 16
    if flags is None:  # reference mode: one reference per family
        refs = [paths[fams.index(f)] for f in sorted(set(fams))]
        (tmp_path / "genomes.txt").write_text(
            "".join(p + "\n" for p in paths if p not in refs))
        argv = ["galah_tpu_torch", "cluster", "--genome-fasta-list",
                str(tmp_path / "genomes.txt"), "--reference-genomes", *refs,
                "--ani", "95", "--output-cluster-definition", str(out), "-q"]
    elif contigs:
        path, names, _ = contig_corpus
        want_lines = len(names)
        argv = ["galah_tpu_torch", "cluster", "-f", path, "--ani", "95",
                "--output-cluster-definition", str(out), "-q", *flags]
    else:
        argv = ["galah_tpu_torch"] + _cluster_argv(d, out) + flags
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "import galah_tpu_torch\n"
        "for m in pkgutil.walk_packages(galah_tpu_torch.__path__, "
        "'galah_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"sys.argv = {argv!r}\n"
        "try:\n"
        "    runpy.run_module('galah_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'galah_tpu'))\n"
        "print('FOREIGN_MODULES', bad)\n"
        "from galah_tpu_torch.utils import metrics\n"
        "print('DEVICE_BATCHES', "
        "int(metrics.current().counters.get('sketch_device_batches', 0)))\n"
        "sys.exit(rc)\n"
    )
    env = dict(os.environ, GALAH_TPU_PLATFORM="cpu", GALAH_TPU_SCREEN=screen,
               GALAH_TPU_DEVICE_SKETCH=device_sketch,
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "FOREIGN_MODULES []" in proc.stdout
    batches = int(proc.stdout.split("DEVICE_BATCHES")[1].split()[0])
    assert (batches > 0) == (device_sketch == "1")
    assert len(out.read_text().splitlines()) == want_lines


def test_no_cuda_device_is_an_error(corpus, tmp_path, monkeypatch, capsys):
    d, _, _ = corpus
    monkeypatch.delenv("GALAH_TPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert torch_main(_cluster_argv(d, tmp_path / "x.tsv")) == 1
    err = capsys.readouterr().err
    assert f"Error: {NO_CUDA_MESSAGE}" in err
    assert not (tmp_path / "x.tsv").exists()


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("", "gpu", None):
        monkeypatch.setenv("GALAH_TPU_PLATFORM", name or "")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device("gpu") == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="not supported"):
        resolve_device("tpu")


@pytest.mark.parametrize("flags", [
    ["--output-distance-cache", "d.npz"],
    ["--sketch-directory", "sketches"],
    ["--precluster-method", "finch"],
    ["--cluster-method", "fastani"],
    ["--sweep-checkpoint", "ckpt"],
    ["--input-distance-cache", "d.npz"],
])
def test_unported_modes_are_refused(corpus, tmp_path, monkeypatch, flags):
    """The modes that earlier slices of the port refused now run, and
    give the JAX CLI's clusters.tsv. Each package runs in a directory of
    its own (the flags' paths are relative), with the fastANI shim of
    tests/test_subprocess_backends.py on PATH; the input distance cache
    is written by a JAX run, and an output cache reads back equal."""
    from test_subprocess_backends import FASTANI_SHIM

    from galah_tpu_torch.sketch.store import load_distance_cache

    d, _, _ = corpus
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "fastANI").write_text(FASTANI_SHIM)
    (bindir / "fastANI").chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("GALAH_TPU_SCREEN", "packed")
    monkeypatch.setenv("GALAH_TPU_VERIFY_DEVICES", "1")
    out = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        wd = tmp_path / name
        wd.mkdir()
        monkeypatch.chdir(wd)
        monkeypatch.delenv("GALAH_TPU_PLATFORM", raising=False)
        if flags[0] == "--input-distance-cache":
            assert jax_main(_cluster_argv(d, wd / "pre.tsv")
                            + ["--output-distance-cache", "d.npz"]) == 0
        if name == "torch":
            monkeypatch.setenv("GALAH_TPU_PLATFORM", "cpu")
        assert main(_cluster_argv(d, wd / "x.tsv") + flags) == 0
        out[name] = (wd / "x.tsv").read_bytes()
    assert out["torch"] == out["jax"]
    assert len(out["torch"].splitlines()) == 16
    if flags[0] == "--output-distance-cache":
        got = [load_distance_cache(str(tmp_path / n / "d.npz"))
               for n in ("jax", "torch")]
        assert dict(got[0][0].items()) == dict(got[1][0].items())
        assert got[0][1:] == got[1][1:]
