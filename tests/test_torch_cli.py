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
from galah_tpu.utils.synth import make_families
from galah_tpu_torch.cli.main import main as torch_main
from galah_tpu_torch.utils.device import NO_CUDA_MESSAGE, resolve_device

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_corpus")
    paths, fams = make_families(str(d), 4, 4, genome_length=60_000, seed=3)
    return str(d), paths, fams


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
    (function, cache_blocks)."""
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
    d, _, _ = corpus
    monkeypatch.setenv("GALAH_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("GALAH_TPU_SCREEN", "indicator")
    assert torch_main(_cluster_argv(d, tmp_path / "x.tsv")) == 1
    assert "not yet supported by galah_tpu_torch" in capsys.readouterr().err


# The modes the port runs, as (extra flags, GALAH_TPU_SCREEN).
PORT_MODES = {
    "genome": ([], "packed"),
    "low-memory": (["--low-memory"], "packed"),
    "popcount": ([], "popcount"),
    "reference": (None, "packed"),
}


@pytest.mark.parametrize("mode", sorted(PORT_MODES))
def test_module_entry_point_never_imports_jax(corpus, tmp_path, mode):
    """`python -m galah_tpu_torch cluster` in each mode the port runs,
    in a fresh interpreter that first imports every module of the port:
    neither JAX nor anything of the JAX package gets imported."""
    d, paths, fams = corpus
    flags, screen = PORT_MODES[mode]
    out = tmp_path / "sub.tsv"
    if flags is None:  # reference mode: one reference per family
        refs = [paths[fams.index(f)] for f in sorted(set(fams))]
        (tmp_path / "genomes.txt").write_text(
            "".join(p + "\n" for p in paths if p not in refs))
        argv = ["galah_tpu_torch", "cluster", "--genome-fasta-list",
                str(tmp_path / "genomes.txt"), "--reference-genomes", *refs,
                "--ani", "95", "--output-cluster-definition", str(out), "-q"]
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
        "sys.exit(rc)\n"
    )
    env = dict(os.environ, GALAH_TPU_PLATFORM="cpu", GALAH_TPU_SCREEN=screen,
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "FOREIGN_MODULES []" in proc.stdout
    assert len(out.read_text().splitlines()) == 16


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
    ["--cluster-contigs", "--small-contigs"],
    ["--precluster-method", "finch"],
    ["--cluster-method", "fastani"],
    ["--sweep-checkpoint", "ckpt"],
])
def test_unported_modes_are_refused(corpus, tmp_path, monkeypatch, capsys, flags):
    d, _, _ = corpus
    monkeypatch.setenv("GALAH_TPU_PLATFORM", "cpu")
    assert torch_main(_cluster_argv(d, tmp_path / "x.tsv") + flags) == 1
    assert "not yet supported by galah_tpu_torch" in capsys.readouterr().err
