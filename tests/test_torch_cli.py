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


def test_module_entry_point_never_imports_jax(corpus, tmp_path):
    d, _, _ = corpus
    out = tmp_path / "sub.tsv"
    argv = ["galah_tpu_torch"] + _cluster_argv(d, out)
    code = (
        "import runpy, sys\n"
        f"sys.argv = {argv!r}\n"
        "try:\n"
        "    runpy.run_module('galah_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "print('JAX_LOADED', 'jax' in sys.modules)\n"
        "sys.exit(rc)\n"
    )
    env = dict(os.environ, GALAH_TPU_PLATFORM="cpu",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_LOADED False" in proc.stdout
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
    ["--low-memory"],
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
