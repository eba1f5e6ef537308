"""The port's non-native methods against the JAX package's, on the CPU:
the finch (Mash MinHash) preclusterer, with its murmur3 and minhash
copies, and skani/fastANI through the bash shims of
tests/test_subprocess_backends.py. Every distance cache and ANI must
equal the JAX package's, and the CLI's clusters.tsv too."""

import numpy as np
import pytest
from test_subprocess_backends import shim_env  # noqa: F401 (fixture)

from galah_tpu.cli.main import main as jax_main
from galah_tpu.engines import finch_like as jax_finch
from galah_tpu.engines import subprocess_backends as jax_sb
from galah_tpu.sketch import minhash as jax_minhash
from galah_tpu.sketch import murmur3 as jax_murmur3
from galah_tpu.utils.synth import make_families
from galah_tpu_torch import native_ext
from galah_tpu_torch.cli.main import main as torch_main
from galah_tpu_torch.engines import finch_like
from galah_tpu_torch.engines import subprocess_backends as sb
from galah_tpu_torch.sketch import minhash, murmur3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("backend_corpus")
    paths, fams = make_families(str(d), 4, 3, genome_length=40_000,
                                within_ani=0.98, seed=8)
    return paths, fams


def test_murmur3_matches_jax_package():
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 4, size=(200, 21), dtype=np.uint8)
    keys = np.frombuffer(b"ACGT", np.uint8)[keys]
    for seed in (0, 42):
        np.testing.assert_array_equal(
            murmur3.murmur3_x64_128(keys, seed=seed),
            jax_murmur3.murmur3_x64_128(keys, seed=seed))


@pytest.mark.parametrize("sketcher", ["c++", "numpy"])
def test_minhash_sketches_match_jax_package(corpus, monkeypatch, sketcher):
    from galah_tpu import native_ext as jax_native_ext

    paths, _ = corpus
    if sketcher == "numpy":
        monkeypatch.setattr(native_ext, "available", lambda: False)
        monkeypatch.setattr(jax_native_ext, "available", lambda: False)
    a = [minhash.sketch_file(p) for p in paths[:4]]
    b = [jax_minhash.sketch_file(p) for p in paths[:4]]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.hashes, y.hashes)
        assert len(x.hashes) == 1000
    for i in range(4):
        for j in range(4):
            assert minhash.mash_ani(a[i], a[j]) == jax_minhash.mash_ani(
                b[i], b[j])


def test_finch_preclusterer_matches_jax_package(corpus):
    paths, fams = corpus
    got = finch_like.FinchPreclusterer(min_ani=0.9, threads=2)
    want = jax_finch.FinchPreclusterer(min_ani=0.9, threads=2)
    cache = dict(got.distances(paths).items())
    assert cache == dict(want.distances(paths).items())
    assert cache and all(fams[i] == fams[j] for i, j in cache)
    assert dict(got.distances_contigs(paths, ["x"]).items()) == {}
    with pytest.raises(ValueError, match="Reference genome clustering"):
        got.distances_with_references(paths, paths[:1])
    with pytest.raises(ValueError, match="Low-memory"):
        finch_like.FinchPreclusterer(0.9, low_memory=True).distances(paths)


def test_skani_and_fastani_match_jax_package(shim_env):  # noqa: F811
    genomes, _ = shim_env
    for mod in (sb, jax_sb):
        mod.check_for_binary("skani")
    pre = [m.SkaniPreclusterer(90.0, 0.15, False, 2, False)
           for m in (sb, jax_sb)]
    assert (dict(pre[0].distances(genomes).items())
            == dict(pre[1].distances(genomes).items()))
    assert (dict(pre[0].distances_with_references(genomes, genomes[:1])
                 .items())
            == dict(pre[1].distances_with_references(genomes, genomes[:1])
                    .items()))
    lowmem = [m.SkaniPreclusterer(90.0, 0.15, False, 2, True)
              for m in (sb, jax_sb)]
    assert (dict(lowmem[0].distances(genomes).items())
            == dict(lowmem[1].distances(genomes).items()))
    for cls in ("SkaniClusterer", "FastaniClusterer"):
        args = (95.0, 0.15, False) if cls == "SkaniClusterer" else (
            95.0, 0.15, 3000)
        eng = [getattr(m, cls)(*args) for m in (sb, jax_sb)]
        for e in eng:
            e.initialise()
        pairs = [(genomes[0], genomes[1]), (genomes[1], genomes[0]),
                 (genomes[2], genomes[0])]
        assert ([eng[0].calculate_ani(*p) for p in pairs]
                == [eng[1].calculate_ani(*p) for p in pairs])
        assert eng[0].method_name() == eng[1].method_name()


@pytest.mark.parametrize("methods", [("skani", "skani"), ("skani", "fastani"),
                                     ("finch", "skani")])
def test_cli_methods_match_jax_package(shim_env, tmp_path,  # noqa: F811
                                       monkeypatch, methods):
    """The shim joins a and b; neither package touches a device for
    these methods (the port runs with no CUDA device and without
    GALAH_TPU_PLATFORM=cpu)."""
    import torch

    genomes, _ = shim_env
    pre, clu = methods
    out = []
    monkeypatch.delenv("GALAH_TPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        tsv = tmp_path / f"{name}.tsv"
        assert main(["cluster", "-f", *genomes, "--precluster-method", pre,
                     "--cluster-method", clu, "--precluster-ani", "90",
                     "--output-cluster-definition", str(tsv), "-q"]) == 0
        out.append(tsv.read_bytes())
    assert out[0] == out[1]
    assert len(out[1].splitlines()) == 3
