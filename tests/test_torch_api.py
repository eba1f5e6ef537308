"""The port's library API (galah_tpu_torch.api) against the JAX package's
(galah_tpu.api), on the CPU: equal clusters from cluster_genomes (also
in reference mode and with the finch preclusterer) and cluster_contigs,
pairwise ANI within 1e-3 percentage points, and no silent fallback: with
no device given and no CUDA device the API stops unless the CPU was
asked for."""

import pytest
import torch

from galah_tpu import api as jax_api
from galah_tpu.utils.synth import make_contig_corpus, make_families
from galah_tpu_torch import api
from galah_tpu_torch.utils.device import NO_CUDA_MESSAGE

CPU = torch.device("cpu")
ANI_TOL = 1e-3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("api_corpus")
    paths, fams = make_families(str(d), 4, 3, genome_length=24_000,
                                within_ani=0.97, seed=3)
    return paths, fams


@pytest.fixture(scope="module")
def contigs(tmp_path_factory):
    path = tmp_path_factory.mktemp("api_contigs") / "contigs.fna"
    names, fams = make_contig_corpus(str(path), 20, 5, contig_length=5_000,
                                     seed=21)
    return str(path), names, fams


@pytest.fixture(autouse=True)
def single_device(monkeypatch):
    monkeypatch.setenv("GALAH_TPU_SCREEN", "packed")
    monkeypatch.setenv("GALAH_TPU_VERIFY_DEVICES", "1")
    monkeypatch.delenv("GALAH_TPU_PLATFORM", raising=False)


def _one_family_each(memberships, fam_of):
    for members in memberships:
        assert len({fam_of[m] for m in members}) == 1


@pytest.mark.parametrize("methods", [("native", "native"),
                                     ("finch", "native")])
def test_cluster_genomes_matches_jax_package(corpus, methods):
    paths, fams = corpus
    pre, clu = methods
    kw = dict(ani=95, precluster_ani=90, precluster_method=pre,
              cluster_method=clu, threads=2)
    want = jax_api.cluster_genomes(paths, jax_api.ClusterParameters(**kw))
    got = api.cluster_genomes(paths, api.ClusterParameters(**kw), device=CPU)
    assert got.clusters == want.clusters
    assert got.representatives == want.representatives
    assert len(got.clusters) == 4
    _one_family_each(got.memberships(), dict(zip(paths, fams)))


def test_reference_mode_matches_jax_package(corpus):
    paths, fams = corpus
    refs = [paths[fams.index(f)] for f in sorted(set(fams))]
    want = jax_api.cluster_genomes(paths, reference_genomes=refs)
    got = api.cluster_genomes(paths, reference_genomes=refs, device=CPU)
    assert got.clusters == want.clusters
    assert len(got.clusters) == 4
    assert sorted(got.representatives) == sorted(refs)


def test_cluster_contigs_matches_jax_package(contigs):
    path, names, fams = contigs
    params = dict(small_genomes=True, ani=95)
    want = jax_api.cluster_contigs([path], jax_api.ClusterParameters(**params))
    got = api.cluster_contigs([path], api.ClusterParameters(**params),
                              device=CPU)
    assert got.clusters == want.clusters
    assert got.contig_names == names
    assert len(got.clusters) == 20
    _one_family_each(got.memberships(), dict(zip(names, fams)))


def test_pairwise_ani_matches_jax_package(corpus):
    paths, fams = corpus
    same = [(paths[0], paths[1]), (paths[3], paths[5])]
    other = [(paths[0], paths[3])]
    for a, b in same + other:
        want = jax_api.pairwise_ani(a, b)
        got = api.pairwise_ani(a, b, device=CPU)
        if want is None:
            assert got is None
        else:
            assert got == pytest.approx(want, abs=ANI_TOL)
    assert all(api.pairwise_ani(a, b, device=CPU) > 95 for a, b in same)


def test_no_device_and_no_cuda_stops(corpus, monkeypatch):
    paths, _ = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.cluster_genomes(paths)
    with pytest.raises(RuntimeError) as e:
        api.pairwise_ani(paths[0], paths[1])
    assert str(e.value) == NO_CUDA_MESSAGE
    # The CPU when asked for, by argument or by GALAH_TPU_PLATFORM.
    monkeypatch.setenv("GALAH_TPU_PLATFORM", "cpu")
    assert len(api.cluster_genomes(paths).clusters) == 4
    # finch/native never builds a device engine for the preclusterer,
    # but the native clusterer still needs the device.
    monkeypatch.delenv("GALAH_TPU_PLATFORM")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.cluster_genomes(paths, api.ClusterParameters(
            precluster_method="finch", precluster_ani=90))
