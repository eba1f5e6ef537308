"""The port's between-phase artifacts against the JAX package's (modelled
on tests/test_sketch_directory.py): the persistent sketch directory
(--sketch-directory) and the distance caches (--output-distance-cache,
--input-distance-cache), through both CLIs on the CPU.

- a second run sketches nothing, a changed file invalidates only its
  sketch, contig mode keeps one bundle per FASTA (also through the
  overlapped phases, whose rows and verify streams then come from the
  host), widened parameters never reuse another width, and --low-memory
  spills into the directory;
- a directory written by the JAX package is reused by the port, which
  names and fills its own files as the JAX package does;
- a distance cache round trip in each of the three modes, by the port
  and from a JAX-written cache, gives the JAX CLI's clusters.tsv with
  no sketch and no screen; every mismatch is refused with the JAX
  package's message.
"""

import json
import os

import numpy as np
import pytest

from galah_tpu.cli.main import main as jax_main
from galah_tpu.utils.synth import (
    make_contig_corpus,
    make_families,
    random_genome,
    write_fasta,
)
from galah_tpu_torch.cli.main import main as torch_main
from galah_tpu_torch.ops import device_sketch as ds
from galah_tpu_torch.ops import packed_matmul as pm
from galah_tpu_torch.sketch import store



@pytest.fixture()
def corpus(tmp_path):
    d = tmp_path / "corpus"
    make_families(str(d), n_families=4, members_per_family=3,
                  genome_length=24_000, within_ani=0.97, seed=3)
    return sorted(str(p) for p in d.iterdir() if p.suffix == ".fna")


@pytest.fixture(scope="module")
def contigs(tmp_path_factory):
    path = tmp_path_factory.mktemp("cache_contigs") / "contigs.fna"
    names, fams = make_contig_corpus(str(path), 20, 5, contig_length=5_000,
                                     seed=21)
    return str(path), names, fams


@pytest.fixture(autouse=True)
def single_device(monkeypatch):
    """The JAX side on its single-device packed screen; K1 and K5's
    plain versions counted on the port's side."""
    monkeypatch.setenv("GALAH_TPU_SCREEN", "packed")
    monkeypatch.setenv("GALAH_TPU_VERIFY_DEVICES", "1")
    calls = {"K1": 0, "K5": 0}
    k1, k5 = pm.packed_intersect_counts_reference, ds.sketch_batch_reference

    def count(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(pm, "packed_intersect_counts_reference",
                        count("K1", k1))
    monkeypatch.setattr(ds, "sketch_batch_reference", count("K5", k5))
    return calls


def _cli(package, monkeypatch, inputs, out, *flags):
    """(clusters.tsv bytes, metrics counters) of one run of `package`'s
    CLI; a refusal raises SystemExit."""
    if package == "jax":
        monkeypatch.delenv("GALAH_TPU_PLATFORM", raising=False)
        main = jax_main
    else:
        monkeypatch.setenv("GALAH_TPU_PLATFORM", "cpu")
        main = torch_main
    mjson = f"{out}.json"
    rc = main(["cluster", *inputs, "--ani", "95", "-q",
               "--output-cluster-definition", str(out),
               "--metrics-json", mjson, *flags])
    assert rc == 0
    with open(out, "rb") as f, open(mjson) as g:
        return f.read(), json.load(g)["counters"]


def _files(inputs):
    return ["-f", *inputs]


# ------------------------------------------------------- sketch directory


def test_second_run_sketches_nothing(corpus, tmp_path, monkeypatch):
    sk = str(tmp_path / "sketches")
    want, _ = _cli("jax", monkeypatch, _files(corpus), tmp_path / "j.tsv")
    a, c1 = _cli("torch", monkeypatch, _files(corpus), tmp_path / "a.tsv",
                 "--sketch-directory", sk)
    assert c1["genomes_sketched"] == len(corpus)
    assert len(os.listdir(sk)) == len(corpus)
    b, c2 = _cli("torch", monkeypatch, _files(corpus), tmp_path / "b.tsv",
                 "--sketch-directory", sk)
    assert "genomes_sketched" not in c2
    assert a == b == want


def test_changed_file_invalidates_its_sketch(corpus, tmp_path, monkeypatch):
    sk = str(tmp_path / "sketches")
    _cli("torch", monkeypatch, _files(corpus), tmp_path / "a.tsv",
         "--sketch-directory", sk)
    write_fasta(corpus[0], random_genome(np.random.default_rng(9), 24_000),
                "changed")
    got, counters = _cli("torch", monkeypatch, _files(corpus),
                         tmp_path / "b.tsv", "--sketch-directory", sk)
    assert counters["genomes_sketched"] == 1
    want, _ = _cli("jax", monkeypatch, _files(corpus), tmp_path / "j.tsv")
    assert got == want


@pytest.mark.parametrize("device_sketch", ["0", "1"])
def test_contig_bundles(contigs, tmp_path, monkeypatch, single_device,
                        device_sketch):
    """One bundle per FASTA; the second run reads it and sketches no
    contig. With device sketching (K5's plain version, the phases
    overlapped) the first run's rows are device-born and the second's
    are uploaded from the host, rows and verify streams alike."""
    path, names, _ = contigs
    monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", device_sketch)
    sk = str(tmp_path / "sketches")
    inputs = ["-f", path, "--cluster-contigs", "--small-contigs"]
    want, _ = _cli("jax", monkeypatch, inputs, tmp_path / "j.tsv")
    a, c1 = _cli("torch", monkeypatch, inputs, tmp_path / "a.tsv",
                 "--sketch-directory", sk)
    assert c1["contigs_sketched"] == len(names)
    assert c1["sketch_bundle_write_s"] > 0
    assert len(os.listdir(sk)) == 1
    single_device["K5"] = 0
    b, c2 = _cli("torch", monkeypatch, inputs, tmp_path / "b.tsv",
                 "--sketch-directory", sk)
    assert "contigs_sketched" not in c2 and c2["sketch_bundle_read_s"] > 0
    assert single_device["K5"] == 0
    assert a == b == want
    if device_sketch == "1":
        assert c1["phases_overlapped"] == c2["phases_overlapped"] == 1
        assert c1["screen_rows_device_born"] == len(names)
        assert "verify_streams_uploaded" not in c1
        assert c2["screen_rows_host_uploaded"] == len(names)
        assert c2["screen_host_row_bytes"] > 0
        assert c2["verify_streams_uploaded"] > 0
        assert c2["verify_stream_upload_bytes"] > 0


def test_widened_params_never_reuse_other_width(corpus, tmp_path,
                                                monkeypatch):
    sk = str(tmp_path / "sketches")
    wide = ("--sketch-directory", sk, "--min-aligned-fraction", "0.05")
    a, c1 = _cli("torch", monkeypatch, _files(corpus), tmp_path / "a.tsv",
                 *wide)
    assert c1["genomes_sketched"] == len(corpus)
    _, c2 = _cli("torch", monkeypatch, _files(corpus), tmp_path / "b.tsv",
                 "--sketch-directory", sk)
    assert c2["genomes_sketched"] == len(corpus)
    c, c3 = _cli("torch", monkeypatch, _files(corpus), tmp_path / "c.tsv",
                 *wide)
    assert "genomes_sketched" not in c3
    assert c == a


def test_low_memory_spills_into_the_directory(corpus, tmp_path, monkeypatch):
    sk = str(tmp_path / "sketches")
    flags = ("--sketch-directory", sk, "--low-memory")
    a, c1 = _cli("torch", monkeypatch, _files(corpus), tmp_path / "a.tsv",
                 *flags)
    assert c1["genomes_sketched"] == len(corpus)
    assert len(os.listdir(sk)) == len(corpus)
    b, c2 = _cli("torch", monkeypatch, _files(corpus), tmp_path / "b.tsv",
                 *flags)
    assert "genomes_sketched" not in c2
    want, _ = _cli("jax", monkeypatch, _files(corpus), tmp_path / "j.tsv",
                   "--low-memory")
    assert a == b == want


def _sketch_files(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        p = os.path.join(directory, name)
        with np.load(p) as z:
            out[name] = {k: z[k] for k in z.files}
    return out


def test_jax_written_directory_is_reused(corpus, contigs, tmp_path,
                                         monkeypatch, single_device):
    """The JAX package fills a directory (genome sketches and a contig
    bundle); the port sketches nothing from it and gives the same
    clusters.tsv. A directory the port fills holds the same file names
    and the same arrays."""
    path, _, _ = contigs
    runs = (("genomes", _files(corpus)),
            ("contigs", ["-f", path, "--cluster-contigs", "--small-contigs"]))
    for tag, inputs in runs:
        jdir = str(tmp_path / f"jax_{tag}")
        pdir = str(tmp_path / f"torch_{tag}")
        want, _ = _cli("jax", monkeypatch, inputs, tmp_path / f"j{tag}.tsv",
                       "--sketch-directory", jdir)
        single_device["K5"] = 0
        got, counters = _cli("torch", monkeypatch, inputs,
                             tmp_path / f"t{tag}.tsv",
                             "--sketch-directory", jdir)
        assert got == want
        assert not {"genomes_sketched", "contigs_sketched"} & set(counters)
        own, _ = _cli("torch", monkeypatch, inputs, tmp_path / f"o{tag}.tsv",
                      "--sketch-directory", pdir)
        assert own == want
        jf, pf = _sketch_files(jdir), _sketch_files(pdir)
        assert list(jf) == list(pf)
        for name in jf:
            assert jf[name].keys() == pf[name].keys()
            for k in jf[name]:
                np.testing.assert_array_equal(jf[name][k], pf[name][k])


# --------------------------------------------------------- distance caches


def _modes(corpus, contigs, tmp_path):
    """{mode: CLI inputs} of the three modes a cache records."""
    path, _, _ = contigs
    refs = corpus[::3]
    (tmp_path / "refs.txt").write_text("".join(p + "\n" for p in refs))
    (tmp_path / "genomes.txt").write_text(
        "".join(p + "\n" for p in corpus if p not in refs))
    return {
        "triangle": _files(corpus),
        "contigs": ["-f", path, "--cluster-contigs", "--small-contigs"],
        "references": ["--genome-fasta-list", str(tmp_path / "genomes.txt"),
                       "--reference-genomes-list", str(tmp_path / "refs.txt")],
    }


@pytest.mark.parametrize("mode", ["triangle", "contigs", "references"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_distance_cache_round_trip(corpus, contigs, tmp_path, monkeypatch,
                                   single_device, mode, writer):
    inputs = _modes(corpus, contigs, tmp_path)[mode]
    cache = str(tmp_path / "d.npz")
    want, _ = _cli(writer, monkeypatch, inputs, tmp_path / "w.tsv",
                   "--output-distance-cache", cache)
    _, names, meta = store.load_distance_cache(cache)
    assert meta == {"threshold": 95.0, "min_af": 0.15, "method": "native",
                    "mode": mode}
    assert len(names) == (100 if mode == "contigs" else len(corpus))
    single_device.update(K1=0, K5=0)
    got, counters = _cli("torch", monkeypatch, inputs, tmp_path / "r.tsv",
                         "--input-distance-cache", cache)
    assert got == want
    assert single_device["K1"] == 0
    assert "screen_tiles" not in counters
    if writer == "torch":
        jax_again, _ = _cli("jax", monkeypatch, inputs, tmp_path / "j.tsv")
        assert got == jax_again


MISMATCHES = {
    "threshold": (("--ani", "97"), ("--ani", "95"), "recorded at ANI 97"),
    "min-af": ((), ("--min-aligned-fraction", "0.3"),
               "--min-aligned-fraction 0.15"),
    "method": ((), ("--precluster-method", "finch", "--precluster-ani",
                    "95"), "precluster method 'native'"),
    "mode": ((), "references", "recorded in triangle mode"),
}


@pytest.mark.parametrize("case", sorted(MISMATCHES))
def test_cache_mismatch_refused_as_in_jax_package(
    corpus, contigs, tmp_path, monkeypatch, case
):
    record, run, words = MISMATCHES[case]
    modes = _modes(corpus, contigs, tmp_path)
    cache = str(tmp_path / "d.npz")
    _cli("torch", monkeypatch, modes["triangle"], tmp_path / "w.tsv",
         "--output-distance-cache", cache, *record)
    if run == "references":
        inputs, run = modes["references"], ()
    else:
        inputs = modes["triangle"]
    msgs = []
    for package in ("jax", "torch"):
        with pytest.raises(SystemExit) as e:
            _cli(package, monkeypatch, inputs, tmp_path / f"{package}.tsv",
                 "--input-distance-cache", cache, *run)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert words in msgs[1]
