"""The port's host layer: it imports nothing of the JAX package, and its
copies of the JAX package's host modules behave as the originals do.

- every program file of the port, and chip_smoke.py, is scanned for
  imports of `galah_tpu` (a fresh interpreter running the port's CLI
  in each mode is checked in tests/test_torch_cli.py);
- on a `make_families` corpus both packages' `sketch_file_native` give
  identical sketches, with the C++ sketcher and with the numpy one;
- both `greedy.cluster`s give the same clusters from the same engines;
- a `.npz` sketch or distance cache written by either package reads in
  the other, with the same keys and compression;
- both `add_cluster_arguments` parse the cluster flags to the same
  namespace.
"""

import argparse
import ast
import io
import zipfile
from pathlib import Path

import numpy as np
import pytest

from galah_tpu import native_ext as jax_native_ext
from galah_tpu.cli.cluster_cmd import add_cluster_arguments as jax_add_args
from galah_tpu.cluster import greedy as jax_greedy
from galah_tpu.cluster.cache import SortedPairDistanceCache as JaxCache
from galah_tpu.engines import base as jax_base
from galah_tpu.sketch import fracminhash as jax_fmh
from galah_tpu.sketch import store as jax_store
from galah_tpu.utils.synth import make_families
from galah_tpu_torch import native_ext
from galah_tpu_torch.cli.cluster_cmd import add_cluster_arguments
from galah_tpu_torch.cluster import greedy
from galah_tpu_torch.cluster.cache import SortedPairDistanceCache
from galah_tpu_torch.engines import base
from galah_tpu_torch.engines.native import _shrink_bits
from galah_tpu_torch.sketch import fracminhash as fmh
from galah_tpu_torch.sketch import store
from galah_tpu_torch.utils.convert import native_sketch_from_fields

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "galah_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]
SKETCH_FIELDS = ("prefilter_buckets", "frag_buckets", "frag_offsets",
                 "member_buckets")


def galah_tpu_imports(source: str):
    """(line, module) of every import of galah_tpu or galah_tpu.* in
    `source`, at any depth (lazy imports inside functions included)."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n == "galah_tpu" or n.startswith("galah_tpu.")]
    return found


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_nothing_of_galah_tpu(rel):
    assert galah_tpu_imports((REPO / rel).read_text()) == []


@pytest.mark.parametrize("source,found", [
    ("import galah_tpu\n", [(1, "galah_tpu")]),
    ("import os, galah_tpu.utils.metrics as m\n",
     [(1, "galah_tpu.utils.metrics")]),
    ("from galah_tpu import defaults\n", [(1, "galah_tpu")]),
    ("def f():\n    from galah_tpu.io.fasta import read_fasta\n",
     [(2, "galah_tpu.io.fasta")]),
    ("import galah_tpu_torch\nfrom galah_tpu_torch import defaults\n"
     "from . import galah_tpu\n", []),
])
def test_import_scan_finds_galah_tpu(source, found):
    assert galah_tpu_imports(source) == found


def test_port_loads_the_committed_cpp_sketcher():
    assert native_ext._find_library() == str(REPO / "native" / "libfastaio.so")
    assert native_ext.available()


# ---------------------------------------------------------------- sketches


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("host_corpus")
    paths, fams = make_families(str(d), 2, 3, genome_length=30_000, seed=7)
    return paths, fams


PARAMS = {
    "shrunk": lambda mod: _shrink_bits(mod.NativeSketchParams(), 30_000),
    "small-genomes": lambda mod: mod.small_genome_params(),
}


def _same_params(a, b):
    assert a.__dict__ == b.__dict__


@pytest.mark.parametrize("sketcher", ["c++", "numpy"])
@pytest.mark.parametrize("params", sorted(PARAMS))
def test_sketches_match_jax_package(corpus, monkeypatch, sketcher, params):
    paths, _ = corpus
    if sketcher == "numpy":
        monkeypatch.setattr(native_ext, "available", lambda: False)
        monkeypatch.setattr(jax_native_ext, "available", lambda: False)
    jp = PARAMS[params](jax_fmh)
    pp = PARAMS[params](fmh)
    _same_params(jp, pp)
    for path in paths[:4]:
        want = jax_fmh.sketch_file_native(path, jp)
        got = fmh.sketch_file_native(path, pp)
        assert isinstance(got, fmh.NativeSketch)
        assert (got.name, got.total_len) == (want.name, want.total_len)
        for f in SKETCH_FIELDS:
            g, w = getattr(got, f), getattr(want, f)
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        assert len(got.frag_offsets) > 2
        np.testing.assert_array_equal(got.member_bitmap_words(),
                                      want.member_bitmap_words())
        conv = native_sketch_from_fields(want)
        assert isinstance(conv, fmh.NativeSketch)
        assert isinstance(conv.params, fmh.NativeSketchParams)
        _same_params(conv.params, pp)
        for f in SKETCH_FIELDS:
            np.testing.assert_array_equal(getattr(conv, f), getattr(got, f))


# ------------------------------------------------------------- clustering


def _engines(base_mod, ani, precluster_cut, same_method):
    """A preclusterer that passes every pair at or above `precluster_cut`
    and a clusterer that reads the same matrix, built on `base_mod`'s
    abstract classes."""
    n = ani.shape[0]

    class Pre(base_mod.PreclusterDistanceFinder):
        def _cache(self, cache, pairs):
            for i, j in pairs:
                if ani[i, j] >= precluster_cut:
                    cache.insert((i, j), float(ani[i, j]))
            return cache

        def distances(self, paths):
            return self._cache(self.cache_type(),
                               [(i, j) for i in range(n)
                                for j in range(i + 1, n)])

        def distances_contigs(self, paths, names):
            raise NotImplementedError

        def distances_with_references(self, paths, refs):
            ref = {paths.index(r) for r in refs}
            return self._cache(self.cache_type(),
                               [(i, j) for i in range(n) for j in ref
                                if i not in ref])

        def method_name(self):
            return "fake"

    class Clu(base_mod.ClusterDistanceFinder):
        def method_name(self):
            return "fake" if same_method else "fake-exact"

        def get_ani_threshold(self):
            return 95.0

        def calculate_ani(self, a, b):
            v = float(ani[int(a[1:]), int(b[1:])])
            return v if v >= 90.0 else None

    return Pre(), Clu()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["reuse-ani", "cluster-pass", "references"])
def test_greedy_cluster_matches_jax_package(seed, mode):
    rng = np.random.default_rng(seed)
    n = 60
    # Genomes in a few groups near 96-99% ANI, others near 80-93%.
    group = rng.integers(0, 8, size=n)
    ani = rng.uniform(80.0, 93.0, size=(n, n))
    same = group[:, None] == group[None, :]
    ani[same] = rng.uniform(94.0, 99.5, size=int(same.sum()))
    ani = np.triu(ani, 1)
    ani = ani + ani.T
    names = [f"g{i}" for i in range(n)]
    refs = names[::7] if mode == "references" else None
    out = []
    for base_mod, greedy_mod, cache_type in (
        (jax_base, jax_greedy, JaxCache),
        (base, greedy, SortedPairDistanceCache),
    ):
        pre, clu = _engines(base_mod, ani, 90.0, mode == "reuse-ani")
        pre.cache_type = cache_type
        out.append(greedy_mod.cluster(names, pre, clu,
                                      reference_genomes=refs))
    assert out[0] == out[1]
    assert sorted(i for c in out[1] for i in c) == list(range(n))
    assert 8 <= len(out[1]) < n


# ------------------------------------------------------------------ store


def _npz_layout(raw: bytes):
    """{member name: zip compression type} of an .npz file's bytes."""
    with zipfile.ZipFile(io.BytesIO(raw)) as z:
        return {i.filename: i.compress_type for i in z.infolist()}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sketch_npz_reads_in_the_other_package(corpus, tmp_path, writer):
    paths, _ = corpus
    jp = _shrink_bits(jax_fmh.NativeSketchParams(), 30_000)
    want = jax_fmh.sketch_file_native(paths[0], jp)
    sketches = {"jax": want, "torch": native_sketch_from_fields(want)}
    mods = {"jax": jax_store, "torch": store}
    files = {}
    for name, mod in mods.items():
        files[name] = tmp_path / f"{name}.npz"
        mod.save_sketch(sketches[name], str(files[name]))
    layouts = {k: _npz_layout(f.read_bytes()) for k, f in files.items()}
    assert layouts["jax"] == layouts["torch"]
    assert set(layouts["jax"].values()) == {zipfile.ZIP_DEFLATED}
    reader = mods["torch" if writer == "jax" else "jax"]
    got = reader.load_sketch(str(files[writer]))
    assert (got.name, got.total_len) == (want.name, want.total_len)
    _same_params(got.params, want.params)
    for f in SKETCH_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    # The disk store of the reading package serves the same sketch.
    ds = reader.DiskSketchStore(str(tmp_path / "store"), got.params,
                                max_resident=1)
    ds.put("a", got)
    ds.put("b", got)  # evicts "a": the next get reads it from disk
    again = ds.get("a")
    for f in SKETCH_FIELDS:
        np.testing.assert_array_equal(getattr(again, f), getattr(want, f))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_distance_cache_npz_reads_in_the_other_package(tmp_path, writer):
    mods = {"jax": (jax_store, JaxCache),
            "torch": (store, SortedPairDistanceCache)}
    wmod, wcache = mods[writer]
    rmod, rcache = mods["torch" if writer == "jax" else "jax"]
    cache = wcache()
    for (i, j), v in {(0, 3): 97.5, (2, 1): None, (4, 5): 99.25}.items():
        cache.insert((i, j), v)
    path = str(tmp_path / "d.npz")
    wmod.save_distance_cache(cache, path, names=["a", "b", "c", "d", "e", "f"],
                             threshold=95.0, min_af=0.15, method="native",
                             mode="triangle")
    got, names, meta = rmod.load_distance_cache(path)
    assert isinstance(got, rcache)
    assert dict(got.items()) == dict(cache.items())
    assert names == ["a", "b", "c", "d", "e", "f"]
    assert meta == {"threshold": 95.0, "min_af": 0.15, "method": "native",
                    "mode": "triangle"}


# -------------------------------------------------------------- arguments


@pytest.mark.parametrize("argv", [
    [],
    ["-d", "genomes", "-x", "fa", "--ani", "97", "-t", "8", "--low-memory"],
    ["-f", "a.fna", "b.fna", "--reference-genomes-list", "refs.txt",
     "--min-aligned-fraction", "0.2", "--ani-semantics", "skani-calibrated"],
    ["--genome-fasta-list", "g.txt", "--checkm2-quality-report", "q.tsv",
     "--min-completeness", "60", "--max-contamination", "5",
     "--quality-formula", "dRep", "--output-cluster-definition", "c.tsv",
     "--output-representative-list", "r.txt", "--metrics-json", "m.json"],
    ["-f", "a.fna", "--small-genomes", "--fragment-length", "1000",
     "--precluster-ani", "92", "--reference-genomes", "r1.fna", "r2.fna",
     "-q"],
])
def test_cluster_flags_parse_as_in_jax_package(argv):
    parsed = []
    for add in (jax_add_args, add_cluster_arguments):
        parser = argparse.ArgumentParser()
        add(parser)
        parsed.append(vars(parser.parse_args(argv)))
    assert parsed[0] == parsed[1]


# ------------------------------------------------------------ copies


# Modules the port holds as copies of the JAX package's, unchanged but
# for the package name in their imports and a note in their docstring.
VERBATIM_COPIES = [
    "annotate/analyse.py", "annotate/barrnap.py", "annotate/trnascan.py",
    "cli/analyse_cmd.py", "engines/finch_like.py",
    "engines/subprocess_backends.py", "ops/sweep_checkpoint.py",
    "sketch/minhash.py", "sketch/murmur3.py",
]


def _code_without_docstring(source: str) -> str:
    tree = ast.parse(source)
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(
            getattr(body[0], "value", None), ast.Constant):
        tree.body = body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", VERBATIM_COPIES)
def test_copied_module_is_the_jax_packages(rel):
    import re

    jax_src = (REPO / "galah_tpu" / rel).read_text()
    port_src = (REPO / "galah_tpu_torch" / rel).read_text()
    renamed = re.sub(r"\bgalah_tpu\b", "galah_tpu_torch", jax_src)
    assert _code_without_docstring(port_src) == _code_without_docstring(
        renamed)
    assert f"galah_tpu/{rel}" in ast.get_docstring(ast.parse(port_src))
