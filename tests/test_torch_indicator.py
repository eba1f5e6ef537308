"""galah_tpu_torch's u8 indicator screens and GALAH_TPU_SCREEN_DTYPE
against the JAX package's, on the CPU.

The same numpy-seeded uint8 indicator rows go through both packages'
screen_triangle and screen_rectangle under each product dtype (int8,
bf16, f32), with cached and streamed blocks, over one tile and three:
the candidate pairs must be identical and the screen ANI bit for bit
(both round containment to bfloat16 and take v ** (1/k) * 100 in numpy
float32). Each corpus plants a family of near-duplicates whose tiles
overflow the hit cap or the hit-row limit, with a cutoff inside the
family's containment range, so the bfloat16 rule decides some pairs.
The packed screen is held to K1's plain version under each dtype, the
indicator screens to the JAX package's under GALAH_TPU_SCREEN_BLOCK
(which neither package's indicator screens read), and the cluster CLI
under GALAH_TPU_SCREEN=indicator to the JAX CLI."""

import numpy as np
import pytest
import torch

from galah_tpu.cli.main import main as jax_main
from galah_tpu.ops import prefilter as jax_pf
from galah_tpu.utils.synth import make_families
from galah_tpu_torch.cli.main import main as torch_main
from galah_tpu_torch.ops import prefilter as pf
from test_torch_prefilter import _assert_same, _packed_rows, near_duplicates

CPU = torch.device("cpu")
BLOCK = 256
CUTOFF = 0.7  # inside the planted family's containment, ~0.5-0.95
DTYPES = ["int8", "bf16", "f32"]


def _corpus(n, n_near, seed):
    ind = near_duplicates(np.random.default_rng(seed), n, n_near)
    return ind, ind.sum(axis=1)


# (rows, family rows): one 256-row tile whose 200 family rows overflow
# the hit-row limit; or two row blocks, three tiles, whose first
# diagonal tile and off-diagonal tile overflow it.
TILINGS = {"one_tile": (256, 200), "three_tiles": (400, 300)}


@pytest.mark.parametrize("tiles", sorted(TILINGS))
@pytest.mark.parametrize("cache_blocks", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_screen_triangle_matches_jax(dtype, cache_blocks, tiles,
                                     monkeypatch):
    monkeypatch.setenv("GALAH_TPU_SCREEN_DTYPE", dtype)
    ind, sizes = _corpus(*TILINGS[tiles], seed=len(dtype))
    rows = list(ind)
    want = jax_pf.screen_triangle(rows, sizes, 15, CUTOFF, block=BLOCK,
                                  cache_blocks=cache_blocks)
    got = pf.screen_triangle(rows, sizes, 15, CUTOFF, CPU, block=BLOCK,
                             cache_blocks=cache_blocks)
    pairs = _assert_same(got, want)
    assert (pairs[:, 0] < pairs[:, 1]).all()
    fam = TILINGS[tiles][1]
    in_family = int(np.sum(pairs[:, 1] < fam))
    assert 0 < in_family < fam * (fam - 1) // 2  # the cutoff splits it
    # Tile (0, 0)'s hits span more rows than the row limit: decided on
    # its bfloat16 containment.
    first = pairs[pairs[:, 1] < BLOCK]
    assert len(np.unique(first[:, 0])) > pf._row_sel(BLOCK)


@pytest.mark.parametrize("tiles", ["one_tile", "three_tiles"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_screen_rectangle_matches_jax(dtype, tiles, monkeypatch):
    """Queries against 150 references drawn from the planted family:
    one tile (200 query rows) or three (600 query rows, three blocks);
    the family's query rows overflow the hit-row limit."""
    monkeypatch.setenv("GALAH_TPU_SCREEN_DTYPE", dtype)
    nq = 200 if tiles == "one_tile" else 600
    ind, sizes = _corpus(600, 330, seed=7)
    q, r = slice(0, nq), slice(180, 330)
    want = jax_pf.screen_rectangle(list(ind[q]), sizes[q], list(ind[r]),
                                   sizes[r], 15, CUTOFF, block=BLOCK)
    got = pf.screen_rectangle(list(ind[q]), sizes[q], list(ind[r]),
                              sizes[r], 15, CUTOFF, CPU, block=BLOCK)
    pairs = _assert_same(got, want)
    assert len(np.unique(pairs[:, 0])) > pf._row_sel(BLOCK)


@pytest.mark.parametrize("dtype", DTYPES + ["int8x"])
def test_screen_matmul_counts_are_exact(dtype):
    """_screen_matmul's float32 counts equal integer counts in every
    dtype, counts above 2^8 and 2^16 included (bfloat16 holds integers
    only to 256)."""
    rng = np.random.default_rng(3)
    x = (rng.random((37, 1 << 18)) < 0.4).astype(np.uint8)
    x[0] = 1  # a full row: counts up to 2^18
    want = x.astype(np.int64) @ x[:11].astype(np.int64).T
    got = pf._indicator_counts(dtype)(torch.from_numpy(x),
                                      torch.from_numpy(x[:11]))
    assert got.dtype == torch.float32
    assert want.max() > 1 << 16
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


@pytest.mark.parametrize("m,want", [(5, 24), (16, 24), (17, 24), (24, 24),
                                    (672, 672), (673, 680), (1024, 1024)])
def test_int_mm_rows_and_padding(m, want):
    """The row counts the int8 product pads to on a card: more than 16
    and a multiple of 8 (the contig edge tile's 672 needs none)."""
    assert pf._int_mm_rows(m) == want
    x = torch.ones((m, 4), dtype=torch.int8)
    padded = pf._pad_rows(x, want)
    assert padded.shape == (want, 4)
    assert torch.equal(padded[:m], x) and not padded[m:].any()


@pytest.mark.parametrize("route", ["int8x", "bf16", "f32"])
def test_packed_screen_ignores_dtype(route, monkeypatch):
    """GALAH_TPU_SCREEN_DTYPE names the indicator product's dtype only:
    the packed screen still counts with K1 (its plain version here),
    with the same pairs and ANI bit for bit."""
    from galah_tpu_torch.ops import packed_matmul

    ind, sizes = _corpus(400, 300, seed=11)
    packed = _packed_rows(ind)
    want = pf.screen_triangle_packed(packed, sizes, 15, CUTOFF, 4096,
                                     device=CPU, block=BLOCK)
    monkeypatch.setenv("GALAH_TPU_SCREEN_DTYPE", route)
    calls = []
    real = packed_matmul.packed_intersect_counts_reference
    monkeypatch.setattr(packed_matmul, "packed_intersect_counts_reference",
                        lambda *a: calls.append(1) or real(*a))
    got = pf.screen_triangle_packed(packed, sizes, 15, CUTOFF, 4096,
                                    device=CPU, block=BLOCK)
    _assert_same(got, want)
    assert len(calls) == 3  # one a tile of the two row blocks' triangle


@pytest.mark.parametrize("shape", ["triangle", "rectangle"])
def test_indicator_screens_ignore_screen_block(shape, monkeypatch):
    """GALAH_TPU_SCREEN_BLOCK does not reach the indicator screens, as
    in the JAX package: given no edge, both sweep at DEFAULT_BLOCK and
    give the JAX package's pairs and ANI under the same variable, over
    a planted family that overflows the hit-row limit."""
    edges = []
    real = pf._TileQueue.__init__

    def spy(self, bits, min_containment, block, *a, **k):
        edges.append(block)
        real(self, bits, min_containment, block, *a, **k)

    monkeypatch.setattr(pf._TileQueue, "__init__", spy)
    monkeypatch.setenv("GALAH_TPU_SCREEN_BLOCK", "128")
    ind, sizes = _corpus(400, 300, seed=13)
    if shape == "triangle":
        want = jax_pf.screen_triangle(list(ind), sizes, 15, CUTOFF)
        got = pf.screen_triangle(list(ind), sizes, 15, CUTOFF, CPU)
    else:
        q, r = slice(0, 400), slice(150, 300)
        want = jax_pf.screen_rectangle(list(ind[q]), sizes[q], list(ind[r]),
                                       sizes[r], 15, CUTOFF)
        got = pf.screen_rectangle(list(ind[q]), sizes[q], list(ind[r]),
                                  sizes[r], 15, CUTOFF, CPU)
    pairs = _assert_same(got, want)
    assert edges == [pf.DEFAULT_BLOCK]
    assert len(np.unique(pairs[:, 0])) > pf._row_sel(pf.DEFAULT_BLOCK)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("indicator_corpus")
    paths, fams = make_families(str(d), 4, 4, genome_length=60_000, seed=3)
    return str(d), paths, fams


@pytest.mark.parametrize("mode,dtype", [
    ("genome", "int8"), ("genome", "bf16"), ("low-memory", "f32"),
    ("reference", "f32"),
])
def test_cluster_cli_matches_jax(corpus, tmp_path, monkeypatch, mode, dtype):
    """`cluster` under GALAH_TPU_SCREEN=indicator (genome mode,
    --low-memory, reference mode) gives the JAX CLI's clusters.tsv, with
    the port's indicator screen called (cache_blocks False under
    --low-memory) and one cluster per family."""
    from galah_tpu_torch.engines import native

    d, paths, fams = corpus
    argv = ["cluster", "--ani", "95", "-q"]
    if mode == "reference":
        refs = tmp_path / "refs.txt"
        refs.write_text("".join(p + "\n" for p in paths[::4]))
        genomes = tmp_path / "genomes.txt"
        genomes.write_text("".join(
            p + "\n" for i, p in enumerate(paths) if i % 4))
        argv += ["--genome-fasta-list", str(genomes),
                 "--reference-genomes-list", str(refs)]
    else:
        argv += ["-d", d, "-x", "fna"]
    if mode == "low-memory":
        argv.append("--low-memory")
    calls = []
    for name in ("screen_triangle", "screen_rectangle"):
        real = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _r=real, _n=name, **k: (
            calls.append((_n, k.get("cache_blocks"))) or _r(*a, **k)))
    monkeypatch.setenv("GALAH_TPU_SCREEN", "indicator")
    monkeypatch.setenv("GALAH_TPU_SCREEN_DTYPE", dtype)
    monkeypatch.setenv("GALAH_TPU_VERIFY_DEVICES", "1")
    out = []
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        if name == "torch":
            monkeypatch.setenv("GALAH_TPU_PLATFORM", "cpu")
        tsv = tmp_path / f"{name}.tsv"
        assert main(argv + ["--output-cluster-definition", str(tsv)]) == 0
        out.append(tsv.read_bytes())
    assert out[0] == out[1]
    assert calls == [("screen_rectangle", None) if mode == "reference"
                     else ("screen_triangle", mode != "low-memory")]
    fam_of = dict(zip(paths, fams))
    clusters = {}
    for line in out[1].decode().splitlines():
        rep, member = line.split("\t")
        clusters.setdefault(rep, set()).add(fam_of[member])
    assert len(clusters) == 4 and all(len(f) == 1 for f in clusters.values())
