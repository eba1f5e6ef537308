"""The gather probe's kernels (K3 `gather_xor`, K4 `gather_xor_chains`)
against the JAX package's Pallas kernels.

At the reference probe's full shape (2^17 int32 indices into a 2^17 x 8
uint32 table), inputs made with a numpy seed go through
benchmarks/pallas_gather_probe.py's `pallas_gather` and
`pallas_gather_chains` in interpret mode and through the port's plain
version: the XOR is exact, so the bits must be equal, for every unroll
the probe runs. The CUDA kernels run only on a card: their tests are in
test_torch_cuda.py. The probe's entry point runs here on the CPU at a
small shape."""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from galah_tpu_torch.ops import gather_probe as gp
from galah_tpu_torch.tools import gather_probe as tool
from galah_tpu_torch.utils.convert import words_to_torch

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pallas_probe():
    """benchmarks/pallas_gather_probe.py, imported with JAX's persistent
    compile cache (which the module turns on) switched off, and the
    environment restored afterwards."""
    keys = ("GALAH_TPU_NO_COMPILE_CACHE", "JAX_COMPILATION_CACHE_DIR")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ["GALAH_TPU_NO_COMPILE_CACHE"] = "1"
    try:
        spec = importlib.util.spec_from_file_location(
            "pallas_gather_probe", REPO / "benchmarks" / "pallas_gather_probe.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return mod


@pytest.fixture(scope="module")
def reference_inputs(pallas_probe):
    rng = np.random.default_rng(2024)
    idx = rng.integers(0, pallas_probe.WT, size=pallas_probe.NS, dtype=np.int32)
    table = rng.integers(0, 1 << 32, size=(pallas_probe.WT, pallas_probe.RW),
                         dtype=np.uint32)
    return idx, table


@pytest.mark.parametrize("maker,unroll", [
    ("pallas_gather", 1), ("pallas_gather", 4), ("pallas_gather", 8),
    ("pallas_gather_chains", 8), ("pallas_gather_chains", 16),
    ("pallas_gather_chains", 32),
])
def test_plain_version_matches_pallas_kernels(pallas_probe, reference_inputs,
                                              maker, unroll):
    import jax.numpy as jnp

    idx, table = reference_inputs
    want = np.asarray(getattr(pallas_probe, maker)(unroll, True)(
        jnp.asarray(idx), jnp.asarray(table)))
    wrapper = {"pallas_gather": gp.gather_xor,
               "pallas_gather_chains": gp.gather_xor_chains}[maker]
    ti, tt = torch.from_numpy(idx), words_to_torch(table)
    got = gp.gather_xor_reference(ti, tt).numpy().view(np.uint32)
    assert want.dtype == np.uint32 and want.shape == (1, gp.ROW_WORDS)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.bitwise_xor.reduce(table[idx], axis=0, keepdims=True))
    # On the CPU the wrapper takes the plain version.
    np.testing.assert_array_equal(
        wrapper(ti, tt, unroll).numpy().view(np.uint32), want)


@pytest.mark.parametrize("ns", [0, 1, 3, 5, 7, 33, 1001])
def test_fold_of_any_length(ns):
    rng = np.random.default_rng(ns)
    table = rng.integers(0, 1 << 32, size=(50, gp.ROW_WORDS), dtype=np.uint32)
    idx = rng.integers(0, 50, size=ns, dtype=np.int32)
    got = gp.gather_xor_reference(torch.from_numpy(idx), words_to_torch(table))
    want = np.bitwise_xor.reduce(table[idx], axis=0, keepdims=True)
    if ns == 0:
        want = np.zeros((1, gp.ROW_WORDS), np.uint32)
    assert got.shape == (1, gp.ROW_WORDS) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def _ok():
    return (torch.zeros(16, dtype=torch.int32),
            torch.zeros((4, gp.ROW_WORDS), dtype=torch.int32))


@pytest.mark.parametrize("case,exc,match", [
    ("idx int64", TypeError, "int32"),
    ("table int64", TypeError, "int32"),
    ("table width 7", ValueError, "table"),
    ("idx 2-D", ValueError, "idx"),
    ("table not contiguous", ValueError, "contiguous"),
    ("empty table", ValueError, "no rows"),
    ("index past the table", IndexError, r"\[0, 4\)"),
    ("negative index", IndexError, r"\[0, 4\)"),
    ("unroll 3", ValueError, "unroll"),
    ("mixed devices", ValueError, "different devices"),
    ("meta device", ValueError, "unsupported device"),
])
@pytest.mark.parametrize("wrapper", [gp.gather_xor, gp.gather_xor_chains])
def test_wrappers_reject_what_the_kernel_does_not_take(wrapper, case, exc,
                                                       match):
    idx, table = _ok()
    unroll = 8
    if case == "idx int64":
        idx = idx.long()
    elif case == "table int64":
        table = table.long()
    elif case == "table width 7":
        table = table[:, :7].contiguous()
    elif case == "idx 2-D":
        idx = idx.reshape(4, 4)
    elif case == "table not contiguous":
        table = torch.zeros((gp.ROW_WORDS, 4), dtype=torch.int32).T
    elif case == "empty table":
        table = table[:0]
    elif case == "index past the table":
        idx[5] = 4
    elif case == "negative index":
        idx[5] = -1
    elif case == "unroll 3":
        unroll = 3
    elif case == "mixed devices":
        idx = idx.to("meta")
    elif case == "meta device":
        idx, table = idx.to("meta"), table.to("meta")
    before = wrapper.launches
    with pytest.raises(exc, match=match):
        wrapper(idx, table, unroll)
    assert wrapper.launches == before


def test_cpu_tensors_never_touch_the_kernel_library(monkeypatch):
    from galah_tpu_torch.ops import _build

    def no_library():
        raise AssertionError("the CPU path loaded the kernel library")

    monkeypatch.setattr(_build, "load_library", no_library)
    rng = np.random.default_rng(1)
    table = rng.integers(0, 1 << 32, size=(64, gp.ROW_WORDS), dtype=np.uint32)
    idx = rng.integers(0, 64, size=999, dtype=np.int32)
    want = np.bitwise_xor.reduce(table[idx], axis=0, keepdims=True)
    before = (gp.gather_xor.launches, gp.gather_xor_chains.launches)
    for fn, unroll in ((gp.gather_xor, 1), (gp.gather_xor_chains, 32)):
        got = fn(torch.from_numpy(idx), words_to_torch(table), unroll)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert (gp.gather_xor.launches, gp.gather_xor_chains.launches) == before


def test_probe_entry_point_on_the_cpu(monkeypatch, capsys):
    """The probe's main at small shapes: every setting of both kernels,
    the plain version and index_select, one line each and a JSON
    summary."""
    import json

    shapes = (tool.Shape("reference", 512, 700), tool.Shape("large", 4096, 999))
    monkeypatch.setattr(tool, "SHAPES", shapes)
    monkeypatch.setenv("GALAH_TPU_PLATFORM", "cpu")
    assert tool.main(["--iters", "2", "--seed", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu (plain versions, host clock)"
    summary = json.loads(lines[-1])
    got = [(r["shape"], r["kernel"], r["unroll"]) for r in summary["results"]]
    want = [(s.name, k, u) for s in shapes
            for k, u in [("gather_xor", 1), ("gather_xor", 4),
                         ("gather_xor", 8), ("gather_xor_chains", 8),
                         ("gather_xor_chains", 16), ("gather_xor_chains", 32),
                         ("plain", None), ("index_select", None)]]
    assert got == want
    assert len(lines) == len(want) + 2
    assert all(r["ms"] > 0 and r["indices_per_s"] > 0
               for r in summary["results"])


def test_probe_inputs_follow_the_seed():
    shape = tool.Shape("s", 100, 300)
    a = tool.make_inputs(shape, 5, CPU)
    b = tool.make_inputs(shape, 5, CPU)
    c = tool.make_inputs(shape, 6, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    idx, table = a
    assert idx.dtype == torch.int32 and 0 <= int(idx.min()) <= int(idx.max()) < 100
    assert table.shape == (100, gp.ROW_WORDS) and int(table.min()) >= 0


def test_probe_refuses_a_kernel_that_disagrees(monkeypatch):
    shape = tool.Shape("s", 64, 100)
    bad = list(tool.KERNELS)
    bad[1] = ("gather_xor_chains", lambda i, t, u: gp.gather_xor_reference(i, t) ^ 1,
              (8,))
    monkeypatch.setattr(tool, "KERNELS", tuple(bad))
    with pytest.raises(RuntimeError, match="gather_xor_chains unroll=8 differs"):
        tool.run_probe((shape,), iters=1, device=CPU)


def test_probe_patterns_on_the_cpu():
    """run_patterns at a small shape: every pattern through both kernels,
    then the torch read of the table."""
    shape = tool.Shape("s", 3 * tool.TILE_ROWS + 5, 999)
    results = tool.run_patterns(shape, seed=2, iters=1, device=CPU)
    got = [(r["pattern"], r["kernel"], r["unroll"], r["indices"])
           for r in results]
    want = [(p, k, u, shape.rows if p == "full" else shape.indices)
            for p in tool.PATTERNS for k, _, us in tool.KERNELS for u in us]
    assert got == want + [("full", "table_sum", None, shape.rows)]
    assert all(r["ms"] > 0 for r in results)


@pytest.mark.parametrize("pattern", tool.PATTERNS)
def test_probe_patterns_are_indices_of_the_table(pattern):
    rows = 5 * tool.TILE_ROWS + 3
    idx, _ = tool.make_inputs(tool.Shape("s", rows, 4000), 1, CPU)
    got = tool.pattern_indices(pattern, idx, rows)
    assert got.dtype == torch.int32
    assert 0 <= int(got.min()) and int(got.max()) < rows
    if pattern in ("random", "sorted", "grouped"):
        assert torch.equal(got.sort().values, idx.sort().values)
    if pattern in ("sorted", "sequential", "full"):
        assert bool((got[1:] >= got[:-1]).all())
    assert got.numel() == (rows if pattern == "full" else 4000)


def test_grouped_pattern_of_the_reference_probe_matches_pallas(
        pallas_probe, reference_inputs):
    """At the reference probe's full shape, the `grouped` pattern is the
    stable grouping of the indices by tile, and the XOR over that order
    equals the Pallas kernels' result in interpret mode."""
    import jax.numpy as jnp

    idx, table = reference_inputs
    want = np.asarray(pallas_probe.pallas_gather_chains(8, True)(
        jnp.asarray(idx), jnp.asarray(table)))
    ti = torch.from_numpy(idx)
    grouped = tool.pattern_indices("grouped", ti, pallas_probe.WT)
    order = np.argsort(idx // tool.TILE_ROWS, kind="stable")
    np.testing.assert_array_equal(grouped.numpy(), idx[order])
    for fn, unroll in ((gp.gather_xor, 1), (gp.gather_xor_chains, 32)):
        got = fn(grouped, words_to_torch(table), unroll)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
