"""The port's mid-sweep checkpoint (--sweep-checkpoint), against the JAX
package's (modelled on tests/test_sweep_checkpoint.py).

24 genomes in 6 families through the port's CLI on the CPU, with 8-row
screen blocks (3 row blocks, 6 tiles) and every tile drained as soon as
it is issued. K1's plain version is what the CPU runs, so its calls
count the tiles issued; a crash is injected by making it raise:

- a sweep killed at half and resumed gives the clusters.tsv of a run
  without a checkpoint and of the JAX CLI, issuing only the tiles that
  were not logged, with the JAX package's screen counters;
- a completed log replays with no K1 call;
- a log of another corpus starts fresh;
- the same through the overlapped phases (_run_pipelined);
- a truncated tail record is ignored, and a log written by either
  package's SweepCheckpoint loads in the other's.
"""

import json
import os
import struct

import numpy as np
import pytest

import galah_tpu.ops.prefilter as jax_pf
from galah_tpu.cli.main import main as jax_main
from galah_tpu.ops import sweep_checkpoint as jax_ckpt
from galah_tpu.utils.synth import make_families
from galah_tpu_torch.cli.main import main as torch_main
from galah_tpu_torch.ops import packed_matmul as pm
from galah_tpu_torch.ops import prefilter as pf
from galah_tpu_torch.ops import sweep_checkpoint as ckpt

TILES = 6  # 24 genomes, 8-row blocks: 3 row blocks
K1_PLAIN = pm.packed_intersect_counts_reference


class Boom(RuntimeError):
    pass


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_corpus")
    make_families(str(d), n_families=6, members_per_family=4,
                  genome_length=30_000, within_ani=0.97, seed=9)
    return sorted(str(p) for p in d.iterdir() if p.suffix == ".fna")


@pytest.fixture(scope="module")
def jax_tsv(corpus, tmp_path_factory):
    """The JAX CLI's clusters.tsv, on its single-device packed screen."""
    out = tmp_path_factory.mktemp("ckpt_jax") / "jax.tsv"
    mp = pytest.MonkeyPatch()
    mp.setenv("GALAH_TPU_SCREEN", "packed")
    mp.setenv("GALAH_TPU_VERIFY_DEVICES", "1")
    mp.delenv("GALAH_TPU_PLATFORM", raising=False)
    try:
        assert jax_main(["cluster", "-f", *corpus, "--ani", "95",
                         "--output-cluster-definition", str(out), "-q"]) == 0
    finally:
        mp.undo()
    return out.read_bytes()


@pytest.fixture()
def small_tiles(monkeypatch):
    monkeypatch.setattr(pf, "DEFAULT_BLOCK", 8)
    monkeypatch.setattr(pf, "TILE_WINDOW", 0)
    monkeypatch.setenv("GALAH_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("GALAH_TPU_SCREEN", "packed")


def _k1_calls(monkeypatch, crash_after=None):
    """Count the calls to K1's plain version; raise Boom on the call
    after `crash_after`."""
    calls = {"n": 0}

    def counting(a, b):
        calls["n"] += 1
        if crash_after is not None and calls["n"] > crash_after:
            raise Boom("injected crash mid-sweep")
        return K1_PLAIN(a, b)

    monkeypatch.setattr(pm, "packed_intersect_counts_reference", counting)
    return calls


def _run(corpus, tmp_path, tag, ckpt_path=None, extra=("-q",)):
    """(exit code, clusters.tsv bytes or None, metrics counters)."""
    tsv = tmp_path / f"{tag}.tsv"
    mjson = tmp_path / f"{tag}.json"
    argv = ["cluster", "-f", *corpus, "--ani", "95",
            "--output-cluster-definition", str(tsv),
            "--metrics-json", str(mjson), *extra]
    if ckpt_path:
        argv += ["--sweep-checkpoint", str(ckpt_path)]
    rc = torch_main(argv)
    counters = json.loads(mjson.read_text())["counters"] if rc == 0 else {}
    return rc, (tsv.read_bytes() if rc == 0 else None), counters


def _logged_tiles(path):
    """The (bi, bj) of every whole record of a sweep log."""
    with open(path, "rb") as f:
        raw = f.read()
    pos = len(ckpt._MAGIC)
    (fp_len,) = struct.unpack_from("<i", raw, pos)
    pos += 4 + fp_len
    out = []
    while pos + 16 <= len(raw):
        tag, bi, bj, count = struct.unpack_from("<4siii", raw, pos)
        end = pos + 16 + count * 20
        if tag != ckpt._REC or end > len(raw):
            break
        out.append((bi, bj))
        pos = end
    return out


def test_kill_at_half_then_resume_byte_identical(
    corpus, jax_tsv, tmp_path, monkeypatch, small_tiles
):
    rc, ref, ref_counters = _run(corpus, tmp_path, "ref")
    assert rc == 0 and ref == jax_tsv
    assert ref_counters["screen_tiles"] == TILES
    log = tmp_path / "sweep.ckpt"
    _k1_calls(monkeypatch, crash_after=3)
    rc, _, _ = _run(corpus, tmp_path, "killed", log)
    assert rc == 1
    logged = _logged_tiles(log)
    assert len(logged) == 3  # each tile drained as soon as it was issued
    calls = _k1_calls(monkeypatch)
    rc, resumed, counters = _run(corpus, tmp_path, "resumed", log)
    assert rc == 0
    assert resumed == ref == jax_tsv
    assert calls["n"] == TILES - len(logged)
    assert counters["screen_tiles"] == TILES - len(logged)
    assert counters["screen_tiles_restored"] == len(logged)
    assert counters["screen_pairs_computed"] == (TILES - len(logged)) * 64
    assert sorted(_logged_tiles(log)) == sorted(
        (bi, bj) for bi in range(3) for bj in range(bi, 3))


def test_resume_counters_match_jax_package(
    corpus, tmp_path, monkeypatch, small_tiles
):
    """The same crash in both packages (after 3 of 6 one-tile
    dispatches, each drained at once): the resumed runs compute the same
    pairs (screen_pairs_computed, replayed tiles excluded) and give the
    same clusters.tsv."""
    monkeypatch.setattr(jax_pf, "TILE_WINDOW", 0)
    got = {}
    for name in ("jax", "torch"):
        log = tmp_path / f"{name}.ckpt"
        out = {}
        for phase in ("killed", "resumed"):
            crash = 3 if phase == "killed" else None
            if name == "jax":
                monkeypatch.setenv("GALAH_TPU_SCREEN_BLOCK", "8")
                monkeypatch.setenv("GALAH_TPU_SCREEN_TILE_GROUP", "1")
                monkeypatch.setenv("GALAH_TPU_VERIFY_DEVICES", "1")
                monkeypatch.delenv("GALAH_TPU_PLATFORM", raising=False)
                calls = {"n": 0}
                real = jax_pf._resident_screen_extract

                def extract(*a, _real=real, _calls=calls, _crash=crash, **k):
                    _calls["n"] += 1
                    if _crash is not None and _calls["n"] > _crash:
                        raise Boom("injected crash mid-sweep")
                    return _real(*a, **k)

                monkeypatch.setattr(jax_pf, "_resident_screen_extract",
                                    extract)
                main = jax_main
            else:
                monkeypatch.setenv("GALAH_TPU_PLATFORM", "cpu")
                _k1_calls(monkeypatch, crash_after=crash)
                main = torch_main
            tsv = tmp_path / f"{name}_{phase}.tsv"
            mjson = tmp_path / f"{name}_{phase}.json"
            rc = main(["cluster", "-f", *corpus, "--ani", "95",
                       "--sweep-checkpoint", str(log),
                       "--output-cluster-definition", str(tsv),
                       "--metrics-json", str(mjson), "-q"])
            if name == "jax":
                monkeypatch.setattr(jax_pf, "_resident_screen_extract", real)
            assert rc == (1 if crash else 0)
            out[phase] = len(_logged_tiles(log))
        out["tsv"] = tsv.read_bytes()
        out["pairs_computed"] = json.loads(
            mjson.read_text())["counters"]["screen_pairs_computed"]
        got[name] = out
    assert got["torch"] == got["jax"]
    assert got["torch"]["killed"] == 3
    assert got["torch"]["pairs_computed"] == 3 * 64


def test_completed_log_replays_with_no_k1_call(
    corpus, jax_tsv, tmp_path, monkeypatch, small_tiles
):
    log = tmp_path / "sweep.ckpt"
    rc, first, _ = _run(corpus, tmp_path, "a", log)
    assert rc == 0 and first == jax_tsv
    assert len(_logged_tiles(log)) == TILES
    calls = _k1_calls(monkeypatch)
    rc, again, counters = _run(corpus, tmp_path, "b", log)
    assert rc == 0 and again == first
    assert calls["n"] == 0
    assert "screen_tiles" not in counters
    assert counters["screen_tiles_restored"] == TILES


def test_mismatched_log_starts_fresh(corpus, jax_tsv, tmp_path, monkeypatch,
                                     small_tiles):
    log = tmp_path / "sweep.ckpt"
    other = ckpt.SweepCheckpoint(str(log), ckpt.sweep_fingerprint(
        ["other1", "other2"], 4096, 8, 15, 0.3, pf.SCREEN_ROUTE))
    other.put(0, 0, np.array([[0, 1]], np.int64),
              np.array([99.0], np.float32))
    other.close()
    calls = _k1_calls(monkeypatch)
    rc, got, _ = _run(corpus, tmp_path, "got", log)
    assert rc == 0 and got == jax_tsv
    assert calls["n"] == TILES
    assert len(_logged_tiles(log)) == TILES


@pytest.mark.parametrize("block", [8, 16])
def test_log_of_another_block_edge_starts_fresh(
    corpus, jax_tsv, tmp_path, monkeypatch, small_tiles, block
):
    """The fingerprint records the block edge: a log written at 16-row
    blocks is not replayed by a sweep at 8-row blocks, and the reverse."""
    def tiles(edge):
        nb = -(-24 // edge)
        return nb * (nb + 1) // 2

    log = tmp_path / "sweep.ckpt"
    monkeypatch.setattr(pf, "DEFAULT_BLOCK", 24 - block)
    assert _run(corpus, tmp_path, "first", log)[0] == 0
    assert len(_logged_tiles(log)) == tiles(24 - block)
    monkeypatch.setattr(pf, "DEFAULT_BLOCK", block)
    calls = _k1_calls(monkeypatch)
    rc, got, _ = _run(corpus, tmp_path, "second", log)
    assert rc == 0 and got == jax_tsv
    assert calls["n"] == tiles(block)
    assert len(_logged_tiles(log)) == tiles(block)


def test_pipelined_kill_resume_and_replay(corpus, jax_tsv, tmp_path,
                                          monkeypatch, small_tiles):
    """Through the overlapped phases (device sketching on the CPU, i.e.
    K5's plain version): a crash with tiles in flight leaves only the
    drained tiles logged; the resume issues exactly the rest, and a
    third run replays every tile, its pairs still reaching the verify
    feeder (the clusters are the JAX CLI's)."""
    from galah_tpu_torch.engines import native

    monkeypatch.setenv("GALAH_TPU_PIPELINE", "1")
    monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "1")
    ran = []
    real = native.NativePreclusterer._run_pipelined
    monkeypatch.setattr(native.NativePreclusterer, "_run_pipelined",
                        lambda *a, **k: ran.append(1) or real(*a, **k))
    log = tmp_path / "pipe.ckpt"
    _k1_calls(monkeypatch, crash_after=4)
    assert _run(corpus, tmp_path, "killed", log)[0] == 1
    logged = _logged_tiles(log)
    assert 0 < len(logged) < 4
    calls = _k1_calls(monkeypatch)
    rc, resumed, counters = _run(corpus, tmp_path, "resumed", log)
    assert rc == 0 and resumed == jax_tsv
    assert calls["n"] == TILES - len(logged)
    assert counters["phases_overlapped"] == 1
    calls = _k1_calls(monkeypatch)
    rc, replayed, counters = _run(corpus, tmp_path, "replayed", log)
    assert rc == 0 and replayed == jax_tsv
    assert calls["n"] == 0
    assert counters["screen_tiles_restored"] == TILES
    assert len(ran) == 3


def test_streaming_and_popcount_warn_and_do_not_log(
    corpus, jax_tsv, tmp_path, monkeypatch, small_tiles, capsys
):
    log = tmp_path / "sweep.ckpt"
    rc, got, _ = _run(corpus, tmp_path, "lm", log, extra=["--low-memory"])
    assert rc == 0 and got == jax_tsv
    assert "streaming sweep will NOT checkpoint" in capsys.readouterr().err
    monkeypatch.setenv("GALAH_TPU_SCREEN", "popcount")
    rc, got, _ = _run(corpus, tmp_path, "pc", log, extra=())
    assert rc == 0 and got == jax_tsv
    assert "the popcount path will NOT checkpoint" in capsys.readouterr().err
    assert not log.exists()


# ------------------------------------------------------------ the log file


def _fp(mod):
    return mod.sweep_fingerprint(["a", "b", "c"], 4096, 8, 15, 0.3, "f32")


def test_fingerprints_are_the_jax_packages():
    names = [f"g{i}" for i in range(5)]
    for args in ((4096, 8, 15, 0.3, "f32"),
                 (1 << 15, 1024, 15, 0.1234567, pf.SCREEN_ROUTE)):
        assert (ckpt.sweep_fingerprint(names, *args)
                == jax_ckpt.sweep_fingerprint(names, *args))


def test_truncated_tail_record_ignored(tmp_path):
    fp = _fp(ckpt)
    path = str(tmp_path / "log")
    ck = ckpt.SweepCheckpoint(path, fp)
    ck.put(0, 0, np.array([[0, 1]], np.int64), np.array([97.5], np.float32))
    ck.put(0, 1, np.array([[0, 2]], np.int64), np.array([96.5], np.float32))
    ck.close()
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 6)
    ck2 = ckpt.SweepCheckpoint(path, fp)
    assert ck2.has(0, 0) is not None
    assert ck2.has(0, 1) is None
    ck2.put(0, 1, np.array([[0, 2]], np.int64), np.array([96.5], np.float32))
    ck2.close()
    ck3 = ckpt.SweepCheckpoint(path, fp)
    np.testing.assert_array_equal(ck3.has(0, 0)[0], [[0, 1]])
    np.testing.assert_array_equal(ck3.has(0, 1)[0], [[0, 2]])
    np.testing.assert_array_equal(ck3.has(0, 1)[1], np.float32([96.5]))
    ck3.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_log_reads_in_the_other_package(tmp_path, writer):
    mods = {"jax": jax_ckpt, "torch": ckpt}
    wmod = mods[writer]
    rmod = mods["torch" if writer == "jax" else "jax"]
    path = str(tmp_path / "log")
    rng = np.random.default_rng(3)
    want = {}
    w = wmod.SweepCheckpoint(path, _fp(wmod))
    for bi, bj, n in ((0, 0, 3), (0, 1, 0), (1, 1, 5)):
        pairs = rng.integers(0, 24, size=(n, 2)).astype(np.int64)
        anis = rng.uniform(90, 100, size=n).astype(np.float32)
        w.put(bi, bj, pairs, anis)
        want[(bi, bj)] = (pairs, anis)
    w.close()
    r = rmod.SweepCheckpoint(path, _fp(rmod))
    assert len(r) == 3
    for key, (pairs, anis) in want.items():
        got = r.has(*key)
        np.testing.assert_array_equal(got[0], pairs)
        np.testing.assert_array_equal(got[1], anis)
    r.close()
    # A different fingerprint starts fresh in the reading package too.
    other = rmod.SweepCheckpoint(path, rmod.sweep_fingerprint(
        ["a", "b"], 4096, 8, 15, 0.3, "f32"))
    assert len(other) == 0
    other.close()
