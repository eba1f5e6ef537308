"""The verify profile's inputs and timed run
(galah_tpu_torch/tools/verify_profile.py) on the CPU: its synthetic
families have the shapes it asks for and the pairs the screen would
pass, and its timed run splits the pair table's host time by step
without changing a result."""

import dataclasses

import numpy as np
import pytest
import torch

from galah_tpu_torch.ops import pair_table as pt
from galah_tpu_torch.tools import verify_profile

CPU = torch.device("cpu")


def test_synthetic_sketches_have_the_shapes_asked_for():
    sk, pairs = verify_profile.synthetic_sketches(3, 4, 1000, 7, 1 << 14,
                                                  seed=1)
    assert len(sk) == 12 and len(pairs) == 3 * 4 * 3
    assert all(a.split("_")[0] == b.split("_")[0] for a, b in pairs)
    s = sk["f1_m2"]
    assert s.frag_buckets.shape == (1000,) and s.n_fragments == 7
    assert s.frag_offsets[0] == 0 and s.frag_offsets[-1] == 1000
    for lo, hi in zip(s.frag_offsets[:-1], s.frag_offsets[1:]):
        assert np.all(np.diff(s.frag_buckets[lo:hi]) >= 0)
    np.testing.assert_array_equal(s.member_buckets,
                                  np.unique(s.frag_buckets))
    assert s.frag_buckets.max() < 1 << 14
    # members of a family share most of their buckets
    shared = len(np.intersect1d(sk["f1_m0"].member_buckets,
                                sk["f1_m1"].member_buckets))
    assert shared > 0.5 * len(sk["f1_m0"].member_buckets)
    again, _ = verify_profile.synthetic_sketches(3, 4, 1000, 7, 1 << 14,
                                                 seed=1)
    assert np.array_equal(again["f2_m3"].frag_buckets,
                          sk["f2_m3"].frag_buckets)


def test_timed_run_splits_the_host_time_and_keeps_the_results(monkeypatch):
    sk, pairs = verify_profile.synthetic_sketches(4, 3, 2000, 5, 1 << 14,
                                                  seed=2)
    engine = verify_profile._engine(sk, CPU)
    engine.pair_table.cfg = dataclasses.replace(engine.pair_table.cfg,
                                                max_pairs=5)
    want = engine.pair_table.run(pairs, sk)
    got, res = verify_profile.timed_run(engine, pairs, sk, CPU)
    assert res == want
    assert got["batches"] == len(engine.pair_table._plan_batches(pairs, sk))
    assert got["batches"] == -(-len(pairs) // 5)
    for key in ("plan", "dispatch", "issue", "collect"):
        assert 0 <= got[f"{key}_us_a_batch"] <= got["host_us_a_batch"]
    assert got["host_us_a_batch"] * got["batches"] == pytest.approx(
        got["wall_s"] * 1e6)
    assert pt.PairTableVerifier._dispatch.__name__ == "_dispatch"
    assert pt._pair_table_kernel.__name__ == "_pair_table_kernel"
    # within-family pairs at 98% ANI align on most fragments
    assert np.mean([v[1] for v in res.values()]) > 0.5
