"""The screen profile's inputs (galah_tpu_torch/tools/screen_profile.py)
on the CPU: its random rows hold the bits it asks for, and its timed
sweep counts every tile of the resident screen and every drain."""

import numpy as np
import torch

from galah_tpu_torch.ops import prefilter as pf
from galah_tpu_torch.tools import screen_profile

CPU = torch.device("cpu")


def test_random_rows_set_distinct_bits():
    x = screen_profile.random_rows(50, 32, 40, seed=1, device=CPU)
    assert x.shape == (50, 32) and x.dtype == torch.int32
    got = screen_profile.popcounts(x).numpy()
    want = np.unpackbits(x.numpy().view(np.uint8), axis=1).sum(axis=1)
    np.testing.assert_array_equal(got, want)
    assert 35 <= got.min() and got.max() <= 40  # 40 positions, a few repeat
    again = screen_profile.random_rows(50, 32, 40, seed=1, device=CPU)
    assert torch.equal(x, again)


def test_timed_sweep_counts_every_tile(monkeypatch):
    monkeypatch.setattr(pf, "DEFAULT_BLOCK", 16)
    x = screen_profile.random_rows(50, 32, 300, seed=2, device=CPU)
    x[7] = x[3]
    s = screen_profile.popcounts(x)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    got = screen_profile.timed_sweep(x, s, 1024, 0.5)
    assert got["tiles"] == 4 * 5 // 2
    assert got["pairs"] >= 1
    assert 0 <= got["wait_ms_a_tile"] <= got["drain_ms_a_tile"]
    assert pf._TileQueue._drain.__name__ == "_drain"  # restored
    want = pf.screen_triangle_packed(list(x.numpy().view(np.uint32)),
                                     s.numpy(), 15, 0.5, 1024, device=CPU)
    assert got["pairs"] == len(want.pairs)


def test_busy_share_takes_the_union_of_device_intervals():
    """Overlapping device intervals count once; host events not at all."""
    from types import SimpleNamespace as NS

    def ev(name, lo, hi, dev=torch.autograd.DeviceType.CUDA):
        return NS(name=name, device_type=dev,
                  time_range=NS(start=lo, end=hi))

    prof = NS(events=lambda: [
        ev("k1", 0.0, 10.0), ev("add", 5.0, 12.0), ev("k1", 20.0, 25.0),
        ev("aten::add", 0.0, 100.0, torch.autograd.DeviceType.CPU)])
    busy, by_name = screen_profile._busy_us(prof)
    assert busy == 17.0
    assert by_name == {"k1": 15.0, "add": 7.0}
