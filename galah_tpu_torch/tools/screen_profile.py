"""Where the packed screen's time goes, tile by tile, on a card.

    python -m galah_tpu_torch.tools.screen_profile [--rows N] [--words W]
        [--set-bits B] [--window-blocks K] [--seed S] [--out DIR]

Random packed rows from --seed: N rows of W int32 words with about B
bits set a row. The defaults are the contig corpus's screen (chip_smoke
.py, BASELINE config #3): 100,000 rows of 1,024 words (2^15 prefilter
bits under --small-contigs) with ~500 bits set (5 kb over genome_scale
10), so 4,851 tiles of 1024^2. Random rows share no hits, so the drain
decodes empty tiles: the time measured is the screen's fixed cost a
tile. On the card:

- the resident sweep (ops/prefilter.py::screen_triangle_packed, which
  prebuilds an IncrementalPackedScreen) over every row, synchronised:
  its wall, per tile, and the host time spent in the drains (_TileQueue
  ._drain), of it the wait for each tile's copy (its CUDA event);
- torch.profiler over a prebuilt screen of the first K row blocks
  (K(K+1)/2 tiles): device time per kernel and host time per operator,
  per tile, kernel launches per tile, and the device's busy share of
  that window's wall (the union of its kernels' and copies' intervals
  over the wall), as a JSON line and key_averages tables under --out.

The last lines are the card's name and power limit as nvidia-smi prints
them and one JSON object. Needs a CUDA device: there is nothing to time
on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, Tuple

import numpy as np
import torch


def random_rows(rows: int, words: int, set_bits: int, seed: int,
                device: torch.device) -> torch.Tensor:
    """(rows, words) int32 packed rows, each with set_bits random bit
    positions set (fewer where a position repeats), made on `device`
    from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    row_bits = words * 32
    pos = torch.randint(0, row_bits, (rows, set_bits), generator=gen,
                        device=device)
    pos += torch.arange(rows, device=device)[:, None] * row_bits
    pos = torch.unique(pos)
    w = torch.zeros(rows * words, dtype=torch.int64, device=device)
    w.index_add_(0, pos >> 5, torch.ones_like(pos) << (pos & 31))
    w = torch.where(w >= 1 << 31, w - (1 << 32), w)
    return w.to(torch.int32).view(rows, words)


def popcounts(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each row, float32."""
    from galah_tpu_torch.ops.popcount_screen import _popc32

    return _popc32(x).sum(dim=1).to(torch.float32)


def timed_sweep(x: torch.Tensor, s: torch.Tensor, bits: int,
                cut: float) -> dict:
    """The resident sweep over x, its wall and its drains' host time."""
    from galah_tpu_torch.ops import prefilter as pf

    acc = {"drain_s": 0.0, "wait_s": 0.0, "tiles": 0}
    drain = pf._TileQueue._drain

    def timed_drain(self, t):
        t0 = time.perf_counter()
        if t.done is not None:
            t.done.synchronize()
        acc["wait_s"] += time.perf_counter() - t0
        drain(self, t)
        acc["drain_s"] += time.perf_counter() - t0
        acc["tiles"] += 1

    rows = list(x.cpu().numpy().view(np.uint32))
    sizes = s.cpu().numpy()
    pf._TileQueue._drain = timed_drain
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pf.screen_triangle_packed(rows, sizes, 15, cut, bits,
                                        device=x.device,
                                        block=pf.DEFAULT_BLOCK,
                                        matrix_builder=lambda n: x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pf._TileQueue._drain = drain
    n = acc["tiles"]
    return {"tiles": n, "pairs": int(len(res.pairs)), "wall_s": wall,
            "ms_a_tile": wall / n * 1e3,
            "drain_ms_a_tile": acc["drain_s"] / n * 1e3,
            "wait_ms_a_tile": acc["wait_s"] / n * 1e3,
            "issue_ms_a_tile": (wall - acc["drain_s"]) / n * 1e3}


def _busy_us(prof) -> Tuple[float, Dict[str, float]]:
    """(µs of the union of the device's activity intervals, µs by
    kernel or copy name) from a profile's device-side events."""
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.end - e.time_range.start)
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy, by_name


def profiled_window(x: torch.Tensor, s: torch.Tensor, bits: int, cut: float,
                    blocks: int, out: str) -> dict:
    """torch.profiler over a prebuilt screen of the first `blocks` row
    blocks."""
    from torch.profiler import ProfilerActivity, profile

    from galah_tpu_torch.ops import prefilter as pf

    n = min(x.shape[0], blocks * pf.DEFAULT_BLOCK)
    xw, sw = x[:n].contiguous(), s[:n].contiguous()

    def run():
        scr = pf.IncrementalPackedScreen(n, 15, cut, bits, x.device)
        scr.set_prebuilt(xw, sw)
        scr.finish()
        return scr.nblocks * (scr.nblocks + 1) // 2

    run()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tiles = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    with open(os.path.join(out, "screen_profile.txt"), "w") as f:
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=40))
        f.write("\n")
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=40))
    busy_us, device = _busy_us(prof)
    host = {e.key: e.self_cpu_time_total / tiles for e in events
            if e.self_cpu_time_total}
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")

    def top(d, scale=1.0):
        return {k[:80]: v * scale
                for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:12]}

    return {"tiles": tiles, "wall_s": wall, "ms_a_tile": wall / tiles * 1e3,
            "device_busy_share": busy_us / (wall * 1e6),
            "device_us_a_tile_total": busy_us / tiles,
            "device_us_a_tile": top(device, 1.0 / tiles),
            "host_us_a_tile": top(host),
            "host_us_a_tile_total": sum(host.values()),
            "kernel_launches_a_tile": launches / tiles}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--words", type=int, default=1024)
    ap.add_argument("--set-bits", type=int, default=500)
    ap.add_argument("--window-blocks", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/screen_profile")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("screen_profile: no CUDA device", file=sys.stderr)
        return 1
    from galah_tpu_torch.engines.native import _screen_min_containment
    from galah_tpu_torch.ops.packed_matmul import packed_intersect_counts

    os.makedirs(args.out, exist_ok=True)
    device = torch.device("cuda", 0)
    bits = args.words * 32
    cut = _screen_min_containment(95.0, 0.15, 15)
    x = random_rows(args.rows, args.words, args.set_bits, args.seed, device)
    s = popcounts(x)
    packed_intersect_counts(x[:8], x[:8])  # build and load the kernels
    result = {"rows": args.rows, "words": args.words,
              "mean_set_bits": float(s.mean()), "cutoff": cut}
    launches = packed_intersect_counts.launches
    result["sweep"] = timed_sweep(x, s, bits, cut)
    result["sweep"]["k1_launches"] = packed_intersect_counts.launches - launches
    print("sweep: " + json.dumps(result["sweep"]), flush=True)
    result["window"] = profiled_window(x, s, bits, cut, args.window_blocks,
                                       args.out)
    print("window: " + json.dumps(result["window"]), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
