"""K6, the screen tile's epilogue, timed at the screen's tile shapes on a
card.

    python -m galah_tpu_torch.tools.k6_profile [--iters N] [--seed S]
        [--target-blocks B,B,...] [--trace] [--out DIR]

At the contig path's tile (1024 x 1024, W = 1024 words), its edge tile
(1024 x 672) and the reference-mode tile (896 x 128, W = 4096): random
packed rows from --seed (as tools/screen_profile.py makes them) with 32
column rows copied from row rows, so a tile has a few hits under the
screen's cutoff; K1's int32 counts of them, K6 on those counts checked
bit for bit against its plain version, then

- its time a call in a CUDA graph of N calls (CUDA events around a
  replay) and called one by one (CUDA events around N calls);
- torch.profiler over one replay of that graph: device µs a call by
  kernel name, so a design of several kernels shows each.

--trace builds K6 with GALAH_K6_TRACE (csrc/screen_epilogue.cu) into a
library of its own and launches it one call at a time: each block's
thread 0 records the global timer at entry, after its ticket, its
passes, its aggregate's publication, its look-back, its hits and at
exit; the tool gives, over the launches' medians, the mean block, the
latest block and ticket 0 at each point, in µs from the launch's first
entry.

--target-blocks times the graph again with K6's launch plan aimed at
each of these block counts (ops/screen_epilogue.py TARGET_BLOCKS; a tree
without that plan ignores it). The module needs nothing the two-launch
design's wrapper lacks, so it runs unchanged in an earlier tree's
archive with this file copied in. The last lines are the card's name
and power limit as nvidia-smi prints them and one JSON object; --out
also gets the profiler's tables. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Callable, Dict

import torch

SHAPES = ((1024, 1024, 1024), (1024, 672, 1024), (896, 128, 4096))


def tile_inputs(m: int, n: int, w: int, seed: int, device: torch.device):
    """(counts, a, b, cutoff, cap) of one tile: K1's counts of random
    rows with copies planted, their sizes, the screen's cutoff and cap."""
    from galah_tpu_torch.engines.native import _screen_min_containment
    from galah_tpu_torch.ops.packed_matmul import packed_intersect_counts
    from galah_tpu_torch.ops.prefilter import _screen_cap_for
    from galah_tpu_torch.tools.screen_profile import popcounts, random_rows

    x = random_rows(m, w, w // 2, seed, device)
    y = random_rows(n, w, w // 2, seed + 1, device)
    k = min(m, n, 32)
    y[:k] = x[m - k:]
    cut = float(_screen_min_containment(95.0, 0.15, 15))
    return (packed_intersect_counts(x, y), popcounts(x), popcounts(y), cut,
            _screen_cap_for(1024))


def graph_of(fn: Callable[[], object], iters: int) -> torch.cuda.CUDAGraph:
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return g


def events_ms(run: Callable[[], object], calls: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def kernel_us(g: torch.cuda.CUDAGraph, iters: int, out: str,
              name: str) -> Dict[str, float]:
    """Device µs a call by kernel name over one replay of g."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        g.replay()
        torch.cuda.synchronize()
    by_name: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + (e.time_range.end - e.time_range.start) / iters)
    if out:
        with open(os.path.join(out, f"k6_{name}.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=20))
    return {k[:100]: v for k, v in by_name.items()}


TRACE_POINTS = ("entry", "ticket", "passes", "published", "look_back",
                "hits", "exit")


def traced(iters: int, seed: int) -> Dict[str, dict]:
    """K6's timeline a launch at SHAPES, from the GALAH_K6_TRACE build."""
    import ctypes

    import numpy as np

    from galah_tpu_torch.ops import _build
    from galah_tpu_torch.ops import screen_epilogue as se

    lib = _build.bind(ctypes.CDLL(str(_build.build_library(
        defines=["GALAH_K6_TRACE"]).path)))
    lib.galah_screen_epilogue_trace.argtypes = [ctypes.c_void_p]
    lib.galah_screen_epilogue_trace.restype = ctypes.c_int
    host = np.zeros((1024, len(TRACE_POINTS)), dtype=np.uint64)
    keep = _build.load_library
    _build.load_library = lambda: lib
    out = {}
    try:
        for m, n, w in SHAPES:
            counts, a, b, cut, cap = tile_inputs(m, n, w, seed, torch.device(
                "cuda", 0))
            blocks = se.epilogue_plan(m, n)[1]
            means, lasts, firsts = [], [], []
            for _ in range(iters):
                se.screen_epilogue(counts, a, b, bits_f=float(w * 32),
                                   min_cont_f=cut, diag=False, cap=cap,
                                   streaming=False)
                torch.cuda.synchronize()
                if lib.galah_screen_epilogue_trace(host.ctypes.data) != 0:
                    raise RuntimeError("K6 trace copy failed")
                t = host[:blocks].astype(np.int64)
                t = (t - t[:, 0].min()) / 1e3
                means.append(t.mean(axis=0))
                lasts.append(t.max(axis=0))
                firsts.append(t[0])
            out[f"{m}x{n}"] = {
                "blocks": blocks,
                "ticket0_us": dict(zip(TRACE_POINTS, np.median(
                    firsts, axis=0).round(3).tolist())),
                "mean_us": dict(zip(TRACE_POINTS, np.median(
                    means, axis=0).round(3).tolist())),
                "latest_us": dict(zip(TRACE_POINTS, np.median(
                    lasts, axis=0).round(3).tolist()))}
    finally:
        _build.load_library = keep
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--target-blocks", default="")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k6_profile: no CUDA device", file=sys.stderr)
        return 1
    from galah_tpu_torch.ops import screen_epilogue as se

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    device = torch.device("cuda", 0)
    result = {}
    for m, n, w in SHAPES:
        name = f"{m}x{n}"
        counts, a, b, cut, cap = tile_inputs(m, n, w, args.seed, device)
        kw = dict(bits_f=float(w * 32), min_cont_f=cut, diag=False, cap=cap,
                  streaming=False)
        got, want = (se.screen_epilogue(counts, a, b, **kw),
                     se.screen_epilogue_reference(counts, a, b, **kw))
        torch.cuda.synchronize()
        if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                and torch.equal(got[1], want[1])):
            print(f"k6_profile: K6 differs from its plain version at {name}",
                  file=sys.stderr)
            return 1
        def call():
            se.screen_epilogue(counts, a, b, **kw)

        def calls():
            for _ in range(args.iters):
                call()

        g = graph_of(call, args.iters)
        row = {
            "hits": int(want[1][0]),
            "graph_ms": events_ms(g.replay, args.iters),
            "eager_ms": events_ms(calls, args.iters),
            "kernel_us": kernel_us(g, args.iters, args.out, name),
        }
        del g
        targets = [int(t) for t in args.target_blocks.split(",") if t]
        if targets and hasattr(se, "TARGET_BLOCKS"):
            keep = se.TARGET_BLOCKS
            row["graph_ms_by_target_blocks"] = {}
            try:
                for t in targets:
                    se.TARGET_BLOCKS = t
                    g = graph_of(call, args.iters)
                    row["graph_ms_by_target_blocks"][t] = {
                        "plan": se.epilogue_plan(m, n),
                        "ms": events_ms(g.replay, args.iters)}
                    del g
            finally:
                se.TARGET_BLOCKS = keep
        result[name] = row
        print(f"{name}: " + json.dumps(row), flush=True)
    if args.trace:
        result["trace"] = traced(args.iters, args.seed)
        print("trace: " + json.dumps(result["trace"]), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
