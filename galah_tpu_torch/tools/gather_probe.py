"""The gather probe: how fast can the card XOR 32-byte table rows picked
by random indices? (counterpart of benchmarks/pallas_gather_probe.py,
`main`).

    python -m galah_tpu_torch.tools.gather_probe            # on the card
    GALAH_TPU_PLATFORM=cpu python -m galah_tpu_torch.tools.gather_probe

The rate sizes the word gathers of the verify programs
(ops/pair_table.py `_pair_table_kernel`, ops/fragment_ani.py
`_forward_kernel`). Two shapes:

- the reference probe's: a table of WT = 2^17 rows of RW = 8 uint32
  words (4 MiB, resident in the card's 50 MB L2) and NS = 2^17 indices;
- a table larger than L2: 2^23 rows (256 MiB) and 2^22 indices, whose
  random rows come from device memory.

For each, K3 (`gather_xor`, one accumulator) runs at unroll 1, 4 and 8
and K4 (`gather_xor_chains`, independent accumulators) at 8, 16 and 32.
Each result is checked bit for bit against the plain version, and
`torch.index_select(table, 0, idx)`, the counterpart of the reference
probe's XLA gather, is timed beside them. Inputs come from a seeded
torch.Generator on the device. Times are CUDA-event means over
`--iters` calls captured in a CUDA graph, so the host's Python work per
wrapper call, longer than the kernel at the reference shape, does not
hide the device time (time_ms); on the CPU (asked
for with GALAH_TPU_PLATFORM=cpu) the kernels' plain versions run and
the times are host-clock means, not device times. One line per setting,
then one JSON object with every result.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass
from typing import Callable, List

import torch

from galah_tpu_torch.ops.gather_probe import (
    ROW_WORDS,
    gather_xor,
    gather_xor_chains,
    gather_xor_reference,
)
from galah_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class Shape:
    name: str
    rows: int      # WT: table rows of ROW_WORDS uint32 words
    indices: int   # NS


REFERENCE = Shape("reference", 1 << 17, 1 << 17)
LARGE = Shape("larger-than-L2", 1 << 23, 1 << 22)
SHAPES = (REFERENCE, LARGE)
# (kernel name, wrapper, unrolls), as the reference probe runs them.
KERNELS = (
    ("gather_xor", gather_xor, (1, 4, 8)),
    ("gather_xor_chains", gather_xor_chains, (8, 16, 32)),
)


def make_inputs(shape: Shape, seed: int, device: torch.device):
    """idx (NS,) int32 uniform in [0, WT) and a (WT, 8) int32 table of
    words uniform in [0, 2^31 - 1), as the reference probe draws them."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    idx = torch.randint(0, shape.rows, (shape.indices,), generator=gen,
                        dtype=torch.int32, device=device)
    table = torch.randint(0, 2**31 - 1, (shape.rows, ROW_WORDS),
                          generator=gen, dtype=torch.int32, device=device)
    return idx, table


def time_ms(fn: Callable[[], object], device: torch.device, iters: int,
            graph: bool = True) -> float:
    """Mean ms per call of `fn` after one warm-up call. On a card: CUDA
    events around `iters` calls captured in one CUDA graph (replayed
    once to warm it, timed on the second replay), so the host's per-call
    Python work is not in the time; with graph=False, for a function that
    synchronises, around `iters` direct calls. On the CPU: the host
    clock."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    run = lambda: [fn() for _ in range(iters)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        g.replay()
        run = g.replay
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def run_probe(shapes=SHAPES, seed: int = 0, iters: int = 50,
              device: torch.device | None = None) -> List[dict]:
    """One result per (shape, kernel, unroll), plus the plain version and
    index_select per shape. Raises if a kernel's bits differ from the
    plain version's."""
    device = resolve_device() if device is None else device
    results = []
    for shape in shapes:
        idx, table = make_inputs(shape, seed, device)
        want = gather_xor_reference(idx, table)

        def record(kernel, unroll, ms):
            results.append({
                "shape": shape.name, "rows": shape.rows,
                "indices": shape.indices, "kernel": kernel,
                "unroll": unroll, "ms": ms,
                "indices_per_s": shape.indices / (ms * 1e-3),
            })

        for name, fn, unrolls in KERNELS:
            for unroll in unrolls:
                got = fn(idx, table, unroll)
                if not torch.equal(got, want):
                    raise RuntimeError(
                        f"{name} unroll={unroll} differs from the plain "
                        f"version at the {shape.name} shape")
                record(name, unroll,
                       time_ms(lambda: fn(idx, table, unroll), device, iters))
        # The plain version's bounds check synchronises: no graph.
        record("plain", None, time_ms(
            lambda: gather_xor_reference(idx, table), device,
            max(1, iters // 10), graph=False))
        record("index_select", None, time_ms(
            lambda: torch.index_select(table, 0, idx), device, iters))
        del idx, table
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m galah_tpu_torch.tools.gather_probe",
        description="Indices per second of the row-gather XOR kernels "
                    "(K3, K4) beside torch.index_select",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--iters", type=int, default=50,
                        help="timed calls per setting [default: 50]")
    args = parser.parse_args(argv)
    device = resolve_device()
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (plain versions, host clock)")
    print(f"device: {where}", flush=True)
    results = run_probe(SHAPES, seed=args.seed, iters=args.iters,
                        device=device)
    for r in results:
        unroll = "" if r["unroll"] is None else f" unroll={r['unroll']}"
        print(f"{r['shape']} ({r['rows']} rows, {r['indices']} indices) "
              f"{r['kernel']}{unroll}: {r['indices_per_s'] / 1e6:.1f}M idx/s "
              f"({r['ms']:.4f} ms)", flush=True)
    print(json.dumps({"device": where, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
