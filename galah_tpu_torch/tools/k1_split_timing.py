"""Where K1's time goes: the packed-popcount kernel (csrc/packed_popcount.cu,
unpack to int8 in shared memory + s8 wgmma) beside its two halves.

    python -m galah_tpu_torch.tools.k1_split_timing      # on the card

Builds the kernel library with -DGALAH_TIMING_VARIANTS, which adds the C
entry galah_packed_popcount_variant (the kernel library the screens load
leaves it out), and times, under K1's own launch plan and at the shapes
chip_smoke.py gives K1:

- the kernel, checked bit-exact against the plain version;
- unpack-only (mode 1): every panel staged and unpacked, no product;
- product-only (mode 2): every wgmma on whatever the tiles hold, no
  copies and no unpack.

The halves' outputs are not counts and are not checked. Times are
CUDA-event means over --reps calls of the C entry alone (no output
allocation or zeroing in the timed window). One line per shape, then
the card's name and power limit as nvidia-smi prints them, then one
JSON object. Needs a CUDA device: there is nothing to time on the CPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from typing import Callable, List, Tuple

import torch

from galah_tpu_torch.ops._build import COUNT_ARGS, build_library
from galah_tpu_torch.ops.packed_matmul import (
    _launch_plan,
    packed_intersect_counts_reference,
    sm_count,
)

DEFINES = ("GALAH_TIMING_VARIANTS",)
UNPACK_ONLY, PRODUCT_ONLY = 1, 2
# K1's shapes in chip_smoke.py: the packed screen's 1024-row tiles at
# 2^18 and 2^17 bits, the reference-mode tile and a ragged shape.
SHAPES: Tuple[Tuple[int, int, int], ...] = (
    (1024, 1024, 8192), (1024, 1024, 4096), (896, 128, 4096),
    (1000, 777, 1000))


def load_variant_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(DEFINES).path))
    lib.galah_packed_popcount.argtypes = [*COUNT_ARGS, ctypes.c_void_p]
    lib.galah_packed_popcount_variant.argtypes = [
        *COUNT_ARGS, ctypes.c_int, ctypes.c_void_p]
    lib.galah_packed_popcount.restype = ctypes.c_int
    lib.galah_packed_popcount_variant.restype = ctypes.c_int
    return lib


def time_ms(fn: Callable[[], None], reps: int) -> float:
    """Mean ms per call: CUDA events around `reps` calls after one."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def split_times(lib: ctypes.CDLL, m: int, n: int, w: int, reps: int,
                gen: torch.Generator, device: torch.device) -> dict:
    """ms of the kernel, unpack-only and product-only at (m, n, w) on
    random words; raises if a launch fails or the kernel's counts
    differ from the plain version's."""
    a, b = (torch.randint(-(1 << 31), 1 << 31, (rows, w), generator=gen,
                          dtype=torch.int64, device=device).to(torch.int32)
            for rows in (m, n))
    plan = _launch_plan(m, n, w, sm_count(device))
    out = torch.empty((m, n), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, w,
            plan.split_words)

    def launch(mode: int = 0) -> None:
        err = (lib.galah_packed_popcount_variant(*args, mode, stream) if mode
               else lib.galah_packed_popcount(*args, stream))
        if err != 0:
            raise RuntimeError(f"K1 mode {mode} launch failed at "
                               f"{m}x{n}xW{w}: CUDA error {err}")

    out.zero_()  # the splits add into it
    launch()
    if not torch.equal(out, packed_intersect_counts_reference(a, b)):
        raise RuntimeError(f"K1 differs from the plain version at "
                           f"{m}x{n}xW{w}")
    gx, gy, gz = plan.grid
    return {"shape": [m, n, w], "blocks": gx * gy * gz,
            "ms": time_ms(launch, reps),
            "unpack_only_ms": time_ms(lambda: launch(UNPACK_ONLY), reps),
            "product_only_ms": time_ms(lambda: launch(PRODUCT_ONLY), reps)}


def main(argv: List[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m galah_tpu_torch.tools.k1_split_timing",
        description="K1's time beside its unpack-only and product-only "
                    "halves")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=20,
                        help="timed calls per setting [default: 20]")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_split_timing: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    lib = load_variant_library()
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    results = []
    for m, n, w in SHAPES:
        r = split_times(lib, m, n, w, args.reps, gen, device)
        results.append(r)
        print(f"K1 {m}x{n}xW{w} ({r['blocks']} blocks): kernel "
              f"{r['ms']:.4f} ms, unpack-only {r['unpack_only_ms']:.4f} ms, "
              f"product-only {r['product_only_ms']:.4f} ms", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
