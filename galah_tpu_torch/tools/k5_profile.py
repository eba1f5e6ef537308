"""Where K5's time goes at the batch shapes the CLI gives it.

    python -m galah_tpu_torch.tools.k5_profile [--reps N] [--out DIR] [--cuts]

K5 is the device sketch kernel (csrc/device_sketch.cu, wrapped by
ops/device_sketch.py::sketch_batch). Two batches, shaped as the CLI
plans them on a card:

- main: 64 genomes x 1 Mb (GENOME_BATCH_BYTES over the padded length
  2^20), at the main path's parameters (NativeSketchParams shrunk for
  1 Mb genomes: 2^22 member bits, 2^17 prefilter bits);
- contigs: 32,768 contigs x 5 kb (CONTIG_BATCH_BYTES over the padded
  length 2^13), at small_genome_params().

Random ACGT from --seed. For each batch, after one warm-up call:

- CUDA-event means over --reps calls of sketch_batch (the product span:
  the wrapper and K5) and of sketch_host_batch (upload, products,
  bitmaps to bucket lists, the host copy and cutting into sketches);
- torch.profiler over --reps calls of sketch_host_batch: device time
  per kernel and host time per operator, per call, as a JSON line and
  as key_averages tables under --out;
- the SASS of every kernel whose name holds "sketch" in the built
  library (cuobjdump -sass), written under --out, with the instructions
  K5 issues a k-mer start on its common path, in all and by integer
  pipe (hash_loop), and K5's bound at each shape from them (k5_bound,
  which chip_smoke.py uses too);
- with --cuts, CUDA-event means of the K5 launch alone, whole and built
  to stop after each of its first steps (CUTS: -DGALAH_K5_STOP_AFTER),
  so the difference between two is the time of the steps between them.

Without --cuts the same command times an older tree's K5 too, with that
tree first on PYTHONPATH (and gives it no bound). The last
lines are the card's name and power limit as nvidia-smi prints them and
one JSON object. Needs a CUDA device: there is nothing to time on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from typing import Dict, List

import numpy as np
import torch

SHAPES = {"main": (64, 1_000_000), "contigs": (32_768, 5_000)}
# Builds of K5 that stop early (csrc/device_sketch.cu): after hashing
# (steps 1-2, staging and the hash loop) and after the bitmaps (step 3).
CUTS = {"hash": 2, "bits": 3}
# Host operators whose time the profile reports per call.
HOST_OPS = (
    "aten::zeros", "aten::empty", "aten::zero_", "aten::item",
    "aten::_local_scalar_dense", "aten::sort", "aten::unique_consecutive",
    "aten::bincount", "aten::nonzero", "aten::cumsum",
    "aten::repeat_interleave", "aten::index", "aten::cat", "aten::copy_",
    "aten::to",
)


def _params(name: str):
    from galah_tpu_torch.engines.native import _shrink_bits
    from galah_tpu_torch.sketch.fracminhash import (
        NativeSketchParams,
        small_genome_params,
    )

    if name == "main":
        return _shrink_bits(NativeSketchParams(), SHAPES["main"][1])
    return small_genome_params()


def make_batch(name: str, seed: int):
    """The planned HostBatch of `name`'s shape, random ACGT bases."""
    from galah_tpu_torch.ops import device_sketch as ds

    units, length = SHAPES[name]
    params = _params(name)
    hb = ds.plan_layout([f"{name}{i}" for i in range(units)],
                        [[length]] * units, params)
    rng = np.random.default_rng(seed)
    hb.seq[:] = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, size=hb.seq.size, dtype=np.uint8)]
    return hb, params


def time_ms(fn, reps: int) -> float:
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


def cut_times(batch, reps: int) -> dict:
    """ms of the K5 launch alone on `batch` (CUDA events), whole and in
    each of CUTS's builds."""
    import ctypes

    from galah_tpu_torch.ops import _build
    from galah_tpu_torch.ops import device_sketch as ds

    libs = {"whole": None}
    for name, stop in CUTS.items():
        built = _build.build_library((f"GALAH_K5_STOP_AFTER={stop}",))
        libs[name] = _build.bind(ctypes.CDLL(str(built.path)))
    dev = batch.device
    member = torch.zeros((batch.n_units, batch.member_bits // 32),
                         dtype=torch.int32, device=dev)
    pref = torch.zeros((batch.n_units, batch.prefilter_bits // 32),
                       dtype=torch.int32, device=dev)
    counts = torch.empty(batch.n_frags, dtype=torch.int32, device=dev)
    slots = torch.empty(batch.n_slots, dtype=torch.int32, device=dev)
    return {name: round(time_ms(lambda lib=lib: ds.launch_k5(
        batch, member, pref, counts, slots, lib), reps), 4)
        for name, lib in libs.items()}


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile(hb, params, device, reps: int, out_dir: str, tag: str) -> dict:
    """torch.profiler over `reps` calls of sketch_host_batch: per call,
    each kernel's device ms and HOST_OPS' host ms (self time, their
    kernels' device ms beside it)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from galah_tpu_torch.ops import device_sketch as ds

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            ds.sketch_host_batch(hb, params, device)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    kernels, ops = {}, {}
    for e in avg:
        dev_ms = _device_us(e) / 1e3 / reps
        if e.key in HOST_OPS:
            ops[e.key] = {"host_ms": e.cpu_time_total / 1e3 / reps,
                          "self_host_ms": e.self_cpu_time_total / 1e3 / reps,
                          "calls": e.count // reps}
        elif dev_ms > 0 and not e.key.startswith(("aten::", "cuda")):
            kernels[e.key[:90]] = round(dev_ms, 5)
    with open(os.path.join(out_dir, f"{tag}_profile.txt"), "w") as f:
        for sort_by in ("self_cuda_time_total", "self_cpu_time_total"):
            f.write(avg.table(sort_by=sort_by, row_limit=40) + "\n")
    return {"kernels_device_ms": kernels,
            "device_ms": round(sum(kernels.values()), 5),
            "host_ops": {k: {kk: round(v, 5) if isinstance(v, float) else v
                             for kk, v in d.items()}
                         for k, d in sorted(ops.items())}}


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "cuobjdump")):
            return os.path.join(root, "bin", "cuobjdump")
    raise RuntimeError("cuobjdump not found")


_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA\s+(?:`\()?(0x[0-9a-f]+|\.L_x_\d+)")


def sass_functions(lib_path: str) -> Dict[str, List[str]]:
    """{function name: its SASS lines} of every function in the library."""
    text = subprocess.run([_cuobjdump(), "-sass", lib_path],
                          capture_output=True, text=True, check=True).stdout
    funcs: Dict[str, List[str]] = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
        elif cur is not None:
            funcs[cur].append(line)
    return funcs


def _instructions(lines: List[str]) -> List[tuple]:
    """[(address, instruction text, branch target address or None)] of a
    function's SASS lines."""
    instrs, labels, pending = [], {}, []
    for line in lines:
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for p in pending:
                labels[p] = addr
            pending = []
            instrs.append((addr, m.group(2)))
    out = []
    for addr, ins in instrs:
        b = _BRA.search(ins)
        tgt = None
        if b:
            t = b.group(1)
            tgt = int(t, 16) if t.startswith("0x") else labels.get(t)
        out.append((addr, ins, tgt))
    return out


# splitmix64's two products by the low words of its constants: the first
# marks a k-mer start, the threshold compare follows the second.
_FIRST_PRODUCT = "0x1ce4e5b9"
_SECOND_PRODUCT = "0x133111eb"

# What an H100 SM issues a clock, in lanes (thread-instructions): 4
# schedulers of one 32-lane warp instruction each (the Hopper
# architecture white paper); and the two integer pipes beside each other,
# 64 lanes each (the CUDA C++ Programming Guide's throughput table,
# compute capability 9.0: 32-bit integer add, logic, shift, compare and
# min/max on the ALU pipe, integer multiply-add on the FMA pipe).
SM_LANES_PER_CLOCK = 128
ALU_LANES = 64
FMA_LANES = 64
H100_SMS = 132
HBM_BYTES_PER_S = 3.35e12
# SASS opcodes that only the integer ALU pipe runs; IMAD in all its forms
# runs on the FMA pipe. Any other instruction (loads, stores, branches,
# VIADD, which either pipe may take) counts only at the issue rate, which
# leaves the bound at its lowest.
_ALU_OPS = frozenset(("LOP3", "SHF", "IADD3", "ISETP", "IMNMX", "VIMNMX",
                      "SEL", "LEA"))


def _is_product(ins: str, const: str) -> bool:
    return "IMAD.WIDE.U32" in ins and const in ins


def pipe(ins: str) -> str:
    """"alu", "fma" or "other": the pipe a SASS instruction needs."""
    op = ins.split()[1 if ins.startswith("@") else 0].split(".")[0]
    return "alu" if op in _ALU_OPS else "fma" if op == "IMAD" else "other"


def hash_loop(lines: List[str]) -> dict:
    """The innermost backward-branch loop that hashes (splitmix64's
    64-bit products, IMAD.WIDE.U32 by its constants): its instruction
    count, the starts an iteration hashes, and the instructions a k-mer
    start issues on the common path, a valid start that is not selected,
    in all and on each integer pipe (`pipe`). That path is walked from
    the loop's head to its back branch, taking the first conditional
    branch after each start's second product (the threshold compare,
    which skips the selected block) and falling through every other
    branch."""
    instrs = _instructions(lines)
    best = None
    for addr, _, taddr in instrs:
        if taddr is None or taddr >= addr:
            continue
        body = [x for x in instrs if taddr <= x[0] <= addr]
        if (any(_is_product(x[1], _FIRST_PRODUCT) for x in body)
                and (best is None or len(body) < len(best))):
            best = body
    if best is None:
        return {}
    starts = sum(_is_product(x[1], _FIRST_PRODUCT) for x in best)
    walked = {"alu": 0, "fma": 0, "other": 0}
    pos, armed = 0, False
    while pos < len(best):
        addr, ins, tgt = best[pos]
        walked[pipe(ins)] += 1
        armed = armed or _is_product(ins, _SECOND_PRODUCT)
        if armed and tgt is not None and ins.startswith("@") and tgt > addr:
            armed = False
            pos = next(j for j, x in enumerate(best) if x[0] >= tgt)
            continue
        pos += 1
    return {"instructions": len(best), "starts": starts,
            "per_start": round(sum(walked.values()) / starts, 2),
            "alu_per_start": round(walked["alu"] / starts, 2),
            "fma_per_start": round(walked["fma"] / starts, 2),
            "range": [hex(best[0][0]), hex(best[-1][0])]}


def clocks_per_start(loop: dict) -> float:
    """The SM clocks a k-mer start of `loop` (hash_loop's counts) takes
    at the least: its instructions at the issue rate, or those of one
    pipe at that pipe's rate, whichever takes longer."""
    return max(loop["per_start"] / SM_LANES_PER_CLOCK,
               loop["alu_per_start"] / ALU_LANES,
               loop["fma_per_start"] / FMA_LANES)


def k5_bound(hb, params, n_buckets: int, loop: dict, clock_hz: float):
    """(ms, "bytes" or "operations"): the least time an H100 could take
    for K5 on the planned batch `hb`. Bytes: each input read once (the
    sequence, unit offsets, tile and fragment arrays), both bitmaps, the
    per-fragment counts and the `n_buckets` distinct buckets written once,
    at HBM_BYTES_PER_S. Operations: `loop`'s instructions a start over
    every start (clocks_per_start), on H100_SMS SMs at `clock_hz`."""
    read = (hb.seq.nbytes + hb.unit_off.nbytes + hb.tile_unit.nbytes
            + hb.tile_start.nbytes + hb.tile_end.nbytes + hb.tile_frag.nbytes
            + hb.frag_start.nbytes + hb.frag_end.nbytes + hb.frag_slot.nbytes)
    written = (len(hb.names) * (params.member_bits + params.prefilter_bits)
               // 8 + 4 * len(hb.frag_start) + 4 * n_buckets)
    t_bytes = (read + written) / HBM_BYTES_PER_S
    t_ops = hb.starts * clocks_per_start(loop) / (H100_SMS * clock_hz)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k5_loops(lib_path: str) -> Dict[bool, dict]:
    """hash_loop of each of K5's two instances in the library's SASS:
    {True: narrow member widths (a bitmap in shared memory), False: wide
    ones}; raises if either is not found."""
    funcs = sass_functions(lib_path)
    out = {}
    for narrow, tag in ((True, "ILb1E"), (False, "ILb0E")):
        loops = [hash_loop(lines) for name, lines in funcs.items()
                 if "sketch_tile_kernel" in name and tag in name]
        if len(loops) != 1 or not loops[0]:
            raise RuntimeError(f"K5's hash loop ({tag}) not found in the "
                               f"SASS of {lib_path}")
        out[narrow] = loops[0]
    return out


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    return float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6


def sass_report(out_dir: str) -> dict:
    from galah_tpu_torch.ops import _build

    lib = str(_build.build_library().path)
    report = {}
    for name, lines in sass_functions(lib).items():
        if "sketch" not in name:
            continue
        short = re.sub(r"\W+", "_", name)[-60:]
        with open(os.path.join(out_dir, f"sass_{short}.txt"), "w") as f:
            f.write("\n".join(lines))
        report[name] = {"instructions": sum(bool(_INSTR.search(x))
                                            for x in lines),
                        "hash_loop": hash_loop(lines)}
    return report


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/k5_profile")
    ap.add_argument("--shapes", default="main,contigs")
    ap.add_argument("--cuts", action="store_true",
                    help="also time K5 built to stop after each of CUTS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_profile: no CUDA device", file=sys.stderr)
        return 1
    from galah_tpu_torch.ops import _build
    from galah_tpu_torch.ops import device_sketch as ds
    from galah_tpu_torch.utils import metrics

    os.makedirs(args.out, exist_ok=True)
    device = torch.device("cuda", 0)
    print(f"k5_profile: galah_tpu_torch from {os.path.dirname(ds.__file__)}",
          flush=True)
    result = {"sass": sass_report(args.out), "shapes": {}}
    print(json.dumps({"sass": result["sass"]}), flush=True)
    clock_hz = sm_clock_hz()
    # An older tree's K5 (that tree first on PYTHONPATH) has no
    # k5_launch_shape, and gets no bound here.
    loops = (k5_loops(str(_build.build_library().path))
             if hasattr(ds, "k5_launch_shape") else None)
    for name in args.shapes.split(","):
        t0 = time.perf_counter()
        hb, params = make_batch(name, args.seed)
        made_s = time.perf_counter() - t0
        batch = ds.upload_batch(hb, params, device)
        bound, narrow = (None, None), None
        if loops:
            n_buckets = int(ds.sketch_batch(batch)[3].numel())
            narrow = ds.k5_launch_shape(batch)[3]
            bound = k5_bound(hb, params, n_buckets, loops[narrow], clock_hz)
        product_ms = time_ms(lambda: ds.sketch_batch(batch), args.reps)
        cuts = cut_times(batch, 4 * args.reps) if args.cuts else None
        del batch
        m = metrics.reset()
        host_ms = time_ms(lambda: ds.sketch_host_batch(hb, params, device),
                          args.reps)
        split = {k: round(v / (args.reps + 1) * 1e3, 4)
                 for k, v in m.counters.items() if k.endswith("_s")}
        prof = profile(hb, params, device, args.reps, args.out, name)
        row = {"units": len(hb.names), "starts": hb.starts,
               "batch_made_s": round(made_s, 2),
               "bound_ms": bound[0], "bound_by": bound[1],
               "narrow_instance": narrow,
               "product_ms": round(product_ms, 4), "kernel_ms_cuts": cuts,
               "sketch_host_batch_ms": round(host_ms, 4),
               "split_ms": split, "profile": prof}
        result["shapes"][name] = row
        print(f"{name}: " + json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    result["clocks_max_sm_mhz"] = clock_hz / 1e6
    print(nvidia_smi("name,power.limit"))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
