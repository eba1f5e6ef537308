"""Where the pair-table verify's time goes, batch by batch, on a card;
and the verify kernels K7 and K8 alone at the main path's shapes.

    python -m galah_tpu_torch.tools.verify_profile [--corpus main|contigs]
        [--seed S] [--out DIR]
    python -m galah_tpu_torch.tools.verify_profile --kernels [--seed S]

Synthetic sketches from --seed, at the shapes of chip_smoke.py's two
corpora (both by default): "main" is 128 families of 8 genomes of 1 Mb,
each a stream of 125,000 hashes in 333 fragments (fragment scale 8,
3 kb fragments) over 2^22 member bits; "contigs" is BASELINE config
#3's 20,000 families of 5 contigs of 5 kb, each 2,500 hashes in 5
fragments (--small-contigs: scale 2, 1 kb fragments) over 2^16 bits.
A member keeps 74% of its family's buckets (98% ANI at k = 15) and
draws the rest at random. The pairs are every directed pair within a
family (7,168 and 400,000), the pairs the screen passes there.

On the card, through the engine's pair table
(ops/pair_table.py::PairTableVerifier.run, with every stream and bitmap
resident after a warm-up run, as the pipelined CLI leaves them):

- a timed run: its wall, synchronised, and the host time a batch in
  planning (_plan_batches), in dispatch (_dispatch without the kernel
  call: streams, pool rows, descriptors and their uploads), in issue
  (the _pair_table_kernel call: the hand-written kernel's launch, or the
  plain version's launches) and in collecting the results;
- torch.profiler over a second run: device µs a batch (the union of the
  kernels' and copies' intervals) and by kernel, kernel launches a batch
  (cudaLaunchKernel calls), and the device's busy share of the run's
  wall, as a JSON line, and key_averages tables under --out
  (verify_profile_<corpus>.txt).

With --kernels, instead: K7 on the largest batch of each corpus's run
(recorded from the engine's pair table), and on the largest batch at
each of NARROW_PRESETS' widths, 2^18 and 2^20 bits, where the launch plan
reads the row through L1: there also through the kernel that stages it
(a cluster of 2 blocks, each holding half the row, the narrowest plan
that runs that kernel); and K8 on one large genome's
stream (GROUPED_SHAPE: 3,333 fragments of 375 sorted buckets, the shape
of chip_smoke.py phase 16's 10 Mb genomes) against R = 8, 32, 64 and 128
rows of 2^22 bits, half of them holding the stream. Each is checked
against its plain version first (K7 bit for bit; K8's AF equal, its ANI
within 1e-4 percentage points), then timed with CUDA events over a CUDA
graph of calls; tests/s is the bit tests of the call (flat hashes, or R
x N) over its time.

It drives only what the package names in both its current and earlier
layouts, so the same file times an earlier tree of the port too (there
without the staged timings at 2^18 and 2^20). The last lines are the card's name and power limit as
nvidia-smi prints them and one JSON object. Needs a CUDA device: there
is nothing to time on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# corpus: (families, members, hashes a stream, fragments, member bits)
PRESETS = {
    "main": (128, 8, 125_000, 333, 1 << 22),
    "contigs": (20_000, 5, 2_500, 5, 1 << 16),
}
# Share of a family's buckets each member keeps: 0.98^15, the k-mers
# that survive 2% divergence at k = 15.
KEEP = 0.74
# Genomes whose rows engines/native.py::_shrink_bits makes 2^18 bits
# (8 kb viruses: 1,000 hashes in 3 fragments) and 2^20 bits (30 kb
# phages: 3,750 hashes in 10 fragments), for K7 alone.
NARROW_PRESETS = {
    "2^18": (128, 8, 1_000, 3, 1 << 18),
    "2^20": (128, 8, 3_750, 10, 1 << 20),
}
# K8's stream: (fragments, buckets a fragment, member bits), and its widths.
GROUPED_SHAPE = (3_333, 375, 1 << 22)
GROUPED_REFS = (8, 32, 64, 128)


def synthetic_sketches(families: int, members: int, hashes: int,
                       fragments: int, bits: int, seed: int):
    """({key: NativeSketch}, [directed pairs within each family]). Each
    member's stream is its family's base stream with 1 - KEEP of its
    positions redrawn, cut into `fragments` fragments of near-equal
    size and sorted within each; its member buckets are the stream's
    distinct buckets."""
    from galah_tpu_torch.sketch.fracminhash import (
        NativeSketch,
        NativeSketchParams,
    )

    params = NativeSketchParams(member_bits=bits)
    rng = np.random.default_rng(seed)
    offsets = np.linspace(0, hashes, fragments + 1).round().astype(np.int64)
    sketches, pairs = {}, []
    for f in range(families):
        base = rng.integers(0, bits, hashes, dtype=np.int32)
        redraw = rng.random((members, hashes)) >= KEEP
        streams = np.where(redraw, rng.integers(0, bits, (members, hashes),
                                                dtype=np.int32), base)
        keys = [f"f{f}_m{m}" for m in range(members)]
        for key, s in zip(keys, streams):
            for lo, hi in zip(offsets[:-1], offsets[1:]):
                s[lo:hi].sort()
            sketches[key] = NativeSketch(
                name=key, total_len=0,
                prefilter_buckets=np.zeros(0, np.int32),
                frag_buckets=s, frag_offsets=offsets,
                member_buckets=np.unique(s), params=params)
        pairs += [(a, b) for a in keys for b in keys if a != b]
    return sketches, pairs


def _engine(sketches, device: torch.device):
    from galah_tpu_torch.ops import fragment_ani as fa

    params = next(iter(sketches.values())).params
    return fa.FragmentAniEngine(
        fa.FragmentAniConfig(k=params.k, member_bits=params.member_bits,
                             min_fragment_hashes=params.min_fragment_hashes),
        device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_run(engine, pairs: Sequence[Tuple], sketches,
              device: torch.device) -> Tuple[dict, Dict]:
    """One PairTableVerifier.run over `pairs`, synchronised, with the
    host time in its planning, dispatch, issue and collection. Returns
    (numbers, results)."""
    from galah_tpu_torch.ops import pair_table as pt

    acc = {"plan": 0.0, "dispatch": 0.0, "issue": 0.0, "batches": 0}
    plan, dispatch, kernel = (pt.PairTableVerifier._plan_batches,
                              pt.PairTableVerifier._dispatch,
                              pt._pair_table_kernel)

    def timed(key, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[key] += time.perf_counter() - t0
        return run

    def planned(self, *a, **k):
        batches = timed("plan", plan)(self, *a, **k)
        acc["batches"] += len(batches)
        return batches

    pt.PairTableVerifier._plan_batches = planned
    pt.PairTableVerifier._dispatch = timed("dispatch", dispatch)
    pt._pair_table_kernel = timed("issue", kernel)
    try:
        _sync(device)
        t0 = time.perf_counter()
        res = engine.pair_table.run(pairs, sketches)
        _sync(device)
        wall = time.perf_counter() - t0
    finally:
        pt.PairTableVerifier._plan_batches = plan
        pt.PairTableVerifier._dispatch = dispatch
        pt._pair_table_kernel = kernel
    n = max(1, acc["batches"])
    us = 1e6 / n
    return {
        "batches": acc["batches"], "pairs": len(pairs), "wall_s": wall,
        "plan_us_a_batch": acc["plan"] * us,
        "dispatch_us_a_batch": (acc["dispatch"] - acc["issue"]) * us,
        "issue_us_a_batch": acc["issue"] * us,
        "collect_us_a_batch": (wall - acc["plan"] - acc["dispatch"]) * us,
        "host_us_a_batch": wall * us,
    }, res


def profiled_run(engine, pairs, sketches, batches: int, out: str) -> dict:
    """torch.profiler over one PairTableVerifier.run on the card; its
    key_averages tables go to the file `out`."""
    from torch.profiler import ProfilerActivity, profile

    from galah_tpu_torch.tools.screen_profile import _busy_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.pair_table.run(pairs, sketches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    with open(out, "w") as f:
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=40))
        f.write("\n")
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=40))
    busy_us, device = _busy_us(prof)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel"))
    top = {k[:80]: v / batches
           for k, v in sorted(device.items(), key=lambda kv: -kv[1])[:12]}
    return {"wall_s": wall, "device_busy_share": busy_us / (wall * 1e6),
            "device_us_a_batch": busy_us / batches,
            "device_us_a_batch_by_kernel": top,
            "kernel_launches_a_batch": launches / batches}


def profile_corpus(corpus: str, shape: Sequence[int], seed: int,
                   device: torch.device, out: str) -> dict:
    """The synthetic corpus's verify: a warm-up run (builds the kernels,
    fills the pool and the arena), a timed run and a profiled run."""
    t0 = time.perf_counter()
    sketches, pairs = synthetic_sketches(*shape, seed=seed)
    made = time.perf_counter() - t0
    engine = _engine(sketches, device)
    engine.pair_table.run(pairs, sketches)       # warm-up
    timed, res = timed_run(engine, pairs, sketches, device)
    af = np.array([v[1] for v in res.values()], np.float32)
    result = {"corpus": corpus, "families": shape[0], "members": shape[1],
              "hashes": shape[2], "fragments": shape[3],
              "member_bits": shape[4], "made_s": made,
              "mean_af": float(af.mean()), "timed": timed}
    print(f"{corpus} timed: " + json.dumps(timed), flush=True)
    result["profiled"] = profiled_run(
        engine, pairs, sketches, timed["batches"],
        os.path.join(out, f"verify_profile_{corpus}.txt"))
    print(f"{corpus} profiled: " + json.dumps(result["profiled"]),
          flush=True)
    return result


def largest_batch(engine, pairs, sketches):
    """(args, kwargs) of _pair_table_kernel's call with the most flat
    hashes in one PairTableVerifier.run (its shard dropped)."""
    from galah_tpu_torch.ops import pair_table as pt

    calls = []
    real = pt._pair_table_kernel

    def record(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    pt._pair_table_kernel = record
    try:
        engine.pair_table.run(pairs, sketches)
    finally:
        pt._pair_table_kernel = real
    args, kw = max(calls, key=lambda c: c[1]["n_flat"])
    return args, {k: v for k, v in kw.items() if k != "shard"}


def time_k7(args, kw, device: torch.device, plan=None) -> dict:
    """K7 on one batch: bit for bit against the plain version, then ms
    over a CUDA graph of 20 calls; with `plan`, a VerifyPlan, launched
    by that plan instead of verify_launch_plan's."""
    from galah_tpu_torch.ops import pair_table as pt

    if plan is None:
        return _time_k7(args, kw, device)
    planned = pt.verify_launch_plan
    pt.verify_launch_plan = lambda bits: plan
    try:
        return dict(_time_k7(args, kw, device), plan=list(plan))
    finally:
        pt.verify_launch_plan = planned


def _time_k7(args, kw, device: torch.device) -> dict:
    from galah_tpu_torch.ops import pair_table as pt
    from galah_tpu_torch.tools.gather_probe import time_ms

    got = pt._pair_table_kernel(*args, **kw)
    want = pt._pair_table_plain(*args, **kw)
    if not all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(got, want)):
        raise RuntimeError("K7 differs from its plain version")
    ms = time_ms(lambda: pt._pair_table_kernel(*args, **kw), device, 20)
    return {"pairs": int(args[4].shape[0]), "flat_hashes": kw["n_flat"],
            "flat_fragments": kw["n_flat_frags"], "bits": kw["bits"],
            "ms": ms, "tests_per_s": kw["n_flat"] / (ms * 1e-3)}


def grouped_inputs(refs: int, seed: int, device: torch.device):
    """(bitmaps, rows, popcounts, buckets, offsets) for K8 at
    GROUPED_SHAPE: random rows of density 1/4, the first half of them
    with every bucket of the stream set."""
    frags, per, bits = GROUPED_SHAPE
    rng = np.random.default_rng(seed)
    buckets = np.sort(rng.integers(0, bits, (frags, per), dtype=np.int32),
                      axis=1).reshape(-1)
    b = torch.from_numpy(buckets).to(device)
    o = torch.arange(0, frags * per + 1, per, dtype=torch.int32,
                     device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def words(n):
        return torch.randint(-(1 << 31), 1 << 31, (n, bits // 32),
                             generator=gen, dtype=torch.int64,
                             device=device).to(torch.int32)

    stack = words(refs) & words(refs)
    ub = torch.unique(b).long()
    held = torch.zeros(bits // 32, dtype=torch.int64, device=device)
    held.index_add_(0, ub >> 5, torch.ones_like(ub) << (ub & 31))
    stack[:refs // 2] |= held.to(torch.int32)
    popcounts = torch.full((refs,), bits / 4, dtype=torch.float32,
                           device=device)
    rows = torch.arange(refs, device=device)
    return stack, rows, popcounts, b, o


def time_k8(refs: int, seed: int, device: torch.device) -> dict:
    """K8 at R = refs: its AF equal to the plain version's and its ANI
    within 1e-4 percentage points, then ms over a CUDA graph of 10
    calls."""
    from galah_tpu_torch.ops import fragment_ani as fa
    from galah_tpu_torch.tools.gather_probe import time_ms

    args = grouped_inputs(refs, seed, device)
    bits = GROUPED_SHAPE[2]
    kw = dict(bits=bits, k=15, min_hashes=8,
              min_ident=fa.FragmentAniConfig().min_fragment_identity)
    got = fa._forward_kernel(*args, **kw)
    want = fa._forward_plain(*args, **kw)
    dani = float((got[0] - want[0]).abs().max())
    if not torch.equal(got[1], want[1]) or dani > 1e-4:
        raise RuntimeError(f"K8 at R={refs} differs from its plain version")
    ms = time_ms(lambda: fa._forward_kernel(*args, **kw), device, 10)
    n = args[3].numel()
    return {"refs": refs, "stream_hashes": n,
            "fragments": args[4].numel() - 1, "bits": bits, "ms": ms,
            "max_abs_ani_err": dani, "tests_per_s": refs * n / (ms * 1e-3)}


def kernel_times(seed: int, device: torch.device) -> dict:
    """K7 on each corpus's largest batch and at NARROW_PRESETS' widths,
    and K8 at GROUPED_REFS."""
    from galah_tpu_torch.ops import pair_table as pt

    out = {}
    presets = {**{c: PRESETS[c] for c in ("main", "contigs")},
               **NARROW_PRESETS}
    for corpus, shape in presets.items():
        sketches, pairs = synthetic_sketches(*shape, seed=seed)
        engine = _engine(sketches, device)
        args, kw = largest_batch(engine, pairs, sketches)
        runs = {f"K7 {corpus}": None}
        if corpus in NARROW_PRESETS and hasattr(pt, "verify_launch_plan"):
            bits = shape[4]
            runs[f"K7 {corpus} staged"] = pt.VerifyPlan(2, bits // 2,
                                                        bits // 16)
        for name, plan in runs.items():
            out[name] = time_k7(args, kw, device, plan)
            print(f"{name}: " + json.dumps(out[name]), flush=True)
        del engine, args, sketches
        torch.cuda.empty_cache()
    for r in GROUPED_REFS:
        out[f"K8 R={r}"] = time_k8(r, seed, device)
        print(f"K8 R={r}: " + json.dumps(out[f"K8 R={r}"]), flush=True)
        torch.cuda.empty_cache()
    return out


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", choices=sorted(PRESETS), action="append")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/verify_profile")
    ap.add_argument("--kernels", action="store_true",
                    help="time K7 and K8 alone instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("verify_profile: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    if args.kernels:
        results = {"kernels": kernel_times(args.seed, device)}
    else:
        os.makedirs(args.out, exist_ok=True)
        results = []
        for corpus in args.corpus or sorted(PRESETS):
            results.append(profile_corpus(corpus, PRESETS[corpus],
                                          args.seed, device, args.out))
            torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
