"""Where the pair-table verify's time goes, batch by batch, on a card.

    python -m galah_tpu_torch.tools.verify_profile [--corpus main|contigs]
        [--seed S] [--out DIR]

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

It drives only what the package names in both its current and earlier
layouts, so the same file times an earlier tree of the port too. The
last lines are the card's name and power limit as nvidia-smi prints
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


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", choices=sorted(PRESETS), action="append")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/verify_profile")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("verify_profile: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    device = torch.device("cuda", 0)
    results = []
    for corpus in args.corpus or sorted(PRESETS):
        results.append(profile_corpus(corpus, PRESETS[corpus], args.seed,
                                      device, args.out))
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
