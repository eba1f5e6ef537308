#!/usr/bin/env python3
"""Benchmark of galah_tpu_torch on one card: whole `cluster` jobs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A run writes the cell's corpus for the seed into memory files
(corpus.py; its time is logged on a line of its own), then warms up
with one whole job on that corpus, which builds or loads every kernel
the cell uses. ``setup_s`` is the time from the process's start to the
end of the warm-up job, the corpus writing included.

With ``--trace 0`` it then runs whole jobs back to back, each into a
fresh output directory, while the window of ``--seconds`` is open; a job
that starts in the window runs to its end. ``job_s`` is the sum of the
jobs' walls over their count; ``host_peak_gib`` the most host memory the
process held resident while they ran, sampled every 5 ms. Between jobs
it synchronises the card and collects garbage, outside the walls. A
cell reports the end-to-end metrics that BENCHMARK.json lists for it;
every value is logged on standard error.

With ``--trace 1`` it runs one job under torch.profiler and a sampler of
the host's stack, and reports the per-layer metrics and the breakdown.

Job outputs go to TMPDIR. Either way it then checks the outputs of a job against the plain
reference (check.py) and prints one JSON line last on standard output.
It exits non-zero, with no result, without a CUDA device, or if JAX or
the JAX package was loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench.cell import load_cell  # noqa: E402
from portbench.hostmem import GIB, PeakSampler, lifetime_peak_bytes  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "galah_tpu")
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
               "NUMEXPR_NUM_THREADS", "VECLIB_MAXIMUM_THREADS")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def prepare_process(threads: int) -> None:
    """Pin the numeric libraries' thread pools to the job's --threads and
    drop the program's switches, so each run takes the default path."""
    for var in THREAD_VARS:
        os.environ[var] = str(threads)
    for var in [v for v in os.environ if v.startswith("GALAH_TPU_")]:
        del os.environ[var]


def require_devices(n: int):
    """None if `n` CUDA devices are there, else why not."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device"
    if torch.cuda.device_count() < n:
        return f"{torch.cuda.device_count()} CUDA devices, the cell needs {n}"
    return None


def forbidden_modules():
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def cluster_count(path: str) -> int:
    with open(path) as fh:
        return len({line.split("\t", 1)[0] for line in fh if line.strip()})


def main(argv=None, device=None) -> int:
    """The run. `device` is for tests on the CPU: given, the look for a
    card is skipped and the program runs there too."""
    args = parse_args(argv)
    cell = load_cell(args.workload)
    threads = cell.threads
    prepare_process(threads)

    import numpy as np
    import torch

    torch.set_num_threads(threads)
    if device is None:
        why = require_devices(cell.chips)
        if why:
            log(f"{why}: no result")
            return 3
        device = torch.device("cuda", 0)
    else:
        os.environ["GALAH_TPU_PLATFORM"] = device.type
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    from portbench import cell as cellmod
    from portbench.check import Limits, check_job, read_job_output
    from portbench.corpus import make_corpus

    root = os.path.join(tempfile.gettempdir(),
                        f"portbench-{cell.name}-{args.seed}")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    corpus = make_corpus(cell.traffic, args.seed)
    corpus_s = time.perf_counter() - t0
    try:
        log(f"corpus {corpus.kind} {json.dumps(corpus.shape())} written in "
            f"{corpus_s:.3f} s")

        warm = cellmod.run_job(
            cellmod.job_argv(cell, corpus, os.path.join(root, "warmup")),
            os.path.join(root, "warmup"))
        if warm.rc:
            log(f"warm-up job failed with {warm.rc}")
            return 1
        sync()
        gc.collect()
        setup_s = time.perf_counter() - T_START
        log(f"setup_s {setup_s!r} (warm-up job {warm.wall_s:.4f} s)")

        jobs = []
        trace = None
        sampler = None
        if args.trace:
            from portbench.trace import traced

            out = os.path.join(root, "traced")
            argv_job = cellmod.job_argv(cell, corpus, out)
            holder = []
            trace = traced(lambda: holder.append(cellmod.run_job(argv_job,
                                                                 out)),
                           on_card)
            jobs = holder
            log(f"trace: {trace.events} device events, {trace.samples} "
                f"host samples, reduced in {trace.extra['reduce_s']:.3f} s, "
                f"clock shift {trace.extra['clock_shift_ms']:.3f} ms")
        else:
            if "host_peak_gib" in {m["name"] for m in cell.end_to_end()}:
                sampler = PeakSampler().start()
            t_open = time.perf_counter()
            while not jobs or time.perf_counter() - t_open < args.seconds:
                out = os.path.join(root, f"job{len(jobs)}")
                jobs.append(cellmod.run_job(
                    cellmod.job_argv(cell, corpus, out), out))
                sync()
                gc.collect()
            if sampler is not None:
                sampler.stop()
        for i, job in enumerate(jobs):
            tsv = os.path.join(job.out_dir, "clusters.tsv")
            n_cl = cluster_count(tsv) if job.rc == 0 else -1
            log(f"job {i} wall {job.wall_s!r} s rc {job.rc} phases "
                f"{json.dumps(job.phases, sort_keys=True)}")
            log(f"job {i} work {cellmod.work_line(job, n_cl)}")
        failed = sum(1 for j in jobs if j.rc != 0)
        memory_peak = (int(torch.cuda.max_memory_allocated(device))
                       if on_card else 0)
        device_info = {"platform": "gpu" if on_card else "cpu",
                       "kind": (torch.cuda.get_device_name(0) if on_card
                                else "cpu"),
                       "count": cell.chips,
                       "memory_peak_bytes": memory_peak}

        if args.trace:
            metrics, breakdown = _layer_metrics(cell, corpus, jobs[0], trace)
            device_info["busy_s"] = trace.busy_s
            device_info["window_s"] = trace.window_s
        else:
            values = {"job_s": sum(j.wall_s for j in jobs) / len(jobs),
                      "setup_s": setup_s}
            if sampler is not None:
                values["host_peak_gib"] = sampler.peak / GIB
                log(f"host resident peak {sampler.peak} bytes over "
                    f"{sampler.samples} samples; lifetime high-water "
                    f"{lifetime_peak_bytes()} bytes")
            log(f"end to end {json.dumps(values, sort_keys=True)}")
            metrics = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in cell.end_to_end()}
            breakdown = None

        # The reference runs after the peak is read and the program's
        # state is freed.
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        ok_jobs = [j for j in jobs if j.rc == 0]
        if ok_jobs:
            pick = ok_jobs[int(np.random.default_rng(
                [args.seed % (1 << 64), 0x70B]).integers(len(ok_jobs)))]
            first = _read(os.path.join(pick.out_dir, "clusters.tsv"))
            differ = sum(1 for j in ok_jobs if _read(os.path.join(
                j.out_dir, "clusters.tsv")) != first)
            out = read_job_output(corpus,
                                  os.path.join(pick.out_dir, "clusters.tsv"),
                                  os.path.join(pick.out_dir, "distances.npz"))
            result = check_job(corpus, cell.traffic, cell.config, args.seed,
                               out, differ, device,
                               Limits(**cell.config["check"]["limits"]))
            log(f"check info {json.dumps(result.info, sort_keys=True)}")
            correct = result.correct and failed == 0
            check_lines, check_json = result.lines(), result.as_json()
        else:
            correct, check_lines, check_json = False, ["check no job"], {}
    finally:
        corpus.close()
        shutil.rmtree(root, ignore_errors=True)

    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {', '.join(bad)}: no result")
        return 4
    for line in check_lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    result = {"correct": bool(correct), "attempted": len(jobs),
              "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = check_json
    print(json.dumps(result), flush=True)
    return 0


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _layer_metrics(cell, corpus, job, trace):
    """The cell's per-layer metrics from the traced job, and the
    breakdown; device time that no reader's kernel list names is logged
    as unattributed."""
    from portbench import cell as cellmod
    from portbench.reference import file_bytes, member_bits_for

    files = ([u.name for u in corpus.units] if corpus.kind == "genomes"
             else [corpus.paths["fasta"]])
    max_bytes = file_bytes(files)
    sketch = cell.config["sketch"]
    ctx = cellmod.LayerContext(job.phases, job.counters, trace, corpus,
                               sketch, max_bytes,
                               member_bits_for(sketch, max_bytes),
                               job.wall_s)
    metrics = {}
    for m in cell.per_layer():
        value = cellmod.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    named = cellmod.all_kernel_names(cell.manifest["per_layer"])
    unattributed = {n: s for n, s in trace.device_s.items()
                    if not any(k in n for k in named)}
    log(f"device s unattributed {sum(unattributed.values())!r} of "
        f"{sum(trace.device_s.values())!r}")
    ops = sorted(trace.device_s.items(), key=lambda t: -t[1])[:10]
    breakdown = {"device_ops": [[n, s] for n, s in ops],
                 "idle_gaps": [[n, s] for n, s in trace.idle_gaps[:10]]}
    return metrics, breakdown


if __name__ == "__main__":
    sys.exit(main())
