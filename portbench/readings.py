#!/usr/bin/env python3
"""The readings that the output check's limits are set from, at a
cell's own size, many seeds in one process (the benchmark's runs never
run this):

    python3 portbench/readings.py --workload <cell> --seeds 11,12,13 \\
        [--control]

For each seed it writes the corpus, runs one whole job (after one
warm-up job on the first seed's corpus) and checks it against the
reference: the program's readings. With ``--control`` it also checks
the control on the same corpus: the reference put in the job's place
and computed in bfloat16, the precision below the float32 in which the
program computes ANI. One JSON line a seed and side on standard output.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench.cell import load_cell  # noqa: E402


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    cell = load_cell(args.workload)

    from portbench import run

    run.prepare_process(cell.threads)
    import torch

    torch.set_num_threads(cell.threads)
    if device is None:
        why = run.require_devices(cell.chips)
        if why:
            print(why, file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    else:
        os.environ["GALAH_TPU_PLATFORM"] = device.type

    from portbench import cell as cellmod
    from portbench.check import Limits, check_job, read_job_output
    from portbench.corpus import make_corpus

    limits = Limits(**cell.config["check"]["limits"])
    warmed = False
    for seed in [int(s) for s in args.seeds.split(",")]:
        root = os.path.join(tempfile.gettempdir(),
                            f"portbench-readings-{cell.name}-{seed}")
        shutil.rmtree(root, ignore_errors=True)
        corpus = make_corpus(cell.traffic, seed)
        try:
            if not warmed:
                warm = os.path.join(root, "warm")
                cellmod.run_job(cellmod.job_argv(cell, corpus, warm),
                                warm)
                warmed = True
            out = os.path.join(root, "job")
            job = cellmod.run_job(cellmod.job_argv(cell, corpus, out), out)
            t0 = time.perf_counter()
            res = check_job(corpus, cell.traffic, cell.config, seed,
                            read_job_output(
                                corpus, os.path.join(out, "clusters.tsv"),
                                os.path.join(out, "distances.npz")),
                            0, device, limits)
            print(json.dumps({
                "side": "program", "seed": seed, "rc": job.rc,
                "wall_s": job.wall_s, "numbers": res.numbers,
                "info": res.info, "correct": res.correct,
                "check_s": time.perf_counter() - t0,
                "work": json.loads(cellmod.work_line(
                    job, run.cluster_count(os.path.join(
                        out, "clusters.tsv"))))}),
                flush=True)
            if args.control:
                res = check_job(corpus, cell.traffic, cell.config, seed,
                                None, 0, device, limits, program="control",
                                dtype=torch.bfloat16)
                print(json.dumps({"side": "control", "seed": seed,
                                  "numbers": res.numbers, "info": res.info,
                                  "correct": res.correct}), flush=True)
        finally:
            corpus.close()
            shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
