"""The port's `cluster` CLI from two trees in turn, on one corpus.

    python -m galah_tpu_torch.tools.cli_ab OLD_TREE NEW_TREE
        [--corpus contigs|main] [--order ABBA] [--out DIR] [--platform gpu]
        [--low-memory]

A tree is a checkout of the repo (its root holds galah_tpu_torch/). A run
is `python -m galah_tpu_torch cluster` in a fresh process started in that
tree, so it loads that tree's kernels, which a process of their own
builds (under the tree's build/) before the first run, on a card. Both
trees take the same corpus, made once before the first run: `contigs` is
chip_smoke.py's contig corpus (--cluster-contigs --small-contigs over
20,000 families of 5 contigs of 5 kb at 98% ANI, seed 13), `main` its
genome corpus (128 families of 8 genomes of 1 Mb at 98% ANI, seed 11);
--families, --members and --length shrink them. --order names the runs,
A for the first tree and B for the second: ABBA runs each tree at both
ends of the call, so a drift of the machine over the call shows as the
difference between one tree's two runs. --low-memory passes the CLI's
flag of that name to every run.

Prints a JSON line a run (the process's wall and peak resident set, from
wait4's rusage, and from --metrics-json the CLI's wall, phases, every
sketch_*_s span and the work counters), the
card's name and power limit on a card, and a last JSON line with each
tree's medians; exits 1 unless every run wrote the same clusters.tsv and
counted the same work.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List

# (families, members, unit length, seed) of each corpus, as chip_smoke.py
# makes them.
CORPORA = {"contigs": (20_000, 5, 5_000, 13), "main": (128, 8, 1_000_000, 11)}
WORK = ("genomes_sketched", "contigs_sketched", "sketch_bases",
        "screen_pairs_computed", "verify_directed_pairtable",
        "verify_directed_grouped", "clusters")


def make_corpus(kind: str, out: str, families: int, members: int,
                length: int, seed: int) -> List[str]:
    """Make the corpus under `out`; returns the CLI's input arguments."""
    from galah_tpu_torch.utils.synth import make_contig_corpus, make_families

    if kind == "contigs":
        path = os.path.join(out, "contigs.fna")
        make_contig_corpus(path, families, members, contig_length=length,
                           within_ani=0.98, seed=seed)
        return ["-f", path, "--cluster-contigs", "--small-contigs"]
    directory = os.path.join(out, "genomes")
    make_families(directory, families, members, genome_length=length,
                  within_ani=0.98, seed=seed)
    return ["-d", directory, "-x", "fna"]


def _env(tree: str, platform: str) -> Dict[str, str]:
    return dict(os.environ, GALAH_TPU_PLATFORM=platform,
                PYTHONPATH=os.pathsep.join(
                    p for p in (tree, os.environ.get("PYTHONPATH")) if p))


def build_kernels(tree: str) -> None:
    """Build `tree`'s kernel library in a process of its own."""
    tree = os.path.abspath(tree)
    subprocess.run([sys.executable, "-c", "from galah_tpu_torch.ops._build "
                    "import build_library; build_library()"],
                   env=_env(tree, "gpu"), cwd=tree, check=True)


def _run_measured(cmd: List[str], env: Dict[str, str], cwd: str) -> int:
    """Run `cmd` to its end; returns its peak resident set in bytes (the
    child's own, from wait4). Raises if it fails."""
    proc = subprocess.Popen(cmd, env=env, cwd=cwd)
    _, status, usage = os.wait4(proc.pid, 0)
    proc.returncode = os.waitstatus_to_exitcode(status)
    if proc.returncode:
        raise subprocess.CalledProcessError(proc.returncode, cmd)
    return usage.ru_maxrss * 1024  # KiB on Linux


def run_cli(tree: str, inputs: List[str], out: str, tag: str,
            platform: str, flags: List[str] = ()) -> dict:
    """One `cluster` run of `tree`'s port in a fresh process, with the
    CLI flags `flags`."""
    tsv = os.path.join(out, f"{tag}.tsv")
    mjson = os.path.join(out, f"{tag}.json")
    tree = os.path.abspath(tree)
    cmd = [sys.executable, "-m", "galah_tpu_torch", "cluster", *inputs,
           "--ani", "95", "-t", str(min(8, os.cpu_count() or 1)),
           "--output-cluster-definition", tsv, "--metrics-json", mjson, "-q",
           *flags]
    t0 = time.perf_counter()
    rss = _run_measured(cmd, _env(tree, platform), tree)
    wall = time.perf_counter() - t0
    with open(mjson) as f:
        m = json.load(f)
    c = m["counters"]
    return {"run": tag, "tree": tree, "process_wall_s": wall,
            "peak_rss_bytes": rss,
            "wall_clock_s": m["wall_clock_s"], "phases_s": m["phases_s"],
            "sketch_s": {k[7:-2]: v for k, v in sorted(c.items())
                         if k.startswith("sketch_") and k.endswith("_s")},
            "work": {k: c.get(k) for k in WORK}, "clusters_tsv": tsv}


def medians(runs: List[dict]) -> dict:
    """Each time's median over `runs` (one tree's)."""
    def med(key, sub=None):
        vals = [r[key] if sub is None else r[key].get(sub) for r in runs]
        vals = [v for v in vals if v is not None]
        return statistics.median(vals) if vals else None

    return {"runs": len(runs), "process_wall_s": med("process_wall_s"),
            "peak_rss_bytes": med("peak_rss_bytes"),
            "wall_clock_s": med("wall_clock_s"),
            **{f"{key}.{sub}": med(key, sub)
               for key in ("phases_s", "sketch_s")
               for sub in sorted({s for r in runs for s in r[key]})}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs=2, help="tree A, then tree B")
    ap.add_argument("--corpus", choices=sorted(CORPORA), default="contigs")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--out", default="build/cli_ab")
    ap.add_argument("--platform", default="gpu", help="GALAH_TPU_PLATFORM")
    ap.add_argument("--families", type=int)
    ap.add_argument("--members", type=int)
    ap.add_argument("--length", type=int)
    ap.add_argument("--low-memory", action="store_true",
                    help="run the CLI with --low-memory")
    args = ap.parse_args(argv)
    families, members, length, seed = CORPORA[args.corpus]
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    inputs = make_corpus(args.corpus, out, args.families or families,
                         args.members or members, args.length or length, seed)
    print(f"cli_ab: {args.corpus} corpus made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.platform == "gpu":
        for tree in args.trees:
            build_kernels(tree)
    runs = []
    for i, letter in enumerate(args.order):
        tree = args.trees["AB".index(letter)]
        runs.append(run_cli(tree, inputs, out, f"{i}{letter}", args.platform,
                            ["--low-memory"] if args.low_memory else []))
        print(json.dumps(runs[-1]), flush=True)
    tsvs = set()
    for r in runs:
        with open(r["clusters_tsv"], "rb") as f:
            tsvs.add(f.read())
    same = len(tsvs) == 1 and all(r["work"] == runs[0]["work"] for r in runs)
    if args.platform == "gpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())
    print(json.dumps({
        "ok": same, "corpus": args.corpus, "order": args.order,
        "low_memory": args.low_memory,
        "trees": [os.path.abspath(t) for t in args.trees],
        "medians": {letter: medians([r for r in runs
                                     if r["run"][-1] == letter])
                    for letter in sorted(set(args.order))}}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
