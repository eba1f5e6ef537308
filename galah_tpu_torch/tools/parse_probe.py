"""How long the C++ FASTA parse of device sketching's length pass
(ops/device_sketch.py::_FastaSource) takes on one large multi-contig
FASTA, by the thread it runs on.

    python -m galah_tpu_torch.tools.parse_probe [--families 20000] [--dir D]

Writes chip_smoke.py's contig corpus (utils/synth.py::make_contig_corpus:
families of 5 contigs of 5 kb at 98% ANI, seed 13) into a temporary
directory under D, then times the parse, --reps times each: on the
calling thread, on a fresh pool thread (a new executor for each parse),
and on one reused pool thread; then the Python reader's pass over the
same file (io/fasta.py::read_fasta, what contig mode's names pass
runs). Host only: no device is touched. One line per setting, then one
JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List

from galah_tpu_torch import native_ext
from galah_tpu_torch.io.fasta import read_fasta
from galah_tpu_torch.ops.device_sketch import _FastaSource
from galah_tpu_torch.utils.synth import make_contig_corpus


def _seconds(fn: Callable[[], object]) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def probe(path: str, reps: int) -> dict:
    """{setting: [seconds of each rep]} for one FASTA."""
    out = {"calling_thread": [], "fresh_pool_thread": [],
           "reused_pool_thread": [], "python_reader": []}
    with ThreadPoolExecutor(max_workers=1) as reused:
        for _ in range(reps):
            out["calling_thread"].append(_seconds(lambda: _FastaSource(path)))
            with ThreadPoolExecutor(max_workers=1) as fresh:
                out["fresh_pool_thread"].append(_seconds(
                    lambda: fresh.submit(_FastaSource, path).result()))
            out["reused_pool_thread"].append(_seconds(
                lambda: reused.submit(_FastaSource, path).result()))
            out["python_reader"].append(_seconds(
                lambda: [r.contig_name for r in read_fasta(path)]))
    return out


def main(argv: List[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m galah_tpu_torch.tools.parse_probe",
        description="time the length pass's C++ FASTA parse by thread")
    parser.add_argument("--families", type=int, default=20_000,
                        help="contig families of 5 [default: 20000]")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--dir", default=None,
                        help="where the temporary corpus goes [default: "
                             "the system's temporary directory]")
    args = parser.parse_args(argv)
    if not native_ext.available():
        print("parse_probe: the C++ reader (native/libfastaio.so) did not "
              "load", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(dir=args.dir) as work:
        path = os.path.join(work, "contigs.fna")
        names, _ = make_contig_corpus(path, args.families, 5, 5_000, 0.98, 13)
        nbytes = os.path.getsize(path)
        times = probe(path, args.reps)
    for setting, secs in times.items():
        print(f"{setting}: " + ", ".join(f"{s:.3f}" for s in secs) + " s",
              flush=True)
    print(json.dumps({"contigs": len(names), "file_bytes": nbytes,
                      "host_cpus": os.cpu_count(), "seconds": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
