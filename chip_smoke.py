#!/usr/bin/env python3
"""Smoke test of galah_tpu_torch, the PyTorch/CUDA port, on one GPU.

    python3 chip_smoke.py

Phases, one line each (a failed check raises and the script exits
non-zero):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: compile galah_tpu_torch/csrc/*.cu with nvcc for sm_90a;
3. kernel: the packed-popcount kernel against its plain torch version on
   the card, bit-exact, at the screen's tile shapes, with both times;
4. main path: `galah_tpu_torch cluster` over 1024 synthetic 1 Mb genomes
   (128 families of 8, 98% ANI within a family) must find exactly the
   128 families, through the kernel, with screen and verify on the card;
5. parity: a 64-genome 200 kb corpus through the port on the CPU and on
   the card must give the same candidate pairs, ANI within 1e-3
   percentage points, equal AF and the same clusters.tsv.

The last lines are the kernels' JSON summary, the nvidia-smi line and
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1
and prints no result. The synthetic corpora are written under build/ and
removed at the end.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

MAIN_GENOMES = (128, 8)        # families x members
MAIN_LENGTH = 1_000_000
MAIN_SEED = 11
PARITY_GENOMES = (8, 8)
PARITY_LENGTH = 200_000
PARITY_SEED = 5
ANI_TOL = 1e-3                 # percentage points, GPU vs CPU verify ANI


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip() if out else ""


def phase_device() -> dict:
    import torch

    info = {
        "nvidia_smi": nvidia_smi_line(),
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    log("device", json.dumps(info))
    return info


def phase_build() -> None:
    from galah_tpu_torch.ops import _build

    res = _build.build_library()
    log("build", f"{res.path.relative_to(ROOT)} built in {res.seconds:.2f} s "
                 f"(cached={res.cached})")
    for line in res.log.splitlines():
        if "registers" in line or "Compiling" in line or "spill" in line:
            log("build", "  " + line.strip())
    _build.load_library()


def _random_words(m: int, w: int, density: float, gen, device):
    """(m, w) int32 words with each bit set with probability `density`."""
    import torch

    from galah_tpu_torch.utils.convert import u32_to_i32

    acc = torch.zeros((m, w), dtype=torch.int64, device=device)
    for s in range(32):
        bit = torch.rand((m, w), generator=gen, device=device) < density
        acc |= bit.to(torch.int64) << s
    return u32_to_i32(acc)


def _time_ms(fn, reps: int) -> float:
    import torch

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


def phase_kernel() -> dict:
    """Kernel against plain version, bit-exact; returns the timings at
    the main path's tile shape (W = 4096) and the largest error."""
    import torch

    from galah_tpu_torch.ops.packed_matmul import (
        packed_intersect_counts,
        packed_intersect_counts_reference,
    )

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    cases = []
    for w in (8192, 4096):
        a = _random_words(1024, w, 0.06, gen, dev)
        b = _random_words(1024, w, 0.06, gen, dev)
        a[:4] = _random_words(4, w, 0.9, gen, dev)   # dense rows
        b[10:14] = _random_words(4, w, 0.9, gen, dev)
        a[4:8] = 0                                   # empty rows
        b[20:24] = 0
        a[8] = -1                                    # one all-ones row
        b[30] = -1
        cases.append((f"1024x1024xW{w}", a, b))
    cases.append((
        "1000x777xW1000",
        _random_words(1000, 1000, 0.06, gen, dev),
        _random_words(777, 1000, 0.06, gen, dev),
    ))
    max_err = 0
    times = {}
    for name, a, b in cases:
        got = packed_intersect_counts(a, b)
        want = packed_intersect_counts_reference(a, b)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"kernel != plain at {name} (max err {err})")
        ms = _time_ms(lambda: packed_intersect_counts(a, b), 20)
        plain_ms = _time_ms(lambda: packed_intersect_counts_reference(a, b), 5)
        times[name] = (ms, plain_ms)
        log("kernel", f"{name}: bit-exact; kernel {ms:.4f} ms/tile, "
                      f"plain {plain_ms:.4f} ms/tile")
    ms, plain_ms = times["1024x1024xW4096"]
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": max_err}


@contextlib.contextmanager
def _recording():
    """Record the devices the screen and verify kernels ran on, the
    screen's candidate pairs and the verify results of one run."""
    import galah_tpu_torch.engines.native as native
    import galah_tpu_torch.ops.fragment_ani as fa
    import galah_tpu_torch.ops.pair_table as pt
    import galah_tpu_torch.ops.prefilter as pf

    rec = {"screen_dev": set(), "verify_dev": set(), "pairs": None,
           "verified": {}}
    orig = (pf._screen_tile, pt._pair_table_kernel, fa._forward_kernel,
            native.screen_triangle_packed, fa.FragmentAniEngine.bidirectional)

    def screen_tile(si, *a, **k):
        rec["screen_dev"].add(si.device.type)
        return orig[0](si, *a, **k)

    def pair_table_kernel(ustream, *a, **k):
        rec["verify_dev"].add(ustream.device.type)
        return orig[1](ustream, *a, **k)

    def forward_kernel(bitmaps, *a, **k):
        rec["verify_dev"].add(bitmaps.device.type)
        return orig[2](bitmaps, *a, **k)

    def screen(*a, **k):
        res = orig[3](*a, **k)
        rec["pairs"] = res
        return res

    def bidirectional(self, pairs, sketches_by_key):
        out = orig[4](self, pairs, sketches_by_key)
        rec["verified"].update(out)
        return out

    pf._screen_tile = screen_tile
    pt._pair_table_kernel = pair_table_kernel
    fa._forward_kernel = forward_kernel
    native.screen_triangle_packed = screen
    fa.FragmentAniEngine.bidirectional = bidirectional
    try:
        yield rec
    finally:
        (pf._screen_tile, pt._pair_table_kernel, fa._forward_kernel,
         native.screen_triangle_packed,
         fa.FragmentAniEngine.bidirectional) = orig


def _run_cli(corpus: str, out_dir: str, tag: str, platform: str):
    from galah_tpu_torch.cli.main import main

    tsv = os.path.join(out_dir, f"{tag}.tsv")
    mjson = os.path.join(out_dir, f"{tag}.json")
    argv = ["cluster", "-d", corpus, "-x", "fna", "--ani", "95",
            "-t", str(min(8, os.cpu_count() or 1)),
            "--output-cluster-definition", tsv, "--metrics-json", mjson, "-q"]
    os.environ["GALAH_TPU_PLATFORM"] = platform
    with _recording() as rec:
        t0 = time.perf_counter()
        rc = main(argv)
        wall = time.perf_counter() - t0
    check(rc == 0, f"{tag}: cluster exited {rc}")
    with open(mjson) as f:
        run_metrics = json.load(f)
    with open(tsv, "rb") as f:
        clusters = f.read()
    return wall, run_metrics, clusters, rec


def _families_exact(clusters_tsv: bytes, paths, fam_ids) -> int:
    """Number of clusters, after checking each is exactly one family."""
    fam_of = {p: f for p, f in zip(paths, fam_ids)}
    members = {}
    for line in clusters_tsv.decode().splitlines():
        rep, member = line.split("\t")
        members.setdefault(rep, []).append(member)
    seen = set()
    for rep, ms in members.items():
        fams = {fam_of[m] for m in ms}
        check(len(fams) == 1, f"cluster of {rep} mixes families {sorted(fams)}")
        fam = fams.pop()
        check(fam not in seen, f"family {fam} split over clusters")
        check(len(ms) == fam_ids.count(fam), f"family {fam} incomplete")
        seen.add(fam)
    return len(members)


def phase_main_path(work: str) -> int:
    import torch

    from galah_tpu import native_ext
    from galah_tpu.utils.synth import make_families
    from galah_tpu_torch.ops.packed_matmul import packed_intersect_counts

    nfam, nmem = MAIN_GENOMES
    corpus = os.path.join(work, "main")
    t0 = time.perf_counter()
    paths, fam_ids = make_families(corpus, nfam, nmem,
                                   genome_length=MAIN_LENGTH,
                                   within_ani=0.98, seed=MAIN_SEED)
    log("main", f"corpus {len(paths)} x {MAIN_LENGTH} bp made in "
                f"{time.perf_counter() - t0:.1f} s; C++ sketcher loaded: "
                f"{native_ext.available()}")
    torch.cuda.reset_peak_memory_stats()
    packed_intersect_counts.launches = 0
    wall, m, clusters, rec = _run_cli(corpus, work, "main", "gpu")
    launches = packed_intersect_counts.launches
    torch.cuda.synchronize()
    n_clusters = _families_exact(clusters, paths, fam_ids)
    counters = m["counters"]
    log("main", f"wall {wall:.2f} s; phases {json.dumps(m['phases_s'])}")
    log("main", "counters " + json.dumps({
        k: counters.get(k) for k in (
            "genomes_sketched", "sketch_bases", "screen_tiles",
            "screen_pairs_computed", "verify_directed_pairtable",
            "verify_directed_grouped", "clusters")
    }))
    log("main", f"kernel launches {launches}; screen on {sorted(rec['screen_dev'])}; "
                f"verify on {sorted(rec['verify_dev'])}; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    check(n_clusters == nfam, f"{n_clusters} clusters, want {nfam}")
    check(launches >= counters["screen_tiles"] > 0,
          f"{launches} kernel launches for {counters['screen_tiles']} tiles")
    check(rec["screen_dev"] == {"cuda"}, f"screen ran on {rec['screen_dev']}")
    check(rec["verify_dev"] == {"cuda"}, f"verify ran on {rec['verify_dev']}")
    log("main", f"OK: {n_clusters} clusters, one per family")
    return launches


def phase_parity(work: str) -> None:
    import numpy as np

    from galah_tpu.utils.synth import make_families

    nfam, nmem = PARITY_GENOMES
    corpus = os.path.join(work, "parity")
    paths, fam_ids = make_families(corpus, nfam, nmem,
                                   genome_length=PARITY_LENGTH,
                                   within_ani=0.98, seed=PARITY_SEED)
    wall_c, _, tsv_c, rec_c = _run_cli(corpus, work, "parity_cpu", "cpu")
    wall_g, _, tsv_g, rec_g = _run_cli(corpus, work, "parity_gpu", "gpu")
    check(rec_c["screen_dev"] == {"cpu"} and rec_g["screen_dev"] == {"cuda"},
          "parity runs on the wrong devices")

    def sorted_pairs(res):
        o = np.lexsort((res.pairs[:, 1], res.pairs[:, 0]))
        return res.pairs[o], res.ani_est[o]

    pc, ac = sorted_pairs(rec_c["pairs"])
    pg, ag = sorted_pairs(rec_g["pairs"])
    check(np.array_equal(pc, pg), "candidate pairs differ CPU vs GPU")
    check(np.array_equal(ac, ag), "screen ANI estimates differ CPU vs GPU")
    vc, vg = rec_c["verified"], rec_g["verified"]
    check(vc.keys() == vg.keys(), "verified pair sets differ CPU vs GPU")
    dani = max(abs(vc[k][0] - vg[k][0]) for k in vc) if vc else 0.0
    af_equal = all(vc[k][1:] == vg[k][1:] for k in vc)
    check(dani <= ANI_TOL, f"verify ANI differs by {dani} > {ANI_TOL}")
    check(af_equal, "verify AF differs CPU vs GPU")
    check(tsv_c == tsv_g, "clusters.tsv differs CPU vs GPU")
    n_clusters = _families_exact(tsv_g, paths, fam_ids)
    log("parity", f"OK: {len(pc)} candidate pairs, {len(vc)} verified, "
                  f"max |dANI| {dani:.3g}, AF equal, clusters.tsv identical "
                  f"({n_clusters} clusters); CPU {wall_c:.2f} s, GPU {wall_g:.2f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    # Fail before printing anything when the program is not beside us.
    import galah_tpu_torch.cli.main  # noqa: F401

    info = phase_device()
    phase_build()
    kernel = phase_kernel()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build",
                                     prefix="chip_smoke_") as work:
        launches = phase_main_path(work)
        phase_parity(work)
    print(json.dumps({"kernels": [{
        "name": "packed_intersect_counts",
        "route": "cuda",
        "source": "galah_tpu_torch/csrc/packed_popcount.cu",
        "replaces": "galah_tpu/ops/packed_matmul.py:46",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
    }]}))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
