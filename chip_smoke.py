#!/usr/bin/env python3
"""Smoke test of galah_tpu_torch, the PyTorch/CUDA port, on one GPU.

    python3 chip_smoke.py

Phases, one line or more each (a failed check raises and the script
exits non-zero):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: compile galah_tpu_torch/csrc/*.cu with nvcc for sm_90a;
3. kernel: each hand-written kernel against its plain torch version on
   the card, bit-exact, at the shapes its screen gives it, with CUDA-event
   times: the packed-popcount kernel (K1) at the packed screen's tiles,
   the popcount-screen kernel (K2) at the popcount screen's tiles beside
   its plain version and K1 at the same shapes; beside both, the library
   call that computes the same counts, torch._int_mm on the rows unpacked
   to int8 0/1 (unpacked outside the timed window), where its shape rules
   allow it;
   gather: the gather probe's entry point (galah_tpu_torch.tools.
   gather_probe.run_probe) at the reference probe's shape (2^17 indices
   into a 4 MiB table) and at a 256 MiB table, K3 at unroll 1, 4 and 8
   and K4 at 8, 16 and 32, with index_select timed beside them; then each
   setting of both kernels against the plain version, bit-exact;
4. main path: `galah_tpu_torch cluster` over 1024 synthetic 1 Mb genomes
   (128 families of 8, 98% ANI within a family) must find exactly the
   128 families, through K1, with screen and verify on the card;
5. popcount path: the same run with GALAH_TPU_SCREEN=popcount must give
   a byte-identical clusters.tsv through K2, with K1 never launched;
6. reference mode: the first genome of each family as
   --reference-genomes-list, the other 896 as --genome-fasta-list: 128
   clusters, one per family, each holding its reference; the rectangle
   runs through K1 on the card;
7. low memory: --low-memory over the main corpus gives a byte-identical
   clusters.tsv, through K1's streaming sweep;
8. streaming at scale: 10,240 synthetic packed rows of 2^17 bits with
   200 planted near-duplicate pairs; the resident and streaming packed
   sweeps (55 tiles of 1024^2) give identical pairs and ANI, and the
   popcount screen (15 tiles of 2048^2) the same pair set;
9. parity: a 64-genome 200 kb corpus through the port on the CPU and on
   the card, for the packed, popcount, reference and low-memory paths,
   must give the same candidate pairs, ANI within 1e-3 percentage
   points, equal AF and the same clusters.tsv.

Each path's kernel launch counts are set to 0 just before its run and
read just after. The C++ sketcher must load: the numpy fallback would
change the sketch times many times over. The last lines are the kernels' JSON summary, the
nvidia-smi line and {"ok": true, "device": {...}}. Without a CUDA device
the script exits 1 and prints no result. The synthetic corpora are
written under build/ and removed at the end.
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
SCALE_ROWS = 10_240
SCALE_BITS = 1 << 17
SCALE_SET_BITS = 5_000         # expected set bits per row
SCALE_PLANTED = 200
# (m, n, w) of each kernel's checks: K1 at the packed screen's 1024-row
# tiles (2^18 and 2^17 bits), at the reference-mode rectangle's one tile
# over the main corpus (the 896 non-first members against the 128 first
# members, 2^17 bits) and at a ragged shape; K2 at the popcount screen's
# tile over the main corpus, at its full 2048-row tiles and at the same
# ragged shape.
REFERENCE_TILE = (MAIN_GENOMES[0] * (MAIN_GENOMES[1] - 1), MAIN_GENOMES[0],
                  4096)
K1_SHAPES = ((1024, 1024, 8192), (1024, 1024, 4096), REFERENCE_TILE,
             (1000, 777, 1000))
K2_SHAPES = ((1024, 1024, 4096), (2048, 2048, 4096), (2048, 2048, 8192),
             (1000, 777, 1000))
# The shape whose times go into the kernels' JSON line, and for the
# gather kernels the unroll (the one both run).
K12_SUMMARY_SHAPE = (1024, 1024, 4096)
GATHER_SUMMARY_UNROLL = 8
GATHER_SEED = 0
GATHER_ITERS = 50
# Published H100 SXM peaks (NVIDIA's data sheet, dense, 700 W): HBM
# bytes/s, int8 tensor-core operations/s, float32 operations/s outside
# the tensor cores (the rate taken for 32-bit integer ALU work).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
FP32_OPS_PER_S = 67e12


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


def _kernel_inputs(m: int, n: int, w: int, gen, dev):
    """Sparse random rows (the screens' ~6% bitmap load) with dense,
    empty and all-ones rows mixed in."""
    a = _random_words(m, w, 0.06, gen, dev)
    b = _random_words(n, w, 0.06, gen, dev)
    a[:4] = _random_words(4, w, 0.9, gen, dev)   # dense rows
    b[10:14] = _random_words(4, w, 0.9, gen, dev)
    a[4:8] = 0                                   # empty rows
    b[20:24] = 0
    a[8] = -1                                    # one all-ones row
    b[30] = -1
    return a, b


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


def _max_err(got, want) -> int:
    import torch

    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def _bound_ms(bytes_moved: float, ops: float, ops_per_s: float):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _counts_bound(m: int, n: int, w: int):
    """Intersection counts of (m, w) and (n, w) words as an int8 0/1
    product on the tensor cores: 2 m n 32w operations; bytes: both
    operands read once, the int32 counts written once."""
    return _bound_ms(4 * (m * w + n * w + m * n), 2 * m * n * 32 * w,
                     INT8_OPS_PER_S)


def _unpack_int8(x):
    """(m, w) int32 words -> (m, 32 w) int8 0/1 bits, word-major."""
    import torch

    shifts = torch.arange(32, dtype=torch.int32, device=x.device)
    return ((x[:, :, None] >> shifts) & 1).to(torch.int8).reshape(
        x.shape[0], -1)


def _library_counts(a, b, want):
    """ms of torch._int_mm on the rows unpacked to int8 0/1, the one
    library call that gives the same counts (exact: every count is below
    2^31), after checking it does; None where _int_mm refuses the shape
    (it wants n and the bit width in multiples of 8). The unpack is
    outside the timed window."""
    import torch

    if a.shape[0] <= 16 or b.shape[0] % 8 or (32 * a.shape[1]) % 8:
        return None
    a8, b8t = _unpack_int8(a), _unpack_int8(b).t()
    got = torch._int_mm(a8, b8t)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "torch._int_mm counts differ")
    ms = _time_ms(lambda: torch._int_mm(a8, b8t), 20)
    del a8, b8t
    return ms


def phase_kernel() -> dict:
    """Each kernel against its plain version, bit-exact; returns per
    kernel the largest error, the times at K12_SUMMARY_SHAPE and the
    bound there."""
    import torch

    from galah_tpu_torch.ops.packed_matmul import (
        packed_intersect_counts as k1,
        packed_intersect_counts_reference as k1_plain,
    )
    from galah_tpu_torch.ops.popcount_screen import (
        popcount_tile_counts as k2,
        popcount_tile_counts_reference as k2_plain,
    )

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    out = {}
    summary = "{}x{}xW{}".format(*K12_SUMMARY_SHAPE)
    bound_ms, bound_by = _counts_bound(*K12_SUMMARY_SHAPE)
    log("kernel", f"counts bound at {summary}: {bound_ms:.4f} ms by "
                  f"{bound_by} (int8 tensor core, {INT8_OPS_PER_S:g} op/s)")
    err = 0
    times = {}
    for m, n, w in K1_SHAPES:
        name = f"{m}x{n}xW{w}"
        a, b = _kernel_inputs(m, n, w, gen, dev)
        got, want = k1(a, b), k1_plain(a, b)
        torch.cuda.synchronize()
        err = max(err, _max_err(got, want))
        check(torch.equal(got, want), f"K1 != plain at {name}")
        times[name] = (_time_ms(lambda: k1(a, b), 20),
                       _time_ms(lambda: k1_plain(a, b), 5),
                       _library_counts(a, b, want))
        log("kernel", f"K1 {name}: bit-exact; kernel {times[name][0]:.4f} "
                      f"ms/tile, plain {times[name][1]:.4f} ms/tile, "
                      f"_int_mm {_fmt_ms(times[name][2])} ms/tile")
    ms, plain_ms, library_ms = times[summary]
    out["packed_intersect_counts"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}

    err = 0
    times = {}
    for m, n, w in K2_SHAPES:
        name = f"{m}x{n}xW{w}"
        a, b = _kernel_inputs(m, n, w, gen, dev)
        got, want, other = k2(a, b), k2_plain(a, b), k1(a, b)
        torch.cuda.synchronize()
        err = max(err, _max_err(got, want))
        check(torch.equal(got, want), f"K2 != plain at {name}")
        check(torch.equal(other, want), f"K1 != K2's plain at {name}")
        times[name] = (_time_ms(lambda: k2(a, b), 20),
                       _time_ms(lambda: k2_plain(a, b), 2),
                       _library_counts(a, b, want),
                       _time_ms(lambda: k1(a, b), 20))
        log("kernel", f"K2 {name}: bit-exact; kernel {times[name][0]:.4f} "
                      f"ms/tile, plain {times[name][1]:.4f} ms/tile, "
                      f"_int_mm {_fmt_ms(times[name][2])} ms/tile, "
                      f"K1 {times[name][3]:.4f} ms/tile")
    ms, plain_ms, library_ms, _ = times[summary]
    out["popcount_tile_counts"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
    log("kernel", "_int_mm times exclude unpacking the rows to int8 0/1")
    return out


def _fmt_ms(ms) -> str:
    return "n/a" if ms is None else f"{ms:.4f}"


def phase_gather() -> dict:
    """The gather probe's entry point with K3's and K4's counts set to 0
    just before and read just after; then each setting of both kernels
    against the plain version on the same inputs, bit-exact. Returns
    both kernels' JSON fields, at the larger-than-L2 table and
    GATHER_SUMMARY_UNROLL."""
    import torch

    from galah_tpu_torch.ops import gather_probe as gp
    from galah_tpu_torch.tools import gather_probe as probe

    dev = torch.device("cuda", 0)
    wrappers = {"gather_xor": gp.gather_xor,
                "gather_xor_chains": gp.gather_xor_chains}
    for fn in wrappers.values():
        fn.launches = 0
    results = probe.run_probe(probe.SHAPES, seed=GATHER_SEED,
                              iters=GATHER_ITERS, device=dev)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    log("gather", f"probe launches {json.dumps(launches)}")
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched by the probe")
    for r in results:
        unroll = "" if r["unroll"] is None else f" unroll={r['unroll']}"
        log("gather", f"{r['shape']} ({r['rows']} x 8 table, {r['indices']} "
                      f"indices) {r['kernel']}{unroll}: {r['ms']:.4f} ms, "
                      f"{r['indices_per_s'] / 1e6:.1f}M idx/s")

    errs = {k: 0 for k in wrappers}
    bounds = {}
    for shape in probe.SHAPES:
        idx, table = probe.make_inputs(shape, GATHER_SEED, dev)
        want = gp.gather_xor_reference(idx, table)
        for name, _, unrolls in probe.KERNELS:
            for unroll in unrolls:
                got = wrappers[name](idx, table, unroll)
                torch.cuda.synchronize()
                errs[name] = max(errs[name], _max_err(
                    got.to(torch.int64) & 0xFFFFFFFF,
                    want.to(torch.int64) & 0xFFFFFFFF))
                check(torch.equal(got, want),
                      f"{name} unroll={unroll} != plain at {shape.name}")
        # Bytes this data needs: every index read once, each distinct
        # row's 32 bytes once, the 32-byte result written once; 8 XORs
        # per index.
        distinct = int(torch.unique(idx).numel())
        bounds[shape.name] = _bound_ms(
            idx.numel() * 4 + distinct * 32 + 32, idx.numel() * 8,
            FP32_OPS_PER_S)
        log("gather", f"{shape.name}: every unroll of both kernels bit-exact; "
                      f"{distinct} distinct rows, bound "
                      f"{bounds[shape.name][0]:.5f} ms by "
                      f"{bounds[shape.name][1]}")
        del idx, table

    def at(kernel, unroll=None):
        return next(r["ms"] for r in results
                    if r["shape"] == probe.LARGE.name
                    and r["kernel"] == kernel and r["unroll"] == unroll)

    bound_ms, bound_by = bounds[probe.LARGE.name]
    return {
        name: {
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": at(name, GATHER_SUMMARY_UNROLL), "plain_ms": at("plain"),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": at("index_select"),
            "shape": f"{probe.LARGE.rows} x 8 table, {probe.LARGE.indices} "
                     f"indices, unroll {GATHER_SUMMARY_UNROLL}",
        }
        for name in wrappers
    }


@contextlib.contextmanager
def _recording():
    """Record the devices the screen and verify ran on, the screen's
    candidate pairs and the verify results of one run."""
    import galah_tpu_torch.engines.native as native
    import galah_tpu_torch.ops.fragment_ani as fa
    import galah_tpu_torch.ops.pair_table as pt
    import galah_tpu_torch.ops.popcount_screen as pc
    import galah_tpu_torch.ops.prefilter as pf

    rec = {"screen_dev": set(), "verify_dev": set(), "tile_shapes": set(),
           "pairs": None, "verified": {}}
    screens = ("screen_triangle_packed", "screen_triangle_popcount",
               "screen_rectangle_packed")
    orig = {
        (pf, "_containment"): pf._containment,
        (pc, "_containment"): pc._containment,
        (pt, "_pair_table_kernel"): pt._pair_table_kernel,
        (fa, "_forward_kernel"): fa._forward_kernel,
        (fa.FragmentAniEngine, "bidirectional"):
            fa.FragmentAniEngine.bidirectional,
        **{(native, s): getattr(native, s) for s in screens},
    }

    def containment(fn):
        def run(counts, *a, **k):
            rec["screen_dev"].add(counts.device.type)
            rec["tile_shapes"].add(tuple(counts.shape))
            return fn(counts, *a, **k)
        return run

    def pair_table_kernel(ustream, *a, **k):
        rec["verify_dev"].add(ustream.device.type)
        return orig[(pt, "_pair_table_kernel")](ustream, *a, **k)

    def forward_kernel(bitmaps, *a, **k):
        rec["verify_dev"].add(bitmaps.device.type)
        return orig[(fa, "_forward_kernel")](bitmaps, *a, **k)

    def screen(fn):
        def run(*a, **k):
            rec["pairs"] = fn(*a, **k)
            return rec["pairs"]
        return run

    def bidirectional(self, pairs, sketches_by_key):
        out = orig[(fa.FragmentAniEngine, "bidirectional")](
            self, pairs, sketches_by_key)
        rec["verified"].update(out)
        return out

    pf._containment = containment(orig[(pf, "_containment")])
    pc._containment = containment(orig[(pc, "_containment")])
    pt._pair_table_kernel = pair_table_kernel
    fa._forward_kernel = forward_kernel
    fa.FragmentAniEngine.bidirectional = bidirectional
    for s in screens:
        setattr(native, s, screen(orig[(native, s)]))
    try:
        yield rec
    finally:
        for (owner, attr), fn in orig.items():
            setattr(owner, attr, fn)


def _launch_counters():
    from galah_tpu_torch.ops.packed_matmul import packed_intersect_counts
    from galah_tpu_torch.ops.popcount_screen import popcount_tile_counts

    return {"K1": packed_intersect_counts, "K2": popcount_tile_counts}


def _run_cli(inputs, out_dir: str, tag: str, platform: str,
             screen: str | None = None, flags=()):
    """One `cluster` run; returns (wall, metrics, clusters.tsv bytes,
    recording, {kernel: launches in this run})."""
    from galah_tpu_torch.cli.main import main

    tsv = os.path.join(out_dir, f"{tag}.tsv")
    mjson = os.path.join(out_dir, f"{tag}.json")
    argv = ["cluster", *inputs, "--ani", "95",
            "-t", str(min(8, os.cpu_count() or 1)),
            "--output-cluster-definition", tsv, "--metrics-json", mjson,
            "-q", *flags]
    os.environ["GALAH_TPU_PLATFORM"] = platform
    if screen:
        os.environ["GALAH_TPU_SCREEN"] = screen
    counters = _launch_counters()
    try:
        for fn in counters.values():
            fn.launches = 0
        with _recording() as rec:
            t0 = time.perf_counter()
            rc = main(argv)
            wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        os.environ.pop("GALAH_TPU_SCREEN", None)
    check(rc == 0, f"{tag}: cluster exited {rc}")
    with open(mjson) as f:
        run_metrics = json.load(f)
    with open(tsv, "rb") as f:
        clusters = f.read()
    return wall, run_metrics, clusters, rec, launches


def _members(clusters_tsv: bytes) -> dict:
    members = {}
    for line in clusters_tsv.decode().splitlines():
        rep, member = line.split("\t")
        members.setdefault(rep, []).append(member)
    return members


def _families_exact(clusters_tsv: bytes, paths, fam_ids) -> int:
    """Number of clusters, after checking each is exactly one family."""
    fam_of = {p: f for p, f in zip(paths, fam_ids)}
    seen = set()
    for rep, ms in _members(clusters_tsv).items():
        fams = {fam_of[m] for m in ms}
        check(len(fams) == 1, f"cluster of {rep} mixes families {sorted(fams)}")
        fam = fams.pop()
        check(fam not in seen, f"family {fam} split over clusters")
        check(len(ms) == fam_ids.count(fam), f"family {fam} incomplete")
        seen.add(fam)
    return len(seen)


def _reference_inputs(work: str, tag: str, paths, fam_ids):
    """CLI inputs of reference mode: the first genome of each family in
    a --reference-genomes-list, the rest in a --genome-fasta-list."""
    refs = [paths[fam_ids.index(f)] for f in sorted(set(fam_ids))]
    ref_list = os.path.join(work, f"{tag}_refs.txt")
    genome_list = os.path.join(work, f"{tag}_genomes.txt")
    with open(ref_list, "w") as f:
        f.writelines(p + "\n" for p in refs)
    with open(genome_list, "w") as f:
        f.writelines(p + "\n" for p in paths if p not in set(refs))
    return refs, ["--genome-fasta-list", genome_list,
                  "--reference-genomes-list", ref_list]


def _log_run(phase: str, wall: float, m: dict, launches: dict, rec) -> None:
    import torch

    log(phase, f"wall {wall:.2f} s; phases {json.dumps(m['phases_s'])}")
    counters = m["counters"]
    log(phase, "counters " + json.dumps({
        k: counters.get(k) for k in (
            "genomes_sketched", "sketch_bases", "screen_tiles",
            "screen_pairs_computed", "verify_directed_pairtable",
            "verify_directed_grouped", "clusters")
    }))
    log(phase, f"kernel launches {json.dumps(launches)}; screen on "
               f"{sorted(rec['screen_dev'])}; verify on "
               f"{sorted(rec['verify_dev'])}; peak device memory "
               f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    check(rec["screen_dev"] == {"cuda"}, f"screen ran on {rec['screen_dev']}")
    check(rec["verify_dev"] == {"cuda"}, f"verify ran on {rec['verify_dev']}")


def make_main_corpus(work: str):
    from galah_tpu_torch import native_ext
    from galah_tpu_torch.utils.synth import make_families

    nfam, nmem = MAIN_GENOMES
    corpus = os.path.join(work, "main")
    t0 = time.perf_counter()
    paths, fam_ids = make_families(corpus, nfam, nmem,
                                   genome_length=MAIN_LENGTH,
                                   within_ani=0.98, seed=MAIN_SEED)
    log("main", f"corpus {len(paths)} x {MAIN_LENGTH} bp made in "
                f"{time.perf_counter() - t0:.1f} s; C++ sketcher loaded: "
                f"{native_ext.available()}")
    check(native_ext.available(),
          "the C++ sketcher (native/libfastaio.so) did not load")
    return corpus, paths, fam_ids


def phase_main_path(work: str, corpus: str, paths, fam_ids):
    """The packed path; returns (K1 launches, clusters.tsv bytes)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    wall, m, clusters, rec, launches = _run_cli(
        ["-d", corpus, "-x", "fna"], work, "main", "gpu")
    _log_run("main", wall, m, launches, rec)
    n_clusters = _families_exact(clusters, paths, fam_ids)
    tiles = m["counters"]["screen_tiles"]
    check(n_clusters == MAIN_GENOMES[0],
          f"{n_clusters} clusters, want {MAIN_GENOMES[0]}")
    check(launches["K1"] >= tiles > 0,
          f"{launches['K1']} K1 launches for {tiles} tiles")
    log("main", f"OK: {n_clusters} clusters, one per family")
    return launches["K1"], clusters


def phase_popcount_path(work: str, corpus: str, main_tsv: bytes) -> int:
    """GALAH_TPU_SCREEN=popcount; returns K2's launches."""
    wall, m, clusters, rec, launches = _run_cli(
        ["-d", corpus, "-x", "fna"], work, "popcount", "gpu",
        screen="popcount")
    _log_run("popcount", wall, m, launches, rec)
    check(launches["K2"] >= 1 and launches["K1"] == 0,
          f"popcount path launches {launches}")
    check(clusters == main_tsv, "popcount clusters.tsv differs from packed")
    log("popcount", "OK: clusters.tsv identical to the packed run")
    return launches["K2"]


def phase_reference(work: str, paths, fam_ids) -> None:
    refs, inputs = _reference_inputs(work, "reference", paths, fam_ids)
    wall, m, clusters, rec, launches = _run_cli(
        inputs, work, "reference", "gpu")
    _log_run("reference", wall, m, launches, rec)
    check(launches["K1"] >= 1, f"reference path launches {launches}")
    check(rec["tile_shapes"] == {REFERENCE_TILE[:2]},
          f"reference tiles {rec['tile_shapes']}, the kernel phase checked "
          f"{REFERENCE_TILE[:2]}")
    n_clusters = _families_exact(clusters, paths, fam_ids)
    check(n_clusters == MAIN_GENOMES[0],
          f"{n_clusters} clusters, want {MAIN_GENOMES[0]}")
    for rep, ms in _members(clusters).items():
        check(len(set(ms) & set(refs)) == 1,
              f"cluster of {rep} does not hold exactly one reference")
    log("reference", f"OK: {n_clusters} clusters, one per family, each "
                     f"holding its reference ({len(refs)} references)")


def phase_low_memory(work: str, corpus: str, main_tsv: bytes) -> None:
    wall, m, clusters, rec, launches = _run_cli(
        ["-d", corpus, "-x", "fna"], work, "low_memory", "gpu",
        flags=["--low-memory"])
    _log_run("low-memory", wall, m, launches, rec)
    check(launches["K1"] >= 1, f"low-memory path launches {launches}")
    check(clusters == main_tsv, "--low-memory clusters.tsv differs")
    log("low-memory", "OK: clusters.tsv identical to the default run")


def phase_scale() -> None:
    """Resident, streaming and popcount sweeps over 10,240 packed rows."""
    import numpy as np
    import torch

    from galah_tpu_torch.engines.native import _screen_min_containment
    from galah_tpu_torch.ops.popcount_screen import (
        DEFAULT_BLOCK as POPCOUNT_BLOCK,
        _popc32,
        screen_triangle_popcount,
    )
    from galah_tpu_torch.ops.prefilter import screen_triangle_packed

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    w = SCALE_BITS // 32
    x = _random_words(SCALE_ROWS, w, SCALE_SET_BITS / SCALE_BITS, gen, dev)
    order = torch.randperm(SCALE_ROWS, generator=gen, device=dev)
    ii = order[:SCALE_PLANTED].sort().values
    jj = order[SCALE_PLANTED:2 * SCALE_PLANTED]
    x[jj] = x[ii] & _random_words(SCALE_PLANTED, w, 0.9, gen, dev)
    planted = {tuple(sorted(p)) for p in zip(ii.tolist(), jj.tolist())}
    sizes = _popc32(x).sum(dim=1).cpu().numpy()
    rows = list(x.cpu().numpy().view(np.uint32))
    del x
    cut = _screen_min_containment(95.0, 0.15, 15)
    counters = _launch_counters()
    runs = {}
    for name, screen, kw in (
        ("resident", screen_triangle_packed, {}),
        ("streaming", screen_triangle_packed, {"cache_blocks": False}),
        ("popcount", screen_triangle_popcount, {}),
    ):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = screen(rows, sizes, 15, cut, SCALE_BITS, device=dev, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        runs[name] = res
        log("scale", f"{name}: {dt:.3f} s, {len(res.pairs)} pairs, launches "
                     f"{json.dumps({k: f.launches for k, f in counters.items()})}")
    nb = -(-SCALE_ROWS // POPCOUNT_BLOCK)
    check(counters["K2"].launches == nb * (nb + 1) // 2,
          "one K2 launch per popcount tile")
    res, st = runs["resident"], runs["streaming"]
    check(np.array_equal(res.pairs, st.pairs), "streaming pairs differ")
    check(np.array_equal(res.ani_est.view(np.int32), st.ani_est.view(np.int32)),
          "streaming ANI differs")
    found = set(map(tuple, res.pairs.tolist()))
    check(found == planted, f"{len(found)} pairs, {len(planted)} planted")
    check(set(map(tuple, runs["popcount"].pairs.tolist())) == found,
          "popcount pair set differs")
    log("scale", f"OK: {SCALE_ROWS} rows, the {len(planted)} planted pairs "
                 "exactly, resident == streaming (pairs and ANI), popcount "
                 "pair set equal")


def phase_parity(work: str) -> None:
    import numpy as np

    from galah_tpu_torch.utils.synth import make_families

    nfam, nmem = PARITY_GENOMES
    corpus = os.path.join(work, "parity")
    paths, fam_ids = make_families(corpus, nfam, nmem,
                                   genome_length=PARITY_LENGTH,
                                   within_ani=0.98, seed=PARITY_SEED)
    _, ref_inputs = _reference_inputs(work, "parity", paths, fam_ids)
    dir_inputs = ["-d", corpus, "-x", "fna"]

    def sorted_pairs(res):
        o = np.lexsort((res.pairs[:, 1], res.pairs[:, 0]))
        return res.pairs[o], res.ani_est[o]

    for mode, inputs, screen, flags in (
        ("packed", dir_inputs, None, ()),
        ("popcount", dir_inputs, "popcount", ()),
        ("reference", ref_inputs, None, ()),
        ("low-memory", dir_inputs, None, ("--low-memory",)),
    ):
        runs = {
            dev: _run_cli(inputs, work, f"parity_{mode}_{dev}", dev,
                          screen=screen, flags=flags)
            for dev in ("cpu", "gpu")
        }
        (wall_c, _, tsv_c, rec_c, _), (wall_g, _, tsv_g, rec_g, _) = (
            runs["cpu"], runs["gpu"])
        check(rec_c["screen_dev"] == {"cpu"} and rec_g["screen_dev"] == {"cuda"},
              f"{mode}: parity runs on the wrong devices")
        pc, ac = sorted_pairs(rec_c["pairs"])
        pg, ag = sorted_pairs(rec_g["pairs"])
        check(np.array_equal(pc, pg), f"{mode}: candidate pairs differ")
        check(np.array_equal(ac, ag), f"{mode}: screen ANI differs")
        vc, vg = rec_c["verified"], rec_g["verified"]
        check(vc.keys() == vg.keys(), f"{mode}: verified pair sets differ")
        dani = max(abs(vc[k][0] - vg[k][0]) for k in vc) if vc else 0.0
        check(dani <= ANI_TOL, f"{mode}: verify ANI differs by {dani}")
        check(all(vc[k][1:] == vg[k][1:] for k in vc),
              f"{mode}: verify AF differs")
        check(tsv_c == tsv_g, f"{mode}: clusters.tsv differs CPU vs GPU")
        n_clusters = _families_exact(tsv_g, paths, fam_ids)
        log("parity", f"{mode} OK: {len(pc)} candidate pairs, {len(vc)} "
                      f"verified, max |dANI| {dani:.3g}, AF equal, "
                      f"clusters.tsv identical ({n_clusters} clusters); "
                      f"CPU {wall_c:.2f} s, GPU {wall_g:.2f} s")


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
    kernels = phase_kernel()
    gather = phase_gather()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build",
                                     prefix="chip_smoke_") as work:
        corpus, paths, fam_ids = make_main_corpus(work)
        k1_launches, main_tsv = phase_main_path(work, corpus, paths, fam_ids)
        k2_launches = phase_popcount_path(work, corpus, main_tsv)
        phase_reference(work, paths, fam_ids)
        phase_low_memory(work, corpus, main_tsv)
        phase_scale()
        phase_parity(work)
    print(json.dumps({"kernels": [
        {
            "name": "packed_intersect_counts",
            "route": "cuda",
            "source": "galah_tpu_torch/csrc/packed_popcount.cu",
            "replaces": "galah_tpu/ops/packed_matmul.py:46",
            "launches": k1_launches,
            **kernels["packed_intersect_counts"],
        },
        {
            "name": "popcount_tile_counts",
            "route": "cuda",
            "source": "galah_tpu_torch/csrc/popcount_screen.cu",
            "replaces": "galah_tpu/ops/popcount_screen.py:47",
            "launches": k2_launches,
            **kernels["popcount_tile_counts"],
        },
        {
            "name": "gather_xor",
            "route": "cuda",
            "source": "galah_tpu_torch/csrc/gather_probe.cu",
            "replaces": "benchmarks/pallas_gather_probe.py:58",
            **gather["gather_xor"],
        },
        {
            "name": "gather_xor_chains",
            "route": "cuda",
            "source": "galah_tpu_torch/csrc/gather_probe.cu",
            "replaces": "benchmarks/pallas_gather_probe.py:85",
            **gather["gather_xor_chains"],
        },
    ]}))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
