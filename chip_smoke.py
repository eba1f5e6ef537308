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
   times: the packed-popcount kernel (K1, unpack + s8 wgmma) at the packed
   screen's tiles (the genome and contig corpora's), the popcount-screen
   kernel (K2, b1 AND-popcount mma) at the popcount screen's tiles beside
   its plain version and K1 at the same shapes; beside both, the library
   call that computes the same counts, torch._int_mm on the rows unpacked
   to int8 0/1 (unpacked outside the timed window; a column count that is
   not a multiple of 8 is padded with zero rows and cut back), and the
   previous design's time;
   gather: the gather probe's entry point (galah_tpu_torch.tools.
   gather_probe.run_probe) at the reference probe's shape (2^17 indices
   into a 4 MiB table) and at a 256 MiB table, K3 at unroll 1, 4 and 8
   and K4 at 8, 16 and 32, with index_select timed beside them and the
   previous design's time; then each setting of both kernels against the
   plain version, bit-exact; then the probe's index patterns of the
   256 MiB table (run_patterns: random, sorted, grouped by tile, strided,
   every row, and a torch read of the table);
4. sketch kernel: K5 (hash, select and per-fragment dedup,
   csrc/device_sketch.cu) against sketch_batch_reference on the card,
   bit-exact (bitmaps, per-fragment counts and buckets), on 8 genomes
   and on the main path's 64-genome batch of the main corpus and on
   2,000 contigs of the contig corpus, with CUDA-event times (the launch
   alone, the product span, the plain version, the torch dedup K5
   replaced), its bound and its grid;
5. main path: `galah_tpu_torch cluster` over 1024 synthetic 1 Mb genomes
   (128 families of 8, 98% ANI within a family) must find exactly the
   128 families, sketching on the card through K5 (every sketch equal to
   the host C++ sketcher's, the screen matrix built from device-born
   rows) and screening through K1, with screen and verify on the card
   and the three phases overlapped (phases_overlapped, every verify
   stream read from the stream arena); it prints the sketch phase's
   split (read, upload, K5 and the bucket gather, bitmaps to bucket
   lists, host copies);
6. popcount path: the same run with GALAH_TPU_SCREEN=popcount must give
   a byte-identical clusters.tsv through K2, with K1 never launched;
7. reference mode: the first genome of each family as
   --reference-genomes-list, the other 896 as --genome-fasta-list: 128
   clusters, one per family, each holding its reference; the rectangle
   runs through K1 on the card;
8. low memory: --low-memory over the first 32 families (256 genomes)
   gives a clusters.tsv byte-identical to a default run over the same
   genomes, through K1's streaming sweep;
8b. indicator: GALAH_TPU_SCREEN=indicator under GALAH_TPU_SCREEN_DTYPE
   int8, bf16 and f32 on the main corpus must give phase 5's candidate
   pairs and ANI bit for bit and its clusters.tsv, and in reference mode
   phase 7's pairs, with K1 never launched (the product is a library
   call); each run's wall and screen time are printed, then the product
   at the main tile in each dtype, exact, with its time and bound;
9. contig path: `--cluster-contigs --small-contigs` over 100,000 synthetic
   5 kb contigs in one FASTA (20,000 families of 5 at 98% ANI) must find
   exactly the 20,000 families, every contig's device sketch equal to
   the C++ sketcher's, through K5 and K1, with the phases overlapped:
   the first screen tile issued before the last contig was sketched
   (screen_rows_at_first_dispatch), every verify stream read from the
   stream arena with no reset; then once more with GALAH_TPU_PIPELINE=0,
   which must give the same candidate pairs and a byte-identical
   clusters.tsv;
10. resume: the resume artifacts on a contig corpus of the contig
   path's shape cut to 20,000 contigs (4,000 families of 5; 210 tiles),
   each run's clusters.tsv byte-identical to a default run's over it:
   (a) --sweep-checkpoint C --sketch-directory D --output-distance-cache
   X, killed in-process at screen tile 101 (exit 1; C must hold the
   drained tiles); (b) the
   same flags without the crash: K1 launched once for each tile not in
   C, the contig bundle written (its write time printed); (c) D alone:
   K5 never launched, K1 once a tile, rows and verify streams uploaded
   from the host (bytes and times printed); (d) D and the complete C: K1
   and K5 never launched; (e) --input-distance-cache X: K1 never
   launched;
11. surface: on the main corpus, `process` with a synthetic CheckM2
   report and precomputed barrnap/tRNAscan-SE lists (128 families, each
   represented by its best genome), the library API's cluster_genomes
   on the card (128 families), `cluster-validate` over the main path's
   clusters.tsv (no problems), and --precluster-method finch
   --cluster-method native over the first 32 families (32 families,
   verify on the card);
12. streaming at scale: 10,240 synthetic packed rows of 2^17 bits with
   200 planted near-duplicate pairs; the resident and streaming packed
   sweeps (55 tiles of 1024^2) give identical pairs and ANI, and the
   popcount screen (15 tiles of 2048^2) the same pair set;
13. parity: a 64-genome 200 kb corpus through the port on the CPU (host
   sketching) and on the card (device sketching), for the packed,
   popcount, reference and low-memory paths, and a 2,000-contig corpus
   in contig mode, must give the same candidate pairs, ANI within 1e-3
   percentage points, equal AF and the same clusters.tsv;
14. shards: the contig path over every visible card as a shard, or two
   shards on cuda:0 with one card (the cluster subcommand called with
   them): the sharded triangle, and under GALAH_TPU_ROWSHARD=1 the
   row-sharded one, must give phase 9's candidate pairs and ANI bit for
   bit and its clusters.tsv, with K1 launched by each shard and 4,851
   times in all (it prints the tiles the row-sharded stream rule
   decided densely); reference mode over the shards must give phase 7's
   pairs;
15. processes: this script again as 2 ranks joined by gloo on a free
   localhost port (one card a rank, or both on cuda:0), each running the
   API's cluster_genomes on the main corpus (its share of the genomes
   sketched through K5, the rest exchanged; one K1 launch in all) and
   cluster_contigs on the contig corpus (every contig sketched on each
   rank; K1 launches summing to 4,851): every rank's clusters.tsv must
   be phase 5's and phase 9's. It prints each rank's launches, the
   exchange's bytes and seconds and the verify partition's pairs. A rank
   that fails or outlasts RANK_TIMEOUT_S fails the phase;
16. large genomes: `cluster` over 8 families of 3 synthetic 10 Mb
   genomes (98% ANI), whose fragment streams all exceed 2^20 hashes
   (checked first; the smallest is printed), so every verify takes the
   grouped path, three times: GALAH_TPU_VERIFY_GATHER=word, =bt and
   unset (words). Each must find the 8 families with no verify on the
   pair table; clusters.tsv, ANI and AF must be bit-identical across the
   three. Then the grouped verify on one stream against 8, 32, 64 and
   128 references, word against bt (bit-identical), with CUDA-event
   times, the rows and bytes each gathers, a byte bound and the gathers
   priced at the gather probe's measured row rates.

On a machine with several cards phases 5-13 and 16 run on the first
(every entry point that resolves the local devices is given cuda:0
only), phase 14 takes a shard a card and phase 15 a rank a card.

Each path's kernel launch counts are set to 0 just before its run and
read just after (by shard and by rank in phases 14 and 15). The C++
sketcher must load: the numpy fallback would change the sketch times
many times over. The last lines are the device programs' JSON line (the
indicator product by dtype, the grouped verify by width and gather,
phase 16's runs), the kernels' JSON summary, the nvidia-smi line and
{"ok": true, "device": {...}}. Without a CUDA device
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
# The contig path: BASELINE config #3's 100k viral/plasmid contigs, as
# benchmarks/contig_e2e.py makes them (families x members, 5 kb, 98% ANI).
CONTIG_CORPUS = (20_000, 5)
CONTIG_LENGTH = 5_000
CONTIG_SEED = 13
PARITY_CONTIGS = (400, 5)
LOW_MEMORY_FAMILIES = 32       # --low-memory runs over these families only
# The resume phase's corpus: the contig corpus's shape at a fifth of its
# depth (20,000 contigs, 210 tiles), and its crash, about half the sweep.
RESUME_CORPUS = (4_000, 5)
RESUME_CRASH_TILES = 100
K5_GENOMES = 8                 # main-corpus genomes of K5's check
K5_MAIN_GENOMES = 64           # the main path's batch (64 MiB / 2^20)
K5_CONTIGS = 2_000             # contig-corpus contigs of K5's check
ANI_TOL = 1e-3                 # percentage points, GPU vs CPU verify ANI
SCALE_ROWS = 10_240
RANKS = 2                      # phase 15's processes on one card
RANK_TIMEOUT_S = 600           # phase 15's time limit and collective timeout
SCALE_BITS = 1 << 17
# Phase 16: genomes large enough that every fragment stream exceeds the
# pair table's 2^20 hashes (about 1.25M at 10 Mb), so every verify takes
# the grouped path; 8 families of 3 at 98% ANI (240 Mb).
LARGE_GENOMES = (8, 3)
LARGE_LENGTH = 10_000_000
LARGE_SEED = 17
GROUPED_MIN_HASHES = 1 << 20
# The grouped verify's widths timed on one stream (128 is the budget's
# width at 1.25M hashes), and the gather probe's measured 32-byte-row
# rates on the H100 (tools/gather_probe.py's run_patterns, rows/s:
# random and ascending indices into a table beyond the L2), at which
# its gathers are priced.
GROUPED_REFS = (8, 32, 64, 128)
PROBE_ROWS_PER_S = {"random": 3.2e10, "ascending": 6.5e10}
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
# K1 also at the contig path's tiles (2^15 bits, W = 1024; the last row
# block of 100,000 rows holds 672).
CONTIG_TILES = ((1024, 1024, 1024),
                (1024, CONTIG_CORPUS[0] * CONTIG_CORPUS[1] % 1024, 1024))
K1_SHAPES = ((1024, 1024, 8192), (1024, 1024, 4096), REFERENCE_TILE,
             *CONTIG_TILES, (1000, 777, 1000))
K2_SHAPES = ((1024, 1024, 4096), (2048, 2048, 4096), (2048, 2048, 8192),
             (1000, 777, 1000))
# The shape whose times go into the kernels' JSON line, and for the
# gather kernels the unroll (the one both run).
K12_SUMMARY_SHAPE = (1024, 1024, 4096)
# ms of the previous design of each kernel, NVIDIA H100 80GB HBM3 at
# 700 W, printed beside the new times: the count kernels' integer-ALU
# __popc design, from this script's kernel phase before the tensor-core
# redesign; the gather kernels' two-waves grid with __ldg rows and an
# index load a lane, from tools/gather_probe.py before their redesign, by
# (kernel, shape name, unroll).
PREVIOUS_MS = {
    ("K1", (1024, 1024, 8192)): 2.4669,
    ("K1", (1024, 1024, 4096)): 1.2169,
    ("K1", REFERENCE_TILE): 0.6403,
    ("K1", (1000, 777, 1000)): 0.2996,
    ("K2", (1024, 1024, 4096)): 1.1995,
    ("K2", (2048, 2048, 4096)): 4.7731,
    ("K2", (2048, 2048, 8192)): 9.5979,
    ("gather_xor", "reference", 1): 0.0039,
    ("gather_xor", "reference", 4): 0.0036,
    ("gather_xor", "reference", 8): 0.0044,
    ("gather_xor_chains", "reference", 8): 0.0048,
    ("gather_xor_chains", "reference", 16): 0.0065,
    ("gather_xor_chains", "reference", 32): 0.0110,
    ("gather_xor", "larger-than-L2", 1): 0.1317,
    ("gather_xor", "larger-than-L2", 4): 0.1303,
    ("gather_xor", "larger-than-L2", 8): 0.1300,
    ("gather_xor_chains", "larger-than-L2", 8): 0.1311,
    ("gather_xor_chains", "larger-than-L2", 16): 0.1418,
    ("gather_xor_chains", "larger-than-L2", 32): 0.1923,
}
GATHER_SUMMARY_UNROLL = 8
GATHER_SEED = 0
GATHER_ITERS = 50
# Published H100 SXM peaks (NVIDIA's data sheet, dense, 700 W): HBM
# bytes/s, int8 tensor-core operations/s; and the integer ALU pipe's
# 32-bit operations/s (the gather kernels' XORs, one LOP3 a word): 64
# lanes a clock an SM, 132 SMs, 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
INT_ALU_OPS_PER_S = 64 * 132 * 1.98e9
# The indicator screen's product dtypes and their peaks (operations/s):
# int8 and bf16 on the tensor cores, float32 on the CUDA cores (TF32
# stays off, so float32 products do not use the tensor cores).
INDICATOR_PEAKS = {"int8": INT8_OPS_PER_S, "bf16": 0.989e15, "f32": 67e12}


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
    """Bound of the intersection counts of (m, w) and (n, w) words, K1's
    and K2's function: both operands read once, the int32 counts written
    once. It has no operations term: the card computes the function as
    single-bit AND-popcount tensor-core products (K2), whose peak NVIDIA
    does not publish, faster than the int8 term below allows."""
    return _bound_ms(4 * (m * w + n * w + m * n), 0, INT8_OPS_PER_S)


def _int8_ceiling_ms(m: int, n: int, w: int) -> float:
    """ms of the counts as an int8 0/1 product (2 m n 32w operations) at
    the int8 tensor-core peak: the s8 route's ceiling (K1's), not a bound
    on the function."""
    return 2 * m * n * 32 * w / INT8_OPS_PER_S * 1e3


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
    (it wants more than 16 rows). It wants n in multiples of 8: other
    column counts are padded with zero rows, which count 0, and cut back
    to n before the check. The unpack and padding are outside the timed
    window."""
    import torch

    if a.shape[0] <= 16:
        return None
    n = b.shape[0]
    b8 = _unpack_int8(b)
    if n % 8:
        b8 = torch.cat([b8, b8.new_zeros((8 - n % 8, b8.shape[1]))])
    a8, b8t = _unpack_int8(a), b8.t()
    got = torch._int_mm(a8, b8t)[:, :n]
    torch.cuda.synchronize()
    check(torch.equal(got, want), "torch._int_mm counts differ")
    ms = _time_ms(lambda: torch._int_mm(a8, b8t), 20)
    del a8, b8, b8t
    return ms


def _plan_text(module, m: int, n: int, w: int) -> str:
    from galah_tpu_torch.ops.packed_matmul import sm_count

    plan = module._launch_plan(m, n, w, sm_count(0))
    gx, gy, gz = plan.grid
    return f"grid {gx}x{gy}x{gz} = {gx * gy * gz} blocks"


def phase_kernel() -> dict:
    """Each kernel against its plain version, bit-exact; returns per
    kernel the largest error, the times at K12_SUMMARY_SHAPE and the
    bound there."""
    import torch

    from galah_tpu_torch.ops import packed_matmul, popcount_screen
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
    log("kernel", f"counts bound at {summary} (K1 and K2): {bound_ms:.5f} "
                  f"ms by {bound_by}; not a bound, the s8 route's int8 "
                  f"ceiling: {_int8_ceiling_ms(*K12_SUMMARY_SHAPE):.4f} ms "
                  f"at {INT8_OPS_PER_S:g} op/s")
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
                      f"ms/tile (previous design "
                      f"{_fmt_ms(PREVIOUS_MS.get(('K1', (m, n, w))))}), "
                      f"plain {times[name][1]:.4f} ms/tile, "
                      f"_int_mm {_fmt_ms(times[name][2])} ms/tile; bound "
                      f"{_counts_bound(m, n, w)[0]:.5f} ms (bytes; int8 "
                      f"ceiling {_int8_ceiling_ms(m, n, w):.4f}); "
                      f"{_plan_text(packed_matmul, m, n, w)}")
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
                      f"ms/tile (previous design "
                      f"{_fmt_ms(PREVIOUS_MS.get(('K2', (m, n, w))))}), "
                      f"plain {times[name][1]:.4f} ms/tile, "
                      f"_int_mm {_fmt_ms(times[name][2])} ms/tile, "
                      f"K1 {times[name][3]:.4f} ms/tile; bound "
                      f"{_counts_bound(m, n, w)[0]:.5f} ms (bytes; int8 "
                      f"ceiling {_int8_ceiling_ms(m, n, w):.4f}); "
                      f"{_plan_text(popcount_screen, m, n, w)}")
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
        previous = PREVIOUS_MS.get((r["kernel"], r["shape"], r["unroll"]))
        before = ("" if previous is None
                  else f" (previous design {previous:.4f})")
        log("gather", f"{r['shape']} ({r['rows']} x 8 table, {r['indices']} "
                      f"indices) {r['kernel']}{unroll}: {r['ms']:.4f} ms"
                      f"{before}, {r['indices_per_s'] / 1e6:.1f}M idx/s")

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
            INT_ALU_OPS_PER_S)
        log("gather", f"{shape.name}: every unroll of both kernels bit-exact; "
                      f"{distinct} distinct rows, bound "
                      f"{bounds[shape.name][0]:.5f} ms by "
                      f"{bounds[shape.name][1]}")
        del idx, table

    t0 = time.perf_counter()
    for r in probe.run_patterns(probe.LARGE, seed=GATHER_SEED,
                                iters=GATHER_ITERS, device=dev):
        log("gather", "pattern: " + probe.describe(r))
    log("gather", f"patterns ran in {time.perf_counter() - t0:.1f} s")

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


def phase_sketch_kernel(genome_paths, contig_path: str) -> dict:
    """K5 against its plain version on the card, bit-exact (both bitmaps,
    the per-fragment counts and buckets), on K5_GENOMES genomes and the
    main path's K5_MAIN_GENOMES-genome batch of the main corpus (at the
    main path's sketch parameters) and on K5_CONTIGS contigs of the
    contig corpus (at the small-genome ones). CUDA-event times: the
    launch alone, the product span (bitmap zeroing, launch, the gather of
    the fragment buckets), the plain version, and the torch sort /
    unique / bincount dedup that K5's on-chip dedup replaced, on the
    plain version's keys. Its bound (tools/k5_profile.py::k5_bound) takes
    the instructions a k-mer start of K5's hash loop on its common path,
    in all and by integer pipe, from `cuobjdump -sass` of the library
    this run built, at the SM clock nvidia-smi reports. Returns K5's JSON
    fields (at the main batch)."""
    import torch

    from galah_tpu_torch.engines.native import _shrink_bits
    from galah_tpu_torch.io.fasta import decompressed_size_estimate
    from galah_tpu_torch.ops import _build
    from galah_tpu_torch.ops import device_sketch as ds
    from galah_tpu_torch.sketch.fracminhash import (
        NativeSketchParams,
        small_genome_params,
    )
    from galah_tpu_torch.tools import k5_profile

    dev = torch.device("cuda", 0)
    clock_hz = k5_profile.sm_clock_hz()
    loops = k5_profile.k5_loops(str(_build.build_library().path))
    genome_params = _shrink_bits(
        NativeSketchParams(),
        max(decompressed_size_estimate(p) for p in genome_paths))
    t0 = time.perf_counter()
    contigs = ds._FastaSource(contig_path)
    log("sketch-kernel", f"the C++ reader parsed the contig corpus "
                         f"({len(contigs.lengths)} records, {contigs.nbytes} "
                         f"bases) in {time.perf_counter() - t0:.2f} s; SM "
                         f"clock {clock_hz / 1e6:.0f} MHz (max); K5's hash "
                         f"loop a start on the common path (all, ALU pipe, "
                         f"FMA pipe; SM clocks at the least): " + "; ".join(
                             f"{tag} {lp['per_start']}, {lp['alu_per_start']}"
                             f", {lp['fma_per_start']}; "
                             f"{k5_profile.clocks_per_start(lp):.4f}"
                             for tag, lp in (("wide", loops[False]),
                                             ("narrow", loops[True]))))

    def genomes(n):
        srcs = [ds._FastaSource(p) for p in genome_paths[:n]]
        return (genome_params, [str(p) for p in genome_paths[:n]],
                [[(src, j) for j in range(len(src.lengths))] for src in srcs])

    cases = {
        "genomes": genomes(K5_GENOMES),
        "contigs": (small_genome_params(),
                    [contigs.name(j) for j in range(K5_CONTIGS)],
                    [[(contigs, j)] for j in range(K5_CONTIGS)]),
        "main batch": genomes(K5_MAIN_GENOMES),
    }
    out = {}
    for name, (params, names, pieces) in cases.items():
        hb = ds._read_batch(names, pieces, params, time.perf_counter())
        batch = ds.upload_batch(hb, params, dev)
        scratch = ds.SlotScratch()
        got = ds.sketch_batch(batch, scratch)
        member, pref, keys = ds.reference_keys(batch)
        want = (member, pref,
                *ds.dedup_keys(keys, params.member_bits, batch.n_frags))
        torch.cuda.synchronize()
        err = max(_max_err(g, w) if g.shape == w.shape else -1
                  for g, w in zip(got, want))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"K5 != plain on the {name} batch")
        n_buckets = int(got[3].numel())
        member, pref, counts, _ = got
        slots = scratch.get(batch.n_slots, dev)
        kernel_ms = _time_ms(
            lambda: ds.launch_k5(batch, member, pref, counts, slots), 20)
        ms = _time_ms(lambda: ds.sketch_batch(batch, scratch), 10)
        plain_ms = _time_ms(lambda: ds.sketch_batch_reference(batch), 2)
        dedup_ms = _time_ms(
            lambda: ds.dedup_keys(keys, params.member_bits, batch.n_frags), 5)
        blocks, threads, smem, narrow = ds.k5_launch_shape(batch)
        bound_ms, bound_by = k5_profile.k5_bound(hb, params, n_buckets,
                                                 loops[narrow], clock_hz)
        log("sketch-kernel", f"K5 {name}: {len(names)} units, {hb.starts} "
                             f"k-mer starts, {batch.n_frags} fragments, "
                             f"{n_buckets} distinct fragment buckets: "
                             f"bit-exact; kernel {kernel_ms:.4f} ms (launch "
                             f"alone), product span {ms:.4f} ms (zeroed "
                             f"bitmaps, launch, bucket gather), plain "
                             f"{plain_ms:.4f} ms, replaced torch dedup "
                             f"{dedup_ms:.4f} ms; bound {bound_ms:.5f} ms by "
                             f"{bound_by} ({bound_ms / kernel_ms:.1%} of it); "
                             f"grid {blocks} x {threads} threads, "
                             f"{smem} B shared a block ("
                             f"{'narrow' if narrow else 'wide'} instance), "
                             f"tiles up to {batch.tile_cap} starts")
        out[name] = {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None, "product_ms": ms,
                     "replaced_dedup_ms": dedup_ms,
                     "shape": f"{len(names)} {name.split()[0]}, "
                              f"{hb.starts} starts"}
        del batch, scratch, got, want, member, pref, counts, keys, slots
        torch.cuda.empty_cache()
    return out["main batch"]


@contextlib.contextmanager
def _recording():
    """Record the devices the screen and verify ran on, the screen's
    candidate pairs and the verify results of one run."""
    import galah_tpu_torch.engines.native as native
    import galah_tpu_torch.ops.device_sketch as ds
    import galah_tpu_torch.ops.fragment_ani as fa
    import galah_tpu_torch.ops.pair_table as pt
    import galah_tpu_torch.ops.popcount_screen as pc
    import galah_tpu_torch.ops.prefilter as pf
    import galah_tpu_torch.parallel.distance as dist

    rec = {"screen_dev": set(), "verify_dev": set(), "tile_shapes": set(),
           "tiles": 0, "pairs": None, "verified": {}, "device_sketches": []}
    finish = pf.IncrementalPackedScreen.finish
    screens = ("screen_triangle_packed", "screen_triangle_popcount",
               "screen_rectangle_packed", "screen_triangle",
               "screen_rectangle")
    sharded = ("sharded_screen_triangle_packed",
               "sharded_screen_rectangle_packed",
               "sharded_screen_triangle_rowsharded",
               "sharded_screen_rectangle_rowsharded")
    orig = {
        (pf, "_containment"): pf._containment,
        (pc, "_containment"): pc._containment,
        (pt, "_pair_table_kernel"): pt._pair_table_kernel,
        (fa, "_forward_kernel"): fa._forward_kernel,
        (fa, "_forward_kernel_bt"): fa._forward_kernel_bt,
        (fa.FragmentAniEngine, "bidirectional"):
            fa.FragmentAniEngine.bidirectional,
        (ds, "sketch_host_batch"): ds.sketch_host_batch,
        (pf.IncrementalPackedScreen, "finish"): finish,
        **{(native, s): getattr(native, s) for s in screens},
        **{(dist, s): getattr(dist, s) for s in sharded},
    }

    def containment(fn):
        def run(counts, *a, **k):
            rec["screen_dev"].add(counts.device.type)
            rec["tile_shapes"].add(tuple(counts.shape))
            rec["tiles"] += 1
            return fn(counts, *a, **k)
        return run

    def pair_table_kernel(ustream, *a, **k):
        rec["verify_dev"].add(ustream.device.type)
        return orig[(pt, "_pair_table_kernel")](ustream, *a, **k)

    def forward_kernel(bitmaps, *a, **k):
        rec["verify_dev"].add(bitmaps.device.type)
        return orig[(fa, "_forward_kernel")](bitmaps, *a, **k)

    def forward_kernel_bt(table, *a, **k):
        rec["verify_dev"].add(table.device.type)
        return orig[(fa, "_forward_kernel_bt")](table, *a, **k)

    def screen(fn):
        def run(*a, **k):
            rec["pairs"] = fn(*a, **k)
            return rec["pairs"]
        return run

    def sketch_host_batch(*a, **k):
        sketches, dev = orig[(ds, "sketch_host_batch")](*a, **k)
        rec["device_sketches"] += sketches
        return sketches, dev

    def bidirectional(self, pairs, sketches_by_key):
        out = orig[(fa.FragmentAniEngine, "bidirectional")](
            self, pairs, sketches_by_key)
        rec["verified"].update(out)
        return out

    pf._containment = containment(orig[(pf, "_containment")])
    pc._containment = containment(orig[(pc, "_containment")])
    pt._pair_table_kernel = pair_table_kernel
    fa._forward_kernel = forward_kernel
    fa._forward_kernel_bt = forward_kernel_bt
    fa.FragmentAniEngine.bidirectional = bidirectional
    ds.sketch_host_batch = sketch_host_batch
    # The resident screen's pairs, whether its rows came at once or, with
    # the phases overlapped, batch by batch.
    pf.IncrementalPackedScreen.finish = screen(finish)
    for s in screens:
        setattr(native, s, screen(orig[(native, s)]))
    for s in sharded:
        setattr(dist, s, screen(orig[(dist, s)]))
    try:
        yield rec
    finally:
        for (owner, attr), fn in orig.items():
            setattr(owner, attr, fn)


def _launch_counters():
    from galah_tpu_torch.ops.device_sketch import sketch_batch
    from galah_tpu_torch.ops.packed_matmul import packed_intersect_counts
    from galah_tpu_torch.ops.popcount_screen import popcount_tile_counts

    return {"K1": packed_intersect_counts, "K2": popcount_tile_counts,
            "K5": sketch_batch}


def _run_cli(inputs, out_dir: str, tag: str, platform: str,
             screen: str | None = None, flags=(), env=None, expect_rc=0,
             devices=None):
    """One `cluster` run, with the environment variables `env` set for
    it; returns (wall, metrics, clusters.tsv bytes, recording, {kernel:
    launches in this run}). A run expected to fail (expect_rc != 0)
    returns None for the metrics and the clusters. `devices`, when
    given, are the run's shards (the subcommand called with them, as
    the CLI calls it with every local card); K1's launches by shard are
    then under "K1 by shard"."""
    import torch

    from galah_tpu_torch.cli.main import build_parser, main
    from galah_tpu_torch.cli.cluster_cmd import run_cluster

    tsv = os.path.join(out_dir, f"{tag}.tsv")
    mjson = os.path.join(out_dir, f"{tag}.json")
    argv = ["cluster", *inputs, "--ani", "95",
            "-t", str(min(8, os.cpu_count() or 1)),
            "--output-cluster-definition", tsv, "--metrics-json", mjson,
            "-q", *flags]
    os.environ["GALAH_TPU_PLATFORM"] = platform
    env = dict(env or {})
    if screen:
        env["GALAH_TPU_SCREEN"] = screen
    os.environ.update(env)
    counters = _launch_counters()
    try:
        for fn in counters.values():
            fn.launches = 0
        counters["K1"].per_shard.clear()
        torch.cuda.reset_peak_memory_stats()
        log(tag, f"device memory held before the run: "
                 f"{torch.cuda.memory_allocated() / 2**20:.0f} MiB")
        with _recording() as rec:
            t0 = time.perf_counter()
            if devices is None:
                rc = main(argv)
            else:
                rc = run_cluster(build_parser().parse_args(argv),
                                 devices) or 0
            wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        if devices is not None:
            launches["K1 by shard"] = dict(sorted(
                counters["K1"].per_shard.items()))
    finally:
        for var in env:
            os.environ.pop(var, None)
    check(rc == expect_rc, f"{tag}: cluster exited {rc}, want {expect_rc}")
    if rc:
        return wall, None, None, rec, launches
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


def _log_run(phase: str, wall: float, m: dict, launches: dict, rec,
             screened: bool = True, verified: bool = True) -> None:
    """Print a run's wall, phases, counters and launches, and check that
    its screen (unless not `screened`: every tile replayed, or no screen)
    and its verify (unless not `verified`) ran on the card."""
    import torch

    log(phase, f"wall {wall:.2f} s; phases {json.dumps(m['phases_s'])}")
    counters = m["counters"]
    log(phase, "counters " + json.dumps({
        k: counters.get(k) for k in (
            "genomes_sketched", "contigs_sketched", "sketch_bases",
            "screen_tiles", "screen_pairs_computed",
            "screen_rows_device_born", "screen_rows_host_uploaded",
            "phases_overlapped", "screen_rows_at_first_dispatch",
            "verify_directed_pairtable", "verify_directed_grouped",
            "verify_streams_uploaded", "stream_arena_resets", "clusters")
    }))
    resume = {k: counters[k] for k in (
        "screen_tiles_restored", "screen_host_row_bytes",
        "screen_host_row_upload_s", "verify_stream_upload_bytes",
        "verify_stream_upload_s", "sketch_bundle_read_s",
        "sketch_bundle_write_s") if k in counters}
    if resume:
        log(phase, "resume counters (host clock, s) " + json.dumps(resume))
    if "sketch_device_batches" in counters:
        log(phase, "sketch split (s; lengths is the first pass over the "
                   "files, read the second, on the read-ahead thread beside "
                   "the device work; read_wait the device side's wait for "
                   "it) " + json.dumps({
                       k: counters.get(f"sketch_{k}_s") for k in (
                           "lengths", "read", "read_wait", "upload", "kernel",
                           "unpack", "copy")
                   }) + f"; {int(counters['sketch_device_batches'])} "
                   f"batches, {int(counters['sketch_upload_bytes'])} bytes "
                   "uploaded")
    log(phase, f"kernel launches {json.dumps(launches)}; screen on "
               f"{sorted(rec['screen_dev'])}; verify on "
               f"{sorted(rec['verify_dev'])}; peak device memory "
               f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    check(rec["screen_dev"] == ({"cuda"} if screened else set()),
          f"screen ran on {rec['screen_dev']}")
    check(rec["verify_dev"] == ({"cuda"} if verified else set()),
          f"verify ran on {rec['verify_dev']}")


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


def _check_device_sketches(rec, want_fn, units, phase: str) -> None:
    """Every unit was sketched on the card, and each sketch equals the
    C++ sketcher's: want_fn() gives those, in `units` order."""
    import numpy as np

    got = {s.name: s for s in rec["device_sketches"]}
    check(sorted(got) == sorted(units),
          f"{phase}: {len(got)} device sketches for {len(units)} units")
    t0 = time.perf_counter()
    want = want_fn()
    host_s = time.perf_counter() - t0
    fields = ("prefilter_buckets", "member_buckets", "frag_offsets",
              "frag_buckets")
    for w in want:
        g = got[w.name]
        check(g.total_len == w.total_len and all(
            getattr(g, f).dtype == getattr(w, f).dtype
            and np.array_equal(getattr(g, f), getattr(w, f)) for f in fields),
            f"{phase}: the device sketch of {w.name} differs from the host's")
    log(phase, f"every device sketch ({len(want)}) equals the C++ sketcher's "
               f"(host sketcher, {min(8, os.cpu_count() or 1)} threads: "
               f"{host_s:.2f} s)")


def _check_overlapped(m: dict, phase: str) -> None:
    """The run overlapped its phases and verified device-born streams
    from the stream arena, uploading none and never resetting it."""
    c = m["counters"]
    check(c.get("phases_overlapped") == 1,
          f"{phase}: sketch, screen and verify did not overlap")
    check(not c.get("verify_streams_uploaded"),
          f"{phase}: verify uploaded {c.get('verify_streams_uploaded')} "
          "streams")
    check(not c.get("stream_arena_resets"),
          f"{phase}: the stream arena reset {c.get('stream_arena_resets')} "
          "times")


def phase_main_path(work: str, corpus: str, paths, fam_ids):
    """The packed path, sketching on the card; returns (launches,
    clusters.tsv bytes, candidate pairs)."""
    from concurrent.futures import ThreadPoolExecutor

    from galah_tpu_torch.sketch.fracminhash import sketch_file_native

    wall, m, clusters, rec, launches = _run_cli(
        ["-d", corpus, "-x", "fna"], work, "main", "gpu")
    _log_run("main", wall, m, launches, rec)
    n_clusters = _families_exact(clusters, paths, fam_ids)
    tiles = m["counters"]["screen_tiles"]
    check(n_clusters == MAIN_GENOMES[0],
          f"{n_clusters} clusters, want {MAIN_GENOMES[0]}")
    check(launches["K1"] >= tiles > 0,
          f"{launches['K1']} K1 launches for {tiles} tiles")
    check(launches["K5"] > 0, "K5 was never launched on the main path")
    check(m["counters"].get("screen_rows_device_born") == len(paths),
          "the screen matrix was not built from device-born rows")
    _check_overlapped(m, "main")
    params = rec["device_sketches"][0].params

    def host():
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
            return list(ex.map(lambda p: sketch_file_native(p, params),
                               paths))

    _check_device_sketches(rec, host, paths, "main")
    log("main", f"OK: {n_clusters} clusters, one per family")
    return launches, clusters, rec["pairs"]


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


def phase_reference(work: str, paths, fam_ids):
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
    return rec["pairs"]


def phase_low_memory(work: str, paths, fam_ids) -> None:
    """--low-memory over the first LOW_MEMORY_FAMILIES families, against
    a default run over the same genomes."""
    keep = [i for i, f in enumerate(fam_ids) if f < LOW_MEMORY_FAMILIES]
    sub_paths = [paths[i] for i in keep]
    sub_fams = [fam_ids[i] for i in keep]
    listing = os.path.join(work, "low_memory_genomes.txt")
    with open(listing, "w") as f:
        f.writelines(p + "\n" for p in sub_paths)
    inputs = ["--genome-fasta-list", listing]
    *_, default_tsv, _, _ = _run_cli(inputs, work, "low_memory_default", "gpu")
    wall, m, clusters, rec, launches = _run_cli(
        inputs, work, "low_memory", "gpu", flags=["--low-memory"])
    _log_run("low-memory", wall, m, launches, rec)
    check(launches["K1"] >= 1 and launches["K5"] >= 1,
          f"low-memory path launches {launches}")
    check(clusters == default_tsv, "--low-memory clusters.tsv differs")
    n_clusters = _families_exact(clusters, sub_paths, sub_fams)
    check(n_clusters == LOW_MEMORY_FAMILIES,
          f"{n_clusters} clusters, want {LOW_MEMORY_FAMILIES}")
    log("low-memory", f"OK: {len(sub_paths)} genomes, {n_clusters} clusters, "
                      "clusters.tsv identical to the default run")


def _indicator_product_times(bits: int, tiles: dict) -> dict:
    """The indicator screen's product in each dtype at the main path's
    tile (1024 x 1024 rows of `bits` uint8 0/1 bytes): exact counts
    (checked against a float64 product), CUDA-event ms, and its bound:
    both blocks read once and the float32 counts written once, against
    2 m n bits operations at the dtype's tensor-core peak (float32 at the
    CUDA cores' rate; TF32 stays off). Each dtype is one library call,
    which is its library_ms. tiles: {dtype: tiles on its main run}."""
    import torch

    from galah_tpu_torch.ops.prefilter import _indicator_counts

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    m = n = 1024
    x = (torch.rand((m, bits), generator=gen, device=dev) < 0.05).to(
        torch.uint8)
    y = (torch.rand((n, bits), generator=gen, device=dev) < 0.05).to(
        torch.uint8)
    want = x.to(torch.float64) @ y.to(torch.float64).t()
    out = {}
    for dtype, peak in INDICATOR_PEAKS.items():
        counts = _indicator_counts(dtype)
        got = counts(x, y)
        torch.cuda.synchronize()
        err = float((got.to(torch.float64) - want).abs().max())
        check(err == 0, f"indicator product {dtype}: counts differ by {err}")
        ms = _time_ms(lambda: counts(x, y), 20)
        bound_ms, bound_by = _bound_ms((m + n) * bits + 4 * m * n,
                                       2 * m * n * bits, peak)
        out[dtype] = {"ms": ms, "max_abs_err": err, "launches": tiles[dtype],
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": ms, "shape": f"{m}x{n}x{bits} u8"}
        log("indicator", f"product {dtype} at {m}x{n}x{bits}: {ms:.4f} ms, "
                         f"bound {bound_ms:.4f} ms ({bound_by}), exact; "
                         f"{nvidia_smi_line()}")
    del x, y, want
    torch.cuda.empty_cache()
    return out


def phase_indicator(work: str, corpus: str, paths, fam_ids, main_pairs,
                    main_tsv: bytes, ref_pairs) -> dict:
    """GALAH_TPU_SCREEN=indicator under each GALAH_TPU_SCREEN_DTYPE on
    the main corpus must give phase 5's candidate pairs and ANI bit for
    bit and its clusters.tsv, and in reference mode phase 7's pairs,
    with K1 never launched; then the product's times by dtype. Returns
    {dtype: product numbers}."""
    import numpy as np

    _, ref_inputs = _reference_inputs(work, "indicator_reference", paths,
                                      fam_ids)
    want_main = _sorted_pairs(main_pairs)
    want_ref = _sorted_pairs(ref_pairs)
    tiles = {}
    for dtype in INDICATOR_PEAKS:
        env = {"GALAH_TPU_SCREEN_DTYPE": dtype}
        for tag, inputs, want in (("main", ["-d", corpus, "-x", "fna"],
                                   want_main),
                                  ("reference", ref_inputs, want_ref)):
            wall, m, clusters, rec, launches = _run_cli(
                inputs, work, f"indicator_{tag}_{dtype}", "gpu",
                screen="indicator", env=env)
            _log_run(f"indicator-{tag}-{dtype}", wall, m, launches, rec)
            got = _sorted_pairs(rec["pairs"])
            check(np.array_equal(got[0], want[0])
                  and np.array_equal(got[1].view(np.int32),
                                     want[1].view(np.int32)),
                  f"indicator {tag} {dtype}: candidate pairs or ANI differ "
                  f"from the packed screen's ({len(got[0])} against "
                  f"{len(want[0])})")
            check(launches["K1"] == 0 and launches["K5"] > 0,
                  f"indicator {tag} {dtype}: launches {launches}")
            if tag == "main":
                check(clusters == main_tsv,
                      f"indicator {dtype}: clusters.tsv differs from phase 5's")
                tiles[dtype] = rec["tiles"]
                bits = rec["device_sketches"][0].params.prefilter_bits
            n = _families_exact(clusters, paths, fam_ids)
            check(n == MAIN_GENOMES[0], f"indicator {tag} {dtype}: {n} clusters")
            log("indicator", f"{tag} {dtype} OK: {len(got[0])} pairs and ANI "
                             f"bit for bit, {n} clusters; wall {wall:.2f} s, "
                             f"screen {m['phases_s'].get('screen', 0):.4f} s; "
                             f"{nvidia_smi_line()}")
    return _indicator_product_times(bits, tiles)


def make_contig_corpus(work: str, shape, tag: str):
    """One FASTA of `shape` (families, members) 5 kb contigs."""
    from galah_tpu_torch.utils.synth import make_contig_corpus as make

    path = os.path.join(work, f"{tag}.fna")
    t0 = time.perf_counter()
    names, fams = make(path, *shape, contig_length=CONTIG_LENGTH,
                       within_ani=0.98, seed=CONTIG_SEED)
    log(tag, f"corpus {len(names)} contigs x {CONTIG_LENGTH} bp made in "
             f"{time.perf_counter() - t0:.1f} s")
    return path, names, fams


def _contig_inputs(path: str):
    return ["-f", path, "--cluster-contigs", "--small-contigs"]


def _sorted_pairs(res):
    import numpy as np

    o = np.lexsort((res.pairs[:, 1], res.pairs[:, 0]))
    return res.pairs[o], res.ani_est[o]


def phase_contig_path(work: str, path: str, names, fams):
    """--cluster-contigs --small-contigs over the contig corpus, with the
    phases overlapped, then with GALAH_TPU_PIPELINE=0; returns the
    overlapped run's launches, clusters.tsv bytes, tiles and candidate
    pairs with their ANI (sorted by pair)."""
    import numpy as np

    from galah_tpu_torch.sketch.fracminhash import sketch_contigs_native

    wall, m, clusters, rec, launches = _run_cli(
        _contig_inputs(path), work, "contigs", "gpu")
    _log_run("contigs", wall, m, launches, rec)
    _check_overlapped(m, "contigs")
    first = m["counters"].get("screen_rows_at_first_dispatch")
    log("contigs", f"first screen tile issued after {first} of "
                   f"{len(names)} rows")
    check(first is not None and first < len(names),
          "the screen waited for the whole corpus")
    n_clusters = _families_exact(clusters, names, fams)
    check(n_clusters == CONTIG_CORPUS[0],
          f"{n_clusters} clusters, want {CONTIG_CORPUS[0]}")
    tiles = m["counters"]["screen_tiles"]
    check(launches["K1"] >= tiles > 0 and launches["K5"] > 0,
          f"contig path launches {launches} for {tiles} tiles")
    check(m["counters"].get("screen_rows_device_born") == len(names),
          "the screen matrix was not built from device-born rows")
    params = rec["device_sketches"][0].params
    _check_device_sketches(
        rec, lambda: sketch_contigs_native(
            path, params, threads=min(8, os.cpu_count() or 1)),
        names, "contigs")
    log("contigs", f"OK: {n_clusters} clusters, one per family; {tiles} "
                   f"tiles, K1 {launches['K1']}, K5 {launches['K5']}")
    seq_wall, seq_m, seq_clusters, seq_rec, seq_launches = _run_cli(
        _contig_inputs(path), work, "contigs_sequential", "gpu",
        env={"GALAH_TPU_PIPELINE": "0"})
    _log_run("contigs-sequential", seq_wall, seq_m, seq_launches, seq_rec)
    check("phases_overlapped" not in seq_m["counters"],
          "GALAH_TPU_PIPELINE=0 still overlapped the phases")
    check(seq_clusters == clusters,
          "the sequential run's clusters.tsv differs from the overlapped one")
    (pp, pa), (sp, sa) = (_sorted_pairs(rec["pairs"]),
                          _sorted_pairs(seq_rec["pairs"]))
    check(np.array_equal(pp, sp) and np.array_equal(pa, sa),
          "the sequential run's candidate pairs differ")
    check(seq_launches["K1"] == launches["K1"],
          f"K1 launches {seq_launches['K1']} sequential, {launches['K1']} "
          "overlapped")
    log("contigs", f"OK: GALAH_TPU_PIPELINE=0 gives the same {len(pp)} "
                   f"candidate pairs and clusters.tsv; wall {wall:.2f} s "
                   f"overlapped, {seq_wall:.2f} s sequential")
    return launches, clusters, int(tiles), (pp, pa)


def _logged_tiles(path: str) -> int:
    """Tiles held by a sweep checkpoint, read with the fingerprint its
    header records."""
    import struct

    from galah_tpu_torch.ops.sweep_checkpoint import _MAGIC, SweepCheckpoint

    with open(path, "rb") as f:
        check(f.read(len(_MAGIC)) == _MAGIC, f"{path} is not a sweep log")
        (n,) = struct.unpack("<i", f.read(4))
        fingerprint = json.loads(f.read(n))
    log_ = SweepCheckpoint(path, fingerprint)
    try:
        return len(log_)
    finally:
        log_.close()


@contextlib.contextmanager
def _crash_after(tiles: int):
    """Make the screen raise when it issues tile tiles + 1 (K1's wrapper,
    as the prefilter module calls it, is wrapped; the tiles before it
    launch K1 as usual)."""
    import galah_tpu_torch.ops.prefilter as pf

    real = pf.packed_intersect_counts
    issued = {"n": 0}

    def crashing(a, b, **kw):
        issued["n"] += 1
        if issued["n"] > tiles:
            raise RuntimeError(f"injected crash at screen tile {tiles + 1}")
        return real(a, b, **kw)

    pf.packed_intersect_counts = crashing
    try:
        yield
    finally:
        pf.packed_intersect_counts = real


def phase_resume(work: str) -> dict:
    """The resume artifacts on the contig corpus's shape cut to
    RESUME_CORPUS (the full corpus's bundle write alone took ~3 min):
    a default run first, then (a) a run with --sweep-checkpoint C
    --sketch-directory D --output-distance-cache X killed in-process
    after RESUME_CRASH_TILES screen tiles; (b) the same flags without
    the crash; (c) D alone; (d) D and the complete C; (e) X. Each run's
    clusters.tsv must be the default run's, with the launches each must
    make. Returns {run: launches}."""
    from galah_tpu_torch.ops.prefilter import _pipeline_window

    path, names, fams = make_contig_corpus(work, RESUME_CORPUS,
                                           "resume_contigs")
    wall, m, contig_tsv, _, launches = _run_cli(
        _contig_inputs(path), work, "resume_default", "gpu")
    contig_tiles = int(m["counters"]["screen_tiles"])
    n = _families_exact(contig_tsv, names, fams)
    check(n == RESUME_CORPUS[0] and launches["K1"] == contig_tiles,
          f"resume corpus: {n} clusters, K1 {launches['K1']} for "
          f"{contig_tiles} tiles")
    log("resume", f"default run: {len(names)} contigs, {n} clusters, "
                  f"{contig_tiles} tiles; wall {wall:.2f} s")
    out = {"default": launches}
    ckpt, sk_dir = os.path.join(work, "resume.ckpt"), os.path.join(
        work, "resume_sketches")
    cache = os.path.join(work, "resume_distances.npz")
    full = ["--sweep-checkpoint", ckpt, "--sketch-directory", sk_dir,
            "--output-distance-cache", cache]
    with _crash_after(RESUME_CRASH_TILES):
        wall, _, _, _, launches = _run_cli(
            _contig_inputs(path), work, "resume_a", "gpu", flags=full,
            expect_rc=1)
    logged = _logged_tiles(ckpt)
    log("resume", f"(a) killed after {launches['K1']} K1 launches in "
                  f"{wall:.2f} s; the log holds {logged} tiles "
                  f"({os.path.getsize(ckpt)} bytes)")
    check(launches["K1"] == RESUME_CRASH_TILES,
          f"(a) launched K1 {launches['K1']} times")
    check(launches["K1"] - _pipeline_window() <= logged <= launches["K1"],
          f"(a) logged {logged} of {launches['K1']} issued tiles")
    out["a"] = launches
    runs = (
        ("b", full, contig_tiles - logged, None),
        ("c", ["--sketch-directory", sk_dir], contig_tiles, 0),
        ("d", ["--sketch-directory", sk_dir, "--sweep-checkpoint", ckpt],
         0, 0),
        ("e", ["--input-distance-cache", cache], 0, 0),
    )
    for tag, flags, k1, k5 in runs:
        wall, m, clusters, rec, launches = _run_cli(
            _contig_inputs(path), work, f"resume_{tag}", "gpu", flags=flags)
        _log_run(f"resume-{tag}", wall, m, launches, rec, screened=k1 > 0,
                 verified=tag != "e")
        check(clusters == contig_tsv,
              f"({tag}) clusters.tsv differs from the default run's")
        check(launches["K1"] == k1,
              f"({tag}) launched K1 {launches['K1']} times, want {k1}")
        check(k5 is None and launches["K5"] > 0 or launches["K5"] == k5,
              f"({tag}) launched K5 {launches['K5']} times")
        c = m["counters"]
        if tag == "b":
            bundles = os.listdir(sk_dir)
            check(len(bundles) == 1, f"(b) wrote {bundles} to the directory")
            size = os.path.getsize(os.path.join(sk_dir, bundles[0]))
            log("resume", f"(b) bundle of {len(names)} contigs written in "
                          f"{c['sketch_bundle_write_s']:.2f} s, {size} bytes; "
                          f"distance cache {os.path.getsize(cache)} bytes")
        if tag in ("c", "d"):
            check(c.get("screen_rows_host_uploaded") == len(names)
                  and c.get("verify_streams_uploaded", 0) > 0,
                  f"({tag}) rows or streams were not uploaded from the host")
            log("resume", f"({tag}) bundle read in "
                          f"{c['sketch_bundle_read_s']:.2f} s; rows "
                          f"{int(c['screen_host_row_bytes'])} bytes uploaded "
                          f"in {c['screen_host_row_upload_s']:.3f} s, verify "
                          f"streams {int(c['verify_stream_upload_bytes'])} "
                          f"bytes in {c['verify_stream_upload_s']:.3f} s")
        log("resume", f"({tag}) OK: clusters.tsv identical to the default "
                      f"run's; K1 "
                      f"{launches['K1']}, K5 {launches['K5']}; wall "
                      f"{wall:.2f} s")
        out[tag] = launches
    return out


def _annotation_inputs(work: str, paths):
    """A synthetic CheckM2 report and barrnap/tRNAscan-SE output lists
    for `paths`: member m of a family has completeness 60 + 4 m, so the
    last member is each family's best. Returns the process flags."""
    d = os.path.join(work, "annotations")
    os.makedirs(d)
    aas = ("Ala Arg Asn Asp Cys Gln Glu Gly His Ile Leu Lys Met Phe Pro "
           "Ser Thr Trp Tyr Val").split()
    report = os.path.join(d, "quality_report.tsv")
    gffs, trnas = os.path.join(d, "gffs.tsv"), os.path.join(d, "trnas.tsv")
    with open(report, "w") as q, open(gffs, "w") as g, open(trnas, "w") as t:
        q.write("Name\tCompleteness\tContamination\tModel\n")
        for i, p in enumerate(paths):
            stem = os.path.splitext(os.path.basename(p))[0]
            member = int(stem.rsplit("_m", 1)[1])
            q.write(f"{stem}\t{60 + 4 * member}\t1.0\tGB\n")
            gff, out = (os.path.join(d, f"{stem}.gff"),
                        os.path.join(d, f"{stem}.trna"))
            with open(gff, "w") as f:
                f.write("##gff-version 3\n" + "".join(
                    f"c1\tbarrnap\trRNA\t1\t9\t0\t+\t.\tName={r}_rRNA\n"
                    for r in ("5S", "16S", "23S")[:1 + i % 3]))
            with open(out, "w") as f:
                f.write("h\nh\nh\n" + "".join(
                    f"c1\t{j}\t1\t70\t{aa}\tNNN\t0\t0\t50.0\n"
                    for j, aa in enumerate(aas[:10 + i % 11])))
            g.write(f"{p}\t{gff}\n")
            t.write(f"{p}\t{out}\n")
    return ["--checkm2-quality-report", report, "--barrnap-gff-list", gffs,
            "--trnascan-out-list", trnas]


def _run_surface(tag: str, fn):
    """fn() with every kernel's count set to 0 just before and read just
    after; (wall, its result, recording, {kernel: launches})."""
    counters = _launch_counters()
    for k in counters.values():
        k.launches = 0
    with _recording() as rec:
        t0 = time.perf_counter()
        res = fn()
        wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    log("surface", f"{tag}: wall {wall:.2f} s; kernel launches "
                   f"{json.dumps(launches)}; verify on "
                   f"{sorted(rec['verify_dev'])}")
    check(rec["verify_dev"] == {"cuda"}, f"{tag}: verify ran on "
                                         f"{rec['verify_dev']}")
    return wall, res, rec, launches


def phase_surface(work: str, corpus: str, paths, fam_ids,
                  main_tsv: bytes) -> None:
    """The rest of the port's surface on the main corpus: `process` with
    a synthetic CheckM2 report and precomputed barrnap/tRNAscan-SE lists,
    the API's cluster_genomes on the card, `cluster-validate` over the
    main path's clusters.tsv, and --precluster-method finch
    --cluster-method native over the first LOW_MEMORY_FAMILIES families.
    Each must find the families."""
    import torch

    from galah_tpu_torch import api
    from galah_tpu_torch.cli.main import build_parser, main
    from galah_tpu_torch.cli.validate_cmd import run_validate

    os.environ["GALAH_TPU_PLATFORM"] = "gpu"
    threads = str(min(8, os.cpu_count() or 1))
    flags = _annotation_inputs(work, paths)
    mimag, tsv = (os.path.join(work, "process_mimag.tsv"),
                  os.path.join(work, "process.tsv"))
    _, rc, _, launches = _run_surface("process", lambda: main([
        "process", "-d", corpus, "-x", "fna", "--ani", "95", "-t", threads,
        "--output-mimag-summary", mimag, "--output-cluster-definition", tsv,
        "-q", *flags]))
    check(rc == 0, f"process exited {rc}")
    check(launches["K1"] > 0 and launches["K5"] > 0,
          f"process launches {launches}")
    with open(tsv, "rb") as f:
        clusters = f.read()
    n = _families_exact(clusters, paths, fam_ids)
    check(n == MAIN_GENOMES[0], f"process: {n} clusters")
    best = f"_m{MAIN_GENOMES[1] - 1}.fna"
    check(all(rep.endswith(best) for rep in _members(clusters)),
          "process: a representative is not its family's best genome")
    with open(mimag) as f:
        rows = f.read().splitlines()[1:]
    tiers = sorted({r.split("\t")[-1] for r in rows})
    check(len(rows) == len(paths), f"process: {len(rows)} MIMAG rows")
    log("surface", f"process OK: {n} clusters, each represented by its "
                   f"family's best genome; MIMAG tiers {tiers}")

    _, res, _, launches = _run_surface("api", lambda: api.cluster_genomes(
        paths, api.ClusterParameters(ani=95, threads=int(threads)),
        device=torch.device("cuda", 0)))
    check(launches["K1"] > 0 and launches["K5"] > 0,
          f"api launches {launches}")
    n = _families_exact("".join(f"{r}\t{m}\n" for c in res.memberships()
                                for r in c[:1] for m in c).encode(),
                        paths, fam_ids)
    check(n == MAIN_GENOMES[0], f"api: {n} clusters")
    log("surface", f"api OK: cluster_genomes on the card, {n} clusters")

    main_file = os.path.join(work, "main.tsv")
    with open(main_file, "rb") as f:
        check(f.read() == main_tsv, "the main path's clusters.tsv changed")
    args = build_parser().parse_args([
        "cluster-validate", "--cluster-file", main_file, "--ani", "95",
        "--min-aligned-fraction", "15", "-t", threads, "-q"])
    _, problems, _, _ = _run_surface("cluster-validate",
                                     lambda: run_validate(args))
    check(problems == 0, f"cluster-validate found {problems} problems")
    log("surface", "cluster-validate OK: no problems in the main path's "
                   "clusters.tsv")

    keep = [i for i, f in enumerate(fam_ids) if f < LOW_MEMORY_FAMILIES]
    sub_paths = [paths[i] for i in keep]
    listing = os.path.join(work, "finch_genomes.txt")
    with open(listing, "w") as f:
        f.writelines(p + "\n" for p in sub_paths)
    wall, m, clusters, rec, launches = _run_cli(
        ["--genome-fasta-list", listing], work, "finch", "gpu",
        flags=["--precluster-method", "finch", "--cluster-method", "native"])
    check(rec["verify_dev"] == {"cuda"},
          f"finch: verify on {rec['verify_dev']}")
    n = _families_exact(clusters, sub_paths, [fam_ids[i] for i in keep])
    check(n == LOW_MEMORY_FAMILIES, f"finch: {n} clusters")
    log("surface", f"finch OK: {len(sub_paths)} genomes, {n} clusters, "
                   f"verify on the card; wall {wall:.2f} s, phases "
                   f"{json.dumps(m['phases_s'])}; kernel launches "
                   f"{json.dumps(launches)}")


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

    contig_path, contig_names, contig_fams = make_contig_corpus(
        work, PARITY_CONTIGS, "parity_contigs")
    for mode, inputs, screen, flags in (
        ("packed", dir_inputs, None, ()),
        ("popcount", dir_inputs, "popcount", ()),
        ("reference", ref_inputs, None, ()),
        ("low-memory", dir_inputs, None, ("--low-memory",)),
        ("contigs", _contig_inputs(contig_path), None, ()),
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
        pc, ac = _sorted_pairs(rec_c["pairs"])
        pg, ag = _sorted_pairs(rec_g["pairs"])
        check(np.array_equal(pc, pg), f"{mode}: candidate pairs differ")
        check(np.array_equal(ac, ag), f"{mode}: screen ANI differs")
        vc, vg = rec_c["verified"], rec_g["verified"]
        check(vc.keys() == vg.keys(), f"{mode}: verified pair sets differ")
        dani = max(abs(vc[k][0] - vg[k][0]) for k in vc) if vc else 0.0
        check(dani <= ANI_TOL, f"{mode}: verify ANI differs by {dani}")
        check(all(vc[k][1:] == vg[k][1:] for k in vc),
              f"{mode}: verify AF differs")
        check(tsv_c == tsv_g, f"{mode}: clusters.tsv differs CPU vs GPU")
        check(not rec_c["device_sketches"] and rec_g["device_sketches"],
              f"{mode}: the CPU run must sketch on the host, the GPU run "
              "on the card")
        n_clusters = (_families_exact(tsv_g, contig_names, contig_fams)
                      if mode == "contigs"
                      else _families_exact(tsv_g, paths, fam_ids))
        log("parity", f"{mode} OK: {len(pc)} candidate pairs, {len(vc)} "
                      f"verified, max |dANI| {dani:.3g}, AF equal, "
                      f"clusters.tsv identical ({n_clusters} clusters); "
                      f"CPU {wall_c:.2f} s, GPU {wall_g:.2f} s")


@contextlib.contextmanager
def _one_card():
    """The single-device phases on cuda:0 on a machine with several
    cards: every entry point that resolves the local devices (the CLI,
    the API, process) gets the first of them only, so the runs take the
    single-device path their checks expect. A no-op with one card."""
    import torch

    from galah_tpu_torch.utils import device

    if torch.cuda.device_count() < 2:
        yield
        return
    real = device.resolve_devices
    device.resolve_devices = lambda platform=None: real(platform)[:1]
    try:
        yield
    finally:
        device.resolve_devices = real


def _ranks() -> int:
    """Phase 15's processes: one a card, or RANKS on one card."""
    import torch

    n = torch.cuda.device_count()
    return n if n > 1 else RANKS


def _shard_devices():
    """Phase 14's shards: every visible card, or two shards on cuda:0
    when there is one."""
    import torch

    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)] if n > 1 else [
        torch.device("cuda", 0)] * 2


def phase_shards(work: str, contig_path: str, contig_names, contig_fams,
                 contig_pairs, contig_tsv: bytes, contig_tiles: int,
                 paths, fam_ids, ref_pairs) -> dict:
    """The contig path over the shards: the sharded triangle (and under
    GALAH_TPU_ROWSHARD=1 the row-sharded one) must give phase 9's
    candidate pairs and ANI bit for bit, its clusters.tsv, and K1
    launches by shard that sum to phase 9's tiles; the reference mode
    over the shards must give phase 7's pairs. Returns {run: K1 by
    shard}."""
    import numpy as np

    devices = _shard_devices()
    log("shards", f"{len(devices)} shards on {[str(d) for d in devices]}; "
                  f"{nvidia_smi_line()}")
    out = {}
    for tag, env in (("sharded", {}),
                     ("rowsharded", {"GALAH_TPU_ROWSHARD": "1"})):
        wall, m, clusters, rec, launches = _run_cli(
            _contig_inputs(contig_path), work, f"shards_{tag}", "gpu",
            env=env, devices=devices)
        _log_run(f"shards-{tag}", wall, m, launches, rec)
        by_shard = launches["K1 by shard"]
        dense = int(m["counters"].get("screen_rowshard_dense_tiles", 0))
        log("shards", f"{tag}: K1 by shard {json.dumps(by_shard)}; tiles "
                      f"decided on their bfloat16 containment by the "
                      f"row-sharded stream rule: {dense}")
        check(sorted(by_shard) == list(range(len(devices)))
              and sum(by_shard.values()) == launches["K1"] == contig_tiles,
              f"{tag}: K1 by shard {by_shard}, {launches['K1']} in all, "
              f"phase 9 had {contig_tiles} tiles")
        check("phases_overlapped" not in m["counters"],
              f"{tag}: the phases overlapped over several shards")
        pp, pa = _sorted_pairs(rec["pairs"])
        check(np.array_equal(pp, contig_pairs[0]),
              f"{tag}: candidate pairs differ from phase 9's")
        check(np.array_equal(pa.view(np.int32),
                             contig_pairs[1].view(np.int32)),
              f"{tag}: screen ANI differs from phase 9's ({dense} dense "
              "tiles)")
        check(clusters == contig_tsv,
              f"{tag}: clusters.tsv differs from phase 9's")
        _families_exact(clusters, contig_names, contig_fams)
        log("shards", f"{tag} OK: phase 9's {len(pp)} candidate pairs and "
                      f"ANI bit for bit, its clusters.tsv; wall {wall:.2f} s")
        out[tag] = by_shard
    _, inputs = _reference_inputs(work, "shards_reference", paths, fam_ids)
    wall, m, clusters, rec, launches = _run_cli(
        inputs, work, "shards_reference", "gpu", devices=devices)
    _log_run("shards-reference", wall, m, launches, rec)
    got = rec["pairs"]
    check(np.array_equal(got.pairs, ref_pairs.pairs)
          and np.array_equal(got.ani_est.view(np.int32),
                             ref_pairs.ani_est.view(np.int32)),
          "the sharded rectangle's pairs differ from phase 7's")
    n = _families_exact(clusters, paths, fam_ids)
    check(n == MAIN_GENOMES[0], f"sharded reference: {n} clusters")
    log("shards", f"reference OK: phase 7's {len(got.pairs)} pairs and ANI "
                  f"bit for bit, {n} clusters; K1 by shard "
                  f"{json.dumps(launches['K1 by shard'])}; wall {wall:.2f} s")
    out["reference"] = launches["K1 by shard"]
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_processes(work: str, corpus: str, paths, fam_ids, main_tsv: bytes,
                    contig_path: str, contig_names, contig_fams,
                    contig_tsv: bytes, contig_tiles: int) -> dict:
    """This script again as _ranks() processes joined by gloo on
    localhost (one card a rank, or RANKS on cuda:0 with one card), each
    running the API on the main corpus (cluster_genomes) and on the
    contig corpus (cluster_contigs). Each rank's clusters.tsv must be
    phase 5's and phase 9's; each rank sketches its share of the genomes
    through K5 and every contig; the ranks' K1 launches on the contig
    corpus sum to phase 9's tiles. A rank that fails, or the time limit,
    fails the phase (every rank is killed). Returns each rank's
    report."""
    import torch

    torch.cuda.empty_cache()
    n_cards = torch.cuda.device_count()
    ranks = _ranks()
    port = str(_free_port())
    t0 = time.perf_counter()
    procs, logs = [], []
    for rank in range(ranks):
        env = dict(os.environ)
        env.pop("GALAH_TPU_PLATFORM", None)
        if n_cards > 1:
            env["CUDA_VISIBLE_DEVICES"] = str(rank % n_cards)
        logs.append(open(os.path.join(work, f"rank{rank}.log"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--rank",
             str(rank), "--ranks", str(ranks), "--port", port, "--work",
             work, "--corpus", corpus, "--contigs", contig_path],
            stdout=logs[-1], stderr=subprocess.STDOUT, env=env))
    try:
        for rank, p in enumerate(procs):
            left = RANK_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                rc = p.wait(timeout=max(1.0, left))
            except subprocess.TimeoutExpired:
                rc = None
            logs[rank].seek(0)
            tail = logs[rank].read()[-4000:]
            check(rc == 0, f"rank {rank} exited {rc}:\n{tail}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    reports = []
    for rank in range(ranks):
        with open(os.path.join(work, f"rank{rank}.json")) as f:
            reports.append(json.load(f))
    for r in reports:
        log("processes", f"rank {r['rank']}: " + json.dumps(
            {k: v for k, v in r.items() if not k.endswith("_tsv")}))
    for r in reports:
        check(r["main_tsv"] == main_tsv.decode(),
              f"rank {r['rank']}: cluster_genomes' clusters.tsv differs "
              "from phase 5's")
        check(r["contigs_tsv"] == contig_tsv.decode(),
              f"rank {r['rank']}: cluster_contigs' clusters.tsv differs "
              "from phase 9's")
        check(r["main"]["genomes_sketched"] == len(paths) // ranks
              and r["main"]["launches"]["K5"] > 0,
              f"rank {r['rank']}: sketched {r['main']['genomes_sketched']} "
              f"genomes, K5 {r['main']['launches']['K5']}")
        check(r["contigs"]["contigs_sketched"] == len(contig_names),
              f"rank {r['rank']}: sketched {r['contigs']['contigs_sketched']}"
              " contigs")
    main_k1 = [r["main"]["launches"]["K1"] for r in reports]
    contig_k1 = [r["contigs"]["launches"]["K1"] for r in reports]
    check(sorted(main_k1) == [0] * (ranks - 1) + [1],
          f"main corpus K1 by rank {main_k1}, want one launch in all")
    check(sum(contig_k1) == contig_tiles and min(contig_k1) > 0,
          f"contig corpus K1 by rank {contig_k1}, phase 9 had "
          f"{contig_tiles} tiles")
    log("processes", f"OK: {ranks} ranks, phase 5's and phase 9's "
                     f"clusters.tsv on every rank; K1 by rank {main_k1} "
                     f"(main) and {contig_k1} (contigs); wall {wall:.2f} s "
                     "from start to the last rank's exit")
    return {"wall_s": wall, "reports": reports}


def _grouped_verify_times(sketches) -> dict:
    """The grouped verify's two gathers on the card for the first
    sketch's stream against R = GROUPED_REFS references: the corpus's
    member bitmaps, then random ones (R distinct bitmaps, as R
    representatives would be). Each width: word and bt
    bit-identical, CUDA-event ms of each kernel and of the table build,
    the rows and bytes each gathers, the function's byte bound (stream,
    offsets and bitmaps read once, results written once) and its
    gathers priced at the probe's row rates. Returns {R: numbers}."""
    import numpy as np
    import torch

    from galah_tpu_torch.ops import fragment_ani as fa

    dev = torch.device("cuda", 0)
    q = sketches[0]
    bits = q.params.member_bits
    w = bits // 32
    b = torch.from_numpy(np.asarray(q.frag_buckets, np.int32)).to(dev)
    o = torch.from_numpy(np.asarray(q.frag_offsets, np.int32)).to(dev)
    n, f = b.numel(), o.numel() - 1
    real = np.stack([s.member_bitmap_words() for s in sketches])
    rmax = max(GROUPED_REFS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    stack = torch.zeros((rmax, w), dtype=torch.int32, device=dev)
    stack[:len(real)] = torch.from_numpy(real.view(np.int32)).to(dev)
    stack[len(real):] = _random_words(rmax - len(real), w, 0.25, gen, dev)
    pc = torch.full((rmax,), bits / 4, dtype=torch.float32, device=dev)
    pc[:len(real)] = torch.tensor([s.member_popcount for s in sketches],
                                  dtype=torch.float32)
    cfg = fa.FragmentAniConfig(k=q.params.k, member_bits=bits,
                               min_fragment_hashes=q.params.min_fragment_hashes)
    kw = dict(bits=bits, k=cfg.k, min_hashes=cfg.min_fragment_hashes,
              min_ident=cfg.min_fragment_identity)
    smi = nvidia_smi_line()
    out = {}
    for r in GROUPED_REFS:
        rows = torch.arange(r, device=dev)
        rpad = max(32, 1 << (r - 1).bit_length())
        padded = torch.cat([stack[:r], stack.new_zeros((rpad - r, w))])
        word = fa._forward_kernel(stack, rows, pc[:r], b, o, **kw)
        table = fa._bit_transpose_table(padded)
        bt = fa._forward_kernel_bt(table, pc[:r], b, o, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(word, bt)),
              f"grouped verify at R={r}: word and bt differ")
        word_ms = _time_ms(lambda: fa._forward_kernel(
            stack, rows, pc[:r], b, o, **kw), 10)
        bt_ms = _time_ms(lambda: fa._forward_kernel_bt(
            table, pc[:r], b, o, **kw), 10)
        table_ms = _time_ms(lambda: fa._bit_transpose_table(padded), 10)
        fn_bytes = 4 * (n + f + 1 + r * w + r + 2 * r)
        bound_ms, bound_by = _bound_ms(fn_bytes, r * n, INT_ALU_OPS_PER_S)
        rec = {"refs": r, "stream_hashes": n, "fragments": f,
               "word_ms": word_ms, "bt_ms": bt_ms, "bt_table_ms": table_ms,
               "word_rows": r * n, "word_bytes": 4 * r * n,
               "bt_rows": n, "bt_bytes": 4 * (rpad // 32) * n,
               "bound_ms": bound_ms, "bound_by": bound_by}
        for order, rate in PROBE_ROWS_PER_S.items():
            rec[f"word_gather_ms_{order}"] = r * n / rate * 1e3
            rec[f"bt_gather_ms_{order}"] = n / rate * 1e3
        out[r] = rec
        log("large", f"grouped verify R={r} on {n} hashes ({f} fragments): "
                     f"word {word_ms:.4f} ms ({r * n} rows, {4 * r * n} "
                     f"bytes gathered; {rec['word_gather_ms_ascending']:.4f} "
                     f"/ {rec['word_gather_ms_random']:.4f} ms at the probe's "
                     f"ascending / random row rate), bt {bt_ms:.4f} ms "
                     f"({n} rows, {rec['bt_bytes']} bytes; "
                     f"{rec['bt_gather_ms_ascending']:.4f} / "
                     f"{rec['bt_gather_ms_random']:.4f} ms) + table "
                     f"{table_ms:.4f} ms; bound {bound_ms:.4f} ms "
                     f"({bound_by}); bit-identical; {smi}")
        del word, bt, table, padded
    del stack
    torch.cuda.empty_cache()
    return out


def phase_large_genomes(work: str) -> dict:
    """`cluster` over LARGE_GENOMES families of LARGE_LENGTH genomes,
    three times: GALAH_TPU_VERIFY_GATHER=word, =bt and unset (words).
    Every fragment stream must exceed GROUPED_MIN_HASHES (checked first,
    on the first run's device sketches), every verify must take the
    grouped path, each run must find the families, and the three runs'
    clusters.tsv, ANI and AF must be bit-identical; then the grouped
    verify's times by width. Returns {"runs": {tag: counters},
    "grouped": {R: numbers}}."""
    import numpy as np

    from galah_tpu_torch.utils.synth import make_families

    nfam, nmem = LARGE_GENOMES
    corpus = os.path.join(work, "large")
    t0 = time.perf_counter()
    paths, fam_ids = make_families(corpus, nfam, nmem,
                                   genome_length=LARGE_LENGTH,
                                   within_ani=0.98, seed=LARGE_SEED)
    log("large", f"corpus {len(paths)} x {LARGE_LENGTH} bp made in "
                 f"{time.perf_counter() - t0:.1f} s")
    runs, first = {}, None
    for tag, env in (("word", {"GALAH_TPU_VERIFY_GATHER": "word"}),
                     ("bt", {"GALAH_TPU_VERIFY_GATHER": "bt"}),
                     ("unset", {})):
        wall, m, clusters, rec, launches = _run_cli(
            ["-d", corpus, "-x", "fna"], work, f"large_{tag}", "gpu",
            env=env)
        if first is None:
            streams = [len(s.frag_buckets) for s in rec["device_sketches"]]
            check(len(streams) == len(paths)
                  and min(streams) > GROUPED_MIN_HASHES,
                  f"streams of {sorted(streams)[:3]} hashes, want every one "
                  f"of the {len(paths)} over {GROUPED_MIN_HASHES}")
            log("large", f"smallest fragment stream {min(streams)} hashes "
                         f"(largest {max(streams)}), all {len(streams)} over "
                         f"{GROUPED_MIN_HASHES}")
            sketches = rec["device_sketches"]
        _log_run(f"large-{tag}", wall, m, launches, rec)
        c = m["counters"]
        check(c.get("verify_directed_grouped", 0) > 0
              and not c.get("verify_directed_pairtable"),
              f"large {tag}: grouped {c.get('verify_directed_grouped')}, "
              f"pair table {c.get('verify_directed_pairtable')}")
        routes = {k: int(c.get(f"verify_grouped_{k}_dispatches", 0))
                  for k in ("word", "bt")}
        # Unset, the card gathers words, as the CPU does.
        off = {"word": "bt", "bt": "word", "unset": "bt"}[tag]
        check(routes[off] == 0, f"large {tag}: dispatches {routes}")
        n = _families_exact(clusters, paths, fam_ids)
        check(n == nfam, f"large {tag}: {n} clusters")
        verified = rec["verified"]
        if first is None:
            first = (clusters, verified)
        else:
            check(clusters == first[0],
                  f"large {tag}: clusters.tsv differs from the word run's")
            check(verified.keys() == first[1].keys() and all(
                np.array(verified[k], np.float64).tobytes()
                == np.array(first[1][k], np.float64).tobytes()
                for k in verified),
                f"large {tag}: ANI or AF differ from the word run's")
        log("large", f"{tag} OK: {n} clusters, {len(verified)} pairs "
                     f"verified, {int(c['verify_directed_grouped'])} directed "
                     f"on the grouped path, dispatches {routes}; wall "
                     f"{wall:.2f} s, verify {m['phases_s'].get('verify', 0)} s"
                     f"; {nvidia_smi_line()}")
        runs[tag] = {"wall_s": wall, "phases_s": m["phases_s"],
                     "verify_directed_grouped": c["verify_directed_grouped"],
                     "dispatches": routes}
    log("large", "OK: ANI and AF bit-identical under word, bt and unset")
    return {"runs": runs, "grouped": _grouped_verify_times(sketches)}


def _rank_run(tag: str, fn) -> dict:
    """fn() with every kernel count set to 0 just before and read just
    after; its result and a report of its counters."""
    import torch

    from galah_tpu_torch.utils import metrics

    counters = _launch_counters()
    for k in counters.values():
        k.launches = 0
    counters["K1"].per_shard.clear()
    m = metrics.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fn()
    wall = time.perf_counter() - t0
    c = m.counters
    return res, {
        "wall_s": wall,
        "launches": {k: f.launches for k, f in counters.items()},
        "genomes_sketched": c.get("genomes_sketched"),
        "contigs_sketched": c.get("contigs_sketched"),
        "sketch_exchange_bytes": c.get("sketch_exchange_bytes"),
        "sketch_exchange_s": c.get("sketch_exchange_s"),
        "verify_mp_pairs_local": c.get("verify_mp_pairs_local"),
        "screen_tiles": c.get("screen_tiles"),
        "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20,
        "phases_s": dict(m.phases),
    }


def rank_main(argv) -> int:
    """One rank of phase 15 (chip_smoke.py --rank R --ranks N --port P
    --work W --corpus C --contigs F): joins the process group, runs
    cluster_genomes over the main corpus and cluster_contigs over the
    contig corpus on its card, and writes its clusters and counters to
    W/rankR.json."""
    import argparse
    import glob
    import logging

    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--ranks", "--port"):
        ap.add_argument(flag, type=int, required=True)
    for flag in ("--work", "--corpus", "--contigs"):
        ap.add_argument(flag, required=True)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from galah_tpu_torch import api
    from galah_tpu_torch.parallel.mesh import initialize_distributed

    logging.basicConfig(level=logging.INFO,
                        format=f"[rank {a.rank}] %(name)s: %(message)s")
    initialize_distributed(f"localhost:{a.port}", a.ranks, a.rank,
                           timeout_s=RANK_TIMEOUT_S)
    device = [torch.device("cuda", 0)]
    threads = max(1, min(8, os.cpu_count() or 1) // a.ranks)
    paths = sorted(glob.glob(os.path.join(a.corpus, "*.fna")))
    res, main_report = _rank_run("main", lambda: api.cluster_genomes(
        paths, api.ClusterParameters(ani=95, threads=threads),
        device=device))
    main_tsv = "".join(f"{c[0]}\t{m}\n" for c in res.memberships()
                       for m in c)
    res, contig_report = _rank_run("contigs", lambda: api.cluster_contigs(
        [a.contigs], api.ClusterParameters(ani=95, small_genomes=True,
                                           threads=threads),
        device=device))
    contigs_tsv = "".join(f"{c[0]}\t{m}\n" for c in res.memberships()
                          for m in c)
    with open(os.path.join(a.work, f"rank{a.rank}.json"), "w") as f:
        json.dump({"rank": a.rank, "device": torch.cuda.get_device_name(0),
                   "main": main_report, "contigs": contig_report,
                   "main_tsv": main_tsv, "contigs_tsv": contigs_tsv}, f)
    torch.distributed.destroy_process_group()
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if len(sys.argv) > 1:
        return rank_main(sys.argv[1:])
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
        contig_path, contig_names, contig_fams = make_contig_corpus(
            work, CONTIG_CORPUS, "contigs")
        k5 = phase_sketch_kernel(paths, contig_path)
        with _one_card():
            main_launches, main_tsv, main_pairs = phase_main_path(
                work, corpus, paths, fam_ids)
            k2_launches = phase_popcount_path(work, corpus, main_tsv)
            ref_pairs = phase_reference(work, paths, fam_ids)
            phase_low_memory(work, paths, fam_ids)
            indicator = phase_indicator(work, corpus, paths, fam_ids,
                                        main_pairs, main_tsv, ref_pairs)
            contig_launches, contig_tsv, contig_tiles, contig_pairs = (
                phase_contig_path(work, contig_path, contig_names,
                                  contig_fams))
            resume = phase_resume(work)
            phase_surface(work, corpus, paths, fam_ids, main_tsv)
            phase_scale()
            phase_parity(work)
        shards = phase_shards(work, contig_path, contig_names, contig_fams,
                              contig_pairs, contig_tsv, contig_tiles, paths,
                              fam_ids, ref_pairs)
        ranks = phase_processes(work, corpus, paths, fam_ids, main_tsv,
                                contig_path, contig_names, contig_fams,
                                contig_tsv, contig_tiles)["reports"]
        with _one_card():
            large = phase_large_genomes(work)
    print(json.dumps({"device_programs": {
        "indicator_product": indicator,
        "grouped_verify": large["grouped"],
        "large_genome_runs": large["runs"],
        "card": info["nvidia_smi"],
    }}))
    print(json.dumps({"kernels": [
        {
            "name": "packed_intersect_counts",
            "route": "cuda",
            "source": "galah_tpu_torch/csrc/packed_popcount.cu",
            "replaces": "galah_tpu/ops/packed_matmul.py:46",
            "launches": main_launches["K1"],
            "launches_contig_path": contig_launches["K1"],
            "launches_resume_path": {k: v["K1"] for k, v in resume.items()},
            "launches_by_shard": shards,
            "launches_by_rank": {
                corpus_tag: [r[corpus_tag]["launches"]["K1"] for r in ranks]
                for corpus_tag in ("main", "contigs")},
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
        {
            "name": "sketch_batch",
            "route": "cuda",
            "source": "galah_tpu_torch/csrc/device_sketch.cu",
            "replaces": "galah_tpu/ops/device_sketch.py:603",
            "launches": main_launches["K5"],
            "launches_contig_path": contig_launches["K5"],
            "launches_resume_path": {k: v["K5"] for k, v in resume.items()},
            "launches_by_rank": {
                corpus_tag: [r[corpus_tag]["launches"]["K5"] for r in ranks]
                for corpus_tag in ("main", "contigs")},
            **k5,
        },
    ]}))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
