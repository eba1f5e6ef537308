"""Build and load the port's CUDA kernels.

Every `.cu` file in galah_tpu_torch/csrc/ is compiled with nvcc, on
first use, into one shared library with a plain C interface: one nvcc
per source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -I csrc -c csrc/<name>.cu -o <name>.o
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o libgalah_kernels.so *.o

The library lands in build/galah_tpu_torch/<sha256>/ at the root of the
checkout, keyed by every file under csrc/ (sources and the headers they
include) and the full compile flag list, and is loaded with ctypes.
A missing nvcc or a failed build raises with the compiler's output:
there is no fallback. `build_library(defines=...)` builds the same
sources with extra preprocessor defines into a directory of its own, for
tools that need code the kernel library leaves out.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "galah_tpu_torch"
LIB_NAME = "libgalah_kernels.so"

# (a, b, out, m, n, w, split_words) of the count kernels' C entries.
COUNT_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


@dataclass(frozen=True)
class BuildResult:
    path: Path
    log: str        # nvcc's output (ptxas register/shared-memory report)
    seconds: float  # compile time; 0.0 when the library was already built
    cached: bool


def _sources() -> List[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
    return srcs


def _compile_flags(defines: Sequence[str] = ()) -> List[str]:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines), "-I", str(CSRC_DIR)]


def _digest(defines: Sequence[str] = ()) -> str:
    """Key of the build: every file under csrc/ (a header change must
    rebuild every source that may include it) and the compile and link
    flags, include path included."""
    h = hashlib.sha256()
    for p in sorted(q for q in CSRC_DIR.rglob("*") if q.is_file()):
        h.update(str(p.relative_to(CSRC_DIR)).encode() + b"\0")
        h.update(p.read_bytes())
    h.update("\0".join(_compile_flags(defines) + ARCH_FLAGS).encode())
    return h.hexdigest()


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin): "
        "the galah_tpu_torch CUDA kernels cannot be built"
    )


def build_library(defines: Sequence[str] = ()) -> BuildResult:
    """Compile csrc/*.cu, with `-D` for each of `defines`, unless the
    library for these files and flags exists."""
    srcs = _sources()
    out_dir = BUILD_ROOT / _digest(defines)
    lib = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildResult(lib, log, 0.0, True)
    nvcc = _find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as work:
        objs = [os.path.join(work, p.stem + ".o") for p in srcs]
        logs = _run_all([
            [nvcc, *_compile_flags(defines), "-c", str(p), "-o", o]
            for p, o in zip(srcs, objs)
        ])
        # Link to a temporary name and rename, so a concurrent process
        # never loads a half-written library.
        tmp = os.path.join(work, LIB_NAME)
        logs += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
        log = "".join(logs)
        log_path.write_text(log)
        os.replace(tmp, lib)
    return BuildResult(lib, log, time.perf_counter() - t0, False)


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Start every command at once and wait for all of them; their
    outputs, or a RuntimeError with the first failure's output."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for c in cmds
    ]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{out}"
            )
    return outs


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argtypes and restype declared."""
    return bind(ctypes.CDLL(str(build_library().path)))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every entry point's argtypes and restype on a loaded
    kernel library; returns it."""
    # Both count entries take (a, b, out, m, n, w, split_words, stream)
    # and return a CUDA error code.
    for fn in (lib.galah_packed_popcount, lib.galah_popcount_screen):
        fn.argtypes = [*COUNT_ARGS, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # K6 (counts, counts_float, a, b, cont, hits, scratch, m, n, bits,
    # cut, diag, cap, streaming, rows, stream) returns a CUDA error code.
    lib.galah_screen_epilogue.argtypes = [
        ctypes.c_void_p, ctypes.c_int, *[ctypes.c_void_p] * 5,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.galah_screen_epilogue.restype = ctypes.c_int
    # The gather probe's entries take (idx, table, out, ns, wt, unroll,
    # stream) and return a CUDA error code.
    for fn in (lib.galah_gather_xor, lib.galah_gather_xor_chains):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    # K5 (seq, unit_off, tile_unit, tile_start, tile_end, tile_frag,
    # frag_start, frag_end, frag_slot, n_tiles, tile_cap, max_frags, k,
    # fthresh, gthresh, member_shift, prefilter_shift, member, pref,
    # counts, scratch, threads, stream) returns a CUDA error code.
    lib.galah_device_sketch.argtypes = [
        *[ctypes.c_void_p] * 9, *[ctypes.c_int] * 4,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        *[ctypes.c_void_p] * 4, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.galah_device_sketch.restype = ctypes.c_int
    # K7 (ustream, ufrag_offsets, pool, words, popcounts,
    # pair_ufrag_start, pair_fragflat_start, pair_ref, pair_row, pairs,
    # flat_frags, cluster, slice_bits, smem, inv_bits, inv_k, min_hashes,
    # min_ident, ani, af, stream) returns a CUDA error code.
    lib.galah_pair_table_verify.argtypes = [
        *[ctypes.c_void_p] * 3, ctypes.c_longlong, *[ctypes.c_void_p] * 5,
        *[ctypes.c_int] * 5, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_float, *[ctypes.c_void_p] * 3,
    ]
    lib.galah_pair_table_verify.restype = ctypes.c_int
    # K8 (buckets, offsets, frags, pool, words, rows, popcounts, refs,
    # cluster, slice_bits, smem, inv_bits, inv_k, min_hashes, min_ident,
    # ani, af, scratch, scratch_words, stream) returns a CUDA error code;
    # its scratch size (frags, refs) in int32 words.
    lib.galah_grouped_verify.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        *[ctypes.c_int] * 4, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_float, *[ctypes.c_void_p] * 3, ctypes.c_longlong,
        ctypes.c_void_p,
    ]
    lib.galah_grouped_verify.restype = ctypes.c_int
    lib.galah_grouped_verify_scratch_words.argtypes = [ctypes.c_int] * 2
    lib.galah_grouped_verify_scratch_words.restype = ctypes.c_longlong
    # K5's launch shape (tile_cap, max_frags, k, member_shift, narrow*)
    # returns its shared memory a block in bytes.
    lib.galah_device_sketch_shared.argtypes = [
        *[ctypes.c_int] * 4, ctypes.POINTER(ctypes.c_int)]
    lib.galah_device_sketch_shared.restype = ctypes.c_longlong
    return lib
