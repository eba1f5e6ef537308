"""Build and load the port's CUDA kernels.

Every `.cu` file in galah_tpu_torch/csrc/ is compiled with nvcc, on
first use, into one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o libgalah_kernels.so csrc/*.cu

The library lands in build/galah_tpu_torch/<sha256>/ at the root of the
checkout, keyed by the sources and flags, and is loaded with ctypes.
A missing nvcc or a failed build raises with the compiler's output:
there is no fallback.
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
from typing import List

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "galah_tpu_torch"
LIB_NAME = "libgalah_kernels.so"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
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


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256()
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
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


def build_library() -> BuildResult:
    """Compile csrc/*.cu unless the library for these sources exists."""
    srcs = _sources()
    out_dir = BUILD_ROOT / _digest(srcs)
    lib = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildResult(lib, log, 0.0, True)
    nvcc = _find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    # Build to a temporary name and rename, so a concurrent process
    # never loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}"
        )
    log_path.write_text(log)
    os.replace(tmp, lib)
    return BuildResult(lib, log, seconds, False)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argtypes and restype declared."""
    lib = ctypes.CDLL(str(build_library().path))
    fn = lib.galah_packed_popcount
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib
