"""Mid-sweep screen checkpoint (a copy of galah_tpu/ops/sweep_checkpoint.py).

A crash between the sketch store and the final `--output-distance-cache`
would otherwise lose the whole O(n^2) screen. The checkpoint is an
append-only binary log of drained tile results keyed by tile id: each
tile's surviving (pairs, ani) arrays append as soon as the tile drains,
and a resumed sweep replays logged tiles instead of issuing them again.
The output is byte-identical by construction, since a tile's result is
a pure function of its two row blocks; the fingerprint pins the corpus
and the sweep's geometry, and a mismatch starts fresh rather than mixing
corpora. Scope: the resident packed triangle sweep, sequential and
pipelined (ops/prefilter.py::IncrementalPackedScreen); the streaming
sweeps and the popcount screen recompute.

Format: MAGIC, fingerprint-JSON length + bytes, then records of
[b"TILE" bi:i32 bj:i32 count:i32 pairs:int64[count,2] anis:f32[count]].
A partially-written tail record (crash mid-write) is detected by
length and ignored. The format and the fingerprint's keys are the JAX
package's, so a log written by either package's SweepCheckpoint loads
in the other's when the fingerprint dict is the same. The port's screen
writes its own route into the fingerprint's `dtname`
(ops/prefilter.py::SCREEN_ROUTE, "torch-k1-int32": intersection counts
from K1, exact int32, where the JAX package records its matmul input
dtype), so neither package replays the other's sweep.

The port's own copy, so that the port imports nothing of galah_tpu:
same behaviour, file formats and numerics.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_MAGIC = b"GTSWEEP1\n"
_REC = b"TILE"


def sweep_fingerprint(
    unit_names: Sequence[str],
    bits: int,
    block: int,
    k: int,
    min_cont_f: float,
    dtname: str,
) -> Dict[str, object]:
    """Identity of a sweep: corpus (ordered unit names) + geometry.
    Any difference means logged tiles would not reproduce."""
    h = hashlib.sha256()
    for nm in unit_names:
        h.update(nm.encode())
        h.update(b"\0")
    return {
        "names_sha256": h.hexdigest(),
        "n": len(unit_names),
        "bits": int(bits),
        "block": int(block),
        "k": int(k),
        "min_cont": float(np.float32(min_cont_f)),
        "dtname": dtname,
    }


class SweepCheckpoint:
    """Append-only tile-result log; thread-safe puts (the pipelined
    sweep drains from the device-sketch worker thread)."""

    def __init__(self, path: str, fingerprint: Dict[str, object]) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._have: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
        fp_bytes = json.dumps(fingerprint, sort_keys=True).encode()
        self._good_end = 0
        if os.path.exists(path) and self._load(path, fp_bytes):
            logger.info(
                "Sweep checkpoint: resuming %s (%d tiles logged)",
                path, len(self._have),
            )
            self._f = open(path, "ab")
            # Drop any truncated tail record BEFORE appending: new
            # records written after partial garbage would be swallowed
            # as that record's body on the next load (the partial
            # header is intact, so its count field would consume the
            # following valid records' bytes).
            if os.path.getsize(path) > self._good_end:
                self._f.truncate(self._good_end)
                self._f.seek(self._good_end)
        else:
            if os.path.exists(path):
                logger.warning(
                    "Sweep checkpoint %s does not match this sweep "
                    "(different corpus or geometry); starting fresh",
                    path,
                )
            self._f = open(path, "wb")
            self._f.write(_MAGIC)
            self._f.write(struct.pack("<i", len(fp_bytes)))
            self._f.write(fp_bytes)
            self._f.flush()

    def _load(self, path: str, fp_bytes: bytes) -> bool:
        try:
            with open(path, "rb") as f:
                if f.read(len(_MAGIC)) != _MAGIC:
                    return False
                (fp_len,) = struct.unpack("<i", f.read(4))
                if f.read(fp_len) != fp_bytes:
                    return False
                self._good_end = f.tell()
                while True:
                    head = f.read(16)
                    if len(head) < 16:
                        break  # clean EOF or truncated header
                    tag, bi, bj, count = struct.unpack("<4siii", head)
                    if tag != _REC or count < 0:
                        break  # corrupt tail
                    body = f.read(count * 16 + count * 4)
                    if len(body) < count * 16 + count * 4:
                        break  # truncated record (crash mid-write)
                    pairs = np.frombuffer(
                        body[: count * 16], dtype=np.int64
                    ).reshape(count, 2).copy()
                    anis = np.frombuffer(
                        body[count * 16 :], dtype=np.float32
                    ).copy()
                    self._have[(bi, bj)] = (pairs, anis)
                    self._good_end = f.tell()
            return True
        except (OSError, struct.error):
            return False

    def has(
        self, bi: int, bj: int
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        return self._have.get((bi, bj))

    def put(self, bi: int, bj: int, pairs: np.ndarray, anis: np.ndarray) -> None:
        with self._lock:
            if (bi, bj) in self._have:
                return
            self._have[(bi, bj)] = (pairs, anis)
            self._f.write(struct.pack("<4siii", _REC, bi, bj, len(pairs)))
            self._f.write(np.ascontiguousarray(pairs, np.int64).tobytes())
            self._f.write(np.ascontiguousarray(anis, np.float32).tobytes())
            self._f.flush()

    def __len__(self) -> int:
        return len(self._have)

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass
