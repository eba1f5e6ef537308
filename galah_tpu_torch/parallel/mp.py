"""Multi-process coordination (counterpart of galah_tpu/parallel/mp.py).

Every multi-process feature relies on the lockstep contract of the
sharded screen (parallel/distance.py): the host pipeline is
deterministic and runs identically in every process, so each process
reaches the same collectives in the same order. The collectives run on
gloo over host tensors; gloo's all_gather wants equal shapes, so
variable-length data travels as its lengths first, then as payloads
padded to the longest.
"""

from __future__ import annotations

import io
import logging
import math
import os
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from galah_tpu_torch.parallel.mesh import process_count, process_index

logger = logging.getLogger(__name__)

_governed_cache: Dict[str, bool] = {}


def governed_flag(env_name: str) -> bool:
    """True unless process 0 set `env_name=0`.

    Process 0's setting is broadcast to every process: a per-host
    environment mismatch must not desynchronize the collective schedule
    (one process skipping an all-gather deadlocks the others). Call it
    from EVERY process: it is itself a collective when there are several.
    The broadcast result is memoized per name, since the environment
    cannot change mid-run and a hot path must not pay a round trip to
    read a flag again."""
    local = os.environ.get(env_name) != "0"
    if process_count() <= 1:
        return local
    if env_name not in _governed_cache:
        flag = torch.tensor([int(local)], dtype=torch.int64)
        dist.broadcast(flag, src=0)
        _governed_cache[env_name] = bool(flag.item())
    return _governed_cache[env_name]


def all_gather_equal(x: np.ndarray) -> List[np.ndarray]:
    """Every process's `x`, in rank order; x has the same shape and
    dtype in every process."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return [o.numpy() for o in out]


def all_gather_rows(x: np.ndarray) -> List[np.ndarray]:
    """Every process's `x`, in rank order, where the leading dimension
    may differ between processes (its other dimensions and dtype may
    not): the lengths are gathered first, then the rows padded to the
    longest."""
    lens = [int(n[0]) for n in all_gather_equal(
        np.asarray([len(x)], np.int64))]
    if max(lens) == 0:  # every process knows it: all skip the gather
        return [x[:0] for _ in lens]
    buf = np.zeros((max(lens),) + x.shape[1:], x.dtype)
    buf[:len(x)] = x
    return [g[:n] for g, n in zip(all_gather_equal(buf), lens)]


def exchange_blobs(
    n_items: int,
    my_blob: Callable[[int], bytes],
    on_blob: Callable[[int, bytes], None],
    chunk: int = 16,
) -> Tuple[int, int]:
    """All-to-all exchange of round-robin-owned byte blobs.

    Item i is owned by process `i % process_count()`; `my_blob(i)` is
    called for owned items, and `on_blob(i, blob)` for every item
    another process produced. Blobs travel `chunk` owned items per
    round, as each process's lengths and then its padded uint8 payload:
    two all-gathers a round, peak memory about processes x chunk x the
    largest blob. Returns (bytes sent, bytes received) of the blobs."""
    nproc = process_count()
    me = process_index()
    kmax = math.ceil(n_items / nproc)
    sent = received = 0
    for k0 in range(0, kmax, chunk):
        ks = range(k0, min(k0 + chunk, kmax))
        lens = np.zeros(len(ks), np.int64)
        parts: List[bytes] = []
        for j, k in enumerate(ks):
            gi = me + k * nproc
            if gi < n_items:
                b = my_blob(gi)
                lens[j] = len(b)
                parts.append(b)
        payload = b"".join(parts)
        sent += len(payload)
        lens_g = all_gather_equal(lens)
        maxlen = int(max(lg.sum() for lg in lens_g))
        buf = np.zeros(max(maxlen, 1), np.uint8)  # gloo wants no empty
        if payload:
            buf[: len(payload)] = np.frombuffer(payload, np.uint8)
        buf_g = all_gather_equal(buf)
        for p in range(nproc):
            if p == me:
                continue
            off = 0
            for j, k in enumerate(ks):
                gi = p + k * nproc
                ln = int(lens_g[p][j])
                if gi < n_items and ln:
                    on_blob(gi, buf_g[p][off: off + ln].tobytes())
                    off += ln
                    received += ln
    return sent, received


def exchange_sketches(
    paths: Sequence[str],
    get_local,
    put,
    expect_params=None,
) -> Tuple[int, int]:
    """Share round-robin-partitioned sketches across all processes.

    `get_local(path)` returns the locally computed NativeSketch for
    owned paths; `put(path, sketch)` stores a received one.
    `expect_params` (the local context's NativeSketchParams) rejects
    peers that sketched at other bitmap widths: mixed widths in one run
    fail far from their cause, so the culprit is named here. Returns
    exchange_blobs' (bytes sent, bytes received)."""
    from galah_tpu_torch.sketch.store import dump_sketch, load_sketch

    def my_blob(i: int) -> bytes:
        fh = io.BytesIO()
        dump_sketch(get_local(paths[i]), fh, compress=False)
        return fh.getvalue()

    def on_blob(i: int, blob: bytes) -> None:
        sk = load_sketch(io.BytesIO(blob))
        if expect_params is not None and sk.params != expect_params:
            raise RuntimeError(
                f"sketch for {paths[i]} arrived from a peer with "
                f"different sketch parameters ({sk.params} != "
                f"{expect_params}); hosts must resolve identical "
                "bitmap widths (check per-host filesystem visibility "
                "of the genome files)"
            )
        put(paths[i], sk)

    return exchange_blobs(len(paths), my_blob, on_blob)
