"""Sharded all-vs-all sketch screens
(counterpart of galah_tpu/parallel/distance.py).

The screens of ops/prefilter.py spread over shards: several devices of
this process (a device may repeat, as two shards on one card or CPU
shards in the tests) and the shards of every other process of the
group (parallel/mesh.py). Each local shard runs its own _TileQueue
(ops/prefilter.py) over its share of the tiles, with K1 on its device,
its events and its pinned hit buffers; its tiles are drained under the
single-device rules. Every process computes only its shards' tiles and
the hits are all-gathered once at the end, so every process returns the
same pairs, in the JAX package's order.

Two sweeps, as in the JAX package:

- the replicated sweep (sharded_screen_triangle_packed,
  sharded_screen_rectangle_packed): the packed matrix is resident on
  every local device (shards on one device share one copy) and tile t
  of the sweep goes to shard t mod the shard count. A tile is decided
  on its bfloat16 containment only past its cap, as a resident tile is;
- the row-sharded sweep (sharded_screen_triangle_rowsharded,
  sharded_screen_rectangle_rowsharded), taken past the device budget or
  under GALAH_TPU_ROWSHARD=1: row block g lives only on shard g mod the
  shard count, and the sweep goes one column block (stage) at a time.
  Every process holds every host row, so a stage's column block is
  copied device to device from its owner shard when the owner is local
  and uploaded from the host rows otherwise. The JAX package compacts
  each shard's hits of a stage into one stream of `stage_cap` slots and
  recomputes densely every tile past `cap` and, once the stream's
  running offset passes stage_cap - cap, every tile of that shard's
  stage. The port has no stream, but it replays that running offset
  from the tiles' hit counts, so the same tiles are decided on their
  bfloat16 containment (screen_rowshard_dense_tiles counts them).

The JAX package's transports are not carried over: its jitted shard_map
programs over chunks of TILES_PER_DEVICE tiles, the psum broadcast of a
stage's column block and the compacted stage stream.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from galah_tpu_torch.ops.prefilter import (
    SCREEN_ROUTE,
    ScreenResult,
    _TileQueue,
    _device_resident_budget,
    _empty_result,
    _host_block,
    _row_width,
    _screen_block,
    _screen_cap_for,
)
from galah_tpu_torch.parallel.mesh import (
    Shard,
    process_count,
    process_index,
    shard_list,
)
from galah_tpu_torch.utils import metrics

logger = logging.getLogger(__name__)

# The row-sharded sweep's tile edge at most, per-tile hit capacity and
# per-shard per-stage stream capacity (the JAX package's).
ROWSHARD_BLOCK = 1024
ROWSHARD_CAP = 8192
ROWSHARD_STAGE_CAP = 1 << 15

# A tile queue's window in the row-sharded sweep: a whole stage stays in
# flight until its shard's stream offset is replayed.
_WHOLE_STAGE = 1 << 30


def _pick_block(n: int, block: int) -> int:
    """Shrink the tile edge for small inputs so tiny runs don't pay a
    (1024 x 1024) matmul for 24 genomes."""
    if n >= block:
        return block
    return max(128, 1 << (max(n - 1, 1)).bit_length())


def _local_devices(devices: Optional[Sequence[torch.device]]):
    if devices is None:
        from galah_tpu_torch.utils.device import resolve_devices

        devices = resolve_devices()
    return list(devices)


def _on(device: torch.device):
    """The device's context for a CUDA device (events, pinned copies)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _rowshard_forced(padded_rows: int, w: int, devices) -> bool:
    """GALAH_TPU_ROWSHARD=1/0 forces the row-sharded sweep or the
    replicated one; else row-shard when the block-padded matrix exceeds
    a local device's resident budget (the JAX package's rule)."""
    env = os.environ.get("GALAH_TPU_ROWSHARD")
    if env == "0":
        return False
    return env == "1" or padded_rows * w * 4 > min(
        _device_resident_budget(d) for d in devices)


def _merge(chunks: List[Tuple[int, np.ndarray, np.ndarray]]) -> ScreenResult:
    """One result from every process's tiles: (order key, pairs, ANI) of
    each tile with a hit, all-gathered when there are several processes,
    then in key order (a stable sort keeps each tile's row-major order)."""
    if chunks:
        keys = np.concatenate([np.full(len(p), k, np.int64)
                               for k, p, _ in chunks])
        pairs = np.concatenate([p for _, p, _ in chunks])
        anis = np.concatenate([a for _, _, a in chunks])
    else:
        keys = np.empty(0, np.int64)
        pairs = np.empty((0, 2), np.int64)
        anis = np.empty(0, np.float32)
    if process_count() > 1:
        from galah_tpu_torch.parallel.mp import all_gather_rows

        rows = np.stack([keys, pairs[:, 0], pairs[:, 1],
                         anis.view(np.int32).astype(np.int64)], axis=1) \
            if len(keys) else np.empty((0, 4), np.int64)
        rows = np.concatenate(all_gather_rows(rows))
        keys, pairs = rows[:, 0], np.ascontiguousarray(rows[:, 1:3])
        anis = rows[:, 3].astype(np.int32).view(np.float32)
    if not len(keys):
        return _empty_result()
    order = np.argsort(keys, kind="stable")
    return ScreenResult(pairs[order], anis[order])


def _tile_chunks(queue: _TileQueue, block: int,
                 key_of: Callable[[int, int], int]):
    """A drained queue's tiles with a hit as (order key, pairs, ANI);
    each tile's (row block, column block) is read off its first pair."""
    return [(key_of(int(p[0, 0]) // block, int(p[0, 1]) // block), p, a)
            for p, a in zip(queue.pairs, queue.anis)]


def _local(shards: List[Shard]) -> List[int]:
    """Global indices of this process's shards, in local order."""
    me = process_index()
    return [g for g, sh in enumerate(shards) if sh.rank == me]


# ---------------------------------------------------------------- replicated


def sharded_screen_triangle_packed(
    packed: Sequence[np.ndarray],
    sizes: np.ndarray,
    k: int,
    min_containment: float,
    bits: int,
    devices: Optional[Sequence[torch.device]] = None,
    block: int = 0,
    cap: int = 0,
    checkpoint_path: Optional[str] = None,
    unit_names: Optional[Sequence[str]] = None,
) -> ScreenResult:
    """Upper-triangle all-vs-all screen over packed uint32 bitmap rows
    with the tile list sharded over `devices` (default: every local
    device, utils/device.py::resolve_devices) and every other process's
    shards. block and cap of 0 take the single-device sweep's tile edge
    and cap.

    checkpoint_path + unit_names: the mid-sweep tile log
    (ops/sweep_checkpoint.py), with the single-device sweep's
    fingerprint: logged tiles replay before anything is uploaded, and
    every drained tile is logged. Single-process only: with several
    processes the checkpoint is ignored with a warning, as per-host logs
    could break the lockstep sweep."""
    devices = _local_devices(devices)
    n = len(packed)
    if n == 0:
        return _empty_result()
    w = _row_width(packed)
    block = _pick_block(n, block or _screen_block())
    cap = cap or _screen_cap_for(block)
    nblocks = -(-n // block)
    if _rowshard_forced(nblocks * block, w, devices):
        logger.info("Row-sharding the resident packed matrix (%d rows x %d "
                    "words)", n, w)
        if checkpoint_path:
            logger.warning(
                "--sweep-checkpoint is not supported by the row-sharded "
                "sweep; this run will NOT checkpoint mid-sweep")
        return sharded_screen_triangle_rowsharded(
            packed, sizes, k, min_containment, bits, devices=devices,
            block=min(block, ROWSHARD_BLOCK))

    checkpoint = None
    if checkpoint_path:
        if process_count() > 1:
            logger.warning(
                "--sweep-checkpoint is ignored on multi-process runs of the "
                "sharded sweep (per-host logs would break the lockstep "
                "dispatch contract)")
        elif unit_names is None:
            logger.warning("--sweep-checkpoint needs unit names; ignored")
        else:
            from galah_tpu_torch.ops.sweep_checkpoint import (
                SweepCheckpoint,
                sweep_fingerprint,
            )

            checkpoint = SweepCheckpoint(checkpoint_path, sweep_fingerprint(
                unit_names, bits, block, k,
                float(np.float32(min_containment)), SCREEN_ROUTE))
    tiles = [(bi, bj) for bi in range(nblocks) for bj in range(bi, nblocks)]
    key_of = lambda bi, bj: bi * nblocks + bj  # noqa: E731
    restored = []
    try:
        if checkpoint is not None and len(checkpoint):
            # Replay before the matrix is built or uploaded: a complete
            # log returns without either.
            remaining = []
            for bi, bj in tiles:
                got = checkpoint.has(bi, bj)
                if got is None:
                    remaining.append((bi, bj))
                elif len(got[0]):
                    restored.append((key_of(bi, bj), *got))
            if len(remaining) < len(tiles):
                metrics.current().count("screen_tiles_restored",
                                        len(tiles) - len(remaining))
            logger.info("Sweep checkpoint: %d/%d tiles replayed",
                        len(tiles) - len(remaining), len(tiles))
            tiles = remaining
        chunks = []
        if tiles:
            sizes_f = np.asarray(sizes).astype(np.float32)
            x, s = _host_block(packed, sizes_f, 0, n, devices[0])
            chunks = _replicated_sweep(
                x, s, tiles, devices, n_rows=n, n_cols=n, col_base=0,
                triangle=True, block=block, cap=cap, bits=bits,
                min_containment=min_containment, k=k, key_of=key_of,
                checkpoint=checkpoint)
    finally:
        if checkpoint is not None:
            checkpoint.close()
    return _merge(restored + chunks)


def sharded_screen_rectangle_packed(
    query_packed: Sequence[np.ndarray],
    query_sizes: np.ndarray,
    ref_packed: Sequence[np.ndarray],
    ref_sizes: np.ndarray,
    k: int,
    min_containment: float,
    bits: int,
    devices: Optional[Sequence[torch.device]] = None,
    block: int = 0,
    cap: int = 0,
) -> ScreenResult:
    """Reference-genome (rectangular) screen: every (query block, ref
    block) tile, sharded as the triangle's tiles are. Queries and refs
    form one resident matrix (queries first). Returned pairs are
    (query_idx, ref_idx). Past the device budget, or under
    GALAH_TPU_ROWSHARD=1, the row-sharded rectangle instead."""
    devices = _local_devices(devices)
    nq, nr = len(query_packed), len(ref_packed)
    if nq == 0 or nr == 0:
        return _empty_result()
    w = _row_width(query_packed)
    block = _pick_block(max(nq, nr), block or _screen_block())
    cap = cap or _screen_cap_for(block)
    nqb, nrb = -(-nq // block), -(-nr // block)
    if _rowshard_forced((nqb + nrb) * block, w, devices):
        logger.info("Row-sharding the resident rectangle matrix (%d+%d rows "
                    "x %d words)", nq, nr, w)
        return sharded_screen_rectangle_rowsharded(
            query_packed, query_sizes, ref_packed, ref_sizes, k,
            min_containment, bits, devices=devices,
            block=min(block, ROWSHARD_BLOCK))
    rows = _ConcatRows(query_packed, nq, ref_packed)
    sizes_f = np.concatenate([np.asarray(query_sizes, np.float32),
                              np.asarray(ref_sizes, np.float32)])
    x, s = _host_block(rows, sizes_f, 0, nq + nr, devices[0])
    tiles = [(bi, bj) for bi in range(nqb) for bj in range(nrb)]
    return _merge(_replicated_sweep(
        x, s, tiles, devices, n_rows=nq, n_cols=nr, col_base=nq,
        triangle=False, block=block, cap=cap, bits=bits,
        min_containment=min_containment, k=k,
        key_of=lambda bi, bj: bi * nrb + bj))


def _replicated_sweep(
    x: torch.Tensor,
    s: torch.Tensor,
    tiles: List[Tuple[int, int]],
    devices: List[torch.device],
    *,
    n_rows: int,
    n_cols: int,
    col_base: int,
    triangle: bool,
    block: int,
    cap: int,
    bits: int,
    min_containment: float,
    k: int,
    key_of: Callable[[int, int], int],
    checkpoint=None,
):
    """The replicated sweep's local share: x (rows, W) and s (rows,) on
    devices[0] hold row blocks at rows [0, n_rows) and column blocks at
    [col_base, col_base + n_cols); tile t of `tiles` goes to global
    shard t mod the shard count. Returns this process's tile chunks
    (_merge's input)."""
    shards = shard_list(devices)
    mine = _local(shards)
    # One replica a local device: .to() of a device the tensor is on
    # returns the tensor itself.
    reps = [(x.to(d), s.to(d)) for d in devices]
    queues = [_TileQueue(bits, min_containment, block, k, streaming=False,
                         cap=cap, shard=g) for g in mine]
    for q in queues:
        q.checkpoint = checkpoint
    m = metrics.current()
    try:
        for t, (bi, bj) in enumerate(tiles):
            sh = shards[t % len(shards)]
            if sh.device is None:
                continue
            xr, sr = reps[sh.local]
            r0, r1 = bi * block, min(n_rows, (bi + 1) * block)
            c0 = col_base + bj * block
            c1 = col_base + min(n_cols, (bj + 1) * block)
            m.count("screen_tiles", 1)
            m.count("screen_pairs_computed", block * block)
            with _on(sh.device):
                queues[sh.local].issue(
                    xr[r0:r1], xr[c0:c1], sr[r0:r1], sr[c0:c1],
                    diag=triangle and bi == bj, row0=r0,
                    col0=bj * block)
        chunks = []
        for q in queues:
            q.result()
            chunks += _tile_chunks(q, block, key_of)
        return chunks
    finally:
        for q in queues:
            q.abandon()


# -------------------------------------------------------------- row-sharded


class _ConcatRows:
    """List-like view of queries then refs, without materializing the
    matrix on the host. `gap` zero rows may sit between them (the
    row-sharded rectangle pads the queries to a block boundary)."""

    def __init__(self, query_packed, q_end: int, ref_packed) -> None:
        self._q = query_packed
        self._nq = len(query_packed)
        self._q_end = q_end
        self._r = ref_packed
        self.row_width = _row_width(query_packed)
        self._zero = np.zeros((self.row_width,), np.uint32)

    def __len__(self) -> int:
        return self._q_end + len(self._r)

    def __getitem__(self, i: int) -> np.ndarray:
        if i < self._nq:
            return self._q[i]
        if i < self._q_end:
            return self._zero
        return self._r[i - self._q_end]


def sharded_screen_triangle_rowsharded(
    packed: Sequence[np.ndarray],
    sizes: np.ndarray,
    k: int,
    min_containment: float,
    bits: int,
    devices: Optional[Sequence[torch.device]] = None,
    block: int = ROWSHARD_BLOCK,
    cap: int = ROWSHARD_CAP,
    stage_cap: int = ROWSHARD_STAGE_CAP,
) -> ScreenResult:
    """Upper-triangle screen with the packed matrix ROW-SHARDED over the
    shards (cyclic block ownership): a shard holds about n/shards rows,
    so capacity grows with shards and processes. Column stage cb sweeps
    row blocks g <= cb."""
    devices = _local_devices(devices)
    n = len(packed)
    if n == 0:
        return _empty_result()
    block = _pick_block(n, block)
    nblocks = -(-n // block)
    return _rowshard_sweep(
        packed, np.asarray(sizes, np.float32),
        lambda g: (g * block, min(n, (g + 1) * block)), nblocks,
        [(cb, cb) for cb in range(nblocks)], devices, block=block, cap=cap,
        stage_cap=stage_cap, bits=bits, min_containment=min_containment,
        k=k, col0_blocks=0)


def sharded_screen_rectangle_rowsharded(
    query_packed: Sequence[np.ndarray],
    query_sizes: np.ndarray,
    ref_packed: Sequence[np.ndarray],
    ref_sizes: np.ndarray,
    k: int,
    min_containment: float,
    bits: int,
    devices: Optional[Sequence[torch.device]] = None,
    block: int = ROWSHARD_BLOCK,
    cap: int = ROWSHARD_CAP,
    stage_cap: int = ROWSHARD_STAGE_CAP,
) -> ScreenResult:
    """Reference-genome (rectangular) screen with the concatenated
    query + ref matrix ROW-SHARDED over the shards: query blocks then
    ref blocks, each shard holding every shard-count-th block. Each
    column stage takes one REF block and sweeps every QUERY row block
    against it; returned pairs are (query_idx, ref_idx)."""
    devices = _local_devices(devices)
    nq, nr = len(query_packed), len(ref_packed)
    if nq == 0 or nr == 0:
        return _empty_result()
    block = _pick_block(max(nq, nr), block)
    nqb = -(-nq // block)
    q_end = nqb * block
    nblocks = nqb + -(-nr // block)
    rows = _ConcatRows(query_packed, q_end, ref_packed)
    sizes_f = np.zeros(q_end + nr, np.float32)
    sizes_f[:nq] = np.asarray(query_sizes, np.float32)
    sizes_f[q_end:] = np.asarray(ref_sizes, np.float32)

    def span(g: int) -> Tuple[int, int]:
        lo = g * block
        return lo, min(nq if g < nqb else q_end + nr, lo + block)

    return _rowshard_sweep(
        rows, sizes_f, span, nblocks,
        [(cb, nqb - 1) for cb in range(nqb, nblocks)], devices, block=block,
        cap=cap, stage_cap=stage_cap, bits=bits,
        min_containment=min_containment, k=k, col0_blocks=nqb)


def _rowshard_sweep(
    rows: Sequence[np.ndarray],
    sizes_f: np.ndarray,
    span: Callable[[int], Tuple[int, int]],
    nblocks: int,
    stages: List[Tuple[int, int]],
    devices: List[torch.device],
    *,
    block: int,
    cap: int,
    stage_cap: int,
    bits: int,
    min_containment: float,
    k: int,
    col0_blocks: int,
) -> ScreenResult:
    """The row-sharded sweeps' common body. Row block g (host rows
    span(g) of `rows`) lives on global shard g mod the shard count.
    `stages` lists (cb, max_row_block): column block cb is swept against
    the row blocks g <= max_row_block. Emitted row indices are those of
    `rows`, column indices are rebased by col0_blocks blocks."""
    stage_cap = max(stage_cap, 2 * cap)
    shards = shard_list(devices)
    n_dev = len(shards)
    slots = -(-nblocks // n_dev)
    mine = _local(shards)

    def upload(g: int, device: torch.device):
        return _host_block(rows, sizes_f, *span(g), device)

    resident = [{g: upload(g, shards[gs].device)
                 for g in range(gs, nblocks, n_dev)} for gs in mine]
    queues = [_TileQueue(bits, min_containment, block, k, streaming=False,
                         cap=cap, shard=gs) for gs in mine]
    for q in queues:
        q.window = _WHOLE_STAGE
    m = metrics.current()
    dense_tiles = 0
    chunks = []
    try:
        for cb, mrb in stages:
            owner = shards[cb % n_dev]
            src = (resident[owner.local][cb] if owner.device is not None
                   else upload(cb, devices[0]))
            for li, gs in enumerate(mine):
                dev = devices[li]
                xc, sc = src[0].to(dev), src[1].to(dev)
                with _on(dev):
                    for g in range(gs, min(mrb + 1, nblocks), n_dev):
                        xr, sr = resident[li][g]
                        m.count("screen_tiles", 1)
                        m.count("screen_pairs_computed", block * block)
                        queues[li].issue(
                            xr, xc, sr, sc, diag=g == cb, row0=g * block,
                            col0=(cb - col0_blocks) * block)
            for li, q in enumerate(queues):
                # Replay the JAX package's compacted stream: a tile
                # stores min(count, cap) hits at the running offset, and
                # a tile that stores hits past stage_cap - cap clobbers
                # the stream, so every tile of the stage goes dense.
                counts = q.counts()
                off, clobbered = 0, False
                for c in counts:
                    stored = min(c, cap)
                    if stored and off > stage_cap - cap:
                        clobbered = True
                    off += stored
                if clobbered:
                    logger.warning(
                        "row-sharded screen: stage %d shard %d stream "
                        "overflow (%d hits > %d); dense recompute",
                        cb, mine[li], off, stage_cap)
                dense_tiles += sum(clobbered or c > cap for c in counts)
                q.drain_all(force_dense=clobbered)
        for q in queues:
            chunks += _tile_chunks(
                q, block,
                lambda g, c: (c * n_dev + g % n_dev) * slots + g // n_dev)
    finally:
        for q in queues:
            q.abandon()
    if dense_tiles:
        m.count("screen_rowshard_dense_tiles", dense_tiles)
    return _merge(chunks)


def sharded_screen_triangle(
    indicators: np.ndarray,
    sizes: np.ndarray,
    k: int,
    min_containment: float,
    devices: Optional[Sequence[torch.device]] = None,
) -> ScreenResult:
    """Dense 0/1 indicator convenience wrapper: packs rows into uint32
    bitmaps and runs the sharded packed sweep."""
    indicators = np.asarray(indicators)
    n, bits = indicators.shape
    if bits % 32 != 0:
        raise ValueError(f"indicator width {bits} not a multiple of 32")
    packed = np.packbits(
        indicators.astype(bool), axis=1, bitorder="little"
    ).view(np.uint32)
    return sharded_screen_triangle_packed(
        list(packed), np.asarray(sizes), k, min_containment, bits,
        devices=devices)
