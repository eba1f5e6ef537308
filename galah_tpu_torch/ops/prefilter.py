"""All-vs-all sketch-intersection screen (counterpart of galah_tpu/ops/prefilter.py).

Genome prefilter sketches are packed uint32 bitmap rows (int32 tensors
holding the same bits). A sweep walks (block x block) tiles: the upper
triangle of one matrix (screen_triangle_packed) or every (query block,
reference block) tile of a rectangle (screen_rectangle_packed). Each
tile goes through two steps (_TileQueue):

- issue, device work only: intersection counts from the
  packed-popcount kernel (ops/packed_matmul.py), collision-corrected
  max containment in the reference's float32 operation order
  (_containment), the float32 cutoff and, on diagonal tiles, the
  strict-upper mask, then the hits extracted row-major into a
  fixed-capacity buffer (a prefix sum and a search, no host sync) with
  their values rounded to bfloat16, and one copy of that buffer home;
- drain, once the copy has landed: the reference's overflow rules
  (_drain_tile) and its emit rules (_emit_tile).

Up to a window of tiles is in flight between the two (TILE_WINDOW, or 2
while rows still arrive). Resident sweeps hold the packed matrix on the
device and slice its tiles: IncrementalPackedScreen, fed row block by
row block while the corpus is sketched (the engine's pipeline), or with
the whole matrix at once (screen_triangle_packed). Streaming sweeps
(low-memory mode, or a matrix over the device budget) upload each
tile's row blocks from the host row sequence (_sweep). Both keep the
reference's two overflow rules: a resident tile is decided on its
bfloat16-rounded containment (the reference's dense fallback) only
past `cap` hits; a streaming tile also when its hits span more than
`_row_sel(rows)` rows, because the reference has no resident matrix to
re-extract such a tile from.

Pairs come out tile by tile in the order tiles were issued, row-major
within a tile: the reference's sweep order for a sweep, the order in
which tiles became ready for a screen fed row by row.

The resident triangle sweep can log every drained tile to a mid-sweep
checkpoint (ops/sweep_checkpoint.py, --sweep-checkpoint) and replay the
logged tiles of a killed run instead of issuing them: a replayed tile's
pairs are emitted when it would have been issued, ahead of tiles still
in flight, so the pair order differs from a fresh run's but the pair
set does not. The streaming sweeps do not checkpoint.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from galah_tpu_torch.ops.packed_matmul import packed_intersect_counts
from galah_tpu_torch.utils import metrics
from galah_tpu_torch.utils.convert import to_device, words_to_torch

logger = logging.getLogger(__name__)

DEFAULT_BLOCK = 1024

# The route recorded as `dtname` in a sweep checkpoint's fingerprint:
# the intersection counts are K1's, exact int32 (the JAX package records
# its matmul input dtype there).
SCREEN_ROUTE = "torch-k1-int32"

# Hit-row capacity of the reference's two-level sparse extraction
# (galah_tpu/ops/prefilter.py ROW_SEL): a streaming tile whose hits span
# more rows is decided densely.
ROW_SEL = 128

# Tiles in flight before the oldest is drained (the reference's
# TILE_WINDOW): bounds the tiles' containment matrices and host buffers
# held at once while the host queues the next tiles.
TILE_WINDOW = 16

# (packed rows, sizes) of one block on the device.
Block = Tuple[torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class ScreenResult:
    """Above-cutoff candidate pairs with containment-ANI estimates."""

    pairs: np.ndarray    # (P, 2) int64 — (i, j) with i < j, or (query, ref)
    ani_est: np.ndarray  # (P,) float32 — percentage scale


def _empty_result() -> ScreenResult:
    return ScreenResult(np.empty((0, 2), np.int64), np.empty(0, np.float32))


def _concat(pairs: List[np.ndarray], anis: List[np.ndarray]) -> ScreenResult:
    """One result from the tiles' emitted pairs and ANI, in order."""
    if pairs:
        return ScreenResult(np.concatenate(pairs), np.concatenate(anis))
    return _empty_result()


def _screen_cap_for(block: int) -> int:
    """Per-tile hit capacity of the reference's sparse extraction,
    linear in the tile edge. Past it the reference decides the tile on
    its bfloat16 containment (the dense fallback); the drain keeps that
    rule so the pair set matches at any hit count."""
    return 16384 * max(1, block // 1024)


def _row_sel(rows: int) -> int:
    """Hit rows the reference's two-level extraction holds for a tile
    of `rows` rows (galah_tpu/ops/prefilter.py _extract_above_cutoff)."""
    return min(rows, max(ROW_SEL, rows // 16))


def _device_resident_budget(device: torch.device) -> int:
    """Bytes the packed matrix may take on `device` and stay resident:
    half the card's memory on CUDA, 4 GiB on the CPU (the reference's
    rule and CPU figure)."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[1] // 2
    return 4 << 30


def _pipeline_window() -> int:
    """In-flight window of a screen whose rows still arrive: 2, or
    GALAH_TPU_PIPELINE_WINDOW (the reference's rule). A shallow window
    drains tiles while the corpus is still being sketched instead of
    leaving them all to finish()."""
    env = os.environ.get("GALAH_TPU_PIPELINE_WINDOW")
    return max(1, int(env)) if env else 2


def _containment(
    counts: torch.Tensor, a: torch.Tensor, b: torch.Tensor, bits_f: float
) -> torch.Tensor:
    """Collision-corrected max containment, float32.

    counts: (bi, bj); a: (bi,) sizes; b: (bj,) sizes.
    Two-step correction: E[c_obs] ~= c + (a-c)(b-c)/B."""
    a = a[:, None]
    b = b[None, :]
    c1 = torch.clamp(counts - a * b / bits_f, min=0.0)
    c = torch.clamp(counts - (a - c1) * (b - c1) / bits_f, min=0.0)
    denom = torch.clamp(torch.minimum(a, b), min=1.0)
    return torch.clamp(c / denom, max=1.0)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to bfloat16, as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _extract_hits(mask: torch.Tensor, cont: torch.Tensor,
                  slots: torch.Tensor, rows: bool) -> torch.Tensor:
    """One tile's hits as one int32 device buffer of 2 + 2 * cap words,
    with no host sync: [hit count, rows with a hit (when `rows`, else
    0), the first cap hits' flat indices row-major, their
    bfloat16-rounded containment as float32 bits]. `slots` is
    1..cap as int32: the hit of slot s is the first position whose
    inclusive prefix count reaches s, and slots past the count hold the
    tile's last position."""
    flat = mask.reshape(-1)
    csum = torch.cumsum(flat, 0, dtype=torch.int32)
    idx = torch.searchsorted(csum, slots, out_int32=True)
    idx = idx.clamp_(max=flat.numel() - 1)
    vals = _bf16(cont.reshape(-1).index_select(0, idx))
    hit_rows = (mask.any(dim=1).sum(dtype=torch.int32).view(1) if rows
                else torch.zeros(1, dtype=torch.int32, device=mask.device))
    return torch.cat([csum[-1:], hit_rows, idx, vals.view(torch.int32)])


def _emit_tile(
    ii: np.ndarray,
    jj: np.ndarray,
    vals: np.ndarray,
    *,
    row0: int,
    col0: int,
    inv_k: float,
    pairs: List[np.ndarray],
    anis: List[np.ndarray],
) -> bool:
    """The reference's _drain_tile emit rules: rebase by row0/col0 and
    convert containment to ANI as v ** (1/k) * 100 in numpy float32.
    Tiles are exact row slices here, never zero-padded, so the
    reference's drop of padding rows (keep_rows/keep_cols) has nothing
    to remove. Returns whether the tile had a hit."""
    gi = ii.astype(np.int64) + row0
    gj = jj.astype(np.int64) + col0
    v = vals.astype(np.float32)
    if not len(gi):
        return False
    pairs.append(np.stack([gi, gj], axis=1).astype(np.int64))
    anis.append((v ** inv_k * 100.0).astype(np.float32))
    return True


@dataclass
class _Tile:
    """One issued tile, until its drain: where it sits, its containment
    matrix (kept so that an overflowing tile is decided on the very
    values it was issued with, without a second count), and its hit
    buffer on the host with the event that marks the copy done (None on
    the CPU, where the buffer is the result itself)."""

    row0: int
    col0: int
    diag: bool
    cont: torch.Tensor
    host: torch.Tensor
    done: Optional["torch.cuda.Event"]


class _TileQueue:
    """The packed screens' tiles in flight: `issue` queues one tile's
    device work and the copy of its hits home; once more than `window`
    tiles are queued the oldest is drained. The one implementation of
    the issue/drain split and of the window, for every sweep."""

    def __init__(self, bits: int, min_containment: float, block: int,
                 k: int, *, streaming: bool, cap: int = 0,
                 shard: Optional[int] = None) -> None:
        self.block = block
        self.bits_f = float(bits)
        self.min_cont_f = float(np.float32(min_containment))
        self.cap = cap or _screen_cap_for(block)
        self.inv_k = 1.0 / k
        self.streaming = streaming
        # The shard whose tiles this queue issues (parallel/distance.py),
        # passed to K1's wrapper for its per-shard launch count.
        self.shard = shard
        self.window = TILE_WINDOW
        self.pairs: List[np.ndarray] = []
        self.anis: List[np.ndarray] = []
        # Called with each drained tile's (pairs, ani_est) when it has
        # a hit: the engine's verify feeder.
        self.on_pairs: Optional[Callable[[np.ndarray, np.ndarray], None]] = None
        # The sweep checkpoint every drained tile is logged to, keyed by
        # (row0 // block, col0 // block), hit or not (triangle sweeps).
        self.checkpoint = None
        self._pending: "deque[_Tile]" = deque()
        self._free: List[torch.Tensor] = []  # pinned hit buffers to reuse
        self._upper: Dict[Tuple, torch.Tensor] = {}
        self._slots: Dict[torch.device, torch.Tensor] = {}

    def _upper_mask(self, shape, device) -> torch.Tensor:
        key = (tuple(shape), device)
        if key not in self._upper:
            self._upper[key] = torch.ones(
                shape, dtype=torch.bool, device=device).triu_(1)
        return self._upper[key]

    def _slots_on(self, device) -> torch.Tensor:
        if device not in self._slots:
            self._slots[device] = torch.arange(
                1, self.cap + 1, dtype=torch.int32, device=device)
        return self._slots[device]

    def issue(self, si: torch.Tensor, sj: torch.Tensor, ai: torch.Tensor,
              aj: torch.Tensor, *, diag: bool, row0: int, col0: int) -> None:
        """Queue one tile (row block si with sizes ai against column
        block sj with sizes aj) and drain tiles past the window."""
        counts = packed_intersect_counts(si, sj, shard=self.shard).to(
            torch.float32)
        cont = _containment(counts, ai, aj, self.bits_f)
        mask = cont >= self.min_cont_f
        if diag:
            mask &= self._upper_mask(mask.shape, mask.device)
        hits = _extract_hits(mask, cont, self._slots_on(mask.device),
                             rows=self.streaming)
        done = None
        if hits.device.type == "cuda":
            host = (self._free.pop() if self._free else torch.empty(
                hits.numel(), dtype=torch.int32, pin_memory=True))
            host.copy_(hits, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(hits.device))
        else:
            host = hits
        self._pending.append(_Tile(row0, col0, diag, cont, host, done))
        while len(self._pending) > self.window:
            self._drain(self._pending.popleft())

    def _drain(self, t: _Tile, force_dense: bool = False) -> None:
        """Decode one tile under the reference's overflow rules
        (_drain_tile) and emit it; force_dense decides it on its
        bfloat16 containment whatever its count."""
        if t.done is not None:
            t.done.synchronize()
        buf = t.host.numpy()
        cap = self.cap
        cnt, rows = int(buf[0]), int(buf[1])
        dense = force_dense or cnt > cap or (
            self.streaming and rows > _row_sel(t.cont.shape[0]))
        if dense:
            mask = _bf16(t.cont) >= self.min_cont_f
            if t.diag:
                mask &= self._upper_mask(mask.shape, mask.device)
            hit = torch.nonzero(mask)
            vals = _bf16(t.cont[hit[:, 0], hit[:, 1]]).cpu().numpy()
            hit = hit.cpu().numpy()
            ii, jj = hit[:, 0], hit[:, 1]
        else:
            flat = buf[2:2 + cnt].astype(np.int64)
            cols = t.cont.shape[1]
            ii, jj = flat // cols, flat % cols
            vals = buf[2 + cap:2 + cap + cnt].view(np.float32)
        got = _emit_tile(ii, jj, vals, row0=t.row0, col0=t.col0,
                         inv_k=self.inv_k, pairs=self.pairs, anis=self.anis)
        if t.done is not None:
            self._free.append(t.host)
        if got and self.on_pairs is not None:
            self.on_pairs(self.pairs[-1], self.anis[-1])
        if self.checkpoint is not None:
            self.checkpoint.put(
                t.row0 // self.block, t.col0 // self.block,
                self.pairs[-1] if got else np.empty((0, 2), np.int64),
                self.anis[-1] if got else np.empty(0, np.float32))

    def counts(self) -> List[int]:
        """The hit count of every tile in flight, in issue order, once
        its copy home has landed (the row-sharded sweep's stage
        decision; its queue's window holds a whole stage)."""
        out = []
        for t in self._pending:
            if t.done is not None:
                t.done.synchronize()
            out.append(int(t.host[0]))
        return out

    def drain_all(self, force_dense: bool = False) -> None:
        """Drain every tile in flight, in issue order."""
        while self._pending:
            self._drain(self._pending.popleft(), force_dense)

    def replay(self, pairs: np.ndarray, anis: np.ndarray) -> None:
        """Emit a logged tile's pairs, as its drain would have."""
        if len(pairs):
            self.pairs.append(pairs)
            self.anis.append(anis)
            if self.on_pairs is not None:
                self.on_pairs(pairs, anis)

    def abandon(self) -> None:
        """Drop every tile in flight after a failure, once its copy home
        has landed, so that no pinned buffer is still being written."""
        for t in self._pending:
            if t.done is not None:
                t.done.synchronize()
        self._pending.clear()
        self._free.clear()

    def result(self) -> ScreenResult:
        """Drain every tile still in flight; every pair in issue order."""
        while self._pending:
            self._drain(self._pending.popleft())
        return _concat(self.pairs, self.anis)


class IncrementalPackedScreen:
    """Resident packed triangle screen fed row by row (counterpart of
    galah_tpu/ops/prefilter.py::IncrementalPackedScreen).

    The matrix of n rows lives on `device`. Rows arrive device to
    device from a sketch batch's prefilter words (add_device_rows) or
    from the host (add_host_rows); each tile whose two row blocks are
    complete is issued at once, so the screen runs while later units
    are still being sketched. The sequential resident sweep is the
    degenerate case (set_prebuilt, then finish()), so both share one
    issue/drain path (_TileQueue) and give the same pairs for any feed
    order. A tile's row blocks are complete, and never written again,
    before it is issued, and its drain reads only what its issue
    computed. Calls come from one thread; finish() comes after the last
    row, close() after a failure.

    checkpoint_path and unit_names (one name per row) turn on the
    mid-sweep checkpoint: every drained tile is logged, and a tile found
    in the log is replayed instead of issued (tiles_restored counts
    them; they count neither as screen_tiles nor in
    screen_pairs_computed, as in the JAX package)."""

    def __init__(self, n: int, k: int, min_containment: float, bits: int,
                 device: torch.device, block: int = 0,
                 row_width: int = 0,
                 checkpoint_path: Optional[str] = None,
                 unit_names: Optional[Sequence[str]] = None) -> None:
        if n <= 0:
            raise ValueError("IncrementalPackedScreen needs n >= 1")
        self.n = n
        self.block = block or DEFAULT_BLOCK
        self.device = device
        self.w = row_width or bits // 32
        self.nblocks = -(-n // self.block)
        self._x = torch.zeros((n, self.w), dtype=torch.int32, device=device)
        self._s = torch.zeros(n, dtype=torch.float32, device=device)
        self._queue = _TileQueue(bits, min_containment, self.block, k,
                                 streaming=False)
        self._added = np.zeros(n, dtype=bool)
        self._left = [min(self.block, n - b * self.block)
                      for b in range(self.nblocks)]
        self._complete: List[int] = []
        self._finished = False
        # Rows fed when the first tile was issued (None until then;
        # under n shows the screen started before the corpus was
        # sketched).
        self.rows_at_first_dispatch: Optional[int] = None
        self.rows_added = 0
        self.tiles_restored = 0
        self._ckpt = None
        if checkpoint_path:
            from galah_tpu_torch.ops.sweep_checkpoint import (
                SweepCheckpoint,
                sweep_fingerprint,
            )

            if unit_names is None or len(unit_names) != n:
                raise ValueError(
                    "checkpoint_path requires unit_names (one per row)")
            self._ckpt = SweepCheckpoint(checkpoint_path, sweep_fingerprint(
                unit_names, bits, self.block, k, self._queue.min_cont_f,
                SCREEN_ROUTE))
            self._queue.checkpoint = self._ckpt

    @property
    def on_pairs(self):
        """Called with each drained tile's (pairs (P, 2) int64, ani_est
        (P,) float32) when it has a hit, as soon as it is decoded."""
        return self._queue.on_pairs

    @on_pairs.setter
    def on_pairs(self, fn) -> None:
        self._queue.on_pairs = fn

    @property
    def window(self) -> int:
        """Tiles in flight before the oldest drains: TILE_WINDOW for a
        prebuilt matrix, _pipeline_window() once rows arrive
        incrementally."""
        return self._queue.window

    # ---- feeding -----------------------------------------------------

    def _check_open(self) -> None:
        if self._finished:
            raise RuntimeError("IncrementalPackedScreen already finished")

    def _fresh(self, idxs: Sequence[int]) -> List[int]:
        """Positions in idxs of rows not yet added, first occurrence."""
        seen = set()
        out = []
        for p, i in enumerate(idxs):
            if not self._added[i] and i not in seen:
                seen.add(i)
                out.append(p)
        return out

    def _note_added(self, idxs: Sequence[int]) -> List[int]:
        """Mark rows added; the blocks that just completed."""
        done = []
        for i in idxs:
            self._added[i] = True
            self.rows_added += 1
            b = i // self.block
            self._left[b] -= 1
            if self._left[b] == 0:
                done.append(b)
        return done

    def _schedule(self, new_blocks: Sequence[int]) -> None:
        """Issue every tile that became ready with `new_blocks`: for
        each, its tiles against every complete block, in sorted order."""
        for b in new_blocks:
            self._complete.append(b)
            for bi, bj in sorted((min(b, c), max(b, c))
                                 for c in self._complete):
                self._issue(bi, bj)

    def add_device_rows(self, idxs: Sequence[int], src: torch.Tensor,
                        src_rows: Sequence[int],
                        sizes: Sequence[float]) -> None:
        """matrix[idxs[b]] = src[src_rows[b]], device to device, for a
        (G, W) int32 tensor of packed rows on the screen's device (a
        sketch batch's prefilter words). Rows already added are
        skipped."""
        self._check_open()
        self._queue.window = _pipeline_window()
        keep = self._fresh(idxs)
        if not keep:
            return
        dst = [int(idxs[p]) for p in keep]
        dst_t = to_device(np.asarray(dst, np.int64), self.device)
        rows = to_device(np.asarray([src_rows[p] for p in keep], np.int64),
                         self.device)
        self._x.index_copy_(0, dst_t, src.index_select(0, rows))
        self._s.index_copy_(0, dst_t, to_device(
            np.asarray([sizes[p] for p in keep], np.float32), self.device))
        self._schedule(self._note_added(dst))

    def add_host_rows(self, idxs: Sequence[int], rows: Sequence[np.ndarray],
                      sizes: Sequence[float]) -> None:
        """Upload host-packed uint32 rows (pack_indicator output), in
        chunks of about 64 MiB. screen_host_row_bytes and
        screen_host_row_upload_s count the rows' bytes and the host time
        of their upload, not that of the tiles they complete."""
        self._check_open()
        self._queue.window = _pipeline_window()
        keep = self._fresh(idxs)
        step = max(1, (64 << 20) // (self.w * 4))
        m = metrics.current()
        for lo in range(0, len(keep), step):
            chunk = keep[lo:lo + step]
            t0 = time.perf_counter()
            dst = [int(idxs[p]) for p in chunk]
            dst_t = to_device(np.asarray(dst, np.int64), self.device)
            mat = words_to_torch(np.stack([rows[p] for p in chunk])).numpy()
            self._x.index_copy_(0, dst_t, to_device(mat, self.device))
            self._s.index_copy_(0, dst_t, to_device(
                np.asarray([sizes[p] for p in chunk], np.float32),
                self.device))
            m.count("screen_host_row_bytes", mat.nbytes)
            m.count("screen_host_row_upload_s", time.perf_counter() - t0)
            self._schedule(self._note_added(dst))

    def set_prebuilt(self, x: torch.Tensor, s: torch.Tensor) -> None:
        """The whole (n, W) int32 matrix and (n,) float32 sizes at once,
        on the screen's device; tiles are issued in the sweep's order
        (row block bi, then column blocks bj >= bi)."""
        self._check_open()
        if self.rows_added:
            raise RuntimeError("set_prebuilt after rows were added")
        self._x, self._s = x, s
        self._added[:] = True
        self.rows_added = self.n
        self._left = [0] * self.nblocks
        self._complete = list(range(self.nblocks))
        for bi in range(self.nblocks):
            for bj in range(bi, self.nblocks):
                self._issue(bi, bj)

    def missing_rows(self) -> List[int]:
        """Rows never fed, for the caller to add from the host before
        finish() (units the sketch sink never saw)."""
        return [int(i) for i in np.nonzero(~self._added)[0]]

    # ---- issue / finish ----------------------------------------------

    def _issue(self, bi: int, bj: int) -> None:
        if self._ckpt is not None:
            got = self._ckpt.has(bi, bj)
            if got is not None:
                self.tiles_restored += 1
                self._queue.replay(*got)
                return
        if self.rows_at_first_dispatch is None:
            self.rows_at_first_dispatch = self.rows_added
        m = metrics.current()
        m.count("screen_tiles", 1)
        m.count("screen_pairs_computed", self.block * self.block)
        b = self.block
        si, ai = self._x[bi * b:(bi + 1) * b], self._s[bi * b:(bi + 1) * b]
        sj, aj = self._x[bj * b:(bj + 1) * b], self._s[bj * b:(bj + 1) * b]
        self._queue.issue(si, sj, ai, aj, diag=bi == bj, row0=bi * b,
                          col0=bj * b)

    def finish(self) -> ScreenResult:
        """Drain every tile; the screen's pairs. Raises if a row was
        never fed."""
        self._check_open()
        try:
            if self.rows_added != self.n:
                raise RuntimeError(
                    f"screen finish() with {self.n - self.rows_added} rows "
                    "never fed")
            return self._queue.result()
        finally:
            self.close()

    def close(self) -> None:
        """Release what the sweep holds: the tiles still in flight (after
        a failure) and the checkpoint's file. Idempotent."""
        self._finished = True
        self._queue.abandon()
        if self._ckpt is not None:
            self._ckpt.close()
            if self.tiles_restored:
                metrics.current().count("screen_tiles_restored",
                                        self.tiles_restored)
                logger.info("Sweep checkpoint: %d tiles replayed, %d "
                            "logged in all", self.tiles_restored,
                            len(self._ckpt))
            self._ckpt = None


def _sweep(
    row_block: Callable[[int], Block],
    col_block: Callable[[int], Block],
    n_rows: int,
    n_cols: int,
    *,
    triangle: bool,
    queue: _TileQueue,
    block: int,
) -> ScreenResult:
    """Every tile of a sweep, in the reference's order: row block bi
    once per row of tiles, then column blocks bj >= bi (triangle; the
    diagonal tile reuses the row block) or every bj (rectangle), each
    issued into `queue`."""
    for bi in range(-(-n_rows // block)):
        si, ai = row_block(bi)
        for bj in range(bi if triangle else 0, -(-n_cols // block)):
            diag = triangle and bj == bi
            sj, aj = (si, ai) if diag else col_block(bj)
            queue.issue(si, sj, ai, aj, diag=diag, row0=bi * block,
                        col0=bj * block)
    return queue.result()


def _row_width(packed: Sequence[np.ndarray]) -> int:
    """Words per row, from the sequence's `row_width` hint when it has
    one (lazy rows), else from row 0."""
    return getattr(packed, "row_width", None) or len(packed[0])


def _host_block(
    packed: Sequence[np.ndarray], sizes_f: np.ndarray, lo: int, hi: int,
    device: torch.device,
) -> Block:
    """Rows [lo, hi) of a host row sequence, uploaded to `device`."""
    mat = np.stack([np.asarray(packed[t]) for t in range(lo, hi)])
    return (
        to_device(words_to_torch(mat).numpy(), device),
        to_device(sizes_f[lo:hi], device),
    )


def _streamer(
    packed: Sequence[np.ndarray], sizes_f: np.ndarray, block: int,
    device: torch.device,
) -> Callable[[int], Block]:
    n = len(packed)
    return lambda b: _host_block(
        packed, sizes_f, b * block, min(n, (b + 1) * block), device
    )


def _slicer(x: torch.Tensor, s: torch.Tensor, block: int):
    return lambda b: (x[b * block:(b + 1) * block], s[b * block:(b + 1) * block])


def screen_triangle_packed(
    packed: Sequence[np.ndarray],
    sizes: np.ndarray,
    k: int,
    min_containment: float,
    bits: int,
    device: torch.device,
    block: int = 0,
    cache_blocks: bool = True,
    matrix_builder: Optional[Callable[[int], torch.Tensor]] = None,
    checkpoint_path: Optional[str] = None,
    unit_names: Optional[Sequence[str]] = None,
) -> ScreenResult:
    """Upper-triangle screen over packed uint32 bitmap rows.

    packed: n rows of (bits/32,) uint32 words (any sequence; rows are
    read by index); sizes: (n,) set sizes. The packed matrix is uploaded
    to `device` once and swept by IncrementalPackedScreen, unless
    cache_blocks=False (low-memory mode) or the matrix exceeds
    _device_resident_budget: then each tile's blocks stream from the
    host (the reference's streaming branch, with its overflow rule).
    matrix_builder(n), when given, supplies the resident (n, W) int32
    matrix on `device` instead of the upload (the engine builds it from
    device-born sketch rows). checkpoint_path and unit_names turn on the
    resident sweep's mid-sweep checkpoint (IncrementalPackedScreen); the
    streaming sweep warns that it does not checkpoint, as the JAX
    package's does."""
    n = len(packed)
    if n == 0:
        return _empty_result()
    block = block or DEFAULT_BLOCK
    sizes_f = np.asarray(sizes).astype(np.float32)
    w = _row_width(packed)
    if cache_blocks and n * w * 4 <= _device_resident_budget(device):
        scr = IncrementalPackedScreen(n, k, min_containment, bits, device,
                                      block=block, row_width=w,
                                      checkpoint_path=checkpoint_path,
                                      unit_names=unit_names)
        try:
            if matrix_builder is not None:
                scr.set_prebuilt(matrix_builder(n), to_device(sizes_f, device))
            else:
                scr.set_prebuilt(*_host_block(packed, sizes_f, 0, n, device))
            return scr.finish()
        finally:
            scr.close()
    if checkpoint_path:
        logger.warning(
            "--sweep-checkpoint only applies to the resident sweep; "
            "this streaming sweep will NOT checkpoint mid-sweep")
    stream = _streamer(packed, sizes_f, block, device)
    queue = _TileQueue(bits, min_containment, block, k, streaming=True)
    return _sweep(stream, stream, n, n, triangle=True, queue=queue,
                  block=block)


def screen_rectangle_packed(
    query_packed: Sequence[np.ndarray],
    query_sizes: np.ndarray,
    ref_packed: Sequence[np.ndarray],
    ref_sizes: np.ndarray,
    k: int,
    min_containment: float,
    bits: int,
    device: torch.device,
    block: int = 0,
    cache_blocks: bool = True,
) -> ScreenResult:
    """Cross-group screen (reference-genome mode): every (query block,
    reference block) tile, never a diagonal. Returns (query_idx,
    ref_idx) pairs. Queries and references form one resident matrix,
    unless cache_blocks=False (low-memory mode) or the rectangle
    exceeds _device_resident_budget: then blocks stream from the host,
    with the streaming overflow rule. The budget check counts the
    block-padded rows the reference's resident matrix holds, so both
    packages take the same branch."""
    nq, nr = len(query_packed), len(ref_packed)
    if nq == 0 or nr == 0:
        return _empty_result()
    block = block or DEFAULT_BLOCK
    qs = np.asarray(query_sizes).astype(np.float32)
    rs = np.asarray(ref_sizes).astype(np.float32)
    w = _row_width(query_packed)
    padded_rows = -(-nq // block) * block + -(-nr // block) * block
    resident = (cache_blocks
                and padded_rows * w * 4 <= _device_resident_budget(device))
    queue = _TileQueue(bits, min_containment, block, k,
                       streaming=not resident)
    if resident:
        mat = np.stack([np.asarray(query_packed[t]) for t in range(nq)]
                       + [np.asarray(ref_packed[t]) for t in range(nr)])
        x = to_device(words_to_torch(mat).numpy(), device)
        s = to_device(np.concatenate([qs, rs]), device)
        del mat
        rows = _slicer(x[:nq], s[:nq], block)
        cols = _slicer(x[nq:], s[nq:], block)
    else:
        rows = _streamer(query_packed, qs, block, device)
        cols = _streamer(ref_packed, rs, block, device)
    return _sweep(rows, cols, nq, nr, triangle=False, queue=queue,
                  block=block)
