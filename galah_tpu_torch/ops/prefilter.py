"""All-vs-all sketch-intersection screen (counterpart of galah_tpu/ops/prefilter.py).

Genome prefilter sketches are packed uint32 bitmap rows (int32 tensors
holding the same bits). A sweep walks (block x block) tiles: the upper
triangle of one matrix (screen_triangle_packed) or every (query block,
reference block) tile of a rectangle (screen_rectangle_packed). Each
tile goes through two steps (_TileQueue):

- issue, device work only, with no host sync: intersection counts from
  the packed-popcount kernel (ops/packed_matmul.py, K1), then the
  epilogue (ops/screen_epilogue.py, K6 on a card): collision-corrected
  max containment in the reference's float32 operation order, the
  float32 cutoff and, on diagonal tiles, the strict-upper mask, with
  the hits extracted row-major into a fixed-capacity buffer, their
  values rounded to bfloat16; then one copy of that buffer home;
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

The u8 indicator screens (screen_triangle, screen_rectangle; the
engine's GALAH_TPU_SCREEN=indicator) sweep uint8 0/1 rows through the
same queue, their counts one matrix product a tile in the
GALAH_TPU_SCREEN_DTYPE dtype (_screen_matmul), under the streaming
overflow rule, which the reference's indicator sweep always applies.
Every dtype's counts are exact, so none changes a pair or an ANI value.
The packed screens' counts are K1's whatever GALAH_TPU_SCREEN_DTYPE
says. The packed screens' tile edge is the caller's, else
GALAH_TPU_SCREEN_BLOCK, else DEFAULT_BLOCK (_screen_block); the
indicator screens', as the reference's, the caller's or DEFAULT_BLOCK.

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
from galah_tpu_torch.ops.screen_epilogue import _bf16, screen_epilogue
# The containment stays importable from here, where the popcount screen
# and the tests read it.
from galah_tpu_torch.ops.screen_epilogue import _containment  # noqa: F401
from galah_tpu_torch.utils import metrics
from galah_tpu_torch.utils.convert import to_device, words_to_torch

logger = logging.getLogger(__name__)

DEFAULT_BLOCK = 1024

# The route recorded as `dtname` in a sweep checkpoint's fingerprint:
# the intersection counts are K1's, exact int32 (the JAX package records
# its matmul input dtype there).
SCREEN_ROUTE = "torch-k1-int32"

# GALAH_TPU_SCREEN_DTYPE's values (the JAX package's): the dtype of the
# indicator screens' 0/1 product ("int8x", the reference's int8 without
# its fused kernel, is int8 here). Counts are exact in every dtype, so
# pairs and ANI do not depend on it. The packed screens always count
# with K1.
SCREEN_DTYPES = {
    "int8": torch.int8,
    "int8x": torch.int8,
    "bf16": torch.bfloat16,
    "f32": torch.float32,
}

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


def _screen_block() -> int:
    """Tile edge of the packed screens when the caller gives none:
    GALAH_TPU_SCREEN_BLOCK, else DEFAULT_BLOCK on every device (the JAX
    package's edge model is priced in TPU tile rates)."""
    env = os.environ.get("GALAH_TPU_SCREEN_BLOCK")
    return int(env) if env else DEFAULT_BLOCK


def _screen_dtype_name(device: torch.device) -> str:
    """The product dtype GALAH_TPU_SCREEN_DTYPE names, else "int8" on a
    card and "f32" on the CPU (the JAX package's defaults); resolved
    once a sweep."""
    mode = os.environ.get("GALAH_TPU_SCREEN_DTYPE")
    if mode in SCREEN_DTYPES:
        return mode
    return "int8" if device.type == "cuda" else "f32"


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x with zero rows appended up to `rows` rows (x itself when it has
    as many)."""
    if x.shape[0] >= rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0], x.shape[1]))])


def _int_mm_rows(m: int) -> int:
    """Rows torch._int_mm takes for m rows on a card: more than 16, and
    (for its column operand) a multiple of 8."""
    return max(24, -(-m // 8) * 8)


def _screen_matmul(xu: torch.Tensor, yu: torch.Tensor) -> torch.Tensor:
    """(m, n) float32 intersection counts of two blocks of 0/1 rows,
    (m, K) and (n, K), in their dtype (the JAX package's _screen_matmul):
    int8 through torch._int_mm (int32 sums), bfloat16 and float32 as
    float32 sums. Every count is exact: below 2^31 in int32, below 2^24
    in float32 (K is at most 2^18). On a card _int_mm wants more than 16
    rows and column counts in multiples of 8, so both operands are
    padded with zero rows, which count 0, and the product cut back; a
    bfloat16 product there keeps its float32 sums (out_dtype), since a
    bfloat16 result would round every count above 256."""
    m, n = xu.shape[0], yu.shape[0]
    if xu.dtype == torch.int8:
        if xu.device.type == "cuda":
            counts = torch._int_mm(_pad_rows(xu, _int_mm_rows(m)),
                                   _pad_rows(yu, _int_mm_rows(n)).t())
            counts = counts[:m, :n]
        else:
            counts = torch._int_mm(xu, yu.t())
        return counts.to(torch.float32)
    if xu.dtype == torch.bfloat16:
        if xu.device.type == "cuda":
            return torch.mm(xu, yu.t(), out_dtype=torch.float32)
        xu, yu = xu.to(torch.float32), yu.to(torch.float32)
    return xu @ yu.t()


def _indicator_counts(dtname: str) -> Callable[..., torch.Tensor]:
    """The counts of two blocks of uint8 0/1 indicator rows in the
    dtype dtname names (int8 reinterprets the bytes, no copy)."""
    dt = SCREEN_DTYPES[dtname]

    def counts(si: torch.Tensor, sj: torch.Tensor) -> torch.Tensor:
        if dt == torch.int8:
            return _screen_matmul(si.view(torch.int8), sj.view(torch.int8))
        return _screen_matmul(si.to(dt), sj.to(dt))

    return counts


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
                 shard: Optional[int] = None,
                 counts: Optional[Callable[..., torch.Tensor]] = None
                 ) -> None:
        self.block = block
        self.bits_f = float(bits)
        self.min_cont_f = float(np.float32(min_containment))
        self.cap = cap or _screen_cap_for(block)
        self.inv_k = 1.0 / k
        self.streaming = streaming
        # The shard whose tiles this queue issues (parallel/distance.py),
        # passed to K1's and K6's wrappers for their per-shard launch counts.
        self.shard = shard
        # (row block, column block) -> float32 counts: the indicator
        # screens' product; None for K1's. (A default closing over self
        # would make the queue a reference cycle, and the engine it
        # reports to would outlive the run until the cyclic collector
        # ran.)
        self._counts = counts
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

    def _upper_mask(self, shape, device) -> torch.Tensor:
        key = (tuple(shape), device)
        if key not in self._upper:
            self._upper[key] = torch.ones(
                shape, dtype=torch.bool, device=device).triu_(1)
        return self._upper[key]

    def issue(self, si: torch.Tensor, sj: torch.Tensor, ai: torch.Tensor,
              aj: torch.Tensor, *, diag: bool, row0: int, col0: int) -> None:
        """Queue one tile (row block si with sizes ai against column
        block sj with sizes aj) and drain tiles past the window."""
        counts = (self._counts(si, sj) if self._counts else
                  packed_intersect_counts(si, sj, shard=self.shard))
        cont, hits = screen_epilogue(
            counts, ai, aj, bits_f=self.bits_f, min_cont_f=self.min_cont_f,
            diag=diag, cap=self.cap, streaming=self.streaming,
            shard=self.shard)
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
        self.block = block or _screen_block()
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
    block = block or _screen_block()
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
    block = block or _screen_block()
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


def _indicator_streamer(
    rows: Sequence[np.ndarray], sizes_f: np.ndarray, block: int,
    device: torch.device,
) -> Callable[[int], Block]:
    """Block b of uint8 indicator rows (and its sizes), uploaded."""
    n = len(rows)

    def make(b: int) -> Block:
        lo, hi = b * block, min(n, (b + 1) * block)
        mat = np.stack([np.asarray(rows[t], np.uint8) for t in range(lo, hi)])
        return to_device(mat, device), to_device(sizes_f[lo:hi], device)

    return make


def screen_triangle(
    indicators: Sequence[np.ndarray],
    sizes: np.ndarray,
    k: int,
    min_containment: float,
    device: torch.device,
    block: int = 0,
    cache_blocks: bool = True,
) -> ScreenResult:
    """Upper-triangle screen over uint8 0/1 indicator rows (the JAX
    package's screen_triangle, GALAH_TPU_SCREEN=indicator).

    indicators: n rows of (bits,) uint8, any sequence (rows are read by
    index, a block at a time). Each tile's counts are the 0/1 product in
    the GALAH_TPU_SCREEN_DTYPE dtype (_screen_matmul); the rest of the
    tile is the packed screens' issue and drain (_TileQueue) under the
    reference's streaming overflow rule, which its indicator sweep
    always applies. Blocks stay cached on the device unless cache_blocks
    is False (low-memory mode) or the n * bits bytes exceed the device
    budget; then they stream and one tile at most waits in flight (a
    deeper window would pin as many streamed blocks). The tile edge is
    the caller's, else DEFAULT_BLOCK: like the reference's indicator
    screens, these do not read GALAH_TPU_SCREEN_BLOCK. The sweep does not
    checkpoint."""
    n = len(indicators)
    if n == 0:
        return _empty_result()
    bits = len(indicators[0])
    block = block or DEFAULT_BLOCK
    sizes_f = np.asarray(sizes).astype(np.float32)
    if cache_blocks and n * bits > _device_resident_budget(device):
        logger.info("Indicator matrix (%d x %d) exceeds the device budget; "
                    "streaming column blocks", n, bits)
        cache_blocks = False
    queue = _TileQueue(bits, min_containment, block, k, streaming=True,
                       counts=_indicator_counts(_screen_dtype_name(device)))
    make = _indicator_streamer(indicators, sizes_f, block, device)
    if cache_blocks:
        cached: Dict[int, Block] = {}

        def get(b: int) -> Block:
            if b not in cached:
                cached[b] = make(b)
            return cached[b]
    else:
        queue.window = 1
        get = make
    return _sweep(get, get, n, n, triangle=True, queue=queue, block=block)


def screen_rectangle(
    query_indicators: Sequence[np.ndarray],
    query_sizes: np.ndarray,
    ref_indicators: Sequence[np.ndarray],
    ref_sizes: np.ndarray,
    k: int,
    min_containment: float,
    device: torch.device,
    block: int = 0,
) -> ScreenResult:
    """Cross-group screen over uint8 indicator rows (reference-genome
    mode under GALAH_TPU_SCREEN=indicator; the JAX package's
    screen_rectangle): every (query block, reference block) tile, the
    query block uploaded once per row of tiles and the reference block
    once per tile, with one tile at most in flight; the tile edge as in
    screen_triangle. Returns (query_idx, ref_idx) pairs."""
    nq, nr = len(query_indicators), len(ref_indicators)
    if nq == 0 or nr == 0:
        return _empty_result()
    bits = len(query_indicators[0])
    block = block or DEFAULT_BLOCK
    queue = _TileQueue(bits, min_containment, block, k, streaming=True,
                       counts=_indicator_counts(_screen_dtype_name(device)))
    queue.window = 1
    rows = _indicator_streamer(
        query_indicators, np.asarray(query_sizes).astype(np.float32), block,
        device)
    cols = _indicator_streamer(
        ref_indicators, np.asarray(ref_sizes).astype(np.float32), block,
        device)
    return _sweep(rows, cols, nq, nr, triangle=False, queue=queue,
                  block=block)
