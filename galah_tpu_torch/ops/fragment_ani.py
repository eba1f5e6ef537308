"""Fragment-containment ANI — the verify stage
(counterpart of galah_tpu/ops/fragment_ani.py).

A query genome's fragment-level FracMinHash buckets are tested for
membership in a reference genome's bucket bitmap (a word gather and a
bit test); per-fragment shared-k-mer counts give per-fragment identity
(corrected containment)^(1/k); a direction's ANI is the mean identity of
aligned fragments and its AF the aligned share of usable fragments.

Two kernels:
- the pair-table kernel (ops/pair_table.py) for pairs whose streams both
  fit its budget: many directed pairs per batch; on a card the
  hand-written K7 (csrc/pair_table_verify.cu);
- the grouped kernel: one query stream against many reference bitmaps,
  for pairs with a stream over the budget. It tests each stream bucket
  either with one bitmap word gathered per (reference, position)
  (_forward_kernel: on a card the hand-written K8, csrc/grouped_verify.cu;
  on the CPU its plain version _forward_plain) or with one row of a
  bucket-major bit-transposed table gathered per position, which holds
  every reference's bit (_forward_kernel_bt over _bit_transpose_table,
  plain torch on every device); GALAH_TPU_VERIFY_GATHER=bt picks the
  second, words are the default (_verify_gather_mode). The plain word
  version and bt give the same bits; K8 the same AF and an ANI within
  float32 rounding of its identity sum.
Routing is per undirected pair, so a pair's two directions never mix the
two kernels' numerics (fixed-point vs float32 identity sums);
GALAH_TPU_VERIFY=pairtable|grouped forces one kernel for every pair.

Both read the query side's fragment streams from the stream arena
(StreamArena) when they are there: device-born streams are adopted into
it device to device as each sketch batch completes, host streams are
uploaded into it once per residency. GALAH_TPU_ARENA=0 turns the arena
off: every dispatch uploads its streams, as before the arena.

Over several shards (the engine's devices, a device possibly repeated)
each shard keeps its own bitmap pool and stream arena (_VerifyShard);
the grouped kernel's sources and the pair table's batches go round
robin over the first GALAH_TPU_VERIFY_DEVICES shards (verify_devices),
and device-born products are adopted on the first shard. Over several
processes, bidirectional() partitions its pairs round robin across
them and all-gathers the results (GALAH_TPU_MP_VERIFY=0 on process 0
computes every pair in every process instead).
"""

from __future__ import annotations

import functools
import logging
import os
import time
from collections import Counter, OrderedDict, defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from galah_tpu_torch import defaults
from galah_tpu_torch.ops.pair_table import (
    PairTableConfig,
    PairTableVerifier,
    check_bits,
    check_operands,
    check_rows,
    verify_launch_plan,
)
from galah_tpu_torch.parallel.mesh import process_count, process_index
from galah_tpu_torch.sketch.fracminhash import NativeSketch
from galah_tpu_torch.utils import metrics
from galah_tpu_torch.utils.convert import sketch_tensors, to_device, u32_to_i32

logger = logging.getLogger(__name__)

# Buckets scattered per bitmap-pool fill step (bounds the int64 index
# temporaries to ~128 MB).
_FILL_CHUNK = 1 << 24


@dataclass(frozen=True)
class FragmentAniConfig:
    k: int = 15
    member_bits: int = defaults.NATIVE_MEMBER_BITS
    min_fragment_hashes: int = 8
    min_fragment_identity: float = defaults.NATIVE_FRAGMENT_MIN_IDENTITY
    # References per grouped-kernel call, before the (R, N) budget below.
    max_refs_per_dispatch: int = 1024
    # Bitmap-pool rows kept resident (raised on CUDA devices).
    max_cached_bitmaps: int = 512


# Streams are counted padded to this many hashes when the grouped
# kernel's width is chosen (the reference's padded stream length).
_STREAM_PAD = 1 << 14

# The (R, N) intermediates' budget of one grouped dispatch, in elements.
_GROUPED_BUDGET = 256 << 20


def refs_per_dispatch(npad: int, cap: int) -> int:
    """Grouped-kernel width for a stream padded to npad hashes: the
    cap, chunked down by the budget on the (R, N) intermediates, floored
    at 8 and rounded down to a power of two."""
    r_chunk = max(8, min(cap, _GROUPED_BUDGET // max(1, npad)))
    return 1 << (r_chunk.bit_length() - 1)


def _round_up(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


def _verify_gather_mode() -> str:
    """How the grouped kernel tests stream buckets against reference
    bitmaps (the reference's GALAH_TPU_VERIFY_GATHER): "bt" when the
    variable says so, one row of the bit-transposed table gathered per
    position; else "word", one bitmap word per (reference, position),
    on every device. The reference's "auto" takes bt for narrow
    dispatches on an accelerator; here it is "word": on the H100
    (chip_smoke.py phase 16) bt's kernel beat word's only at 32
    references, by about 0.5 ms, and lost at 64 and 128, before the
    0.35-1.36 ms its table takes each dispatch. Both modes give the
    same AF, and on the CPU the same bits; on a card word's K8 sums
    identities in another order than bt's torch.sum."""
    return "bt" if os.environ.get("GALAH_TPU_VERIFY_GATHER") == "bt" \
        else "word"


def _ani_af_from_counts(m, M, popcount, bits, k, min_hashes, min_ident):
    """m: (..., F) hit counts; M: (..., F) fragment hash counts;
    popcount: (...,) ref bitmap popcount. Returns (ani_pct, af)."""
    p = (popcount / bits)[..., None]
    Mf = M.to(torch.float32)
    c = (m.to(torch.float32) - Mf * p) / torch.clamp(1.0 - p, min=1e-6)
    c = torch.minimum(torch.clamp(c, min=0.0), Mf)
    usable = M >= min_hashes
    cont = c / torch.clamp(Mf, min=1.0)
    ident = torch.pow(torch.clamp(cont, min=1e-30), 1.0 / k)
    aligned = usable & (ident >= min_ident)
    n_aligned = torch.sum(aligned, dim=-1, dtype=torch.int32)
    n_usable = torch.sum(usable, dim=-1, dtype=torch.int32)
    ani = torch.sum(
        torch.where(aligned, ident, torch.zeros_like(ident)), dim=-1
    ) / torch.clamp(n_aligned, min=1)
    af = n_aligned / torch.clamp(n_usable, min=1)
    return ani * 100.0, af


def _per_fragment_hits(
    bits_hit: torch.Tensor, offsets: torch.Tensor
) -> torch.Tensor:
    """Per-fragment hit counts (R, F) from an (R, N) 0/1 hit matrix and
    (F+1,) stream offsets: one int32 prefix sum along N and gathers at
    the offsets (the same integers as the reference's block-segmented
    prefixes)."""
    r = bits_hit.shape[0]
    h = torch.zeros(
        (r, bits_hit.shape[1] + 1), dtype=torch.int32, device=bits_hit.device
    )
    torch.cumsum(bits_hit, dim=1, dtype=torch.int32, out=h[:, 1:])
    off = offsets.long()
    return h[:, off[1:]] - h[:, off[:-1]]


def _forward_kernel(
    bitmaps: torch.Tensor,    # (C, W) int32 bitmap rows (pool or stack)
    rows: torch.Tensor,       # (R,) int64 rows of `bitmaps` to test against
    popcounts: torch.Tensor,  # (R,) float32
    buckets: torch.Tensor,    # (N,) int32 query fragment buckets
    offsets: torch.Tensor,    # (F+1,) int32 fragment offsets
    bits: int,
    k: int,
    min_hashes: int,
    min_ident: float,
    shard: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query's fragments against R reference bitmaps (word-gather
    mode). Returns (ani_pct (R,), af (R,)). A CPU tensor takes the plain
    version; a CUDA tensor launches K8 on the current stream or raises,
    with no host sync. K8 holds each reference's row in shared memory
    (ops/pair_table.py::verify_launch_plan) and requires what every
    stream producer gives: buckets ascending within each fragment (the
    plain version takes any order), and rows as check_rows says. K8's
    counts and AF equal the plain version's; its identity sum runs in
    another order than torch.sum, so its ANI may differ in the last
    float32 bits. `shard` is where the launch is also counted in
    `per_shard`."""
    check_bits(bits)
    if bitmaps.device.type == "cpu":
        return _forward_plain(bitmaps, rows, popcounts, buckets, offsets,
                              bits, k, min_hashes, min_ident)
    if bitmaps.device.type != "cuda":
        raise ValueError(f"unsupported device {bitmaps.device}")
    check_operands((bitmaps, buckets, offsets), torch.int32)
    check_operands((rows,), torch.int64)
    check_operands((popcounts,), torch.float32)
    if len({t.device for t in (bitmaps, rows, popcounts, buckets,
                               offsets)}) != 1:
        raise ValueError("the kernel's operands are on different devices")
    if (rows.shape != popcounts.shape or rows.dim() != 1
            or bitmaps.dim() != 2 or offsets.dim() != 1
            or offsets.shape[0] < 1):
        raise ValueError(
            f"operands do not fit: rows {tuple(rows.shape)}, popcounts "
            f"{tuple(popcounts.shape)}, bitmaps {tuple(bitmaps.shape)}, "
            f"offsets {tuple(offsets.shape)}")
    plan = verify_launch_plan(bits)
    check_rows(bitmaps, bits)
    from galah_tpu_torch.ops._build import load_library

    lib = load_library()
    r = rows.shape[0]
    frags = offsets.shape[0] - 1
    dev = bitmaps.device
    ani = torch.empty(r, dtype=torch.float32, device=dev)
    af = torch.empty(r, dtype=torch.float32, device=dev)
    words = lib.galah_grouped_verify_scratch_words(frags, r)
    scratch = torch.empty(max(words, 1), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.galah_grouped_verify(
            buckets.data_ptr(), offsets.data_ptr(), frags,
            bitmaps.data_ptr(), bitmaps.shape[1], rows.data_ptr(),
            popcounts.data_ptr(), r, *plan, 1.0 / bits, 1.0 / k,
            min_hashes, min_ident, ani.data_ptr(), af.data_ptr(),
            scratch.data_ptr(), scratch.numel(), stream)
    if err != 0:
        raise RuntimeError(
            f"galah_grouped_verify launch failed: CUDA error {err} "
            f"(references={r}, fragments={frags}, {plan})")
    _K8.launches += 1
    if shard is not None:
        _K8.per_shard[shard] += 1
    return ani, af


_forward_kernel.launches = 0
_forward_kernel.per_shard = Counter()
# The wrapper's own function object (as ops/pair_table.py's _K7).
_K8 = _forward_kernel


def _forward_plain(
    bitmaps: torch.Tensor,
    rows: torch.Tensor,
    popcounts: torch.Tensor,
    buckets: torch.Tensor,
    offsets: torch.Tensor,
    bits: int,
    k: int,
    min_hashes: int,
    min_ident: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K8 (_forward_kernel's arguments): an (R, N)
    word gather and bit test, per-fragment hits from one prefix sum, and
    the epilogue. Returns (ani_pct (R,), af (R,))."""
    W = bitmaps.shape[1]
    M = offsets[1:] - offsets[:-1]
    word_idx = rows[:, None] * W + (buckets >> 5).long()[None, :]
    words = bitmaps.reshape(-1)[word_idx]                 # (R, N)
    bits_hit = (words >> (buckets & 31)[None, :]) & 1
    m = _per_fragment_hits(bits_hit, offsets)
    return _ani_af_from_counts(
        m, M[None, :], popcounts, float(bits), k, min_hashes, min_ident
    )


def _bit_transpose_table(bitmaps: torch.Tensor) -> torch.Tensor:
    """(R, W) int32 bitmap rows (R a multiple of 32) -> the bucket-major
    bit table T, (32 W, R // 32) int32, with

        (T[b, g] >> r) & 1 == (bitmaps[32 g + r, b >> 5] >> (b & 31)) & 1

    so row b holds every reference's bit of bucket b (the reference's
    _bit_transpose_table). A butterfly 32 x 32 bit transpose of each
    group of 32 rows, vectorised over words and groups: 5 passes of
    mask, shift and xor. Right shifts of int32 are arithmetic, so each
    is masked: every pass's mask has zeros in its top j bits, where the
    sign bits would land."""
    r, w = bitmaps.shape
    if r % 32:
        raise ValueError(f"bit transpose of {r} rows, not a multiple of 32")
    blk = bitmaps.reshape(r // 32, 32, w)
    j, m = 16, 0x0000FFFF
    while j:
        xr = blk.reshape(r // 32, -1, 2, j, w)
        upper, lower = xr[:, :, 0], xr[:, :, 1]
        t = ((upper >> j) ^ lower) & m
        blk = torch.stack([upper ^ (t << j), lower ^ t], dim=2).reshape(
            r // 32, 32, w)
        j >>= 1
        m ^= (m << j) & 0xFFFFFFFF
    # T[32 w + s, g] = blk[g, s, w]; the last mask is 0x55555555, and
    # every mask fits an int32.
    return blk.permute(2, 1, 0).reshape(w * 32, r // 32).contiguous()


def _forward_kernel_bt(
    table: torch.Tensor,      # (bits, G) int32 bit-transposed table
    popcounts: torch.Tensor,  # (R,) float32, R <= 32 G
    buckets: torch.Tensor,    # (N,) int32 query fragment buckets
    offsets: torch.Tensor,    # (F+1,) int32 fragment offsets
    bits: int,
    k: int,
    min_hashes: int,
    min_ident: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query's fragments against the first R references of a
    bit-transposed table (the reference's _forward_kernel_bt): one
    G-word row gathered per stream position gives every reference's
    bit. The padding references past R are cut before the per-fragment
    counts, so the rest runs on the same (R, F) shapes as
    _forward_plain and gives the same bits. Returns (ani_pct (R,),
    af (R,))."""
    r = popcounts.shape[0]
    M = offsets[1:] - offsets[:-1]
    rows = table.index_select(0, buckets)                 # (N, G)
    shifts = torch.arange(32, dtype=torch.int32, device=table.device)
    bits_hit = ((rows.t()[:, None, :] >> shifts[None, :, None]) & 1).reshape(
        -1, rows.shape[0])[:r]                            # (R, N)
    m = _per_fragment_hits(bits_hit, offsets)
    return _ani_af_from_counts(
        m, M[None, :], popcounts, float(bits), k, min_hashes, min_ident
    )


class _BitmapPool:
    """Device-resident member-bitmap cache: one (C, W) int32 tensor of
    bitmap rows and a host LRU from genome key to row. Grows
    geometrically up to hard_cap (and past it when one request needs
    more rows), then evicts least-recently-used rows."""

    def __init__(
        self, words: int, device: torch.device, capacity: int, hard_cap: int
    ) -> None:
        self.words = words
        self.device = device
        self.capacity = capacity
        self.hard_cap = max(hard_cap, capacity)
        self._rows: "OrderedDict[object, int]" = OrderedDict()
        self._next = 0
        self._popc = np.zeros(capacity, np.float32)
        self.buffer = torch.zeros(
            (capacity, words), dtype=torch.int32, device=device
        )

    def _grow_to(self, new_cap: int) -> None:
        extra = new_cap - self.capacity
        self.buffer = torch.cat([
            self.buffer,
            torch.zeros((extra, self.words), dtype=torch.int32,
                        device=self.device),
        ])
        self._popc = np.concatenate([self._popc, np.zeros(extra, np.float32)])
        self.capacity = new_cap

    def _row_for(self, key) -> int:
        if self._next < self.capacity:
            r = self._next
            self._next += 1
        else:
            _, r = self._rows.popitem(last=False)  # LRU evict
        self._rows[key] = r
        return r

    def ensure(self, keys, sketches: Sequence[NativeSketch]) -> None:
        """Make every (key, sketch) resident; one request's keys always
        coexist."""
        missing: List[Tuple] = []
        seen = set()
        for key, s in zip(keys, sketches):
            if key in seen:
                continue
            seen.add(key)
            if key in self._rows:
                self._rows.move_to_end(key)
            else:
                missing.append((key, s))
        if not missing:
            return
        want = min(
            max(len(self._rows) + len(missing), self.capacity),
            max(self.hard_cap, len(seen)),
        )
        if want > self.capacity:
            self._grow_to(1 << (want - 1).bit_length())
        rows, buckets, lens = [], [], []
        for key, s in missing:
            r = self._row_for(key)
            self._popc[r] = float(s.member_popcount)
            rows.append(r)
            buckets.append(np.asarray(s.member_buckets, np.int32))
            lens.append(len(s.member_buckets))
        self._fill(rows, buckets, lens)

    def _fill(self, rows, buckets, lens) -> None:
        """Zero the rows, then scatter their buckets' bits. Distinct
        buckets set distinct bits, so adding them equals OR-ing them."""
        self.buffer[torch.tensor(rows, device=self.device)] = 0
        lo = 0
        while lo < len(rows):
            hi, total = lo, 0
            while hi < len(rows) and (hi == lo or total + lens[hi] <= _FILL_CHUNK):
                total += lens[hi]
                hi += 1
            b = torch.from_numpy(np.concatenate(buckets[lo:hi])).to(self.device)
            r = torch.repeat_interleave(
                torch.tensor(rows[lo:hi], dtype=torch.int64, device=self.device),
                torch.tensor(lens[lo:hi], dtype=torch.int64, device=self.device),
                output_size=total,
            )
            flat = r * self.words + (b >> 5).long()
            val = u32_to_i32(torch.ones_like(flat) << (b & 31).long())
            self.buffer.view(-1).index_add_(0, flat, val)
            lo = hi

    def adopt(self, keys, src: torch.Tensor, src_rows: Sequence[int],
              popcounts: Sequence[float]) -> None:
        """Make `keys` resident by copying rows `src_rows` of a
        device-born (G, W) bitmap tensor into the pool, device to device
        (galah_tpu/ops/fragment_ani.py::_BitmapPool.adopt). Keys already
        resident stay as they are. Growth follows `ensure`, so one
        batch's keys never evict each other."""
        todo, seen = [], set()
        for i, key in enumerate(keys):
            if key in self._rows:
                self._rows.move_to_end(key)
            elif key not in seen:
                seen.add(key)
                todo.append(i)
        if not todo:
            return
        want = min(
            max(len(self._rows) + len(todo), self.capacity),
            max(self.hard_cap, len(todo)),
        )
        if want > self.capacity:
            self._grow_to(1 << (want - 1).bit_length())
        dst = []
        for i in todo:
            r = self._row_for(keys[i])
            self._popc[r] = float(popcounts[i])
            dst.append(r)
        rows = torch.tensor([src_rows[i] for i in todo], device=self.device)
        self.buffer.index_copy_(0, torch.tensor(dst, device=self.device),
                                src.index_select(0, rows))

    def rows(self, keys) -> Tuple[np.ndarray, np.ndarray]:
        """(rows (G,) int64, popcounts (G,) float32) host arrays for
        resident `keys`."""
        rows = np.empty(len(keys), np.int64)
        for i, key in enumerate(keys):
            rows[i] = self._rows[key]
            self._rows.move_to_end(key)
        return rows, self._popc[rows]


def _arena_enabled() -> bool:
    """Whether verify reads fragment streams from the stream arena;
    GALAH_TPU_ARENA=0 uploads them per dispatch instead (the
    reference's switch; results are the same either way)."""
    return os.environ.get("GALAH_TPU_ARENA", "1") != "0"


def _arena_capacities(device: torch.device) -> Tuple[int, int]:
    """(hash slots, fragment-offset slots) of the stream arena, int32
    each: 2^29 and 2^24 on a card (2 GiB and 64 MiB: the streams of
    100,000 contigs of 5 kb under --small-contigs take about 2.5 * 10^8
    and 6 * 10^5 of them, those of 1,024 genomes of 1 Mb fewer), 2^22
    and 2^18 on the CPU. GALAH_TPU_ARENA_HASHES / GALAH_TPU_ARENA_FRAGS
    override (the reference's variables)."""
    hc = os.environ.get("GALAH_TPU_ARENA_HASHES")
    fc = os.environ.get("GALAH_TPU_ARENA_FRAGS")
    dh, df = ((1 << 29, 1 << 24) if device.type == "cuda"
              else (1 << 22, 1 << 18))
    return int(hc) if hc else dh, int(fc) if fc else df


def _runs(items: Sequence[Tuple[int, int, int]]) -> List[Tuple[int, int, int]]:
    """(src, dst, length) copies merged where both sides continue the
    previous one."""
    out: List[List[int]] = []
    for src, dst, n in items:
        if out and out[-1][0] + out[-1][2] == src and \
                out[-1][1] + out[-1][2] == dst:
            out[-1][2] += n
        else:
            out.append([src, dst, n])
    return [tuple(r) for r in out]


class StreamArena:
    """Fragment streams resident on the device (counterpart of
    galah_tpu/ops/fragment_ani.py::StreamArena).

    One int32 buffer holds streams back to back (a unit's fragment
    buckets), another each unit's fragment offsets made absolute (its
    stream's position in the first buffer added), F + 1 slots a unit.
    The pair-table kernel addresses unique source streams through
    per-pair starts, so it reads both buffers in place; the grouped
    kernel reads a unit's span. A stream is uploaded at most once per
    residency (ensure), and a device-born one is copied in device to
    device with no upload at all (adopt).

    Allocation appends; when a stream does not fit, the whole arena
    resets (one request's streams are bounded far below the capacity,
    so a reset makes room). A stream larger than the arena is never
    resident: its callers upload it per dispatch. Every write is queued
    on the device's current stream, after the kernels queued before it
    that read what it overwrites, so a reset never reaches a dispatch
    already issued."""

    def __init__(self, device: torch.device, hash_capacity: int,
                 frag_capacity: int) -> None:
        self.device = device
        self.hash_capacity = hash_capacity
        self.frag_capacity = frag_capacity
        # Only spans are ever read, so the buffers need no zeroing.
        self.hashes = torch.empty(hash_capacity, dtype=torch.int32,
                                  device=device)
        self.offsets = torch.empty(frag_capacity, dtype=torch.int32,
                                   device=device)
        self._map: Dict[object, Tuple[int, int]] = {}
        self._hash_top = 0
        self._offs_top = 0
        self.resets = 0

    def reset(self) -> None:
        self._map.clear()
        self._hash_top = 0
        self._offs_top = 0
        self.resets += 1
        metrics.current().count("stream_arena_resets", 1)

    def span(self, key) -> Optional[Tuple[int, int]]:
        """(hash offset, offsets offset) if key is resident."""
        return self._map.get(key)

    def spans(self, keys) -> Dict[object, Tuple[int, int]]:
        """{key: (hash offset, offsets offset)} for resident keys only."""
        return {k: self._map[k] for k in keys if k in self._map}

    def _fits(self, nh: int, nf: int) -> bool:
        return nh <= self.hash_capacity and nf + 1 <= self.frag_capacity

    def would_reset(self, keys, sketches_by_key) -> bool:
        """Whether ensure(keys) would reset the arena (exact: nothing is
        padded). Only a reset moves what is resident."""
        need_h = need_f = 0
        seen = set()
        for k in keys:
            if k in self._map or k in seen:
                continue
            seen.add(k)
            sk = sketches_by_key[k]
            nh, nf = len(sk.frag_buckets), sk.n_fragments
            if self._fits(nh, nf):
                need_h += nh
                need_f += nf + 1
        return (self._hash_top + need_h > self.hash_capacity
                or self._offs_top + need_f > self.frag_capacity)

    def _alloc(self, key, nh: int, nf: int) -> None:
        """Reserve a stream of nh hashes and nf fragments, resetting the
        arena when it is full. The caller checked _fits."""
        if (self._hash_top + nh > self.hash_capacity
                or self._offs_top + nf + 1 > self.frag_capacity):
            logger.info("stream arena full (%d/%d hashes); resetting",
                        self._hash_top, self.hash_capacity)
            self.reset()
        self._map[key] = (self._hash_top, self._offs_top)
        self._hash_top += nh
        self._offs_top += nf + 1

    def _place(self, keys: Sequence, sizes: Sequence[Tuple[int, int]]):
        """Allocate every key not resident whose stream fits, with the
        reference's reset-safety rule: _alloc may reset the arena midway
        and drop both this request's earlier allocations and keys that
        were resident before it, so each attempt recomputes what is
        missing from the current map, and every key allocated in any
        attempt is (re)filled at its final span. Returns the positions
        in `keys` to fill."""
        fresh = set()
        for _ in (0, 1):
            for p, k in enumerate(keys):
                if k not in self._map and self._fits(*sizes[p]):
                    self._alloc(k, *sizes[p])
                    fresh.add(p)
            if all(k in self._map for p, k in enumerate(keys)
                   if self._fits(*sizes[p])):
                break
            self.reset()
        return sorted(p for p in fresh if keys[p] in self._map)

    def _fill_offsets(self, keys: Sequence, sketches: Sequence,
                      todo: Sequence[int]) -> None:
        """Each todo key's fragment offsets, made absolute, uploaded in
        runs of consecutive slots."""
        runs: List[List] = []
        for p in todo:
            h, o = self._map[keys[p]]
            offs = np.asarray(sketches[p].frag_offsets, np.int64) + h
            if runs and runs[-1][0] + runs[-1][1] == o:
                runs[-1][1] += len(offs)
                runs[-1][2].append(offs)
            else:
                runs.append([o, len(offs), [offs]])
        for o, n, parts in runs:
            self.offsets[o:o + n] = to_device(
                np.concatenate(parts).astype(np.int32), self.device)

    def _fill_host(self, keys: Sequence, sketches: Sequence,
                   todo: Sequence[int]) -> None:
        """Upload the todo keys' streams from their host sketches, in
        runs of consecutive slots: the arena's only stream upload
        (verify_stream_upload_bytes and _s count its stream bytes and
        host time)."""
        m = metrics.current()
        m.count("verify_streams_uploaded", len(todo))
        t0 = time.perf_counter()
        runs: List[List] = []
        for p in todo:
            h, _ = self._map[keys[p]]
            b = np.asarray(sketches[p].frag_buckets, np.int32)
            if runs and runs[-1][0] + runs[-1][1] == h:
                runs[-1][1] += len(b)
                runs[-1][2].append(b)
            else:
                runs.append([h, len(b), [b]])
        for h, n, parts in runs:
            self.hashes[h:h + n] = to_device(np.concatenate(parts),
                                             self.device)
            m.count("verify_stream_upload_bytes", 4 * n)
        self._fill_offsets(keys, sketches, todo)
        m.count("verify_stream_upload_s", time.perf_counter() - t0)

    def ensure(self, keys, sketches_by_key) -> Dict[object, Tuple[int, int]]:
        """Make every key's stream resident, uploading those that are
        not; returns {key: (hash offset, offsets offset)}. A key whose
        stream does not fit the arena at all is absent from the result
        (its caller uploads it per dispatch).

        Reset safety: an allocation may reset the arena midway, which
        drops both earlier allocations of this request and keys that
        were resident before it; _place re-allocates from the current
        map, and every key allocated in any attempt is filled at its
        final span."""
        uniq = list(dict.fromkeys(keys))
        sks = [sketches_by_key[k] for k in uniq]
        todo = self._place(uniq, [(len(s.frag_buckets), s.n_fragments)
                                  for s in sks])
        if todo:
            self._fill_host(uniq, sks, todo)
        return self.spans(keys)

    def adopt(self, keys, sketches, frag_buckets: torch.Tensor,
              stream_off: np.ndarray) -> None:
        """Adopt a device-sketch batch's streams: keys[u]'s stream is
        frag_buckets[stream_off[u]:stream_off[u + 1]] on the device
        (sketch_host_batch's products), copied into the arena device to
        device, in runs of consecutive units. Its offsets come from the
        batch's host sketches, which its one host copy already made.
        Keys already resident are skipped."""
        uniq = {}
        for u, k in enumerate(keys):
            if k not in self._map:
                uniq.setdefault(k, u)
        if not uniq:
            return
        ks = list(uniq)
        us = [uniq[k] for k in ks]
        todo = self._place(ks, [(len(sketches[u].frag_buckets),
                                 sketches[u].n_fragments) for u in us])
        copies = []
        for p in todo:
            u = us[p]
            lo, hi = int(stream_off[u]), int(stream_off[u + 1])
            copies.append((lo, self._map[ks[p]][0], hi - lo))
        for src, dst, n in _runs(copies):
            self.hashes[dst:dst + n] = frag_buckets[src:src + n]
        self._fill_offsets(ks, [sketches[u] for u in us], todo)

    def query(self, key, sk: NativeSketch
              ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """(buckets (N,) int32, offsets (F+1,) int32 relative to the
        stream) of a resident key's stream, read from the arena; None if
        it is not resident (galah_tpu/ops/fragment_ani.py::
        _query_from_arena)."""
        span = self._map.get(key)
        if span is None:
            return None
        h, o = span
        n = len(sk.frag_buckets)
        return self.hashes[h:h + n], self.offsets[o:o + sk.n_fragments + 1] - h


def verify_devices(devices: Sequence[torch.device]) -> List[torch.device]:
    """The shards (local devices) the verify fans its independent
    dispatches over, round robin: the first GALAH_TPU_VERIFY_DEVICES of
    them (1 restores the single-device behaviour), else all. Across
    processes the pair list is partitioned separately (bidirectional)."""
    devices = list(devices)
    cap = os.environ.get("GALAH_TPU_VERIFY_DEVICES")
    if cap is not None:
        devices = devices[: max(1, int(cap))]
    return devices


def _verify_shards(shards: List["_VerifyShard"],
                   devices: Sequence[torch.device]) -> List["_VerifyShard"]:
    """The first of `shards` that verify work goes to (verify_devices)."""
    return shards[:len(verify_devices(devices))]


class _VerifyShard:
    """One verify shard: its device, and its bitmap pool and stream
    arena, each allocated on first use (`used` says whether work ever
    landed here)."""

    def __init__(self, device: torch.device, words: int,
                 max_cached: int) -> None:
        self.device = device
        self._words = words
        self._max_cached = max_cached
        self._pool: Optional[_BitmapPool] = None
        self._arena: Optional[StreamArena] = None

    @property
    def used(self) -> bool:
        return self._pool is not None

    @property
    def pool(self) -> _BitmapPool:
        if self._pool is None:
            hard_cap = self._max_cached
            if self.device.type == "cuda":
                # ~2 GB of resident bitmaps: 4096 genomes at 2^22 bits.
                hard_cap = max(hard_cap, (2 << 30) // (self._words * 4))
            self._pool = _BitmapPool(self._words, self.device, capacity=64,
                                     hard_cap=hard_cap)
        return self._pool

    def arena(self) -> StreamArena:
        if self._arena is None:
            self._arena = StreamArena(self.device,
                                      *_arena_capacities(self.device))
        return self._arena


class FragmentAniEngine:
    """Device-side pair-ANI evaluator over NativeSketch data, on one
    device or over several shards (`devices`, the first the main one);
    owns each shard's bitmap pool, which both kernels read."""

    def __init__(self, cfg: FragmentAniConfig,
                 devices: Union[torch.device, Sequence[torch.device]]) -> None:
        self.cfg = cfg
        self.devices = ([devices] if isinstance(devices, torch.device)
                        else list(devices))
        self.device = self.devices[0]
        self.shards = [_VerifyShard(d, cfg.member_bits // 32,
                                    cfg.max_cached_bitmaps)
                       for d in self.devices]
        bitmap_bytes = cfg.member_bits // 8
        self.pair_table = PairTableVerifier(
            PairTableConfig(
                member_bits=cfg.member_bits,
                k=cfg.k,
                min_fragment_hashes=cfg.min_fragment_hashes,
                min_fragment_identity=cfg.min_fragment_identity,
                max_bitmaps=max(64, min(1024, (256 << 20) // bitmap_bytes)),
            ),
            # Not the bound verify_shards: the pair table would hold the
            # engine that holds it, a reference cycle that keeps every
            # shard's pool and 2 GiB arena after the run until the cyclic
            # collector runs.
            functools.partial(_verify_shards, self.shards, self.devices),
        )

    @property
    def pool(self) -> _BitmapPool:
        """The main shard's bitmap pool."""
        return self.shards[0].pool

    def verify_shards(self) -> List[_VerifyShard]:
        """The shards verify work goes to (verify_devices)."""
        return _verify_shards(self.shards, self.devices)

    def stream_arena(self) -> StreamArena:
        """The main shard's stream arena, allocated on first use."""
        return self.shards[0].arena()

    def adopt_batch(self, keys, sketches: Sequence[NativeSketch],
                    dev) -> None:
        """Adopt one device-sketch batch's products into the main
        shard, with no host round trip: its member bitmaps
        (dev["member_words"], rows in `keys` order) into the bitmap pool
        and, unless GALAH_TPU_ARENA=0, its fragment streams
        (dev["frag_buckets"], dev["stream_off"]) into the stream arena.
        The host sketches stay the fallback for any key the pool or the
        arena drops later, and for the other shards."""
        self.pool.adopt(keys, dev["member_words"], range(len(keys)),
                        [s.member_popcount for s in sketches])
        if _arena_enabled():
            self.stream_arena().adopt(keys, sketches, dev["frag_buckets"],
                                      dev["stream_off"])

    def _query_arrays(self, key, sk: NativeSketch, shard: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A query's (buckets, offsets) on a shard's device: read from
        its stream arena when the stream is resident there, else
        uploaded."""
        sh = self.shards[shard]
        if _arena_enabled() and sh._arena is not None:
            got = sh._arena.query(key, sk)
            if got is not None:
                return got
        metrics.current().count("verify_streams_uploaded", 1)
        st = sketch_tensors(sk, sh.device)
        return st.frag_buckets, st.frag_offsets

    def _ref_table(self, keys: List, refs: Sequence[NativeSketch],
                   rpad: int, shard: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The bit-transposed table of one reference group on a shard,
        its rows padded with zero bitmaps to rpad, and the group's
        popcounts. Built for each dispatch, uncached: the reference
        caches tables by group, but a verify sends each source against
        its own target list, so a group recurs only where two sources
        have the same targets."""
        sh = self.shards[shard]
        sh.pool.ensure(keys, list(refs))
        rows, pc = sh.pool.rows(keys)
        stack = sh.pool.buffer.index_select(0, to_device(rows, sh.device))
        table = _bit_transpose_table(
            torch.cat([stack, stack.new_zeros((rpad - len(keys),
                                               stack.shape[1]))]))
        return table, to_device(pc, sh.device)

    def one_to_many_issue(
        self,
        query: NativeSketch,
        query_key,
        refs: Sequence[NativeSketch],
        ref_keys: Sequence,
        shard: int = 0,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Queue the grouped kernel for `query`'s fragments against each
        ref's bitmap on one shard, without reading anything back (the
        reference's one_to_many_async). Returns (ani_pct (R,), af (R,))
        on the shard's device.

        References go in chunks of refs_per_dispatch of the query's
        padded stream length, capped at GALAH_TPU_VERIFY_REFS when set,
        else at max_refs_per_dispatch. A chunk gathers from the
        bit-transposed table (its references padded to a power of two,
        32 at least) when the gather mode says so and the padded
        (references, stream) intermediates fit the budget, else
        bitmap words."""
        cfg = self.cfg
        sh = self.shards[shard]
        dev = sh.device
        pool = sh.pool
        buckets, offsets = self._query_arrays(query_key, query, shard)
        npad = _round_up(len(query.frag_buckets), _STREAM_PAD)
        r_cap = (int(os.environ.get("GALAH_TPU_VERIFY_REFS", 0))
                 or cfg.max_refs_per_dispatch)
        r_chunk = refs_per_dispatch(npad, r_cap)
        mode = _verify_gather_mode()
        kw = dict(bits=cfg.member_bits, k=cfg.k,
                  min_hashes=cfg.min_fragment_hashes,
                  min_ident=cfg.min_fragment_identity)
        anis, afs = [], []
        for lo in range(0, len(refs), r_chunk):
            keys = list(ref_keys[lo : lo + r_chunk])
            chunk = list(refs[lo : lo + r_chunk])
            rpad_bt = max(32, 1 << (len(keys) - 1).bit_length())
            if mode == "bt" and rpad_bt * npad <= _GROUPED_BUDGET:
                table, pc = self._ref_table(keys, chunk, rpad_bt, shard)
                ani, af = _forward_kernel_bt(table, pc, buckets, offsets,
                                             **kw)
                metrics.current().count("verify_grouped_bt_dispatches", 1)
            else:
                pool.ensure(keys, chunk)
                rows, pc = pool.rows(keys)
                ani, af = _forward_kernel(
                    pool.buffer, to_device(rows, dev), to_device(pc, dev),
                    buckets, offsets, shard=shard, **kw)
                metrics.current().count("verify_grouped_word_dispatches", 1)
            anis.append(ani)
            afs.append(af)
        if not anis:
            empty = torch.empty(0, dtype=torch.float32, device=dev)
            return empty, empty
        return torch.cat(anis), torch.cat(afs)

    def one_to_many(
        self,
        query: NativeSketch,
        query_key,
        refs: Sequence[NativeSketch],
        ref_keys: Sequence,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """ANI/AF of `query`'s fragments against each ref's bitmap
        (grouped kernel). Returns (ani_pct (R,), af (R,))."""
        ani, af = self.one_to_many_issue(query, query_key, refs, ref_keys)
        return ani.cpu().numpy(), af.cpu().numpy()

    def bidirectional(self, pairs, sketches_by_key):
        """Bidirectional ANI over key pairs. With several processes the
        pair list is partitioned round robin across them and the (ani,
        af, af) rows all-gathered, unless process 0 set
        GALAH_TPU_MP_VERIFY=0. Lockstep contract: every process calls
        this with the same pair list, which the deterministic host
        pipeline guarantees. Results are float32 values either way, so
        the partition changes none of them.
        Returns {(a, b): (ani_pct, af_a_dir, af_b_dir)}."""
        nproc = process_count()
        if nproc > 1 and len(pairs) > 0:
            from galah_tpu_torch.parallel.mp import governed_flag

            partition = governed_flag("GALAH_TPU_MP_VERIFY")
        else:
            partition = False
        if not partition:
            return self._bidirectional_local(pairs, sketches_by_key)
        from galah_tpu_torch.parallel.mp import all_gather_equal

        pairs_list = list(pairs)
        mine = pairs_list[process_index()::nproc]
        local = self._bidirectional_local(mine, sketches_by_key)
        metrics.current().count("verify_mp_pairs_local", len(mine))
        chunk = -(-len(pairs_list) // nproc)
        vals = np.full((chunk, 3), np.nan, dtype=np.float32)
        for i, pr in enumerate(mine):
            vals[i] = local[pr]
        gathered = all_gather_equal(vals)
        out = {}
        for p in range(nproc):
            for i in range(chunk):
                gidx = p + i * nproc
                if gidx >= len(pairs_list):
                    break
                a, ff, fr = gathered[p][i]
                out[pairs_list[gidx]] = (float(a), float(ff), float(fr))
        return out

    def _bidirectional_local(self, pairs, sketches_by_key):
        """Bidirectional ANI over key pairs, in this process. Each
        undirected pair goes to the pair-table kernel when both streams
        are at most max_flat_hashes // 8 hashes, else both directions go
        to the grouped kernel. GALAH_TPU_VERIFY=pairtable|grouped sends
        every directed pair to that kernel instead, as the reference
        does; under pairtable a stream over max_flat_hashes raises the
        pair table's ValueError. The grouped kernel's sources go round
        robin over the verify shards (a stable assignment; every shard
        does the same float32 arithmetic, so results do not depend on
        the shard count)."""
        mode = os.environ.get("GALAH_TPU_VERIFY")
        if mode in ("grouped", "pairtable"):
            directed = sorted({d for a, b in pairs for d in ((a, b), (b, a))})
            small_pairs = directed if mode == "pairtable" else []
            large_pairs = directed if mode == "grouped" else []
        else:
            thresh = self.pair_table.cfg.max_flat_hashes // 8
            small_d, large_d = set(), set()
            for a, b in pairs:
                both_small = (
                    len(sketches_by_key[a].frag_buckets) <= thresh
                    and len(sketches_by_key[b].frag_buckets) <= thresh
                )
                (small_d if both_small else large_d).update(((a, b), (b, a)))
            small_pairs = sorted(small_d)
            large_pairs = sorted(large_d)

        m = metrics.current()
        if small_pairs:
            m.count("verify_directed_pairtable", len(small_pairs))
        if large_pairs:
            m.count("verify_directed_grouped", len(large_pairs))

        fwd = {}
        if small_pairs:
            fwd.update(self.pair_table.run(small_pairs, sketches_by_key))
        if large_pairs:
            directed = defaultdict(set)
            for a, b in large_pairs:
                directed[a].add(b)
            # Every source is queued before any result is read, and one
            # copy a shard brings them all home (the reference's
            # one_to_many_async, then collect).
            n_sh = len(self.verify_shards())
            issued = []
            for i, src in enumerate(sorted(directed)):
                targets = sorted(directed[src])
                issued.append((src, targets, i % n_sh, self.one_to_many_issue(
                    sketches_by_key[src], src,
                    [sketches_by_key[t] for t in targets], targets,
                    shard=i % n_sh,
                )))
            for sh in range(n_sh):
                mine = [it for it in issued if it[2] == sh]
                if not mine:
                    continue
                anis = torch.cat([a for *_, (a, _) in mine]).cpu().numpy()
                afs = torch.cat([f for *_, (_, f) in mine]).cpu().numpy()
                o = 0
                for src, targets, _, _ in mine:
                    for t in targets:
                        fwd[(src, t)] = (float(anis[o]), float(afs[o]))
                        o += 1
        out = {}
        for a, b in pairs:
            ani_f, af_f = fwd[(a, b)]
            ani_r, af_r = fwd[(b, a)]
            out[(a, b)] = (max(ani_f, ani_r), af_f, af_r)
        return out
