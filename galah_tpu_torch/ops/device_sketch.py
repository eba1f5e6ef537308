"""FracMinHash sketching on the device
(counterpart of galah_tpu/ops/device_sketch.py).

A batch of units (genomes, or single contigs in contig mode) goes to the
device as raw sequence bytes, 1 byte a base, units back to back and a
genome's contigs joined by one separator byte. One pass over them (K5,
csrc/device_sketch.cu, on a CUDA tensor; `sketch_batch_reference`, plain
torch, on a CPU tensor) decodes each base, forms the canonical k-mer of
every start position, hashes it with splitmix64 and applies FracMinHash
selection: the member and prefilter bitmaps of each unit and, per
fragment, its sorted distinct member buckets, deduplicated on chip
(the reference's per-fragment dedup). torch turns the bitmaps into
sorted bucket lists with `torch.nonzero`, and the host arrays of every
NativeSketch of the batch come back in one copy. The result is
bit-identical to the host sketcher (sketch/fracminhash.py and the C++
one it calls), which reads the same bytes.

Host side, as in the reference: a genome's contigs are planned into
the reference's fragment bins in concatenated coordinates (`plan_layout`,
for a whole batch at once), and each unit is cut into K5's tiles of
whole fragments; units are batched by power-of-two padded length under
a byte budget and a per-unit memory cap (`_batch_genome_cap`); files are
read in two passes, lengths first, then a read per batch on a one-batch
read-ahead thread. Files are parsed by the C++ reader (the bytes the C++
sketcher hashes), and the parses of the length pass are kept for the
read pass within a byte budget, so a many-contig FASTA is parsed once.

Not carried over from the reference, which worked around the TPU and its
relay: 2-bit packing with a sparse list of invalid positions (PCIe moves
1 byte a base faster than the host packs it), the scatter/prefix-sum
fragment lookup, the routed and bitonic dedup networks over whole units,
the narrow transports and lazy host copies, the compile shadow (the CUDA
library builds in seconds, before any batch) and the overflow fallback
to the host sketcher (a fragment's list lives in its own positions, so
it cannot overflow).
"""

from __future__ import annotations

import ctypes
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from galah_tpu_torch import native_ext
from galah_tpu_torch.io.fasta import read_fasta
from galah_tpu_torch.sketch.fracminhash import NativeSketch, NativeSketchParams
from galah_tpu_torch.utils import metrics

# A unit is cut into K5's tiles at multiples of this many start
# positions, each cut inside a fragment moved back to the fragment's
# start: a tile holds at most TILE_POSITIONS + fragment_length - 1 starts.
TILE_POSITIONS = 8192
# K5's threads a block (one block a tile; at most 256).
K5_THREADS = 256
# The byte that joins a genome's contigs: it decodes invalid, so no k-mer
# spans two contigs.
SEPARATOR = 0
# Padded sequence bytes per batch, by device type.
GENOME_BATCH_BYTES = {"cuda": 64 << 20, "cpu": 8 << 20}
CONTIG_BATCH_BYTES = {"cuda": 256 << 20, "cpu": 8 << 20}
# Bitmap bits turned into bucket lists per step (bounds the unpacked
# temporaries to ~2 bytes a bit).
_UNPACK_BITS = 1 << 28
# Bytes of parsed FASTA files kept between the length pass and the read
# pass.
OPEN_FILE_BYTES = 2 << 30

_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB


# ----------------------------------------------------------------- host plan


def _check_params(params: NativeSketchParams) -> None:
    """The reference's preconditions (galah_tpu/ops/device_sketch.py:
    774-784) and the kernel's own, raised as ValueError: k-mers in 30
    bits, power-of-two widths of at least 32 bits, prefilter buckets no
    wider than member buckets, gsel a subset of fsel."""
    if params.k > 15:
        raise ValueError(f"device sketch packs k-mers in 30 bits: k={params.k}")
    for bits in (params.member_bits, params.prefilter_bits):
        if bits < 32 or bits & (bits - 1) or bits > 1 << 28:
            raise ValueError(f"device sketch widths are powers of two in "
                             f"[2^5, 2^28]: {bits}")
    if params.prefilter_bits > params.member_bits:
        raise ValueError("device sketch needs prefilter_bits <= member_bits")
    if params.genome_threshold > params.fragment_threshold:
        raise ValueError("device sketch needs genome_scale >= fragment_scale")


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def _excl_cumsum(x: np.ndarray) -> np.ndarray:
    """[0, x0, x0 + x1, ...], one longer than x, int64."""
    out = np.zeros(len(x) + 1, dtype=np.int64)
    np.cumsum(x, out=out[1:])
    return out


@dataclass
class HostBatch:
    """A batch planned on the host: numpy arrays K5 takes, and what the
    host needs to cut its outputs back into sketches. Unit u's bins are
    [bin_off[u], bin_off[u+1]): bin i starts at bounds[i] (unit
    coordinates, ascending from 0) and holds the batch-global fragment
    bin2frag[i], -1 for separators, gaps and the tail; fragment f covers
    the starts [frag_start[f], frag_end[f]) of its unit. Tile t holds the
    starts [tile_start[t], tile_end[t]) of unit tile_unit[t] and the
    whole fragments [tile_frag[t], tile_frag[t+1]); the tiles cover every
    position of every unit once, in order."""

    names: List[str]
    total_lens: List[int]
    seq: np.ndarray         # (N,) uint8, the units back to back
    contig_off: np.ndarray  # (C,) int64, each contig's first byte in seq
    unit_off: np.ndarray    # (G+1,) int64
    bounds: np.ndarray      # (B,) int32
    bin2frag: np.ndarray    # (B,) int32
    bin_off: np.ndarray     # (G+1,) int32
    frag_off: np.ndarray    # (G+1,) int64, each unit's first fragment
    frag_start: np.ndarray  # (F,) int32
    frag_end: np.ndarray    # (F,) int32
    frag_slot: np.ndarray   # (F+1,) int32, exclusive sum of fragment lengths
    tile_unit: np.ndarray   # (T,) int32
    tile_start: np.ndarray  # (T,) int32
    tile_end: np.ndarray    # (T,) int32
    tile_frag: np.ndarray   # (T+1,) int32
    starts: int             # k-mer start positions, all units
    read_s: float = 0.0     # host time reading and planning the batch

    @property
    def tile_cap(self) -> int:
        """Starts in the longest tile."""
        return int((self.tile_end - self.tile_start).max(initial=0))

    @property
    def max_tile_frags(self) -> int:
        """Fragments in the tile that holds the most."""
        return int(np.diff(self.tile_frag).max(initial=0))


def plan_layout(names: Sequence[str], contig_lens: Sequence[Sequence[int]],
                params: NativeSketchParams) -> HostBatch:
    """The layout of a batch whose unit u has contigs of contig_lens[u]
    bytes, with a separator-filled `seq` for the caller to copy each
    contig into at contig_off. The fragment bins are those of the
    reference's _plan_genome (galah_tpu/ops/device_sketch.py:684-721),
    one more -1 bin at each unit's end, computed for the whole batch at
    once: fragments by sketch/fracminhash.py::_fragment_boundaries's rule
    (full windows of fragment_length, a remainder of at least half a
    window, a whole contig of at least min_fragment_length), a gap bin
    before a fragment that does not start where the previous one of its
    unit ended, a tail bin when the unit runs on past its last
    fragment."""
    _check_params(params)
    k, L = params.k, params.fragment_length
    ncontigs = np.asarray([len(c) for c in contig_lens], dtype=np.int64)
    clen = np.asarray([n for c in contig_lens for n in c], dtype=np.int64)
    g, c = len(ncontigs), len(clen)
    cunit = np.repeat(np.arange(g), ncontigs)
    cfirst = _excl_cumsum(ncontigs)
    bases = _excl_cumsum(clen)
    total = bases[cfirst[1:]] - bases[cfirst[:-1]]
    ulen = total + np.maximum(ncontigs - 1, 0)
    if g and ulen.max() >= 1 << 31:
        raise ValueError("a unit of over 2^31 bytes exceeds what the device "
                         "sketch addresses within a unit")
    unit_off = _excl_cumsum(ulen)
    step = _excl_cumsum(clen + 1)
    coff = step[:-1] - step[cfirst[cunit]]          # within the unit

    nfull = clen // L
    nfrag = np.where(clen < L, (clen >= params.min_fragment_length),
                     nfull + (clen - nfull * L >= L // 2)).astype(np.int64)
    fcontig = np.repeat(np.arange(c), nfrag)
    fidx = np.arange(len(fcontig)) - _excl_cumsum(nfrag)[fcontig]
    fstart = coff[fcontig] + fidx * L
    fend = coff[fcontig] + np.minimum((fidx + 1) * L, clen[fcontig])
    funit = cunit[fcontig]
    nf = len(fcontig)
    frag_off = _excl_cumsum(np.bincount(funit, minlength=g))
    if frag_off[-1] >= 1 << 31:
        raise ValueError("device sketch batch too large: over 2^31 fragments")
    prev_end = np.zeros(nf, dtype=np.int64)
    prev_end[1:] = fend[:-1]
    prev_end[frag_off[:-1][frag_off[:-1] < frag_off[1:]]] = 0
    last_end = np.zeros(g, dtype=np.int64)
    has = frag_off[1:] > frag_off[:-1]
    last_end[has] = fend[frag_off[1:][has] - 1]

    # Items in bin order: each unit's fragments, then its tail. Each
    # item opens with a -1 bin when a gap (or the tail) precedes it.
    items = nf + g
    fpos = np.arange(nf) + funit
    tpos = frag_off[1:] + np.arange(g)
    pre = np.zeros(items, dtype=bool)
    pre_at = np.zeros(items, dtype=np.int64)
    main_at = np.zeros(items, dtype=np.int64)
    main_id = np.full(items, -1, dtype=np.int64)
    pre[fpos], pre_at[fpos] = fstart > prev_end, prev_end
    main_at[fpos], main_id[fpos] = fstart, np.arange(nf)
    pre[tpos], pre_at[tpos], main_at[tpos] = ulen > last_end, last_end, ulen
    eoff = _excl_cumsum(1 + pre)
    bounds = np.zeros(int(eoff[-1]), dtype=np.int32)
    bin2frag = np.full(int(eoff[-1]), -1, dtype=np.int32)
    bounds[eoff[:-1][pre]] = pre_at[pre]
    main = eoff[:-1] + pre
    bounds[main] = main_at
    bin2frag[main] = main_id

    frag_slot = _excl_cumsum(fend - fstart)
    if frag_slot[-1] >= 1 << 31:
        raise ValueError("device sketch batch too large: fragments cover "
                         "over 2^31 positions")
    tile_unit, tile_start, tile_end, tile_frag = _plan_tiles(
        unit_off, ulen, unit_off[funit] + fstart, unit_off[funit] + fend)
    return HostBatch(
        names=list(names),
        total_lens=total.tolist(),
        seq=np.full(int(unit_off[-1]), SEPARATOR, dtype=np.uint8),
        contig_off=unit_off[cunit] + coff,
        unit_off=unit_off,
        bounds=bounds,
        bin2frag=bin2frag,
        bin_off=np.append(eoff[frag_off[:-1] + np.arange(g)],
                          eoff[-1]).astype(np.int32),
        frag_off=frag_off,
        frag_start=fstart.astype(np.int32),
        frag_end=fend.astype(np.int32),
        frag_slot=frag_slot.astype(np.int32),
        tile_unit=tile_unit,
        tile_start=tile_start,
        tile_end=tile_end,
        tile_frag=tile_frag,
        starts=int(np.maximum(ulen - k + 1, 0).sum()),
    )


def _plan_tiles(unit_off: np.ndarray, ulen: np.ndarray, gfs: np.ndarray,
                gfe: np.ndarray):
    """K5's tiles of a batch whose fragments cover [gfs, gfe) in batch
    coordinates (ascending): each unit cut at every multiple of
    TILE_POSITIONS, a cut strictly inside a fragment moved back to its
    start. Returns (tile_unit, tile_start, tile_end, tile_frag) as
    HostBatch holds them."""
    ncut = -(-ulen // TILE_POSITIONS)
    cu = np.repeat(np.arange(len(ulen)), ncut)
    cut = unit_off[cu] + (np.arange(int(ncut.sum()))
                          - _excl_cumsum(ncut)[cu]) * TILE_POSITIONS
    if len(gfs):
        j = np.maximum(np.searchsorted(gfs, cut, side="right") - 1, 0)
        inside = (gfs[j] < cut) & (cut < gfe[j])
        cut = np.where(inside, gfs[j], cut)
    cut = np.unique(cut)
    unit = np.searchsorted(unit_off, cut, side="right") - 1
    end = np.append(cut[1:], unit_off[-1])
    frag = np.append(np.searchsorted(gfs, cut, side="left"), len(gfs))
    return (unit.astype(np.int32), (cut - unit_off[unit]).astype(np.int32),
            (end - unit_off[unit]).astype(np.int32), frag.astype(np.int32))


def plan_batch(names: Sequence[str], seq_lists: Sequence[Sequence[bytes]],
               params: NativeSketchParams) -> HostBatch:
    """The batch of `names`, each unit the contigs in its `seq_lists`
    entry, their bytes copied in."""
    hb = plan_layout(names, [[len(s) for s in seqs] for seqs in seq_lists],
                     params)
    for o, s in zip(hb.contig_off, (s for seqs in seq_lists for s in seqs)):
        hb.seq[o:o + len(s)] = np.frombuffer(s, dtype=np.uint8)
    return hb


# ------------------------------------------------------- device batch, K5


@dataclass
class DeviceBatch:
    """A HostBatch's arrays on a device, with the sketch parameters K5
    takes (the fragment bins stay on the host). `seq` is a view of N
    bytes on storage that runs 16 bytes further (K5 stages whole 16-byte
    vectors)."""

    seq: torch.Tensor         # (N,) uint8
    unit_off: torch.Tensor    # (G+1,) int64
    frag_off: torch.Tensor    # (G+1,) int32
    frag_start: torch.Tensor  # (F,) int32
    frag_end: torch.Tensor    # (F,) int32
    frag_slot: torch.Tensor   # (F+1,) int32
    tile_unit: torch.Tensor   # (T,) int32
    tile_start: torch.Tensor  # (T,) int32
    tile_end: torch.Tensor    # (T,) int32
    tile_frag: torch.Tensor   # (T+1,) int32
    n_units: int
    n_frags: int
    n_slots: int            # scratch slots K5 writes fragments' buckets into
    n_tiles: int
    tile_cap: int
    max_tile_frags: int
    starts: int
    k: int
    fthresh: int
    gthresh: int
    member_bits: int
    prefilter_bits: int

    @property
    def device(self) -> torch.device:
        return self.seq.device


_I32_FIELDS = ("frag_off", "frag_start", "frag_end", "frag_slot",
               "tile_unit", "tile_start", "tile_end", "tile_frag")


def upload_batch(hb: HostBatch, params: NativeSketchParams,
                 device: torch.device) -> DeviceBatch:
    """Three copies to `device`: the bytes (16 bytes of padding after
    them), the unit offsets, and the plan's fragment and tile arrays as
    int32 in one buffer, split into views."""
    n = hb.seq.size
    seq = torch.empty(n + 16, dtype=torch.uint8, device=device)
    seq[:n].copy_(torch.from_numpy(hb.seq))
    parts = [np.asarray(getattr(hb, f), dtype=np.int32) for f in _I32_FIELDS]
    flat = torch.from_numpy(np.concatenate(parts)).to(device)
    views = torch.split(flat, [len(p) for p in parts])
    return DeviceBatch(
        seq=seq[:n], unit_off=torch.from_numpy(hb.unit_off).to(device),
        **dict(zip(_I32_FIELDS, views)),
        n_units=len(hb.names), n_frags=len(hb.frag_start),
        n_slots=int(hb.frag_slot[-1]), n_tiles=len(hb.tile_unit),
        tile_cap=hb.tile_cap, max_tile_frags=hb.max_tile_frags,
        starts=hb.starts, k=params.k,
        fthresh=int(params.fragment_threshold),
        gthresh=int(params.genome_threshold),
        member_bits=params.member_bits, prefilter_bits=params.prefilter_bits,
    )


# Products of one batch: (member words (G, member_bits/32) int32,
# prefilter words (G, prefilter_bits/32) int32, distinct buckets per
# fragment (F,) int32, every fragment's distinct buckets in ascending
# order, fragments in order, (sum of the counts,) int32).
Products = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class SlotScratch:
    """K5's int32 scratch of fragment slots on a device, kept across a
    run's batches: allocated for the largest batch asked of it (callers
    that know their batches reserve the largest first) and reused."""

    def __init__(self) -> None:
        self.buffer: Optional[torch.Tensor] = None

    def get(self, n: int, device: torch.device) -> torch.Tensor:
        buf = self.buffer
        if buf is None or buf.device != device or buf.numel() < n:
            self.buffer = buf = None  # free it before the larger one
            self.buffer = buf = torch.empty(max(1, n), dtype=torch.int32,
                                            device=device)
        return buf[:n]


def sketch_batch(batch: DeviceBatch,
                 scratch: Optional[SlotScratch] = None) -> Products:
    """K5 on a CUDA batch, then each fragment's buckets gathered from
    their slots into one array (torch cumsum and indexing); the plain
    version on a CPU batch. A CUDA batch launches the kernel or raises.
    `scratch` keeps the slot buffer between batches."""
    dev = batch.device
    if dev.type == "cpu":
        return sketch_batch_reference(batch)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    g = batch.n_units
    member = torch.zeros((g, batch.member_bits // 32), dtype=torch.int32,
                         device=dev)
    pref = torch.zeros((g, batch.prefilter_bits // 32), dtype=torch.int32,
                       device=dev)
    counts = torch.empty(batch.n_frags, dtype=torch.int32, device=dev)
    slots = (scratch or SlotScratch()).get(batch.n_slots, dev)
    launch_k5(batch, member, pref, counts, slots)
    return member, pref, counts, gather_fragments(slots, counts,
                                                  batch.frag_slot)


def launch_k5(batch: DeviceBatch, member: torch.Tensor, pref: torch.Tensor,
              counts: torch.Tensor, slots: torch.Tensor, lib=None) -> None:
    """The K5 launch alone, into zeroed bitmaps, `counts` (F,) and
    `slots` (batch.n_slots,) int32; raises if the launch is refused (a
    block that needs more shared memory than the card has, too).
    `lib` is the kernel library (by default the one the wrappers load)."""
    from galah_tpu_torch.ops._build import load_library

    lib = lib or load_library()
    with torch.cuda.device(batch.device):
        stream = torch.cuda.current_stream(batch.device).cuda_stream
        err = lib.galah_device_sketch(
            batch.seq.data_ptr(), batch.unit_off.data_ptr(),
            batch.tile_unit.data_ptr(), batch.tile_start.data_ptr(),
            batch.tile_end.data_ptr(), batch.tile_frag.data_ptr(),
            batch.frag_start.data_ptr(), batch.frag_end.data_ptr(),
            batch.frag_slot.data_ptr(), batch.n_tiles, batch.tile_cap,
            batch.max_tile_frags, batch.k, batch.fthresh, batch.gthresh,
            batch.member_bits.bit_length() - 1,
            batch.prefilter_bits.bit_length() - 1,
            member.data_ptr(), pref.data_ptr(), counts.data_ptr(),
            slots.data_ptr(), K5_THREADS, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"galah_device_sketch launch failed: CUDA error {err} "
            f"(tiles={batch.n_tiles}, threads={K5_THREADS}, tile of up to "
            f"{batch.tile_cap} starts and {batch.max_tile_frags} fragments)"
        )
    sketch_batch.launches += 1


sketch_batch.launches = 0


def gather_fragments(slots: torch.Tensor, counts: torch.Tensor,
                     frag_slot: torch.Tensor) -> torch.Tensor:
    """Fragment f's counts[f] buckets from slots[frag_slot[f]...], for
    every fragment in order, as one int32 array (one host sync for its
    length)."""
    if counts.numel() == 0:
        return torch.empty(0, dtype=torch.int32, device=slots.device)
    ends = torch.cumsum(counts, 0)
    total = int(ends[-1])
    shift = frag_slot[:-1].long() - (ends - counts)
    idx = torch.arange(total, device=slots.device) + torch.repeat_interleave(
        shift, counts.long(), output_size=total)
    return slots[idx]


def k5_launch_shape(batch: DeviceBatch) -> Tuple[int, int, int, bool]:
    """(blocks, threads a block, shared memory a block in bytes, whether
    the instance with the member bitmap in shared memory runs) of K5's
    launch on `batch`, the last two as its launcher sizes them (asks the
    kernel library, so it needs the CUDA build)."""
    from galah_tpu_torch.ops._build import load_library

    narrow = ctypes.c_int(0)
    smem = load_library().galah_device_sketch_shared(
        batch.tile_cap, batch.max_tile_frags, batch.k,
        batch.member_bits.bit_length() - 1, ctypes.byref(narrow))
    return batch.n_tiles, K5_THREADS, int(smem), bool(narrow.value)


# ----------------------------------------------------------- plain version


def _srl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 `x` by 0 < r < 64: the arithmetic
    shift with the sign-extended bits masked off."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _i64(v: int) -> int:
    """The int64 holding the 64 bits of 0 <= v < 2^64."""
    return v - (1 << 64) if v >= 1 << 63 else v


def mix64_torch(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 tensors holding uint64 bits, exactly
    sketch/fracminhash.py::mix64: right shifts masked to be logical, the
    products left to wrap in two's complement."""
    x = x ^ _srl(x, 30)
    x = x * _i64(_M1)
    x = x ^ _srl(x, 27)
    x = x * _i64(_M2)
    return x ^ _srl(x, 31)


def lt_u64(x: torch.Tensor, t: int) -> torch.Tensor:
    """x < t as uint64, for int64 `x` holding uint64 bits: flip the sign
    bit of both sides and compare signed."""
    flip = -(1 << 63)
    return (x ^ flip) < _i64(t ^ (1 << 63))


def _decode_lut(device: torch.device) -> torch.Tensor:
    """Byte -> 2-bit code, 4 for anything but ACGT/acgt
    (sketch/kmers.py's table)."""
    lut = torch.full((256,), 4, dtype=torch.int64)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
        lut[b + 32] = i
    return lut.to(device)


def _words_from_bits(idx: torch.Tensor, g: int, bits: int) -> torch.Tensor:
    """(g, bits/32) int32 bitmap words with bit `idx % bits` of row
    `idx // bits` set, for flat bit indices `idx`."""
    ind = torch.zeros(g * bits, dtype=torch.int64, device=idx.device)
    ind.scatter_(0, idx, torch.ones_like(idx))
    shifts = torch.arange(32, dtype=torch.int64, device=idx.device)
    words = (ind.view(g, bits // 32, 32) << shifts).sum(dim=2)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def sketch_batch_reference(batch: DeviceBatch) -> Products:
    """Plain torch version of K5, on any device: reference_keys, then
    dedup_keys."""
    member, pref, keys = reference_keys(batch)
    return (member, pref,
            *dedup_keys(keys, batch.member_bits, batch.n_frags))


def dedup_keys(keys: torch.Tensor, member_bits: int,
               n_frags: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distinct buckets per fragment (F,) int32, the distinct buckets
    in fragment-then-bucket order int32) of keys fragment * member_bits
    + bucket, by torch sort, unique_consecutive and bincount."""
    uk = torch.unique_consecutive(torch.sort(keys).values)
    counts = torch.bincount(uk // member_bits, minlength=n_frags)
    return counts.to(torch.int32), (uk & (member_bits - 1)).to(torch.int32)


def reference_keys(batch: DeviceBatch):
    """(member words, prefilter words, keys (n,) int64) of a batch: the
    k-loop of shifts of the reference's _hash_front over the whole batch,
    splitmix64 in int64, torch.searchsorted for units and fragments (on
    the plan's fragment extents, not K5's tiles), scatter_ for the
    bitmaps; one key fragment * member_bits + bucket per
    fragment-selected start, in position order."""
    dev = batch.device
    g, k = batch.n_units, batch.k
    mb, pb = batch.member_bits, batch.prefilter_bits
    n = batch.seq.numel() - k + 1
    if n <= 0:
        return (torch.zeros((g, mb // 32), dtype=torch.int32, device=dev),
                torch.zeros((g, pb // 32), dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.int64, device=dev))
    codes = _decode_lut(dev)[batch.seq.long()]
    fwd = torch.zeros(n, dtype=torch.int64, device=dev)
    rev = torch.zeros(n, dtype=torch.int64, device=dev)
    bad = torch.zeros(n, dtype=torch.bool, device=dev)
    for j in range(k):
        cj = codes[j:j + n]
        fwd = (fwd << 2) | (cj & 3)
        rev = rev | ((3 - (cj & 3)) << (2 * j))
        bad |= cj > 3
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    unit = torch.searchsorted(batch.unit_off, pos, right=True) - 1
    valid = ~bad & (pos + k <= batch.unit_off[unit + 1])
    h = mix64_torch(torch.minimum(fwd, rev))
    fsel = valid & lt_u64(h, batch.fthresh)
    gsel = valid & lt_u64(h, batch.gthresh)
    member = _words_from_bits(unit[fsel] * mb + (h[fsel] & (mb - 1)), g, mb)
    pref = _words_from_bits(unit[gsel] * pb + (h[gsel] & (pb - 1)), g, pb)
    # Fragments in batch coordinates (ascending): a unit's shifted by its
    # offset. A start lies in fragment j, the last that starts at or
    # before it, when it also lies before j's end; gfe's trailing 0 turns
    # j = -1 (before every fragment) down.
    frag_unit = torch.repeat_interleave(
        torch.arange(g, device=dev), torch.diff(batch.frag_off).long(),
        output_size=batch.n_frags)
    gfs = batch.frag_start.long() + batch.unit_off[frag_unit]
    gfe = torch.cat([batch.frag_end.long() + batch.unit_off[frag_unit],
                     torch.zeros(1, dtype=torch.int64, device=dev)])
    sel = pos[fsel]
    frag = torch.searchsorted(gfs, sel, right=True) - 1
    inf = sel < gfe[frag]
    keys = frag[inf] * mb + (h[fsel][inf] & (mb - 1))
    return member, pref, keys


# -------------------------------------------------- products -> sketches


def _bits_to_buckets(words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Set bits of (G, W) int32 bitmap rows as (sorted buckets of each row
    back to back (n,) int32, per-row counts (G,) int64), by torch.nonzero
    on the rows unpacked a byte at a time."""
    g, w = words.shape
    as_bytes = words.contiguous().view(torch.uint8)  # little-endian
    masks = torch.tensor([1 << j for j in range(8)], dtype=torch.uint8,
                         device=words.device)
    rows = max(1, _UNPACK_BITS // max(1, w * 32))
    flat, counts = [], []
    for lo in range(0, g, rows):
        b = as_bytes[lo:lo + rows]
        bits = (b.unsqueeze(-1) & masks) != 0
        nz = torch.nonzero(bits.view(b.shape[0], -1))
        counts.append(torch.bincount(nz[:, 0], minlength=b.shape[0]))
        flat.append(nz[:, 1].to(torch.int32))
    if not flat:
        return (torch.empty(0, dtype=torch.int32, device=words.device),
                torch.zeros(0, dtype=torch.int64, device=words.device))
    return torch.cat(flat), torch.cat(counts)


class _Clock:
    """Marks on a device's timeline: CUDA events on a card (read once the
    batch has synchronised), the host clock on the CPU."""

    def __init__(self, device: torch.device) -> None:
        self.cuda = device.type == "cuda"
        self.marks: List = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> List[float]:
        """Seconds between consecutive marks. On a card it waits for the
        last mark: one recorded after the batch's host copy may not have
        completed yet, and elapsed_time refuses such an event."""
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def sketch_host_batch(
    hb: HostBatch, params: NativeSketchParams, device: torch.device,
    scratch: Optional[SlotScratch] = None,
) -> Tuple[List[NativeSketch], Dict[str, torch.Tensor]]:
    """Sketch a planned batch on `device`: upload, K5 and the gather of
    its fragment buckets (or the plain version on the CPU), bitmaps to
    bucket lists, one host copy. Returns the sketches and the device-born
    bitmaps {"member_words", "pref_words"}, (G, W) int32 rows in the
    batch's unit order. Adds the batch's split to the current metrics:
    sketch_{upload,kernel,unpack,copy}_s."""
    clock = _Clock(device)
    clock.mark()
    batch = upload_batch(hb, params, device)
    clock.mark()
    member, pref, frag_counts, frag_buckets = sketch_batch(batch, scratch)
    clock.mark()
    member_flat, member_counts = _bits_to_buckets(member)
    pref_flat, pref_counts = _bits_to_buckets(pref)
    g = len(hb.names)
    packed = torch.cat([
        member_counts.to(torch.int32), pref_counts.to(torch.int32),
        frag_counts, member_flat, pref_flat, frag_buckets,
    ])
    clock.mark()
    host = packed.cpu().numpy()
    clock.mark()
    up_s, k5_s, unpack_s, copy_s = clock.seconds()

    nf = int(hb.frag_off[-1])
    member_counts_h = host[:g].astype(np.int64)
    pref_counts_h = host[g:2 * g].astype(np.int64)
    frag_counts_h = host[2 * g:2 * g + nf].astype(np.int64)
    o = 2 * g + nf
    n_member = int(member_counts_h.sum())
    n_pref = int(pref_counts_h.sum())
    member_all = host[o:o + n_member]
    pref_all = host[o + n_member:o + n_member + n_pref]
    frag_all = host[o + n_member + n_pref:]
    m_off = _excl_cumsum(member_counts_h)
    p_off = _excl_cumsum(pref_counts_h)
    f_off = _excl_cumsum(frag_counts_h)
    sketches = []
    for i, name in enumerate(hb.names):
        f0, f1 = int(hb.frag_off[i]), int(hb.frag_off[i + 1])
        sketches.append(NativeSketch(
            name=name,
            total_len=hb.total_lens[i],
            prefilter_buckets=pref_all[p_off[i]:p_off[i + 1]],
            frag_buckets=frag_all[f_off[f0]:f_off[f1]],
            frag_offsets=f_off[f0:f1 + 1] - f_off[f0],
            member_buckets=member_all[m_off[i]:m_off[i + 1]],
            params=params,
        ))
    m = metrics.current()
    for name, v in (("sketch_read_s", hb.read_s), ("sketch_upload_s", up_s),
                    ("sketch_kernel_s", k5_s), ("sketch_unpack_s", unpack_s),
                    ("sketch_copy_s", copy_s)):
        m.count(name, v)
    m.count("sketch_device_batches", 1)
    m.count("sketch_upload_bytes", int(hb.seq.nbytes))
    return sketches, {"member_words": member, "pref_words": pref}


def device_sketch_batch(
    names: Sequence[str],
    seq_lists: Sequence[Sequence[bytes]],
    params: NativeSketchParams,
    device: torch.device,
    *,
    return_device: bool = False,
):
    """Sketch a batch of units on `device`, bit-identical to
    sketch_sequences_native: names and, per unit, its contig sequences.
    Returns the sketches, or with return_device (sketches, device-born
    bitmaps) as sketch_host_batch does."""
    sketches, dev = sketch_host_batch(
        plan_batch(names, seq_lists, params), params, device)
    return (sketches, dev) if return_device else sketches


# ----------------------------------------------------------------- batching


def _batch_genome_cap(P: int, params: NativeSketchParams,
                      device: torch.device) -> int:
    """Most units of padded length P in one batch, so that the batch's
    per-unit device buffers stay within a quarter of the card's memory
    (1 GiB on the CPU): both bitmaps, the sequence bytes, K5's int32 slot
    per fragment position, and the gather of the expected distinct
    buckets (galah_tpu/ops/device_sketch.py::_batch_genome_cap, sized for
    this layout)."""
    if device.type == "cuda":
        budget = torch.cuda.mem_get_info(device)[1] // 4
    else:
        budget = 1 << 30
    per_unit = (
        (params.member_bits + params.prefilter_bits) // 8
        + 5 * P
        + 32 * (P // max(1, params.fragment_scale) + 1)
    )
    return max(1, budget // per_unit)


def _run_scratch(device: torch.device, batch_bases) -> SlotScratch:
    """A run's K5 scratch, allocated up front on a card for its largest
    batch (a batch's fragments cover at most its bases)."""
    scratch = SlotScratch()
    if device.type == "cuda":
        scratch.get(max(batch_bases, default=0), device)
    return scratch


def _chunks(buckets: Dict[int, list], max_batch_bytes: int,
            params: NativeSketchParams, device: torch.device) -> List[list]:
    """Each length bucket's items cut into batches, buckets in ascending
    padded length."""
    out = []
    for P, items in sorted(buckets.items()):
        per = max(1, min(max_batch_bytes // max(P, 1),
                         _batch_genome_cap(P, params, device)))
        out += [items[i:i + per] for i in range(0, len(items), per)]
    return out


# ----------------------------------------------------------------- reading


class _FastaSource:
    """Random access to one FASTA file's records: the C++ reader's parse
    when it loads (the bytes the C++ sketcher hashes; a record's bytes
    are copied straight into a batch buffer, with the GIL released), else
    io/fasta.py's records."""

    def __init__(self, path: str) -> None:
        if native_ext.available():
            self._fasta = native_ext.NativeFasta(path)
            lib, h = self._fasta.lib, self._fasta.handle
            self.lengths = [int(lib.gt_record_seq_len(h, i))
                            for i in range(self._fasta.num_records())]
            self._records = None
        else:
            self._fasta = None
            self._records = [(r.name, r.seq) for r in read_fasta(path)]
            self.lengths = [len(seq) for _, seq in self._records]
        self.nbytes = sum(self.lengths)

    def name(self, i: int) -> str:
        """Record i's header line (tabs kept)."""
        return self._fasta.name(i) if self._fasta else self._records[i][0]

    def copy_into(self, i: int, out: np.ndarray) -> None:
        """Record i's bytes into the uint8 view `out` of its length."""
        if self._fasta is None:
            out[:] = np.frombuffer(self._records[i][1], dtype=np.uint8)
        else:
            self._fasta.lib.gt_record_seq_copy(
                self._fasta.handle, i,
                ctypes.cast(out.ctypes.data, ctypes.c_char_p))


class _OpenFiles:
    """Parsed files of a corpus, kept while their bytes stay within
    OPEN_FILE_BYTES (least recently used out first, the newest always
    kept), so the read pass finds most files the length pass parsed: a
    many-contig FASTA is parsed once. Where the reference kept forward
    read cursors on a streaming parser (galah_tpu/ops/device_sketch.py:
    1179-1228), the C++ reader's parse gives random access.

    Under low memory the length pass keeps only the newest parse, as the
    reference's one-file-at-a-time length pass (galah_tpu/ops/
    device_sketch.py:1638-1648), and `plan` keeps it only if the first
    batch reads its file; the read pass drops a parse once the last
    batch that reads its file (`plan`) has read it. So each file is
    parsed at most twice (a lone contig FASTA once), and host memory
    holds the files of the batch being read plus those an earlier batch
    read that a later one still needs. A genome file is read by one
    batch, so that is the batch's files. `held` and `peak` are the bytes
    of the parses kept, now and at most."""

    def __init__(self, paths: Sequence[str], low_memory: bool = False) -> None:
        self._paths = paths
        self._low_memory = low_memory
        self._budget = 0 if low_memory else OPEN_FILE_BYTES
        self._lru: "OrderedDict[int, _FastaSource]" = OrderedDict()
        self._lock = threading.Lock()
        self._uses: List[List[int]] = []
        self._last: Dict[int, int] = {}
        self.parsed = 0
        self.held = 0
        self.peak = 0

    def _drop(self, keep) -> None:
        with self._lock:
            for i in [i for i in self._lru if not keep(i)]:
                self.held -= self._lru.pop(i).nbytes

    def plan(self, uses: Sequence[Sequence[int]]) -> None:
        """The files each batch reads, in the order batches are read."""
        self._uses = [list(u) for u in uses]
        self._last = {i: ci for ci, u in enumerate(self._uses) for i in u}
        if self._low_memory:
            first = set(self._uses[0]) if self._uses else set()
            self._drop(first.__contains__)
            self._budget = float("inf")  # released by last use instead

    def batch(self, ci: int,
              ex: Optional[ThreadPoolExecutor] = None) -> List[_FastaSource]:
        """The parses of batch ci's files (`plan`), for its read (`ex`'s
        threads parse them when given); under low memory those whose
        file no later batch reads are dropped from the cache."""
        srcs = list((ex.map if ex else map)(self.get, self._uses[ci]))
        if self._low_memory:
            self._drop(lambda i: self._last.get(i) != ci)
        return srcs

    def get(self, i: int) -> _FastaSource:
        with self._lock:
            src = self._lru.get(i)
            if src is not None:
                self._lru.move_to_end(i)
                return src
        src = _FastaSource(self._paths[i])
        with self._lock:
            self.parsed += 1
            self._lru[i] = src
            self.held += src.nbytes
            self.peak = max(self.peak, self.held)
            while self.held > self._budget and len(self._lru) > 1:
                _, old = self._lru.popitem(last=False)
                self.held -= old.nbytes
        return src


def _read_batch(names: Sequence[str], pieces: Sequence[Sequence[Tuple]],
                params: NativeSketchParams, t0: float,
                ex: Optional[ThreadPoolExecutor] = None) -> HostBatch:
    """Plan a batch whose unit u is the records pieces[u] (each a
    (_FastaSource, record index)) and copy their bytes in, unit by unit
    on `ex` when given."""
    hb = plan_layout(names, [[src.lengths[i] for src, i in unit]
                             for unit in pieces], params)
    first = _excl_cumsum([len(unit) for unit in pieces])

    def fill(u: int) -> None:
        for (src, i), o in zip(pieces[u],
                               hb.contig_off[first[u]:first[u + 1]]):
            src.copy_into(i, hb.seq[o:o + src.lengths[i]])

    list((ex.map if ex else map)(fill, range(len(pieces))))
    hb.read_s = time.perf_counter() - t0
    return hb


def _joined_length(contig_lens: Sequence[int]) -> int:
    """A genome's bytes with its contigs joined by separators."""
    return sum(contig_lens) + max(0, len(contig_lens) - 1)


def _length_pass(ex: ThreadPoolExecutor, fn, n: int) -> list:
    """[fn(i) for i in range(n)], on `ex`'s threads, or on the calling
    thread for a single file: a fresh thread's first large parse took
    about 3x as long as the main thread's on the H100 host (likely the
    C++ reader growing a new malloc arena), and one file gains nothing
    from the pool."""
    return [fn(0)] if n == 1 else list(ex.map(fn, range(n)))


def _pipelined(n: int, read, process) -> Iterator:
    """Yield process(i, read(i)) for i in range(n), reading batch i + 1
    on a thread while batch i is processed and consumed. The time spent
    waiting for a read goes to the sketch_read_wait_s counter."""
    if n == 0:
        return
    with ThreadPoolExecutor(max_workers=1) as reader:
        fut = reader.submit(read, 0)
        for i in range(n):
            t0 = time.perf_counter()
            data = fut.result()
            metrics.current().count("sketch_read_wait_s",
                                    time.perf_counter() - t0)
            if i + 1 < n:
                fut = reader.submit(read, i + 1)
            yield process(i, data)


def iter_device_sketch_files(
    paths: Sequence[str], params: NativeSketchParams, device: torch.device,
    *, threads: int = 1, low_memory: bool = False,
) -> Iterator[Tuple[List[int], List[NativeSketch], Dict[str, torch.Tensor]]]:
    """Sketch whole genome files on `device`, batch by batch: yields
    (indices into `paths`, their sketches, the batch's device-born
    bitmaps). Pass 1 parses each file for its length and buckets the
    files by padded length; pass 2 reads each batch's files (`threads` at
    a time) one batch ahead of the device. With low_memory no parse is
    kept beyond the batch that reads it (_OpenFiles)."""
    _check_params(params)
    files = _OpenFiles(paths, low_memory)
    with ThreadPoolExecutor(max_workers=max(1, threads)) as ex:
        t0 = time.perf_counter()
        lengths = _length_pass(
            ex, lambda i: _joined_length(files.get(i).lengths), len(paths))
        metrics.current().count("sketch_lengths_s", time.perf_counter() - t0)
        buckets: Dict[int, List[int]] = {}
        for i, total in enumerate(lengths):
            buckets.setdefault(_next_pow2(max(total, params.k)), []).append(i)
        chunks = _chunks(buckets, GENOME_BATCH_BYTES[device.type], params,
                         device)
        files.plan(chunks)

        def read(ci: int) -> HostBatch:
            t0 = time.perf_counter()
            srcs = files.batch(ci, ex)
            return _read_batch(
                [paths[i] for i in chunks[ci]],
                [[(src, j) for j in range(len(src.lengths))] for src in srcs],
                params, t0, ex)

        scratch = _run_scratch(
            device, (sum(lengths[i] for i in c) for c in chunks))
        yield from _pipelined(len(chunks), read, lambda ci, hb: (
            chunks[ci], *sketch_host_batch(hb, params, device, scratch)))


def device_sketch_files(
    paths: Sequence[str], params: NativeSketchParams, device: torch.device,
    **kw,
) -> List[NativeSketch]:
    """One sketch per genome file, in `paths` order
    (iter_device_sketch_files, collected)."""
    out: List[Optional[NativeSketch]] = [None] * len(paths)
    for idx, sketches, _ in iter_device_sketch_files(paths, params, device,
                                                     **kw):
        for i, sk in zip(idx, sketches):
            out[i] = sk
    return out  # type: ignore[return-value]


def iter_device_sketch_contig_files(
    paths: Sequence[str], params: NativeSketchParams, device: torch.device,
    *, threads: int = 1, low_memory: bool = False,
) -> Iterator[Tuple[List[Tuple[int, int]], List[NativeSketch],
                    Dict[str, torch.Tensor]]]:
    """One sketch per contig on `device`, batch by batch: yields ((file,
    contig) items, their sketches, the batch's device-born bitmaps).
    Contigs are bucketed by padded length across the whole corpus; pass 1
    parses the files for their contigs' lengths, pass 2 reads each batch
    from the parsed files, one batch ahead of the device. Names follow
    the tab-split rule. With low_memory a parse is dropped after the
    last batch that reads its file (_OpenFiles)."""
    _check_params(params)
    files = _OpenFiles(paths, low_memory)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(1, threads)) as ex:
        per_file = _length_pass(ex, lambda i: files.get(i).lengths,
                                len(paths))
    metrics.current().count("sketch_lengths_s", time.perf_counter() - t0)
    buckets: Dict[int, List[Tuple[int, int]]] = {}
    for pi, lens in enumerate(per_file):
        for cj, n in enumerate(lens):
            buckets.setdefault(_next_pow2(max(n, params.k)), []).append((pi, cj))
    chunks = _chunks(buckets, CONTIG_BATCH_BYTES[device.type], params, device)
    files.plan([dict.fromkeys(pi for pi, _ in c) for c in chunks])

    def read(ci: int) -> HostBatch:
        t0 = time.perf_counter()
        items = chunks[ci]
        srcs = dict(zip(dict.fromkeys(pi for pi, _ in items),
                        files.batch(ci)))
        names = [srcs[pi].name(cj).split("\t")[0] for pi, cj in items]
        return _read_batch(names, [[(srcs[pi], cj)] for pi, cj in items],
                           params, t0)

    scratch = _run_scratch(
        device, (sum(per_file[pi][cj] for pi, cj in c) for c in chunks))
    yield from _pipelined(len(chunks), read, lambda ci, hb: (
        chunks[ci], *sketch_host_batch(hb, params, device, scratch)))


def device_sketch_contig_files(
    paths: Sequence[str], params: NativeSketchParams, device: torch.device,
    *, on_batch=None, **kw,
) -> List[List[NativeSketch]]:
    """One sketch per contig, per file, in file order
    (iter_device_sketch_contig_files, collected): the device counterpart
    of sketch_contigs_native. on_batch(names, sketches, device-born
    bitmaps), when given, sees each batch as it is sketched."""
    got: Dict[Tuple[int, int], NativeSketch] = {}
    for items, sketches, dev in iter_device_sketch_contig_files(
            paths, params, device, **kw):
        if on_batch is not None:
            on_batch([sk.name for sk in sketches], sketches, dev)
        got.update(zip(items, sketches))
    counts = [0] * len(paths)
    for pi, _ in got:
        counts[pi] += 1
    return [[got[(pi, cj)] for cj in range(n)] for pi, n in enumerate(counts)]
