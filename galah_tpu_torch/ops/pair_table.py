"""Pair-table verify: many directed genome pairs per dispatch
(counterpart of galah_tpu/ops/pair_table.py).

A batch of directed (source, target) pairs is evaluated in one launch:

- the batch's unique source fragment streams are read in place from the
  engine's stream arena (ops/fragment_ani.py::StreamArena), where
  device-born streams were adopted and host streams are uploaded once a
  residency; a stream too large for the arena, or every stream under
  GALAH_TPU_ARENA=0, is uploaded with the batch instead. Per-pair
  descriptors locate each pair's stream and fragments in them;
- target membership bitmaps are rows of the engine's bitmap pool,
  read in place through per-pair row ids;
- over several shards, batch i runs on shard i mod the shard count,
  with that shard's arena and pool;
- per fragment, the hits of its hashes in the target bitmap give the
  corrected containment and identity; per pair, identities are summed
  in 2^-14 fixed point (exact integer sums, half-to-even rounding), as
  the reference does.

On a CUDA tensor _pair_table_kernel launches the hand-written kernel
csrc/pair_table_verify.cu (K7, one launch a batch), which stages each
pair's target row in shared memory over a thread-block cluster when the
row is over 2^20 bits (verify_launch_plan), and reads a smaller row
through L1; on a CPU tensor it runs the plain torch version,
_pair_table_plain. Both give the same bits.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from galah_tpu_torch.utils import metrics
from galah_tpu_torch.utils.convert import to_device

_FX_ONE = 1 << 14  # fixed-point scale of the per-pair identity sums


@dataclass(frozen=True)
class PairTableConfig:
    member_bits: int
    k: int
    min_fragment_hashes: int
    min_fragment_identity: float
    # Per-batch capacities (the reference's caps).
    max_flat_hashes: int = 1 << 23      # flat (pair-duplicated) hash slots
    max_flat_frags: int = 1 << 16       # flat fragment slots
    max_pairs: int = 1 << 12            # directed pairs per batch
    max_unique_hashes: int = 1 << 22    # concatenated unique stream slots
    max_unique_frags: int = 1 << 16
    max_bitmaps: int = 256              # distinct target bitmaps


def _pair_table_kernel(
    ustream: torch.Tensor,              # (U,) int32 unique source streams
    ufrag_offsets: torch.Tensor,        # (UF+1,) int32 global fragment offsets
    bitmaps: torch.Tensor,              # (C, W) int32 bitmap rows (the pool)
    popcounts: torch.Tensor,            # (G,) float32
    pair_src_start: torch.Tensor,       # (P,) int32 stream start in ustream
    pair_flat_start: torch.Tensor,      # (P+1,) int32 ascending flat-hash starts
    pair_ufrag_start: torch.Tensor,     # (P,) int32 first fragment in ufrag_offsets
    pair_fragflat_start: torch.Tensor,  # (P+1,) int32 ascending flat-fragment starts
    pair_ref: torch.Tensor,             # (P,) int64 rows into popcounts
    pair_row: torch.Tensor,             # (P,) int64 rows into bitmaps
    n_flat: int,
    n_flat_frags: int,
    bits: int,
    k: int,
    min_hashes: int,
    min_ident: float,
    shard: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (ani_pct (P,), af (P,)) float32 for the directed pairs. A
    CPU tensor takes the plain version; a CUDA tensor launches K7 on the
    current stream or raises, with no host sync. K7 requires what every
    stream producer gives: buckets ascending within each fragment (the
    plain version takes any order), rows of exactly `bits` bits and a
    pool aligned to 16 bytes (check_rows). `shard`, the verify shard the
    batch went to, is where the launch is also counted in `per_shard`."""
    check_bits(bits)
    if n_flat_frags * _FX_ONE >= 1 << 31:
        raise ValueError("fixed-point identity sum would overflow int32")
    if ustream.device.type == "cpu":
        return _pair_table_plain(
            ustream, ufrag_offsets, bitmaps, popcounts, pair_src_start,
            pair_flat_start, pair_ufrag_start, pair_fragflat_start, pair_ref,
            pair_row, n_flat, n_flat_frags, bits, k, min_hashes, min_ident)
    if ustream.device.type != "cuda":
        raise ValueError(f"unsupported device {ustream.device}")
    check_operands(
        (ustream, ufrag_offsets, bitmaps, pair_ufrag_start,
         pair_fragflat_start), torch.int32)
    check_operands((popcounts,), torch.float32)
    check_operands((pair_ref, pair_row), torch.int64)
    if len({t.device for t in (ustream, ufrag_offsets, bitmaps, popcounts,
                               pair_ufrag_start, pair_fragflat_start,
                               pair_ref, pair_row)}) != 1:
        raise ValueError("the kernel's operands are on different devices")
    P = pair_ufrag_start.shape[0]
    if (bitmaps.dim() != 2 or pair_fragflat_start.shape != (P + 1,)
            or pair_ref.shape != (P,) or pair_row.shape != (P,)):
        raise ValueError(
            f"descriptors of {P} pairs do not fit: pair_fragflat_start "
            f"{tuple(pair_fragflat_start.shape)}, pair_ref "
            f"{tuple(pair_ref.shape)}, pair_row {tuple(pair_row.shape)}, "
            f"bitmaps {tuple(bitmaps.shape)}")
    plan = verify_launch_plan(bits)
    check_rows(bitmaps, bits)
    from galah_tpu_torch.ops._build import load_library

    dev = ustream.device
    ani = torch.empty(P, dtype=torch.float32, device=dev)
    af = torch.empty(P, dtype=torch.float32, device=dev)
    entry = load_library().galah_pair_table_verify
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(ustream.data_ptr(), ufrag_offsets.data_ptr(),
                    bitmaps.data_ptr(), bitmaps.shape[1],
                    popcounts.data_ptr(), pair_ufrag_start.data_ptr(),
                    pair_fragflat_start.data_ptr(), pair_ref.data_ptr(),
                    pair_row.data_ptr(), P, n_flat_frags, *plan, 1.0 / bits,
                    1.0 / k, min_hashes, min_ident, ani.data_ptr(),
                    af.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"galah_pair_table_verify launch failed: CUDA error {err} "
            f"(pairs={P}, flat fragments={n_flat_frags}, {plan})")
    _K7.launches += 1
    if shard is not None:
        _K7.per_shard[shard] += 1
    return ani, af


_pair_table_kernel.launches = 0
_pair_table_kernel.per_shard = Counter()
# The wrapper's own function object, where its launches are counted even
# when a caller replaces the module's name with a wrapper of its own (as
# chip_smoke.py and tools/verify_profile.py do to record and time it).
_K7 = _pair_table_kernel


def check_bits(bits: int) -> None:
    """What the verify kernels and their plain versions assume of the
    bitmap width: a power of two, so that the card's multiply by 1 / bits
    and the CPU's divide by bits give the same float32."""
    if bits <= 0 or bits & (bits - 1):
        raise ValueError(f"member bitmap of {bits} bits, not a power of two")


# A block holds at most 2^20 bits of a row (128 KiB of its 227 KB of
# shared memory); a cluster of up to 4 blocks holds a row of up to 2^22
# bits, the widest the sketch parameters give (engines/native.py::
# _shrink_bits never widens past the defaults). The narrowest row is one
# 16-byte bulk copy.
MAX_SLICE_BITS = 1 << 20
MAX_ROW_BITS = 1 << 22
MIN_ROW_BITS = 1 << 7


class VerifyPlan(NamedTuple):
    """How K7 and K8 hold a bitmap row of `bits` bits on chip, in the
    order their C entries take it."""

    cluster: int      # blocks of the thread-block cluster that holds a row
    slice_bits: int   # bits of the row each of them holds
    smem_bytes: int   # its dynamic shared memory (the slice)


def verify_launch_plan(bits: int) -> VerifyPlan:
    """K7's and K8's launch plan for rows of `bits` bits: one block up
    to 2^20 bits (K7 then reads the row through L1), then a cluster of
    bits / 2^20 blocks of 128 KiB each. Raises ValueError for a width
    they do not take."""
    check_bits(bits)
    if not MIN_ROW_BITS <= bits <= MAX_ROW_BITS:
        raise ValueError(
            f"member bitmap of {bits} bits: the verify kernels take "
            f"{MIN_ROW_BITS} to {MAX_ROW_BITS} bits")
    cluster = max(1, bits // MAX_SLICE_BITS)
    slice_bits = bits // cluster
    return VerifyPlan(cluster, slice_bits, slice_bits // 8)


def check_rows(bitmaps: torch.Tensor, bits: int) -> None:
    """What the kernels' bulk copies need of the bitmap rows: rows of
    exactly `bits` bits, from an address aligned to 16 bytes."""
    if bitmaps.shape[1] * 32 != bits:
        raise ValueError(f"bitmap rows of {bitmaps.shape[1]} words for "
                         f"{bits} bits")
    if bitmaps.data_ptr() % 16:
        raise ValueError("the bitmap rows must start 16-byte aligned")


def check_operands(tensors, dtype: torch.dtype) -> None:
    """Every tensor of `dtype` and contiguous, as a kernel reads it."""
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"want {dtype} operands, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernel's operands must be contiguous")


def _pair_table_plain(
    ustream: torch.Tensor,              # (U,) int32 unique source streams
    ufrag_offsets: torch.Tensor,        # (UF+1,) int32 global fragment offsets
    bitmaps: torch.Tensor,              # (C, W) int32 bitmap rows (the pool)
    popcounts: torch.Tensor,            # (G,) float32
    pair_src_start: torch.Tensor,       # (P,) int32 stream start in ustream
    pair_flat_start: torch.Tensor,      # (P+1,) int32 ascending flat-hash starts
    pair_ufrag_start: torch.Tensor,     # (P,) int32 first fragment in ufrag_offsets
    pair_fragflat_start: torch.Tensor,  # (P+1,) int32 ascending flat-fragment starts
    pair_ref: torch.Tensor,             # (P,) int64 rows into popcounts
    pair_row: torch.Tensor,             # (P,) int64 rows into bitmaps
    n_flat: int,
    n_flat_frags: int,
    bits: int,
    k: int,
    min_hashes: int,
    min_ident: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K7: (ani_pct (P,), af (P,)) float32 for
    the directed pairs, over flat (pair-duplicated) hash and fragment
    domains with prefix sums at their bounds."""
    dev = ustream.device
    P = pair_src_start.shape[0]
    W = bitmaps.shape[1]
    pair_ids = torch.arange(P, device=dev)

    # --- flat hash domain: one slot per (pair, source-stream position) ---
    hpair = torch.repeat_interleave(
        pair_ids, (pair_flat_start[1:] - pair_flat_start[:-1]).long(),
        output_size=n_flat,
    )
    flat_idx = torch.arange(n_flat, dtype=torch.int32, device=dev)
    upos = pair_src_start[hpair] + (flat_idx - pair_flat_start[hpair])
    bucket = ustream[upos.long()]
    word_idx = pair_row[hpair] * W + (bucket >> 5).long()
    words = bitmaps.reshape(-1)[word_idx]
    hit = (words >> (bucket & 31)) & 1

    # --- per-fragment hit counts: prefix sum + gathers at the bounds ---
    fpair = torch.repeat_interleave(
        pair_ids, (pair_fragflat_start[1:] - pair_fragflat_start[:-1]).long(),
        output_size=n_flat_frags,
    )
    frag_idx = torch.arange(n_flat_frags, dtype=torch.int32, device=dev)
    uf = (
        pair_ufrag_start[fpair] + (frag_idx - pair_fragflat_start[fpair])
    ).long()
    base = pair_flat_start[fpair] - pair_src_start[fpair]
    f_start = (base + ufrag_offsets[uf]).long()
    f_end = (base + ufrag_offsets[uf + 1]).long()
    hcum = _prefix(hit)
    m = hcum[f_end] - hcum[f_start]
    Mf = f_end - f_start

    # --- per-fragment epilogue (float32, the reference's order) ---
    p = popcounts[pair_ref[fpair]] / float(bits)
    Mfloat = Mf.to(torch.float32)
    c = (m.to(torch.float32) - Mfloat * p) / torch.clamp(1.0 - p, min=1e-6)
    c = torch.minimum(torch.clamp(c, min=0.0), Mfloat)
    usable = Mf >= min_hashes
    cont = c / torch.clamp(Mfloat, min=1.0)
    ident = torch.pow(torch.clamp(cont, min=1e-30), 1.0 / k)
    aligned = usable & (ident >= min_ident)

    # --- per-pair reduction over the fragment axis ---
    ident_fx = torch.where(
        aligned, torch.round(ident * _FX_ONE), torch.zeros_like(ident)
    ).to(torch.int32)
    acum = _prefix(aligned.to(torch.int32))
    ucum = _prefix(usable.to(torch.int32))
    icum = _prefix(ident_fx)
    lo = pair_fragflat_start[:-1].long()
    hi = pair_fragflat_start[1:].long()
    n_aligned = acum[hi] - acum[lo]
    n_usable = ucum[hi] - ucum[lo]
    sum_ident = (icum[hi] - icum[lo]).to(torch.float32) / float(_FX_ONE)
    ani = sum_ident / torch.clamp(n_aligned, min=1) * 100.0
    af = n_aligned / torch.clamp(n_usable, min=1)
    return ani, af


def _prefix(x: torch.Tensor) -> torch.Tensor:
    """Exclusive-bounds int32 prefix sum: out[t] = sum(x[:t]), (len+1,)."""
    out = torch.zeros(x.shape[0] + 1, dtype=torch.int32, device=x.device)
    torch.cumsum(x, dim=0, dtype=torch.int32, out=out[1:])
    return out


class _Usage:
    def __init__(self) -> None:
        self.flat_h = 0
        self.flat_f = 0
        self.uniq_h = 0
        self.uniq_f = 0
        self.n_pairs = 0
        self.bitmaps = set()
        self.has_src = None


class PairTableVerifier:
    """Host-side batcher for the pair-table kernel. shards_fn() gives
    the engine's verify shards (ops/fragment_ani.py::_VerifyShard), each
    with its device, bitmap pool and stream arena; batches go round
    robin over them."""

    def __init__(self, cfg: PairTableConfig, shards_fn: Callable) -> None:
        self.cfg = cfg
        self._shards_fn = shards_fn

    def _plan_batches(
        self, directed_pairs: Sequence[Tuple], sketches_by_key: Dict
    ) -> List[List[Tuple]]:
        """Pack directed pairs into batches (pure host planning): pairs
        group by source so unique streams amortize; a batch closes when
        any capacity would overflow."""
        cfg = self.cfg
        batches: List[List[Tuple]] = []
        batch: List[Tuple] = []
        usage = _Usage()

        def src_cost(key):
            sk = sketches_by_key[key]
            return len(sk.frag_buckets), sk.n_fragments

        by_src = defaultdict(list)
        for s, t in directed_pairs:
            by_src[s].append(t)

        def flush():
            nonlocal batch, usage
            if batch:
                batches.append(batch)
                batch = []
                usage = _Usage()

        for src in sorted(by_src):
            nh, nf = src_cost(src)
            if nh > cfg.max_flat_hashes or nf > cfg.max_flat_frags:
                raise ValueError(
                    f"source stream too large for pair table: {nh} hashes"
                )
            for tgt in sorted(by_src[src]):
                add_unique = 0 if usage.has_src == src else 1
                need_uh = nh if add_unique else 0
                need_uf = nf if add_unique else 0
                new_bitmap = 0 if tgt in usage.bitmaps else 1
                if (
                    usage.flat_h + nh > cfg.max_flat_hashes
                    or usage.flat_f + nf > cfg.max_flat_frags
                    or usage.uniq_h + need_uh > cfg.max_unique_hashes
                    or usage.uniq_f + need_uf > cfg.max_unique_frags
                    or usage.n_pairs + 1 > cfg.max_pairs
                    or len(usage.bitmaps) + new_bitmap > cfg.max_bitmaps
                ):
                    flush()
                    # after flush the source stream must be re-added
                if usage.has_src != src:
                    usage.uniq_h += nh
                    usage.uniq_f += nf
                    usage.has_src = src
                usage.flat_h += nh
                usage.flat_f += nf
                usage.n_pairs += 1
                usage.bitmaps.add(tgt)
                batch.append((src, tgt))
        flush()
        return batches

    def run(
        self, directed_pairs: Sequence[Tuple], sketches_by_key: Dict
    ) -> Dict[Tuple, Tuple[float, float]]:
        """Evaluate directed (src, tgt) pairs; returns
        {(src, tgt): (ani_pct, af_src_direction)}. Batch i goes to shard
        i mod the shard count (a stable assignment; results are per pair,
        so the same at any count). Every batch is issued before any
        result is read, so batches queue back to back on each device;
        one device-to-host copy a shard brings its results home. That is
        safe with the arena and the pool rewriting what an earlier batch
        reads, because every write is queued on the same stream after
        the kernels queued before it."""
        batches = self._plan_batches(directed_pairs, sketches_by_key)
        if not batches:
            return {}
        shards = self._shards_fn()
        outs = [self._dispatch(b, sketches_by_key, shards[i % len(shards)],
                               i % len(shards))
                for i, b in enumerate(batches)]
        results: Dict[Tuple, Tuple[float, float]] = {}
        for sh in range(min(len(shards), len(batches))):
            mine = range(sh, len(batches), len(shards))
            ani = torch.cat([outs[i][0] for i in mine]).cpu().numpy()
            af = torch.cat([outs[i][1] for i in mine]).cpu().numpy()
            o = 0
            for i in mine:
                for pr in batches[i]:
                    results[pr] = (float(ani[o]), float(af[o]))
                    o += 1
        return results

    def _dispatch(self, batch: List[Tuple], sketches_by_key: Dict, shard,
                  shard_index: int):
        cfg = self.cfg
        dev = shard.device
        pool = shard.pool
        src_order = list(dict.fromkeys(s for s, _ in batch))
        streams = self._streams(src_order, sketches_by_key, shard)
        ustream, uoffsets, src_start, src_ufrag_start = streams

        tgt_order: List = []
        tgt_index: Dict = {}
        for _, t in batch:
            if t not in tgt_index:
                tgt_index[t] = len(tgt_order)
                tgt_order.append(t)
        pool.ensure(tgt_order, [sketches_by_key[t] for t in tgt_order])
        rows, popcounts = pool.rows(tgt_order)

        P = len(batch)
        psrc = np.empty(P, np.int32)
        puf = np.empty(P, np.int32)
        pref = np.empty(P, np.int64)
        pfs = np.empty(P + 1, np.int32)
        pffs = np.empty(P + 1, np.int32)
        fh = ff = 0
        for i, (s, t) in enumerate(batch):
            sk = sketches_by_key[s]
            psrc[i] = src_start[s]
            puf[i] = src_ufrag_start[s]
            pref[i] = tgt_index[t]
            pfs[i] = fh
            pffs[i] = ff
            fh += len(sk.frag_buckets)
            ff += sk.n_fragments
        pfs[P] = fh
        pffs[P] = ff
        prow = rows[pref]

        def up(a: np.ndarray) -> torch.Tensor:
            return to_device(a, dev)

        return _pair_table_kernel(
            ustream,
            uoffsets,
            pool.buffer,
            up(popcounts),
            up(psrc), up(pfs), up(puf), up(pffs),
            up(pref), up(prow),
            n_flat=fh, n_flat_frags=ff,
            bits=cfg.member_bits, k=cfg.k,
            min_hashes=cfg.min_fragment_hashes,
            min_ident=cfg.min_fragment_identity,
            shard=shard_index,
        )

    def _streams(self, src_order: List, sketches_by_key: Dict, shard):
        """(streams (U,) int32, fragment offsets int32, {source: its
        stream's start}, {source: its first offset}) on the shard's
        device: its stream arena's buffers and spans, or, when a source
        does not fit the arena or GALAH_TPU_ARENA=0, the batch's own
        upload."""
        from galah_tpu_torch.ops.fragment_ani import _arena_enabled

        if _arena_enabled():
            arena = shard.arena()
            spans = arena.ensure(src_order, sketches_by_key)
            if all(s in spans for s in src_order):
                return (arena.hashes, arena.offsets,
                        {s: spans[s][0] for s in src_order},
                        {s: spans[s][1] for s in src_order})
        return upload_streams(src_order, sketches_by_key, shard.device)


def upload_streams(src_order: List, sketches_by_key: Dict,
                   device: torch.device):
    """The sources' streams concatenated and uploaded for one dispatch,
    with their offsets made absolute and sharing each boundary: the
    per-dispatch upload the stream arena replaces. Returns what
    PairTableVerifier._streams does."""
    metrics.current().count("verify_streams_uploaded", len(src_order))
    src_start: Dict = {}
    src_ufrag_start: Dict = {}
    streams: List[np.ndarray] = []
    uoff_parts: List[np.ndarray] = [np.zeros(1, np.int64)]
    uh = uf = 0
    for s in src_order:
        sk = sketches_by_key[s]
        src_start[s] = uh
        src_ufrag_start[s] = uf
        streams.append(np.asarray(sk.frag_buckets, np.int32))
        uoff_parts.append(np.asarray(sk.frag_offsets[1:], np.int64) + uh)
        uh += len(sk.frag_buckets)
        uf += sk.n_fragments
    ustream = np.concatenate(streams) if uh else np.zeros(0, np.int32)
    return (to_device(ustream, device),
            to_device(np.concatenate(uoff_parts).astype(np.int32), device),
            src_start, src_ufrag_start)
