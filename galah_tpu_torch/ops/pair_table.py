"""Pair-table verify: many directed genome pairs per dispatch
(counterpart of galah_tpu/ops/pair_table.py).

A batch of directed (source, target) pairs is evaluated in one pass of
plain torch on the device:

- the batch's unique source fragment streams are read in place from the
  engine's stream arena (ops/fragment_ani.py::StreamArena), where
  device-born streams were adopted and host streams are uploaded once a
  residency; a stream too large for the arena, or every stream under
  GALAH_TPU_ARENA=0, is uploaded with the batch instead. Per-pair
  descriptors map the flat (pair-duplicated) hash domain back onto
  them, broadcast with repeat_interleave;
- target membership bitmaps are rows of the engine's bitmap pool,
  read in place through per-pair row ids;
- per-fragment hit counts are differences of one prefix sum at the
  fragment bounds; the containment/identity epilogue runs per fragment
  and reduces per pair, with identities summed in 2^-14 fixed point
  (exact integer prefix sums, half-to-even rounding), as the reference
  does.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (ani_pct (P,), af (P,)) float32 for the directed pairs."""
    if n_flat_frags * _FX_ONE >= 1 << 31:
        raise ValueError("fixed-point identity sum would overflow int32")
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
    """Host-side batcher for the pair-table kernel. `pool` is the
    engine's bitmap pool (ops/fragment_ani.py::_BitmapPool);
    arena_fn(), when given, its stream arena."""

    def __init__(self, cfg: PairTableConfig, pool, device: torch.device,
                 arena_fn: Optional[Callable] = None) -> None:
        self.cfg = cfg
        self.pool = pool
        self.device = device
        self._arena_fn = arena_fn

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
        {(src, tgt): (ani_pct, af_src_direction)}. Every batch is issued
        before any result is read, so batches queue back to back on the
        device; one device-to-host copy brings all results home. That is
        safe with the arena and the pool rewriting what an earlier batch
        reads, because every write is queued on the same stream after
        the kernels queued before it."""
        batches = self._plan_batches(directed_pairs, sketches_by_key)
        if not batches:
            return {}
        outs = [self._dispatch(b, sketches_by_key) for b in batches]
        ani = torch.cat([a for a, _ in outs]).cpu().numpy()
        af = torch.cat([f for _, f in outs]).cpu().numpy()
        results: Dict[Tuple, Tuple[float, float]] = {}
        o = 0
        for batch in batches:
            for pr in batch:
                results[pr] = (float(ani[o]), float(af[o]))
                o += 1
        return results

    def _dispatch(self, batch: List[Tuple], sketches_by_key: Dict):
        cfg = self.cfg
        dev = self.device
        src_order = list(dict.fromkeys(s for s, _ in batch))
        streams = self._streams(src_order, sketches_by_key)
        ustream, uoffsets, src_start, src_ufrag_start = streams

        tgt_order: List = []
        tgt_index: Dict = {}
        for _, t in batch:
            if t not in tgt_index:
                tgt_index[t] = len(tgt_order)
                tgt_order.append(t)
        self.pool.ensure(tgt_order, [sketches_by_key[t] for t in tgt_order])
        rows, popcounts = self.pool.rows(tgt_order)

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
            self.pool.buffer,
            up(popcounts),
            up(psrc), up(pfs), up(puf), up(pffs),
            up(pref), up(prow),
            n_flat=fh, n_flat_frags=ff,
            bits=cfg.member_bits, k=cfg.k,
            min_hashes=cfg.min_fragment_hashes,
            min_ident=cfg.min_fragment_identity,
        )

    def _streams(self, src_order: List, sketches_by_key: Dict):
        """(streams (U,) int32, fragment offsets int32, {source: its
        stream's start}, {source: its first offset}) on the device: the
        stream arena's buffers and spans, or, when a source does not fit
        the arena or GALAH_TPU_ARENA=0, the batch's own upload."""
        from galah_tpu_torch.ops.fragment_ani import _arena_enabled

        if self._arena_fn is not None and _arena_enabled():
            arena = self._arena_fn()
            spans = arena.ensure(src_order, sketches_by_key)
            if all(s in spans for s in src_order):
                return (arena.hashes, arena.offsets,
                        {s: spans[s][0] for s in src_order},
                        {s: spans[s][1] for s in src_order})
        return upload_streams(src_order, sketches_by_key, self.device)


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
