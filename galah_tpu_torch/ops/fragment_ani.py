"""Fragment-containment ANI — the verify stage
(counterpart of galah_tpu/ops/fragment_ani.py).

A query genome's fragment-level FracMinHash buckets are tested for
membership in a reference genome's bucket bitmap (a word gather and a
bit test); per-fragment shared-k-mer counts give per-fragment identity
(corrected containment)^(1/k); a direction's ANI is the mean identity of
aligned fragments and its AF the aligned share of usable fragments.

Two kernels, both plain torch on the device:
- the pair-table kernel (ops/pair_table.py) for pairs whose streams both
  fit its budget: many directed pairs per batch;
- the grouped kernel (_forward_kernel): one query stream against many
  reference bitmaps, for pairs with a stream over the budget.
Routing is per undirected pair, so a pair's two directions never mix the
two kernels' numerics (fixed-point vs float32 identity sums);
GALAH_TPU_VERIFY=pairtable|grouped forces one kernel for every pair.
"""

from __future__ import annotations

import os
from collections import OrderedDict, defaultdict
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from galah_tpu_torch import defaults
from galah_tpu_torch.ops.pair_table import PairTableConfig, PairTableVerifier
from galah_tpu_torch.sketch.fracminhash import NativeSketch
from galah_tpu_torch.utils import metrics
from galah_tpu_torch.utils.convert import sketch_tensors, u32_to_i32

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


def refs_per_dispatch(n: int, cap: int) -> int:
    """Grouped-kernel width for an n-hash stream: the cap, chunked down
    by a 256M-element budget on the (R, N) intermediates, floored at 8
    and rounded down to a power of two."""
    r_chunk = max(8, min(cap, (256 << 20) // max(1, n)))
    return 1 << (r_chunk.bit_length() - 1)


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query's fragments against R reference bitmaps (word-gather
    mode). Returns (ani_pct (R,), af (R,))."""
    W = bitmaps.shape[1]
    M = offsets[1:] - offsets[:-1]
    word_idx = rows[:, None] * W + (buckets >> 5).long()[None, :]
    words = bitmaps.reshape(-1)[word_idx]                 # (R, N)
    bits_hit = (words >> (buckets & 31)[None, :]) & 1
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


class FragmentAniEngine:
    """Device-side pair-ANI evaluator over NativeSketch data; owns the
    bitmap pool that both kernels read."""

    def __init__(self, cfg: FragmentAniConfig, device: torch.device) -> None:
        self.cfg = cfg
        self.device = device
        words = cfg.member_bits // 32
        hard_cap = cfg.max_cached_bitmaps
        if device.type == "cuda":
            # ~2 GB of resident bitmaps: 4096 genomes at 2^22 bits.
            hard_cap = max(hard_cap, (2 << 30) // (words * 4))
        self.pool = _BitmapPool(words, device, capacity=64, hard_cap=hard_cap)
        bitmap_bytes = cfg.member_bits // 8
        self.pair_table = PairTableVerifier(
            PairTableConfig(
                member_bits=cfg.member_bits,
                k=cfg.k,
                min_fragment_hashes=cfg.min_fragment_hashes,
                min_fragment_identity=cfg.min_fragment_identity,
                max_bitmaps=max(64, min(1024, (256 << 20) // bitmap_bytes)),
            ),
            self.pool,
            device,
        )

    def adopt_batch(self, keys, sketches: Sequence[NativeSketch],
                    dev) -> None:
        """Adopt one device-sketch batch's member bitmaps
        (dev["member_words"], rows in `keys` order) into the bitmap pool,
        with no host round trip. The host sketches stay the fallback for
        any key the pool evicts later."""
        self.pool.adopt(keys, dev["member_words"], range(len(keys)),
                        [s.member_popcount for s in sketches])

    def one_to_many(
        self,
        query: NativeSketch,
        query_key,
        refs: Sequence[NativeSketch],
        ref_keys: Sequence,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """ANI/AF of `query`'s fragments against each ref's bitmap
        (grouped kernel). Returns (ani_pct (R,), af (R,))."""
        cfg = self.cfg
        dev = self.device
        stream = sketch_tensors(query, dev)
        r_chunk = refs_per_dispatch(len(query.frag_buckets),
                                    cfg.max_refs_per_dispatch)
        anis, afs = [], []
        for lo in range(0, len(refs), r_chunk):
            keys = list(ref_keys[lo : lo + r_chunk])
            self.pool.ensure(keys, list(refs[lo : lo + r_chunk]))
            rows, pc = self.pool.rows(keys)
            ani, af = _forward_kernel(
                self.pool.buffer,
                torch.from_numpy(rows).to(dev),
                torch.from_numpy(pc).to(dev),
                stream.frag_buckets,
                stream.frag_offsets,
                bits=cfg.member_bits,
                k=cfg.k,
                min_hashes=cfg.min_fragment_hashes,
                min_ident=cfg.min_fragment_identity,
            )
            anis.append(ani)
            afs.append(af)
        if not anis:
            return np.empty(0, np.float32), np.empty(0, np.float32)
        return torch.cat(anis).cpu().numpy(), torch.cat(afs).cpu().numpy()

    def bidirectional(self, pairs, sketches_by_key):
        """Bidirectional ANI over key pairs, in this process (the
        reference's _bidirectional_local; its multi-process partition is
        not ported). Each undirected pair goes to the pair-table kernel
        when both streams are at most max_flat_hashes // 8 hashes, else
        both directions go to the grouped kernel.
        GALAH_TPU_VERIFY=pairtable|grouped sends every directed pair to
        that kernel instead, as the reference does; under pairtable a
        stream over max_flat_hashes raises the pair table's ValueError.
        Returns {(a, b): (ani_pct, af_a_dir, af_b_dir)}."""
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
            for src in sorted(directed):
                targets = sorted(directed[src])
                anis, afs = self.one_to_many(
                    sketches_by_key[src], src,
                    [sketches_by_key[t] for t in targets], targets,
                )
                for t, x, y in zip(targets, anis, afs):
                    fwd[(src, t)] = (float(x), float(y))
        out = {}
        for a, b in pairs:
            ani_f, af_f = fwd[(a, b)]
            ani_r, af_r = fwd[(b, a)]
            out[(a, b)] = (max(ani_f, ani_r), af_f, af_r)
        return out
