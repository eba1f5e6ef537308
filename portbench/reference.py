"""Plain reference of a galah cluster job, in torch and numpy.

It imports nothing of the program: it parses the generated FASTA
itself, sketches each unit, works out the fragment-containment ANI and
AF of the pairs it is given, and clusters greedily in quality order. The
rules are galah's native engine's, as its configuration states them
(``configs/<config>.json`` "sketch"):

- canonical 2-bit k-mers (k = 15) of each contig, skipping windows with
  a base other than ACGT; splitmix64's finalizer as the hash;
- fragment-scale FracMinHash (keep h < 2^64 / scale); a unit's member
  bitmap holds ``h mod bits`` of every kept hash; a contig is cut into
  fragments of ``fragment_length`` (a remainder of at least half a
  fragment is its own fragment; a contig shorter than a fragment is one
  fragment from 100 bases), a k-mer belongs to the fragment where it
  starts, and each fragment keeps its distinct buckets;
- for a directed pair (a, b) and each fragment of a with M buckets of
  which m are set in b's bitmap: the collision-corrected count
  c = clamp((m - M p) / (1 - p), 0, M) with p = popcount(b) / bits,
  identity (c / M)^(1/k); a fragment is usable with M >= 8 and aligned
  when usable with identity >= 0.8; ANI is the mean identity of the
  aligned fragments (x100), AF their share of the usable ones;
- a pair passes with max(ANI(a, b), ANI(b, a)) >= the ANI threshold and
  the larger AF >= the minimum AF.

Everything is computed in float64 (``dtype``); the control computes the
same in bfloat16.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB
_SIGN = -(1 << 63)


def _signed(x: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


@dataclass(frozen=True)
class SketchRules:
    k: int
    fragment_scale: int
    fragment_length: int
    member_bits: int
    min_fragment_hashes: int = 8
    min_fragment_identity: float = 0.8
    min_fragment_length: int = 100


def member_bits_for(sketch: dict, max_file_bytes: int) -> int:
    """The member bitmap's width: the configured width, or for genomes
    (``shrink``) the smallest power of two over 256 bits a kept hash of
    the largest file, floored at 2^17 and capped at the configured
    width."""
    bits = int(sketch["member_bits"])
    if not sketch.get("shrink"):
        return bits
    need = (max_file_bytes // int(sketch["fragment_scale"]) + 1) * 256
    return min(bits, 1 << max(int(need - 1).bit_length(), 17))


def rules_for(sketch: dict, max_file_bytes: int) -> SketchRules:
    return SketchRules(
        k=int(sketch["k"]),
        fragment_scale=int(sketch["fragment_scale"]),
        fragment_length=int(sketch["fragment_length"]),
        member_bits=member_bits_for(sketch, max_file_bytes),
        min_fragment_hashes=int(sketch["min_fragment_hashes"]),
        min_fragment_identity=float(sketch["min_fragment_identity"]),
    )


# --- FASTA ---------------------------------------------------------------

_CODE = np.full(256, 4, dtype=np.uint8)
for _c, _v in zip(b"ACGT", range(4)):
    _CODE[_c] = _v
    _CODE[_c + 32] = _v


def read_fasta_records(path: str, wanted: Optional[Sequence[int]] = None
                       ) -> List[Tuple[str, np.ndarray]]:
    """(name, sequence bytes) of the file's records, or of the records at
    `wanted` (their positions in the file), in file order. The name is
    the header up to its first whitespace."""
    with open(path, "rb") as fh:
        data = np.frombuffer(fh.read(), dtype=np.uint8)
    starts = np.flatnonzero(data == ord(">"))
    ends = np.append(starts[1:], len(data))
    picks = range(len(starts)) if wanted is None else sorted(wanted)
    out = []
    for r in picks:
        rec = data[starts[r]: ends[r]]
        nl = int(np.argmax(rec == 10))
        name = rec[1:nl].tobytes().decode().split()[0]
        body = rec[nl + 1:]
        seq = body[(body != 10) & (body != 13)]
        out.append((name, seq))
    return out


# --- Sketch --------------------------------------------------------------


@dataclass
class UnitSketch:
    """A unit's fragment buckets (ascending within each fragment), its
    fragment offsets and its member bitmap's popcount."""

    buckets: torch.Tensor       # (N,) int64
    offsets: torch.Tensor       # (F + 1,) int64
    popcount: int


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 tensors holding uint64 bits
    (wrapping products, logical shifts)."""
    def lsr(v, s):
        return (v >> s) & ((1 << (64 - s)) - 1)

    h = x ^ lsr(x, 30)
    h = h * _signed(_M1)
    h = h ^ lsr(h, 27)
    h = h * _signed(_M2)
    return h ^ lsr(h, 31)


def _canonical_kmers(code: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Canonical packed k-mers of a code sequence (0-3, 4 for any other
    byte) and their starts, skipping windows with a 4."""
    n = code.numel() - k + 1
    if n <= 0:
        e = torch.empty(0, dtype=torch.int64, device=code.device)
        return e, e
    bad = (code > 3).to(torch.int32)
    csum = torch.zeros(code.numel() + 1, dtype=torch.int32,
                       device=code.device)
    torch.cumsum(bad, 0, out=csum[1:])
    start = torch.nonzero((csum[k:] - csum[:-k]) == 0).flatten()
    c = code & 3
    fwd = torch.zeros(start.numel(), dtype=torch.int64, device=code.device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        fwd = (fwd << 2) | c[start + j]
        rev = rev | ((3 - c[start + j]) << (2 * j))
    return torch.minimum(fwd, rev), start


def sketch_units(units: Sequence[Sequence[np.ndarray]], rules: SketchRules,
                 device: torch.device, batch_bases: int = 1 << 26
                 ) -> List[Tuple[UnitSketch, torch.Tensor]]:
    """(sketch, member bitmap as a (bits,) bool tensor) of each unit, a
    unit being its contigs' sequence bytes. Units are sketched in batches
    of about `batch_bases` bases: the contigs laid end to end with one
    invalid byte between them, so no k-mer spans two."""
    out: List[Tuple[UnitSketch, torch.Tensor]] = []
    batch: List[Sequence[np.ndarray]] = []
    size = 0
    for u in units:
        batch.append(u)
        size += sum(len(s) + 1 for s in u)
        if size >= batch_bases:
            out += _sketch_batch(batch, rules, device)
            batch, size = [], 0
    if batch:
        out += _sketch_batch(batch, rules, device)
    return out


def _sketch_batch(units, rules: SketchRules, device):
    L, bits = rules.fragment_length, rules.member_bits
    seqs = [s for u in units for s in u]
    unit_of = np.repeat(np.arange(len(units)), [len(u) for u in units])
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens + 1)[:-1]])
    buf = np.full(int((lens + 1).sum()), 4, dtype=np.uint8)
    for s, st in zip(seqs, starts):
        buf[st: st + len(s)] = _CODE[s]
    # Fragments of each contig: full windows of L, a remainder of at
    # least L // 2 as one more; under L, one fragment from 100 bases.
    nfull = lens // L
    last = (lens - nfull * L) >= L // 2
    short = lens < L
    nfrag = np.where(short, (lens >= rules.min_fragment_length).astype(
        np.int64), nfull + last)
    fbase = np.concatenate([[0], np.cumsum(nfrag)[:-1]])

    t = functools.partial(torch.as_tensor, device=device)
    code = t(buf).to(torch.int64)
    kmers, pos = _canonical_kmers(code, rules.k)
    cid = torch.searchsorted(t(starts), pos, right=True) - 1
    p = pos - t(starts)[cid]
    f = torch.div(p, L, rounding_mode="floor")
    nf, la = t(nfull)[cid], t(last)[cid]
    f = torch.where(f >= nf, torch.where(la, nf, torch.full_like(f, -1)), f)
    sh = t(short)[cid]
    f = torch.where(sh, torch.where(t(nfrag)[cid] > 0, torch.zeros_like(f),
                                    torch.full_like(f, -1)), f)
    h = mix64(kmers)
    keep = (h ^ _SIGN) < (_signed((1 << 64) // rules.fragment_scale) ^ _SIGN)
    bucket = h[keep] & (bits - 1)
    cid, f = cid[keep], f[keep]
    unit = t(unit_of)[cid]
    member = torch.zeros((len(units), bits), dtype=torch.bool, device=device)
    member[unit, bucket] = True
    inb = f >= 0
    keys = torch.unique((t(fbase)[cid[inb]] + f[inb]) * bits + bucket[inb])
    gfrag = torch.div(keys, bits, rounding_mode="floor")
    total = int(nfrag.sum())
    counts = torch.bincount(gfrag, minlength=total)
    offsets = torch.zeros(total + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=offsets[1:])
    buckets = keys % bits
    frags_of_unit = np.bincount(unit_of, weights=nfrag,
                                minlength=len(units)).astype(np.int64)
    fstart = np.concatenate([[0], np.cumsum(frags_of_unit)])
    popcounts = member.sum(dim=1).tolist()
    out = []
    for i in range(len(units)):
        lo, hi = int(fstart[i]), int(fstart[i + 1])
        off = offsets[lo: hi + 1]
        a, b = int(off[0]), int(off[-1])
        out.append((UnitSketch(buckets[a:b].clone(), off - a,
                               int(popcounts[i])), member[i].clone()))
    return out


# --- Verify --------------------------------------------------------------


def fragment_identities(src: UnitSketch, bitmaps: torch.Tensor,
                        popcounts: torch.Tensor, rules: SketchRules,
                        dtype=torch.float64
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per fragment of `src` against each of the (T, bits) target
    bitmaps: identity (T, F), usable (1, F) and aligned (T, F), computed
    in `dtype`."""
    M = (src.offsets[1:] - src.offsets[:-1])
    hit = bitmaps[:, src.buckets].to(torch.int64)            # (T, N)
    cs = torch.zeros((bitmaps.shape[0], hit.shape[1] + 1), dtype=torch.int64,
                     device=hit.device)
    torch.cumsum(hit, 1, out=cs[:, 1:])
    m = (cs[:, src.offsets[1:]] - cs[:, src.offsets[:-1]]).to(dtype)
    Mf = M.to(dtype)[None, :]
    p = (popcounts.to(dtype) / rules.member_bits)[:, None]
    c = (m - Mf * p) / torch.clamp(1.0 - p, min=1e-6)
    c = torch.minimum(torch.clamp(c, min=0.0), Mf)
    usable = (M >= rules.min_fragment_hashes)[None, :]
    cont = c / torch.clamp(Mf, min=1.0)
    ident = torch.pow(torch.clamp(cont, min=1e-30),
                      torch.tensor(1.0 / rules.k, dtype=dtype))
    aligned = usable & (ident >= rules.min_fragment_identity)
    return ident, usable, aligned


def directed_ani_af(src: UnitSketch, bitmaps: torch.Tensor,
                    popcounts: torch.Tensor, rules: SketchRules,
                    dtype=torch.float64) -> Tuple[torch.Tensor, torch.Tensor]:
    """ANI (%) and AF of `src`'s fragments against each of the (T, bits)
    target bitmaps, computed in `dtype`."""
    T = bitmaps.shape[0]
    if src.buckets.numel() == 0 or src.offsets.numel() < 2:
        z = torch.zeros(T, dtype=dtype, device=bitmaps.device)
        return z, z
    ident, usable, aligned = fragment_identities(src, bitmaps, popcounts,
                                                 rules, dtype)
    n_aligned = aligned.sum(dim=1)
    n_usable = usable.sum(dim=1)
    total = torch.where(aligned, ident, torch.zeros_like(ident)).sum(dim=1)
    ani = total / torch.clamp(n_aligned, min=1).to(dtype) * 100.0
    af = n_aligned.to(dtype) / torch.clamp(n_usable, min=1).to(dtype)
    return ani, af


def pair_results(sketches: Dict[int, UnitSketch],
                 bitmaps: Dict[int, torch.Tensor],
                 pairs: Sequence[Tuple[int, int]], rules: SketchRules,
                 dtype=torch.float64) -> Dict[Tuple[int, int],
                                              Tuple[float, float, float]]:
    """{(a, b): (ANI %, AF of a against b, AF of b against a)} with ANI
    the larger of the two directions."""
    targets: Dict[int, List[int]] = {}
    for a, b in pairs:
        targets.setdefault(a, []).append(b)
        targets.setdefault(b, []).append(a)
    fwd: Dict[Tuple[int, int], Tuple[float, float]] = {}
    for src, tl in targets.items():
        tl = sorted(set(tl))
        for lo in range(0, len(tl), 256):
            chunk = tl[lo: lo + 256]
            bm = torch.stack([bitmaps[t] for t in chunk])
            pc = torch.tensor([sketches[t].popcount for t in chunk],
                              device=bm.device)
            ani, af = directed_ani_af(sketches[src], bm, pc, rules, dtype)
            for t, x, y in zip(chunk, ani.double().tolist(),
                               af.double().tolist()):
                fwd[(src, t)] = (x, y)
    return {(a, b): (max(fwd[(a, b)][0], fwd[(b, a)][0]), fwd[(a, b)][1],
                     fwd[(b, a)][1]) for a, b in pairs}


def passes(result: Tuple[float, float, float], ani_pct: float,
           min_af: float) -> bool:
    ani, af_ab, af_ba = result
    return ani >= ani_pct and max(af_ab, af_ba) >= min_af


# --- Greedy clustering ---------------------------------------------------


def greedy_clusters(order: Sequence[int],
                    ani: Dict[Tuple[int, int], float],
                    threshold: float) -> Dict[int, List[int]]:
    """galah's greedy clustering of units given in priority order, from
    the passing pairs' ANI ({(min, max): ANI}): single-linkage
    preclusters; in each, a unit is a representative unless a
    representative before it lies within `threshold`; every other unit
    joins the representative of highest ANI (the first on a tie, in
    priority order). Returns {representative: members in priority
    order}."""
    rank = {u: i for i, u in enumerate(order)}
    adj: Dict[int, List[int]] = {u: [] for u in order}
    for (a, b) in ani:
        adj[a].append(b)
        adj[b].append(a)
    for u in adj:
        adj[u].sort(key=rank.__getitem__)

    def key(a, b):
        return (a, b) if a < b else (b, a)

    reps: List[int] = []
    rep_set = set()
    for u in order:
        if not any(v in rep_set and ani[key(u, v)] >= threshold
                   for v in adj[u]):
            reps.append(u)
            rep_set.add(u)
    out: Dict[int, List[int]] = {r: [r] for r in reps}
    for u in order:
        if u in rep_set:
            continue
        best, best_ani = None, None
        for v in adj[u]:
            if v in rep_set and (best_ani is None or ani[key(u, v)] > best_ani):
                best, best_ani = v, ani[key(u, v)]
        if best is None:
            raise ValueError(f"unit {u} has no representative")
        out[best].append(u)
    return out


def file_bytes(paths: Sequence[str]) -> int:
    return max(os.path.getsize(p) for p in paths)
