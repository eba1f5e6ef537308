"""Corpus generator: one general generator that every traffic file drives.

A traffic file (``traffic/<config>.<traffic>.json``) fixes the corpus's
shape: the family sizes, the unit lengths, the identity of each member
to its family's base, and, for genomes, how many contigs each genome is
cut into. The seed picks only the bases, the mutation sites and the
order of each genome's contigs (its cut points), so every seed gives the
same amount of work.

Two kinds of unit:

- ``genomes``: one FASTA file a genome (a MAG), cut into contigs whose
  lengths are a fixed multiset a genome, written in a seeded order; a
  CheckM2 quality report whose completeness and contamination come from
  a fixed list by member index; a list file of the genome paths.
- ``contigs``: one FASTA file of equal-length contigs (viral contigs), in
  a fixed order that scatters each family over the file.

Every member, singletons included, is its family's base with exactly
``round(length * (1 - identity))`` substitutions, each to another base.

Every file is an anonymous in-memory file (``memfd_create``), which the
job opens by its ``/proc/<pid>/fd/<n>`` path: the corpus lives in RAM as
a warm page cache holds it on a node, no corpus is written to disk, and
no job's reads wait on a file system whose speed follows the host's
load. ``Corpus.close`` frees them.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)
# Shape-only streams (fixed across seeds) use this key beside an index.
_SHAPE_KEY = 0x5EED


@dataclass
class Unit:
    """One clustered unit: a genome file or a contig record."""

    name: str          # the name clusters.tsv writes (path or contig name)
    family: int
    member: int        # index within its family
    length: int        # bases
    contig_lengths: List[int] = field(default_factory=list)


class MemFiles:
    """In-memory files, each with a path that open() takes, kept until
    close()."""

    def __init__(self) -> None:
        self.fds: List[int] = []

    def create(self, name: str) -> str:
        fd = os.memfd_create(name, 0)
        self.fds.append(fd)
        return f"/proc/{os.getpid()}/fd/{fd}"

    def close(self) -> None:
        for fd in self.fds:
            os.close(fd)
        self.fds = []


@dataclass
class Corpus:
    """What the generator wrote and knows: units in input order, their
    families, and the files the job reads."""

    kind: str                      # "genomes" or "contigs"
    files: MemFiles
    units: List[Unit]
    families: List[List[int]]      # unit indices of each family
    paths: Dict[str, str]          # "list", "quality", "fasta"

    def close(self) -> None:
        self.files.close()

    def family_sizes(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for fam in self.families:
            out[len(fam)] = out.get(len(fam), 0) + 1
        return out

    def within_family_directed_pairs(self) -> int:
        return sum(len(f) * (len(f) - 1) for f in self.families)

    def total_bases(self) -> int:
        return sum(u.length for u in self.units)

    def shape(self) -> dict:
        """The seed-independent description the tests hold fixed."""
        return {
            "units": len(self.units),
            "bases": self.total_bases(),
            "family_sizes": sorted(self.family_sizes().items()),
            "directed_pairs": self.within_family_directed_pairs(),
            "contigs": sum(max(1, len(u.contig_lengths)) for u in self.units),
        }


def family_list(traffic: dict) -> List[int]:
    """Family sizes in family order, from [[count, size], ...]."""
    return [int(size) for count, size in traffic["families"]
            for _ in range(int(count))]


def _family_lengths(traffic: dict) -> List[int]:
    """Base length of each family: equal for contigs; for genomes evenly
    spaced over [length_min, length_max] within each size class, so each
    class's mean is the midpoint."""
    out: List[int] = []
    for count, size in traffic["families"]:
        count = int(count)
        if traffic["kind"] == "contigs":
            out += [int(traffic["length"])] * count
        else:
            lo, hi = float(traffic["length_min"]), float(traffic["length_max"])
            if count == 1:
                out.append(int(round((lo + hi) / 2)))
            else:
                out += [int(round(x)) for x in np.linspace(lo, hi, count)]
    return out


def contig_multiset(length: int, n: int, min_len: int,
                    genome_index: int) -> np.ndarray:
    """A genome's contig lengths, fixed by its index (not the seed):
    lognormal shares of what lies above n * min_len, summing to
    `length` exactly."""
    if n <= 1:
        return np.array([length], dtype=np.int64)
    rng = np.random.default_rng([_SHAPE_KEY, 1, genome_index])
    w = rng.lognormal(0.0, 0.8, n)
    spare = length - n * min_len
    if spare < 0:
        raise ValueError(f"{n} contigs of at least {min_len} exceed {length}")
    extra = np.floor(w / w.sum() * spare).astype(np.int64)
    extra[: spare - int(extra.sum())] += 1
    return extra + min_len


def _substitute(rng: np.random.Generator, codes: np.ndarray,
                n_mut: int) -> np.ndarray:
    """A copy of `codes` (2-bit bases) with exactly n_mut substitutions at
    distinct seeded sites, each to another base."""
    out = codes.copy()
    if n_mut:
        pos = rng.choice(len(codes), size=n_mut, replace=False)
        out[pos] = (out[pos] + rng.integers(1, 4, size=n_mut,
                                            dtype=np.uint8)) & 3
    return out


def _substitute_rows(rng: np.random.Generator, rows: np.ndarray,
                     n_mut: int) -> np.ndarray:
    """_substitute on every row of a (N, L) block: n_mut distinct sites a
    row, drawn with replacement and de-duplicated (rows that come up
    short draw again one by one)."""
    out = rows.copy()
    if n_mut == 0:
        return out
    n, length = rows.shape
    draw = rng.integers(0, length, size=(n, n_mut + 16))
    draw.sort(axis=1)
    dup = np.zeros_like(draw, dtype=bool)
    dup[:, 1:] = draw[:, 1:] == draw[:, :-1]
    draw[dup] = length
    draw.sort(axis=1)
    sites = draw[:, :n_mut]
    short = np.flatnonzero(sites[:, -1] >= length)
    for r in short:
        sites[r] = rng.choice(length, size=n_mut, replace=False)
    shift = rng.integers(1, 4, size=(n, n_mut), dtype=np.uint8)
    rr = np.repeat(np.arange(n), n_mut)
    cc = sites.ravel()
    out[rr, cc] = (out[rr, cc] + shift.ravel()) & 3
    return out


def _wrapped(seq_ascii: np.ndarray, width: int) -> bytes:
    """Sequence bytes with a newline after every `width` bases and at the
    end."""
    n = len(seq_ascii)
    full = n // width
    body = seq_ascii[: full * width].reshape(full, width)
    lines = np.concatenate(
        [body, np.full((full, 1), 10, dtype=np.uint8)], axis=1).ravel()
    tail = seq_ascii[full * width:]
    if len(tail):
        lines = np.concatenate([lines, tail, np.array([10], np.uint8)])
    return lines.tobytes()


def _write(path: str, chunks: Sequence[bytes]) -> None:
    with open(path, "wb") as fh:
        for c in chunks:
            fh.write(c)


def quality_of_member(member: int) -> Tuple[float, float]:
    """(completeness %, contamination %) of a genome from its member
    index: a fixed list, so the quality order is the same every seed."""
    comp = 98.0 - 0.07 * ((member * 37) % 100) - 0.001 * member
    cont = 0.2 + 0.05 * ((member * 11) % 20)
    return round(comp, 3), round(cont, 3)


def make_corpus(traffic: dict, seed: int) -> Corpus:
    """Write the corpus of `traffic` for `seed` into memory files."""
    files = MemFiles()
    try:
        return _make(traffic, seed, files)
    except BaseException:
        files.close()
        raise


def _make(traffic: dict, seed: int, files: MemFiles) -> Corpus:
    sizes = family_list(traffic)
    lengths = _family_lengths(traffic)
    identity = float(traffic["identity"])
    width = int(traffic.get("line_width", 80))
    if traffic["kind"] == "genomes":
        return _make_genomes(traffic, seed, sizes, lengths, identity, width,
                             files)
    if traffic["kind"] == "contigs":
        return _make_contigs(traffic, np.random.default_rng(seed % (1 << 64)),
                             sizes, lengths, identity, width, files)
    raise ValueError(f"unknown traffic kind {traffic['kind']!r}")


def _make_genomes(traffic, seed, sizes, lengths, identity, width,
                  files: MemFiles, workers: int = 4) -> Corpus:
    """One FASTA a genome. Each family's base and each genome's mutations
    and contig order come from streams of their own keyed by the seed and
    the index, so the files are the same however the pool orders them."""
    n_contigs = int(traffic["contigs_per_genome"])
    min_contig = int(traffic["contig_min"])
    s64 = seed % (1 << 64)
    fam_of = np.repeat(np.arange(len(sizes)), sizes)
    member_of = np.concatenate([np.arange(s) for s in sizes])
    units = [Unit(files.create(f"g{gi:05d}.fna"), int(fam_of[gi]),
                  int(member_of[gi]), lengths[fam_of[gi]])
             for gi in range(len(fam_of))]

    def base(f):
        return np.random.default_rng([s64, 1, f]).integers(
            0, 4, size=lengths[f], dtype=np.uint8)

    def write(gi, base_codes):
        u = units[gi]
        rng = np.random.default_rng([s64, 2, gi])
        codes = _substitute(rng, base_codes,
                            int(round(u.length * (1.0 - identity))))
        cl = contig_multiset(u.length, n_contigs, min_contig, gi)
        cl = cl[rng.permutation(len(cl))]
        u.contig_lengths = [int(x) for x in cl]
        ascii_ = _ASCII[codes]
        ends = np.cumsum(cl)
        stem = f"g{gi:05d}"
        chunks = []
        for j, (s, e) in enumerate(zip(ends - cl, ends)):
            chunks.append(f">{stem}_c{j:03d}\n".encode())
            chunks.append(_wrapped(ascii_[s:e], width))
        _write(u.name, chunks)

    first = np.concatenate([[0], np.cumsum(sizes)])
    with ThreadPoolExecutor(max_workers=workers) as pool:
        bases = list(pool.map(base, range(len(sizes))))
        for f in pool.map(
                lambda gi: write(gi, bases[fam_of[gi]]), range(len(units))):
            pass
    families = [list(range(first[f], first[f + 1]))
                for f in range(len(sizes))]
    # CheckM2 names a genome by its file's stem: here the fd number.
    quality = ["Name\tCompleteness\tContamination\n"]
    for u in units:
        comp, cont = quality_of_member(u.member)
        quality.append(f"{os.path.basename(u.name)}\t{comp}\t{cont}\n")
    paths = {"list": files.create("genomes.txt"),
             "quality": files.create("quality_report.tsv")}
    _write(paths["list"], [(u.name + "\n").encode() for u in units])
    _write(paths["quality"], [q.encode() for q in quality])
    return Corpus("genomes", files, units, families, paths)


def contig_order(n_units: int) -> np.ndarray:
    """File position of each contig (by family order): a fixed
    permutation, the same every seed, that scatters a family's members
    over the file as a vOTU's contigs are scattered over samples."""
    return np.random.default_rng([_SHAPE_KEY, 2, n_units]).permutation(
        n_units)


def _make_contigs(traffic, rng, sizes, lengths, identity, width,
                  files: MemFiles) -> Corpus:
    length = int(traffic["length"])
    if any(x != length for x in lengths):
        raise ValueError("contig traffic wants one length")
    n_fam = len(sizes)
    fam_of = np.repeat(np.arange(n_fam), sizes)
    member_of = np.concatenate([np.arange(s) for s in sizes])
    n = len(fam_of)
    pos_of = contig_order(n)               # family-order index -> file row
    n_mut = int(round(length * (1.0 - identity)))
    digits = max(6, len(str(n - 1)))
    path = files.create("contigs.fna")
    step = 20_000
    with open(path, "wb") as fh:
        rows = np.empty((n, length), dtype=np.uint8)
        for lo in range(0, n_fam, step):
            hi = min(n_fam, lo + step)
            bases = rng.integers(0, 4, size=(hi - lo, length), dtype=np.uint8)
            sel = np.flatnonzero((fam_of >= lo) & (fam_of < hi))
            block = _substitute_rows(rng, bases[fam_of[sel] - lo], n_mut)
            rows[pos_of[sel]] = block
        ascii_ = _ASCII[rows]
        del rows
        full = length // width
        rest = length - full * width
        for lo in range(0, n, step):
            hi = min(n, lo + step)
            blk = ascii_[lo:hi]
            k = hi - lo
            heads = np.frombuffer(
                "".join(f">v{i:0{digits}d}\n" for i in range(lo, hi)).encode(),
                dtype=np.uint8).reshape(k, -1)
            body = np.concatenate(
                [blk[:, : full * width].reshape(k, full, width),
                 np.full((k, full, 1), 10, np.uint8)], axis=2).reshape(k, -1)
            parts = [heads, body]
            if rest:
                parts += [blk[:, full * width:], np.full((k, 1), 10, np.uint8)]
            fh.write(np.concatenate(parts, axis=1).tobytes())
    row_of = np.empty(n, dtype=np.int64)
    row_of[pos_of] = np.arange(n)          # file row -> family-order index
    units = [Unit(f"v{r:0{digits}d}", int(fam_of[row_of[r]]),
                  int(member_of[row_of[r]]), length) for r in range(n)]
    families: List[List[int]] = [[] for _ in range(n_fam)]
    for r in range(n):
        families[units[r].family].append(r)
    return Corpus("contigs", files, units, families, {"fasta": path})


def sample_families(corpus: Corpus, check: dict, seed: int) -> List[int]:
    """Families the output check covers, drawn from the seed: for each
    family size in check["families"] that many families of that size
    (all where fewer exist). The largest family is always among them."""
    rng = np.random.default_rng([(seed % (1 << 64)), 0xC4EC])
    by_size: Dict[int, List[int]] = {}
    for f, fam in enumerate(corpus.families):
        by_size.setdefault(len(fam), []).append(f)
    chosen: List[int] = []
    for size_s, count in sorted(check["families"].items(),
                                key=lambda t: -int(t[0])):
        pool = by_size.get(int(size_s), [])
        take = min(int(count), len(pool))
        if take:
            chosen += [int(x) for x in rng.choice(pool, size=take,
                                                   replace=False)]
    largest = max(range(len(corpus.families)),
                  key=lambda f: len(corpus.families[f]))
    if largest not in chosen:
        chosen.insert(0, largest)
    return chosen


def cross_pairs(corpus: Corpus, units: Sequence[int], per_unit: int,
                seed: int) -> List[Tuple[int, int]]:
    """For each checked unit, `per_unit` other checked units of other
    families, drawn from the seed: pairs the screen and verify must
    leave out."""
    rng = np.random.default_rng([(seed % (1 << 64)), 0xC805])
    units = list(units)
    fam = np.array([corpus.units[u].family for u in units])
    out = set()
    if len(set(fam.tolist())) < 2:
        return []
    for idx, u in enumerate(units):
        others = np.flatnonzero(fam != fam[idx])
        for o in rng.choice(others, size=min(per_unit, len(others)),
                            replace=False):
            v = units[int(o)]
            out.add((min(u, v), max(u, v)))
    return sorted(out)


def expected_hashes(length: int, k: int, scale: int) -> float:
    """Hashes FracMinHash keeps from a sequence of `length` random bases:
    one in `scale` of its k-mer starts."""
    return max(0, length - k + 1) / scale
