"""Synthetic genome generation with known ground-truth ANI.

Used by correctness-at-scale tests and benchmarks: random base genomes
plus per-family mutated copies at controlled substitution rates, so the
expected clustering is known exactly.

The port's own copy of galah_tpu/utils/synth.py, so that the port
imports nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_genome(rng: np.random.Generator, length: int) -> np.ndarray:
    return _BASES[rng.integers(0, 4, size=length)]


def mutate(
    rng: np.random.Generator, genome: np.ndarray, ani: float
) -> np.ndarray:
    """Point-substitute bases at rate (1 - ani)."""
    out = genome.copy()
    n_mut = rng.binomial(len(genome), 1.0 - ani)
    pos = rng.choice(len(genome), size=n_mut, replace=False)
    # substitute with a *different* base
    shift = rng.integers(1, 4, size=n_mut).astype(np.uint8)
    code = np.searchsorted(_BASES, out[pos])
    out[pos] = _BASES[(code + shift) % 4]
    return out


def mutate_indels(
    rng: np.random.Generator,
    genome: np.ndarray,
    ani: float,
    indel_events_per_sub: float = 0.1,
    mean_indel_len: float = 3.0,
    max_indel_len: int = 50,
) -> Tuple[np.ndarray, float]:
    """Substitutions at rate (1 - ani) plus indel events.

    Indel events occur at `indel_events_per_sub` times the substitution
    count (microbial genomes run ~1 indel per 8-20 substitutions);
    lengths are geometric with the given mean, capped at
    `max_indel_len`, split evenly between insertions (random sequence)
    and deletions. Returns (sequence, gap_excluded_ani): the ANI an
    aligner reports over aligned columns — indels open gaps, which are
    excluded from the identity denominator, so the ground truth is set
    by the substitution rate alone. (k-mer containment estimators see
    every indel event as ~(k+len-1)/k substitutions' worth of lost
    k-mers; this function exists to quantify that bias.)"""
    out = mutate(rng, genome, ani)
    n_sub = int(round(len(genome) * (1.0 - ani)))
    n_indel = rng.binomial(max(n_sub, 1), min(indel_events_per_sub, 1.0)) \
        if indel_events_per_sub <= 1.0 else int(n_sub * indel_events_per_sub)
    if n_indel == 0:
        return out, ani * 100.0
    # geometric lengths with the requested mean (p = 1/mean), capped
    lens = np.minimum(
        rng.geometric(1.0 / max(mean_indel_len, 1.0), size=n_indel),
        max_indel_len,
    )
    pos = np.sort(rng.choice(len(out) - max_indel_len, size=n_indel,
                             replace=False))[::-1]
    is_ins = rng.random(n_indel) < 0.5
    parts = out
    for p, ln, ins in zip(pos, lens, is_ins):
        if ins:
            parts = np.concatenate(
                [parts[:p], random_genome(rng, int(ln)), parts[p:]]
            )
        else:
            parts = np.concatenate([parts[:p], parts[p + ln:]])
    return parts, ani * 100.0


_COMP = {65: 84, 67: 71, 71: 67, 84: 65}  # A<->T, C<->G
_COMP_LUT = np.arange(256, dtype=np.uint8)
for _k, _v in _COMP.items():
    _COMP_LUT[_k] = _v


def revcomp(seq: np.ndarray) -> np.ndarray:
    return _COMP_LUT[seq[::-1]]


def rearrange(
    rng: np.random.Generator,
    genome: np.ndarray,
    n_events: int = 4,
    segment_frac: float = 0.05,
) -> np.ndarray:
    """Segmental rearrangements: each event either inverts (reverse-
    complements) a random segment or translocates it elsewhere. Aligned
    identity is unchanged outside breakpoints (aligners report the
    segments as separate same-identity alignments), so ground-truth ANI
    is whatever the input carried; only breakpoint k-mers are lost."""
    out = genome.copy()
    seg = max(1000, int(len(genome) * segment_frac))
    for _ in range(n_events):
        start = int(rng.integers(0, len(out) - seg))
        segment = out[start : start + seg]
        if rng.random() < 0.5:
            out[start : start + seg] = revcomp(segment)
        else:
            rest = np.concatenate([out[:start], out[start + seg:]])
            dest = int(rng.integers(0, len(rest)))
            out = np.concatenate([rest[:dest], segment, rest[dest:]])
    return out


def fragment_into_contigs(
    rng: np.random.Generator, genome: np.ndarray, n_contigs: int
) -> List[np.ndarray]:
    """Split a genome into n_contigs at random breakpoints (MAG-style
    assembly fragmentation)."""
    if n_contigs <= 1:
        return [genome]
    cuts = np.sort(
        rng.choice(len(genome) - 2, size=n_contigs - 1, replace=False) + 1
    )
    return np.split(genome, cuts)


def subsample_contigs(
    rng: np.random.Generator,
    contigs: List[np.ndarray],
    completeness: float,
) -> List[np.ndarray]:
    """Keep a random subset of contigs totalling ~completeness of the
    bases — an incomplete MAG (CheckM completeness 60-90% regime). ANI
    over the retained sequence is unchanged; aligned fraction drops to
    ~completeness (what the reference's min-aligned-fraction guards,
    src/fastani.rs:55-65)."""
    order = rng.permutation(len(contigs))
    total = sum(len(c) for c in contigs)
    kept: List[np.ndarray] = []
    acc = 0
    for i in order:
        if acc >= completeness * total:
            break
        kept.append(contigs[i])
        acc += len(contigs[i])
    return kept or [contigs[int(order[0])]]


def add_contamination(
    rng: np.random.Generator,
    contigs: List[np.ndarray],
    contaminant: np.ndarray,
    frac: float,
    n_contigs: int = 5,
) -> List[np.ndarray]:
    """Append contigs drawn from an unrelated `contaminant` genome
    totalling ~frac of the host's bases (CheckM contamination regime)."""
    total = sum(len(c) for c in contigs)
    want = int(total * frac)
    pieces = fragment_into_contigs(
        rng, contaminant[: max(want, n_contigs * 2)], n_contigs
    )
    return list(contigs) + pieces


def write_fasta_contigs(
    path: str, contigs: List[np.ndarray], name: str, width: int = 80
) -> None:
    with open(path, "w") as f:
        for ci, seq in enumerate(contigs):
            f.write(f">{name}_c{ci}\n")
            b = seq.tobytes()
            for i in range(0, len(b), width):
                f.write(b[i : i + width].decode("ascii"))
                f.write("\n")


def write_fasta(path: str, seq: np.ndarray, name: str, width: int = 80) -> None:
    with open(path, "w") as f:
        f.write(f">{name}\n")
        b = seq.tobytes()
        for i in range(0, len(b), width):
            f.write(b[i : i + width].decode("ascii"))
            f.write("\n")


def make_contig_corpus(
    path: str,
    n_families: int,
    members_per_family: int,
    contig_length: int = 5_000,
    within_ani: float = 0.98,
    seed: int = 0,
) -> Tuple[List[str], List[int]]:
    """One multi-contig FASTA of related contig families (the viral/
    plasmid --cluster-contigs workload). Returns (contig_names,
    family_id_per_contig)."""
    rng = np.random.default_rng(seed)
    names: List[str] = []
    family_ids: List[int] = []
    with open(path, "w") as f:
        for fam in range(n_families):
            base = random_genome(rng, contig_length)
            for m in range(members_per_family):
                seq = base if m == 0 else mutate(rng, base, within_ani)
                name = f"fam{fam}_c{m}"
                f.write(f">{name}\n")
                b = seq.tobytes()
                for i in range(0, len(b), 80):
                    f.write(b[i : i + 80].decode("ascii"))
                    f.write("\n")
                names.append(name)
                family_ids.append(fam)
    return names, family_ids


def make_families(
    directory: str,
    n_families: int,
    members_per_family: int,
    genome_length: int = 200_000,
    within_ani: float = 0.98,
    seed: int = 0,
) -> Tuple[List[str], List[int]]:
    """Generate families of related genomes. Returns (paths,
    family_id_per_path). Unrelated families are random sequences (ANI
    effectively ~25% k-mer-wise: no sharing)."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths: List[str] = []
    family_ids: List[int] = []
    for fam in range(n_families):
        base = random_genome(rng, genome_length)
        for m in range(members_per_family):
            seq = base if m == 0 else mutate(rng, base, within_ani)
            p = os.path.join(directory, f"fam{fam}_m{m}.fna")
            write_fasta(p, seq, f"fam{fam}_m{m}")
            paths.append(p)
            family_ids.append(fam)
    return paths, family_ids


def make_strains(
    directory: str,
    n_species: int,
    strains_per_species: int,
    members_per_strain: int,
    genome_length: int = 200_000,
    strain_ani: float = 0.98,
    within_ani: float = 0.997,
    seed: int = 0,
) -> Tuple[List[str], List[int]]:
    """Two-level corpus for strain-resolution workloads (BASELINE
    config #2: 1k MAGs dereplicated at 99% ANI): each species has
    `strains_per_species` strains at ~strain_ani to the species base
    (pairwise strain-strain ANI ~ 1-2*(1-strain_ani), well below a 99%
    threshold), and each strain has members at ~within_ani to the
    strain base (pairwise ~99.4% at the default — above it). Returns
    (paths, strain_id_per_path); exact dereplication recovers one
    cluster per strain."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths: List[str] = []
    strain_ids: List[int] = []
    sid = 0
    for sp in range(n_species):
        species_base = random_genome(rng, genome_length)
        for st in range(strains_per_species):
            strain_base = mutate(rng, species_base, strain_ani)
            for m in range(members_per_strain):
                seq = strain_base if m == 0 else mutate(rng, strain_base, within_ani)
                p = os.path.join(directory, f"sp{sp}_st{st}_m{m}.fna")
                write_fasta(p, seq, f"sp{sp}_st{st}_m{m}")
                paths.append(p)
                strain_ids.append(sid)
            sid += 1
    return paths, strain_ids
