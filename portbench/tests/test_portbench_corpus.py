"""The corpus's shape is fixed by its traffic file: seeds change bases,
mutation sites and contig order, never the work."""

import os

import numpy as np
import pytest

from conftest import TINY
from portbench import reference as ref
from portbench.corpus import (contig_multiset, cross_pairs, make_corpus,
                              sample_families)


@pytest.mark.parametrize("name", sorted(TINY))
def test_three_seeds_give_one_shape(name):
    shapes = []
    seqs = []
    for seed in (1, 2, 2**31 + 7):
        c = make_corpus(TINY[name], seed)
        shapes.append(c.shape())
        first = (c.units[0].name if c.kind == "genomes"
                 else c.paths["fasta"])
        seqs.append(b"".join(s.tobytes() for _, s in
                             ref.read_fasta_records(first)))
        lengths = [sum(len(s) for _, s in ref.read_fasta_records(u.name))
                   for u in c.units] if c.kind == "genomes" else None
        if lengths is not None:
            assert lengths == [u.length for u in c.units]
        c.close()
    assert shapes[0] == shapes[1] == shapes[2]
    assert seqs[0] != seqs[1]
    c = make_corpus(TINY[name], 5)
    fams = sorted(len(f) for f in c.families)
    c.close()
    want = sorted(s for n, s in TINY[name]["families"] for _ in range(n))
    assert fams == want


def test_members_differ_from_base_by_the_identity():
    t = dict(TINY["viral-contigs.votu"], families=[[1, 3]])
    c = make_corpus(t, 9)
    recs = [s for _, s in ref.read_fasta_records(c.paths["fasta"])]
    c.close()
    n_mut = round(5000 * (1 - t["identity"]))
    for a in range(3):
        for b in range(a + 1, 3):
            d = int(np.count_nonzero(recs[a] != recs[b]))
            assert n_mut <= d <= 2 * n_mut


def test_contig_lengths_are_fixed_by_genome_index():
    a = contig_multiset(1_000_000, 100, 2000, 7)
    assert a.sum() == 1_000_000 and a.min() >= 2000
    assert np.array_equal(a, contig_multiset(1_000_000, 100, 2000, 7))
    assert not np.array_equal(a, contig_multiset(1_000_000, 100, 2000, 8))


def test_sample_keeps_the_largest_family():
    c = make_corpus(TINY["mag-catalogue.gut-skew"], 4)
    c.close()
    for seed in range(5):
        fams = sample_families(c, {"families": {"1": 1}}, seed)
        assert max(len(c.families[f]) for f in fams) == 4
        units = [u for f in fams for u in c.families[f]]
        for a, b in cross_pairs(c, units, 2, seed):
            assert c.units[a].family != c.units[b].family


def test_corpus_lives_in_memory_files():
    c = make_corpus(TINY["viral-contigs.votu"], 3)
    path = c.paths["fasta"]
    assert path.startswith("/proc/") and os.path.getsize(path) > 5000 * 26
    c.close()
    assert c.files.fds == []
