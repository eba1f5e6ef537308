"""The plain reference against the program's own host sketcher and
verify on the CPU (the reference imports nothing of the program; this
test imports both)."""

import os

import numpy as np
import torch

from conftest import TINY
from portbench import reference as ref
from portbench.corpus import make_corpus


def test_mix64_matches_numpy():
    from galah_tpu_torch.sketch.fracminhash import mix64 as np_mix64

    x = np.random.default_rng(0).integers(0, 2**30, 1000).astype(np.uint64)
    got = ref.mix64(torch.from_numpy(x.astype(np.int64))).numpy()
    assert np.array_equal(got.view(np.uint64), np_mix64(x))


def test_sketch_and_ani_match_the_program():
    from galah_tpu_torch.engines.native import _shrink_bits
    from galah_tpu_torch.ops.fragment_ani import _forward_plain
    from galah_tpu_torch.sketch.fracminhash import (NativeSketchParams,
                                                   sketch_sequences_native)

    t = dict(TINY["mag-catalogue.gut-skew"], families=[[1, 3]])
    c = make_corpus(t, 12)
    sketch = {"k": 15, "fragment_scale": 8, "fragment_length": 3000,
              "member_bits": 1 << 22, "shrink": True,
              "min_fragment_hashes": 8, "min_fragment_identity": 0.8}
    biggest = max(os.path.getsize(u.name) for u in c.units)
    rules = ref.rules_for(sketch, biggest)
    params = _shrink_bits(NativeSketchParams(), biggest)
    assert rules.member_bits == params.member_bits
    recs = [[s for _, s in ref.read_fasta_records(u.name)] for u in c.units]
    c.close()
    made = ref.sketch_units(recs, rules, torch.device("cpu"), batch_bases=1)
    prog = [sketch_sequences_native(u.name, [s.tobytes() for s in r], params)
            for u, r in zip(c.units, recs)]
    for (sk, bm), p in zip(made, prog):
        assert np.array_equal(sk.buckets.numpy(), p.frag_buckets)
        assert np.array_equal(sk.offsets.numpy(), p.frag_offsets)
        assert np.array_equal(torch.nonzero(bm).flatten().numpy(),
                              p.member_buckets)
    words = torch.stack([torch.from_numpy(p.member_bitmap_words().view(
        np.int32)) for p in prog])
    pc = torch.tensor([p.member_popcount for p in prog], dtype=torch.float32)
    ani, af = _forward_plain(words, torch.tensor([1, 2]), pc[[1, 2]],
                             torch.from_numpy(prog[0].frag_buckets),
                             torch.from_numpy(prog[0].frag_offsets),
                             rules.member_bits, 15, 8, 0.8)
    bms = torch.stack([made[1][1], made[2][1]])
    r_ani, r_af = ref.directed_ani_af(made[0][0], bms,
                                      torch.tensor(pc[[1, 2]].tolist()), rules)
    assert torch.allclose(r_ani, ani.double(), atol=1e-4)
    assert torch.equal(r_af, af.double())


def test_greedy_clusters_in_priority_order():
    ani = {(0, 1): 97.0, (1, 2): 96.0, (0, 2): 94.0, (3, 4): 99.0}
    got = ref.greedy_clusters([2, 1, 0, 3, 4], ani, 95.0)
    # 1 joins 0, its representative of highest ANI, not 2.
    assert got == {2: [2], 0: [0, 1], 3: [3, 4]}


def test_ani_gap_is_the_pair_tables_fixed_point_sum():
    """The program's pair-table verify sums each pair's fragment
    identities in 2^-14 fixed point; the reference takes the exact mean.
    That rounding is the whole of the gap: at most 100 * 2^-15 points a
    pair, and with the reference's identities rounded the same way the
    answers agree exactly, but for a fragment whose float32 and float64
    identities round to neighbouring steps."""
    from galah_tpu_torch.ops.fragment_ani import (FragmentAniConfig,
                                                  FragmentAniEngine)
    from galah_tpu_torch.sketch.fracminhash import (NativeSketchParams,
                                                   sketch_sequences_native)

    t = dict(TINY["viral-contigs.votu"], families=[[30, 5]])
    c = make_corpus(t, 987654321123)
    sketch = {"k": 15, "fragment_scale": 2, "fragment_length": 1000,
              "member_bits": 65536, "shrink": False,
              "min_fragment_hashes": 8, "min_fragment_identity": 0.8}
    rules = ref.rules_for(sketch, 0)
    recs = ref.read_fasta_records(c.paths["fasta"])
    families = c.families
    c.close()
    made = ref.sketch_units([[s] for _, s in recs], rules,
                            torch.device("cpu"))
    params = NativeSketchParams(k=15, genome_scale=10, fragment_scale=2,
                                fragment_length=1000, prefilter_bits=32768,
                                member_bits=65536)
    prog = {i: sketch_sequences_native(n, [s.tobytes()], params)
            for i, (n, s) in enumerate(recs)}
    engine = FragmentAniEngine(FragmentAniConfig(member_bits=65536),
                               torch.device("cpu"))
    pairs = [(a, b) for f in families for i, a in enumerate(sorted(f))
             for b in sorted(f)[i + 1:]]
    got = engine.bidirectional(pairs, prog)
    sketches = {i: m[0] for i, m in enumerate(made)}
    bitmaps = {i: m[1] for i, m in enumerate(made)}
    exact = ref.pair_results(sketches, bitmaps, pairs, rules)

    def fixed_point(src, tgt):
        ident, _, aligned = ref.fragment_identities(
            sketches[src], bitmaps[tgt][None],
            torch.tensor([sketches[tgt].popcount]), rules)
        steps = torch.where(aligned, torch.round(ident * 2**14),
                            torch.zeros_like(ident))
        return float(steps.sum() / 2**14 / aligned.sum() * 100.0)

    gap = [abs(got[p][0] - exact[p][0]) for p in pairs]
    assert max(gap) <= 100 * 2**-15 + 1e-4
    assert sum(g > 1e-4 for g in gap) > len(pairs) // 2
    rounded = [abs(got[p][0] - max(fixed_point(*p), fixed_point(*p[::-1])))
               for p in pairs]
    # One step of one fragment of a contig's five: 100 * 2^-14 / 5.
    assert max(rounded) <= 100 * 2**-14 / 5 + 1e-5
    assert sum(g > 1e-5 for g in rounded) <= len(pairs) // 100
