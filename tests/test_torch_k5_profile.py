"""The SASS walk that counts K5's instructions a k-mer start
(galah_tpu_torch/tools/k5_profile.py::hash_loop), on hand-written
listings in cuobjdump's format: chip_smoke.py takes K5's bound from it."""

import pytest

from galah_tpu_torch.tools import k5_profile


def _listing(body):
    return [f"        /*{addr:04x}*/                   {ins} ;"
            for addr, ins in zip(range(0, 16 * len(body), 16), body)]


def _start(skip_to):
    """One k-mer start: a byte, the validity branch (not taken on the
    common path), splitmix64's two products, the threshold branch to
    `skip_to` (taken) and the selected block's two instructions."""
    return [
        "LDS.U8 R3, [R4]",
        "ISETP.GE.AND P0, PT, R3, R5, PT",
        f"@P0 BRA 0x{skip_to:x}",
        "IMAD.WIDE.U32 R6, R3, 0x1ce4e5b9, RZ",
        "IMAD.WIDE.U32 R8, R6, 0x133111eb, RZ",
        "ISETP.GE.U32.AND P0, PT, R8, R9, PT",
        f"@P0 BRA 0x{skip_to:x}",
        "ATOMS.OR RZ, [R2], R3",
        "REDG.E.OR.STRONG.GPU desc[UR8][R12.64], R13",
    ]


def test_hash_loop_walks_the_common_path():
    # 0x00 set-up; loop 0x10-0xc0; 0xd0 exit.
    body = (["MOV R1, R2"] + _start(0xa0)
            + ["VIADD R4, R4, 0x1", "ISETP.LT.AND P1, PT, R4, R10, PT",
               "@P1 BRA 0x10", "EXIT"])
    got = k5_profile.hash_loop(_listing(body))
    # 7 instructions to the taken threshold branch, 3 after its target.
    # Of those, ISETP three times on the ALU pipe, two IMADs on the FMA
    # pipe.
    assert got == {"instructions": 12, "starts": 1, "per_start": 10.0,
                   "alu_per_start": 3.0, "fma_per_start": 2.0,
                   "range": ["0x10", "0xc0"]}


@pytest.mark.parametrize("unroll", [2, 4])
def test_hash_loop_divides_an_unrolled_loop_by_its_starts(unroll):
    body = ["MOV R1, R2"]
    for _ in range(unroll):
        after = 16 * (len(body) + 9)   # the address after this start
        body += _start(after)
    body += ["VIADD R4, R4, 0x1", "@P1 BRA 0x10", "EXIT"]
    got = k5_profile.hash_loop(_listing(body))
    assert got["starts"] == unroll
    assert got["instructions"] == 9 * unroll + 2
    assert got["per_start"] == (7 * unroll + 2) / unroll
    assert got["alu_per_start"] == 2.0
    assert got["fma_per_start"] == 2.0


def test_hash_loop_picks_the_innermost_hashing_loop():
    """An outer loop around the hash loop, and a loop without products
    (the warm-up), are not the hash loop."""
    warm = ["LDS.U8 R3, [R4]", "VIADD R4, R4, 0x1", "@P2 BRA 0x10"]
    body = ["MOV R1, R2"] + warm
    head = 16 * len(body)
    body += _start(head + 16 * 9) + ["VIADD R4, R4, 0x1",
                                     f"@P1 BRA 0x{head:x}",
                                     "@P3 BRA 0x0", "EXIT"]
    got = k5_profile.hash_loop(_listing(body))
    assert got["range"] == [hex(head), hex(head + 16 * 10)]
    assert got["per_start"] == 9.0


@pytest.mark.parametrize("ins, want", [
    ("LOP3.LUT R25, R16, 0x3, RZ, 0xc, !PT", "alu"),
    ("SHF.R.U64 R25, R26, 0x1b, R28", "alu"),
    ("ISETP.GE.U32.AND.EX P0, PT, R25, UR7, PT, P0", "alu"),
    ("VIMNMX.U32 R25, R24, R23, PT", "alu"),
    ("IMAD.WIDE.U32 R26, R25, 0x1ce4e5b9, RZ", "fma"),
    ("@!P1 IMAD.IADD R21, R17, 0x1, R11", "fma"),
    ("VIADD R22, R22, 0xffffffff", "other"),
    ("LDS.U8 R16, [R16]", "other"),
    ("@P0 BRA 0x1620", "other"),
])
def test_pipe_of_each_instruction(ins, want):
    assert k5_profile.pipe(ins) == want


@pytest.mark.parametrize("loop, want", [
    # K5's wide hash loop on an H100: the ALU pipe bounds it.
    ({"per_start": 43, "alu_per_start": 28, "fma_per_start": 10}, 28 / 64),
    ({"per_start": 43, "alu_per_start": 10, "fma_per_start": 10}, 43 / 128),
    ({"per_start": 20, "alu_per_start": 2, "fma_per_start": 15}, 15 / 64),
])
def test_clocks_per_start_takes_the_slowest_limit(loop, want):
    assert k5_profile.clocks_per_start(loop) == want


@pytest.mark.parametrize("alu, by", [(28, "operations"), (0, "bytes")])
def test_k5_bound(alu, by):
    """Operations: starts x clocks a start over 132 SMs at the clock;
    bytes: the batch's arrays read once, its products written once."""
    from galah_tpu_torch.ops import device_sketch as ds
    from galah_tpu_torch.sketch.fracminhash import small_genome_params

    params = small_genome_params()
    hb = ds.plan_layout(["a", "b"], [[5000], [3000, 200]], params)
    loop = {"per_start": alu, "alu_per_start": alu, "fma_per_start": 0}
    ms, got_by = k5_profile.k5_bound(hb, params, 100, loop, 1.98e9)
    t_ops = hb.starts * alu / 64 / (132 * 1.98e9)
    nbytes = (hb.seq.nbytes + 8 * 3 + 4 * (4 * len(hb.tile_unit) + 1)
              + 4 * (3 * len(hb.frag_start) + 1)
              + 2 * (params.member_bits + params.prefilter_bits) // 8
              + 4 * len(hb.frag_start) + 4 * 100)
    assert got_by == by
    assert ms == pytest.approx(max(t_ops, nbytes / 3.35e12) * 1e3, rel=1e-12)


def test_hash_loop_without_products_is_empty():
    body = ["MOV R1, R2", "VIADD R4, R4, 0x1", "@P1 BRA 0x10", "EXIT"]
    assert k5_profile.hash_loop(_listing(body)) == {}


@pytest.mark.parametrize("cut", sorted(k5_profile.CUTS))
def test_each_cut_has_its_return_in_the_kernel(cut):
    """k5_profile --cuts builds K5 with -DGALAH_K5_STOP_AFTER=<step>: the
    kernel must return there, or the cut times the whole kernel."""
    from galah_tpu_torch.ops._build import CSRC_DIR

    src = (CSRC_DIR / "device_sketch.cu").read_text()
    stop = k5_profile.CUTS[cut]
    assert src.count(f"if (GALAH_K5_STOP_AFTER == {stop}) return;") == 1
