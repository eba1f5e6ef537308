"""Each per-layer reader on a canned profile."""

import pytest

from conftest import TINY
from portbench import cell as cellmod
from portbench import roofline
from portbench.corpus import make_corpus
from portbench.trace import TraceResult, idle_by_label, union

SKETCH = {"k": 15, "genome_scale": 200, "fragment_scale": 8,
          "fragment_length": 3000, "prefilter_bits": 1 << 18,
          "member_bits": 1 << 22, "shrink": True,
          "min_fragment_hashes": 8, "min_fragment_identity": 0.8}


@pytest.fixture(scope="module")
def ctx():
    c = make_corpus(TINY["mag-catalogue.gut-skew"], 1)
    c.close()
    trace = TraceResult(
        window_s=2.0, busy_s=0.5,
        device_s={"void sketch_tile_kernel<true>(...)": 0.001,
                  "packed_popcount_kernel": 0.002,
                  "screen_epilogue_tile(Params)": 0.0005,
                  "pair_table_verify_l1": 0.0001,
                  "grouped_verify_clusters": 0.0002,
                  "Memcpy DtoH (Device -> Pageable)": 0.3},
        idle_gaps=[], events=6, samples=100)
    return cellmod.LayerContext(
        phases={"sketch": 1.5, "verify": 0.25, "contig_names": 0.75},
        counters={}, trace=trace, corpus=c, sketch=SKETCH,
        max_file_bytes=60000, member_bits=1 << 21, wall_s=3.25)


def test_phase_readers(ctx):
    assert cellmod.reader("sketch_s").read(ctx) == 1.5
    assert cellmod.reader("verify_s").read(ctx) == 0.25
    assert cellmod.reader("contig_names_s").read(ctx) == 0.75
    assert cellmod.reader("job_wall_s").read(ctx) == 3.25
    ctx2 = cellmod.LayerContext({}, {}, None, ctx.corpus, SKETCH, 1, 1)
    for name in ("sketch_s", "verify_s", "contig_names_s",
                 "device_idle_share", "sketch_roofline", "job_wall_s"):
        assert cellmod.reader(name).read(ctx2) is None


@pytest.mark.parametrize("name", ["sketch_s", "verify_roofline",
                                  "device_idle_share"])
def test_split_name_reads_as_its_base(ctx, name):
    """A metric split between cells (``<base>.<split>``) finds its base
    reader and reads the same number."""
    assert cellmod.reader(name + ".setup") is cellmod.reader(name)
    assert cellmod.reader(name + ".setup").read(ctx) == \
        cellmod.reader(name).read(ctx)


def test_idle_share(ctx):
    assert cellmod.reader("device_idle_share").read(ctx) == pytest.approx(75)


@pytest.mark.parametrize("name,seconds,bytes_fn", [
    ("sketch_roofline", 0.001,
     lambda c: roofline.sketch_bytes(c.corpus, SKETCH)),
    ("screen_roofline", 0.0025,
     lambda c: roofline.screen_bytes(c.corpus, SKETCH, c.max_file_bytes)),
    ("verify_roofline", 0.0003,
     lambda c: roofline.verify_bytes(c.corpus, SKETCH, c.member_bits)),
])
def test_roofline_readers(ctx, name, seconds, bytes_fn):
    got = cellmod.reader(name).read(ctx)
    want = 100 * bytes_fn(ctx) / roofline.HBM_BYTES_PER_S / seconds
    assert got == pytest.approx(want)
    assert 0 < got < 100


def test_byte_counts_follow_the_corpus(ctx):
    c = ctx.corpus
    n = len(c.units)
    assert roofline.screen_bytes(c, SKETCH, 60000) == pytest.approx(
        n * (1 << 13) / 8 + 8 * c.within_family_directed_pairs() / 2)
    assert roofline.prefilter_bits(SKETCH, 3_600_000) == 1 << 18
    assert roofline.sketch_bytes(c, SKETCH) > c.total_bases()


def test_idle_gaps_by_host_label():
    busy = union([(10, 20), (15, 30), (50, 60)])
    assert busy == [(10, 30), (50, 60)]
    samples = [(0, "a"), (10, "b"), (30, "c"), (40, "c"), (50, "d")]
    got = idle_by_label(busy, 0, 60, samples, 10)
    assert got == pytest.approx({"a": 10e-9, "c": 20e-9})


def test_host_peak_sampler_sees_a_transient():
    """The sampler's peak covers memory held for a moment inside the span
    and let go before its end."""
    import time

    from portbench import hostmem

    s = hostmem.PeakSampler(period_s=0.002).start()
    before = hostmem.resident_bytes()
    block = bytearray(64 << 20)
    block[:: hostmem.PAGE_BYTES] = b"\x01" * len(block[:: hostmem.PAGE_BYTES])
    time.sleep(0.05)
    del block
    peak = s.stop()
    assert s.samples >= 3
    assert peak >= before + (60 << 20)
    assert peak > hostmem.resident_bytes()
