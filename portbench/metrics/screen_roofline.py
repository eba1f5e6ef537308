"""The screen's share of its byte bound, K1 and K6 counted as one: each
packed prefilter row read once and each within-family hit written once
(``roofline.screen_bytes``), over their summed device time."""

from portbench.roofline import screen_bytes, share

KERNELS = ("packed_popcount_kernel", "screen_epilogue_tile")


def read(ctx):
    return share(screen_bytes(ctx.corpus, ctx.sketch, ctx.max_file_bytes),
                 ctx.device_seconds(KERNELS))
