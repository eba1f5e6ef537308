"""K5's share of its byte bound: every base read once and every kept
hash written once (``roofline.sketch_bytes``), at the HBM's peak, over
K5's device time in the traced job."""

from portbench.roofline import share, sketch_bytes

KERNELS = ("sketch_tile_kernel",)


def read(ctx):
    return share(sketch_bytes(ctx.corpus, ctx.sketch),
                 ctx.device_seconds(KERNELS))
