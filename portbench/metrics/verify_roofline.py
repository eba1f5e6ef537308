"""The verify kernels' share of their byte bound, K7 and K8 counted as
one: each within-family unit's fragment stream and offsets read once,
its member bitmap row read once, and each directed pair's result written
once (``roofline.verify_bytes``), over their summed device time."""

from portbench.roofline import share, verify_bytes

KERNELS = ("pair_table_verify", "grouped_verify_")


def read(ctx):
    return share(verify_bytes(ctx.corpus, ctx.sketch, ctx.member_bits),
                 ctx.device_seconds(KERNELS))
