"""Seconds the program spent verifying candidate pairs
(``phases_s.verify``): the feeder's chunks inside the sketch phase and
any tail after it."""


def read(ctx):
    return ctx.phases.get("verify")
