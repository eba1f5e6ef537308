"""Seconds of the traced job's wall, from the call of the port's CLI
entry to its return: ``job_s`` read per layer, in cells whose host
spreads a window's mean too widely to hold it end to end."""


def read(ctx):
    return ctx.wall_s
