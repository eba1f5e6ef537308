"""% of the traced job's wall in which no kernel, copy or set ran on
the device: 1 - (union of the device events' intervals) / wall."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
