"""Seconds of the program's sketch phase (``phases_s.sketch``). With
device sketching the phases overlap: the screen and the verify are fed
inside it, so this spans sketch, most of the screen and the verify fed
while rows arrive."""


def read(ctx):
    return ctx.phases.get("sketch")
