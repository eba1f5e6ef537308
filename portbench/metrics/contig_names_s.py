"""Seconds the CLI spent reading every contig's name before clustering
(the program's ``phases_s.contig_names``); contig mode only."""


def read(ctx):
    return ctx.phases.get("contig_names")
