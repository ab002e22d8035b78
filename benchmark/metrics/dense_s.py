"""Fused pipeline: host packing of the genome-dense clusters (the ``dense``
phase of ``ops.fused_pipeline``), seconds per job."""


def read(ctx):
    return ctx.phase_mean("fused", "phases", "dense")
