"""Fused pipeline: pinned uploads and kernel launches (the ``dispatch``
phase of ``ops.fused_pipeline``), seconds per job.  Launches are
asynchronous, so this is enqueue time, not device time."""


def read(ctx):
    return ctx.phase_mean("fused", "phases", "dispatch")
