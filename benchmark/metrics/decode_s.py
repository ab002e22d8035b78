"""Staged pipeline: ``classify`` decoding the ``.res`` files on the host
(its ``decode`` phase), seconds per job."""


def read(ctx):
    return ctx.phase_mean("staged", "stages", "classify", "decode")
