"""Staged pipeline: ``cluster_bwt`` writing the ``.res`` score lists (its
``write`` phase, summed over the four collections), seconds per job."""


def read(ctx):
    return ctx.phase_mean("staged", "stages", "cluster_bwt", "write")
