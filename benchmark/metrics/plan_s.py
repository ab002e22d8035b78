"""Native planner: the fused path's ``plan`` phase (``native.plan_pairs_packed``
on each collection), seconds per job."""


def read(ctx):
    return ctx.phase_mean("fused", "phases", "plan")
