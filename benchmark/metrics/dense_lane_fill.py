"""Fused pipeline: the share of the dense products' read lanes that
carry a read, in percent (``100 * counts["dense_lanes"] /
counts["dense_lanes_total"]``), mean over the jobs that computed a dense
product; None where none has the counters."""


def read(ctx):
    fills = []
    for job in ctx.jobs:
        counts = (job.get("fused") or {}).get("counts") or {}
        total = counts.get("dense_lanes_total")
        if total:
            fills.append(100.0 * counts.get("dense_lanes", 0) / total)
    return sum(fills) / len(fills) if fills else None
