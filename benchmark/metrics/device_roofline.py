"""Kernels: the least device time of the traced jobs' work
(``roofline.job_bytes`` at the published memory rate) as a share of the
union of device busy time in the traced window, in %."""


def read(ctx):
    if ctx.trace is None or ctx.trace["busy_s"] <= 0:
        return None
    return 100.0 * ctx.n_jobs * ctx.least_job_s / ctx.trace["busy_s"]
