"""The summed device time of the kernels a replayed step launches,
milliseconds, weighed as the job's scans are."""


def read(ctx):
    return ctx.weighted(lambda p: p.kernel_s()) * 1e3
