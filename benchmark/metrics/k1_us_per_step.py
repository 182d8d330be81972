"""K1's device time a replayed step, microseconds, from the traced
stretch (the port's kernel by its name), weighed as the job's scans are."""


def read(ctx):
    return ctx.weighted(lambda p: p.kernel_s("k1")) * 1e6
