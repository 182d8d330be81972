"""Device kernels a replayed step launches (all B lanes of one scan), from
the traced stretch, weighed as the job's scans are."""


def read(ctx):
    return ctx.weighted(lambda p: len(p.kernels()))
