"""K2's share of its roofline: the least time its first launches need
(`harness/work.py`, counted from the reference's association calls on
the traced scans) over K2's device time on those scans, weighed as the
job's scans are.  Nothing where the stretch ran no K2."""


def read(ctx):
    spent = ctx.weighted(lambda p: p.kernel_s("k2"))
    if spent <= 0:
        return None
    need = (ctx.share_pre * ctx.k2_least_s(ctx.pre_scans) / ctx.pre.steps
            + (1 - ctx.share_pre) * ctx.k2_least_s(ctx.post_scans)
            / ctx.post.steps)
    return 100.0 * need / spent
