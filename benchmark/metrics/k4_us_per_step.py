"""K4's device time a replayed step, microseconds, from the traced
stretch: the kernels whose name holds the LM's damped solve's
(`lm_damped_solve_kernel`, `mmloam_tpu_torch/csrc/lm_solve.cu`), weighed as
the job's scans are.  The harness's census holds a piece's K1-K3 kernels
to the launches counted, not K4's; here each piece's K4 kernels are held
to the K4 launches the program counted for its call
(`spans.call_launches()`: the calls of as many scans and the piece's
K1-K3 launches).  Nothing where they differ (the profiler dropped
records), where the program keeps no such count, or where neither piece
holds a K4 kernel (a program without K4)."""

from harness import layers

NAME = "lm_damped_solve_kernel"


def _k4(piece):
    return [(s, e) for s, e, n, kernel in piece.dev if kernel and NAME in n]


def _counted(piece, calls):
    """The K4 launches the program counted for `piece`'s call, None where
    no call, or calls that disagree, match it."""
    got = piece.launches()
    want = {c.get("k4", 0) for c in calls if c.get("scans") == piece.steps
            and all(c.get(k, 0) == got.get(k, 0) for k in ("k1", "k2", "k3"))}
    return want.pop() if len(want) == 1 else None


def read(ctx):
    pieces = (ctx.pre, ctx.post)
    if not any(_k4(p) for p in pieces):
        return None
    spans = layers.spans_module()
    calls = getattr(spans, "call_launches", lambda: None)()
    if not calls or any(len(_k4(p)) != _counted(p, calls) for p in pieces):
        return None
    return ctx.weighted(lambda p: sum(e - s for s, e in _k4(p)) / 1e9) * 1e6
