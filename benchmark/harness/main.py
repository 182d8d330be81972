"""One run of one cell: set-up, the timed window, the traced stretch
(`--trace 1`), the comparison that decides `correct`, and the result
line.

The window is a closed loop of jobs, back to back, each a call of the
traffic's entry from a fresh state over the cell's scans moved by the
job's shift.  It runs from the first job's start to the synchronize
that ends the last job started before `--seconds` ran out, and
`scans_per_s` is every lane-scan of those jobs over that time.
`setup_s` runs from the process's start to the first job: imports, the
card's start, the kernels' build (or load from the checkout's build
directory), the inputs, and a 2-scan call that captures the graph (its
cache key holds no number of scans).
"""

from __future__ import annotations

import json
import os
import sys
import time
import types

import numpy as np

from . import compare, spec as specmod, traffic as trafficmod

FORBIDDEN = ("jax", "jaxlib", "flax", "mmloam_tpu")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (the name before the first dot, compared whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def limits_of(cell):
    path = os.path.join(specmod.BENCH, "limits", cell.name + ".json")
    with open(path) as f:
        return {k: v for k, v in json.load(f).items()
                if k not in ("about", "control")}


def sampled_job(seed):
    """The job of the window whose outputs are compared: 0 or 1, drawn
    from the seed (every window runs two jobs or more)."""
    return int(np.random.default_rng(seed).integers(2))


def run(cell, seed, seconds, trace, device, t_start, limits=None,
        workers=None):
    """The run's result (the dict printed as the last line), its lines of
    compared numbers and limits printed on standard error last."""
    import torch

    from . import program as programmod

    tr = cell.traffic
    prog = programmod.Program(cell.config["config"], tr, device)
    t_imp = time.perf_counter()
    log(f"setup: imports and card {t_imp - t_start:.3f} s")
    lanes = trafficmod.build(tr, prog.sizes(), seed, workers)
    t_in = time.perf_counter()
    log(f"setup: inputs {t_in - t_imp:.3f} s ({tr['lanes']} lanes x "
        f"{tr['scans']} scans)")
    base = prog.to_device(lanes.scans)
    T = tr["scans"]
    warm, _ = prog.run(prog.fresh(), _cut(base, 0, 2))
    del warm
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    sync()
    t_warm = time.perf_counter()
    runner = prog.runner()
    capture_s = None if runner is None else runner.capture_s
    log(f"setup: warm-up {t_warm - t_in:.3f} s (graph capture "
        f"{capture_s} s), peak {_peak(device)} B")
    setup_s = t_warm - t_start

    keep = sampled_job(seed)
    poses, kept = [], None
    t0 = time.perf_counter()
    j = 0
    while True:
        shift = (j + 1) * tr["job_shift_m"]
        final, outs = prog.run(prog.fresh(), programmod.job_scans(base,
                                                                  shift))
        sync()
        poses.append(outs.pose_p)
        if j == keep:
            kept = (final, outs)
        del final, outs
        j += 1
        t1 = time.perf_counter()
        if t1 - t0 >= seconds and j > keep:
            break
    window_s = t1 - t0
    jobs = j
    peak = _peak(device)
    runner = prog.runner()
    hist = None if runner is None else runner.flag_history
    bodies = None if hist is None else float(hist.sum()) / T
    log(f"window: {jobs} jobs in {window_s:.3f} s, peak {peak} B")

    lanes_n = tr["lanes"]
    failed = sum(int((~torch.isfinite(p.reshape(T, lanes_n, 3))
                      .all(dim=(0, 2))).sum()) for p in poses)
    ctx = types.SimpleNamespace(capture_s=capture_s, if_bodies=bodies, T=T)
    pieces = None
    if trace:
        pieces = _trace(prog, base, T, kept, tr)
    got = compare.program_outputs(kept[1], kept[0])
    del kept, poses
    prog.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    shift = (keep + 1) * tr["job_shift_m"]
    job_np = _shifted(lanes.scans, shift, device)
    calls = []
    t_ref = time.perf_counter()
    ref = compare.reference_replay(cell.config["config"], tr, job_np, device,
                                   record=calls)
    log(f"check: reference {time.perf_counter() - t_ref:.3f} s (job "
        f"{keep}, shift {shift} m)")
    nums, detail = compare.numbers(got, ref, lanes.gt_R, lanes.gt_p)
    log("check: largest position gap a scan (m): " + " ".join(
        f"{x:.2e}" for x in np.max(detail["gap"], axis=1)))
    log("check: ATE (m) of each lane, program / reference: " + " ".join(
        f"{a:.5f}/{b:.5f}" for a, b in zip(detail["ate"], detail["ate_ref"])))
    log("check: numbers " + json.dumps(nums))
    limits = limits_of(cell) if limits is None else limits
    correct, rows = compare.verdict(nums, limits)

    if trace:
        metrics = _per_layer(cell, ctx, pieces, calls)
    else:
        metrics = {"scans_per_s": dict(value=jobs * lanes_n * T / window_s,
                                       unit="scans/s"),
                   "setup_s": dict(value=setup_s, unit="s")}
        metrics = {m["name"]: metrics[m["name"]] for m in cell.end_to_end}
    dev = _device(device, cell.chips, peak)
    result = dict(correct=bool(correct), attempted=jobs * lanes_n,
                  failed=failed, metrics=metrics, device=dev)
    if trace:
        from . import trace as tracemod

        dev["busy_s"] = sum(p.busy_s() for p in pieces)
        dev["window_s"] = sum(p.span_s() for p in pieces)
        result["breakdown"] = tracemod.breakdown(pieces)
    result["limits"] = {k: [x, lim] for k, x, lim in rows}
    for k, x, lim in rows:
        log(f"compared {k} {x!r} limit {lim!r}")
    return result


def _cut(scans, a, b):
    return type(scans)(*(None if x is None else x[a:b] for x in scans))


def _shifted(scans, shift, device):
    """The job's scans as the program got them: the same float32 add on
    the same device (`program.job_scans`), back as arrays."""
    import torch

    out = dict(scans)
    for f in ("pts", "hori_pts"):
        out[f] = (torch.as_tensor(scans[f], device=device)
                  + shift).cpu().numpy()
    return out


def _peak(device):
    import torch

    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def _device(device, chips, peak):
    import torch

    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=peak)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=chips, memory_peak_bytes=peak)


def _trace(prog, base, T, kept, tr):
    """The stretch's two pieces, `trace_steps` steps between them, as
    many before init as the job's share of such scans gives (one at
    least, one after at least)."""
    from . import trace as tracemod

    inited = kept[1].inited.reshape(T, -1).all(dim=1).cpu().numpy()
    first = int(np.argmax(inited)) if inited.any() else T
    n = tr["trace_steps"]
    pre = min(max(1, round(n * first / T)), n - 1)
    pieces = tracemod.stretch(prog, lambda a, b: _cut(base, a, b),
                              prog.fresh(), T, pre, n - pre)
    for p in pieces:
        p.share_pre = first / T
    return pieces


def _per_layer(cell, ctx, pieces, calls):
    """The cell's per-layer metrics that their readers find something
    to read for."""
    from . import trace as tracemod, work

    p1, p2 = pieces
    ctx.pre, ctx.post = p1, p2
    ctx.share_pre = p1.share_pre
    ctx.weighted = lambda fn: tracemod.weighted(p1, p2, ctx.share_pre, fn)
    T = ctx.T
    ctx.pre_scans = range(0, p1.steps)
    ctx.post_scans = range(T - p2.steps, T)
    ctx.k2_least_s = lambda scans: work.k2_least_s(calls, scans)
    metrics = {}
    for m in cell.per_layer:
        value = specmod.reader(m)(ctx)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    return metrics


def main(argv, t_start):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = specmod.load(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"no result: {cell.name} needs {cell.chips} CUDA device(s), "
            f"this machine has {torch.cuda.device_count()}")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.init()
    result = run(cell, args.seed, args.seconds, args.trace, device, t_start)
    bad = forbidden_modules()
    if bad:
        log(f"no result: the run loaded {bad}")
        return 3
    print(json.dumps(result), flush=True)
    return 0
