"""One cell's step by layer, its replay loop's clocks and its set-up by
part, with the program's spans on (`mmloam_tpu_torch/spans.py`).

    python3 benchmark/layer_split.py --workload <cell> --seed <n> \
        [--seconds 10] [--cost 0|1]

Run from the root of a checkout holding the port, on a machine with the
card.  As `run.py --trace 1` makes them: the inputs, the warm-up call
that captures the graph (here with spans on, so the runner lays a layer
on each node), a window of jobs back to back for `--seconds`, and the
traced stretch, whose two pieces are laid by layer (`harness/layers.py`).
The window's last job gives the loop's clocks: the host's time a scan
outside the graph launch and in it, and the device's idle share between
the first replay's start and the last one's end.  With `--cost 1` the
window runs four times on the one graph, spans off, on, off, on, each
with its `scans_per_s`.  No reference runs: nothing here decides
`correct`.

Prints one JSON object on the last line of standard output: `setup`
(seconds by part), `scans_per_s`, `cost`, `clocks` with `graph_idle_pct`,
`host_us_per_scan` and `launch_us_per_scan`, `layers` (`<layer>_ms_per_
step` and `<layer>_kernels_per_step`, weighed over the two pieces as the
benchmark's readers weigh them), `kernels_per_step`,
`device_ms_per_step`, `unlaid` (why a piece could not be laid; the
layers are then left out) and the stretch's longest `idle_gaps`, each
named by the host op running (the loop's parts are ranges of their own
here).  Exits 2 without a card, 3 where the program
has no spans.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _window(prog, base, tr, seconds):
    """Jobs back to back for `seconds` (two at least): scans a second and
    the last job's outputs."""
    import torch

    from harness import program as programmod

    T, j = tr["scans"], 0
    t0 = time.perf_counter()
    while True:
        final, outs = prog.run(prog.fresh(), programmod.job_scans(
            base, (j + 1) * tr["job_shift_m"]))
        torch.cuda.synchronize()
        j += 1
        wall = time.perf_counter() - t0
        if wall >= seconds and j >= 2:
            return j * tr["lanes"] * T / wall, outs


def _traced(prog, state, scans, steps):
    """One call under the profiler, held against the counters as
    `trace.trace_call` holds it: (Piece, {layer: [s, kernels]} or None,
    why not, final state)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from harness import layers, trace

    for _ in range(trace.TRIES):
        torch.cuda.synchronize()
        before = prog.launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function(trace.CALL):
                final, _ = prog.run(state, scans)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        after = prog.launches()
        want = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        piece = trace.Piece(steps, wall, *trace._events(prof))
        if dict(piece.launches()) != want:
            del final
            continue
        runner = prog.runner()
        hist = runner.flag_history
        try:
            laid, why = layers.lay(*layers.events(prof), runner.node_layers,
                                   None if hist is None else
                                   hist.cpu().tolist()), None
        except layers.Unlaid as e:
            laid, why = None, str(e)
        return piece, laid, why, final
    raise RuntimeError("no trace of the stretch matched the graph's "
                       "launches")


def _weighed(p1, v1, p2, v2, share):
    return share * v1 / p1.steps + (1 - share) * v2 / p2.steps


def run(cell, seed, seconds, cost, spans):
    import numpy as np
    import torch

    from harness import layers, main as mainmod, program as programmod
    from harness import trace, traffic as trafficmod

    tr = cell.traffic
    device = torch.device("cuda", 0)
    spans.enable(True)
    prog = programmod.Program(cell.config["config"], tr, device)
    lanes = trafficmod.build(tr, prog.sizes(), seed, None)
    base = prog.to_device(lanes.scans)
    T = tr["scans"]
    warm, _ = prog.run(prog.fresh(), mainmod._cut(base, 0, 2))
    del warm
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    runner = prog.runner()
    log(f"setup: {setup_s:.3f} s, parts {spans.last_setup()}; layers laid: "
        f"{runner.node_layers is not None} ({runner.node_layers_why})")

    rate, outs = _window(prog, base, tr, seconds)
    clocks = spans.last_call()
    log(f"window: {rate:.3f} scans/s, clocks {clocks}")
    rates = []
    if cost:
        for on in (False, True, False, True):
            spans.enable(on)
            rates.append(_window(prog, base, tr, seconds)[0])
            log(f"window, spans {'on' if on else 'off'}: {rates[-1]:.3f} "
                f"scans/s")
        spans.enable(True)

    inited = outs.inited.reshape(T, -1).all(dim=1).cpu().numpy()
    first = int(np.argmax(inited)) if inited.any() else T
    n = tr["trace_steps"]
    pre = min(max(1, round(n * first / T)), n - 1)
    share = first / T
    p1, l1, why1, st = _traced(prog, prog.fresh(), mainmod._cut(base, 0, pre),
                               pre)
    if T - (n - pre) > pre:
        st, _ = prog.run(st, mainmod._cut(base, pre, T - (n - pre)))
    p2, l2, why2, _ = _traced(prog, st, mainmod._cut(base, T - (n - pre), T),
                              n - pre)
    out = dict(
        cell=cell.name, seed=seed, setup_s=setup_s, setup=spans.last_setup(),
        scans_per_s=rate, cost=rates, clocks=clocks,
        graph_idle_pct=layers.idle_pct(clocks),
        host_us_per_scan=clocks and clocks["host_s_per_scan"] * 1e6,
        launch_us_per_scan=clocks and clocks["launch_s_per_scan"] * 1e6,
        kernels_per_step=_weighed(p1, len(p1.kernels()), p2,
                                  len(p2.kernels()), share),
        device_ms_per_step=_weighed(p1, p1.kernel_s(), p2, p2.kernel_s(),
                                    share) * 1e3,
        share_pre=share, unlaid=why1 or why2,
        idle_gaps=trace.breakdown([p1, p2])["idle_gaps"])
    if l1 is not None and l2 is not None:
        out["layers"] = {}
        for name in layers.leaves():
            a, b = l1.get(name, [0.0, 0]), l2.get(name, [0.0, 0])
            out["layers"][name + "_ms_per_step"] = _weighed(
                p1, a[0], p2, b[0], share) * 1e3
            out["layers"][name + "_kernels_per_step"] = _weighed(
                p1, a[1], p2, b[1], share)
    return out


def main(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--cost", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import layers, spec as specmod

    cell = specmod.load(args.workload)
    import torch

    if not torch.cuda.is_available():
        log("no result: needs a CUDA device")
        return 2
    spans = layers.spans_module()
    if spans is None:
        log("no result: the program has no spans (mmloam_tpu_torch.spans)")
        return 3
    torch.cuda.init()
    print(json.dumps(run(cell, args.seed, args.seconds, args.cost, spans)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
