"""The readings the limits of `correct` are set from, many seeds in one
process: for each seed, one job of the cell's entry (the job the
window's comparison would sample) against the reference, and, with
`--control`, the reference one step of precision lower in the program's
place.  Prints one JSON line a seed: the compared numbers of the program
and of the control, and the per-scan detail.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        [--control tf32] [--program 0]

The benchmark's own runs never run the control.
"""

from __future__ import annotations

import json
import time

from . import compare, main as mainmod, program as programmod
from . import spec as specmod, traffic as trafficmod


def readings(cell, seed, device, controls=("tf32",), program=True,
             workers=None):
    """One seed's readings: {"program": numbers, <control>: numbers, and
    each one's per-scan detail} for each name of `controls`
    (`compare.CONTROLS`)."""
    import torch

    tr = cell.traffic
    values = cell.config["config"]
    prog = programmod.Program(values, tr, device)
    lanes = trafficmod.build(tr, prog.sizes(), seed, workers)
    job = mainmod.sampled_job(seed)
    shift = (job + 1) * tr["job_shift_m"]
    out = dict(seed=seed, job=job)
    got = None
    if program:
        base = prog.to_device(lanes.scans)
        t0 = time.perf_counter()
        final, outs = prog.run(prog.fresh(),
                               programmod.job_scans(base, shift))
        got = compare.program_outputs(outs, final)
        out["program_s"] = time.perf_counter() - t0
        del final, outs, base
    scans = mainmod._shifted(lanes.scans, shift, device)
    t0 = time.perf_counter()
    ref = compare.reference_replay(values, tr, scans, device)
    out["reference_s"] = time.perf_counter() - t0
    if got is not None:
        out["program"], out["program_detail"] = compare.numbers(
            got, ref, lanes.gt_R, lanes.gt_p)
    for name in controls:
        t0 = time.perf_counter()
        low = compare.reference_replay(values, tr, scans, device, lower=name)
        out[name + "_s"] = time.perf_counter() - t0
        out[name], out[name + "_detail"] = compare.numbers(
            low, ref, lanes.gt_R, lanes.gt_p)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="",
                    help="controls to read, comma-separated: "
                    + ", ".join(compare.CONTROLS))
    ap.add_argument("--program", type=int, default=1)
    args = ap.parse_args(argv)
    cell = specmod.load(args.workload)
    if not torch.cuda.is_available():
        mainmod.log("no CUDA device")
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(cell, seed, device,
                     [c for c in args.control.split(",") if c],
                     bool(args.program))
        print(json.dumps(r), flush=True)
    return 0
