"""Time the port's two kernels, and what the main path pays around them,
for one or more checkouts of the repository on one card, in turns.

    python3 kernel_ab.py --tree PARENT --tree . --tree . --tree PARENT \\
        [--out kernel_ab.json]

Each `--tree` is the root of a checkout (an unpacked `git archive` of an
earlier commit, or `.`).  Each runs in a process of its own, in the order
given, that imports that tree's `mmloam_tpu_torch` and this tree's
`chip_smoke.py` helpers, and measures:

- first, while the process has traced nothing, the kernels of one call
  (`chip_smoke.kernel_census`: a trace counts only when it recorded every
  launch of ours that the wrapper's counter saw) on chip_smoke.py's
  synthetic room at the main path's shapes: `factors.associate_planes`
  and `associate_lines` with the local rescue, `assoc.associate_with_rescue`
  where the tree has it, and `map_insert.insert_batched`;
- then on the flagship `replay_batch` (LIOConfig(), B=4 x T=16, inputs as
  chip_smoke.py phase 4 builds them): each lane's ATE (the warm-up run),
  replay scans/sec (a warm-up run, then two timed runs; host clock around
  work that ends in a synchronize), and the device busy share over scans
  14-15 of a third run under torch.profiler (kernel device time over the
  profiled wall, and over the unprofiled wall of the timed runs);
- K2 on lane 0's maps (surf M=2048 fresh with blocks, surf from cached
  blocks, corner M=512 fresh): the kernel's device time (torch.profiler
  self device time over its launches, or a CUDA graph of 100 launches
  where the profiler recorded fewer), the launch incl. host (CUDA events
  around the wrapper's launch), the entry (`assoc.associate`), the plain
  version (`assoc.associate_reference`) and the bound (chip_smoke.k2_work,
  from this run's inputs); one `associate_planes` / `associate_lines`
  call and `associate_with_rescue` alone, synchronised host clock;
- K1 on chip_smoke.py phase 2's accumulate case (second insert) at B=16
  and B=4, N=2048, and on the main path's own insert (each lane's newest
  surf stack into its persistent surf map after the warm-up run): device
  time, launch incl. host, `insert_batched` per call, the plain
  `insert_batched_reference`, and the bound (chip_smoke.k1_bytes).

The kernels' launch functions differ between trees; where a tree has the
older API (no `map_insert.sort_points`, no `assoc.associate_with_rescue`)
this script takes that tree's.  Prints one JSON line per tree and writes
them all to `--out`.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _smoke():
    """This tree's chip_smoke.py, loaded by path (another tree's package
    is first on sys.path)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _synced_ms(fn, reps=20):
    """Median host-clock time of `fn()` between two synchronizes, ms."""
    import numpy as np
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def _association_calls(cfg, inp):
    """{name: call} of one association as the estimator makes it, on
    chip_smoke's census inputs (identity pose)."""
    import torch

    from mmloam_tpu_torch.estimator import factors
    from mmloam_tpu_torch.ops import assoc

    q, mask, vm, vml, thres = (inp[f] for f in ("q", "q_mask", "vm", "vml",
                                                "thres"))
    dev = q.device
    x6, Rbl, tbl = (torch.zeros(6, device=dev), torch.eye(3, device=dev),
                    torch.zeros(3, device=dev))
    calls = {
        "associate_planes": lambda: factors.associate_planes(
            x6, q, mask, vm, Rbl, tbl, cfg, thres,
            cfg.solver.plan_weight_tan, vm_local=vml, with_blocks=True),
        "associate_lines": lambda: factors.associate_lines(
            x6, q, mask, vm, Rbl, tbl, cfg, thres, vm_local=vml,
            with_blocks=True)}
    if hasattr(assoc, "associate_with_rescue"):
        calls["associate_with_rescue"] = lambda: assoc.associate_with_rescue(
            vm, vml, q, mask, cfg.map, cfg.local_map, cfg.map.knn,
            assoc.PLANE, thres, cfg.solver.plane_scatter_ratio,
            factors._rescue_cap(q.shape[0], cfg.solver.local_rescue_frac),
            want_blocks=True)
    return calls


def _census(cs, cfg, dev):
    """Kernels per call, from complete traces (or the reason there is
    none)."""
    from mmloam_tpu_torch.ops import assoc, map_insert

    inp = cs.census_inputs(cfg, dev)
    calls = {n: (c, "assoc_kernel", lambda: assoc.LAUNCHES)
             for n, c in _association_calls(cfg, inp).items()}
    calls["insert_batched"] = (lambda: map_insert.insert_batched(
        inp["cells"], inp["pts"], inp["mask"], cfg.map), "map_insert",
        lambda: map_insert.LAUNCHES)
    out = {}
    for name, (call, ours, count) in calls.items():
        try:
            mine, mem, other, names = cs.kernel_census(call, (ours,), count)
            out[name] = dict(ours=mine, memsets=mem, others=other,
                             other_kernels=names)
        except AssertionError as e:
            out[name] = dict(error=str(e))
    return out, inp


def _replay(cs, cfg, dev):
    import torch

    from mmloam_tpu_torch import replay
    from mmloam_tpu_torch.estimator import factors

    B, T = 4, 16
    scans, gts = cs.flagship_inputs(cfg, B, T, 7, dev)
    st, outs = replay.replay_batch(cs.fresh_states(cfg, B, dev), scans, cfg)
    torch.cuda.synchronize()
    pose, ts = outs.pose_p.cpu().numpy(), outs.t.cpu().numpy()
    ate = [cs._ate(pose[:, b], ts[:, b], *gts[b]) for b in range(B)]
    lane0 = cs._lane0(st)
    # the main path's own insert: each lane's newest surf stack into its
    # persistent surf map
    W = cfg.solver.window
    pw = torch.stack([factors._world_points(
        st.x[b, W - 1, :6], st.stacks.surf[b, W - 1], st.Rbl[b], st.tbl[b])
        for b in range(B)]).contiguous()
    main_insert = (st.vm_surf.cells.clone(), pw,
                   st.stacks.surf_mask[:, W - 1].contiguous())
    st = None
    secs = []
    for _ in range(2):
        states = cs.fresh_states(cfg, B, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay.replay_batch(states, scans, cfg)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    cut = lambda lo, hi: type(scans)(*(None if a is None else a[lo:hi]
                                       for a in scans))
    st, _ = replay.replay_batch(cs.fresh_states(cfg, B, dev), cut(0, T - 2),
                                cfg)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        replay.replay_batch(st, cut(T - 2, T), cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = sum(cs._self_device_us(e) for e in prof.key_averages()
                 if "CUDA" in str(getattr(e, "device_type", "")))
    lane_scans = B * 2
    per_scan_unprof = min(secs) / (B * T)
    return lane0, main_insert, dict(
        B=B, T=T, ate=ate, timed_secs=secs,
        scans_per_sec=[B * T / s for s in secs],
        busy_window="scans 14-15", device_ms_per_lane_scan=dev_us / 1e3
        / lane_scans, busy_share_profiled=dev_us / 1e6 / wall,
        busy_share_unprofiled=dev_us / 1e6 / lane_scans / per_scan_unprof)


def _k2(cs, lane0, cfg, dev):
    import torch

    from mmloam_tpu_torch.estimator import factors
    from mmloam_tpu_torch.ops import assoc, voxelmap

    W = cfg.solver.window
    st = lane0["stacks"]
    x6 = lane0["x"][W - 1, :6]
    k = cfg.map.knn
    thres = torch.tensor(cfg.solver.thres_dist, device=dev)
    out = {}
    calls = {}
    for feat, mode, vm_f, vml_f in (
            ("surf", assoc.PLANE, "vm_surf", "vm_local_surf"),
            ("corner", assoc.LINE, "vm_corner", "vm_local_corner")):
        p_l = getattr(st, feat)[W - 1]
        mask = getattr(st, feat + "_mask")[W - 1]
        pw = factors._world_points(x6, p_l, lane0["Rbl"], lane0["tbl"])
        moved = factors._world_points(x6 + 3e-3, p_l, lane0["Rbl"],
                                      lane0["tbl"])
        sr = cfg.solver.plane_scatter_ratio if mode == assoc.PLANE else 0.0
        vm = voxelmap.VoxelMap(lane0[vm_f])
        vml = voxelmap.VoxelMap(lane0[vml_f])
        args = (vm, pw, mask, cfg.map, k, mode, thres, sr)
        _, blocks = assoc.associate_reference(*args)
        entries = [("fresh", None, pw)]
        if feat == "surf":
            entries.append(("cached", blocks, moved))
        for entry, cached, q in entries:
            cargs = (vm, q) + args[2:]
            want = cached is None
            a, bufs = assoc.prepare(assoc.OUT, *cargs, cached, want)
            launch = lambda: assoc.launch(assoc.OUT, a, dev)
            entry_fn = lambda: assoc.associate(*cargs, cached=cached,
                                               want_blocks=want)
            d_ms, how = cs.device_ms(entry_fn, "assoc_kernel", launch)
            nbytes, ops = cs.k2_work(vm, q, cfg.map, cached is None, want)
            bound, by = cs.bound_ms(nbytes, ops)
            out[f"{feat} persistent {entry}"] = dict(
                M=int(q.shape[0]), device_ms=d_ms, device_how=how,
                launch_ms=cs.cuda_ms(launch), entry_ms=cs.cuda_ms(entry_fn),
                plain_ms=cs.cuda_ms(lambda: assoc.associate_reference(
                    *cargs, cached=cached)),
                bytes=nbytes, bound_ms=bound, bound_by=by)
            bufs = None
        if mode == assoc.PLANE:
            call = lambda: factors.associate_planes(
                x6, p_l, mask, vm, lane0["Rbl"], lane0["tbl"], cfg, thres,
                cfg.solver.plan_weight_tan, vm_local=vml, with_blocks=True)
        else:
            call = lambda: factors.associate_lines(
                x6, p_l, mask, vm, lane0["Rbl"], lane0["tbl"], cfg, thres,
                vm_local=vml, with_blocks=True)
        rec = dict(synced_ms=_synced_ms(call))
        if hasattr(assoc, "associate_with_rescue"):
            rec["with_rescue_synced_ms"] = _synced_ms(
                lambda: assoc.associate_with_rescue(
                    vm, vml, pw, mask, cfg.map, cfg.local_map, k, mode,
                    thres, sr, factors._rescue_cap(
                        pw.shape[0], cfg.solver.local_rescue_frac),
                    want_blocks=True))
        calls[f"associate_{'planes' if mode == assoc.PLANE else 'lines'}"] \
            = rec
    return out, calls


def _k1(cs, cfg, dev, main_insert):
    import numpy as np
    import torch

    from mmloam_tpu_torch.ops import map_insert, voxelmap

    cases = []
    for B in (16, 4):
        N = 2048
        mcfg = dataclasses.replace(cfg.map, count_cap=10.0)
        Cs = voxelmap.empty_map(mcfg).cells.shape[0]
        rng = np.random.default_rng(0)
        steps = cs._insert_cases(mcfg, B, N, rng)[0][1]
        cells = torch.zeros((B, Cs, 128), device=dev)
        p, m = (torch.from_numpy(a).to(dev) for a in steps[0])
        map_insert.insert_batched(cells, p, m, mcfg)
        p, m = (torch.from_numpy(a).to(dev) for a in steps[1])
        cases.append((f"B={B} N={N}", mcfg, cells, p, m))
    cells, p, m = main_insert
    cases.append((f"main path surf B={p.shape[0]} N={p.shape[1]}", cfg.map,
                  cells, p, m))
    out = {}
    for label, mcfg, cells, p, m in cases:
        entry_fn = lambda: map_insert.insert_batched(cells, p, m, mcfg)
        if hasattr(map_insert, "sort_points"):
            sp = map_insert.sort_points(p, m, mcfg)
            launch = lambda: map_insert.aggregate_rmw(cells, sp, mcfg)
        else:                   # a tree whose kernel takes row updates
            upd = map_insert.aggregate_updates(p, m, mcfg)
            launch = lambda: map_insert.rmw(cells, upd, mcfg.count_cap)
        d_ms, how = cs.device_ms(entry_fn, "map_insert", launch)
        nbytes = cs.k1_bytes(map_insert, p, m, mcfg)
        bound, by = cs.bound_ms(nbytes, 0)
        out[label] = dict(
            rows=int(map_insert.aggregate_updates(p, m, mcfg).nv.sum()),
            device_ms=d_ms, device_how=how, launch_ms=cs.cuda_ms(launch),
            entry_ms=cs.cuda_ms(entry_fn), entry_synced_ms=_synced_ms(
                entry_fn),
            plain_ms=cs.cuda_ms(lambda: map_insert.insert_batched_reference(
                cells, p, m, mcfg)),
            bytes=nbytes, bound_ms=bound, bound_by=by)
    return out


def child(tree):
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA device")
    import mmloam_tpu_torch
    from mmloam_tpu_torch.config import LIOConfig

    cs = _smoke()
    dev = torch.device("cuda", 0)
    cfg = LIOConfig()
    res = dict(tree=tree, package=os.path.dirname(mmloam_tpu_torch.__file__),
               card=cs.card_line(), torch=torch.__version__)
    res["census"], inp = _census(cs, cfg, dev)
    inp = None
    lane0, main_insert, res["replay"] = _replay(cs, cfg, dev)
    res["k2"], res["assoc_calls"] = _k2(cs, lane0, cfg, dev)
    res["k1"] = _k1(cs, cfg, dev, main_insert)
    print(json.dumps(res), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True)
    ap.add_argument("--out")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        child(a.tree[0])
        return 0
    results, rc = [], 0
    for tree in a.tree:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", "--tree", tree], capture_output=True,
                           text=True, timeout=900)
        sys.stderr.write(p.stderr[-4000:])
        if p.returncode != 0:
            rc = p.returncode
            print(f"kernel_ab: {tree} failed ({p.returncode})", flush=True)
            continue
        line = p.stdout.strip().splitlines()[-1]
        results.append(json.loads(line))
        print(line, flush=True)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(results, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
