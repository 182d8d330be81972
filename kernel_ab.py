"""Time the port's kernels, and what the main path pays around them,
for one or more checkouts of the repository on one card, in turns.

    python3 kernel_ab.py --tree PARENT --tree . --tree . --tree PARENT \\
        [--out kernel_ab.json]

Each `--tree` is the root of a checkout (an unpacked `git archive` of an
earlier commit, or `.`).  Each runs in a process of its own, in the
order given, that imports that tree's `mmloam_tpu_torch` and this tree's
`chip_smoke.py` helpers, and measures:

- first, while the process has traced nothing, the kernels of one call
  (`chip_smoke.kernel_census`: a trace counts only when it recorded every
  launch of ours that the wrapper's counter saw) on chip_smoke.py's
  synthetic room at the main path's shapes: `factors.associate_planes`
  and `associate_lines` with the local rescue, `assoc.associate_with_rescue`
  where the tree has it, and `map_insert.insert_batched`;
- then the flagship `replay_batch` (LIOConfig(), B=4 x T=16 unless
  `--batch`/`--scans` say otherwise, inputs as chip_smoke.py phase 4
  builds them) once, for the maps and stacks the cases below take, and
  each lane's ATE (the replay's time is the benchmark's:
  `benchmark/run.py`, and by layer `benchmark/layer_split.py`);
- K2 on lane 0's maps (surf M=2048 fresh with blocks, surf from cached
  blocks, corner M=512 fresh): the kernel's device time (torch.profiler
  self device time over its launches, or a CUDA graph of 100 launches
  where the profiler recorded fewer), the launch incl. host (CUDA events
  around the wrapper's launch), the entry (`assoc.associate`), the plain
  version (`assoc.associate_reference`) and the bound (chip_smoke.k2_work,
  from this run's inputs); one `associate_planes` / `associate_lines`
  call and `associate_with_rescue` alone, synchronised host clock;
- K2's lane axis, where the tree has one: one fresh launch (surf, M=2048
  a lane, with blocks) over 4 and 16 lanes (the replay's lanes repeated),
  beside one launch on lane 0 alone;
- K1 on chip_smoke.py phase 2's accumulate case (second insert) at B=16
  and B=4, N=2048, and on the main path's own insert (each lane's newest
  surf stack into its persistent surf map after the replay): device
  time, launch incl. host, `insert_batched` per call, the plain
  `insert_batched_reference`, and the bound (chip_smoke.k1_bytes);
- the kernels' general instances, as chip_smoke.py phase 9 times them:
  K1 on the B=16 accumulate case at packs (2,2,2), (1,1,1) and (4,4,4);
  K2 surf fresh (M=2048, with blocks) on lane 0's maps repacked to
  (2,2,2), (1,1,1), (4,4,4) and (4,4,2) with stencil (3,3,2); the
  default window under `dedup_gather` (capacity 2), fresh and its rescue
  pair (the local map under the same dedup, at the flagship cap).  K1's
  cases also run through each general instance the tree has, whichever
  its `map_insert.instance` picks.  A geometry a tree's kernels refuse is
  recorded with the error.

`--only-k1` times K1's cases alone (no census, replay or K2);
`--only-k3` times K3 alone, on phase 4's final Amm and A* (B=4, the
last scan of the eager B=4 x T=16 run, as chip_smoke.check_eigh takes
them: the first child saves them under chip_smoke_out/, and every later
child of the call decomposes the same matrices) and on chip_smoke's
stress sets at B=16 and B=64: device µs (a CUDA graph of 100 launches),
the slowest matrix's sweeps, rounds and µs a round
(`chip_smoke.eigh_round_time`), and bit-equality with the tree's
`jacobi_reference` on the finite lanes.

The kernels' launch functions differ between trees; where a tree has the
older API (no `map_insert.sort_points`, no `assoc.associate_with_rescue`,
K2 wrappers without a lane axis: no `assoc._check_lanes`) this script
takes that tree's (`_up` gives one lane in the form the tree's K2 takes).
Prints one JSON line per tree and writes them all to `--out`.
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


def _up(assoc):
    """One lane's K2 arguments (queries, masks, gates, maps' cells, x6
    and extrinsics) in the form this tree's wrappers take them: with a
    lane axis of one, or as they are on a tree older than the lane axis
    (no `assoc._check_lanes`)."""
    if hasattr(assoc, "_check_lanes"):
        return lambda a: a[None]
    return lambda a: a


def _lane0(cs, st):
    """Lane 0 of a run's final state without its lane axis: maps, window
    poses, extrinsics and stacks (copies)."""
    full = cs._final_lanes(st)
    out = {k: v[0] for k, v in full.items() if k != "stacks"}
    out["stacks"] = type(full["stacks"])(
        *(None if a is None else a[0] for a in full["stacks"]))
    return out


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
    chip_smoke's census inputs (one lane, identity pose) in the tree's
    form."""
    import torch

    from mmloam_tpu_torch.estimator import factors
    from mmloam_tpu_torch.ops import assoc, voxelmap

    up = _up(assoc)
    q, mask, thres = (up(inp[f][0]) for f in ("q", "q_mask", "thres"))
    vm, vml = (voxelmap.VoxelMap(up(inp[f].cells[0])) for f in ("vm", "vml"))
    dev = q.device
    x6, Rbl, tbl = (up(torch.zeros(6, device=dev)), torch.eye(3, device=dev),
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
            factors._rescue_cap(q.shape[-2], cfg.solver.local_rescue_frac),
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


def _clear_graphs():
    from mmloam_tpu_torch import replay

    if hasattr(replay, "clear_graphs"):
        replay.clear_graphs()


def _replay(cs, cfg, dev, B=4, T=16):
    """The flagship `replay_batch` whose final state the K1 and K2 cases
    read: lane 0 (`_lane0`), the main path's own insert (each lane's
    newest surf stack into its persistent surf map) and each lane's
    ATE."""
    import torch

    from mmloam_tpu_torch import replay
    from mmloam_tpu_torch.estimator import factors

    scans, gts = cs.flagship_inputs(cfg, B, T, 7, dev)
    st, outs = replay.replay_batch(cs.fresh_states(cfg, B, dev), scans, cfg)
    torch.cuda.synchronize()
    pose, ts = outs.pose_p.cpu().numpy(), outs.t.cpu().numpy()
    ate = [cs._ate(pose[:, b], ts[:, b], *gts[b]) for b in range(B)]
    lane0 = _lane0(cs, st)
    W = cfg.solver.window
    pw = torch.stack([factors._world_points(
        st.x[b, W - 1, :6], st.stacks.surf[b, W - 1], st.Rbl[b], st.tbl[b])
        for b in range(B)]).contiguous()
    main_insert = (st.vm_surf.cells.clone(), pw,
                   st.stacks.surf_mask[:, W - 1].contiguous())
    st = None
    _clear_graphs()
    return lane0, main_insert, dict(B=B, T=T, ate=ate)


def _time_k2(cs, dev, vm, pw, mask, mcfg, mode, thres, sr, cached, want):
    """K2's times on one lane's case, its arguments in the tree's form
    (`_up`): device time, launch incl. host, the entry (`assoc.associate`),
    the plain version (`assoc.associate_reference`) and the bound."""
    from mmloam_tpu_torch.ops import assoc

    cargs = (vm, pw, mask, mcfg, mcfg.knn, mode, thres, sr)
    a, bufs = assoc.prepare(assoc.OUT, *cargs, cached, want)
    launch = lambda: assoc.launch(assoc.OUT, a, dev)
    entry = lambda: assoc.associate(*cargs, cached=cached, want_blocks=want)
    d_ms, how = cs.device_ms(entry, "assoc_kernel", launch)
    q = pw if pw.dim() == 3 else pw[None]
    nbytes, ops = cs.k2_work(vm, q, mcfg, cached is None, want)
    bound, by = cs.bound_ms(nbytes, ops)
    return dict(M=int(q.shape[1]), device_ms=d_ms, device_how=how,
                launch_ms=cs.cuda_ms(launch), entry_ms=cs.cuda_ms(entry),
                plain_ms=cs.cuda_ms(lambda: assoc.associate_reference(
                    *cargs, cached=cached)),
                bytes=nbytes, bound_ms=bound, bound_by=by)


def _stack(lane0, cfg, feat, moved=False):
    """Lane 0's newest `feat` stack in the world at its window pose (3 mm
    off with `moved`) and its mask, without a lane axis."""
    from mmloam_tpu_torch.estimator import factors

    W = cfg.solver.window
    x6 = lane0["x"][W - 1, :6] + (3e-3 if moved else 0.0)
    p_l = getattr(lane0["stacks"], feat)[W - 1]
    return (factors._world_points(x6, p_l, lane0["Rbl"], lane0["tbl"]),
            getattr(lane0["stacks"], feat + "_mask")[W - 1])


def _k2(cs, lane0, cfg, dev):
    import torch

    from mmloam_tpu_torch.estimator import factors
    from mmloam_tpu_torch.ops import assoc, voxelmap

    up = _up(assoc)
    W = cfg.solver.window
    st = lane0["stacks"]
    x6 = lane0["x"][W - 1, :6]
    k = cfg.map.knn
    thres = up(torch.tensor(cfg.solver.thres_dist, device=dev))
    out = {}
    calls = {}
    for feat, mode, vm_f, vml_f in (
            ("surf", assoc.PLANE, "vm_surf", "vm_local_surf"),
            ("corner", assoc.LINE, "vm_corner", "vm_local_corner")):
        p_l = getattr(st, feat)[W - 1]
        pw, mask = _stack(lane0, cfg, feat)
        moved, _ = _stack(lane0, cfg, feat, moved=True)
        sr = cfg.solver.plane_scatter_ratio if mode == assoc.PLANE else 0.0
        vm = voxelmap.VoxelMap(up(lane0[vm_f]))
        vml = voxelmap.VoxelMap(up(lane0[vml_f]))
        _, blocks = assoc.associate_reference(vm, up(pw), up(mask), cfg.map,
                                              k, mode, thres, sr)
        entries = [("fresh", None, pw)]
        if feat == "surf":
            entries.append(("cached", blocks, moved))
        for entry, cached, q in entries:
            out[f"{feat} persistent {entry}"] = _time_k2(
                cs, dev, vm, up(q), up(mask), cfg.map, mode, thres, sr,
                cached, cached is None)
        args = (up(x6), up(p_l), up(mask), vm, lane0["Rbl"], lane0["tbl"],
                cfg, thres)
        if mode == assoc.PLANE:
            call = lambda: factors.associate_planes(
                *args, cfg.solver.plan_weight_tan, vm_local=vml,
                with_blocks=True)
        else:
            call = lambda: factors.associate_lines(
                *args, vm_local=vml, with_blocks=True)
        rec = dict(synced_ms=_synced_ms(call))
        if hasattr(assoc, "associate_with_rescue"):
            rec["with_rescue_synced_ms"] = _synced_ms(
                lambda: assoc.associate_with_rescue(
                    vm, vml, up(pw), up(mask), cfg.map, cfg.local_map, k,
                    mode, thres, sr, factors._rescue_cap(
                        pw.shape[0], cfg.solver.local_rescue_frac),
                    want_blocks=True))
        calls[f"associate_{'planes' if mode == assoc.PLANE else 'lines'}"] \
            = rec
    return out, calls


def _k2_lanes(cs, cfg, dev, main_insert):
    """K2's lane axis (trees that have one): device time of one fresh
    launch (surf, plane mode, M=2048 a lane, with blocks) over the main
    path's lanes (the run's B) and over 4 and 16 lanes (its lanes
    repeated), beside one launch on lane 0 alone, and each one's bound."""
    import torch

    from mmloam_tpu_torch.ops import assoc, voxelmap

    if not hasattr(assoc, "_check_lanes"):
        return None
    cells, pw, mask = main_insert
    sr = cfg.solver.plane_scatter_ratio
    out = {}
    for B in (1, 4, 16):
        rep = -(-B // cells.shape[0])
        c = cells.repeat(rep, 1, 1)[:B].contiguous()
        p, m = pw.repeat(rep, 1, 1)[:B], mask.repeat(rep, 1)[:B]
        thres = torch.full((B,), cfg.solver.thres_dist, device=dev)
        vm = voxelmap.VoxelMap(c)
        a, bufs = assoc.prepare(assoc.OUT, vm, p, m, cfg.map, cfg.map.knn,
                                assoc.PLANE, thres, sr, None, True)
        launch = lambda: assoc.launch(assoc.OUT, a, dev)
        d_ms, how = cs.device_ms(launch, "assoc_kernel", launch)
        bound, by = cs.bound_ms(*cs.k2_work(vm, p, cfg.map, True, True))
        out[f"B={B}"] = dict(device_ms=d_ms, device_how=how, bound_ms=bound,
                             bound_by=by, M=int(p.shape[1]))
        bufs = c = None
    one = out["B=1"]["device_ms"]
    for B in (4, 16):
        out[f"B={B}"]["single_lane_times_B_ms"] = B * one
    return out


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
    if main_insert is not None:
        cells, p, m = main_insert
        cases.append((f"main path surf B={p.shape[0]} N={p.shape[1]}",
                      cfg.map, cells, p, m))
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


def _general(cs, lane0, cfg, dev):
    """The general instances' cases of chip_smoke.py phase 9 (see the
    module docstring), each {device_ms, ..., bound_ms} or {error}; K2's
    only where `lane0` is given."""
    import numpy as np
    import torch

    from mmloam_tpu_torch.estimator import factors
    from mmloam_tpu_torch.ops import assoc, map_insert, voxelmap

    out = {}

    def run(name, fn):
        try:
            out[name] = fn()
        except (NotImplementedError, RuntimeError) as e:
            out[name] = dict(error=f"{type(e).__name__}: {e}")

    def k1_case(pack, inst=None):
        B, N = 16, 2048
        mcfg = cs.with_pack(dataclasses.replace(cfg.map, count_cap=10.0),
                            pack)
        Cs, R = voxelmap.empty_map(mcfg).cells.shape
        steps = cs._insert_cases(mcfg, B, N, np.random.default_rng(0))[0][1]
        cells = torch.zeros((B, Cs, R), device=dev)
        p, m = (torch.from_numpy(a).to(dev) for a in steps[0])
        map_insert.insert_batched(cells, p, m, mcfg)
        p, m = (torch.from_numpy(a).to(dev) for a in steps[1])
        sp = map_insert.sort_points(p, m, mcfg)
        kw = {} if inst is None else dict(inst=inst)
        launch = lambda: map_insert.aggregate_rmw(cells, sp, mcfg, **kw)
        entry = (launch if inst is not None else
                 lambda: map_insert.insert_batched(cells, p, m, mcfg))
        d_ms, how = cs.device_ms(entry, "map_insert", launch)
        nbytes = cs.k1_bytes(map_insert, p, m, mcfg)
        bound, by = cs.bound_ms(nbytes, 0)
        return dict(rows=int(map_insert.aggregate_updates(p, m, mcfg)
                             .nv.sum()), device_ms=d_ms, device_how=how,
                    entry_ms=cs.cuda_ms(entry), bytes=nbytes,
                    bound_ms=bound, bound_by=by)

    # each general instance the tree has, beside the one it chooses
    alts = [i for i in ("groups", "rows")
            if i in getattr(map_insert, "INSTANCES", ())]
    for pack in ((2, 2, 2), (1, 1, 1), (4, 4, 4)):
        run("k1 pack{}{}{} B=16 N=2048".format(*pack),
            lambda: k1_case(pack))
        for inst in alts:
            run("k1 pack{}{}{} B=16 N=2048 {}".format(*pack, inst),
                lambda: k1_case(pack, inst))
    if lane0 is None:
        return out

    up = _up(assoc)
    thres = up(torch.tensor(cfg.solver.thres_dist, device=dev))
    pw, mask = _stack(lane0, cfg, "surf")
    sr = cfg.solver.plane_scatter_ratio

    def k2_case(gcfg, pair=False):
        vm = voxelmap.VoxelMap(up(cs.repack(lane0["vm_surf"], cfg.map,
                                            gcfg.map)))
        if pair:
            vml = voxelmap.VoxelMap(up(cs.repack(
                lane0["vm_local_surf"], cfg.local_map, gcfg.local_map)))
            args = (vm, vml, up(pw), up(mask), gcfg.map, gcfg.local_map,
                    gcfg.map.knn, assoc.PLANE, thres, sr,
                    factors._rescue_cap(pw.shape[0],
                                        gcfg.solver.local_rescue_frac))
            call = lambda: assoc.associate_with_rescue(*args,
                                                       want_blocks=True)
            d_ms, how = cs.device_ms(call, "assoc_kernel", call, per_call=2)
            return dict(device_ms=d_ms, device_how=how,
                        entry_ms=cs.cuda_ms(call))
        return _time_k2(cs, dev, vm, up(pw), up(mask), gcfg.map, assoc.PLANE,
                        thres, sr, None, True)

    st332 = dict(stencil_x=3, stencil_y=3, stencil_z=2)
    geoms = [("pack{}{}{}".format(*p), p, {}) for p in
             ((2, 2, 2), (1, 1, 1), (4, 4, 4))]
    geoms.append(("pack442-st332", (4, 4, 2), st332))
    for tag, pack, kw in geoms:
        gcfg = cfg.replace(map=cs.with_pack(cfg.map, pack, **kw),
                           local_map=cs.with_pack(cfg.local_map, pack, **kw))
        run(f"k2 {tag} surf fresh", lambda: k2_case(gcfg))
    dd = cfg.replace(
        map=dataclasses.replace(cfg.map, dedup_gather=True),
        local_map=dataclasses.replace(cfg.local_map, dedup_gather=True))
    run("k2 dedup2 surf fresh", lambda: k2_case(dd))
    run("k2 dedup2 surf rescue pair", lambda: k2_case(dd, pair=True))
    return out


K3_INPUTS = os.path.join(HERE, "chip_smoke_out", "kernel_ab_k3_inputs.pt")


def _k3(cs, cfg, dev, inputs=K3_INPUTS):
    """K3's cases (`--only-k3` in the module docstring)."""
    import torch

    from mmloam_tpu_torch.ops import eigh

    if os.path.exists(inputs):
        marg = torch.load(inputs).to(dev)
    else:
        scans, _ = cs.flagship_inputs(cfg, cs.FLAGSHIP_B, cs.FLAGSHIP_T, 7,
                                      dev)
        _, _, seen = cs.eager_run(cs.fresh_states(cfg, cs.FLAGSHIP_B, dev),
                                  scans, cfg)
        marg = torch.stack(seen)
        os.makedirs(os.path.dirname(inputs), exist_ok=True)
        torch.save(marg.cpu(), inputs)
    sets = {"flagship Amm": marg[0], "flagship A*": marg[1],
            "stress B=16": cs.eigh_stress(dev, B=16, seed=12),
            "stress B=64": cs.eigh_stress(dev)}
    out = {}
    for name, A in sets.items():
        A = A.contiguous()
        r = cs.eigh_round_time(A)
        w, V = eigh.eigh(A)
        wr, Vr = eigh.jacobi_reference(A)
        ok = torch.isfinite(A).flatten(-2).all(dim=-1)
        r["bit_equal"] = (torch.equal(w[ok], wr[ok])
                          and torch.equal(V[ok], Vr[ok]))
        r["max_abs_err"] = float((w[ok] - wr[ok]).abs().max())
        out[name] = r
    return out


def child(tree, only_k1=False, batch=4, scans=16, only_k3=False):
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA device")
    import mmloam_tpu_torch
    from mmloam_tpu_torch.config import LIOConfig

    cs = _smoke()
    dev = torch.device("cuda", 0)
    cfg = LIOConfig()
    res = dict(tree=tree,
               package=os.path.dirname(mmloam_tpu_torch.__file__),
               card=cs.card_line(), torch=torch.__version__)
    if only_k3:
        res["k3"] = _k3(cs, cfg, dev)
        print(json.dumps(res), flush=True)
        return
    if only_k1:
        res["k1"] = _k1(cs, cfg, dev, None)
        res["general"] = _general(cs, None, cfg, dev)
        print(json.dumps(res), flush=True)
        return
    res["census"], inp = _census(cs, cfg, dev)
    inp = None
    lane0, main_insert, res["replay"] = _replay(cs, cfg, dev, batch, scans)
    res["k2"], res["assoc_calls"] = _k2(cs, lane0, cfg, dev)
    res["k2_lanes"] = _k2_lanes(cs, cfg, dev, main_insert)
    res["k1"] = _k1(cs, cfg, dev, main_insert)
    res["general"] = _general(cs, lane0, cfg, dev)
    print(json.dumps(res), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True)
    ap.add_argument("--out")
    ap.add_argument("--only-k1", action="store_true",
                    help="time K1 alone: its B=16 and B=4 cases and its "
                    "general instances, each beside the others")
    ap.add_argument("--only-k3", action="store_true",
                    help="time K3 alone: phase 4's Amm and A* and the "
                    "stress sets at B=16 and B=64")
    ap.add_argument("--batch", type=int, default=4, help="replay lanes")
    ap.add_argument("--scans", type=int, default=16, help="replay scans")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        child(a.tree[0], a.only_k1, a.batch, a.scans, a.only_k3)
        return 0
    if a.only_k3 and os.path.exists(K3_INPUTS):
        os.remove(K3_INPUTS)        # this call's first child makes them
    results, rc = [], 0
    for tree in a.tree:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", "--tree", tree,
                            "--batch", str(a.batch), "--scans", str(a.scans)]
                           + ["--only-k1"] * a.only_k1
                           + ["--only-k3"] * a.only_k3,
                           capture_output=True, text=True, timeout=1800)
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
