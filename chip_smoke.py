"""Smoke run of the PyTorch/CUDA port (mmloam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):

0. device check: a CUDA device is required; the card's name and power
   limit are printed as nvidia-smi reports them;
1. build the hand-written CUDA kernels K1 (csrc/map_insert.cu) and K2
   (csrc/assoc.cu) with nvcc, one process per source, started together;
2. K1 against its plain PyTorch version on the card, at the flagship
   persistent-map (131,072 superrows, B=16, N=2048) and local-map
   (36,864 superrows, N=512) shapes: two consecutive inserts whose second
   accumulates and hits the count cap, and a stale-epoch eviction one
   torus period away.  Meta lanes must be equal and sum lanes within
   SUM_ATOL (the kernel is built with -fmad=false, so they agree bit for
   bit); times are CUDA events, median of 20 launches after warm-up;
3. the port's `replay` on `tiny_config()` over the 25-scan hall sequence
   against tests/golden/hall_25.npz (inited/fail exactly; pose within
   GOLDEN_POSE_ATOL and ATE within GOLDEN_ATE_SLACK of the golden's, the
   bounds tests/test_torch_pipeline.py states and justifies), with every
   association through K2;
4. the main path: `replay_batch` at `LIOConfig()` with B=4 lanes and T=16
   scans of 16x1024 VLP-16 + 6x2048 Horizon input, every lane initialized,
   finite poses, ATE < 0.15 m per lane, surf-map occupancy in
   (500, n_cells/4), K1 launched exactly 4*T times and K2 once per
   association call (assoc.LAUNCHES == assoc.CALLS > 0); then a second,
   timed run for scans/sec;
5. K2 and each of its stages against the plain version at flagship shapes
   on the maps phase 4 built with K1 (lane 0): the newest frame's corner
   (M=512, line mode) and surf (M=2048, plane mode) stacks against the
   persistent map, their compacted rescue queries (Mr=256 / 1024) against
   the local map, fresh and from cached blocks, with dense_bf16 on and off
   (and the plane fit without the scatter gate, as faithful_config runs
   it).  GATHER/SELECT/NEED and t_k, n are exact; the float bounds are
   `assoc.compare`'s; a gate may differ only within assoc.GATE_EPS of its
   threshold, and those queries are counted.  Times are CUDA events,
   median of 20, for the kernel alone, its entry (with the torch stencil
   addressing) and the plain version, and for one case (K2_TIMED_CASE)
   each stage's kernel against its plain cut;
6. `faithful_config(tiny_config())` over the 25-scan hall sequence, as
   tests/test_faithful_mode.py runs it: initialized, finite poses,
   ATE < FAITHFUL_ATE_MAX, and every association through K2.

Before the last line come a JSON object with each kernel's launches,
error and times, and the card's name and power limit; the last line is
{"ok": true, "device": {...}}.
"""

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SUM_ATOL = 1e-5
GOLDEN_POSE_ATOL = 0.01
GOLDEN_ATE_SLACK = 0.01
FLAGSHIP_B, FLAGSHIP_T = 4, 16
ATE_MAX = 0.15
FAITHFUL_ATE_MAX = 0.5
# the K2 case whose time stands in the kernels line, and whose stages are
# timed one by one against their plain cuts
K2_TIMED_CASE = "surf persistent fresh bf16=1 scatter=0.01"
KERNEL_SOURCES = ("map_insert.cu", "assoc.cu")
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, flush=True)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Median time of `fn()` in ms, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


# --------------------------------------------------------------------------
# phase 2: K1 against its plain version
# --------------------------------------------------------------------------

def _insert_cases(mcfg, B, N, rng):
    """(name, [(pts (B,N,3), mask (B,N)), ...]) insert sequences."""
    period = (np.array([mcfg.dim_x, mcfg.dim_y, mcfg.dim_z])
              * mcfg.voxel_size).astype(np.float32)
    half = 0.45 * period
    spread = rng.uniform(-half, half, (B, N // 2, 3))
    # a dense cluster over a few dozen cells: several points per cell per
    # insert, so the second insert pushes counts past the cap
    w = 1.5 * mcfg.voxel_size
    cluster = rng.uniform(-w, w, (B, N - N // 2, 3))
    pts = np.concatenate([spread, cluster], axis=1).astype(np.float32)
    mask = rng.random((B, N)) > 0.1
    accumulate = [(pts, mask), (pts * np.float32(0.98), mask)]
    evict = [(cluster.astype(np.float32), np.ones((B, N - N // 2), bool)),
             ((cluster + period).astype(np.float32),
              np.ones((B, N - N // 2), bool))]
    return [("accumulate_and_cap", accumulate), ("stale_epoch", evict)]


def check_map_insert(dev):
    from mmloam_tpu_torch.config import LIOConfig
    from mmloam_tpu_torch.ops import map_insert, voxelmap

    cfg = LIOConfig()
    shapes = [("persistent", cfg.map, 16, 2048),
              ("local", cfg.local_map, 16, 512)]
    rng = np.random.default_rng(0)
    max_err = 0.0
    timing = {}
    for label, base, B, N in shapes:
        mcfg = dataclasses.replace(base, count_cap=10.0)
        Cs = voxelmap.empty_map(mcfg).cells.shape[0]
        for case, steps in _insert_cases(mcfg, B, N, rng):
            ck = torch.zeros((B, Cs, 128), device=dev)
            cp = torch.zeros_like(ck)
            for pts, mask in steps:
                p = torch.from_numpy(pts).to(dev)
                m = torch.from_numpy(mask).to(dev)
                map_insert.insert_batched(ck, p, m, mcfg)
                map_insert.insert_batched_reference(cp, p, m, mcfg)
            if case == "accumulate_and_cap":
                upd = map_insert.aggregate_updates(p, m, mcfg)
                cells = ck.clone()
            torch.cuda.synchronize()
            if not torch.equal(ck[..., 96:], cp[..., 96:]):
                raise AssertionError(f"K1 meta lanes differ: {label} {case}")
            err = float((ck[..., :96] - cp[..., :96]).abs().max())
            if not err <= SUM_ATOL:
                raise AssertionError(f"K1 sums differ by {err}: {label} "
                                     f"{case}")
            counts = ck[..., 96:] - torch.floor(ck[..., 96:] / 128.0) * 128.0
            if case == "accumulate_and_cap" and not bool(
                    (counts == mcfg.count_cap).any()):
                raise AssertionError("cap case never reached the cap")
            max_err = max(max_err, err)
            log(f"  K1 {label:10s} {case:18s} B={B} N={N} Cs={Cs}: meta "
                f"equal, max |sum err| {err:.3g}")
        # time the row RMW alone on the accumulate case's second insert
        ms = cuda_ms(lambda: map_insert.rmw(cells, upd, mcfg.count_cap))
        plain_ms = cuda_ms(
            lambda: map_insert.rmw_reference(cells, upd, mcfg.count_cap))
        timing[label] = dict(B=B, N=N, Cs=Cs, rows=int(upd.nv.sum()),
                             ms=ms, plain_ms=plain_ms)
        log(f"  K1 {label} rmw: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"({int(upd.nv.sum())} rows)")
    return max_err, timing


# --------------------------------------------------------------------------
# phase 3: tiny hall replay against the JAX golden
# --------------------------------------------------------------------------

def _ate(pose_p, t, gt_R, gt_p):
    gt_rel = np.einsum("ij,nj->ni", gt_R[0].T, gt_p - gt_p[0])
    idx = np.rint(np.asarray(t, np.float64) / 0.1).astype(int) - 1
    return float(np.sqrt(((pose_p - gt_rel[idx]) ** 2).sum(1).mean()))


def _check_k2_counts(label):
    """Every association call of the run that just ended launched K2."""
    from mmloam_tpu_torch.ops import assoc

    log(f"  {label}: K2 launches {assoc.LAUNCHES}, association calls "
        f"{assoc.CALLS}")
    if not assoc.LAUNCHES == assoc.CALLS > 0:
        raise AssertionError(f"{label}: K2 launched {assoc.LAUNCHES} times "
                             f"for {assoc.CALLS} association calls")
    return assoc.LAUNCHES


def check_hall_golden(dev):
    from mmloam_tpu_torch import pipeline, replay
    from mmloam_tpu_torch.config import tiny_config
    from mmloam_tpu_torch.data import synthetic
    from mmloam_tpu_torch.ops import assoc

    cfg = tiny_config()
    scans, gt_R, gt_p = replay.make_sequence(
        synthetic.default_world(), synthetic.Trajectory(speed=0.8, z_amp=0.15),
        0.0, 25, cfg, n_az=360, dtype=np.float32, device=dev)
    g = np.load(os.path.join(ROOT, "tests", "golden", "hall_25.npz"))
    assoc.LAUNCHES = assoc.CALLS = 0
    t0 = time.perf_counter()
    _, outs = replay.replay(pipeline.init_state(cfg, device=dev), scans, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    _check_k2_counts("hall_25")
    inited, fail = outs.inited.cpu().numpy(), outs.fail.cpu().numpy()
    pose = outs.pose_p.cpu().numpy()
    if not (np.array_equal(inited, g["inited"])
            and np.array_equal(fail, g["fail"])):
        raise AssertionError(f"hall inited/fail differ: {inited} {fail}")
    err = float(np.abs(pose - g["pose_p"]).max())
    ate = _ate(pose, g["t"], gt_R, gt_p)
    ate_golden = _ate(g["pose_p"], g["t"], gt_R, gt_p)
    log(f"  hall_25: inited/fail equal, max |pose - golden| {err:.4f} m, "
        f"ATE {ate:.4f} m (golden {ate_golden:.4f} m), {secs:.1f} s")
    if not (np.isfinite(pose).all() and err <= GOLDEN_POSE_ATOL
            and ate <= ate_golden + GOLDEN_ATE_SLACK):
        raise AssertionError("hall replay outside its bounds")


# --------------------------------------------------------------------------
# phase 4: flagship batched replay (the main path)
# --------------------------------------------------------------------------

def flagship_inputs(cfg, B, T, seed0, dev):
    """B lanes of T scans, built as bench.py builds them."""
    from mmloam_tpu_torch import pipeline, replay
    from mmloam_tpu_torch.data import synthetic

    world = synthetic.default_world()
    seqs, gts = [], []
    for b in range(B):
        traj = synthetic.Trajectory(speed=0.6 + 0.05 * (b % 8), z_amp=0.1,
                                    yaw_rate=0.2 + 0.02 * (b % 8))
        scans, gt_R, gt_p = replay.make_sequence(
            world, traj, 0.0, T, cfg, n_az=cfg.scan.max_pts_per_line,
            seed=seed0 + b, range_noise=0.003, dtype=np.float32,
            with_hori=True, hori_n_az=cfg.scan.hori_max_pts_per_line)
        seqs.append(scans)
        gts.append((gt_R, gt_p))
    stacked = type(seqs[0])(*(None if x is None else np.stack(
        [getattr(s, f) for s in seqs], axis=1)
        for f, x in zip(seqs[0]._fields, seqs[0])))
    return pipeline.scan_from_numpy(stacked, dev), gts


def fresh_states(cfg, B, dev):
    from mmloam_tpu_torch import pipeline, replay

    return replay.stack_states([pipeline.init_state(cfg, device=dev)
                                for _ in range(B)])


def check_flagship(dev):
    from mmloam_tpu_torch import replay
    from mmloam_tpu_torch.config import LIOConfig
    from mmloam_tpu_torch.ops import assoc, map_insert, voxelmap

    cfg = LIOConfig()
    B, T = FLAGSHIP_B, FLAGSHIP_T
    scans, gts = flagship_inputs(cfg, B, T, 7, dev)
    states = fresh_states(cfg, B, dev)
    torch.cuda.synchronize()

    map_insert.LAUNCHES = 0
    assoc.LAUNCHES = assoc.CALLS = 0
    t0 = time.perf_counter()
    st, outs = replay.replay_batch(states, scans, cfg)
    torch.cuda.synchronize()
    first_secs = time.perf_counter() - t0
    launches = map_insert.LAUNCHES
    k2_launches = _check_k2_counts("replay_batch")

    inited = outs.inited.cpu().numpy()
    pose = outs.pose_p.cpu().numpy()
    ts = outs.t.cpu().numpy()
    n_cells = cfg.map.dim_x * cfg.map.dim_y * cfg.map.dim_z
    lanes = []
    for b in range(B):
        ate = _ate(pose[:, b], ts[:, b], *gts[b])
        occ = int((voxelmap.VoxelMap(st.vm_surf.cells[b]).count > 0)
                  .sum())
        lanes.append(dict(ate=ate, surf_cells=occ,
                          inited_at=int(np.argmax(inited[:, b]))))
        log(f"  lane {b}: inited at scan {lanes[-1]['inited_at']}, ATE "
            f"{ate:.4f} m, surf cells {occ}")
        if not inited[-1, b]:
            raise AssertionError(f"lane {b} never initialized")
        if not ate < ATE_MAX:
            raise AssertionError(f"lane {b} ATE {ate} >= {ATE_MAX}")
        if not 500 < occ < n_cells // 4:
            raise AssertionError(f"lane {b} surf occupancy {occ}")
    if not np.isfinite(pose).all():
        raise AssertionError("non-finite poses")
    if launches != 4 * T:
        raise AssertionError(f"K1 launched {launches} times, want {4 * T}")
    log(f"  replay_batch B={B} T={T}: K1 launches {launches}, first run "
        f"{first_secs:.1f} s")

    lane0 = _lane0(st)
    st = outs = states = None
    states = fresh_states(cfg, B, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    replay.replay_batch(states, scans, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rate = B * T / secs
    log(f"  timed run: {secs:.2f} s, {rate:.3f} scans/sec")
    return dict(B=B, T=T, launches=launches, k2_launches=k2_launches,
                first_secs=first_secs, timed_secs=secs, scans_per_sec=rate,
                lanes=lanes), lane0


def _lane0(st):
    """Lane 0's maps, window poses and stacks (copies)."""
    keep = ("vm_corner", "vm_surf", "vm_local_corner", "vm_local_surf")
    out = {f: getattr(st, f).cells[0].clone() for f in keep}
    out.update(x=st.x[0].clone(), Rbl=st.Rbl[0].clone(),
               tbl=st.tbl[0].clone(), stacks=type(st.stacks)(
                   *(None if a is None else a[0].clone() for a in st.stacks)))
    return out


# --------------------------------------------------------------------------
# phase 5: K2 against its plain version at flagship shapes
# --------------------------------------------------------------------------

def _assoc_cases(lane0, cfg):
    """(label, vm, pw, mask, mcfg, mode, scatter_ratio, moved pw) at the
    main path's shapes: the newest frame's stacks against the persistent
    map, their compacted rescue queries against the local map."""
    from mmloam_tpu_torch.estimator import factors
    from mmloam_tpu_torch.ops import assoc, voxelmap

    W = cfg.solver.window
    x6 = lane0["x"][W - 1, :6]
    st = lane0["stacks"]
    cases = []
    for feat, mode, vm_f, vml_f in (
            ("corner", assoc.LINE, "vm_corner", "vm_local_corner"),
            ("surf", assoc.PLANE, "vm_surf", "vm_local_surf")):
        pts = getattr(st, feat)[W - 1]
        mask = getattr(st, feat + "_mask")[W - 1]
        world = lambda x: factors._world_points(x, pts, lane0["Rbl"],
                                                lane0["tbl"])
        pw, moved = world(x6), world(x6 + 3e-3)
        sr = cfg.solver.plane_scatter_ratio if mode == assoc.PLANE else 0.0
        vm = voxelmap.VoxelMap(lane0[vm_f])
        r, _ = assoc.associate_reference(vm, pw, mask, cfg.map,
                                         cfg.map.knn, mode,
                                         cfg.solver.thres_dist, sr)
        M = pw.shape[0]
        sel = factors._compact_indices(
            mask & ~r.valid, factors._rescue_cap(M,
                                                 cfg.solver.local_rescue_frac))
        pw_r, moved_r = factors._take_fill(pw, sel), factors._take_fill(moved,
                                                                        sel)
        cases.append((f"{feat} persistent", vm, pw, mask, cfg.map, mode, sr,
                      moved))
        cases.append((f"{feat} local", voxelmap.VoxelMap(lane0[vml_f]), pw_r,
                      sel < M, cfg.local_map, mode, sr, moved_r))
    return cases


def time_stages(dev, cargs):
    """Each stage's launch alone (fresh entry) against the same cut of the
    plain version, CUDA events, median of 20."""
    from mmloam_tpu_torch.ops import assoc

    out = {}
    for stage, sname in enumerate(assoc.STAGE_NAMES):
        a, bufs = assoc.prepare(stage, *cargs, None, False)
        ms = cuda_ms(lambda: assoc.launch(stage, a, dev))
        plain_ms = cuda_ms(lambda: assoc.stage_reference(stage, *cargs))
        bufs = None
        out[sname] = dict(ms=ms, plain_ms=plain_ms)
        log(f"    stage {sname:8s} kernel {ms:.4f} ms, plain cut "
            f"{plain_ms:.4f} ms")
    return out


def check_assoc(dev, lane0, cfg):
    from mmloam_tpu_torch.ops import assoc

    k = cfg.map.knn
    thres = torch.tensor(cfg.solver.thres_dist, device=dev)
    max_err, near, timing = 0.0, 0, {}
    for label, vm, pw, mask, mcfg0, mode, sr, moved in _assoc_cases(lane0,
                                                                    cfg):
        for bf16 in (True, False):
            # the plane fit also without the scatter gate (faithful_config)
            for ratio in ([sr, 0.0] if bf16 and sr > 0 else [sr]):
                mcfg = dataclasses.replace(mcfg0, dense_bf16=bf16)
                args = (vm, pw, mask, mcfg, k, mode, thres, ratio)
                _, blocks = assoc.associate_reference(*args)
                for entry, cached, q in (("fresh", None, pw),
                                         ("cached", blocks, moved)):
                    cargs = (vm, q) + args[2:]
                    errs, n_near = [], 0
                    for stage in range(len(assoc.STAGE_NAMES)):
                        if stage == assoc.GATHER and cached is not None:
                            continue
                        got = assoc.run_stage(stage, *cargs, cached=cached)
                        ref = assoc.stage_reference(stage, *cargs,
                                                    cached=cached)
                        torch.cuda.synchronize()
                        st = assoc.compare(stage, got, ref, mask, mode)
                        errs.append(st["max_abs_err"])
                        n_near = max(n_near, st["near"])
                    want = cached is None and "persistent" in label
                    # the kernel alone, the whole entry (with the torch
                    # stencil addressing), and the plain version
                    a, bufs = assoc.prepare(assoc.OUT, *cargs, cached,
                                            want)
                    ms = cuda_ms(lambda: assoc.launch(assoc.OUT, a, dev))
                    bufs = None
                    entry_ms = cuda_ms(lambda: assoc.associate(
                        *cargs, cached=cached, want_blocks=want))
                    plain_ms = cuda_ms(lambda: assoc.associate_reference(
                        *cargs, cached=cached))
                    r, _ = assoc.associate_reference(*cargs, cached=cached)
                    n_valid = int(r.valid.sum())
                    name = (f"{label} {entry} bf16={int(bf16)}"
                            f" scatter={ratio:g}")
                    timing[name] = dict(M=int(pw.shape[0]), ms=ms,
                                        entry_ms=entry_ms, plain_ms=plain_ms,
                                        valid=n_valid, near=n_near,
                                        max_abs_err=max(errs))
                    log(f"  K2 {name:42s} M={pw.shape[0]:4d}: all stages "
                        f"agree, max err {max(errs):.3g}, {n_near} near a "
                        f"gate, {n_valid} valid; kernel {ms:.4f} ms, entry "
                        f"{entry_ms:.4f} ms, plain {plain_ms:.4f} ms")
                    if name == K2_TIMED_CASE:
                        timing[name]["stages"] = time_stages(dev, cargs)
                    max_err = max(max_err, max(errs))
                    near += n_near
    return max_err, near, timing


# --------------------------------------------------------------------------
# phase 6: faithful_config hall replay
# --------------------------------------------------------------------------

def check_faithful(dev):
    from mmloam_tpu_torch import pipeline, replay
    from mmloam_tpu_torch.config import faithful_config, tiny_config
    from mmloam_tpu_torch.data import synthetic
    from mmloam_tpu_torch.ops import assoc

    cfg = faithful_config(tiny_config())
    scans, gt_R, gt_p = replay.make_sequence(
        synthetic.default_world(), synthetic.Trajectory(speed=0.8), 0.0, 25,
        cfg, n_az=360, dtype=np.float32, device=dev)
    assoc.LAUNCHES = assoc.CALLS = 0
    t0 = time.perf_counter()
    _, outs = replay.replay(pipeline.init_state(cfg, device=dev), scans, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    pose = outs.pose_p.cpu().numpy()
    inited = outs.inited.cpu().numpy()
    ate = _ate(pose, outs.t.cpu().numpy(), gt_R, gt_p)
    log(f"  faithful hall_25: inited at scan {int(np.argmax(inited))}, ATE "
        f"{ate:.4f} m, {secs:.1f} s")
    launches = _check_k2_counts("faithful hall")
    if not (inited[-1] and np.isfinite(pose).all() and ate < FAITHFUL_ATE_MAX):
        raise AssertionError("faithful replay outside its bounds")
    return dict(ate=ate, launches=launches, secs=secs)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from mmloam_tpu_torch import cuda_build

    log("phase 1: build K1 and K2")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:
        futs = {src: ex.submit(cuda_build.build, src)
                for src in KERNEL_SOURCES}
        for src, fut in futs.items():
            log(f"  built {fut.result()}")
    for src in KERNEL_SOURCES:
        cuda_build.load(src)
    log(f"  both built in {time.perf_counter() - t0:.1f} s")

    log("phase 2: K1 against its plain version")
    max_err, k1_timing = check_map_insert(dev)

    log("phase 3: tiny hall replay against tests/golden/hall_25.npz")
    check_hall_golden(dev)

    log("phase 4: flagship replay_batch")
    flag, lane0 = check_flagship(dev)

    log("phase 5: K2 against its plain version at flagship shapes")
    from mmloam_tpu_torch.config import LIOConfig

    k2_err, k2_near, k2_timing = check_assoc(dev, lane0, LIOConfig())
    log(f"  {k2_near} query results excused near a gate threshold in all")
    lane0 = None

    log("phase 6: faithful_config hall replay")
    check_faithful(dev)

    t = k1_timing["persistent"]
    t2 = k2_timing[K2_TIMED_CASE]
    kernels = {"kernels": [
        {"name": "map_insert_rmw", "route": "cuda",
         "source": "mmloam_tpu_torch/csrc/map_insert.cu",
         "replaces": "mmloam_tpu/ops/pallas_insert.py:108",
         "launches": flag["launches"], "max_abs_err": max_err,
         "ms": t["ms"], "plain_ms": t["plain_ms"]},
        {"name": "assoc", "route": "cuda",
         "source": "mmloam_tpu_torch/csrc/assoc.cu",
         "replaces": "scripts/pallas_assoc.py:388",
         "launches": flag["k2_launches"], "max_abs_err": k2_err,
         "ms": t2["ms"], "plain_ms": t2["plain_ms"]}]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
