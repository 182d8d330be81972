"""Smoke run of the PyTorch/CUDA port (mmloam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):

0. device check: a CUDA device is required; the card's name and power
   limit are printed as nvidia-smi reports them;
1. build the hand-written CUDA kernel K1 (csrc/map_insert.cu) with nvcc;
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
   bounds tests/test_torch_pipeline.py states and justifies);
4. the main path: `replay_batch` at `LIOConfig()` with B=4 lanes and T=16
   scans of 16x1024 VLP-16 + 6x2048 Horizon input, every lane initialized,
   finite poses, ATE < 0.15 m per lane, surf-map occupancy in
   (500, n_cells/4), and K1 launched exactly 4*T times; then a second,
   timed run for scans/sec.

Before the last line come a JSON object with each kernel's launches,
error and times, and the card's name and power limit; the last line is
{"ok": true, "device": {...}}.
"""

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
    import dataclasses

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


def check_hall_golden(dev):
    from mmloam_tpu_torch import pipeline, replay
    from mmloam_tpu_torch.config import tiny_config
    from mmloam_tpu_torch.data import synthetic

    cfg = tiny_config()
    scans, gt_R, gt_p = replay.make_sequence(
        synthetic.default_world(), synthetic.Trajectory(speed=0.8, z_amp=0.15),
        0.0, 25, cfg, n_az=360, dtype=np.float32, device=dev)
    g = np.load(os.path.join(ROOT, "tests", "golden", "hall_25.npz"))
    t0 = time.perf_counter()
    _, outs = replay.replay(pipeline.init_state(cfg, device=dev), scans, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
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
    from mmloam_tpu_torch.ops import map_insert, voxelmap

    cfg = LIOConfig()
    B, T = FLAGSHIP_B, FLAGSHIP_T
    scans, gts = flagship_inputs(cfg, B, T, 7, dev)
    states = fresh_states(cfg, B, dev)
    torch.cuda.synchronize()

    map_insert.LAUNCHES = 0
    t0 = time.perf_counter()
    st, outs = replay.replay_batch(states, scans, cfg)
    torch.cuda.synchronize()
    first_secs = time.perf_counter() - t0
    launches = map_insert.LAUNCHES

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

    st = outs = states = None
    states = fresh_states(cfg, B, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    replay.replay_batch(states, scans, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rate = B * T / secs
    log(f"  timed run: {secs:.2f} s, {rate:.3f} scans/sec")
    return dict(B=B, T=T, launches=launches, first_secs=first_secs,
                timed_secs=secs, scans_per_sec=rate, lanes=lanes)


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

    log("phase 1: build K1")
    t0 = time.perf_counter()
    cuda_build.load("map_insert.cu")
    build_secs = time.perf_counter() - t0
    log(f"  built {cuda_build.library_path('map_insert.cu')} in "
        f"{build_secs:.1f} s")

    log("phase 2: K1 against its plain version")
    max_err, k1_timing = check_map_insert(dev)

    log("phase 3: tiny hall replay against tests/golden/hall_25.npz")
    check_hall_golden(dev)

    log("phase 4: flagship replay_batch")
    flag = check_flagship(dev)

    t = k1_timing["persistent"]
    kernels = {"kernels": [{
        "name": "map_insert_rmw", "route": "cuda",
        "source": "mmloam_tpu_torch/csrc/map_insert.cu",
        "replaces": "mmloam_tpu/ops/pallas_insert.py:108",
        "launches": flag["launches"], "max_abs_err": max_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"]}]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
