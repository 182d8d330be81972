"""Street-scale drive through the PyTorch/CUDA port (mmloam_tpu_torch) at
the flagship config: the reference's scripts/street_drive.py.

500 scans down a ~140 m canyon (`synthetic.street_world()`) at
`LIOConfig()`: the flagship 256-cell 0.4 m torus (102.4 m period) wraps
during the drive, exercising K1's epoch-key eviction at scale; ATE is
evaluated against the analytic trajectory.  The world, trajectory and
noise are the reference's.  One sequence replays through `replay.replay`
(the one-lane step, a CUDA graph with IF nodes); a batch of B copies
through `replay.replay_batch` (the lockstep step).

    python3 street_drive_torch.py [n_scans=500] [batch=1]

Runs on the card (the port's entry points default to it; without one it
exits).  Prints the reference script's line (distance, torus periods, ATE,
scans/s including scan 0 and the graph's capture: a one-shot run) and the
card's name and power limit, and asserts finite poses, the reference's
only check.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch


def card_line():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main(n_scans=500, batch=1):
    from mmloam_tpu_torch import pipeline, replay
    from mmloam_tpu_torch.config import LIOConfig
    from mmloam_tpu_torch.data import synthetic

    cfg = LIOConfig()
    world = synthetic.street_world()
    # near-straight drive down the canyon: x swings +-100 m inside the
    # 250 m box, ~2.8 m/s -> ~140 m of travel over 50 s (500 scans)
    traj = synthetic.Trajectory(speed=2.8, radius_x=100.0, radius_y=3.0,
                                yaw_rate=0.05, z_amp=0.1)
    print(f"building {n_scans} scans ...", flush=True)
    t0 = time.perf_counter()
    scans, gt_R, gt_p = replay.make_sequence(
        world, traj, t0=0.0, n_scans=n_scans, cfg=cfg,
        n_az=cfg.scan.max_pts_per_line, range_noise=0.004,
        dtype=np.float32)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = pipeline.resolve_device()
    if batch > 1:
        scans = pipeline.scan_from_numpy(replay.stack_sequences(
            [scans] * batch), dev)
        state = replay.stack_states([pipeline.init_state(cfg, device=dev)
                                     for _ in range(batch)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, outs = replay.replay_batch(state, scans, cfg)
        torch.cuda.synchronize()
        p = outs.pose_p[:, 0].cpu().numpy()
        ts = outs.t[:, 0].cpu().numpy()
    else:
        scans = pipeline.scan_from_numpy(scans, dev)
        state = pipeline.init_state(cfg, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, outs = replay.replay(state, scans, cfg)
        torch.cuda.synchronize()
        p = outs.pose_p.cpu().numpy()
        ts = outs.t.cpu().numpy()
    dt = time.perf_counter() - t0
    gt_rel = np.einsum("ij,nj->ni", gt_R[0].T, gt_p - gt_p[0])
    err = np.stack([p[i] - gt_rel[int(round(float(ts[i]) / 0.1)) - 1]
                    for i in range(len(p))])
    rmse = float(np.sqrt((err ** 2).sum(1).mean()))
    dist = float(np.linalg.norm(np.diff(gt_rel, axis=0), axis=1).sum())
    print(f"street drive: {n_scans} scans, {dist:.0f} m travelled "
          f"({dist / 102.4:.1f} torus periods), ATE RMSE {rmse:.3f} m "
          f"({100 * rmse / max(dist, 1e-9):.2f}% of distance), "
          f"{batch * n_scans / dt:.1f} scans/s "
          f"(incl. scan 0 and the capture: one-shot run)", flush=True)
    print(card_line(), flush=True)
    assert np.isfinite(p).all()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("street_drive_torch: needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 500,
         int(sys.argv[2]) if len(sys.argv) > 2 else 1)
