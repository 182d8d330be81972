"""Street-scale drive through the PyTorch/CUDA port (mmloam_tpu_torch) at
the flagship config: the reference's scripts/street_drive.py.

500 scans down a ~140 m canyon (`synthetic.street_world()`) at
`LIOConfig()`: the flagship 256-cell 0.4 m torus (102.4 m period) wraps
during the drive, exercising K1's epoch-key eviction at scale; ATE is
evaluated against the analytic trajectory.  The world, trajectory and
noise are the reference's.  One sequence replays through `replay.replay`
(the one-lane step, a CUDA graph with IF nodes); a batch of B copies
through `replay.replay_batch` (the lockstep step).

    python3 street_drive_torch.py [n_scans=500] [batch=1] [--golden]

Runs on the card (the port's entry points default to it; without one it
exits).  Prints the reference script's line (distance, torus periods, ATE,
scans/s including scan 0 and the graph's capture: a one-shot run) and the
card's name and power limit, and asserts finite poses, the reference's
only check.  The inputs are `make_flagship_golden.build`'s ``street`` run
(scripts/make_flagship_golden.py), the reference script's own.

With --golden the run (lane 0 of a batch) is also held against the
reference's street run in tests/golden/flagship_lio.npz under
`make_flagship_golden.compare`'s bounds: it prints each scan's pose
difference, the first scan over the bound, the largest difference, and
the reference's ATE beside the port's (over the first n_scans), and
fails where a bound is left.
"""

import os
import sys
import time

import numpy as np
import torch


def main(n_scans=500, batch=1, golden=False):
    from chip_smoke import card_line, golden_module
    from mmloam_tpu_torch import pipeline, replay
    from mmloam_tpu_torch.config import LIOConfig
    from mmloam_tpu_torch.data import synthetic

    fg = golden_module()
    cfg = LIOConfig()
    print(f"building {n_scans} scans ...", flush=True)
    t0 = time.perf_counter()
    np_scans, gts = fg.build("street", replay.make_sequence, synthetic, cfg,
                             n_scans=n_scans)
    gt_R, gt_p = gts[0]
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = pipeline.resolve_device()
    if batch > 1:
        scans = pipeline.scan_from_numpy(replay.stack_sequences(
            [np_scans] * batch), dev)
        state = replay.stack_states([pipeline.init_state(cfg, device=dev)
                                     for _ in range(batch)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, outs = replay.replay_batch(state, scans, cfg)
        torch.cuda.synchronize()
        outs = type(outs)(*(None if a is None else a[:, 0] for a in outs))
        final = None
    else:
        scans = pipeline.scan_from_numpy(np_scans, dev)
        state = pipeline.init_state(cfg, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, outs = replay.replay(state, scans, cfg)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    p = outs.pose_p.cpu().numpy()
    ts = outs.t.cpu().numpy()
    gt_rel = np.einsum("ij,nj->ni", gt_R[0].T, gt_p - gt_p[0])
    rmse = fg.ate(p, ts, gt_R, gt_p)
    dist = float(np.linalg.norm(np.diff(gt_rel, axis=0), axis=1).sum())
    print(f"street drive: {n_scans} scans, {dist:.0f} m travelled "
          f"({dist / 102.4:.1f} torus periods), ATE RMSE {rmse:.3f} m "
          f"({100 * rmse / max(dist, 1e-9):.2f}% of distance), "
          f"{batch * n_scans / dt:.1f} scans/s "
          f"(incl. scan 0 and the capture: one-shot run)", flush=True)
    print(card_line(), flush=True)
    assert np.isfinite(p).all()
    if golden:
        hold(fg, outs, final if n_scans == fg.RUNS["street"][3] else None,
             np_scans, gts, n_scans, rmse)


def hold(fg, outs, final, np_scans, gts, n, rmse):
    """The run against the golden's street run (see the docstring)."""
    to_np = lambda a: a.cpu().numpy()
    want = fg.load()["street"]
    got = fg.result(outs, final, np_scans, gts, to_np)
    bad, seen = fg.compare(want, got, n=n)
    d = np.abs(got["pose_p"] - want["pose_p"][:n]).max(axis=1)
    print("per-scan |pose_p - golden| (m): "
          + " ".join(f"{x:.4g}" for x in d), flush=True)
    ref_ate = fg.ate(want["pose_p"][:n], want["t"][:n], *gts[0])
    print(f"against the golden: largest pose difference {d.max():.4g} m "
          f"at scan {int(d.argmax())} (bound {seen['pose_p_bound']:.4g} m "
          f"from scan {seen['pose_p_horizon']}, 0.01 m before), first scan "
          f"over 0.01 m: "
          f"{int(np.argmax(d > 0.01)) if (d > 0.01).any() else None}, "
          f"first over its bound: {seen['pose_p_first_over']}; ATE over "
          f"{n} scans: the reference {ref_ate:.4f} m, the port {rmse:.4f} "
          f"m; {bad or 'every bound held'}", flush=True)
    assert not bad, bad


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("street_drive_torch: needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    args = [a for a in sys.argv[1:] if a != "--golden"]
    main(int(args[0]) if len(args) > 0 else 500,
         int(args[1]) if len(args) > 1 else 1, "--golden" in sys.argv)
