"""Trajectory metrics & run telemetry (an unchanged copy of
mmloam_tpu/metrics.py; numpy only, so callers pass host arrays).

Replaces the reference's observability surface (SURVEY.md §5.5: ROS topics,
per-stage running-average latency prints, feature-count telemetry) with
explicit post-run metrics over the replay outputs:

* ATE (absolute trajectory error) RMSE/mean/max after first-pose alignment,
* RPE (relative pose error) over a configurable frame delta,
* per-run telemetry: init latency, failure/degenerate rates, feature-count
  averages (the reference's feature_num[] prints,
  unionPoseEstimation.cpp:691-705).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class TrajectoryMetrics(NamedTuple):
    ate_rmse: float
    ate_mean: float
    ate_max: float
    rpe_rmse: float
    n_poses: int


def _stamp_match(est_t, gt_t):
    """Index of the closest ground-truth stamp for each estimate."""
    return np.abs(est_t[:, None] - gt_t[None, :]).argmin(axis=1)


def ate(est_p, est_t, gt_p, gt_R, gt_t, rpe_delta=10):
    """Stamp-matched ATE/RPE with first-pose alignment.

    est_p (N,3), est_t (N,): published poses/stamps (repeat stamps during
    warmup are fine — later publications of a stamp overwrite earlier).
    gt_p (M,3), gt_R (M,3,3), gt_t (M,): ground truth in the world frame.
    """
    est_p = np.asarray(est_p, np.float64)
    est_t = np.asarray(est_t, np.float64)
    idx = _stamp_match(est_t, np.asarray(gt_t, np.float64))
    # ground truth expressed in the first matched pose's frame
    R0 = gt_R[idx[0]]
    p0 = gt_p[idx[0]]
    gt_rel = (gt_p[idx] - p0) @ R0
    err = est_p - est_p[0] - gt_rel
    d = np.linalg.norm(err, axis=1)

    k = min(rpe_delta, len(est_p) - 1)
    if k > 0:
        rel_est = est_p[k:] - est_p[:-k]
        rel_gt = gt_rel[k:] - gt_rel[:-k]
        rpe = np.sqrt(((rel_est - rel_gt) ** 2).sum(1).mean())
    else:
        rpe = float("nan")
    return TrajectoryMetrics(
        ate_rmse=float(np.sqrt((d ** 2).mean())), ate_mean=float(d.mean()),
        ate_max=float(d.max()), rpe_rmse=float(rpe), n_poses=len(est_p))


def run_telemetry(outs):
    """Aggregate a replay's StepOutput pytree into run statistics."""
    inited = np.asarray(outs.inited)
    fail = np.asarray(outs.fail)
    deg = np.asarray(outs.degenerate)
    first_init = int(np.argmax(inited)) if inited.any() else -1
    return {
        "n_scans": int(len(fail)),
        "init_scan": first_init,
        "fail_rate": float(fail.mean()),
        "degenerate_rate": float(deg.mean()),
        "avg_corner": float(np.asarray(outs.n_corner).mean()),
        "avg_surf": float(np.asarray(outs.n_surf).mean()),
        "min_sv": float(np.asarray(outs.sv_min)[inited].min()) if inited.any()
                  else float("nan"),
    }
