"""Per-point motion undistortion (port of mmloam_tpu/ops/undistort.py).

    s       = per-point relative time in [0, 1]
    q_s     = slerp(I, dq_lc, s)
    start_p = q_s * p + s * dt_lc          (point in the scan-start frame)
    p'      = dR_lc^T (start_p - dt_lc)    (re-expressed in scan-end frame)
"""

from __future__ import annotations

from .. import lie


def undistort(points, rel_time, dq_lc, dt_lc):
    """De-skew `points (..., N, 3)` with per-point `rel_time (..., N)` in
    [0, 1] by the deltas dq_lc (..., 4), dt_lc (..., 3); leading axes (the
    lanes of a batch) broadcast."""
    dq, dt = dq_lc[..., None, :], dt_lc[..., None, :]
    q_s = lie.slerp_identity(dq, rel_time)
    start_p = lie.quat_rotate(q_s, points) + rel_time[..., None] * dt
    q_inv = lie.quat_conj(dq)
    return lie.quat_rotate(q_inv, start_p - dt)


def undistort_inverse(points, rel_time, dq_lc, dt_lc):
    """Exact inverse of `undistort`."""
    dq, dt = dq_lc[..., None, :], dt_lc[..., None, :]
    start_p = lie.quat_rotate(dq, points) + dt
    q_s = lie.slerp_identity(dq, rel_time)
    return lie.quat_rotate(lie.quat_conj(q_s),
                           start_p - rel_time[..., None] * dt)


def reundistort(points, rel_time, dq_old, dt_old, dq_new, dt_new):
    """Re-deskew points undistorted with (dq_old, dt_old) using the refined
    delta (dq_new, dt_new) (see the reference's docstring)."""
    raw = undistort_inverse(points, rel_time, dq_old, dt_old)
    return undistort(raw, rel_time, dq_new, dt_new)
