"""`imu_mode` 0 (no IMU) and 1 (gyro only) in the port against the JAX
reference.  Both modes never initialize, so every step is the pre-init
single-frame scan matching; mode 0 predicts the rotation from the previous
body delta (`state.dqb`) instead of the integrated gyro.

* One teacher-forced `step_core` (+ `apply_inserts`) from the reference's
  state at scans 4, 5 and 10, with `torch_teacher`'s bounds (those of
  test_torch_pipeline.py): discrete outputs exactly, poses within 1e-5 m,
  map sums within 1e-5 with meta lanes exact; the keyframe bookkeeping is
  never entered (kf_count stays 0).  Scans 1-10 of both modes were all
  checked once: 19 of the 20 steps match exactly, and at scan 5 of mode 0
  one of 893 plane associations flips at a gate for a 2e-6 m difference
  of the LM iterate (the pose stays within 2e-6 m).  That one step is
  held with a stated allowance (STEP_ALLOWANCE): n_assoc_plane within 1,
  its pose within ALLOWANCE_POSE_ATOL, everything else as every step.
* The port's `replay` over the same 11 scans against the reference's
  per-scan steps: inited (never), fail and hori_merged exactly, n_corner
  within 1, poses within REPLAY_POSE_ATOL, as test_torch_modes.py.
* Mode 0's prediction differs from mode 1's on the same state, and both
  trajectories track: the ATE bounds of tests/test_imu_modes.py (mode 1
  0.6 m, mode 0 0.8 m).
"""

import dataclasses
import functools

import numpy as np
import torch

torch.set_num_threads(1)

import pytest  # noqa: E402

from mmloam_tpu.config import tiny_config as jax_tiny_config  # noqa: E402

from mmloam_tpu_torch import pipeline as tp  # noqa: E402
from mmloam_tpu_torch import replay as tr  # noqa: E402
from mmloam_tpu_torch.config import tiny_config  # noqa: E402

import torch_teacher as tt  # noqa: E402

_T = tiny_config()
_J = jax_tiny_config()
CFG_H = _T.replace(solver=dataclasses.replace(_T.solver,
                                              corner_cnt_gate_hori=5))
JCFG_H = _J.replace(solver=dataclasses.replace(_J.solver,
                                               corner_cnt_gate_hori=5))
N_SCANS = 11
REPLAY_POSE_ATOL = 5e-3
ATE_MAX = {0: 0.8, 1: 0.6}
# (mode, scan) -> the counts allowed to differ, and by how much: at scan 5
# of mode 0 one plane association flips at a gate (see above); that step's
# pose is held to ALLOWANCE_POSE_ATOL, tighter than torch_teacher's 1e-5 m
STEP_ALLOWANCE = {(0, 5): {"n_assoc_plane": 1}}
ALLOWANCE_POSE_ATOL = 5e-6


def _cfgs(mode):
    return CFG_H.replace(imu_mode=mode), JCFG_H.replace(imu_mode=mode)


@functools.lru_cache(maxsize=None)
def _record(mode):
    return tt.teacher_record(_cfgs(mode)[1], N_SCANS, (4, 5, 10),
                             with_hori=True, hori_n_az=240)


@pytest.mark.parametrize("t", [4, 5, 10])
@pytest.mark.parametrize("mode", [0, 1])
def test_teacher_forced_imu_mode_step_matches_jax(mode, t):
    rec = _record(mode)[0][t]
    allow = STEP_ALLOWANCE.get((mode, t))
    s1, out = tt.check_teacher_step(rec, False, _cfgs(mode)[0],
                                    count_slack=allow)
    assert not bool(out.inited)
    assert int(s1.kf_count) == 0
    if allow:
        # the flipped association moves the pose by no more than this
        for name in ("pose_p", "pose_q"):
            np.testing.assert_allclose(tt.np_(getattr(out, name)),
                                       getattr(rec["core"][1], name),
                                       atol=ALLOWANCE_POSE_ATOL,
                                       err_msg=name)


@pytest.mark.parametrize("mode", [0, 1])
def test_imu_mode_replay_matches_jax(mode):
    _, oj, (scans, gt_R, gt_p) = _record(mode)
    cfg = _cfgs(mode)[0]
    _, ot = tr.replay(tp.init_state(cfg, device="cpu"),
                      tp.scan_from_numpy(scans, device="cpu"), cfg)
    for name in ("inited", "fail", "hori_merged"):
        np.testing.assert_array_equal(tt.np_(getattr(ot, name)),
                                      getattr(oj, name), err_msg=name)
    assert not oj.inited.any()
    assert np.abs(tt.np_(ot.n_corner) - oj.n_corner).max() <= 1
    pose = tt.np_(ot.pose_p)
    assert np.isfinite(pose).all()
    np.testing.assert_allclose(pose, oj.pose_p, atol=REPLAY_POSE_ATOL)
    ate, _ = tr.ate_rmse(tt.np_(ot.pose_q), pose, gt_R, gt_p)
    assert ate < ATE_MAX[mode], ate


def test_no_imu_mode_predicts_from_the_previous_delta():
    """From the same state and scan, mode 0's predicted rotation is the
    previous body delta applied, mode 1's the integrated gyro."""
    rec = _record(1)[0][4]
    st = tp.state_from_numpy(rec["state"], device="cpu")
    scan = tp.scan_from_numpy(rec["scan"], device="cpu")
    from mmloam_tpu_torch import lie

    q_prev = lie.exp_quat(st.x[-1, 3:6])
    preds = {}
    for mode in (0, 1):
        pf = tp.prepare_frame(st, scan, _cfgs(mode)[0])
        preds[mode] = pf.x_w[-1, 3:6]
    q0 = lie.quat_normalize(lie.quat_mul(q_prev, st.dqb))
    torch.testing.assert_close(lie.exp_quat(preds[0]), q0, atol=1e-6,
                               rtol=0)
    assert float(torch.linalg.vector_norm(preds[0] - preds[1])) > 1e-6
