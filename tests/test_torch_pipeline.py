"""Port pipeline and replay drivers against the JAX reference.

* `init_state` equals the reference leaf by leaf.
* One teacher-forced `step_core` (+ `apply_inserts`) from a JAX state,
  handed over through `state_from_numpy`, before and after IMU init:
  window x, prior validity and anchor, maps, pending insert and
  StepOutput.  Discrete outputs
  (flags, counts) exactly; poses within 1e-5 m; map sums within 1e-5 with
  meta lanes exact.  The hall scans here carry 3 mm range noise.
* `replay_batch` at B=2 over 12 scans with Horizon (merge gate lowered so
  the fused path runs) against the reference's `replay_batch` on CPU:
  inited/fail/hori_merged exactly, n_corner within 1, pose_p within
  5e-3 m.  The port rounds the feature curvature as XLA:CPU's fused code
  does in `replay` (ops/features._fma), but inside the vmapped scan of
  `replay_batch` XLA fuses it differently: two surf picks of lane 1 differ
  at scan 5, and n_corner moves by one at scans 10-11 (ROADMAP queue 3).
* The 25-scan `replay` against tests/golden/hall_25.npz: inited, fail, t
  and n_corner exactly; the ATE against ground truth within 0.01 m of the
  golden's.  The pose bound is 0.01 m, not the 5e-3 m the reference allows
  itself on a foreign backend.  Each step agrees with the reference to
  ~1e-5 m from the same state (the LM stops at its tolerance, and the
  iterates differ in the last bits), and on this noise-free sequence such
  a difference flips a plane association at scan 5 and a few voxel
  boundaries of map inserts at scans 6-7, which the chained solves carry
  to 7.3e-3 m at scan 17 (CPU).  ROADMAP queue 3 records it.
* `import mmloam_tpu_torch` leaves jax out of sys.modules.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from mmloam_tpu import pipeline as jp  # noqa: E402
from mmloam_tpu import replay as jr  # noqa: E402
from mmloam_tpu.config import tiny_config as jax_tiny_config  # noqa: E402
from mmloam_tpu.data import synthetic as jsyn  # noqa: E402

from mmloam_tpu_torch import pipeline as tp  # noqa: E402
from mmloam_tpu_torch import replay as tr  # noqa: E402
from mmloam_tpu_torch.config import tiny_config  # noqa: E402
from mmloam_tpu_torch.tree import tree_map  # noqa: E402

CFG = tiny_config()
JCFG = jax_tiny_config()
# the synthetic hall yields few Horizon corners: the batch test lowers the
# merge gate (as tests/test_hori_fusion.py does) so the fused path runs
CFG_H = CFG.replace(solver=dataclasses.replace(CFG.solver,
                                               corner_cnt_gate_hori=5))
JCFG_H = JCFG.replace(solver=dataclasses.replace(JCFG.solver,
                                                 corner_cnt_gate_hori=5))
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "hall_25.npz")
POSE_ATOL = 1e-5
SUM_ATOL = 1e-5
BATCH_POSE_ATOL = 5e-3
GOLDEN_POSE_ATOL = 0.01
GOLDEN_ATE_SLACK = 0.01


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _hall(n_scans, range_noise, seed=0, **kw):
    return jr.make_sequence(jsyn.default_world(),
                            jsyn.Trajectory(speed=0.8, z_amp=0.15), 0.0,
                            n_scans, JCFG, n_az=360, dtype=np.float32,
                            range_noise=range_noise, seed=seed,
                            to_device=False, **kw)


def _ate(pose_p, t, gt_R, gt_p):
    gt_rel = np.einsum("ij,nj->ni", gt_R[0].T, gt_p - gt_p[0])
    idx = np.rint(np.asarray(t, np.float64) / 0.1).astype(int) - 1
    return float(np.sqrt(((pose_p - gt_rel[idx]) ** 2).sum(1).mean()))


def test_init_state_matches_jax():
    sj = jax.tree.map(np.asarray, jp.init_state(JCFG))
    st = tp.init_state(CFG)
    assert type(st).__name__ == type(sj).__name__
    assert st._fields == sj._fields
    for name in sj._fields:
        a, b = getattr(sj, name), getattr(st, name)
        la = jax.tree.leaves(a)
        lb = [x for x in jax.tree.leaves(tree_map(_np, b))]
        assert len(la) == len(lb), name
        for x, y in zip(la, lb):
            assert x.shape == y.shape, name
            np.testing.assert_array_equal(y, x.astype(y.dtype), err_msg=name)


@functools.lru_cache(maxsize=None)
def _teacher_record():
    """JAX step_core + apply_inserts over hall scans 0..10 (3 mm range
    noise): the pre-step states at scans 5 (pre-init) and 10 (post-init)
    and what the reference makes of that scan."""
    scans, _, _ = _hall(11, 0.003, seed=1)

    @jax.jit
    def parts(s, sc):
        s1, out, pend = jp.step_core(s, sc, JCFG)
        return s1, out, pend, jp.apply_inserts(s1, pend, JCFG)

    st = jp.init_state(JCFG)
    rec = {}
    for t in range(11):
        sc = jax.tree.map(lambda a: jnp.asarray(a[t]), scans)
        s1, out, pend, s2 = parts(st, sc)
        if t in (5, 10):
            rec[t] = dict(state=jax.tree.map(np.asarray, st),
                          scan=jax.tree.map(lambda a: a[t], scans),
                          core=jax.tree.map(np.asarray, (s1, out, pend)),
                          after=jax.tree.map(np.asarray, s2))
        st = s2
    return rec


def _assert_maps(got, want, name):
    got, want = _np(got), np.asarray(want)
    np.testing.assert_array_equal(got[:, 96:], want[:, 96:], err_msg=name)
    np.testing.assert_allclose(got[:, :96], want[:, :96], atol=SUM_ATOL,
                               err_msg=name)


@pytest.mark.parametrize("t", [5, 10])
def test_teacher_forced_step_matches_jax(t):
    rec = _teacher_record()[t]
    sj, (cj_state, cj_out, cj_pend), aj = (rec["state"], rec["core"],
                                           rec["after"])
    assert bool(sj.inited) == (t == 10)
    st = tp.state_from_numpy(sj)
    # the handover itself is lossless, both ways
    back = tp.state_to_numpy(st)
    assert type(back) is type(st)
    for a, b in zip(jax.tree.leaves(sj), jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, a.astype(b.dtype))
    scan = tp.scan_from_numpy(rec["scan"])
    s1, out, pend = tp.step_core(st, scan, CFG)

    for name in ("fail", "degenerate", "inited", "n_corner", "n_surf",
                 "fast_rotation", "hori_merged", "n_assoc_line",
                 "n_assoc_plane", "t"):
        np.testing.assert_array_equal(_np(getattr(out, name)),
                                      np.asarray(getattr(cj_out, name)),
                                      err_msg=name)
    for name in ("pose_p", "pose_q"):
        np.testing.assert_allclose(_np(getattr(out, name)),
                                   getattr(cj_out, name), atol=POSE_ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(_np(out.sv_min), cj_out.sv_min, rtol=1e-4)

    # window: poses to POSE_ATOL; velocity/bias columns are less observed
    # and move with the LM iterates' rounding, so they get 1e-4
    x, xj = _np(s1.x), cj_state.x
    np.testing.assert_allclose(x[:, 0:6], xj[:, 0:6], atol=POSE_ATOL)
    np.testing.assert_allclose(x[:, 6:15], xj[:, 6:15], atol=1e-4)
    np.testing.assert_array_equal(_np(s1.frame_valid), cj_state.frame_valid)
    np.testing.assert_array_equal(_np(s1.inited), cj_state.inited)
    np.testing.assert_array_equal(_np(s1.prior.valid), cj_state.prior.valid)
    np.testing.assert_allclose(_np(s1.prior.x0), cj_state.prior.x0,
                               atol=1e-4)
    # lin_J/lin_r come out of an f32 Schur complement whose pseudo-inverse
    # threshold sits inside the eigenvalue noise: the reference's own jit
    # and eager runs disagree there, so they are held in
    # test_torch_estimator.py::test_marginalize against that spread
    for name in ("corner", "surf"):
        np.testing.assert_array_equal(_np(getattr(s1.stacks, name + "_mask")),
                                      getattr(cj_state.stacks,
                                              name + "_mask"))
        np.testing.assert_allclose(_np(getattr(s1.stacks, name)),
                                   getattr(cj_state.stacks, name),
                                   atol=POSE_ATOL, err_msg=name)
    np.testing.assert_array_equal(_np(pend.do_map), cj_pend.do_map)
    np.testing.assert_allclose(_np(pend.p), cj_pend.p, atol=POSE_ATOL)

    s2 = tp.apply_inserts(s1, pend, CFG)
    for name in tp.MAP_FIELDS:
        _assert_maps(getattr(s2, name).cells, getattr(aj, name).cells, name)
    # the scatter insert returns new maps: the step's input maps are intact
    _assert_maps(s1.vm_surf.cells, sj.vm_surf.cells, "input map")


def _batch_inputs(B, n_scans):
    seqs, gts = [], []
    for b in range(B):
        traj = jsyn.Trajectory(speed=0.6 + 0.2 * b, yaw_rate=0.05 * b,
                               z_amp=0.1)
        scans, gR, gp = jr.make_sequence(
            jsyn.default_world(), traj, 0.0, n_scans, JCFG_H, n_az=360,
            seed=b, range_noise=0.003, dtype=np.float32, with_hori=True,
            hori_n_az=240, to_device=False)
        seqs.append(scans)
        gts.append((gR, gp))
    return jax.tree.map(lambda *xs: np.stack(xs, axis=1), *seqs), gts


def test_replay_batch_matches_jax():
    B, T = 2, 12
    scans, _ = _batch_inputs(B, T)
    _, oj = jr.replay_batch(
        jr.stack_states([jp.init_state(JCFG_H) for _ in range(B)]),
        jax.tree.map(jnp.asarray, scans), JCFG_H)
    states = tr.stack_states([tp.init_state(CFG_H) for _ in range(B)])
    st, ot = tr.replay_batch(states, tp.scan_from_numpy(scans), CFG_H)
    assert ot.pose_p.shape == (T, B, 3)
    for name in ("inited", "fail", "hori_merged"):
        np.testing.assert_array_equal(_np(getattr(ot, name)),
                                      np.asarray(getattr(oj, name)),
                                      err_msg=name)
    assert np.abs(_np(ot.n_corner) - np.asarray(oj.n_corner)).max() <= 1
    assert _np(ot.inited)[-1].all()
    assert _np(ot.hori_merged).any()
    np.testing.assert_allclose(_np(ot.pose_p), np.asarray(oj.pose_p),
                               atol=BATCH_POSE_ATOL)
    # the maps were written in place through the batched insert
    assert st.vm_surf.cells is states.vm_surf.cells
    assert (_np(st.vm_surf.cells)[..., 96:] > 0).any()


def test_hall_replay_against_golden():
    scans, gt_R, gt_p = _hall(25, 0.0)
    g = np.load(GOLDEN)
    _, outs = tr.replay(tp.init_state(CFG), tp.scan_from_numpy(scans), CFG)
    np.testing.assert_array_equal(_np(outs.inited), g["inited"])
    np.testing.assert_array_equal(_np(outs.fail), g["fail"])
    np.testing.assert_array_equal(_np(outs.t), g["t"])
    pose = _np(outs.pose_p)
    assert np.isfinite(pose).all()
    np.testing.assert_allclose(pose, g["pose_p"], atol=GOLDEN_POSE_ATOL)
    ate = _ate(pose, g["t"], gt_R, gt_p)
    ate_golden = _ate(g["pose_p"], g["t"], gt_R, gt_p)
    assert ate <= ate_golden + GOLDEN_ATE_SLACK, (ate, ate_golden)
    # the replay module's aligned ATE agrees with the reference's on the
    # same poses
    q = _np(outs.pose_q)
    a_t, e_t = tr.ate_rmse(q, pose, gt_R, gt_p)
    a_j, e_j = jr.ate_rmse(q, pose, gt_R, gt_p)
    assert abs(a_t - a_j) <= 1e-6
    np.testing.assert_allclose(e_t, e_j, atol=1e-5)
    np.testing.assert_array_equal(_np(outs.n_corner), g["n_corner"])


def test_port_imports_no_jax():
    code = ("import sys, mmloam_tpu_torch, mmloam_tpu_torch.pipeline, "
            "mmloam_tpu_torch.replay, mmloam_tpu_torch.ops.map_insert; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'mmloam_tpu.'))] "
            "+ (['mmloam_tpu'] if 'mmloam_tpu' in sys.modules else []); "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_off_default_options_raise():
    with pytest.raises(NotImplementedError, match="use_nonfeature"):
        tp.init_state(CFG.replace(use_nonfeature=True))
    with pytest.raises(NotImplementedError, match="imu_mode"):
        tp.init_state(CFG.replace(imu_mode=1))
    with pytest.raises(NotImplementedError, match="dedup_gather"):
        tp.init_state(CFG.replace(
            map=dataclasses.replace(CFG.map, dedup_gather=True)))
