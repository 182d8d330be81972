"""Port pipeline and replay drivers against the JAX reference.

* `init_state` equals the reference leaf by leaf.
* One teacher-forced `step_core` (+ `apply_inserts`) from a JAX state,
  handed over through `state_from_numpy`, before and after IMU init:
  window x, prior validity and anchor, maps, pending insert and
  StepOutput.  Discrete outputs
  (flags, counts) exactly; poses within 1e-5 m; map sums within 1e-5 with
  meta lanes exact.  The hall scans here carry 3 mm range noise.  The
  same two steps under `faithful_config` (reference-faithful prediction,
  local-map move gate, full old-frame refresh, uncapped local rescue).
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
* The entry points (`init_state`, `state_from_numpy`, `scan_from_numpy`)
  run on the card unless given `device="cpu"`, and raise without one.
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
from mmloam_tpu.config import faithful_config as jax_faithful_config  # noqa: E402,E501
from mmloam_tpu.config import tiny_config as jax_tiny_config  # noqa: E402
from mmloam_tpu.data import synthetic as jsyn  # noqa: E402

from mmloam_tpu_torch import pipeline as tp  # noqa: E402
from mmloam_tpu_torch import replay as tr  # noqa: E402
from mmloam_tpu_torch.config import faithful_config, tiny_config  # noqa: E402,E501
from mmloam_tpu_torch.data import synthetic as tsyn  # noqa: E402
from mmloam_tpu_torch.tree import tree_map  # noqa: E402

import torch_teacher as tt  # noqa: E402

CFG = tiny_config()
JCFG = jax_tiny_config()
# the synthetic hall yields few Horizon corners: the batch test lowers the
# merge gate (as tests/test_hori_fusion.py does) so the fused path runs
CFG_H = CFG.replace(solver=dataclasses.replace(CFG.solver,
                                               corner_cnt_gate_hori=5))
JCFG_H = JCFG.replace(solver=dataclasses.replace(JCFG.solver,
                                                 corner_cnt_gate_hori=5))
FCFG = faithful_config(CFG)
FJCFG = jax_faithful_config(JCFG)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "hall_25.npz")
FAITHFUL_SCALE = 10.0
FAITHFUL_STACK_RTOL = 1e-4
FAITHFUL_MAP_ATOL = 1e-3
BATCH_POSE_ATOL = 5e-3
GOLDEN_POSE_ATOL = 0.01
GOLDEN_ATE_SLACK = 0.01


_np = tt.np_


def _hall(n_scans, range_noise, seed=0, **kw):
    return tt.hall(JCFG, n_scans, range_noise, seed=seed, **kw)


def _ate(pose_p, t, gt_R, gt_p):
    gt_rel = np.einsum("ij,nj->ni", gt_R[0].T, gt_p - gt_p[0])
    idx = np.rint(np.asarray(t, np.float64) / 0.1).astype(int) - 1
    return float(np.sqrt(((pose_p - gt_rel[idx]) ** 2).sum(1).mean()))


def test_init_state_matches_jax():
    sj = jax.tree.map(np.asarray, jp.init_state(JCFG))
    st = tp.init_state(CFG, device="cpu")
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
def _teacher_record(faithful=False):
    """JAX step_core + apply_inserts over hall scans 0..10 (3 mm range
    noise): the pre-step states at scans 5 (pre-init) and 10 (post-init)
    and what the reference makes of that scan."""
    return tt.teacher_record(FJCFG if faithful else JCFG, 11, (5, 10))[0]


@pytest.mark.parametrize("t", [5, 10])
def test_teacher_forced_step_matches_jax(t):
    _check_teacher_step(_teacher_record()[t], t, CFG)


@pytest.mark.parametrize("t", [5, 10])
def test_teacher_forced_faithful_step_matches_jax(t):
    """`faithful_config`: the reference-faithful prediction (no velocity or
    gravity terms) after init, the local-map move gate, every old frame
    re-associated each scan, the uncapped local rescue and no scatter gate
    on plane fits.  Float bounds are FAITHFUL_SCALE times the default
    step's: on these two steps the reference's own jit and eager runs
    differ by 5.5e-5 m in the published pose (scan 5) and 4.4e-5 in the
    window poses (scan 10), where the port is within 3.9e-5 and 4.4e-5 of
    the jitted reference; discrete outputs stay exact.  That rotation
    spread moves a stack point by up to its range x 4.4e-5 (the stacks'
    FAITHFUL_STACK_RTOL) and an inserted cell sum by up to the sum over
    its points (FAITHFUL_MAP_ATOL, points within 20 m)."""
    _check_teacher_step(_teacher_record(faithful=True)[t], t, FCFG,
                        FAITHFUL_SCALE, stack_rtol=FAITHFUL_STACK_RTOL,
                        map_atol=FAITHFUL_MAP_ATOL)


def _check_teacher_step(rec, t, cfg, scale=1.0, stack_rtol=0.0,
                        map_atol=tt.SUM_ATOL):
    """`torch_teacher.check_teacher_step` (float bounds the default step's
    times `scale`) on the record of scan t (post-init at t = 10)."""
    tt.check_teacher_step(rec, t == 10, cfg, scale, stack_rtol=stack_rtol,
                          map_atol=map_atol)


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
    states = tr.stack_states([tp.init_state(CFG_H, device="cpu") for _ in range(B)])
    st, ot = tr.replay_batch(states, tp.scan_from_numpy(scans, device="cpu"),
                              CFG_H)
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
    _, outs = tr.replay(tp.init_state(CFG, device="cpu"),
                        tp.scan_from_numpy(scans, device="cpu"), CFG)
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
            "mmloam_tpu_torch.replay, mmloam_tpu_torch.ops.map_insert, "
            "mmloam_tpu_torch.checkpoint, mmloam_tpu_torch.metrics, "
            "mmloam_tpu_torch.data.rosbag, mmloam_tpu_torch.data.decode, "
            "mmloam_tpu_torch.data.calibration, "
            "mmloam_tpu_torch.data.export, "
            "mmloam_tpu_torch.data.synthetic_bag; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'mmloam_tpu.'))] "
            "+ (['mmloam_tpu'] if 'mmloam_tpu' in sys.modules else []); "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_init_state_accepts_packs_and_dedup():
    """Every map option of the reference is ported: any pack whose dims
    divide the map (rows of 4 cpr floats) and dedup_gather; a pack that
    does not divide raises as the reference asserts.  Every window has a
    K2 instance (`assoc.instance`), one wider than registers hold the
    staged one."""
    from mmloam_tpu_torch.ops import assoc

    for pack, dedup in (((2, 2, 2), True), ((1, 1, 1), False),
                        ((2, 4, 1), True), ((4, 4, 2), True)):
        mc = dataclasses.replace(CFG.map, pack_x=pack[0], pack_y=pack[1],
                                 pack_z=pack[2], dedup_gather=dedup)
        lc = dataclasses.replace(CFG.local_map, pack_z=1,
                                 dedup_gather=dedup)
        st = tp.init_state(CFG.replace(map=mc, local_map=lc), device="cpu")
        cpr = int(np.prod(pack))
        assert tuple(st.vm_surf.cells.shape) == (
            CFG.map.dim_x * CFG.map.dim_y * CFG.map.dim_z // cpr, 4 * cpr)
        assert st.vm_local_corner.cells.shape[1] == 4 * 16
        assert assoc.instance(mc) in assoc.INSTANCES
        assert assoc.instance(lc) in assoc.INSTANCES
    with pytest.raises(ValueError, match="multiples"):
        tp.init_state(CFG.replace(map=dataclasses.replace(CFG.map, pack_x=5)),
                      device="cpu")
    wide = dataclasses.replace(CFG.map, stencil_x=3, stencil_y=3,
                               stencil_z=2)
    assert assoc.instance(wide) == "staged"
    # the reference-faithful settings and the rig's modes are ported
    tp.init_state(FCFG, device="cpu")
    for kw in (dict(use_nonfeature=True), dict(imu_mode=0),
               dict(imu_mode=1), dict(velo_only_mode=True)):
        tp.init_state(CFG.replace(**kw), device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    """With no CUDA device, the entry points raise and name device="cpu"
    unless the caller asks for the CPU; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tp.init_state(CFG)
    scans, _, _ = _hall(2, 0.0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tp.scan_from_numpy(scans)
    st = tp.init_state(CFG, device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tp.state_from_numpy(tp.state_to_numpy(st))
    assert st.vm_surf.cells.device.type == "cpu"
    assert tp.scan_from_numpy(scans, device="cpu").pts.device.type == "cpu"
    assert isinstance(tr.make_sequence(
        tsyn.default_world(), tsyn.Trajectory(speed=0.8), 0.0, 1, CFG,
        n_az=90)[0].pts, np.ndarray)
