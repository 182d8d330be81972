"""Port estimator against the JAX reference on identical inputs.

The inputs are a real mid-sequence window: the port replays 11 scans of
the tiny hall (3 mm range noise) and hands its state, the prepared frame
of scan 10 (full window, after init) and of scan 5 (short window, before
init), and the keyframes of its init attempt to both packages as f32
numpy arrays.  Compared:

* `build_reduced`: Q/g0/c0/NtN within 1e-4 of each field's scale (f32
  sums over ~1000 factors in another order); n_line/n_plane/n_normal
  exactly.  Also the gather-free re-association from cached blocks.
* `lm_solve`: the solved window within 1e-5 (poses) / 1e-4 (velocity and
  biases); converged flag exactly.
* `marginalize`: the prior's information J^T J and gradient J^T r.  Its
  f32 Schur complement drops eigenvalues below 1e-6 of the largest, and
  eigenvalues near that cut are decided by rounding: the reference's own
  jit and eager runs disagree there.  The port is held to twice that
  self-disagreement plus 1e-3 of the scale.
* `estimate`, full and short window: x, fail/degenerate, association
  counts exactly, sv_min within 1e-4 relative.
* `initialize` / `refine_gravity`: gravity, velocities and biases within
  1e-4 (20 / 8 Gauss-Newton steps in f32), the ok flag exactly.
"""

import functools

import numpy as np
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from mmloam_tpu.config import tiny_config as jax_tiny_config  # noqa: E402
from mmloam_tpu.estimator import estimate as jest  # noqa: E402
from mmloam_tpu.estimator import initializer as jinit  # noqa: E402
from mmloam_tpu.estimator import reduced as jred  # noqa: E402
from mmloam_tpu.estimator import solver as jsol  # noqa: E402
from mmloam_tpu.ops import voxelmap as jvm  # noqa: E402

from mmloam_tpu_torch import pipeline as tp  # noqa: E402
from mmloam_tpu_torch import replay as tr  # noqa: E402
from mmloam_tpu_torch.config import tiny_config  # noqa: E402
from mmloam_tpu_torch.data import synthetic as tsyn  # noqa: E402
from mmloam_tpu_torch.estimator import estimate as test_  # noqa: E402
from mmloam_tpu_torch.estimator import initializer as tinit  # noqa: E402
from mmloam_tpu_torch.estimator import reduced as tred  # noqa: E402
from mmloam_tpu_torch.estimator import solver as tsol  # noqa: E402
from mmloam_tpu_torch.ops import preintegration as tpre  # noqa: E402
from mmloam_tpu_torch.tree import tree_map  # noqa: E402

CFG = tiny_config()
JCFG = jax_tiny_config()
POSE_ATOL = 1e-5
REL = 1e-4


def _np(tree):
    return tree_map(lambda a: a.detach().cpu().numpy(), tree)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _lane(tree):
    """The port's estimator takes a lane axis: a batch of one."""
    return tree_map(lambda a: a[None], tree)


def _unlane(tree):
    return tree_map(lambda a: a[0], tree)


def _close(got, want, rel=REL, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1.0),
                               err_msg=name)


@functools.lru_cache(maxsize=None)
def _window():
    """Port replay of 11 noisy hall scans; returns numpy snapshots."""
    scans, _, _ = tr.make_sequence(
        tsyn.default_world(), tsyn.Trajectory(speed=0.8, z_amp=0.15), 0.0,
        11, CFG, n_az=360, dtype=np.float32, range_noise=0.003, seed=1,
        device="cpu")
    init_inputs = []
    orig = tp._try_init

    def spy(state, cfg, attempt, one=False):
        # the one-sequence step (`one`) enters the init branch only at an
        # attempt; the lockstep step enters it every step, the attempt
        # flagging its lanes
        if one or bool(attempt[0]):
            init_inputs.append(_np(_unlane(state)))
        return orig(state, cfg, attempt, one)

    tp._try_init = spy
    try:
        st = tp.init_state(CFG, device="cpu")
        snaps = {}
        for t in range(11):
            sc = tree_map(lambda a: a[t], scans)
            if t in (5, 10):
                pf = tp.prepare_frame(st, sc, CFG)
                snaps[t] = dict(state=_np(st), pf=_np(pf))
            st, _ = tp.step(st, sc, CFG)
    finally:
        tp._try_init = orig
    assert snaps[10]["state"].inited and not snaps[5]["state"].inited
    return snaps, init_inputs[0]


def _est_args(snap):
    s, pf = snap["state"], snap["pf"]
    W = CFG.solver.window
    n_frames = int(pf.fv_w.sum())
    return dict(
        x0=pf.x_w, stacks=pf.stacks_w, cached_rfs=pf.rfs_w,
        vm_corner=s.vm_corner, vm_surf=s.vm_surf, preint=pf.preint_w,
        pair_valid=pf.pv_w, prior=pf.prior_w, frame_valid=pf.fv_w,
        gravity=s.gravity, Rbl=s.Rbl, tbl=s.tbl,
        full_window=np.asarray(bool(s.inited) and n_frames == W),
        refresh_slot=np.asarray(int(s.step_idx) % (W - 1), np.int32),
        vm_local_corner=s.vm_local_corner, vm_local_surf=s.vm_local_surf)


def _jax_est_args(a):
    out = _jnp(a)
    for k in ("stacks", "cached_rfs", "prior", "vm_corner", "vm_surf",
              "vm_local_corner", "vm_local_surf"):
        out[k] = _to_jax_container(a[k])
    return out


def _to_jax_container(tree):
    """Port NamedTuple of numpy -> the reference's NamedTuple class."""
    cls = {"Stacks": jest.Stacks, "ReducedFactor": jred.ReducedFactor,
           "Prior": jsol.Prior, "VoxelMap": jvm.VoxelMap}[type(tree).__name__]
    return cls(*(None if v is None else jnp.asarray(v) for v in tree))


def _port_est_args(a):
    """The estimate's inputs for the port, each with a lane axis of 1."""
    out = {k: _lane(_t(v)) for k, v in a.items()}
    for k in ("vm_corner", "vm_surf", "vm_local_corner", "vm_local_surf"):
        out[k] = tp.voxelmap.VoxelMap(
            torch.from_numpy(np.array(a[k].cells))[None])
    return out


def _frame(stacks, slot):
    return type(stacks)(*(None if v is None else v[slot] for v in stacks))


def _assert_rf(rt, rj):
    for name in ("Q", "g0", "c0", "z0", "o", "NtN"):
        _close(np.asarray(getattr(rt, name)), np.asarray(getattr(rj, name)),
               name=name)
    for name in ("n_line", "n_plane", "n_normal"):
        np.testing.assert_array_equal(np.asarray(getattr(rt, name)),
                                      np.asarray(getattr(rj, name)),
                                      err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_build_reduced():
    def f(x6, fstack, vmc, vms, Rbl, tbl, thres, wt, hub, ok, vlc, vls,
          cached):
        return jred.build_reduced(x6, fstack, vmc, vms, Rbl, tbl, JCFG,
                                  thres, wt, hub, ok, vm_local_corner=vlc,
                                  vm_local_surf=vls, cached=cached)
    return jax.jit(f)


@pytest.mark.parametrize("slot", [4, 1])
def test_build_reduced_matches_jax(slot):
    snaps, _ = _window()
    a = _est_args(snaps[10])
    s = CFG.solver
    x6 = a["x0"][slot, :6]
    # move the pose off the association point for the cached re-association
    x6_moved = x6 + np.float32(3e-3)
    thres, wt, hub = (np.float32(s.thres_dist), np.float32(s.plan_weight_tan),
                      np.float32(1e12))
    ja = _jax_est_args(a)
    pa = _port_est_args(a)
    fj = _jax_build_reduced()
    common_j = (ja["vm_corner"], ja["vm_surf"], ja["Rbl"], ja["tbl"],
                thres, wt, hub, ja["frame_valid"][slot],
                ja["vm_local_corner"], ja["vm_local_surf"])
    rj, blkj = fj(jnp.asarray(x6), _frame(ja["stacks"], slot),
                  *common_j[:2], *common_j[2:], None)
    pfs = type(pa["stacks"])(*(None if v is None else v[:, slot]
                               for v in pa["stacks"]))
    common_t = dict(vm_local_corner=pa["vm_local_corner"],
                    vm_local_surf=pa["vm_local_surf"])
    rt, blkt = tred.build_reduced(
        torch.from_numpy(x6)[None], pfs, pa["vm_corner"], pa["vm_surf"],
        pa["Rbl"], pa["tbl"], CFG, torch.tensor([thres]), torch.tensor([wt]),
        torch.tensor([hub]), pa["frame_valid"][:, slot], **common_t)
    rt = _unlane(rt)
    assert int(rt.n_plane) > 50
    _assert_rf(rt, rj)
    rj2, _ = fj(jnp.asarray(x6_moved), _frame(ja["stacks"], slot),
                *common_j[:2], *common_j[2:], blkj)
    rt2, _ = tred.build_reduced(
        torch.from_numpy(x6_moved)[None], pfs, pa["vm_corner"],
        pa["vm_surf"], pa["Rbl"], pa["tbl"], CFG, torch.tensor([thres]),
        torch.tensor([wt]), torch.tensor([hub]), pa["frame_valid"][:, slot],
        cached=blkt, **common_t)
    _assert_rf(_unlane(rt2), rj2)
    # eval_reduced at a moved pose
    x6m = torch.from_numpy(x6_moved)
    for a_, b_ in zip(tred.eval_reduced(x6m, rt),
                      jred.eval_reduced(jnp.asarray(x6_moved), rj)):
        _close(a_.numpy(), np.asarray(b_))


def _solve_inputs():
    snaps, _ = _window()
    a = _est_args(snaps[10])
    # factors built by the port at the entry window (identical inputs for
    # both solvers from here on)
    rfs = a["cached_rfs"]
    st = tp.state_from_numpy(snaps[10]["state"], device="cpu")
    res = _unlane(test_.estimate(**_port_est_args(a), cfg=CFG))
    return a, _np(res.rfs), rfs, st


def test_lm_solve_matches_jax():
    a, rfs, _, _ = _solve_inputs()
    args = (a["x0"], rfs, a["preint"], a["pair_valid"], a["prior"],
            a["frame_valid"], a["gravity"])
    cap = CFG.solver.max_inner_iters
    rj = jax.jit(lambda x, r, p, pv, pr, fv, g: jsol.lm_solve(
        x, r, p, pv, pr, fv, g, JCFG, cap))(
        jnp.asarray(args[0]), _to_jax_container(rfs), _jnp(args[2]),
        jnp.asarray(args[3]), _to_jax_container(args[4]),
        jnp.asarray(args[5]), jnp.asarray(args[6]))
    caps = torch.tensor([cap], dtype=torch.int32)
    rt = _unlane(tsol.lm_solve(*(_lane(_t(v)) for v in args), CFG, caps,
                               cap))
    x, xj = rt.x.numpy(), np.asarray(rj.x)
    np.testing.assert_allclose(x[:, 0:6], xj[:, 0:6], atol=POSE_ATOL)
    np.testing.assert_allclose(x[:, 6:15], xj[:, 6:15], atol=1e-4)
    assert bool(rt.converged) == bool(rj.converged)
    assert np.abs(x - a["x0"]).max() > 1e-4      # the solve moved the window
    # skip: a no-op that reports converged
    rs = _unlane(tsol.lm_solve(*(_lane(_t(v)) for v in args), CFG, caps,
                               cap, skip=torch.tensor([True])))
    assert torch.equal(rs.x, torch.from_numpy(a["x0"])) and bool(rs.converged)


def _info(prior):
    J = np.asarray(prior.lin_J, np.float64)
    return J.T @ J, J.T @ np.asarray(prior.lin_r, np.float64)


def test_marginalize_matches_jax():
    a, rfs, _, _ = _solve_inputs()
    rf0 = tree_map(lambda v: v[0], rfs)
    args = (a["x0"], rf0, a["preint"], a["prior"], a["gravity"])
    jargs = (jnp.asarray(args[0]), _to_jax_container(rf0), _jnp(args[2]),
             _to_jax_container(args[3]), jnp.asarray(args[4]))
    pe = jsol.marginalize(*jargs, JCFG)
    pj = jax.jit(lambda *z: jsol.marginalize(*z, JCFG))(*jargs)
    pt = _unlane(tsol.marginalize(*(_lane(_t(v)) for v in args), CFG))
    assert bool(pt.valid)
    np.testing.assert_array_equal(pt.x0.numpy(), np.asarray(pe.x0))
    He, ge = _info(pe)
    Hj, gj = _info(pj)
    Ht, gt = _info(_np(pt))
    for got, want, other in ((Ht, He, Hj), (gt, ge, gj)):
        spread = np.abs(other - want).max()
        bound = 2.0 * spread + 1e-3 * max(np.abs(want).max(), 1.0)
        assert np.abs(got - want).max() <= bound, (
            np.abs(got - want).max(), spread)


@functools.lru_cache(maxsize=None)
def _jax_estimate():
    def f(x0, stacks, rfs, vmc, vms, preint, pv, prior, fv, g, Rbl, tbl,
          full, slot, vlc, vls):
        return jest.estimate(x0, stacks, rfs, vmc, vms, preint, pv, prior,
                             fv, g, Rbl, tbl, JCFG, full_window=full,
                             refresh_slot=slot, vm_local_corner=vlc,
                             vm_local_surf=vls)
    return jax.jit(f)


@pytest.mark.parametrize("t", [10, 5])
def test_estimate_matches_jax(t):
    snaps, _ = _window()
    a = _est_args(snaps[t])
    assert bool(a["full_window"]) == (t == 10)
    ja = _jax_est_args(a)
    rj = _jax_estimate()(*(ja[k] for k in (
        "x0", "stacks", "cached_rfs", "vm_corner", "vm_surf", "preint",
        "pair_valid", "prior", "frame_valid", "gravity", "Rbl", "tbl",
        "full_window", "refresh_slot", "vm_local_corner", "vm_local_surf")))
    rt = _unlane(test_.estimate(**_port_est_args(a), cfg=CFG))
    x, xj = rt.x.numpy(), np.asarray(rj.x)
    np.testing.assert_allclose(x[:, 0:6], xj[:, 0:6], atol=POSE_ATOL)
    np.testing.assert_allclose(x[:, 6:15], xj[:, 6:15], atol=1e-4)
    for name in ("fail", "degenerate", "n_line", "n_plane"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)),
                                      err_msg=name)
    assert int(rt.n_plane) > 50
    np.testing.assert_allclose(rt.sv_min.numpy(), np.asarray(rj.sv_min),
                               rtol=REL)
    _close(rt.NtN.numpy(), np.asarray(rj.NtN), name="NtN")
    np.testing.assert_array_equal(rt.prior.valid.numpy(),
                                  np.asarray(rj.prior.valid))
    for name in ("n_line", "n_plane", "n_normal"):
        np.testing.assert_array_equal(getattr(rt.rfs, name).numpy(),
                                      np.asarray(getattr(rj.rfs, name)))


def test_initialize_and_refine_gravity_match_jax():
    snaps, s = _window()
    z3 = torch.zeros(3)
    st = _t(s)
    prs = [tpre.preintegrate(st.kf_imu[i, :, 0:3], st.kf_imu[i, :, 3:6],
                             st.kf_imu[i, :, 6], st.kf_imu_mask[i], z3, z3,
                             CFG.imu) for i in range(st.kf_x.shape[0])]
    pr = tpre.PreintResult(*(torch.stack(f) for f in zip(*prs)))
    preint9 = _np(dict(dq=pr.dq, dp=pr.dp, dv=pr.dv, jac=pr.jac, cov=pr.cov,
                       dt=pr.dtime, bg=pr.bg, ba=pr.ba))
    Rlb = s.Rbl.T
    tlb = -s.Rbl.T @ s.tbl
    args = (s.kf_x[:, 4:7], s.kf_x[:, 0:4], s.avg_acc, preint9,
            CFG.imu.gnorm, Rlb, tlb)
    kw = dict(gravity_prior_w=CFG.init_gravity_prior_w,
              bias_bound=CFG.failsafe.init_bias_bound,
              velocity_bound=CFG.failsafe.init_velocity_bound)
    rj = jinit.initialize(*(_jnp(v) if not isinstance(v, float) else v
                            for v in args), **kw)
    rt = _unlane(tinit.initialize(*(_lane(_t(v)) if not isinstance(v, float)
                                    else v for v in args), **kw))
    assert bool(rt.ok) and bool(rj.ok)
    for name in ("gravity", "v", "bg", "ba"):
        np.testing.assert_allclose(getattr(rt, name).numpy(),
                                   np.asarray(getattr(rj, name)), atol=1e-4,
                                   err_msg=name)

    post = snaps[10]["state"]
    args = (post.x, post.preint, post.pair_valid, post.gravity)
    gj, vj = jax.jit(lambda x, p, pv, g: jinit.refine_gravity(
        x, p, pv, g, JCFG.imu.gnorm))(*(_jnp(v) for v in args))
    gt, vt = _unlane(tinit.refine_gravity(*(_lane(_t(v)) for v in args),
                                          CFG.imu.gnorm))
    assert int(post.pair_valid.sum()) >= 2
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-4)
