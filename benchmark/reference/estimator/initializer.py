"""Gravity / velocity / bias MAP initialization (port of
mmloam_tpu/estimator/initializer.py).

`initialize` is TryMAPInitialization (unionPoseEstimation.cpp:425-627) as
a small Gauss-Newton solve, and `refine_gravity` the online gravity
re-refinement against the window, both over the lanes of a batch at their
fixed iteration counts.  The reference's `jax.jacfwd` becomes
`torch.func.jacrev`: torch.func's forward mode (`jvp`, hence `jacfwd`)
promotes a Python float times a 0-dim float32 tensor to float64, which the
SO(3) helpers do throughout; reverse mode keeps float32.  Both give the
exact Jacobian.  Each lane's residuals are written for one lane and
`torch.func.vmap` maps them and their Jacobian over the lanes; the linear
algebra is batched, with no device read (`preintegration.solve_lu`,
`cho_solve`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacrev, vmap

from .. import lie
from ..ops.preintegration import cho_solve, cholesky, inv, solve_lu


class InitResult(NamedTuple):
    ok: torch.Tensor        # (B,) bool — passed the sanity gates
    gravity: torch.Tensor   # (B, 3)
    v: torch.Tensor         # (B, K, 3)
    bg: torch.Tensor        # (B, 3)
    ba: torch.Tensor        # (B, 3)


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _gravity_seed(avg_acc, gnorm):
    """Rotation vector r (..., 3) with exp(r) @ (0,0,-gnorm) == avg_acc."""
    a = avg_acc / torch.clamp(_norm(avg_acc), min=1e-9)[..., None]
    g = lie.const((0.0, 0.0, -1.0), avg_acc.dtype, avg_acc.device)
    axis = lie.cross(g, a)
    s = _norm(axis)
    c = torch.sum(g * a, dim=-1)
    angle = torch.atan2(s, c)
    axis = axis / torch.clamp(s, min=1e-9)[..., None]
    axis = torch.where((s < 1e-6)[..., None],
                       lie.const((1.0, 0.0, 0.0), a.dtype, a.device), axis)
    return axis * angle[..., None]


_mv = lie.mv


def _with_residuals(lane_fn):
    """(Jacobian, residuals) of lane_fn(theta, consts) w.r.t. theta, both
    over the lanes of theta (B, n) and consts (B, ...): one evaluation of
    the residuals serves both."""
    def both(theta, consts):
        r = lane_fn(theta, consts)
        return r, r
    return vmap(jacrev(both, has_aux=True))


def _init_residuals(theta, consts):
    """Stacked residual vector of one lane's init problem (all factors)."""
    K = consts["ri"].shape[0]
    r = theta[0:3]
    v = theta[3:3 + 3 * K].reshape(K, 3)
    ba = theta[3 + 3 * K: 6 + 3 * K]
    bg = theta[6 + 3 * K: 9 + 3 * K]
    g_I = torch.stack([torch.zeros_like(consts["gnorm"]),
                       torch.zeros_like(consts["gnorm"]), -consts["gnorm"]])

    out = []
    Rwg = lie.exp_matrix(r)
    prior_R = lie.exp_matrix(consts["prior_r"])
    out.append(consts["gravity_prior_w"] * lie.log_matrix(Rwg.T @ prior_R))
    out.append(1000.0 * ba)
    out.append(4000.0 * bg)
    dtp = consts["dt"][1:, None]
    v_mid = 0.5 * (v[:-1] + v[1:])
    fd = consts["dpos"][1:] / torch.clamp(dtp, min=1e-6)
    out.append((4000.0 * (v_mid - fd)).reshape(-1))
    out.append(40.0 * (v[0] - consts["prior_v"][0]))

    # the K-1 keyframe pairs (i-1, i) at once, pair by pair in order
    Ri = lie.exp_matrix(consts["ri"][:-1])
    Rj = lie.exp_matrix(consts["ri"][1:])
    RiT = Ri.transpose(-1, -2)
    jac = consts["jac"][1:]
    dT = consts["dt"][1:, None]
    dbg = bg - consts["meas_bg"][1:]
    dba = ba - consts["meas_ba"][1:]
    g_w = _mv(Rwg, g_I)
    rP = _mv(RiT, consts["dpos"][1:] - v[:-1] * dT
             - g_w * (0.5 * dT * dT)) - (
        consts["dp"][1:] + _mv(jac[:, 0:3, 9:12], dbg)
        + _mv(jac[:, 0:3, 12:15], dba))
    dR_corr = lie.quat_mul(consts["dq"][1:],
                           lie.exp_quat(_mv(jac[:, 3:6, 9:12], dbg)))
    rPhi = lie.log_matrix(lie.quat_to_matrix(lie.quat_conj(dR_corr))
                          @ RiT @ Rj)
    rV = _mv(RiT, v[1:] - v[:-1] - g_w * dT) - (
        consts["dv"][1:] + _mv(jac[:, 6:9, 9:12], dbg)
        + _mv(jac[:, 6:9, 12:15], dba))
    out.append(_mv(consts["sqrt_info9"][1:],
                   torch.cat([rP, rPhi, rV], dim=-1)).reshape(-1))
    return torch.cat(out)


def initialize(kf_P, kf_Q, avg_acc, preint9, gnorm, Rlb, tlb, iters: int = 20,
               gravity_prior_w: float = 20.0, bias_bound: float = 0.5,
               velocity_bound: float = 2.0):
    """Run the init solve over each lane's K keyframes (see the
    reference): kf_P (B, K, 3), kf_Q (B, K, 4), avg_acc (B, 3), preint9
    (B, K, ...), Rlb (B, 3, 3), tlb (B, 3)."""
    dtype, dev = kf_P.dtype, kf_P.device
    B, K = kf_P.shape[:2]
    T = lambda a: a.transpose(-1, -2)
    Rwl = lie.quat_to_matrix(kf_Q)
    ri = lie.log_matrix(Rwl @ Rlb[:, None])
    p_b = kf_P + _mv(Rwl, tlb[:, None])
    dpos = torch.cat([torch.zeros((B, 1, 3), dtype=dtype, device=dev),
                      p_b[:, 1:] - p_b[:, :-1]], dim=1)
    dt = preint9["dt"]
    v_fd = dpos[:, 1:] / torch.clamp(dt[:, 1:, None], min=1e-6)
    prior_v = torch.cat([v_fd[:, :1], v_fd], dim=1)
    prior_r = _gravity_seed(avg_acc, gnorm)

    eye9 = torch.eye(9, dtype=dtype, device=dev)
    c = preint9["cov"][..., 0:9, 0:9] + eye9 * 1e-10
    ci = inv(0.5 * (c + T(c)))
    sqrt_info9 = T(cholesky(0.5 * (ci + T(ci))))

    shared = dict(gravity_prior_w=torch.full((), gravity_prior_w,
                                             dtype=dtype, device=dev),
                  gnorm=torch.full((), gnorm, dtype=dtype, device=dev))
    consts = dict(ri=ri, dpos=dpos, prior_v=prior_v, prior_r=prior_r,
                  dq=preint9["dq"], dp=preint9["dp"], dv=preint9["dv"],
                  jac=preint9["jac"], dt=dt, meas_bg=preint9["bg"],
                  meas_ba=preint9["ba"], sqrt_info9=sqrt_info9)
    jac_fn = _with_residuals(
        lambda th, c: _init_residuals(th, dict(c, **shared)))

    theta = torch.cat([prior_r, prior_v.reshape(B, -1),
                       torch.zeros((B, 6), dtype=dtype, device=dev)], dim=-1)
    eye = torch.eye(theta.shape[-1], dtype=dtype, device=dev)
    for _ in range(iters):
        J, r = jac_fn(theta, consts)
        H = T(J) @ J
        g = _mv(T(J), r)
        d = torch.diagonal(H, dim1=-2, dim2=-1)
        s = 1.0 / torch.sqrt(torch.clamp(d, min=1e-10))
        A = H * s[..., :, None] * s[..., None, :] + 1e-6 * eye
        L = cholesky(A)
        dx = s * cho_solve(L, (-(s * g))[..., None])[..., 0]
        theta = theta + dx

    r = theta[:, 0:3]
    v = theta[:, 3:3 + 3 * K].reshape(B, K, 3)
    ba = theta[:, 3 + 3 * K: 6 + 3 * K]
    bg = theta[:, 6 + 3 * K: 9 + 3 * K]
    gravity = _mv(lie.exp_matrix(r), lie.const((0.0, 0.0, -gnorm), dtype,
                                               dev))
    ok = ((_norm(ba) <= bias_bound)
          & (_norm(bg) <= bias_bound)
          & torch.all(_norm(v - prior_v) <= velocity_bound, dim=-1)
          & torch.all(torch.isfinite(theta), dim=-1))
    return InitResult(ok=ok, gravity=gravity, v=v, bg=bg, ba=ba)


def _refine_residuals(theta, lane, g_I, prior_w):
    """One lane's gravity-refinement residuals: theta = [tilt (3),
    window velocities (3 W)] against its window `lane`."""
    x, Ri, pre, pvf = lane["x"], lane["Ri"], lane["pre"], lane["pvf"]
    W = x.shape[0]
    r = theta[0:3]
    v = theta[3:].reshape(W, 3)
    g_w = _mv(lie.exp_matrix(r), g_I)
    out = [prior_w * (r - lane["r0"])]
    # the W-1 window pairs (i-1, i) at once, pair by pair in order
    RiT = Ri[:-1].transpose(-1, -2)
    dT = pre["dt"][1:, None]
    rP = _mv(RiT, x[1:, 0:3] - x[:-1, 0:3] - v[:-1] * dT
             - 0.5 * g_w * dT * dT) - pre["dp"][1:]
    rel = lie.quat_to_matrix(lie.quat_conj(pre["dq"][1:])) @ RiT @ Ri[1:]
    rPhi = lie.log_matrix(rel)
    rV = _mv(RiT, v[1:] - v[:-1] - g_w * dT) - pre["dv"][1:]
    r15 = torch.cat([rP, rPhi, rV, torch.zeros(
        (W - 1, 6), dtype=theta.dtype, device=theta.device)], dim=-1)
    out.append((pvf[1:, None] * _mv(pre["sqrt_info"][1:], r15)).reshape(-1))
    return torch.cat(out)


def refine_gravity(x, preint, pair_valid, gravity, gnorm, iters: int = 8,
                   prior_w: float = 50.0):
    """Online gravity re-refinement against each lane's sliding window:
    re-solves [gravity tilt, window velocities] of x (B, W, 15), preint
    and pair_valid (B, W, ...), gravity (B, 3).  Returns (gravity',
    v' (B, W, 3))."""
    dtype, dev = x.dtype, x.device
    B, W = x.shape[:2]
    T = lambda a: a.transpose(-1, -2)
    g_I = lie.const((0.0, 0.0, -gnorm), dtype, dev)
    r0 = _gravity_seed(gravity, gnorm)
    lane = dict(x=x, Ri=lie.exp_matrix(x[..., 3:6]),
                pre={k: preint[k] for k in ("dt", "dp", "dq", "dv",
                                            "sqrt_info")},
                pvf=pair_valid.to(dtype), r0=r0)
    jac_fn = _with_residuals(
        lambda th, ln: _refine_residuals(th, ln, g_I, prior_w))

    theta = torch.cat([r0, x[..., 6:9].reshape(B, -1)], dim=-1)
    eye = torch.eye(theta.shape[-1], dtype=dtype, device=dev)
    for _ in range(iters):
        J, res = jac_fn(theta, lane)
        H = T(J) @ J
        d = torch.diagonal(H, dim1=-2, dim2=-1)
        s = 1.0 / torch.sqrt(torch.clamp(d, min=1e-8))
        A = H * s[..., :, None] * s[..., None, :] + 1e-5 * eye
        sol = solve_lu(A, (-(s * _mv(T(J), res)))[..., None])[..., 0]
        dx = s * sol
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
        theta = theta + dx
    v = theta[:, 3:].reshape(B, W, 3)
    g_new = _mv(lie.exp_matrix(theta[:, 0:3]), g_I)
    ok = torch.all(torch.isfinite(theta), dim=-1)
    return (torch.where(ok[:, None], g_new, gravity),
            torch.where(ok[:, None, None], v, x[..., 6:9]))
