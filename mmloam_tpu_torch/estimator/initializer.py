"""Gravity / velocity / bias MAP initialization (port of
mmloam_tpu/estimator/initializer.py).

`initialize` is TryMAPInitialization (unionPoseEstimation.cpp:425-627) as
a small Gauss-Newton solve, and `refine_gravity` the online gravity
re-refinement against the window.  The reference's `jax.jacfwd` becomes
`torch.func.jacrev`: torch.func's forward mode (`jvp`, hence `jacfwd`)
promotes a Python float times a 0-dim float32 tensor to float64, which the
SO(3) helpers do throughout; reverse mode keeps float32.  Both give the
exact Jacobian.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacrev

from .. import lie
from ..ops.preintegration import cholesky, inv


class InitResult(NamedTuple):
    ok: torch.Tensor        # () bool — passed the sanity gates
    gravity: torch.Tensor   # (3,)
    v: torch.Tensor         # (K,3)
    bg: torch.Tensor        # (3,)
    ba: torch.Tensor        # (3,)


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _gravity_seed(avg_acc, gnorm):
    """Rotation vector r with exp(r) @ (0,0,-gnorm) == avg_acc."""
    a = avg_acc / torch.clamp(_norm(avg_acc), min=1e-9)
    g = torch.tensor([0.0, 0.0, -1.0], dtype=avg_acc.dtype,
                     device=avg_acc.device)
    axis = lie.cross(g, a)
    s = _norm(axis)
    c = torch.sum(g * a)
    angle = torch.atan2(s, c)
    axis = axis / torch.clamp(s, min=1e-9)
    axis = torch.where(s < 1e-6, torch.tensor([1.0, 0.0, 0.0], dtype=a.dtype,
                                              device=a.device), axis)
    return axis * angle


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _init_residuals(theta, consts):
    """Stacked residual vector of the init problem (all factors)."""
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

    for i in range(1, K):
        Ri = lie.exp_matrix(consts["ri"][i - 1])
        Rj = lie.exp_matrix(consts["ri"][i])
        RiT = Ri.T
        jac = consts["jac"][i]
        dT = consts["dt"][i]
        dbg = bg - consts["meas_bg"][i]
        dba = ba - consts["meas_ba"][i]
        rP = _mv(RiT, consts["dpos"][i] - v[i - 1] * dT
                 - _mv(Rwg, g_I) * (0.5 * dT * dT)) - (
            consts["dp"][i] + _mv(jac[0:3, 9:12], dbg)
            + _mv(jac[0:3, 12:15], dba))
        dR_corr = lie.quat_mul(consts["dq"][i],
                               lie.exp_quat(_mv(jac[3:6, 9:12], dbg)))
        rPhi = lie.log_matrix(lie.quat_to_matrix(lie.quat_conj(dR_corr))
                              @ RiT @ Rj)
        rV = _mv(RiT, v[i] - v[i - 1] - _mv(Rwg, g_I) * dT) - (
            consts["dv"][i] + _mv(jac[6:9, 9:12], dbg)
            + _mv(jac[6:9, 12:15], dba))
        out.append(_mv(consts["sqrt_info9"][i], torch.cat([rP, rPhi, rV])))
    return torch.cat(out)


def initialize(kf_P, kf_Q, avg_acc, preint9, gnorm, Rlb, tlb, iters: int = 20,
               gravity_prior_w: float = 20.0, bias_bound: float = 0.5,
               velocity_bound: float = 2.0):
    """Run the init solve over K keyframes (see the reference)."""
    dtype, dev = kf_P.dtype, kf_P.device
    K = kf_P.shape[0]
    Rwl = lie.quat_to_matrix(kf_Q)
    ri = lie.log_matrix(Rwl @ Rlb)
    p_b = kf_P + _mv(Rwl, tlb)
    dpos = torch.cat([torch.zeros((1, 3), dtype=dtype, device=dev),
                      p_b[1:] - p_b[:-1]])
    dt = preint9["dt"]
    v_fd = dpos[1:] / torch.clamp(dt[1:, None], min=1e-6)
    prior_v = torch.cat([v_fd[:1], v_fd], dim=0)
    prior_r = _gravity_seed(avg_acc, gnorm)

    eye9 = torch.eye(9, dtype=dtype, device=dev)
    c = preint9["cov"][:, 0:9, 0:9] + eye9 * 1e-10
    ci = inv(0.5 * (c + c.transpose(-1, -2)))
    sqrt_info9 = cholesky(0.5 * (ci + ci.transpose(-1, -2))).transpose(-1, -2)

    f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    consts = dict(ri=ri, dpos=dpos, prior_v=prior_v, prior_r=prior_r,
                  gravity_prior_w=f(gravity_prior_w), gnorm=f(gnorm),
                  dq=preint9["dq"], dp=preint9["dp"], dv=preint9["dv"],
                  jac=preint9["jac"], dt=dt, meas_bg=preint9["bg"],
                  meas_ba=preint9["ba"], sqrt_info9=sqrt_info9)

    theta = torch.cat([prior_r, prior_v.reshape(-1),
                       torch.zeros(6, dtype=dtype, device=dev)])
    res_fn = lambda th: _init_residuals(th, consts)
    for _ in range(iters):
        r = res_fn(theta)
        J = jacrev(res_fn)(theta)
        H = J.T @ J
        g = J.T @ r
        d = torch.diagonal(H)
        s = 1.0 / torch.sqrt(torch.clamp(d, min=1e-10))
        A = (H * s[:, None] * s[None, :]
             + 1e-6 * torch.eye(H.shape[0], dtype=dtype, device=dev))
        L = cholesky(A)
        dx = s * torch.cholesky_solve((-(s * g))[:, None], L)[:, 0]
        theta = theta + dx

    r = theta[0:3]
    v = theta[3:3 + 3 * K].reshape(K, 3)
    ba = theta[3 + 3 * K: 6 + 3 * K]
    bg = theta[6 + 3 * K: 9 + 3 * K]
    gravity = _mv(lie.exp_matrix(r),
                  torch.tensor([0.0, 0.0, -gnorm], dtype=dtype, device=dev))
    ok = ((_norm(ba) <= bias_bound)
          & (_norm(bg) <= bias_bound)
          & torch.all(_norm(v - prior_v) <= velocity_bound)
          & torch.all(torch.isfinite(theta)))
    return InitResult(ok=ok, gravity=gravity, v=v, bg=bg, ba=ba)


def refine_gravity(x, preint, pair_valid, gravity, gnorm, iters: int = 8,
                   prior_w: float = 50.0):
    """Online gravity re-refinement against the sliding window: re-solves
    [gravity tilt, window velocities].  Returns (gravity', v')."""
    dtype, dev = x.dtype, x.device
    W = x.shape[0]
    g_I = torch.tensor([0.0, 0.0, -gnorm], dtype=dtype, device=dev)
    r0 = _gravity_seed(gravity, gnorm)
    Ri = lie.exp_matrix(x[:, 3:6])
    pvf = pair_valid.to(dtype)

    def residuals(theta):
        r = theta[0:3]
        v = theta[3:].reshape(W, 3)
        g_w = _mv(lie.exp_matrix(r), g_I)
        out = [prior_w * (r - r0)]
        for i in range(1, W):
            RiT = Ri[i - 1].T
            dT = preint["dt"][i]
            rP = _mv(RiT, x[i, 0:3] - x[i - 1, 0:3] - v[i - 1] * dT
                     - 0.5 * g_w * dT * dT) - preint["dp"][i]
            rel = lie.quat_to_matrix(
                lie.quat_conj(preint["dq"][i])) @ RiT @ Ri[i]
            rPhi = lie.log_matrix(rel)
            rV = _mv(RiT, v[i] - v[i - 1] - g_w * dT) - preint["dv"][i]
            r15 = torch.cat([rP, rPhi, rV, torch.zeros(6, dtype=dtype,
                                                       device=dev)])
            out.append(pvf[i] * _mv(preint["sqrt_info"][i], r15))
        return torch.cat(out)

    theta = torch.cat([r0, x[:, 6:9].reshape(-1)])
    for _ in range(iters):
        res = residuals(theta)
        J = jacrev(residuals)(theta)
        H = J.T @ J
        d = torch.diagonal(H)
        s = 1.0 / torch.sqrt(torch.clamp(d, min=1e-8))
        A = (H * s[:, None] * s[None, :]
             + 1e-5 * torch.eye(H.shape[0], dtype=dtype, device=dev))
        sol, info = torch.linalg.solve_ex(A, -(s * (J.T @ res)))
        sol = torch.where(info != 0, torch.full_like(sol, float("nan")), sol)
        dx = s * sol
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
        theta = theta + dx
    r = theta[0:3]
    v = theta[3:].reshape(W, 3)
    g_new = _mv(lie.exp_matrix(r), g_I)
    ok = torch.all(torch.isfinite(theta))
    return (torch.where(ok, g_new, gravity),
            torch.where(ok, v, x[:, 6:9]))
