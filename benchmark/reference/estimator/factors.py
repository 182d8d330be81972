"""Factor construction and residual evaluation (port of
mmloam_tpu/estimator/factors.py).

Association (stencil k-NN from dense candidate blocks -> PCA line / TLS
plane fits with the reference's gates, plus the local-map rescue tier),
localizability, and the IMU / prior residuals with the analytic IMU
Jacobian.  Residuals are in units of lidar_m, as in the reference.
State per frame (15,): [P, phi, V, bg, ba].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import lie
from ..ops import assoc, linalg3


class LineTargets(NamedTuple):
    p_l: torch.Tensor      # (K,3) point in lidar frame
    c: torch.Tensor        # (K,3) line centroid (world)
    u: torch.Tensor        # (K,3) unit line direction (world)
    valid: torch.Tensor    # (K,) bool


class PlaneTargets(NamedTuple):
    p_l: torch.Tensor        # (K,3)
    proj: torch.Tensor       # (K,3) projection of the point onto the plane
    sqrt_info: torch.Tensor  # (K,3,3)
    valid: torch.Tensor      # (K,) bool


StackBlocks = assoc.StackBlocks


_mv = lie.mv


def pose_wl(x6, Rbl, tbl):
    """World-from-lidar transform for state x6 (world-from-body P, phi)."""
    Rwb = lie.exp_matrix(x6[..., 3:6])
    Rwl = Rwb @ Rbl
    twl = _mv(Rwb, tbl) + x6[..., 0:3]
    return Rwl, twl


def _world_points(x6, p_l, Rbl, tbl):
    """World points (..., K, 3) of lidar points p_l (..., K, 3) at the
    poses x6 (..., 6) (leading axes: the lanes of a batch)."""
    Rwl, twl = pose_wl(x6, Rbl, tbl)
    return p_l @ Rwl.transpose(-1, -2) + twl[..., None, :]


# --------------------------------------------------------------------------
# association
# --------------------------------------------------------------------------

def _rescue_cap(M, frac):
    """Static local-rescue buffer size: ceil(M * frac) rounded up to 128."""
    mr = int(M * frac + 0.999)
    return min(M, max(128, (mr + 127) // 128 * 128))


def associate_lines(x6, p_l, mask, vm, Rbl, tbl, cfg, thres_dist,
                    vm_local=None, cached=None, with_blocks=False):
    """Corner association: 5-NN -> PCA line fit -> eigenvalue gate, with
    the local-map rescue of failed points (kernel K2,
    `assoc.associate_with_rescue`; see the reference).  Batched over
    lanes: x6 (B, 6), p_l (B, K, 3), maps (B, Cs, row), thres_dist (B,),
    each lane rescuing its own failed points, in one kernel pair."""
    pw = _world_points(x6, p_l, Rbl, tbl)
    r, blocks = assoc.associate_with_rescue(
        vm, vm_local, pw, mask, cfg.map, cfg.local_map, cfg.map.knn,
        assoc.LINE, thres_dist, 0.0,
        _rescue_cap(pw.shape[-2], cfg.solver.local_rescue_frac),
        cached=cached, want_blocks=with_blocks)
    lt = LineTargets(p_l=p_l, c=pw + r.mu, u=r.vec, valid=r.valid)
    return (lt, blocks) if with_blocks else lt


def _plane_basis(omega):
    """Orthonormal bases (..., K, 3, 3) with first row = omega (rows:
    normal, 2 tangents), batched over the leading axes."""
    ax = torch.abs(omega)
    dev, dt = omega.device, omega.dtype
    e = torch.eye(3, dtype=dt, device=dev)
    first = ((ax[..., 0] <= ax[..., 1]) & (ax[..., 0] <= ax[..., 2]))[..., None]
    second = (ax[..., 1] <= ax[..., 2])[..., None]
    seed = torch.where(first, e[0], torch.where(second, e[1], e[2]))
    t1 = lie.cross(omega, seed)
    t1 = t1 / torch.clamp(torch.sqrt(torch.sum(t1 * t1, dim=-1,
                                               keepdim=True)), min=1e-9)
    t2 = lie.cross(omega, t1)
    return torch.stack([omega, t1, t2], dim=-2)


def associate_planes(x6, p_l, mask, vm, Rbl, tbl, cfg, thres_dist,
                     weight_tan, vm_local=None, cached=None,
                     with_blocks=False):
    """Surf association: 5-NN -> TLS plane fit -> flatness gates, with the
    local-map rescue (kernel K2, `assoc.associate_with_rescue`).  Returns
    (PlaneTargets, normals, normal_valid) (+ blocks when with_blocks).
    Batched over lanes as `associate_lines`, weight_tan one per lane."""
    pw = _world_points(x6, p_l, Rbl, tbl)
    r, blocks = assoc.associate_with_rescue(
        vm, vm_local, pw, mask, cfg.map, cfg.local_map, cfg.map.knn,
        assoc.PLANE, thres_dist, cfg.solver.plane_scatter_ratio,
        _rescue_cap(pw.shape[-2], cfg.solver.local_rescue_frac),
        cached=cached, want_blocks=with_blocks)
    omega, valid = r.vec, r.valid
    dist = -torch.sum(omega * r.mu, dim=-1)
    proj = pw - dist[..., None] * omega

    basis = _plane_basis(omega)
    wt = (weight_tan.to(pw.dtype) if torch.is_tensor(weight_tan)
          else torch.full((), float(weight_tan), dtype=pw.dtype,
                          device=pw.device))
    w = torch.stack([torch.ones_like(wt), wt, wt], dim=-1)
    sqrt_info = w[..., None, :, None] * basis
    pt = PlaneTargets(p_l=p_l, proj=proj, sqrt_info=sqrt_info, valid=valid)
    return (pt, omega, valid, blocks) if with_blocks else (pt, omega, valid)


def localizability_ntn(NtN, n, cfg):
    """checkLocalizability from a normal Gram matrix (Estimator.cpp:536-565).
    Returns (is_degenerate, fail_detected, sv_min)."""
    evals = linalg3.eigvalsh3(NtN)
    sv_min = torch.sqrt(torch.clamp(evals[..., 0], min=0.0))
    too_few = n <= cfg.solver.min_plane_normals
    degenerate = (sv_min < 3.0) | too_few
    fail = (sv_min < cfg.solver.degenerate_sv) | too_few
    return degenerate, fail, torch.where(too_few, -torch.ones_like(sv_min),
                                         sv_min)


def localizability(normals, valid, cfg):
    """Min singular value of stacked plane normals (K, 3) over `valid`
    (K,): `localizability_ntn` over the Gram matrix of the valid ones."""
    w = normals * valid.to(normals.dtype)[..., None]
    NtN = w.transpose(-1, -2) @ w
    return localizability_ntn(NtN, torch.sum(valid, dim=-1), cfg)


# --------------------------------------------------------------------------
# residuals
# --------------------------------------------------------------------------

def _safe_norm(v, eps=1e-12):
    """|v| over the last axis with a finite gradient at v = 0: a residual
    passing exactly through zero would otherwise poison the normal
    equations with one NaN Jacobian row."""
    return torch.sqrt(torch.sum(v * v, dim=-1) + eps)


def _weight_denominator(pw):
    """|P|^(1/2) of the world points, floored (ceresfunc.h:433-437)."""
    return torch.sqrt(torch.clamp(torch.sqrt(torch.sum(pw * pw, dim=-1)),
                                  min=1e-6))


def line_residual(x6, tgt: LineTargets, Rbl, tbl):
    """Point-to-line residuals (K,) in lidar_m units
    (Cost_NavState_IMU_Line, ceresfunc.h:415-441): the distance to the
    line, reweighted by 1 - 0.9 |d| / |P|^(1/2)."""
    pw = _world_points(x6, tgt.p_l, Rbl, tbl)
    d = _safe_norm(lie.cross(pw - tgt.c, tgt.u))
    w = 1.0 - 0.9 * torch.abs(d) / _weight_denominator(pw)
    return torch.where(tgt.valid, w * d, torch.zeros_like(d))


def plane_residual(x6, tgt: PlaneTargets, Rbl, tbl):
    """Projected-point plane residuals (K, 3) in lidar_m units
    (Cost_NavState_IMU_Plan_Vec, ceresfunc.h:536-556)."""
    pw = _world_points(x6, tgt.p_l, Rbl, tbl)
    r0 = pw - tgt.proj
    w = 1.0 - 0.9 * _safe_norm(r0) / _weight_denominator(pw)
    r = _mv(tgt.sqrt_info, w[..., None] * r0)
    return torch.where(tgt.valid[..., None], r, torch.zeros_like(r))


def _imu_terms(xi, xj, meas, gravity):
    Pi, phii, Vi = xi[..., 0:3], xi[..., 3:6], xi[..., 6:9]
    Pj, phij, Vj = xj[..., 0:3], xj[..., 3:6], xj[..., 6:9]
    dbg = xi[..., 9:12] - meas["bg"]
    dba = xi[..., 12:15] - meas["ba"]
    Ri = lie.exp_matrix(phii)
    Rj = lie.exp_matrix(phij)
    RiT = Ri.transpose(-1, -2)
    dt = meas["dt"][..., None]
    dt2 = dt * dt
    jac = meas["jac"]
    J_p_bg, J_p_ba = jac[..., 0:3, 9:12], jac[..., 0:3, 12:15]
    J_r_bg = jac[..., 3:6, 9:12]
    J_v_bg, J_v_ba = jac[..., 6:9, 9:12], jac[..., 6:9, 12:15]
    u_p = Pj - Pi - Vi * dt - 0.5 * gravity * dt2
    rP = _mv(RiT, u_p) - (meas["dp"] + _mv(J_p_bg, dbg) + _mv(J_p_ba, dba))
    eps = _mv(J_r_bg, dbg)
    dR_corr = lie.quat_mul(meas["dq"], lie.exp_quat(eps))
    Mrel = lie.quat_to_matrix(lie.quat_conj(dR_corr)) @ RiT @ Rj
    rPhi = lie.log_matrix(Mrel)
    u_v = Vj - Vi - gravity * dt
    rV = _mv(RiT, u_v) - (meas["dv"] + _mv(J_v_bg, dbg) + _mv(J_v_ba, dba))
    r_raw = torch.cat([rP, rPhi, rV, xj[..., 9:15] - xi[..., 9:15]], dim=-1)
    return dict(Ri=Ri, Rj=Rj, RiT=RiT, dt=dt, J_p_bg=J_p_bg, J_p_ba=J_p_ba,
                J_r_bg=J_r_bg, J_v_bg=J_v_bg, J_v_ba=J_v_ba, u_p=u_p,
                u_v=u_v, eps=eps, M=Mrel, rPhi=rPhi, r_raw=r_raw,
                phii=phii, phij=phij)


def imu_residual(xi, xj, meas, gravity):
    """15-dim preintegration residual (Cost_NavState_PRV_Bias,
    ceresfunc.h:330-375), left-multiplied by the scaled sqrt-info; the
    residual `imu_residual_and_jac` returns beside its Jacobian."""
    return _mv(meas["sqrt_info"], _imu_terms(xi, xj, meas, gravity)["r_raw"])


def imu_residual_and_jac(xi, xj, meas, gravity):
    """Preintegration residual AND its analytic (15, 30) Jacobian over
    [Pi, phii, Vi, bgi, bai, Pj, phij, Vj, bgj, baj]; broadcasts over
    leading dims (see the reference for the derivation)."""
    t = _imu_terms(xi, xj, meas, gravity)
    dtype, dev = xi.dtype, xi.device
    lead = tuple(xi.shape[:-1])
    RiT, Ri, Rj, Mrel = t["RiT"], t["Ri"], t["Rj"], t["M"]
    dt = t["dt"][..., None]
    Jr_i = lie.right_jacobian(t["phii"])
    Jr_j = lie.right_jacobian(t["phij"])
    Jinv = lie.right_jacobian_inv(t["rPhi"])
    Z3 = torch.zeros(lead + (3, 3), dtype=dtype, device=dev)
    I6 = torch.eye(6, dtype=dtype, device=dev).expand(lead + (6, 6))
    Z69 = torch.zeros(lead + (6, 9), dtype=dtype, device=dev)
    T = lambda a: a.transpose(-1, -2)

    rowP = torch.cat(
        [-RiT, lie.hat(_mv(RiT, t["u_p"])) @ Jr_i, -RiT * dt, -t["J_p_bg"],
         -t["J_p_ba"], RiT, Z3, Z3, Z3, Z3], dim=-1)
    rowR = torch.cat(
        [Z3, -Jinv @ T(Rj) @ Ri @ Jr_i, Z3,
         -Jinv @ T(Mrel) @ lie.right_jacobian(t["eps"]) @ t["J_r_bg"], Z3,
         Z3, Jinv @ Jr_j, Z3, Z3, Z3], dim=-1)
    rowV = torch.cat(
        [Z3, lie.hat(_mv(RiT, t["u_v"])) @ Jr_i, -RiT, -t["J_v_bg"],
         -t["J_v_ba"], Z3, Z3, RiT, Z3, Z3], dim=-1)
    rowB = torch.cat([Z69, -I6, Z69, I6], dim=-1)
    J = torch.cat([rowP, rowR, rowV, rowB], dim=-2)
    S = meas["sqrt_info"]
    return _mv(S, t["r_raw"]), S @ J


def prior_residual(x0_kept, prior):
    """Marginalization prior replay: r = lin_r + lin_J (x - x_lin)."""
    return prior.lin_r + _mv(prior.lin_J, x0_kept - prior.x0)


def huber_weight(r_block_sq, delta):
    """sqrt(rho'(s)) for Ceres HuberLoss(delta) per residual block."""
    s = torch.clamp(r_block_sq, min=1e-20)
    return torch.where(s <= delta * delta, torch.ones_like(s),
                       torch.sqrt(delta / torch.sqrt(s)))
