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
from ..ops import linalg3, voxelmap


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


class StackBlocks(NamedTuple):
    """One stack's persistent-map dense candidate blocks, cached for
    gather-free re-association across outer rounds."""

    pw0: torch.Tensor   # (M,3) f32 query positions at gather time
    dxd: torch.Tensor   # (M,C) storage dtype
    dyd: torch.Tensor
    dzd: torch.Tensor
    d2d: torch.Tensor   # +inf at invalid lanes


def _mv(A, v):
    """Batched matrix-vector product over leading dims."""
    return (A @ v[..., None])[..., 0]


def pose_wl(x6, Rbl, tbl):
    """World-from-lidar transform for state x6 (world-from-body P, phi)."""
    Rwb = lie.exp_matrix(x6[..., 3:6])
    Rwl = Rwb @ Rbl
    twl = _mv(Rwb, tbl) + x6[..., 0:3]
    return Rwl, twl


def _world_points(x6, p_l, Rbl, tbl):
    Rwl, twl = pose_wl(x6, Rbl, tbl)
    return p_l @ Rwl.transpose(-1, -2) + twl


# --------------------------------------------------------------------------
# association
# --------------------------------------------------------------------------

def _rescue_cap(M, frac):
    """Static local-rescue buffer size: ceil(M * frac) rounded up to 128."""
    mr = int(M * frac + 0.999)
    return min(M, max(128, (mr + 127) // 128 * 128))


def _compact_indices(fail, Mr):
    """Indices of the first Mr True entries of `fail` (M,), padded with M."""
    M = fail.shape[0]
    dev = fail.device
    pos = torch.cumsum(fail.to(torch.int32), dim=0) - 1
    dst = torch.where(fail & (pos < Mr), pos, torch.full_like(pos, Mr))
    sel = torch.full((Mr + 1,), M, dtype=torch.int32, device=dev)
    sel = sel.index_put((dst.to(torch.int64),),
                        torch.arange(M, dtype=torch.int32, device=dev))
    return sel[:Mr]


def _take_fill(a, idx):
    """a[idx] with out-of-range idx (== len(a)) reading zeros."""
    pad = torch.zeros((1,) + tuple(a.shape[1:]), dtype=a.dtype,
                      device=a.device)
    return torch.cat([a, pad])[idx.to(torch.int64)]


def _set_drop(a, idx, vals):
    """a.at[idx].set(vals, mode="drop") with idx == len(a) dropped."""
    pad = torch.zeros((1,) + tuple(a.shape[1:]), dtype=a.dtype,
                      device=a.device)
    out = torch.cat([a, pad]).index_put((idx.to(torch.int64),),
                                        vals.to(a.dtype))
    return out[:-1]


def _neighbor_moments(vm, pw, mask, mcfg, knn, cached: StackBlocks = None):
    """k-nearest selection + first/second moments of (centroid - query)
    over the dense candidate blocks.  Returns (t_k, n, s1 (M,3),
    s2 (M,3,3), blk = (dxf, dyf, dzf, wf), blocks)."""
    if cached is None:
        dxd, dyd, dzd, d2d = voxelmap.query_candidates_dense(vm, pw, mask,
                                                             mcfg)
        blocks = StackBlocks(pw, dxd, dyd, dzd, d2d)
    else:
        dxd, dyd, dzd, d2d = voxelmap.shift_dense_blocks(
            (cached.dxd, cached.dyd, cached.dzd, cached.d2d),
            pw - cached.pw0, mcfg)
        blocks = cached
    t_k = voxelmap.kth_smallest_dense(d2d, knn)
    wf = (d2d <= t_k[:, None]).to(pw.dtype)
    dxf, dyf, dzf = (a.to(pw.dtype) for a in (dxd, dyd, dzd))
    red = lambda a: torch.sum(a, dim=1)
    wx, wy, wz = dxf * wf, dyf * wf, dzf * wf
    s1 = torch.stack([red(wx), red(wy), red(wz)], dim=-1)
    sxx, syy, szz = red(wx * dxf), red(wy * dyf), red(wz * dzf)
    sxy, sxz, syz = red(wx * dyf), red(wx * dzf), red(wy * dzf)
    s2 = torch.stack([
        torch.stack([sxx, sxy, sxz], dim=-1),
        torch.stack([sxy, syy, syz], dim=-1),
        torch.stack([sxz, syz, szz], dim=-1)], dim=-2)
    n = red(wf)
    return t_k.to(pw.dtype), n, s1, s2, (dxf, dyf, dzf, wf), blocks


def _line_fit(pw, mask, t_k, n, s1, s2, thres_dist, k):
    """PCA line fit + gates (Estimator.cpp:189-277)."""
    have5 = (n >= k) & (t_k < thres_dist)
    nf = torch.clamp(n, min=1).to(pw.dtype)
    mu = s1 / nf[:, None]
    cov = s2 / nf[:, None, None] - mu[:, None, :] * mu[:, :, None]
    evals = linalg3.eigvalsh3(cov)
    u = linalg3.principal_eigvec3(cov, evals)
    line_like = evals[:, 2] > 3.0 * evals[:, 1]
    c = pw + mu
    err0 = torch.sqrt(torch.sum(lie.cross(-mu, u) ** 2, dim=-1))
    valid = mask & have5 & line_like & (err0 > 1e-5)
    return c, u, valid


def associate_lines(x6, p_l, mask, vm, Rbl, tbl, cfg, thres_dist,
                    vm_local=None, cached=None, with_blocks=False):
    """Corner association: 5-NN -> PCA line fit -> eigenvalue gate, with
    the local-map rescue of failed points (see the reference)."""
    pw = _world_points(x6, p_l, Rbl, tbl)
    k = cfg.map.knn
    M = pw.shape[0]

    def one_map_sub(vmi, mcfg, pwq, maskq, cac=None):
        t_k, n, s1, s2, _, blo = _neighbor_moments(vmi, pwq, maskq, mcfg, k,
                                                   cached=cac)
        return _line_fit(pwq, maskq, t_k, n, s1, s2, thres_dist, k) + (blo,)

    c, u, valid, blocks = one_map_sub(vm, cfg.map, pw, mask, cached)
    if vm_local is not None:
        Mr = _rescue_cap(M, cfg.solver.local_rescue_frac)
        if Mr >= M:
            c2, u2, valid2, _ = one_map_sub(vm_local, cfg.local_map, pw,
                                            mask)
            use2 = (~valid & valid2)[:, None]
            c = torch.where(use2, c2, c)
            u = torch.where(use2, u2, u)
            valid = valid | valid2
        else:
            sel = _compact_indices(mask & ~valid, Mr)
            pw_r = _take_fill(pw, sel)
            mask_r = sel < M
            c2, u2, valid2, _ = one_map_sub(vm_local, cfg.local_map, pw_r,
                                            mask_r)
            sel_ok = torch.where(valid2, sel, torch.full_like(sel, M))
            c = _set_drop(c, sel_ok, c2)
            u = _set_drop(u, sel_ok, u2)
            valid = _set_drop(valid, sel_ok, torch.ones_like(valid2))
    lt = LineTargets(p_l=p_l, c=c, u=u, valid=valid)
    return (lt, blocks) if with_blocks else lt


def _plane_basis(omega):
    """Orthonormal bases (K,3,3) with first row = omega (rows: normal, 2
    tangents), batched over K."""
    ax = torch.abs(omega)
    dev, dt = omega.device, omega.dtype
    e = torch.eye(3, dtype=dt, device=dev)
    first = ((ax[:, 0] <= ax[:, 1]) & (ax[:, 0] <= ax[:, 2]))[:, None]
    second = (ax[:, 1] <= ax[:, 2])[:, None]
    seed = torch.where(first, e[0], torch.where(second, e[1], e[2]))
    t1 = lie.cross(omega, seed)
    t1 = t1 / torch.clamp(torch.sqrt(torch.sum(t1 * t1, dim=-1,
                                               keepdim=True)), min=1e-9)
    t2 = lie.cross(omega, t1)
    return torch.stack([omega, t1, t2], dim=-2)


def _plane_fit(pw, mask, t_k, n, s1, s2, blk, thres_dist, k, cfg):
    """Total-LS plane fit + gates (Estimator.cpp:617-696)."""
    have5 = (n >= k) & (t_k < thres_dist)
    nf = torch.clamp(n, min=1).to(pw.dtype)
    mu = s1 / nf[:, None]
    scov = s2 - nf[:, None, None] * mu[:, None, :] * mu[:, :, None]
    sev = linalg3.eigvalsh3(scov)
    omega = linalg3.smallest_eigvec3(scov, sev)
    dist = -torch.sum(omega * mu, dim=-1)
    dxd, dyd, dzd, wf = blk
    dev = wf * (dxd * omega[:, 0, None] + dyd * omega[:, 1, None]
                + dzd * omega[:, 2, None] + dist[:, None])
    planar = torch.amax(torch.abs(dev), dim=1) <= 0.2
    if cfg.solver.plane_scatter_ratio > 0:
        planar = planar & (sev[:, 1] >
                           cfg.solver.plane_scatter_ratio * sev[:, 2])
    proj = pw - dist[:, None] * omega
    err0 = torch.abs(dist)
    valid = mask & have5 & planar & (err0 > 1e-5)
    return proj, omega, valid


def associate_planes(x6, p_l, mask, vm, Rbl, tbl, cfg, thres_dist,
                     weight_tan, vm_local=None, cached=None,
                     with_blocks=False):
    """Surf association: 5-NN -> TLS plane fit -> flatness gates, with
    the local-map rescue.  Returns (PlaneTargets, normals, normal_valid)
    (+ blocks when with_blocks)."""
    pw = _world_points(x6, p_l, Rbl, tbl)
    k = cfg.map.knn
    M = pw.shape[0]

    def one_map_sub(vmi, mcfg, pwq, maskq, cac=None):
        t_k, n, s1, s2, blk, blo = _neighbor_moments(vmi, pwq, maskq, mcfg,
                                                     k, cached=cac)
        return _plane_fit(pwq, maskq, t_k, n, s1, s2, blk, thres_dist, k,
                          cfg) + (blo,)

    proj, omega, valid, blocks = one_map_sub(vm, cfg.map, pw, mask, cached)
    if vm_local is not None:
        Mr = _rescue_cap(M, cfg.solver.local_rescue_frac)
        if Mr >= M:
            proj2, omega2, valid2, _ = one_map_sub(vm_local, cfg.local_map,
                                                   pw, mask)
            use2 = (~valid & valid2)[:, None]
            proj = torch.where(use2, proj2, proj)
            omega = torch.where(use2, omega2, omega)
            valid = valid | valid2
        else:
            sel = _compact_indices(mask & ~valid, Mr)
            pw_r = _take_fill(pw, sel)
            mask_r = sel < M
            proj2, omega2, valid2, _ = one_map_sub(vm_local, cfg.local_map,
                                                   pw_r, mask_r)
            sel_ok = torch.where(valid2, sel, torch.full_like(sel, M))
            proj = _set_drop(proj, sel_ok, proj2)
            omega = _set_drop(omega, sel_ok, omega2)
            valid = _set_drop(valid, sel_ok, torch.ones_like(valid2))

    basis = _plane_basis(omega)
    wt = torch.as_tensor(weight_tan, dtype=pw.dtype, device=pw.device)
    w = torch.stack([torch.ones_like(wt), wt, wt])
    sqrt_info = w[None, :, None] * basis
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


# --------------------------------------------------------------------------
# residuals
# --------------------------------------------------------------------------

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
