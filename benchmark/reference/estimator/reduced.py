"""Reduced (moment-compressed) point-factor blocks (port of
mmloam_tpu/estimator/reduced.py).

Each frame's point factors r_k = S_k (R a_k + P' - q'_k) are linear in
z = [vec(R) (9, col-major), P - o (3)], so their total cost, gradient and
GN Hessian are an exact quadratic in z, built once per association:
Q = Σ BᵀB (12x12), g0 = Σ Bᵀ r(z0), c0 = Σ |r(z0)|².  Each LM iteration
then needs only the 12x6 chain rule (`eval_reduced`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import lie
from . import factors


class ReducedFactor(NamedTuple):
    """One frame's point factors as an exact quadratic in z = [vecR, P-o];
    fields broadcast over leading batch axes (the window axis W)."""

    Q: torch.Tensor      # (12,12)
    g0: torch.Tensor     # (12,)
    c0: torch.Tensor     # ()
    z0: torch.Tensor     # (12,)
    o: torch.Tensor      # (3,)
    NtN: torch.Tensor    # (3,3) Σ ω ωᵀ of valid plane normals
    n_line: torch.Tensor    # () int32
    n_plane: torch.Tensor   # () int32
    n_normal: torch.Tensor  # () int32


def empty_reduced(dtype=torch.float32, device=None) -> ReducedFactor:
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    i0 = lambda: torch.zeros((), dtype=torch.int32, device=device)
    return ReducedFactor(
        Q=z(12, 12), g0=z(12), c0=z(),
        z0=torch.cat([torch.eye(3, dtype=dtype, device=device).reshape(-1),
                      z(3)]),
        o=z(3), NtN=z(3, 3), n_line=i0(), n_plane=i0(), n_normal=i0())


class BlocksCache(NamedTuple):
    """One frame's persistent-tier candidate blocks (corner/surf, and the
    non-feature stack's under cfg.use_nonfeature)."""

    corner: factors.StackBlocks
    surf: factors.StackBlocks
    non: factors.StackBlocks = None


def _vecR(R):
    """Column-major vec: z[3j + i] = R[i, j]."""
    return R.transpose(-1, -2).reshape(tuple(R.shape[:-2]) + (9,))


def _zvec(R, P, o):
    return torch.cat([_vecR(R), P - o], dim=-1)


def _accumulate(a, q_rel, S, valid, R0, P0_rel):
    """Σ BᵀB, Σ Bᵀr0, Σ|r0|² for factors r = S (R a + P' - q') over the
    K axis of a (..., K, 3) (leading axes: lanes)."""
    m = valid.to(a.dtype)
    lead, K = tuple(a.shape[:-2]), a.shape[-2]
    Sm = S * m[..., None, None]
    BR = a[..., :, None, :, None] * Sm[..., :, :, None, :]   # (.., K, i, j, i')
    B = torch.cat([BR.reshape(lead + (K, 3, 9)), Sm], dim=-1)  # (.., K, 3, 12)
    r0 = factors._mv(Sm, a @ R0.transpose(-1, -2) + P0_rel[..., None, :]
                     - q_rel)
    BfT = B.reshape(lead + (K * 3, 12)).transpose(-1, -2)   # (.., 12, 3K)
    # sums over the 3K rows per lane (lie.lane_sum), not matrix products
    Q = lie.lane_sum(BfT[..., :, None, :] * BfT[..., None, :, :])
    g0 = lie.mv(BfT, r0.reshape(lead + (K * 3,)))
    c0 = torch.sum(r0 * r0, dim=(-2, -1))
    return Q, g0, c0


def build_reduced(x6, stacks_frame, vm_corner, vm_surf, Rbl, tbl, cfg,
                  thres_dist, weight_tan, huber_delta, frame_ok,
                  vm_local_corner=None, vm_local_surf=None,
                  vm_non=None, cached: BlocksCache = None):
    """Associate one frame's stacks and compress into a ReducedFactor.

    Returns (ReducedFactor, BlocksCache); passing the cache back via
    `cached` re-associates from the same persistent-map stencil rows.
    `vm_non` adds the non-feature stack as zero-tangent plane factors
    (Cost_NonFeature_ICP), associated against `vm_non` alone: a K2 launch
    with no local-map rescue.  Batched over lanes: x6 (B, 6), the stacks
    (B, K, ...), maps (B, Cs, row), Rbl (B, 3, 3), thres_dist, weight_tan,
    huber_delta and frame_ok one per lane (B,); unbatched calls drop the
    lane axis throughout.
    """
    dtype = x6.dtype
    ok = frame_ok[..., None]
    cpts, cmask = stacks_frame.corner, stacks_frame.corner_mask & ok
    spts, smask = stacks_frame.surf, stacks_frame.surf_mask & ok
    hub = (huber_delta[..., None] if torch.is_tensor(huber_delta)
           else huber_delta)

    lt, blk_c = factors.associate_lines(
        x6, cpts, cmask, vm_corner, Rbl, tbl, cfg, thres_dist,
        vm_local=vm_local_corner,
        cached=None if cached is None else cached.corner, with_blocks=True)
    pt, omega, nvalid, blk_s = factors.associate_planes(
        x6, spts, smask, vm_surf, Rbl, tbl, cfg, thres_dist, weight_tan,
        vm_local=vm_local_surf,
        cached=None if cached is None else cached.surf, with_blocks=True)

    R0w, t0w = factors.pose_wl(x6, Rbl, tbl)
    Rwb0 = lie.exp_matrix(x6[..., 3:6])
    P0 = x6[..., 0:3]
    o = P0
    RblT, R0wT = Rbl.transpose(-1, -2), R0w.transpose(-1, -2)

    # line factors as 3-dim projected residuals
    a_l = cpts @ RblT + tbl[..., None, :]
    pw_l = cpts @ R0wT + t0w[..., None, :]
    d_l = lie.cross(pw_l - lt.c, lt.u)
    dist_l = torch.sqrt(torch.sum(d_l * d_l, dim=-1) + 1e-12)
    pn_l = torch.clamp(torch.sqrt(torch.sum(pw_l * pw_l, dim=-1)), min=1e-6)
    w_l = 1.0 - 0.9 * dist_l / torch.sqrt(pn_l)
    w_l = w_l * factors.huber_weight((w_l * dist_l) ** 2, hub)
    S_l = ((torch.eye(3, dtype=dtype, device=x6.device)
            - lt.u[..., :, None] * lt.u[..., None, :]) * w_l[..., None, None])
    Ql, gl, cl = _accumulate(a_l, lt.c - o[..., None, :], S_l, lt.valid,
                             Rwb0, P0 - o)

    # plane factors
    def plane_accum(ppts, ptgt):
        a_p = ppts @ RblT + tbl[..., None, :]
        pw_p = ppts @ R0wT + t0w[..., None, :]
        r0_p = pw_p - ptgt.proj
        pn_p = torch.clamp(torch.sqrt(torch.sum(pw_p * pw_p, dim=-1)),
                           min=1e-6)
        w_p = 1.0 - 0.9 * torch.sqrt(torch.sum(r0_p * r0_p, dim=-1)
                                     + 1e-12) / torch.sqrt(pn_p)
        rw = factors._mv(ptgt.sqrt_info, w_p[..., None] * r0_p)
        w_p = w_p * factors.huber_weight(torch.sum(rw * rw, dim=-1), hub)
        S_p = ptgt.sqrt_info * w_p[..., None, None]
        return _accumulate(a_p, ptgt.proj - o[..., None, :], S_p,
                           ptgt.valid, Rwb0, P0 - o)

    Qp, gp, cp = plane_accum(spts, pt)
    n_plane = torch.sum(pt.valid, dim=-1)

    blk_n = None
    if vm_non is not None and stacks_frame.non is not None:
        npts = stacks_frame.non
        nmask = stacks_frame.non_mask & ok
        ptn, _, _, blk_n = factors.associate_planes(
            x6, npts, nmask, vm_non, Rbl, tbl, cfg, thres_dist, 0.0,
            cached=None if cached is None else cached.non, with_blocks=True)
        Qn, gn, cn = plane_accum(npts, ptn)
        Qp, gp, cp = Qp + Qn, gp + gn, cp + cn
        n_plane = n_plane + torch.sum(ptn.valid, dim=-1)

    m = nvalid.to(dtype)
    om = omega * m[..., None]
    rf = ReducedFactor(
        Q=Ql + Qp, g0=gl + gp, c0=cl + cp,
        z0=_zvec(Rwb0, P0, o), o=o,
        NtN=lie.lane_sum(om[..., :, None] * om[..., None, :], dim=-3),
        n_line=torch.sum(lt.valid, dim=-1).to(torch.int32),
        n_plane=n_plane.to(torch.int32),
        n_normal=torch.sum(nvalid, dim=-1).to(torch.int32))
    return rf, BlocksCache(corner=blk_c, surf=blk_s, non=blk_n)


def eval_reduced(x6, rf: ReducedFactor):
    """(H6, b6, cost) of reduced factors at states x6; broadcasts over a
    leading window axis."""
    dtype, dev = x6.dtype, x6.device
    lead = tuple(x6.shape[:-1])
    phi = x6[..., 3:6]
    R = lie.exp_matrix(phi)
    Jr = lie.right_jacobian(phi)
    dz = _zvec(R, x6[..., 0:3], rf.o) - rf.z0
    Qdz = factors._mv(rf.Q, dz)
    gy = rf.g0 + Qdz
    cost = 0.5 * (rf.c0 + torch.sum((2.0 * rf.g0 + Qdz) * dz, dim=-1))

    e = torch.eye(3, dtype=dtype, device=dev)
    dvecR = torch.cat([-R @ lie.hat(e[j]) @ Jr for j in range(3)], dim=-2)
    top = torch.cat([torch.zeros(lead + (9, 3), dtype=dtype, device=dev),
                     dvecR], dim=-1)
    bot = torch.cat([e.expand(lead + (3, 3)),
                     torch.zeros(lead + (3, 3), dtype=dtype, device=dev)],
                    dim=-1)
    Z = torch.cat([top, bot], dim=-2)                   # (..., 12, 6)
    ZT = Z.transpose(-1, -2)
    b6 = factors._mv(ZT, gy)
    H6 = ZT @ rf.Q @ Z
    return H6, b6, cost
