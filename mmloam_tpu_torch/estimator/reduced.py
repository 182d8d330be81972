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
    """One frame's persistent-tier candidate blocks (corner/surf)."""

    corner: factors.StackBlocks
    surf: factors.StackBlocks
    non: factors.StackBlocks = None


def _vecR(R):
    """Column-major vec: z[3j + i] = R[i, j]."""
    return R.transpose(-1, -2).reshape(tuple(R.shape[:-2]) + (9,))


def _zvec(R, P, o):
    return torch.cat([_vecR(R), P - o], dim=-1)


def _accumulate(a, q_rel, S, valid, R0, P0_rel):
    """Σ BᵀB, Σ Bᵀr0, Σ|r0|² for factors r = S (R a + P' - q')."""
    m = valid.to(a.dtype)
    K = a.shape[0]
    Sm = S * m[:, None, None]
    BR = a[:, None, :, None] * Sm[:, :, None, :]        # (K, i, j, i')
    B = torch.cat([BR.reshape(K, 3, 9), Sm], dim=-1)    # (K, 3, 12)
    r0 = factors._mv(Sm, a @ R0.T + P0_rel[None, :] - q_rel)
    Bf = B.reshape(K * 3, 12)
    Q = Bf.T @ Bf
    g0 = Bf.T @ r0.reshape(K * 3)
    c0 = torch.sum(r0 * r0)
    return Q, g0, c0


def build_reduced(x6, stacks_frame, vm_corner, vm_surf, Rbl, tbl, cfg,
                  thres_dist, weight_tan, huber_delta, frame_ok,
                  vm_local_corner=None, vm_local_surf=None,
                  vm_non=None, cached: BlocksCache = None):
    """Associate one frame's stacks and compress into a ReducedFactor.

    Returns (ReducedFactor, BlocksCache); passing the cache back via
    `cached` re-associates from the same persistent-map stencil rows.
    """
    if vm_non is not None:
        raise NotImplementedError("use_nonfeature is not ported")
    dtype = x6.dtype
    cpts, cmask = stacks_frame.corner, stacks_frame.corner_mask & frame_ok
    spts, smask = stacks_frame.surf, stacks_frame.surf_mask & frame_ok

    lt, blk_c = factors.associate_lines(
        x6, cpts, cmask, vm_corner, Rbl, tbl, cfg, thres_dist,
        vm_local=vm_local_corner,
        cached=None if cached is None else cached.corner, with_blocks=True)
    pt, omega, nvalid, blk_s = factors.associate_planes(
        x6, spts, smask, vm_surf, Rbl, tbl, cfg, thres_dist, weight_tan,
        vm_local=vm_local_surf,
        cached=None if cached is None else cached.surf, with_blocks=True)

    R0w, t0w = factors.pose_wl(x6, Rbl, tbl)
    Rwb0 = lie.exp_matrix(x6[3:6])
    P0 = x6[0:3]
    o = P0

    # line factors as 3-dim projected residuals
    a_l = cpts @ Rbl.T + tbl[None, :]
    pw_l = cpts @ R0w.T + t0w[None, :]
    d_l = lie.cross(pw_l - lt.c, lt.u)
    dist_l = torch.sqrt(torch.sum(d_l * d_l, dim=-1) + 1e-12)
    pn_l = torch.clamp(torch.sqrt(torch.sum(pw_l * pw_l, dim=-1)), min=1e-6)
    w_l = 1.0 - 0.9 * dist_l / torch.sqrt(pn_l)
    w_l = w_l * factors.huber_weight((w_l * dist_l) ** 2, huber_delta)
    S_l = ((torch.eye(3, dtype=dtype, device=x6.device)[None]
            - lt.u[:, :, None] * lt.u[:, None, :]) * w_l[:, None, None])
    Ql, gl, cl = _accumulate(a_l, lt.c - o[None, :], S_l, lt.valid, Rwb0,
                             P0 - o)

    # plane factors
    a_p = spts @ Rbl.T + tbl[None, :]
    pw_p = spts @ R0w.T + t0w[None, :]
    r0_p = pw_p - pt.proj
    pn_p = torch.clamp(torch.sqrt(torch.sum(pw_p * pw_p, dim=-1)), min=1e-6)
    w_p = 1.0 - 0.9 * torch.sqrt(torch.sum(r0_p * r0_p, dim=-1) + 1e-12) \
        / torch.sqrt(pn_p)
    rw = factors._mv(pt.sqrt_info, w_p[:, None] * r0_p)
    w_p = w_p * factors.huber_weight(torch.sum(rw * rw, dim=-1), huber_delta)
    S_p = pt.sqrt_info * w_p[:, None, None]
    Qp, gp, cp = _accumulate(a_p, pt.proj - o[None, :], S_p, pt.valid, Rwb0,
                             P0 - o)

    m = nvalid.to(dtype)
    om = omega * m[:, None]
    rf = ReducedFactor(
        Q=Ql + Qp, g0=gl + gp, c0=cl + cp,
        z0=_zvec(Rwb0, P0, o), o=o, NtN=om.T @ om,
        n_line=torch.sum(lt.valid).to(torch.int32),
        n_plane=torch.sum(pt.valid).to(torch.int32),
        n_normal=torch.sum(nvalid).to(torch.int32))
    return rf, BlocksCache(corner=blk_c, surf=blk_s, non=None)


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
