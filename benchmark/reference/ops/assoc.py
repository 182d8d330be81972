"""Stencil association, plain (frozen copy of the port's `ops/assoc.py`
without its kernel K2): k-nearest selection, moments and the closed-form
line / plane fit of each query against one voxel map
(`associate_reference`), and the local-map rescue of the queries the
persistent map failed (`associate_with_rescue_reference`), in plain torch
over a batch's lanes.

`RECORD`, where a caller sets it to a list, receives the shapes of every
association call, `(B, M, mcfg, lcfg, rescue_cap, cached, want_blocks)`:
the work the port's kernel K2 has to do for the same step, which the
benchmark's roofline of K2 counts (`harness/work.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import lie
from . import linalg3, voxelmap

PLANE, LINE = 0, 1                 # mode numbers of the archived kernel
RECORD = None


def window_rows(mcfg):
    """S, the superrows of one query's stencil window."""
    nbx, nby, nbz = voxelmap._super_window(mcfg)
    return nbx * nby * nbz


def n_candidates(mcfg):
    """C = S cpr, the candidates of one query (the dense blocks' width)."""
    return window_rows(mcfg) * voxelmap._cpr(mcfg)


class StackBlocks(NamedTuple):
    """One stack's persistent-map dense candidate blocks, cached for
    gather-free re-association across outer rounds."""

    pw0: torch.Tensor   # (M,3) f32 query positions at gather time
    dxd: torch.Tensor   # (M,C) storage dtype
    dyd: torch.Tensor
    dzd: torch.Tensor
    d2d: torch.Tensor   # +inf at invalid lanes


class Assoc(NamedTuple):
    """Per-query association result against one map."""

    mu: torch.Tensor     # (M,3) mean offset of the selected centroids
    vec: torch.Tensor    # (M,3) plane normal / line direction (unit)
    valid: torch.Tensor  # (M,) bool: every gate passed
    t_k: torch.Tensor    # (M,) k-th smallest squared distance (inf: < k)
    n: torch.Tensor      # (M,) number of selected candidates


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------

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
    wf = (d2d <= t_k[..., None]).to(pw.dtype)
    dxf, dyf, dzf = (a.to(pw.dtype) for a in (dxd, dyd, dzd))
    red = lambda a: torch.sum(a, dim=-1)
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


def _per_query(thres, t_k):
    """Each lane's squared-distance gate (...,) against its t_k (..., M)."""
    return torch.as_tensor(thres, dtype=t_k.dtype,
                           device=t_k.device)[..., None]


def _line_fit(pw, mask, t_k, n, s1, s2, thres_dist, k):
    """PCA line fit + gates (Estimator.cpp:189-277).  Returns (Assoc,
    eigenvalues, [(gate quantity, threshold), ...])."""
    have5 = (n >= k) & (t_k < _per_query(thres_dist, t_k))
    nf = torch.clamp(n, min=1).to(pw.dtype)
    mu = s1 / nf[..., None]
    cov = s2 / nf[..., None, None] - mu[..., None, :] * mu[..., :, None]
    evals = linalg3.eigvalsh3(cov)
    u = linalg3.principal_eigvec3(cov, evals)
    line_like = evals[..., 2] > 3.0 * evals[..., 1]
    err0 = torch.sqrt(torch.sum(lie.cross(-mu, u) ** 2, dim=-1))
    valid = mask & have5 & line_like & (err0 > 1e-5)
    return (Assoc(mu, u, valid, t_k, n), evals,
            [(evals[..., 2], 3.0 * evals[..., 1]), (err0, 1e-5)])


def _plane_fit(pw, mask, t_k, n, s1, s2, blk, thres_dist, k, scatter_ratio):
    """Total-LS plane fit + gates (Estimator.cpp:617-696).  Returns (Assoc,
    scatter eigenvalues, [(gate quantity, threshold), ...])."""
    have5 = (n >= k) & (t_k < _per_query(thres_dist, t_k))
    nf = torch.clamp(n, min=1).to(pw.dtype)
    mu = s1 / nf[..., None]
    scov = s2 - nf[..., None, None] * mu[..., None, :] * mu[..., :, None]
    sev = linalg3.eigvalsh3(scov)
    omega = linalg3.smallest_eigvec3(scov, sev)
    dist = -torch.sum(omega * mu, dim=-1)
    dxd, dyd, dzd, wf = blk
    dev = wf * (dxd * omega[..., 0, None] + dyd * omega[..., 1, None]
                + dzd * omega[..., 2, None] + dist[..., None])
    max_dev = torch.amax(torch.abs(dev), dim=-1)
    planar = max_dev <= 0.2
    err0 = torch.abs(dist)
    gates = [(max_dev, 0.2), (err0, 1e-5)]
    if scatter_ratio > 0:
        planar = planar & (sev[..., 1] > scatter_ratio * sev[..., 2])
        gates.append((sev[..., 1], scatter_ratio * sev[..., 2]))
    valid = mask & have5 & planar & (err0 > 1e-5)
    return Assoc(mu, omega, valid, t_k, n), sev, gates


def _fit(mode, pw, mask, t_k, n, s1, s2, blk, thres_dist, k, scatter_ratio):
    if mode == LINE:
        return _line_fit(pw, mask, t_k, n, s1, s2, thres_dist, k)
    return _plane_fit(pw, mask, t_k, n, s1, s2, blk, thres_dist, k,
                      scatter_ratio)


def associate_reference(vm, pw, mask, mcfg, k, mode, thres_dist,
                        scatter_ratio=0.0, cached: StackBlocks = None):
    """Plain PyTorch version of the kernel on any device: returns
    (Assoc, StackBlocks of the persistent-map candidate blocks).  Plain
    torch over any leading axes (a batch's lanes): queries pw (..., M, 3),
    mask (..., M), maps (..., Cs, row), cached blocks (..., M, C), a gate
    thres_dist (...) a lane."""
    t_k, n, s1, s2, blk, blocks = _neighbor_moments(vm, pw, mask, mcfg, k,
                                                    cached)
    fit = _fit(mode, pw, mask, t_k, n, s1, s2, blk, thres_dist, k,
               scatter_ratio)
    return fit[0], blocks


# --------------------------------------------------------------------------
# the local-map rescue, plain version
# --------------------------------------------------------------------------

def _compact_indices(fail, Mr):
    """Indices of the first Mr True entries of each row of `fail` (..., M),
    padded with M."""
    M = fail.shape[-1]
    dev = fail.device
    pos = torch.cumsum(fail.to(torch.int32), dim=-1) - 1
    dst = torch.where(fail & (pos < Mr), pos, torch.full_like(pos, Mr))
    sel = torch.full(tuple(fail.shape[:-1]) + (Mr + 1,), M,
                     dtype=torch.int32, device=dev)
    src = torch.arange(M, dtype=torch.int32, device=dev).expand(fail.shape)
    return sel.scatter(-1, dst.to(torch.int64), src)[..., :Mr]


def _rows_index(idx, a):
    """idx (..., Mr) widened to index a (..., M, *rest) along its query
    axis (idx.dim() - 1)."""
    k = idx.dim() - 1
    rest = tuple(a.shape[k + 1:])
    return idx.to(torch.int64).reshape(tuple(idx.shape) + (1,) * len(rest)
                                       ).expand(tuple(idx.shape) + rest)


def _pad_row(a, k):
    pad = torch.zeros(tuple(a.shape[:k]) + (1,) + tuple(a.shape[k + 1:]),
                      dtype=a.dtype, device=a.device)
    return torch.cat([a, pad], dim=k)


def _take_fill(a, idx):
    """Rows idx (..., Mr) of a (..., M, *rest), lane by lane, with
    out-of-range idx (== M) reading zeros."""
    k = idx.dim() - 1
    return torch.gather(_pad_row(a, k), k, _rows_index(idx, a))


def _set_drop(a, idx, vals):
    """a.at[idx].set(vals, mode="drop") along a's query axis, lane by lane,
    with idx == M dropped."""
    k = idx.dim() - 1
    out = _pad_row(a, k).scatter(k, _rows_index(idx, a), vals.to(a.dtype))
    return out.narrow(k, 0, a.shape[k])


def associate_with_rescue_reference(vm, vm_local, pw, mask, mcfg, lcfg, k,
                                    mode, thres_dist, scatter_ratio,
                                    rescue_cap, cached: StackBlocks = None,
                                    want_blocks=False):
    """Plain version of `associate_with_rescue` on any device, factors'
    composition as the reference runs it: associate against the persistent
    map; compact the first `rescue_cap` failed queries (mask & ~valid, in
    index order), associate them against the local map, and scatter back
    those valid there (every failed query is tried when rescue_cap >= M).
    Returns (Assoc merged, StackBlocks of the persistent map or None)."""
    r, blocks = associate_reference(vm, pw, mask, mcfg, k, mode, thres_dist,
                                    scatter_ratio, cached)
    blocks = blocks if want_blocks or cached is not None else None
    if vm_local is None:
        return r, blocks
    M = pw.shape[-2]
    if rescue_cap >= M:
        r2, _ = associate_reference(vm_local, pw, mask, lcfg, k, mode,
                                    thres_dist, scatter_ratio)
        use2 = ~r.valid & r2.valid
        pick = lambda a, b: torch.where(
            use2.reshape(tuple(use2.shape) + (1,) * (a.dim() - use2.dim())),
            b, a)
        return Assoc(*map(pick, r, r2)), blocks
    sel = _compact_indices(mask & ~r.valid, rescue_cap)
    r2, _ = associate_reference(vm_local, _take_fill(pw, sel), sel < M, lcfg,
                                k, mode, thres_dist, scatter_ratio)
    sel_ok = torch.where(r2.valid, sel, torch.full_like(sel, M))
    return Assoc(*(_set_drop(a, sel_ok, b) for a, b in zip(r, r2))), blocks


def associate(vm, pw, mask, mcfg, k, mode, thres_dist, scatter_ratio=0.0,
              cached: StackBlocks = None, want_blocks=False):
    """Association of a batch's lanes against their own maps, without a
    rescue; returns (Assoc, StackBlocks or None)."""
    return associate_with_rescue(vm, None, pw, mask, mcfg, None, k, mode,
                                 thres_dist, scatter_ratio, 0, cached,
                                 want_blocks)


def associate_with_rescue(vm, vm_local, pw, mask, mcfg, lcfg, k, mode,
                          thres_dist, scatter_ratio, rescue_cap,
                          cached: StackBlocks = None, want_blocks=False):
    """`associate_with_rescue_reference`, its shapes noted in `RECORD`."""
    if RECORD is not None:
        RECORD.append((pw.shape[0], pw.shape[-2], mcfg,
                       None if vm_local is None else lcfg, int(rescue_cap),
                       cached is not None, bool(want_blocks)))
    return associate_with_rescue_reference(
        vm, vm_local, pw, mask, mcfg, lcfg, k, mode, thres_dist,
        scatter_ratio, rescue_cap, cached, want_blocks)
