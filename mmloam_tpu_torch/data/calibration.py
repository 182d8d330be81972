"""Sensor-rig calibration: lidar-to-lidar extrinsic and time offset (port
of mmloam_tpu/data/calibration.py).

* `icp_extrinsic` — point-to-plane Gauss-Newton ICP on SE(3) against a
  torus voxel map fitted to the destination cloud, with the GICP
  plane-to-plane weight, coarse-to-fine (the reference's startup GICP and
  its online re-refinement).  The reference's `lax.scan` over GN steps is
  a Python loop of the same fixed length; the 6x6 normal equations are
  solved by `torch.linalg.solve`.
* `align_startup` — several Horizon frames integrated, then one GICP
  against a Velodyne cloud (the rig is static during the integration).
* `estimate_time_offset` — the velo->hori clock offset over a grid: the
  Horizon points whose shifted stamps fall in the Velodyne scan interval
  are scored by their mean nearest-centroid distance.  Only the time mask
  depends on the offset, so one k-NN query of every point serves the whole
  grid, which is then scored in one batched evaluation.

The maps are built with `voxelmap.insert` (the plain scatter) and queried
by `voxelmap.query_knn` / `query_candidates`: calibration's (2,2,2)
stencil spans 2x2x3 superrows, not the association kernel's 8, so it runs
as plain torch.  Every entry point takes `device` (the card when None,
`pipeline.resolve_device`) and returns host values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import lie
from ..ops import linalg3, voxelmap
from ..pipeline import resolve_device


def _norm(a):
    return torch.sqrt(torch.sum(a * a, dim=-1))


def _crop(pts, mask, near=2.0, far=50.0):
    """removeNearFarPoints (lidars_extrinsic_cali.h:451-477)."""
    d = _norm(pts)
    return mask & (d >= near) & (d <= far)


def _gn_step(x, gate2, src, src_mask, vm, mcfg, src_normals, gicp_eps):
    """One Gauss-Newton step of `_icp_core` (the reference's `gn_step`).
    Returns (x, resid, weight sum)."""
    dtype = src.dtype
    R = lie.exp_matrix(x[3:6])
    t = x[0:3]
    pw = src @ R.T + t[None, :]
    nbr, nvalid, d2 = voxelmap.query_knn(vm, pw, src_mask, mcfg)
    k = mcfg.knn
    have = nvalid[:, k - 1] & (d2[:, k - 1] < gate2)
    # centered total-LS plane fit of the query-relative neighbours
    rel = nbr - pw[:, None, :]
    mu = torch.mean(rel, dim=1)
    cen = rel - mu[:, None, :]
    scov = torch.einsum("kij,kil->kjl", cen, cen)
    sev = linalg3.eigvalsh3(scov)
    omega = linalg3.smallest_eigvec3(scov, sev)
    pd_q = -torch.sum(omega * mu, dim=-1)
    planar = torch.all(
        torch.abs(torch.einsum("kij,kj->ki", cen, omega)) <= 0.2, dim=-1)
    w = (have & planar & src_mask).to(dtype)
    if src_normals is not None:
        ns_w = src_normals @ R.T
        cos2 = torch.sum(omega * ns_w, dim=-1) ** 2
        known = torch.sum(src_normals * src_normals, dim=-1) > 0.5
        wg = torch.sqrt((2.0 * gicp_eps) / (2.0 * gicp_eps + 1.0 - cos2))
        w = w * torch.where(known, wg, torch.ones_like(wg))
    r0 = pd_q
    # Huber(0.1 m) robust reweight (see the reference)
    w = w / torch.sqrt(torch.clamp(torch.abs(r0) / 0.1, min=1.0))
    r = r0 * w

    # d r / d[dt, dphi] under the left perturbation R <- exp(dphi) R
    J = torch.cat([omega, lie.cross(pw - t[None, :], omega)],
                  dim=-1) * w[:, None]
    H = J.T @ J
    eye = torch.eye(6, dtype=dtype, device=x.device)
    H = H + (1e-3 * torch.diag(torch.diagonal(H)) + 1e-6 * eye)
    g = J.T @ r
    dx = -torch.linalg.solve(H, g)
    Rn = lie.exp_matrix(dx[3:6]) @ lie.exp_matrix(x[3:6])
    x = torch.cat([x[0:3] + dx[0:3], lie.log_matrix(Rn)])
    resid = torch.sum(torch.abs(r)) / torch.clamp(torch.sum(w), min=1.0)
    return x, resid, torch.sum(w)


def _icp_core(src, src_mask, vm, x0, cfg, iters, src_normals=None,
              gicp_eps=0.05):
    """`iters` GN steps of point-to-plane ICP, GICP-weighted with
    `src_normals` (see the reference), under the annealed correspondence
    gate 2 m x 0.75^i, floored at 0.25 m.  Returns (x, resid, count) of
    the last step."""
    x = x0
    resid = count = None
    for i in range(iters):
        gate2 = max(2.0 * 0.75 ** i, 0.25) ** 2
        x, resid, count = _gn_step(x, gate2, src, src_mask, vm, cfg.map,
                                   src_normals, gicp_eps)
    return x, resid, count


def _fitted_map_config(map_cfg, pts, voxel, stencil=(2, 2, 2), mask=None,
                       max_cells=64_000_000):
    """Map config whose torus covers the cloud's bounding box alias-free
    (sized from the points `mask` selects, the ones that will be inserted;
    `max_cells` caps the allocation).  See the reference."""
    sel = np.isfinite(pts).all(axis=-1)
    if mask is not None:
        sel = sel & np.asarray(mask)
    if not sel.any():
        raise ValueError("no points selected for map sizing")
    span = np.ptp(pts[sel], axis=0) / voxel + 2 * (np.asarray(stencil) + 4)
    packs = (map_cfg.pack_x, map_cfg.pack_y, map_cfg.pack_z)
    dims = [int(-(-s // p)) * p for s, p in zip(span, packs)]
    n_cells = dims[0] * dims[1] * dims[2]
    if n_cells > max_cells:
        raise ValueError(
            f"fitted map would need {n_cells} cells (> {max_cells}): "
            f"cloud extent {np.ptp(pts[sel], axis=0)} m at voxel {voxel} m — "
            "crop the cloud or use a coarser voxel")
    return dataclasses.replace(
        map_cfg, voxel_size=voxel, dim_x=dims[0], dim_y=dims[1],
        dim_z=dims[2], stencil_x=stencil[0], stencil_y=stencil[1],
        stencil_z=stencil[2])


def _host(t):
    return t.detach().cpu().numpy()


def _cloud_normals(pts, mask, cfg, voxel):
    """Unit surface normals of a cloud from its own neighbourhoods (a fine
    map over the cloud, each point's stencil plane-fitted); zero rows
    where the fit fails."""
    mcfg = _fitted_map_config(cfg.map, _host(pts), voxel, stencil=(2, 2, 2),
                              mask=_host(mask))
    vm = voxelmap.insert(voxelmap.empty_map(mcfg, pts.device), pts, mask,
                         mcfg)
    _, n, s1, s2, _ = _moments(vm, pts, mask, mcfg)
    nf = torch.clamp(n, min=1).to(pts.dtype)
    mu = s1 / nf[:, None]
    scov = s2 - nf[:, None, None] * mu[:, None, :] * mu[:, :, None]
    sev = linalg3.eigvalsh3(scov)
    omega = linalg3.smallest_eigvec3(scov, sev)
    ok = (n >= 4) & (sev[:, 1] > 0.05 * sev[:, 2]) & mask
    return torch.where(ok[:, None], omega, torch.zeros_like(omega))


def _moments(vm, pw, mask, mcfg):
    """k-smallest selection and first/second moments of (centroid - query)
    over each query's stencil: (t_k, n, s1 (M,3), s2 (M,3,3), w)."""
    dx, dy, dz, d2, ok = voxelmap.query_candidates(vm, pw, mask, mcfg)
    t_k, n, w = voxelmap.select_k_smallest(d2, ok, mcfg.knn)
    wf = w.to(pw.dtype)
    red = lambda a: torch.sum(a * wf, dim=(1, 2))
    s1 = torch.stack([red(dx), red(dy), red(dz)], dim=-1)
    s2 = torch.stack([
        torch.stack([red(dx * dx), red(dx * dy), red(dx * dz)], dim=-1),
        torch.stack([red(dx * dy), red(dy * dy), red(dy * dz)], dim=-1),
        torch.stack([red(dx * dz), red(dy * dz), red(dz * dz)], dim=-1)],
        dim=-2)
    return t_k, n, s1, s2, w


def icp_extrinsic(src_pts, dst_pts, cfg, init_T=None, iters=30,
                  voxel=0.1, gicp=True, device=None):
    """Estimate T (4x4 numpy) aligning src onto dst (e.g. hori -> velo),
    on `device` (the card when None).  `gicp` adds the plane-to-plane
    weight.  Returns (T, mean_abs_residual, n_matches)."""
    dev = resolve_device(device)
    src = torch.as_tensor(np.asarray(src_pts, np.float32), device=dev)
    dst = torch.as_tensor(np.asarray(dst_pts, np.float32), device=dev)
    src_mask = _crop(src, torch.isfinite(src).all(dim=-1))
    dst_mask = _crop(dst, torch.isfinite(dst).all(dim=-1))

    src_normals = (_cloud_normals(src, src_mask, cfg, voxel)
                   if gicp else None)

    x0 = torch.zeros(6, dtype=torch.float32, device=dev)
    if init_T is not None:
        T = np.asarray(init_T, np.float64)
        x0 = torch.cat([
            torch.as_tensor(T[:3, 3], dtype=torch.float32, device=dev),
            lie.log_matrix(torch.as_tensor(T[:3, :3], dtype=torch.float32,
                                           device=dev))])

    # coarse-to-fine: a pass at 4x the leaf pulls the estimate into the
    # fine stencil's capture range first (see the reference)
    x = x0
    resid = n = None
    dst_np, dst_mask_np = np.asarray(dst_pts), _host(dst_mask)
    for lv_voxel, lv_iters in ((4.0 * voxel, max(iters // 2, 5)),
                               (voxel, iters)):
        mcfg = _fitted_map_config(cfg.map, dst_np, lv_voxel,
                                  stencil=(2, 2, 2), mask=dst_mask_np)
        vm = voxelmap.insert(voxelmap.empty_map(mcfg, dev), dst, dst_mask,
                             mcfg)
        x, resid, n = _icp_core(src, src_mask, vm, x, cfg.replace(map=mcfg),
                                lv_iters, src_normals=src_normals)
    T = np.eye(4)
    T[:3, :3] = _host(lie.exp_matrix(x[3:6]))
    T[:3, 3] = _host(x[0:3])
    return T, float(resid), int(n)


def align_startup(hori_frames, velo_cloud, cfg, init_T=None, iters=40,
                  voxel=0.08, device=None):
    """Startup extrinsic: integrate several Horizon frames (each (Ni, 3) in
    the Horizon frame, the rig static meanwhile), then one GICP against the
    Velodyne cloud.  Returns (T_hori_to_velo, resid, n_matches)."""
    ig = np.concatenate([np.asarray(f, np.float32) for f in hori_frames],
                        axis=0)
    return icp_extrinsic(ig, velo_cloud, cfg, init_T=init_T, iters=iters,
                         voxel=voxel, gicp=True, device=device)


def estimate_time_offset(hori_abs_t, hori_pts, velo_pts, velo_t0, velo_t1,
                         cfg, offsets, voxel=0.2, device=None):
    """Search the velo->hori time offset over the `offsets` grid: for each
    offset the Horizon points whose shifted stamps fall in [velo_t0,
    velo_t1) are scored by their mean nearest-centroid distance to the
    Velodyne cloud (gated at 2 voxels; a gated or missing match is charged
    the gate).  Returns (best_offset, scores (G,) numpy)."""
    dev = resolve_device(device)
    velo = torch.as_tensor(np.asarray(velo_pts, np.float32), device=dev)
    mcfg = _fitted_map_config(cfg.map, np.asarray(velo_pts), voxel,
                              stencil=(1, 1, 1))
    vm = voxelmap.insert(voxelmap.empty_map(mcfg, dev), velo,
                         torch.isfinite(velo).all(dim=-1), mcfg)
    hp = torch.as_tensor(np.asarray(hori_pts, np.float32), device=dev)
    ht = torch.as_tensor(np.asarray(hori_abs_t, np.float32), device=dev)
    gate = 2.0 * voxel

    # the query mask only gates a point's result, so the nearest centroid
    # of every point, queried once, serves every offset
    every = torch.ones(hp.shape[0], dtype=torch.bool, device=dev)
    _, nvalid, d2 = voxelmap.query_knn(vm, hp, every, mcfg)
    d = torch.sqrt(torch.where(nvalid[:, 0], d2[:, 0],
                               torch.full_like(d2[:, 0], float("inf"))))
    hit = nvalid[:, 0] & (d < gate)
    off = torch.as_tensor(np.asarray(offsets, np.float32), device=dev)
    shifted = ht[None, :] - off[:, None]                  # (G, N)
    m = (shifted >= velo_t0) & (shifted < velo_t1)
    ok = m & hit[None, :]
    zero = torch.zeros((), dtype=d.dtype, device=dev)
    tot = (torch.sum(torch.where(ok, d[None, :], zero), dim=1)
           + torch.sum(torch.where(m & ~ok, torch.full_like(zero, gate),
                                   zero), dim=1))
    scores = _host(tot / torch.clamp(torch.sum(m, dim=1), min=1))
    best = int(np.argmin(scores))
    return float(offsets[best]), scores
