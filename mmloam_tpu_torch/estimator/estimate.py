"""Estimator::Estimate orchestration — association rounds + LM solves
(port of mmloam_tpu/estimator/estimate.py:123-275).

The reference's `lax.scan` over outer rounds is a Python loop and its
`lax.cond`s are Python branches on per-lane flags (under `vmap` both are
pure masking, so per-lane values agree).  Full-window vs short-window mode,
the threshold schedule, the old-slot refresh priority (`lax.top_k`, here a
stable descending sort: ties go to the lowest slot), gather-free
re-association from the round-0 blocks and the outer convergence break
follow the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..tree import tree_map
from . import factors, reduced, solver

_HUBER_OFF = 1e12


class Stacks(NamedTuple):
    """Downsampled per-frame feature stacks in the lidar frame."""

    corner: torch.Tensor       # (W, Kc, 3)
    corner_mask: torch.Tensor  # (W, Kc)
    surf: torch.Tensor         # (W, Ks, 3)
    surf_mask: torch.Tensor    # (W, Ks)
    non: torch.Tensor = None
    non_mask: torch.Tensor = None
    corner_rel: torch.Tensor = None  # (W, Kc)
    surf_rel: torch.Tensor = None    # (W, Ks)
    non_rel: torch.Tensor = None


class EstimateResult(NamedTuple):
    x: torch.Tensor            # (W,15)
    degenerate: torch.Tensor   # () bool
    fail: torch.Tensor         # () bool
    sv_min: torch.Tensor       # ()
    prior: solver.Prior
    rfs: reduced.ReducedFactor  # (W,)
    n_line: torch.Tensor
    n_plane: torch.Tensor
    NtN: torch.Tensor          # (3,3)


def _rf_set_slot(rfs, rf, slot):
    """Write one frame's ReducedFactor into the (W,)-stacked factors."""
    def put(a, v):
        out = a.clone()
        out[slot] = v.to(a.dtype)
        return out
    return tree_map(put, rfs, rf)


def _localizability_rfs(rfs, frame_valid, cfg):
    """checkLocalizability over the union of window frames' plane normals."""
    m = frame_valid.to(rfs.NtN.dtype)
    NtN = torch.sum(rfs.NtN * m[:, None, None], dim=0)
    n = torch.sum(torch.where(frame_valid, rfs.n_normal,
                              torch.zeros_like(rfs.n_normal)))
    return factors.localizability_ntn(NtN, n, cfg)


def _assoc_frame(x, stacks: Stacks, slot, vm_corner, vm_surf, vm_lc, vm_ls,
                 vm_non, Rbl, tbl, cfg, thres, weight_tan, huber,
                 frame_valid, cached=None):
    """One window frame's ReducedFactor at its current pose."""
    fstack = Stacks(*(a[slot] if a is not None else None for a in stacks))
    return reduced.build_reduced(
        x[slot, :6], fstack, vm_corner, vm_surf, Rbl, tbl, cfg,
        thres, weight_tan, huber, frame_valid[slot],
        vm_local_corner=vm_lc, vm_local_surf=vm_ls, vm_non=vm_non,
        cached=cached)


def estimate(x0, stacks: Stacks, cached_rfs, vm_corner, vm_surf, preint,
             pair_valid, prior: solver.Prior, frame_valid, gravity, Rbl, tbl,
             cfg, full_window, refresh_slot, do_marginalize=None,
             vm_local_corner=None, vm_local_surf=None, vm_non=None):
    """One scan's window optimization (see the reference docstring)."""
    s = cfg.solver
    W = x0.shape[0]
    dtype, dev = x0.dtype, x0.device
    full = bool(full_window)
    marg_flag = full if do_marginalize is None else bool(do_marginalize)
    f32 = lambda v: torch.tensor(v, dtype=dtype, device=dev)

    sched_short = ([s.thres_dist_short, 10.0]
                   + [s.thres_dist] * max(s.max_outer_iters - 2, 0)
                   )[:max(s.max_outer_iters, 1)]
    sched = [f32(v) for v in ([s.thres_dist] * s.max_outer_iters
                              if full else sched_short)]
    weight_tan = f32(s.plan_weight_tan if full else 0.0)
    huber = f32(_HUBER_OFF if full else s.huber_delta_scale)

    vm_lc = vm_local_corner if cfg.use_local_map else None
    vm_ls = vm_local_surf if cfg.use_local_map else None
    vm_n = vm_non if cfg.use_nonfeature else None

    def assoc(x, slot, thres, cached=None):
        return _assoc_frame(x, stacks, slot, vm_corner, vm_surf, vm_lc,
                            vm_ls, vm_n, Rbl, tbl, cfg, thres, weight_tan,
                            huber, frame_valid, cached=cached)

    # ---- round 0: newest frame + stalest old slots ----
    rf_new, blkc = assoc(x0, W - 1, sched[0])
    rfs = _rf_set_slot(cached_rfs, rf_new, W - 1)
    n_old = min(s.refresh_old_frames, W - 1)
    if n_old > 0:
        moved = torch.sqrt(torch.sum(
            (x0[:W - 1, 0:3] - cached_rfs.o[:W - 1]) ** 2, dim=-1))
        empty = (cached_rfs.n_line + cached_rfs.n_plane)[:W - 1] == 0
        fv_old = frame_valid[:W - 1]
        tie = (torch.arange(W - 1, device=dev) == refresh_slot).to(dtype) \
            * 1e-3
        score = torch.where(fv_old, moved + 1e6 * (empty & fv_old).to(dtype)
                            + tie, torch.full_like(moved, float("-inf")))
        slots = torch.sort(score, descending=True, stable=True).indices
        for j in range(n_old):
            slot = int(slots[j])
            rf_j, _ = assoc(x0, slot, sched[0])
            rfs = _rf_set_slot(rfs, rf_j, slot)
    deg, fail, sv = _localizability_rfs(rfs, frame_valid, cfg)

    conv_rot = math.radians(s.converge_rot_deg)
    fvf = frame_valid.to(dtype)
    caps = ([s.max_inner_iters]
            + [s.max_inner_iters_later] * max(s.max_outer_iters - 2, 0)
            )[:max(s.max_outer_iters - 1, 0)]

    x = x0
    conv, fresh, odone = False, True, False
    for rnd in range(1, s.max_outer_iters):
        refresh_flag = rnd < s.full_reassoc_rounds
        can_break = rnd >= s.full_reassoc_rounds
        cap = caps[rnd - 1] if full else s.max_inner_iters
        res = solver.lm_solve(
            x, rfs, preint, pair_valid, prior, frame_valid, gravity,
            cfg, cap, skip=(conv and not fresh) or odone)
        dxr = res.x - x
        x = res.x
        conv = bool(res.converged)
        dt_rnd = torch.amax(torch.sqrt(torch.sum(dxr[:, 0:3] ** 2, dim=-1))
                            * fvf)
        dr_rnd = torch.amax(torch.sqrt(torch.sum(dxr[:, 3:6] ** 2, dim=-1))
                            * fvf)
        odone = odone or (can_break and full
                          and bool((dt_rnd < s.converge_trans)
                                   & (dr_rnd < conv_rot)))
        do_refresh = ((not full) or refresh_flag) and not odone
        if do_refresh:
            rf_n, _ = assoc(x, W - 1, sched[rnd], cached=blkc)
            rfs = _rf_set_slot(rfs, rf_n, W - 1)
            deg_i, fail_i, sv_i = _localizability_rfs(rfs, frame_valid, cfg)
            deg, fail, sv = deg | deg_i, fail | fail_i, sv_i
        fresh = do_refresh

    res = solver.lm_solve(x, rfs, preint, pair_valid, prior,
                          frame_valid, gravity, cfg,
                          s.max_inner_iters_later if full
                          else s.max_inner_iters,
                          skip=(conv and not fresh) or odone)
    x = res.x

    if full and marg_flag:
        rf0 = tree_map(lambda a: a[0], rfs)
        new_prior = solver.marginalize(x, rf0, preint, prior, gravity, cfg)
    else:
        new_prior = prior

    NtN = torch.sum(rfs.NtN * fvf[:, None, None], dim=0)
    zi = torch.zeros_like(rfs.n_line)
    return EstimateResult(
        x=x, degenerate=deg, fail=fail, sv_min=sv, prior=new_prior, rfs=rfs,
        n_line=torch.sum(torch.where(frame_valid, rfs.n_line, zi)
                         ).to(torch.int32),
        n_plane=torch.sum(torch.where(frame_valid, rfs.n_plane, zi)
                          ).to(torch.int32),
        NtN=NtN)
