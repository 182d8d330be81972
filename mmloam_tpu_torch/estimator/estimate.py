"""Estimator::Estimate orchestration — association rounds + LM solves
(port of mmloam_tpu/estimator/estimate.py:123-275), over the lanes of a
batch.

Every input carries a leading lane axis B, as the reference's `vmap`
runs it, and what the reference decides per lane stays per lane: the
full- or short-window schedule (thresholds, plane tangent weight, Huber
scale and LM caps are tensors (B,)), the old-slot refresh choice (a
stable descending sort per lane, ties to the lowest slot, as
`lax.top_k`; the chosen slot is read with a gather), the outer rounds
(a static range with `conv`, `fresh` and `odone` per lane) and the
marginalization.  The reference's `lax.cond`s run both branches for
every lane and select per lane: the refresh association runs every
round, its result taken where `do_refresh`.  With `one` (one lane) they
take one branch (`branch.cond`), as the reference's unbatched estimate
does; the marginalization stays unconditional, a select, as in the
reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import branch, spans
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


def select(m, a, b):
    """Per lane, `a` where m (B,) else `b`, over trees of lane-first
    tensors: the counterpart of a `lax.cond` under `vmap`."""
    def pick(x, y):
        return torch.where(m.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)
    return tree_map(pick, a, b)


def _rf_set_slot(rfs, rf, slot):
    """Write each lane's frame ReducedFactor rf (B, ...) into its slot
    (a number, or one per lane (B,)) of the (B, W)-stacked factors."""
    W = rfs.Q.shape[1]
    ar = torch.arange(W, device=rfs.Q.device)
    hit = (ar == slot if isinstance(slot, int) else ar == slot[:, None]
           ).reshape(-1, W)

    def put(a, v):
        m = hit.reshape(hit.shape + (1,) * (a.dim() - 2))
        return torch.where(m, v.to(a.dtype)[:, None], a)
    return tree_map(put, rfs, rf)


def _localizability_rfs(rfs, frame_valid, cfg):
    """checkLocalizability over the union of window frames' plane normals."""
    m = frame_valid.to(rfs.NtN.dtype)
    NtN = torch.sum(rfs.NtN * m[..., None, None], dim=-3)
    n = torch.sum(torch.where(frame_valid, rfs.n_normal,
                              torch.zeros_like(rfs.n_normal)), dim=-1)
    return factors.localizability_ntn(NtN, n, cfg)


def _at_slot(a, slot):
    """Each lane's window slot of a (B, W, ...): a number, or a gather of
    one slot per lane (B,)."""
    if isinstance(slot, int):
        return a[:, slot]
    return a[torch.arange(a.shape[0], device=a.device), slot]


def _assoc_frame(x, stacks: Stacks, slot, vm_corner, vm_surf, vm_lc, vm_ls,
                 vm_non, Rbl, tbl, cfg, thres, weight_tan, huber,
                 frame_valid, cached=None):
    """Each lane's window frame `slot` as a ReducedFactor at its current
    pose."""
    fstack = Stacks(*(None if a is None else _at_slot(a, slot)
                      for a in stacks))
    return reduced.build_reduced(
        _at_slot(x, slot)[:, :6], fstack, vm_corner, vm_surf, Rbl, tbl, cfg,
        thres, weight_tan, huber, _at_slot(frame_valid, slot),
        vm_local_corner=vm_lc, vm_local_surf=vm_ls, vm_non=vm_non,
        cached=cached)


def estimate(x0, stacks: Stacks, cached_rfs, vm_corner, vm_surf, preint,
             pair_valid, prior: solver.Prior, frame_valid, gravity, Rbl, tbl,
             cfg, full_window, refresh_slot, do_marginalize=None,
             vm_local_corner=None, vm_local_surf=None, vm_non=None,
             one=False):
    """One scan's window optimization of every lane (see the reference):
    x0 (B, W, 15), the window's stacks, factors, preintegration and prior
    (B, W, ...), maps (B, Cs, row), full_window and do_marginalize (B,)
    bool, refresh_slot (B,) int.  No host read: every branch is a select;
    with `one` (B == 1) every branch is a `branch.cond` instead.
    """
    s = cfg.solver
    B, W = x0.shape[:2]
    dtype, dev = x0.dtype, x0.device
    full = full_window.to(torch.bool).expand(B)
    marg = full if do_marginalize is None else (
        full & do_marginalize.to(torch.bool))
    by_window = lambda f, sh: torch.where(
        full, torch.full((B,), f, dtype=dtype, device=dev),
        torch.full((B,), sh, dtype=dtype, device=dev))

    sched_short = ([s.thres_dist_short, 10.0]
                   + [s.thres_dist] * max(s.max_outer_iters - 2, 0)
                   )[:max(s.max_outer_iters, 1)]
    sched = [by_window(s.thres_dist, v) for v in sched_short]
    weight_tan = by_window(s.plan_weight_tan, 0.0)
    huber = by_window(_HUBER_OFF, s.huber_delta_scale)

    vm_lc = vm_local_corner if cfg.use_local_map else None
    vm_ls = vm_local_surf if cfg.use_local_map else None
    vm_n = vm_non if cfg.use_nonfeature else None

    def assoc(x, slot, thres, cached=None):
        with spans.layer("association"):
            return _assoc_frame(x, stacks, slot, vm_corner, vm_surf, vm_lc,
                                vm_ls, vm_n, Rbl, tbl, cfg, thres,
                                weight_tan, huber, frame_valid,
                                cached=cached)

    # ---- round 0: newest frame + stalest old slots ----
    rf_new, blkc = assoc(x0, W - 1, sched[0])
    rfs = _rf_set_slot(cached_rfs, rf_new, W - 1)
    n_old = min(s.refresh_old_frames, W - 1)
    if n_old > 0:
        moved = torch.sqrt(torch.sum(
            (x0[:, :W - 1, 0:3] - cached_rfs.o[:, :W - 1]) ** 2, dim=-1))
        empty = (cached_rfs.n_line + cached_rfs.n_plane)[:, :W - 1] == 0
        fv_old = frame_valid[:, :W - 1]
        tie = (torch.arange(W - 1, device=dev)
               == refresh_slot.reshape(-1, 1)).to(dtype) * 1e-3
        score = torch.where(fv_old, moved + 1e6 * (empty & fv_old).to(dtype)
                            + tie, torch.full_like(moved, float("-inf")))
        slots = torch.sort(score, dim=-1, descending=True,
                           stable=True).indices
        for j in range(n_old):
            rf_j, _ = assoc(x0, slots[:, j], sched[0])
            rfs = _rf_set_slot(rfs, rf_j, slots[:, j])
    deg, fail, sv = _localizability_rfs(rfs, frame_valid, cfg)

    conv_rot = math.radians(s.converge_rot_deg)
    fvf = frame_valid.to(dtype)
    caps = ([s.max_inner_iters]
            + [s.max_inner_iters_later] * max(s.max_outer_iters - 2, 0)
            )[:max(s.max_outer_iters - 1, 0)]
    lane_cap = lambda f, sh: torch.where(
        full, torch.full((B,), f, dtype=torch.int32, device=dev),
        torch.full((B,), sh, dtype=torch.int32, device=dev))

    def solve(x, cap_full, cap_short, skip):
        return solver.lm_solve(x, rfs, preint, pair_valid, prior,
                               frame_valid, gravity, cfg,
                               lane_cap(cap_full, cap_short),
                               max(cap_full, cap_short), skip=skip, one=one)

    x = x0
    false = torch.zeros((B,), dtype=torch.bool, device=dev)
    conv, fresh, odone = false, ~false, false
    for rnd in range(1, s.max_outer_iters):
        refresh_flag = rnd < s.full_reassoc_rounds
        can_break = rnd >= s.full_reassoc_rounds
        res = solve(x, caps[rnd - 1], s.max_inner_iters,
                    (conv & ~fresh) | odone)
        dxr = res.x - x
        x = res.x
        conv = res.converged
        dt_rnd = torch.amax(torch.sqrt(torch.sum(dxr[..., 0:3] ** 2, dim=-1))
                            * fvf, dim=-1)
        dr_rnd = torch.amax(torch.sqrt(torch.sum(dxr[..., 3:6] ** 2, dim=-1))
                            * fvf, dim=-1)
        if can_break:
            odone = odone | (full & (dt_rnd < s.converge_trans)
                             & (dr_rnd < conv_rot))
        do_refresh = (~full | refresh_flag) & ~odone

        def reassociate(frozen, x=x, thres=sched[rnd]):
            rfs, deg, fail, sv = frozen
            rf_n, _ = assoc(x, W - 1, thres, cached=blkc)
            rfs_n = _rf_set_slot(rfs, rf_n, W - 1)
            deg_i, fail_i, sv_i = _localizability_rfs(rfs_n, frame_valid,
                                                      cfg)
            return rfs_n, deg | deg_i, fail | fail_i, sv_i

        # lax.cond(do_refresh, reassociate, frozen): at one lane one
        # branch, in the lockstep batch both and a select
        frozen = (rfs, deg, fail, sv)
        if one:
            rfs, deg, fail, sv = branch.cond(do_refresh, reassociate, None,
                                             frozen)
        else:
            rfs, deg, fail, sv = select(do_refresh, reassociate(frozen),
                                        frozen)
        fresh = do_refresh

    res = solve(x, s.max_inner_iters_later, s.max_inner_iters,
                (conv & ~fresh) | odone)
    x = res.x

    rf0 = tree_map(lambda a: a[:, 0], rfs)
    new_prior = select(marg, solver.marginalize(x, rf0, preint, prior,
                                                gravity, cfg), prior)

    NtN = torch.sum(rfs.NtN * fvf[..., None, None], dim=1)
    zi = torch.zeros_like(rfs.n_line)
    return EstimateResult(
        x=x, degenerate=deg, fail=fail, sv_min=sv, prior=new_prior, rfs=rfs,
        n_line=torch.sum(torch.where(frame_valid, rfs.n_line, zi),
                         dim=-1).to(torch.int32),
        n_plane=torch.sum(torch.where(frame_valid, rfs.n_plane, zi),
                          dim=-1).to(torch.int32),
        NtN=NtN)
