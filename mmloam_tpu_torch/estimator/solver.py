"""Dense sliding-window Levenberg-Marquardt solver + Schur marginalization
(port of mmloam_tpu/estimator/solver.py), over the lanes of a batch.

The window's normal equations are block-tridiagonal (point factors bind
single frames, IMU pairs bind (j-1, j), the prior binds frame 0) and are
solved exactly by block-Thomas with pivot-free 15x15 Gauss-Jordan
inverses (`ops.damped_solve`: kernel K4 on the card, the plain chain on
the CPU).  Every function takes a leading lane axis B (x (B, W, 15)), as
the reference's `vmap` runs it: `lm_solve`'s `while_loop` becomes a loop
of a fixed cap (the largest lane's) with a done flag per lane, a lane that
has stopped keeping its carry, so each lane gets the iterates it would get
alone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import branch
from ..ops import eigh
from ..ops.damped_solve import damped_solve as _damped_solve
from . import factors, reduced


class Prior(NamedTuple):
    """Marginalization prior (kept-block linearization)."""

    lin_J: torch.Tensor   # (15,15)
    lin_r: torch.Tensor   # (15,)
    x0: torch.Tensor      # (15,) linearization point (oldest kept frame)
    valid: torch.Tensor   # () bool


def empty_prior(dtype=torch.float32, device=None) -> Prior:
    return Prior(lin_J=torch.zeros((15, 15), dtype=dtype, device=device),
                 lin_r=torch.zeros((15,), dtype=dtype, device=device),
                 x0=torch.zeros((15,), dtype=dtype, device=device),
                 valid=torch.zeros((), dtype=torch.bool, device=device))


def _point_blocks(x, rfs):
    """Per-frame 6x6 blocks from the reduced point factors."""
    H6, b6, cost = reduced.eval_reduced(x[..., :6], rfs)
    return H6, b6, torch.sum(cost, dim=-1)


def _imu_blocks(x, preint, pair_valid, gravity):
    """Per-pair 30x30 blocks of the IMU factors (pair j binds j-1, j)."""
    xi = torch.cat([torch.roll(x, 1, dims=-2), x], dim=-1)   # (B,W,30)
    r, J = factors.imu_residual_and_jac(xi[..., :15], xi[..., 15:], preint,
                                        gravity[..., None, :])
    m = pair_valid.to(x.dtype)
    r = r * m[..., None]
    J = J * m[..., None, None]
    JT = J.transpose(-1, -2)
    H30 = JT @ J
    b30 = factors._mv(JT, r)
    return H30, b30, torch.sum(0.5 * torch.sum(r * r, dim=-1), dim=-1)


def _prior_block(x, prior: Prior):
    r = factors.prior_residual(x[..., 0, :], prior)
    m = prior.valid.to(x.dtype)
    r = r * m[..., None]
    J = prior.lin_J * m[..., None, None]
    JT = J.transpose(-1, -2)
    return JT @ J, factors._mv(JT, r), 0.5 * torch.sum(r * r, dim=-1)


def _assemble_blocks(x, H6, b6, H30, b30, Hp, bp, frame_valid):
    """Block-tridiagonal normal equations: diag (B,W,15,15), up
    (B,W-1,15,15), b (B,W,15), invalid frames zeroed."""
    W = x.shape[-2]
    dtype = x.dtype
    H6e = torch.nn.functional.pad(H6, (0, 9, 0, 9))
    b6e = torch.nn.functional.pad(b6, (0, 9))
    diag, bs = [], []
    for i in range(W):
        blk, bv = H6e[..., i, :, :], b6e[..., i, :]
        if i >= 1:
            blk = blk + H30[..., i, 15:30, 15:30]
            bv = bv + b30[..., i, 15:30]
        if i + 1 < W:
            blk = blk + H30[..., i + 1, 0:15, 0:15]
            bv = bv + b30[..., i + 1, 0:15]
        if i == 0:
            blk = blk + Hp
            bv = bv + bp
        diag.append(blk)
        bs.append(bv)
    diag = torch.stack(diag, dim=-3)
    b = torch.stack(bs, dim=-2)
    up = H30[..., 1:, 0:15, 15:30]
    fv = frame_valid.to(dtype)
    diag = diag * fv[..., None, None]
    up = up * (fv[..., :-1] * fv[..., 1:])[..., None, None]
    b = b * fv[..., None]
    return diag, up, b


class SolveResult(NamedTuple):
    x: torch.Tensor          # (B,W,15)
    cost: torch.Tensor       # (B,)
    iters: torch.Tensor      # (B,) int32
    converged: torch.Tensor  # (B,) bool


def lm_solve(x0, rfs, preint, pair_valid, prior, frame_valid,
             gravity, cfg, caps, static_cap, skip=None, one=False):
    """Deferred-evaluation Levenberg-Marquardt over each lane's window
    with fixed associations (see the reference).

    `caps` is each lane's iteration cap (B,) int32 and `static_cap` the
    loop's bound, an int no smaller than any of them (the reference's
    while_loop under vmap runs until the last lane is done); a lane stops
    at its own cap or its own convergence and keeps its carry from then
    on.  `skip` (None or a bool per lane) makes a lane's solve a no-op
    that reports converged with cost 0, as the reference's pre-set done
    flag and zeroed blocks.  With `one` (one lane, B == 1) the solve runs
    as the reference's unbatched one: the blocks of a skipped solve are
    never evaluated, and an iteration runs only while the lane is live
    (`branch.cond`, `branch.loop`), with the lockstep iteration's ops, so
    the bits are the lockstep solve's at one lane."""
    dtype, dev = x0.dtype, x0.device
    B, W = x0.shape[:2]
    fvf = frame_valid.to(dtype)

    def blocks_at(x):
        H6, b6, cp = _point_blocks(x, rfs)
        H30, b30, ci = _imu_blocks(x, preint, pair_valid, gravity)
        Hp, bp, cpr = _prior_block(x, prior)
        Hd, Hu, b = _assemble_blocks(x, H6, b6, H30, b30, Hp, bp,
                                     frame_valid)
        return Hd, Hu, b, cp + ci + cpr

    def sel(m, a, b):
        return torch.where(m.reshape((B,) + (1,) * (a.dim() - 1)), a, b)

    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    if skip is not None:
        done = skip.to(torch.bool).expand(B)
    if skip is not None and one:
        # lax.cond(skip, zeros, blocks): a skipped solve reads no blocks
        z = lambda *s: torch.zeros((B,) + s, dtype=dtype, device=dev)
        Hd, Hu, b, cost = branch.cond(
            done, lambda _: (z(W, 15, 15), z(W - 1, 15, 15), z(W, 15), z()),
            lambda _: blocks_at(x0), None)
    else:
        Hd, Hu, b, cost = blocks_at(x0)
        if skip is not None:
            zero = lambda a: torch.zeros_like(a)
            Hd, Hu, b, cost = (sel(done, zero(a), a)
                               for a in (Hd, Hu, b, cost))
    lam = torch.full((B,), 1e-4, dtype=dtype, device=dev)
    radius = torch.full((B,), cfg.solver.init_radius, dtype=dtype,
                        device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)

    def live_at(it, carry):
        return ~carry[-1] & (it < caps)

    def iteration(it, live, carry):
        x, Hd, Hu, b, cost, lam, radius, iters, done = carry
        dx = _damped_solve(Hd, Hu, b, lam, radius)
        x_try = x + dx * fvf[..., None]
        Hd_t, Hu_t, b_t, new_cost = blocks_at(x_try)
        accept = new_cost < cost
        significant = (cost - new_cost) > 1e-7 * (1.0 + cost)
        take = live & accept
        x = sel(take, x_try, x)
        Hd = sel(take, Hd_t, Hd)
        Hu = sel(take, Hu_t, Hu)
        b = sel(take, b_t, b)
        cost = sel(take, new_cost, cost)
        lam = sel(live, torch.where(accept, torch.clamp(lam / 3.0, min=1e-9),
                                    lam * 4.0), lam)
        radius_n = torch.where(accept & significant,
                               torch.clamp(radius * 2.0, max=10.0),
                               torch.clamp(radius * 0.5, min=1e-5))
        radius = sel(live, radius_n, radius)
        dt_max = torch.amax(torch.sqrt(torch.sum(dx[..., 0:3] ** 2, dim=-1))
                            * fvf, dim=-1)
        dr_max = torch.amax(torch.sqrt(torch.sum(dx[..., 3:6] ** 2, dim=-1))
                            * fvf, dim=-1)
        conv = (accept & ~significant
                & (dt_max < cfg.solver.inner_converge_trans)
                & (dr_max < cfg.solver.inner_converge_rot))
        conv = conv | (radius_n <= 1e-5)
        iters = iters + live.to(torch.int32)
        done = done | (live & conv)
        return x, Hd, Hu, b, cost, lam, radius, iters, done

    carry = (x0, Hd, Hu, b, cost, lam, radius, iters, done)
    if one:
        carry = branch.loop(static_cap, live_at, iteration, carry)
    else:
        for it in range(static_cap):
            carry = iteration(it, live_at(it, carry), carry)
    x, cost, iters, done = carry[0], carry[4], carry[7], carry[8]
    return SolveResult(x=x, cost=cost, iters=iters, converged=done)


def _eigh(A):
    """Eigen-decomposition of symmetric A (..., n, n), fed identity where a
    lane's A is not finite (its result is NaN there, as the reference's
    eigh of such a matrix): an eigen-solver that fails to converge raises
    in torch, and the lanes the caller's select drops may hold anything.
    `ops.eigh.eigh` solves: the kernel K3 on the card, which reads nothing
    back on the host (torch.linalg.eigh reads its error flags there);
    torch.linalg.eigh on the CPU."""
    ok = torch.isfinite(A).all(dim=-1).all(dim=-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    As = torch.where(ok[..., None, None], A, eye.expand(A.shape))
    evals, evecs = eigh.eigh(As)
    nan = float("nan")
    return (torch.where(ok[..., None], evals, nan),
            torch.where(ok[..., None, None], evecs, nan))


def marginalize(x, rf0, preint, prior, gravity, cfg):
    """Schur-complement marginalization of each lane's frame 0 -> new
    15-dim prior (Estimator.cpp:1448-1567, relative eigen threshold)."""
    m_eps = cfg.solver.marg_eps
    dtype, dev = x.dtype, x.device
    B = x.shape[0]
    T = lambda a: a.transpose(-1, -2)
    mv = factors._mv

    Hp, bp, _ = _prior_block(x, prior)
    meas = {k: v[:, 1] for k, v in preint.items()}
    rI, JI = factors.imu_residual_and_jac(x[:, 0], x[:, 1], meas, gravity)
    w2 = (cfg.imu.lidar_m / cfg.solver.marg_point_sigma) ** 2
    H6, b6, _ = reduced.eval_reduced(x[:, 0, :6], rf0)
    # A = [Hp + w2 H6 on the kept frame-0 block] + JIᵀ JI, in the
    # reference's order of additions
    A = torch.zeros((B, 30, 30), dtype=dtype, device=dev)
    A = A + torch.nn.functional.pad(Hp, (0, 15, 0, 15))
    A = A + T(JI) @ JI
    A = A + torch.nn.functional.pad(w2 * H6, (0, 24, 0, 24))
    b = torch.zeros((B, 30), dtype=dtype, device=dev)
    b = b + torch.nn.functional.pad(bp, (0, 15))
    b = b + mv(T(JI), rI)
    b = b + torch.nn.functional.pad(w2 * b6, (0, 24))

    Amm = 0.5 * (A[:, 0:15, 0:15] + T(A[:, 0:15, 0:15]))
    evals, evecs = _eigh(Amm)
    eps = m_eps * torch.clamp(torch.amax(evals, dim=-1), min=1e-12)
    eps = eps[..., None]
    inv = torch.where(evals > eps, 1.0 / torch.maximum(evals, eps),
                      torch.zeros_like(evals))
    Amm_inv = (evecs * inv[..., None, :]) @ T(evecs)
    Arm = A[:, 15:30, 0:15]
    A_star = A[:, 15:30, 15:30] - Arm @ Amm_inv @ A[:, 0:15, 15:30]
    b_star = b[:, 15:30] - mv(Arm @ Amm_inv, b[:, 0:15])

    evals2, evecs2 = _eigh(0.5 * (A_star + T(A_star)))
    eps2 = m_eps * torch.clamp(torch.amax(evals2, dim=-1), min=1e-12)
    keep = evals2 > eps2[..., None]
    S_sqrt = torch.where(keep, torch.sqrt(torch.clamp(evals2, min=0.0)),
                         torch.zeros_like(evals2))
    S_inv_sqrt = torch.where(keep, 1.0 / torch.clamp(S_sqrt, min=1e-20),
                             torch.zeros_like(S_sqrt))
    lin_J = S_sqrt[..., :, None] * T(evecs2)
    lin_r = S_inv_sqrt * mv(T(evecs2), b_star)
    return Prior(lin_J=lin_J, lin_r=lin_r, x0=x[:, 1],
                 valid=torch.ones((B,), dtype=torch.bool, device=dev))
