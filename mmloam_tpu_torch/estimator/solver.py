"""Dense sliding-window Levenberg-Marquardt solver + Schur marginalization
(port of mmloam_tpu/estimator/solver.py).

The window's normal equations are block-tridiagonal (point factors bind
single frames, IMU pairs bind (j-1, j), the prior binds frame 0) and are
solved exactly by block-Thomas with pivot-free 15x15 Gauss-Jordan
inverses.  `lm_solve`'s `while_loop` is a Python loop that reads the done
flag each iteration — under the reference's `vmap` the loop only masks
finished lanes, so per-lane values are the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
    H6, b6, cost = reduced.eval_reduced(x[:, :6], rfs)
    return H6, b6, torch.sum(cost)


def _imu_blocks(x, preint, pair_valid, gravity):
    """Per-pair 30x30 blocks of the IMU factors (pair j binds j-1, j)."""
    xi = torch.cat([torch.roll(x, 1, dims=0), x], dim=-1)     # (W,30)
    r, J = factors.imu_residual_and_jac(xi[:, :15], xi[:, 15:], preint,
                                        gravity)
    m = pair_valid.to(x.dtype)
    r = r * m[:, None]
    J = J * m[:, None, None]
    JT = J.transpose(-1, -2)
    H30 = JT @ J
    b30 = factors._mv(JT, r)
    return H30, b30, torch.sum(0.5 * torch.sum(r * r, dim=-1))


def _prior_block(x, prior: Prior):
    r = factors.prior_residual(x[0], prior)
    m = prior.valid.to(x.dtype)
    r = r * m
    J = prior.lin_J * m
    return J.T @ J, J.T @ r, 0.5 * torch.sum(r * r)


def _assemble_blocks(x, H6, b6, H30, b30, Hp, bp, frame_valid):
    """Block-tridiagonal normal equations: diag (W,15,15), up (W-1,15,15),
    b (W,15), invalid frames zeroed."""
    W = x.shape[0]
    dtype = x.dtype
    H6e = torch.nn.functional.pad(H6, (0, 9, 0, 9))
    b6e = torch.nn.functional.pad(b6, (0, 9))
    diag, bs = [], []
    for i in range(W):
        blk, bv = H6e[i], b6e[i]
        if i >= 1:
            blk = blk + H30[i, 15:30, 15:30]
            bv = bv + b30[i, 15:30]
        if i + 1 < W:
            blk = blk + H30[i + 1, 0:15, 0:15]
            bv = bv + b30[i + 1, 0:15]
        if i == 0:
            blk = blk + Hp
            bv = bv + bp
        diag.append(blk)
        bs.append(bv)
    diag = torch.stack(diag)
    b = torch.stack(bs)
    up = H30[1:, 0:15, 15:30]
    fv = frame_valid.to(dtype)
    diag = diag * fv[:, None, None]
    up = up * (fv[:-1] * fv[1:])[:, None, None]
    b = b * fv[:, None]
    return diag, up, b


def _gj_inv15(A):
    """Inverse by pivot-free Gauss-Jordan (safe: every matrix inverted is a
    Schur complement of the SPD damped system); batched over leading dims."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    aug = torch.cat([A, eye], dim=-1)
    for k in range(n):
        piv = aug[..., k, :] / aug[..., k, k:k + 1]
        aug = aug - aug[..., :, k:k + 1] * piv[..., None, :]
        aug[..., k, :] = piv
    return aug[..., :, n:]


def _block_thomas(diag, up, b):
    """Exact solve of the symmetric block-tridiagonal system."""
    W = diag.shape[0]
    Dinv = [None] * W
    y = [None] * W
    Dinv[0] = _gj_inv15(diag[0])
    y[0] = b[0]
    for i in range(1, W):
        L = up[i - 1].T @ Dinv[i - 1]
        Dinv[i] = _gj_inv15(diag[i] - L @ up[i - 1])
        y[i] = b[i] - L @ y[i - 1]
    x = [None] * W
    x[W - 1] = Dinv[W - 1] @ y[W - 1]
    for i in range(W - 2, -1, -1):
        x[i] = Dinv[i] @ (y[i] - up[i] @ x[i + 1])
    return torch.stack(x)


def _damped_solve(diag, up, b, lam, radius):
    """Solve (H + lam*diag(H)) dx = -b with per-group Jacobi scaling,
    unobservable dims frozen and the step capped at `radius`."""
    dtype, dev = diag.dtype, diag.device
    d15 = torch.diagonal(diag, dim1=-2, dim2=-1)            # (W,15)
    # per state-component group (P phi V bg ba), floored at 0 like the
    # reference's zeros.at[groups].max
    gmax = torch.clamp(torch.amax(d15, dim=0).reshape(5, 3).amax(dim=1),
                       min=0.0)
    d_floor15 = (1e-6 * torch.clamp(gmax, min=1e-12)).repeat_interleave(3)
    observable = d15 > d_floor15[None, :]
    s = torch.where(observable,
                    1.0 / torch.sqrt(torch.maximum(d15, d_floor15[None, :])),
                    torch.zeros_like(d15))
    diag_s = diag * s[:, :, None] * s[:, None, :]
    up_s = up * s[:-1, :, None] * s[1:, None, :]
    dd = (lam + 1e-5) + torch.where(observable, torch.zeros_like(d15),
                                    torch.ones_like(d15))
    A_diag = diag_s + dd[:, :, None] * torch.eye(15, dtype=dtype, device=dev)
    dx = s * _block_thomas(A_diag, up_s, -(b * s))
    dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
    nrm = torch.sqrt(torch.sum(dx * dx))
    return dx * torch.clamp(radius / torch.clamp(nrm, min=1e-12), max=1.0)


class SolveResult(NamedTuple):
    x: torch.Tensor          # (W,15)
    cost: torch.Tensor
    iters: torch.Tensor
    converged: torch.Tensor  # () bool


def lm_solve(x0, rfs, preint, pair_valid, prior, frame_valid,
             gravity, cfg, max_iters: int, skip=None):
    """Deferred-evaluation Levenberg-Marquardt over the window with fixed
    associations (see the reference).  `skip` (bool) makes the solve a
    no-op that reports converged, as the reference's pre-set done flag."""
    dtype, dev = x0.dtype, x0.device
    if skip is not None and bool(skip):
        return SolveResult(x=x0, cost=torch.zeros((), dtype=dtype, device=dev),
                           iters=torch.zeros((), dtype=torch.int32,
                                             device=dev),
                           converged=torch.ones((), dtype=torch.bool,
                                                device=dev))
    fvf = frame_valid.to(dtype)

    def blocks_at(x):
        H6, b6, cp = _point_blocks(x, rfs)
        H30, b30, ci = _imu_blocks(x, preint, pair_valid, gravity)
        Hp, bp, cpr = _prior_block(x, prior)
        Hd, Hu, b = _assemble_blocks(x, H6, b6, H30, b30, Hp, bp,
                                     frame_valid)
        return Hd, Hu, b, cp + ci + cpr

    x = x0
    Hd, Hu, b, cost = blocks_at(x0)
    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    radius = torch.tensor(cfg.solver.init_radius, dtype=dtype, device=dev)
    it = 0
    done = torch.zeros((), dtype=torch.bool, device=dev)
    while it < max_iters and not bool(done):
        dx = _damped_solve(Hd, Hu, b, lam, radius)
        x_try = x + dx * fvf[:, None]
        Hd_t, Hu_t, b_t, new_cost = blocks_at(x_try)
        accept = new_cost < cost
        significant = (cost - new_cost) > 1e-7 * (1.0 + cost)
        x = torch.where(accept, x_try, x)
        Hd = torch.where(accept, Hd_t, Hd)
        Hu = torch.where(accept, Hu_t, Hu)
        b = torch.where(accept, b_t, b)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-9), lam * 4.0)
        radius = torch.where(accept & significant,
                             torch.clamp(radius * 2.0, max=10.0),
                             torch.clamp(radius * 0.5, min=1e-5))
        dt_max = torch.amax(torch.sqrt(torch.sum(dx[:, 0:3] ** 2, dim=-1))
                            * fvf)
        dr_max = torch.amax(torch.sqrt(torch.sum(dx[:, 3:6] ** 2, dim=-1))
                            * fvf)
        conv = (accept & ~significant
                & (dt_max < cfg.solver.inner_converge_trans)
                & (dr_max < cfg.solver.inner_converge_rot))
        conv = conv | (radius <= 1e-5)
        it += 1
        done = done | conv
    return SolveResult(x=x, cost=cost,
                       iters=torch.tensor(it, dtype=torch.int32, device=dev),
                       converged=done)


def marginalize(x, rf0, preint, prior, gravity, cfg):
    """Schur-complement marginalization of frame 0 -> new 15-dim prior
    (Estimator.cpp:1448-1567, relative eigen threshold)."""
    m_eps = cfg.solver.marg_eps
    dtype, dev = x.dtype, x.device
    A = torch.zeros((30, 30), dtype=dtype, device=dev)
    b = torch.zeros((30,), dtype=dtype, device=dev)

    Hp, bp, _ = _prior_block(x, prior)
    A[0:15, 0:15] += Hp
    b[0:15] += bp

    meas = {k: v[1] for k, v in preint.items()}
    rI, JI = factors.imu_residual_and_jac(x[0], x[1], meas, gravity)
    A = A + JI.T @ JI
    b = b + JI.T @ rI

    w2 = (cfg.imu.lidar_m / cfg.solver.marg_point_sigma) ** 2
    H6, b6, _ = reduced.eval_reduced(x[0, :6], rf0)
    A[0:6, 0:6] += w2 * H6
    b[0:6] += w2 * b6

    Amm = 0.5 * (A[0:15, 0:15] + A[0:15, 0:15].T)
    evals, evecs = torch.linalg.eigh(Amm)
    eps = m_eps * torch.clamp(torch.amax(evals), min=1e-12)
    inv = torch.where(evals > eps, 1.0 / torch.maximum(evals, eps),
                      torch.zeros_like(evals))
    Amm_inv = (evecs * inv[None, :]) @ evecs.T
    Arm = A[15:30, 0:15]
    A_star = A[15:30, 15:30] - Arm @ Amm_inv @ A[0:15, 15:30]
    b_star = b[15:30] - Arm @ Amm_inv @ b[0:15]

    evals2, evecs2 = torch.linalg.eigh(0.5 * (A_star + A_star.T))
    eps2 = m_eps * torch.clamp(torch.amax(evals2), min=1e-12)
    keep = evals2 > eps2
    S_sqrt = torch.where(keep, torch.sqrt(torch.clamp(evals2, min=0.0)),
                         torch.zeros_like(evals2))
    S_inv_sqrt = torch.where(keep, 1.0 / torch.clamp(S_sqrt, min=1e-20),
                             torch.zeros_like(S_sqrt))
    lin_J = S_sqrt[:, None] * evecs2.T
    lin_r = S_inv_sqrt * (evecs2.T @ b_star)
    return Prior(lin_J=lin_J, lin_r=lin_r, x0=x[1],
                 valid=torch.ones((), dtype=torch.bool, device=dev))
