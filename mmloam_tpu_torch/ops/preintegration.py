"""IMU preintegration on the manifold (port of
mmloam_tpu/ops/preintegration.py:51-282).

Same parallel formulation as the reference: quaternion prefix products
(`ops.scan.associative_scan`), prefix sums for dp/dv, and ONE tree
reduction over the affine error-propagation monoid for the bias Jacobian
and the covariance.  State order [P R V BG BA]; masked samples are exact
no-ops (dt forced to 0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import lie
from .scan import associative_scan


class PreintResult(NamedTuple):
    dq: torch.Tensor       # (4,) delta orientation quaternion (w,x,y,z)
    dp: torch.Tensor       # (3,) delta position
    dv: torch.Tensor       # (3,) delta velocity
    cov: torch.Tensor      # (15,15) covariance of [P R V BG BA]
    jac: torch.Tensor      # (15,15) bias Jacobian
    dtime: torch.Tensor    # () total integrated time
    bg: torch.Tensor       # (3,) linearization gyro bias
    ba: torch.Tensor       # (3,) linearization acc bias


def _noise_matrix(imu_cfg, dtype, device):
    d = torch.tensor([imu_cfg.gyr_n ** 2] * 3 + [imu_cfg.acc_n ** 2] * 3
                     + [imu_cfg.gyr_w ** 2] * 3 + [imu_cfg.acc_w ** 2] * 3,
                     dtype=dtype, device=device)
    return torch.diag(d)


def _quat_prefix(e):
    """Inclusive quaternion prefix products (log-depth)."""
    def comb(a, b):
        return (lie.quat_normalize(lie.quat_mul(a[0], b[0])),)
    return associative_scan(comb, (e,))[0]


def preintegrate(acc, gyr, dt, mask, bg, ba, imu_cfg) -> PreintResult:
    """Masked fixed-length preintegration (IMUIntegrator.cpp:108-166)."""
    dtype = acc.dtype
    dev = acc.device
    noise = _noise_matrix(imu_cfg, dtype, dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    M = acc.shape[0]

    dt_m = torch.where(mask, dt, torch.zeros((), dtype=dt.dtype,
                                             device=dev)).to(dtype)
    a = acc.to(dtype) * imu_cfg.gnorm - ba
    w = gyr.to(dtype) - bg
    w_dt = w * dt_m[:, None]
    dt2 = dt_m * dt_m

    e = lie.exp_quat(w_dt)
    pref = _quat_prefix(e)
    dq = pref[-1]
    q_before = torch.cat(
        [torch.tensor([[1.0, 0, 0, 0]], dtype=dtype, device=dev), pref[:-1]],
        dim=0)
    Rk = lie.quat_to_matrix(q_before)

    Ra = torch.einsum("kij,kj->ki", Rk, a)
    u = Ra * dt_m[:, None]
    dv_prefix = torch.cumsum(u, dim=0) - u
    dv = torch.sum(u, dim=0)
    dp = torch.sum(dv_prefix * dt_m[:, None] + 0.5 * Ra * dt2[:, None], dim=0)

    dR = lie.exp_matrix(w_dt)
    Jr = lie.right_jacobian(w_dt)
    a_hat = lie.hat(a)
    Ra_hat = Rk @ a_hat

    I3 = eye3.expand(M, 3, 3)
    Z3 = torch.zeros((M, 3, 3), dtype=dtype, device=dev)
    dt_c = dt_m[:, None, None]
    dt2_c = dt2[:, None, None]
    block_rows = [
        [I3, -0.5 * Ra_hat * dt2_c, I3 * dt_c, Z3, -0.5 * Rk * dt2_c],
        [Z3, dR.transpose(-1, -2), Z3, -Jr * dt_c, Z3],
        [Z3, -Ra_hat * dt_c, I3, Z3, -Rk * dt_c],
        [Z3, Z3, Z3, I3, Z3],
        [Z3, Z3, Z3, Z3, I3],
    ]
    A = torch.cat([torch.cat(row, dim=2) for row in block_rows], dim=1)
    eye15 = torch.eye(15, dtype=dtype, device=dev)
    A = torch.where(mask[:, None, None], A, eye15.expand(M, 15, 15))

    b_rows = [
        [Z3, 0.5 * Rk * dt2_c, Z3, Z3],
        [Jr * dt_c, Z3, Z3, Z3],
        [Z3, Rk * dt_c, Z3, Z3],
        [Z3, Z3, I3 * dt_c, Z3],
        [Z3, Z3, Z3, I3 * dt_c],
    ]
    B = torch.cat([torch.cat(row, dim=2) for row in b_rows], dim=1)

    # (3)+(4): one tree reduction over (J, C) with
    # combine((J1,C1),(J2,C2)) = (J2 J1, J2 C1 J2^T + C2); identity
    # elements pad odd levels (preintegration.py:131-165)
    BN = B @ noise
    J = A
    C = BN @ B.transpose(-1, -2)
    n = M
    while n > 1:
        if n % 2:
            J = torch.cat([J, eye15[None]], dim=0)
            C = torch.cat([C, torch.zeros((1, 15, 15), dtype=dtype,
                                          device=dev)], dim=0)
            n += 1
        Jp = J.reshape((n // 2, 2) + tuple(J.shape[1:]))
        Cp = C.reshape((n // 2, 2) + tuple(C.shape[1:]))
        J1, J2 = Jp[:, 0], Jp[:, 1]
        C1, C2 = Cp[:, 0], Cp[:, 1]
        J = J2 @ J1
        C = (J2 @ C1) @ J2.transpose(-1, -2) + C2
        n //= 2
    jac = J[0]
    cov = C[0]

    dtime = torch.sum(dt_m).to(dtype)
    return PreintResult(lie.quat_normalize(dq), dp, dv, cov, jac, dtime,
                        bg, ba)


def gyro_integrate(gyr, dt, mask):
    """Orientation-only integration (IMUIntegrator.cpp:90-106), log-depth."""
    dt_m = torch.where(mask, dt, torch.zeros((), dtype=dt.dtype,
                                             device=dt.device)).to(gyr.dtype)
    e = lie.exp_quat(gyr * dt_m[:, None])
    return lie.quat_normalize(_quat_prefix(e)[-1])


def average_acc(acc, mask, imu_cfg, max_count: int = 31):
    """Mean of the first <=31 valid samples, scaled by gnorm."""
    idx = torch.cumsum(mask.to(torch.int32), dim=0)
    take = mask & (idx <= max_count)
    n = torch.clamp(torch.sum(take.to(acc.dtype)), min=1.0)
    return (torch.sum(acc * take[:, None].to(acc.dtype), dim=0)
            * imu_cfg.gnorm / n)


def _nan_where_failed(X, info):
    """Where a batched factorization failed, poison the result with NaN —
    what the reference's jnp.linalg routines return instead of raising."""
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(X, float("nan")), X)


def inv(A):
    """Matrix inverse with NaN instead of an exception on singular input."""
    X, info = torch.linalg.inv_ex(A)
    return _nan_where_failed(X, info)


def cholesky(A):
    """Lower Cholesky factor with NaN instead of an exception."""
    L, info = torch.linalg.cholesky_ex(A)
    return _nan_where_failed(L, info)


def sqrt_info_from_cov(cov, eps: float = 1e-12):
    """Upper-triangular sqrt information chol(cov^-1)^T with a symmetric
    diagonal rescaling (see the reference's docstring)."""
    d = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1),
                               min=eps))
    S_inv = 1.0 / d
    C = cov * S_inv[..., :, None] * S_inv[..., None, :]
    n = cov.shape[-1]
    eye = torch.eye(n, dtype=cov.dtype, device=cov.device)
    C = C + eye * 1e-6
    C_inv = inv(C)
    C_inv = 0.5 * (C_inv + C_inv.transpose(-1, -2))
    L = cholesky(C_inv + eye * 1e-8)
    return L.transpose(-1, -2) * S_inv[..., None, :]
