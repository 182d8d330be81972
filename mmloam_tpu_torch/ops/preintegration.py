"""IMU preintegration on the manifold (port of
mmloam_tpu/ops/preintegration.py:51-282).

Same parallel formulation as the reference: quaternion prefix products
(`ops.scan.associative_scan`), prefix sums for dp/dv, and ONE tree
reduction over the affine error-propagation monoid for the bias Jacobian
and the covariance.  State order [P R V BG BA]; masked samples are exact
no-ops (dt forced to 0).
"""

from __future__ import annotations

import math
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
    d = ((imu_cfg.gyr_n ** 2,) * 3 + (imu_cfg.acc_n ** 2,) * 3
         + (imu_cfg.gyr_w ** 2,) * 3 + (imu_cfg.acc_w ** 2,) * 3)
    return torch.diag(lie.const(d, dtype, device))


def _quat_prefix(e):
    """Inclusive quaternion prefix products (log-depth)."""
    def comb(a, b):
        return (lie.quat_normalize(lie.quat_mul(a[0], b[0])),)
    return associative_scan(comb, (e,))[0]


def _sum_samples(x):
    """Sum over the sample axis (0) of x (M, ...), each lane's sum a
    contiguous row of its own: a reduction over the outer axis of x would
    vectorize across the lanes' outputs, and its rounding would then
    depend on how many lanes there are."""
    return torch.sum(x.movedim(0, -1).contiguous(), dim=-1)


def preintegrate(acc, gyr, dt, mask, bg, ba, imu_cfg) -> PreintResult:
    """Masked fixed-length preintegration (IMUIntegrator.cpp:108-166) of
    acc, gyr (..., M, 3), dt, mask (..., M) at biases bg, ba (..., 3); the
    leading axes (lanes, keyframes) are independent.  The sample axis goes
    first internally, so the scans and the tree reduction run along axis 0
    with the lanes as trailing batch axes."""
    dtype = acc.dtype
    dev = acc.device
    noise = _noise_matrix(imu_cfg, dtype, dev)
    M = acc.shape[-2]
    acc, gyr = acc.movedim(-2, 0), gyr.movedim(-2, 0)       # (M, ..., 3)
    dt, mask = dt.movedim(-1, 0), mask.movedim(-1, 0)       # (M, ...)

    dt_m = torch.where(mask, dt, torch.zeros((), dtype=dt.dtype,
                                             device=dev)).to(dtype)
    a = acc.to(dtype) * imu_cfg.gnorm - ba
    w = gyr.to(dtype) - bg
    w_dt = w * dt_m[..., None]
    dt2 = dt_m * dt_m

    e = lie.exp_quat(w_dt)
    pref = _quat_prefix(e)
    dq = pref[-1]
    ident = lie.const((1.0, 0.0, 0.0, 0.0), dtype, dev)
    q_before = torch.cat([ident.expand((1,) + tuple(pref.shape[1:])),
                          pref[:-1]], dim=0)
    Rk = lie.quat_to_matrix(q_before)

    Ra = torch.einsum("k...ij,k...j->k...i", Rk, a)
    u = Ra * dt_m[..., None]
    dv_prefix = torch.cumsum(u, dim=0) - u
    dv = _sum_samples(u)
    dp = _sum_samples(dv_prefix * dt_m[..., None] + 0.5 * Ra * dt2[..., None])

    dR = lie.exp_matrix(w_dt)
    Jr = lie.right_jacobian(w_dt)
    a_hat = lie.hat(a)
    Ra_hat = Rk @ a_hat

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    I3 = eye3.expand(Rk.shape)
    Z3 = torch.zeros(Rk.shape, dtype=dtype, device=dev)
    dt_c = dt_m[..., None, None]
    dt2_c = dt2[..., None, None]
    block_rows = [
        [I3, -0.5 * Ra_hat * dt2_c, I3 * dt_c, Z3, -0.5 * Rk * dt2_c],
        [Z3, dR.transpose(-1, -2), Z3, -Jr * dt_c, Z3],
        [Z3, -Ra_hat * dt_c, I3, Z3, -Rk * dt_c],
        [Z3, Z3, Z3, I3, Z3],
        [Z3, Z3, Z3, Z3, I3],
    ]
    A = torch.cat([torch.cat(row, dim=-1) for row in block_rows], dim=-2)
    eye15 = torch.eye(15, dtype=dtype, device=dev)
    A = torch.where(mask[..., None, None], A, eye15.expand(A.shape))

    b_rows = [
        [Z3, 0.5 * Rk * dt2_c, Z3, Z3],
        [Jr * dt_c, Z3, Z3, Z3],
        [Z3, Rk * dt_c, Z3, Z3],
        [Z3, Z3, I3 * dt_c, Z3],
        [Z3, Z3, Z3, I3 * dt_c],
    ]
    B = torch.cat([torch.cat(row, dim=-1) for row in b_rows], dim=-2)

    # (3)+(4): one tree reduction over (J, C) with
    # combine((J1,C1),(J2,C2)) = (J2 J1, J2 C1 J2^T + C2); identity
    # elements pad odd levels (preintegration.py:131-165)
    BN = B @ noise
    J = A
    C = BN @ B.transpose(-1, -2)
    n = M
    while n > 1:
        if n % 2:
            pad = (1,) + tuple(J.shape[1:])
            J = torch.cat([J, eye15.expand(pad)], dim=0)
            C = torch.cat([C, torch.zeros(pad, dtype=dtype, device=dev)],
                          dim=0)
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

    dtime = _sum_samples(dt_m).to(dtype)
    return PreintResult(lie.quat_normalize(dq), dp, dv, cov, jac, dtime,
                        bg, ba)


def preintegrate_sequential(acc, gyr, dt, mask, bg, ba,
                            imu_cfg) -> PreintResult:
    """The literal sequential transcription of IMUIntegrator.cpp:108-166,
    a loop over the samples of acc, gyr (..., M, 3), dt, mask (..., M):
    the ground truth `preintegrate`'s parallel formulation is tested
    against.  Masked samples leave the accumulators as they were."""
    dtype, dev = acc.dtype, acc.device
    noise = _noise_matrix(imu_cfg, dtype, dev)
    lead = tuple(acc.shape[:-2])
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    dq = lie.const((1.0, 0.0, 0.0, 0.0), dtype, dev).expand(lead + (4,))
    dp = torch.zeros(lead + (3,), dtype=dtype, device=dev)
    dv = torch.zeros_like(dp)
    cov = torch.zeros(lead + (15, 15), dtype=dtype, device=dev)
    jac = torch.eye(15, dtype=dtype, device=dev).expand(cov.shape)
    for k in range(acc.shape[-2]):
        m = mask[..., k]
        dt_i = torch.where(m, dt[..., k], torch.zeros_like(dt[..., k]))
        dt_i = dt_i.to(dtype)[..., None]
        a = acc[..., k, :] * imu_cfg.gnorm - ba
        w = gyr[..., k, :] - bg
        dt2 = dt_i * dt_i
        w_dt = w * dt_i
        dR = lie.exp_matrix(w_dt)
        Jr = lie.right_jacobian(w_dt)
        Rk = lie.quat_to_matrix(dq)
        Ra_hat = Rk @ lie.hat(a)
        s, s2 = dt_i[..., None], dt2[..., None]

        A = torch.eye(15, dtype=dtype, device=dev).repeat(lead + (1, 1))
        A[..., 0:3, 3:6] = -0.5 * Ra_hat * s2
        A[..., 0:3, 6:9] = eye3 * s
        A[..., 0:3, 12:15] = -0.5 * Rk * s2
        A[..., 3:6, 3:6] = dR.transpose(-1, -2)
        A[..., 3:6, 9:12] = -Jr * s
        A[..., 6:9, 3:6] = -Ra_hat * s
        A[..., 6:9, 12:15] = -Rk * s
        B = torch.zeros(lead + (15, 12), dtype=dtype, device=dev)
        B[..., 0:3, 3:6] = 0.5 * Rk * s2
        B[..., 3:6, 0:3] = Jr * s
        B[..., 6:9, 3:6] = Rk * s
        B[..., 9:12, 6:9] = eye3 * s
        B[..., 12:15, 9:12] = eye3 * s

        Ra = lie.mv(Rk, a)
        keep = m[..., None]
        jac = torch.where(keep[..., None], A @ jac, jac)
        cov = torch.where(keep[..., None], A @ cov @ A.transpose(-1, -2)
                          + B @ noise @ B.transpose(-1, -2), cov)
        dp = torch.where(keep, dp + dv * dt_i + 0.5 * Ra * dt2, dp)
        dv = torch.where(keep, dv + Ra * dt_i, dv)
        dq = torch.where(keep, lie.quat_normalize(
            lie.quat_mul(dq, lie.exp_quat(w_dt))), dq)
    dtime = torch.sum(torch.where(mask, dt, torch.zeros_like(dt)),
                      dim=-1).to(dtype)
    return PreintResult(dq, dp, dv, cov, jac, dtime, bg, ba)


def gyro_integrate(gyr, dt, mask):
    """Orientation-only integration (IMUIntegrator.cpp:90-106), log-depth,
    of gyr (..., M, 3), dt, mask (..., M)."""
    gyr, dt, mask = gyr.movedim(-2, 0), dt.movedim(-1, 0), mask.movedim(-1, 0)
    dt_m = torch.where(mask, dt, torch.zeros((), dtype=dt.dtype,
                                             device=dt.device)).to(gyr.dtype)
    e = lie.exp_quat(gyr * dt_m[..., None])
    return lie.quat_normalize(_quat_prefix(e)[-1])


def average_acc(acc, mask, imu_cfg, max_count: int = 31):
    """Mean of the first <=31 valid samples of acc (..., M, 3), scaled by
    gnorm."""
    idx = torch.cumsum(mask.to(torch.int32), dim=-1)
    take = mask & (idx <= max_count)
    n = torch.clamp(torch.sum(take.to(acc.dtype), dim=-1), min=1.0)
    return (torch.sum(acc * take[..., None].to(acc.dtype), dim=-2)
            * imu_cfg.gnorm / n[..., None])


def _nan_where_failed(X, info):
    """Where a batched factorization failed, poison the result with NaN —
    what the reference's jnp.linalg routines return instead of raising."""
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(X, float("nan")), X)


# torch's LU on the card factors a batch of square matrices wider than 16
# through cuBLAS's batched kernel only while the batch holds at most 16 of
# them (and they are at most 128 wide); a larger batch goes to MAGMA, whose
# batched factorization waits on the host, which a CUDA graph's capture
# refuses (the gravity refinement's (B, 18, 18) solve at B = 64)
LU_GROUP = 16


def lu_factor_groups(A):
    """`torch.linalg.lu_factor_ex(A)` with the batch factored `LU_GROUP`
    matrices at a time (each matrix is factored alone either way)."""
    n = A.shape[-1]
    lead = A.shape[:-2]
    flat = A.reshape(-1, n, n)
    parts = [torch.linalg.lu_factor_ex(flat[i:i + LU_GROUP])
             for i in range(0, flat.shape[0], LU_GROUP)]
    LU, piv, info = (torch.cat(p) for p in zip(*parts))
    return LU.reshape(A.shape), piv.reshape(lead + (n,)), info.reshape(lead)


def solve_lu(A, B):
    """A X = B (A (..., n, n), B (..., n, k)) by LU with partial pivoting,
    NaN where the factorization failed.  `torch.linalg.solve_ex` and
    `inv_ex` read a device value in their triangular solve; this factors
    with `lu_factor_ex` and solves with `solve_triangular`, which read
    none (on the CPU the result is bit-equal to `inv_ex`'s).  On the card
    a batch of more than `LU_GROUP` matrices wider than 16 is factored in
    groups (`lu_factor_groups`), so the solve captures at any batch."""
    n = A.shape[-1]
    if A.is_cuda and n > 16 and math.prod(A.shape[:-2]) > LU_GROUP:
        LU, piv, info = lu_factor_groups(A)
    else:
        LU, piv, info = torch.linalg.lu_factor_ex(A)
    P, L, U = torch.lu_unpack(LU, piv)
    y = torch.linalg.solve_triangular(L, P.transpose(-1, -2) @ B,
                                      upper=False, unitriangular=True)
    return _nan_where_failed(torch.linalg.solve_triangular(U, y, upper=True),
                             info)


def cho_solve(L, B):
    """A X = B from A's lower Cholesky factor L, as `torch.cholesky_solve`
    (bit-equal on the CPU) without its error check's device read."""
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def inv(A):
    """Matrix inverse with NaN instead of an exception on singular input."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return solve_lu(A, eye.expand(A.shape))


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
