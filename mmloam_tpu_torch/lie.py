"""SO(3)/quaternion math substrate (port of mmloam_tpu/lie.py).

All functions broadcast over leading batch dims.  The small-angle Taylor
guards are kept exactly as in the reference: both branches are evaluated
and one is selected with `torch.where`, so derivatives (torch.func) stay
finite.  Quaternions are (w, x, y, z), Hamilton convention.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(v):
    """so(3) hat operator: v -> skew-symmetric matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def _safe_norm(v):
    """Norm whose gradient is finite at 0 (eps-floored)."""
    sq = torch.sum(v * v, dim=-1)
    return torch.sqrt(torch.clamp(sq, min=_EPS * _EPS))


def _eye_like(K):
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def exp_matrix(phi):
    """SO3 exponential map: rotation vector -> rotation matrix (Rodrigues)."""
    theta = _safe_norm(phi)[..., None, None]
    small = theta < 1e-5
    K = hat(phi)
    K2 = K @ K
    a = torch.where(small, 1.0 - theta ** 2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta ** 2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta ** 2)
    return _eye_like(K) + a * K + b * K2


def exp_quat(phi):
    """SO3 exponential map: rotation vector -> unit quaternion (w,x,y,z)."""
    theta = _safe_norm(phi)
    half = 0.5 * theta
    small = theta < 1e-5
    s = torch.where(small, 0.5 - theta ** 2 / 48.0, torch.sin(half) / theta)
    w = torch.cos(half)
    xyz = phi * s[..., None]
    return torch.cat([w[..., None], xyz], dim=-1)


def log_quat(q):
    """SO3 logarithm: unit quaternion (w,x,y,z) -> rotation vector."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    n = _safe_norm(xyz)
    theta = 2.0 * torch.atan2(n, w)
    small = n < 1e-6
    scale = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), theta / n)
    return xyz * scale[..., None]


def log_matrix(R):
    """SO3 logarithm via the quaternion (Shepperd + arctan2 log)."""
    return log_quat(matrix_to_quat(R))


def quat_mul(a, b):
    """Hamilton product (w,x,y,z)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def cross(a, b):
    """Cross product over the last axis, broadcasting leading dims."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q."""
    qv = q[..., 1:]
    t = 2.0 * cross(qv, v)
    return v + q[..., :1] * t + cross(qv, t)


def quat_normalize(q):
    n = torch.sqrt(torch.clamp(torch.sum(q * q, dim=-1), min=_EPS * _EPS))
    q = q / n[..., None]
    return torch.where(q[..., :1] < 0, -q, q)


def quat_to_matrix(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ], dim=-2)


def matrix_to_quat(R):
    """Rotation matrix -> unit quaternion (w,x,y,z), branch-free Shepperd."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20],
                     dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21],
                     dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22],
                     dim=-1)
    scores = torch.stack([tr, m00, m11, m22], dim=-1)
    # first maximum on ties, like jnp.argmax (torch.argmax does not promise
    # which of several maxima it returns)
    is_max = scores == scores.max(dim=-1, keepdim=True).values
    first = torch.cumsum(is_max.to(torch.int32), dim=-1) == 1
    sel = (is_max & first).to(R.dtype)                       # (..., 4)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)            # (..., 4, 4)
    q = torch.sum(cands * sel[..., :, None], dim=-2)
    return quat_normalize(q)


def right_jacobian(phi):
    """Right Jacobian of SO(3): Jr(phi) (IMUIntegrator.cpp:131-139 form)."""
    theta = _safe_norm(phi)
    small = theta < 1e-5
    axis = phi / theta[..., None]
    K = hat(axis)
    K2 = K @ K
    t = theta[..., None, None]
    sm = small[..., None, None]
    a = torch.where(sm, t / 2.0 - t ** 3 / 24.0, (1.0 - torch.cos(t)) / t)
    b = torch.where(sm, t ** 2 / 6.0, 1.0 - torch.sin(t) / t)
    eye = _eye_like(K)
    Jr = eye - a * K + b * K2
    Jr_small = eye - 0.5 * hat(phi)
    return torch.where(sm, Jr_small, Jr)


def right_jacobian_inv(phi):
    """Closed-form inverse of the SO(3) right Jacobian (|phi| < pi)."""
    theta = _safe_norm(phi)[..., None, None]
    small = theta < 1e-4
    K = hat(phi)
    K2 = K @ K
    sin_t = torch.sin(theta)
    c = torch.where(
        small, 1.0 / 12.0 + theta ** 2 / 720.0,
        1.0 / torch.clamp(theta ** 2, min=_EPS ** 2)
        - (1.0 + torch.cos(theta)) / torch.clamp(2.0 * theta * sin_t,
                                                 min=_EPS ** 2))
    return _eye_like(K) + 0.5 * K + c * K2


def slerp_identity(q, s):
    """slerp(Identity, q, s) = exp(s * log(q)) for s in [0,1]."""
    phi = log_quat(q)
    return exp_quat(phi * s[..., None])


def quat_angular_distance(a, b):
    """Angle of relative rotation between two unit quaternions (radians)."""
    d = quat_mul(quat_conj(a), b)
    return torch.abs(2.0 * torch.atan2(_safe_norm(d[..., 1:]),
                                       torch.abs(d[..., 0])))
