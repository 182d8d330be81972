"""Closed-form 3x3 symmetric eigen-analysis and linear solve
(port of mmloam_tpu/ops/linalg3.py).

Eigenvalues by the trigonometric method (Smith 1961), eigenvectors by
Cayley-Hamilton, solve by the adjugate — branch-free elementwise math, no
`torch.linalg.eigh`, so results follow the reference formula for formula.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def eigvalsh3(A):
    """Ascending eigenvalues of symmetric A (..., 3, 3) -> (..., 3)."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2, min=_EPS) / 6.0)
    b00, b11, b22 = d0 / p, d1 / p, d2 / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detB = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    diag = p2 < _EPS
    e_lo = torch.where(diag, q, e_lo)
    e_mid = torch.where(diag, q, e_mid)
    e_hi = torch.where(diag, q, e_hi)
    return torch.stack([e_lo, e_mid, e_hi], dim=-1)


def _largest_column(M, fallback):
    """Normalized column of M with the largest norm (first on ties)."""
    norms = torch.sqrt(torch.sum(M * M, dim=-2))             # (..., 3)
    is_max = norms == norms.max(dim=-1, keepdim=True).values
    first = torch.cumsum(is_max.to(torch.int32), dim=-1) == 1
    sel = (is_max & first).to(M.dtype)
    v = torch.sum(M * sel[..., None, :], dim=-1)
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    fb = torch.tensor(fallback, dtype=M.dtype, device=M.device).expand(v.shape)
    return torch.where(n > 1e-9, v / torch.clamp(n, min=1e-9), fb)


def principal_eigvec3(A, evals):
    """Unit eigenvector of the LARGEST eigenvalue of symmetric A."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = ((A - evals[..., 1, None, None] * eye)
         @ (A - evals[..., 0, None, None] * eye))
    return _largest_column(M, [1.0, 0.0, 0.0])


def smallest_eigvec3(A, evals):
    """Unit eigenvector of the SMALLEST eigenvalue of symmetric A."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = ((A - evals[..., 1, None, None] * eye)
         @ (A - evals[..., 2, None, None] * eye))
    return _largest_column(M, [0.0, 0.0, 1.0])


def solve3(A, b):
    """Solve A x = b for 3x3 A (..., 3, 3), b (..., 3) via the adjugate."""
    a = A + 1e-8 * torch.eye(3, dtype=A.dtype, device=A.device)
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a10, a11, a12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
    a20, a21, a22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    safe = torch.where(torch.abs(det) < _EPS,
                       torch.where(det < 0, -_EPS, _EPS), det)
    inv_det = 1.0 / safe
    x0 = (c00 * b[..., 0] + c10 * b[..., 1] + c20 * b[..., 2]) * inv_det
    x1 = (c01 * b[..., 0] + c11 * b[..., 1] + c21 * b[..., 2]) * inv_det
    x2 = (c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2]) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)
