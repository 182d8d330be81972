"""The marginalization's symmetric eigen-decompositions, plain.

The port solves them with its kernel K3, in float64 inside and rounded to
float32.  The reference takes torch's own solver on the input widened to
float64, rounded to float32 the same way: an independent algorithm at the
precision the port states.  `PRECISION` is the dtype it solves in;
`harness.compare` sets it to float32 for the lower-precision control.
"""

from __future__ import annotations

import torch

PRECISION = torch.float64


def eigh(A):
    """Ascending eigenvalues (..., n) and eigenvectors as columns (..., n,
    n) of symmetric A (..., n, n) float32, from its lower triangle.  A
    matrix with a non-finite entry gives NaN, as the port's solver does
    (the lockstep step feeds the identity to lanes whose branch it drops,
    so only a fault reaches here)."""
    ok = torch.isfinite(A).all(dim=(-2, -1))
    safe = torch.where(ok[..., None, None], A,
                       torch.eye(A.shape[-1], dtype=A.dtype,
                                 device=A.device))
    w, v = torch.linalg.eigh(safe.to(PRECISION))
    w = torch.where(ok[..., None], w.to(A.dtype), float("nan"))
    v = torch.where(ok[..., None, None], v.to(A.dtype), float("nan"))
    return w, v
