"""The damped solve of one Levenberg-Marquardt iteration (kernel K4).

Every LM iteration (`estimator.solver.lm_solve`) solves each lane's
damped, Jacobi-scaled block-tridiagonal normal equations for its step.
The reference writes it as a chain of `jnp` operations that XLA fuses
(mmloam_tpu/estimator/solver.py's `_damped_solve`, `_block_thomas`,
`_gj_inv15`); in torch that chain is ~400 launches of a few microseconds
each, every iteration.  `damped_solve` launches `csrc/lm_solve.cu` on CUDA
tensors (one launch for the batch, on the current stream; counted in
LAUNCHES; raises on an input the kernel does not take, `check`) and takes
`plain`, that chain as the port had it, on CPU tensors, so the estimator's
results on the CPU are the reference-held ones bit for bit.

The algorithm, per lane, the same in the kernel and `plain` (float32):
the per-group floor of the window's diagonal (`1e-6 max(gmax, 1e-12)`,
gmax the group's largest diagonal entry over the window, at least 0), the
Jacobi scale `1/sqrt(d)` on the dims whose diagonal d exceeds it (0 on the
others, which get a unit diagonal and so a zero step), the damping `lam +
1e-5` on the scaled diagonal, block-Thomas with pivot-free 15 x 15
Gauss-Jordan inverses (safe: every matrix inverted is a Schur complement
of the SPD damped system), the step scaled back, non-finite entries set to
0 and the whole window's step capped at the trust radius.  The kernel
keeps the orders in which torch's kernels sum `plain`'s products and rows
for one lane on the card (cuBLAS's fused multiply-adds, torch's reduction
trees; csrc/lm_solve.cu states them), so at B = 1 the two agree bit for
bit.  A lane's bits from the kernel do not depend on the batch; torch's
orders do, so against `plain` on a batch the kernel agrees within float32
rounding.
"""

from __future__ import annotations

import threading

import torch

from .. import lie
from . import launch_tape

_SOURCE = "lm_solve.cu"
N = 15                     # state dims a frame
MAX_W = 16                 # the largest window the kernel holds

# kernel launches made by `damped_solve` (counted where it launches,
# nowhere else); callers reset them (`reset_counts`).  Workers of a split
# replay launch from several threads, so counts are taken under a lock.
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()


def _count(times=1):
    """Add `times` launches, atomically; while this thread captures a CUDA
    graph, note them instead (`launch_tape`)."""
    global LAUNCHES
    if launch_tape.note(("k4", "default", False), _count):
        return
    with _COUNT_LOCK:
        LAUNCHES += times


def reset_counts():
    """Set the launch counter to 0."""
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES = 0


def _gj_inv15(A):
    """Inverse by pivot-free Gauss-Jordan, batched over leading dims."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    aug = torch.cat([A, eye], dim=-1)
    for k in range(n):
        row = aug[..., k:k + 1, :]
        piv = row / row[..., k:k + 1]
        aug = aug - aug[..., :, k:k + 1] * piv
        aug[..., k:k + 1, :] = piv
    return aug[..., :, n:]


def _block_thomas(diag, up, b):
    """Exact solve of the symmetric block-tridiagonal system."""
    W = diag.shape[-3]
    mv = lie.mv
    T = lambda a: a.transpose(-1, -2)
    Dinv = [None] * W
    y = [None] * W
    Dinv[0] = _gj_inv15(diag[..., 0, :, :])
    y[0] = b[..., 0, :]
    for i in range(1, W):
        U = up[..., i - 1, :, :]
        L = T(U) @ Dinv[i - 1]
        Dinv[i] = _gj_inv15(diag[..., i, :, :] - L @ U)
        y[i] = b[..., i, :] - mv(L, y[i - 1])
    x = [None] * W
    x[W - 1] = mv(Dinv[W - 1], y[W - 1])
    for i in range(W - 2, -1, -1):
        x[i] = mv(Dinv[i], y[i] - mv(up[..., i, :, :], x[i + 1]))
    return torch.stack(x, dim=-2)


def plain(diag, up, b, lam, radius):
    """The plain version of K4 on any device: solve (H + lam*diag(H)) dx =
    -b with per-group Jacobi scaling, unobservable dims frozen and the
    step capped at `radius` (lam and radius one per lane)."""
    dtype, dev = diag.dtype, diag.device
    d15 = torch.diagonal(diag, dim1=-2, dim2=-1)            # (B,W,15)
    # per state-component group (P phi V bg ba), floored at 0 like the
    # reference's zeros.at[groups].max
    gmax = torch.clamp(torch.amax(d15, dim=-2).unflatten(-1, (5, 3))
                       .amax(dim=-1), min=0.0)
    d_floor15 = (1e-6 * torch.clamp(gmax, min=1e-12)).repeat_interleave(
        3, dim=-1)[..., None, :]
    observable = d15 > d_floor15
    s = torch.where(observable,
                    1.0 / torch.sqrt(torch.maximum(d15, d_floor15)),
                    torch.zeros_like(d15))
    diag_s = diag * s[..., :, :, None] * s[..., :, None, :]
    up_s = up * s[..., :-1, :, None] * s[..., 1:, None, :]
    dd = (lam + 1e-5)[..., None, None] + torch.where(
        observable, torch.zeros_like(d15), torch.ones_like(d15))
    A_diag = diag_s + dd[..., None] * torch.eye(15, dtype=dtype, device=dev)
    dx = s * _block_thomas(A_diag, up_s, -(b * s))
    dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
    nrm = torch.sqrt(torch.sum(dx * dx, dim=(-2, -1)))
    scale = torch.clamp(radius / torch.clamp(nrm, min=1e-12), max=1.0)
    return dx * scale[..., None, None]


def check(diag, up, b, lam, radius):
    """Raise ValueError unless the kernel takes these: float32 tensors on
    one device, diag (B, W, 15, 15) with 1 <= W <= MAX_W, up (B, W - 1,
    15, 15), b (B, W, 15), lam and radius (B,), each contiguous."""
    args = dict(diag=diag, up=up, b=b, lam=lam, radius=radius)
    if diag.dim() != 4:
        raise ValueError(f"diag must be (B, W, {N}, {N}), got "
                         f"{tuple(diag.shape)}")
    B, W = diag.shape[:2]
    want = dict(diag=(B, W, N, N), up=(B, W - 1, N, N), b=(B, W, N),
                lam=(B,), radius=(B,))
    if not 1 <= W <= MAX_W:
        raise ValueError(f"the window must hold 1 to {MAX_W} frames, got "
                         f"{W}")
    for name, a in args.items():
        if a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {a.dtype}")
        if tuple(a.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]} (a {N}-dim "
                             f"state), got {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if a.device != diag.device:
            raise ValueError(f"{name} is on {a.device}, diag on "
                             f"{diag.device}")


def _bind(lib):
    import ctypes

    p = ctypes.c_void_p
    lib.lm_damped_solve_launch.argtypes = [p, p, p, p, p, p, ctypes.c_int,
                                           ctypes.c_int, p]
    lib.lm_damped_solve_launch.restype = ctypes.c_int


def damped_solve(diag, up, b, lam, radius):
    """Each lane's LM step dx (B, W, 15) from its window's normal
    equations diag (B, W, 15, 15), up (B, W - 1, 15, 15), b (B, W, 15),
    its damping lam (B,) and trust radius (B,): the kernel on CUDA
    tensors (one launch for the batch, on the current stream; counted in
    LAUNCHES; raises where `check` does or the launch fails), `plain` on
    CPU tensors."""
    if not diag.is_cuda:
        return plain(diag, up, b, lam, radius)
    check(diag, up, b, lam, radius)
    from .. import cuda_build

    B, W = diag.shape[:2]
    dx = torch.empty((B, W, N), dtype=diag.dtype, device=diag.device)
    fn = cuda_build.load(_SOURCE, _bind).lm_damped_solve_launch
    args = (diag.data_ptr(), up.data_ptr(), b.data_ptr(), lam.data_ptr(),
            radius.data_ptr(), dx.data_ptr(), B, W)
    dev = diag.device
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if B > 0:                       # else the launcher launches nothing
        _count()
    if rc != 0:
        raise RuntimeError(f"lm_damped_solve_launch failed: CUDA error {rc}")
    return dx
