"""Batched symmetric eigen-solver (kernel K3): cyclic Jacobi, one thread
block a matrix.

The marginalization (`estimator.solver.marginalize`) takes the eigen-
decomposition of two 15 x 15 symmetric matrices a lane every lockstep
scan.  The reference calls `jnp.linalg.eigh` there
(mmloam_tpu/estimator/solver.py:368, 376), outside any Pallas kernel;
torch's `torch.linalg.eigh` reads its error flags on the host, a sync that
a CUDA graph cannot capture.  `eigh` launches `csrc/eigh.cu` on CUDA
tensors (counted in LAUNCHES; raises if the kernel cannot be built or
launched) and takes `torch.linalg.eigh` on CPU tensors, so the estimator's
results on the CPU are those of torch's solver.  `jacobi_reference` is the
plain version of the kernel: its rotations in its order, which the tests
and chip_smoke.py hold the kernel against.  `schedule` (a sweep's pairs,
built from `pairs`) and `lookahead` (where each next pair's entries lie)
are the tables the kernel is given.

The algorithm, the same in the kernel and `jacobi_reference`, in float64
(the f32 input converts exactly; results round to f32 at the end): the
lower triangle of each A (B, n, n), n <= 32, mirrored; V = I.  A sweep is
n' - 1 rounds (n' = n rounded up to even) of the round-robin tournament
`pairs`: n'/2 disjoint index pairs a round, a pair with the pad index n
(odd n) a bye.  Each pair (p, q), p < q, gets its rotation from the round's
A (Numerical Recipes 11.1: theta = (a_qq - a_pp) / (2 a_pq), t = sgn(theta)
/ (|theta| + sqrt(theta^2 + 1)), c = 1 / sqrt(t^2 + 1), s = t c; c = 1, s =
0 where a_pq = 0; theta^2 overflows float64 only where a_pq is ~1e-150 of
the diagonal's difference, and t = 0 there, so a_pq is merely zeroed); the
round's rotations apply to A's rows, then to A's columns and V's columns,
and the pairs' entries a_pq, a_qp are set to 0.  A sweep starts only while
off(A)^2 = sum_{i != j} a_ij^2 exceeds (TOL ||A||_F)^2 (||A||_F of the
input), at most MAX_SWEEPS sweeps.  The eigenvalues are A's diagonal,
sorted ascending (a stable sort: ties keep index order), and V's columns
are permuted with them.  A matrix with a non-finite entry in its lower
triangle gives NaN values and vectors.  Each eigenvector's sign is whatever
the rotations give: the marginalization is invariant to it.

Why float64 inside: the marginalization's Amm spans several decades (its
prior and IMU blocks), and the Schur complement A* = A_rr - A_rm Amm^+
A_mr multiplies each kept eigenvector's components along the stiff
directions by A_rm's large entries.  Rotations in f32 leave those components
with absolute errors ~n u (u = 2^-24), which A* turns into errors of the
prior's size (tests/test_torch_eigh.py holds the prior); in float64 the
eigen-decomposition is exact to f32 rounding, and the card's float64
rate does not bound a kernel of a few hundred dependent steps.

The kernel and the plain version on the card round every operation alike
(no fused multiply-add: `cuda_build.NVCC_FLAGS` has -fmad=false; both take
correctly rounded float64 square roots, which torch's CPU build need not:
there the plain version's bits may differ); they may differ in off(A)'s
summation order, and so stop a sweep apart when off(A) lands within
rounding of the threshold.
"""

from __future__ import annotations

import functools
import threading

import torch

from .. import lie
from . import launch_tape

_SOURCE = "eigh.cu"
MAX_N = 32                 # a warp's lanes hold a round's 16 rotations
MAX_SWEEPS = 15
TOL = 2.0 ** -46           # off(A) <= TOL ||A||_F (float64) ends the sweeps

# kernel launches made by `eigh` (counted where it launches, nowhere
# else); callers reset them (`reset_counts`).  Workers of a split replay
# launch from several threads, so counts are taken under a lock.
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()


def _count(times=1):
    """Add `times` launches, atomically; while this thread captures a CUDA
    graph, note them instead (`launch_tape`)."""
    global LAUNCHES
    if launch_tape.note(("k3", "default", False), _count):
        return
    with _COUNT_LOCK:
        LAUNCHES += times


def reset_counts():
    """Set the launch counter to 0."""
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES = 0


def pairs(n):
    """The sweep's rounds for an n x n matrix: a list of (ps, qs), the
    round's pairs p < q < n (byes left out), in the kernel's order.  Round
    r of the tournament over n' = n + n % 2 indices pairs n' - 1 with r
    and, for k = 1 .. n'/2 - 1, (r + k) and (r - k) modulo n' - 1."""
    m = n + n % 2
    rounds = []
    for r in range(m - 1):
        ps, qs = [], []
        for k in range(m // 2):
            a, b = (m - 1, r) if k == 0 else ((r + k) % (m - 1),
                                              (r - k) % (m - 1))
            p, q = min(a, b), max(a, b)
            if q < n:
                ps.append(p)
                qs.append(q)
        rounds.append((ps, qs))
    return rounds


def schedule(n):
    """The kernel's table of a sweep for an n x n matrix: (n' - 1, n'/2, 2)
    uint8 (n' = n + n % 2), pair k of round r as (p, q), p < q: round r's
    pairs of `pairs(n)` in order, after the bye (odd n) as (i, n), i the
    index the round leaves out."""
    m = n + n % 2
    out = []
    for ps, qs in pairs(n):
        row = list(zip(ps, qs))
        if n % 2:
            (i,) = set(range(n)) - set(ps) - set(qs)
            row.insert(0, (i, n))
        out.append(row)
    return torch.tensor(out, dtype=torch.uint8).reshape(m - 1, m // 2, 2)


def lookahead(n):
    """The kernel's look-ahead records, (n' - 1, n'/2) int64 holding one
    32-bit word each: for round r and pair j of the next round (round 0
    after the last), where that pair (p, q) finds its a_pp, a_qq and a_pq
    in round r's output.  p lies in round r's pair kp = {p0, p1}, p = p0,
    and q in pair kq = {q0, q1}, q = q0 (`schedule`'s pairs with the
    sought index first).  Bits 0-4 p0, 5-9 p1, 10-14 q0, 15-19 q1, 20-23
    kp, 24-27 kq; bit 28: p is kp's second index (its s enters negated),
    29: likewise q in kq, 30: the next round's pair j is a bye, 31: a_pq
    is zeroed (kp = kq)."""
    tab = schedule(n).tolist()
    rounds, half = len(tab), len(tab[0])
    out = []
    for r in range(rounds):
        slot = {i: (k, pos) for k in range(half)
                for pos, i in enumerate(tab[r][k])}
        row = []
        for p, q in tab[(r + 1) % rounds]:
            (kp, ap), (kq, aq) = slot[p], slot[q]
            p0, p1 = tab[r][kp][ap], tab[r][kp][1 - ap]
            q0, q1 = tab[r][kq][aq], tab[r][kq][1 - aq]
            row.append(p0 | p1 << 5 | q0 << 10 | q1 << 15 | kp << 20
                       | kq << 24 | ap << 28 | aq << 29 | (q >= n) << 30
                       | (kp == kq and ap != aq) << 31)
        out.append(row)
    return torch.tensor(out, dtype=torch.int64)


@functools.lru_cache(maxsize=None)
def _schedule_arg(n):
    """`schedule(n)`'s bytes then `lookahead(n)`'s little-endian words,
    as a ctypes byte array (kept alive by the cache)."""
    import ctypes
    import struct

    words = lookahead(n).flatten().tolist()
    raw = bytes(schedule(n).flatten().tolist()) + struct.pack(
        f"<{len(words)}I", *words)
    return (ctypes.c_uint8 * len(raw)).from_buffer_copy(raw)


def _rotation(app, aqq, apq):
    """(c, s) of the rotations that zero a_pq, elementwise."""
    theta = (aqq - app) / (2.0 * apq)
    u = 1.0 / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0))
    t = torch.where(theta < 0.0, -u, u)
    c = 1.0 / torch.sqrt(t * t + 1.0)
    s = t * c
    zero = apq == 0.0
    return (torch.where(zero, torch.ones_like(c), c),
            torch.where(zero, torch.zeros_like(s), s))


def _symmetric(A):
    """A's lower triangle mirrored (what `torch.linalg.eigh` reads)."""
    low = torch.tril(A)
    return low + torch.tril(A, -1).transpose(-1, -2)


def _sumsq(A):
    """Sum of squares of each matrix (B, n, n), a contiguous row each."""
    return lie.lane_sum((A * A).flatten(-2))


def jacobi_reference(A, info=False):
    """The plain version of K3 on any device: ascending eigenvalues (...,
    n) and eigenvectors as columns (..., n, n) of each symmetric A (..., n,
    n) float32, by the kernel's rotations in the kernel's order, batched.
    With `info`, also {"sweeps": sweeps each matrix ran (...,) int32,
    "off": its off(A) / ||A||_F when it stopped, float64}."""
    _check(A)
    lead, n = A.shape[:-2], A.shape[-1]
    A = _symmetric(A.reshape((-1, n, n))).to(torch.float64)
    B = A.shape[0]
    ok = torch.isfinite(A).flatten(-2).all(dim=-1)
    A = torch.where(ok[:, None, None], A, torch.zeros_like(A))
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(B, n, n).clone()
    eye = torch.eye(n, dtype=torch.bool, device=A.device)
    thr = TOL * TOL * _sumsq(A)
    offd = lambda M: _sumsq(torch.where(eye, torch.zeros_like(M), M))
    done = torch.zeros((B,), dtype=torch.bool, device=A.device)
    sweeps = torch.zeros((B,), dtype=torch.int32, device=A.device)
    rounds = [(torch.tensor(ps, device=A.device),
               torch.tensor(qs, device=A.device)) for ps, qs in pairs(n)]
    for _ in range(MAX_SWEEPS):
        done = done | (offd(A) <= thr)
        if bool(done.all()):
            break
        A0, V0 = A, V
        for P, Q in rounds:
            c, s = _rotation(A[:, P, P], A[:, Q, Q], A[:, P, Q])
            A = A.clone()
            rp, rq = A[:, P, :], A[:, Q, :]
            A[:, P, :] = c[..., None] * rp - s[..., None] * rq
            A[:, Q, :] = s[..., None] * rp + c[..., None] * rq
            cp, cq = A[:, :, P], A[:, :, Q]
            A[:, :, P] = c[:, None] * cp - s[:, None] * cq
            A[:, :, Q] = s[:, None] * cp + c[:, None] * cq
            A[:, P, Q] = 0.0
            A[:, Q, P] = 0.0
            V = V.clone()
            vp, vq = V[:, :, P], V[:, :, Q]
            V[:, :, P] = c[:, None] * vp - s[:, None] * vq
            V[:, :, Q] = s[:, None] * vp + c[:, None] * vq
        A = torch.where(done[:, None, None], A0, A)
        V = torch.where(done[:, None, None], V0, V)
        sweeps = sweeps + (~done).to(torch.int32)
    d = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.sort(d, dim=-1, stable=True).indices
    w = torch.gather(d, -1, order)
    V = torch.gather(V, -1, order[:, None, :].expand(B, n, n))
    w, V = w.to(torch.float32), V.to(torch.float32)
    nan = float("nan")
    w = torch.where(ok[:, None], w, nan).reshape(lead + (n,))
    V = torch.where(ok[:, None, None], V, nan).reshape(lead + (n, n))
    if not info:
        return w, V
    off = torch.sqrt(offd(A) / torch.clamp(_sumsq(A), min=1e-30))
    return w, V, dict(sweeps=sweeps.reshape(lead), off=off.reshape(lead))


def _check(A):
    if A.dtype != torch.float32 or A.dim() < 2 \
            or A.shape[-1] != A.shape[-2] or not 1 <= A.shape[-1] <= MAX_N:
        raise ValueError(f"A must be (..., n, n) float32 with n <= {MAX_N}, "
                         f"got {tuple(A.shape)} {A.dtype}")


def _bind(lib):
    import ctypes

    p = ctypes.c_void_p
    lib.eigh_launch.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_double, p, p]
    lib.eigh_launch.restype = ctypes.c_int


def eigh(A):
    """Ascending eigenvalues (..., n) and eigenvectors as columns (..., n,
    n) of symmetric A (..., n, n) float32, n <= 32, from its lower
    triangle: the kernel on CUDA tensors (one launch for the batch, on the
    current stream; counted in LAUNCHES), `torch.linalg.eigh` on CPU
    tensors."""
    _check(A)
    if not A.is_cuda:
        return torch.linalg.eigh(A)
    from .. import cuda_build

    lead, n = A.shape[:-2], A.shape[-1]
    a = A.reshape((-1, n, n)).contiguous()
    B = a.shape[0]
    w = torch.empty((B, n), dtype=A.dtype, device=A.device)
    v = torch.empty((B, n, n), dtype=A.dtype, device=A.device)
    import ctypes

    fn = cuda_build.load(_SOURCE, _bind).eigh_launch
    args = (a.data_ptr(), w.data_ptr(), v.data_ptr(), B, n, MAX_SWEEPS, TOL,
            ctypes.addressof(_schedule_arg(n)))
    dev = A.device
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if B > 0:                       # else eigh_launch launches nothing
        _count()
    if rc != 0:
        raise RuntimeError(f"eigh_launch failed: CUDA error {rc}")
    return w.reshape(lead + (n,)), v.reshape(lead + (n, n))
