"""K3's plain version (`ops.eigh.jacobi_reference`, the batched cyclic
Jacobi the kernel runs) against NumPy's float64 `eigh` and JAX's
`jnp.linalg.eigh` (the reference's marginalization calls it,
mmloam_tpu/estimator/solver.py:368, 376), on seeded matrices: random PSD
ones at condition numbers 1 to 1e7, repeated, clustered and rank-
deficient spectra, indefinite ones, and the marginalization's own Amm and
A* (`marginalize` on test_torch_estimator's mid-sequence window, as it
builds them).  The kernel itself runs on the card only
(tests/test_torch_cuda.py, chip_smoke.py phase 14).

Bounds, with u = 2^-24 (f32) and ||A|| the spectral norm.  The solver
rotates in float64 and rounds to f32 once, so against NumPy's float64 it
is held to F64_C n u ||A|| (F64_C = 1; observed below 0.1 n u), against
JAX's f32 solver to EVAL_C n u ||A|| (EVAL_C = 8: a backward-stable f32
solver's error is O(n u ||A||)):
* eigenvalues within those bounds;
* the residual ||A V - V diag(w)||_2 within F64_C n u ||A|| and
  max |V^T V - I| within F64_C n u;
* each eigenvector, up to its sign, within the bound over its gap to the
  other eigenvalues wherever that gap is at least GAP_FRAC ||A||
  (Davis-Kahan);
* eigenvalues ascending, and every matrix converged (off(A) <= TOL
  ||A||_F) before the sweep cap;
* a batch's lanes bit-equal to each lane alone, a non-finite lane NaN;
* `marginalize` through `jacobi_reference` gives the prior's J^T J and
  J^T r within test_torch_estimator.test_marginalize_matches_jax's own
  bound against JAX.

The kernel's design is held here in its algebra: a NumPy float64
emulation of its rounds (`_kernel_emulation`: a thread a 2 x 2 block of
A, rows then columns, A double-buffered, V a 2 x 2 block of columns,
each pair's rotation computed a round ahead from the entries it needs,
the pairs from `eigh.schedule` and the entries from `eigh.lookahead`,
the tables the kernel is given) is bit-equal to `jacobi_reference` at
n = 2 to 32:
eigenvalues, eigenvectors and sweeps.  Its stop test sums off(A) as the
plain version does (the kernel's own sum may stop a sweep apart, as
ops/eigh.py says), and its square roots are torch's, as the plain
version's on the CPU (torch's CPU float64 sqrt is not always correctly
rounded; NumPy's and the card's are).
"""

import functools

import numpy as np
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

import test_torch_estimator as te  # noqa: E402
from mmloam_tpu.estimator import solver as jsol  # noqa: E402
from mmloam_tpu_torch.estimator import solver as tsol  # noqa: E402
from mmloam_tpu_torch.ops import eigh  # noqa: E402
from mmloam_tpu_torch.tree import tree_map  # noqa: E402

U = 2.0 ** -24
EVAL_C = 8.0
F64_C = 1.0
GAP_FRAC = 1e-3
N = 15


def _psd(rng, n, cond):
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    ev = np.logspace(0, np.log10(cond), n) * rng.uniform(0.5, 2.0)
    return (Q * ev) @ Q.T


def _spectrum(rng, ev):
    Q, _ = np.linalg.qr(rng.normal(size=(len(ev), len(ev))))
    return (Q * np.asarray(ev)) @ Q.T


@functools.lru_cache(maxsize=None)
def _marginalization_matrices():
    """The Amm and A* `marginalize` decomposes at the window's entry
    (f32, as it builds them), and the prior it gives through torch's and
    through the reference's eigh."""
    a, rfs, _, _ = te._solve_inputs()
    rf0 = tree_map(lambda v: v[0], rfs)
    args = tuple(te._lane(te._t(v)) for v in (
        a["x0"], rf0, a["preint"], a["prior"], a["gravity"]))
    seen = []
    orig = eigh.eigh

    def spy(As):
        seen.append(As.clone())
        return orig(As)

    eigh.eigh = spy
    try:
        tsol.marginalize(*args, te.CFG)
    finally:
        eigh.eigh = orig
    return a, rf0, torch.cat(seen).numpy()


def _cases():
    rng = np.random.default_rng(0)
    out = {f"psd cond {c:g}": np.stack([_psd(rng, N, c) for _ in range(6)])
           for c in (1.0, 1e2, 1e4, 1e7)}
    out["repeated"] = np.stack([_spectrum(rng, [1.0] * 5 + [2.0] * 5
                                          + [3.0] * 5) for _ in range(3)])
    out["clustered"] = np.stack([_spectrum(
        rng, 1.0 + 1e-6 * rng.normal(size=N)) for _ in range(3)])
    out["rank deficient"] = np.stack([_spectrum(rng, np.concatenate(
        [np.zeros(6), rng.uniform(1.0, 10.0, N - 6)])) for _ in range(3)])
    out["indefinite"] = rng.normal(size=(6, N, N))
    out["n=2, 3, 16, 32"] = None      # built in the test (other sizes)
    return out


CASES = _cases()


def _sym32(A):
    A = np.asarray(A, np.float64)
    return (0.5 * (A + np.swapaxes(A, -1, -2))).astype(np.float32)


def _check_against(A, w, V, w_ref, V_ref, c, what):
    """w, V (f32 results) against w_ref, V_ref for each matrix of A, to
    c n u ||A||."""
    n = A.shape[-1]
    for b in range(A.shape[0]):
        nrm = max(np.abs(w_ref[b]).max(), 1e-30)
        tol = c * n * U * nrm
        assert np.abs(w[b] - w_ref[b]).max() <= tol, (what, b)
        for k in range(n):
            gap = np.delete(np.abs(w_ref[b] - w_ref[b, k]), k).min()
            if gap < GAP_FRAC * nrm:
                continue
            v, r = V[b][:, k], V_ref[b][:, k]
            sign = 1.0 if float(v @ r) >= 0.0 else -1.0
            assert np.abs(sign * v - r).max() <= tol / gap, (what, b, k)


def _check_decomposition(A, what):
    A = _sym32(A)
    w, V, info = (t.numpy() if torch.is_tensor(t) else t for t in
                  eigh.jacobi_reference(torch.from_numpy(A), info=True))
    sweeps, off = info["sweeps"].numpy(), info["off"].numpy()
    n = A.shape[-1]
    A64 = A.astype(np.float64)
    w64, V64 = np.linalg.eigh(A64)
    assert (np.diff(w, axis=-1) >= 0.0).all(), what
    assert (sweeps < eigh.MAX_SWEEPS).all() and (off <= eigh.TOL).all(), (
        what, sweeps, off)
    nrm = np.maximum(np.abs(w64).max(axis=-1), 1e-30)
    V6 = V.astype(np.float64)
    res = np.linalg.norm(A64 @ V6 - V6 * w.astype(np.float64)[:, None, :],
                         ord=2, axis=(-2, -1))
    assert (res <= F64_C * n * U * nrm).all(), (what, res / nrm)
    orth = np.abs(np.swapaxes(V6, -1, -2) @ V6 - np.eye(n)).max(axis=(-2,
                                                                      -1))
    assert (orth <= F64_C * n * U).all(), (what, orth)
    _check_against(A, w, V, w64, V64, F64_C, what + " vs float64")
    wj, Vj = jnp.linalg.eigh(jnp.asarray(A))
    assert np.asarray(wj).dtype == np.float32
    _check_against(A, w, V, np.asarray(wj, np.float64),
                   np.asarray(Vj, np.float64), EVAL_C, what + " vs JAX")


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_numpy_and_jax(case):
    if CASES[case] is None:
        rng = np.random.default_rng(1)
        for n in (2, 3, 16, 32):
            _check_decomposition(rng.normal(size=(3, n, n)), f"n={n}")
        return
    _check_decomposition(CASES[case], case)


def test_reference_on_the_marginalization_matrices():
    """Amm and A* as `marginalize` builds them (a PSD information matrix
    and its Schur complement, eigenvalues over several decades)."""
    _, _, mats = _marginalization_matrices()
    assert mats.shape == (2, N, N)
    _check_decomposition(mats, "marginalization")


def test_lanes_bit_equal_alone_and_nonfinite_lane_nan():
    rng = np.random.default_rng(2)
    A = _sym32(np.stack([_psd(rng, N, 1e4), rng.normal(size=(N, N)),
                         _psd(rng, N, 1e7)]))
    bad = A.copy()
    bad[1, 4, 2] = np.nan
    for batch in (A, bad):
        w, V = eigh.jacobi_reference(torch.from_numpy(batch))
        for b in range(3):
            if not np.isfinite(batch[b]).all():
                assert torch.isnan(w[b]).all() and torch.isnan(V[b]).all()
                continue
            w1, V1 = eigh.jacobi_reference(torch.from_numpy(batch[b:b + 1]))
            assert torch.equal(w[b], w1[0]) and torch.equal(V[b], V1[0]), b
    # leading axes: (2, 3, n, n) as six matrices
    w, V = eigh.jacobi_reference(torch.from_numpy(np.stack([A, A])))
    w1, V1 = eigh.jacobi_reference(torch.from_numpy(A))
    assert torch.equal(w[1], w1) and torch.equal(V[1], V1)


def test_reference_reads_the_lower_triangle():
    rng = np.random.default_rng(3)
    A = _sym32(_psd(rng, N, 1e3))[None]
    skew = A.copy()
    skew[0][np.triu_indices(N, 1)] = np.nan
    w, V = eigh.jacobi_reference(torch.from_numpy(A))
    ws, Vs = eigh.jacobi_reference(torch.from_numpy(skew))
    assert torch.equal(w, ws) and torch.equal(V, Vs)


def test_rounds_pair_every_index_pair_once():
    for n in range(1, eigh.MAX_N + 1):
        seen = []
        for ps, qs in eigh.pairs(n):
            idx = ps + qs
            assert len(set(idx)) == len(idx), n        # disjoint in a round
            assert all(p < q < n for p, q in zip(ps, qs))
            seen += list(zip(ps, qs))
        assert sorted(seen) == [(p, q) for p in range(n)
                                for q in range(p + 1, n)], n


def test_wrapper_takes_torch_eigh_on_the_cpu_and_checks_inputs():
    """On CPU tensors the wrapper is torch.linalg.eigh, bit for bit: the
    estimator's CPU results are those of torch's solver."""
    rng = np.random.default_rng(4)
    A = torch.from_numpy(_sym32(rng.normal(size=(2, 5, N, N))))
    for got, want in zip(eigh.eigh(A), torch.linalg.eigh(A)):
        assert torch.equal(got, want)
    for bad in (A.double(), torch.zeros(2, 3, 4), torch.zeros(33, 33)):
        with pytest.raises(ValueError):
            eigh.eigh(bad)


def test_marginalize_through_jacobi_matches_jax(monkeypatch):
    """The prior from `marginalize` with K3's plain version in place of
    torch's eigh, held to test_marginalize_matches_jax's bound: twice the
    reference's own jit-vs-eager spread plus 1e-3 of the scale."""
    a, rf0, _ = _marginalization_matrices()
    args = (a["x0"], rf0, a["preint"], a["prior"], a["gravity"])
    jargs = (jnp.asarray(args[0]), te._to_jax_container(rf0),
             te._jnp(args[2]), te._to_jax_container(args[3]),
             jnp.asarray(args[4]))
    pe = jsol.marginalize(*jargs, te.JCFG)
    pj = jax.jit(lambda *z: jsol.marginalize(*z, te.JCFG))(*jargs)
    monkeypatch.setattr(eigh, "eigh", eigh.jacobi_reference)
    pt = te._unlane(tsol.marginalize(*(te._lane(te._t(v)) for v in args),
                                     te.CFG))
    assert bool(pt.valid)
    He, ge = te._info(pe)
    Hj, gj = te._info(pj)
    Ht, gt = te._info(te._np(pt))
    for got, want, other in ((Ht, He, Hj), (gt, ge, gj)):
        spread = np.abs(other - want).max()
        bound = 2.0 * spread + 1e-3 * max(np.abs(want).max(), 1.0)
        assert np.abs(got - want).max() <= bound, (
            np.abs(got - want).max(), spread)


def _block_entry(x00, x01, x10, x11, a, b, rK, rL, diag, cK, sK, cL, sL):
    """Entry (a, b) of 2 x 2 blocks after a round, elementwise: rows by
    (cK, sK) where rK, then columns by (cL, sL) where rL; 0 off the
    diagonal where diag (the owners' update in csrc/eigh.cu)."""
    y0 = np.where(a == 1, x10, x00)
    y1 = np.where(a == 1, x11, x01)
    y0, y1 = (np.where(rK, np.where(a == 1, sK * x00 + cK * x10,
                                    cK * x00 - sK * x10), y0),
              np.where(rK, np.where(a == 1, sK * x01 + cK * x11,
                                    cK * x01 - sK * x11), y1))
    z = np.where(rL, np.where(b == 1, sL * y0 + cL * y1, cL * y0 - sL * y1),
                 np.where(b == 1, y1, y0))
    return np.where(diag & (a != b), 0.0, z)


def _entry00(x00, x01, x10, x11, cK, sK, cL, sL):
    """Entry (0, 0) of 2 x 2 blocks after a round, elementwise: rows by
    (cK, sK), then columns by (cL, sL) (csrc/eigh.cu's entry00; a bye's
    rotation is (1, 0) and its pad row and column 0)."""
    y0 = cK * x00 - sK * x10
    y1 = cK * x01 - sK * x11
    return cL * y0 - sL * y1


def _kernel_emulation(A32):
    """K3's rounds on one symmetric n x n f32 matrix (its lower triangle),
    in NumPy float64: (w, V as f32, sweeps).  Each pair's rotation of
    round r + 1 is computed in round r from round r's A and rotations (the
    kernel's look-ahead: the three entries it needs, as their blocks'
    owners compute them, each pair listed with the sought index first and
    its s negated where that index is the pair's second; a bye as the
    rotation (1, 0) on a pad row and column of zeros), and must equal the
    rotation of round r + 1's A.
    Each 2 x 2 block (k, l) rotates A's entries {p_k, q_k} x {p_l, q_l} by
    pair k across the rows, then by pair l across the columns (a bye, q =
    n, is the identity; a diagonal block zeroes a_pq, a_qp), and V's
    entries {p_l, q_l} x {p_k, q_k} by pair k; the round reads one copy of
    A and writes another, in which every real entry is written once."""
    n = A32.shape[-1]
    m, half = n + n % 2, (n + n % 2) // 2
    tab = eigh.schedule(n).numpy().astype(np.int64)
    ahead = eigh.lookahead(n).numpy()
    low = np.tril(A32).astype(np.float64)
    A = np.zeros((m, m))
    A[:n, :n] = low + np.tril(low, -1).T
    V = np.zeros((m, m))
    V[:n, :n] = np.eye(n)
    eye = np.eye(n, dtype=bool)
    sumsq = lambda M: float(eigh._sumsq(torch.from_numpy(M)[None])[0])
    thr = eigh.TOL * eigh.TOL * sumsq(A[:n, :n])
    K, L = np.meshgrid(np.arange(half), np.arange(half), indexing="ij")
    # square roots as the plain version takes them on the CPU: this
    # torch's float64 sqrt is not always correctly rounded (the card's is)
    sqrt = lambda x: torch.sqrt(torch.from_numpy(np.asarray(x))).numpy()

    def rotation(app, aqq, apq, real):
        with np.errstate(all="ignore"):
            theta = (aqq - app) / (2.0 * apq)
            u = 1.0 / (np.abs(theta) + sqrt(theta * theta + 1.0))
            t = np.where(theta < 0.0, -u, u)
            c = 1.0 / sqrt(t * t + 1.0)
            s = t * c
        zero = (apq == 0.0) | ~real
        return np.where(zero, 1.0, c), np.where(zero, 0.0, s)

    def direct(r):
        p, q = tab[r, :, 0], tab[r, :, 1]
        return rotation(A[p, p], A[q, q], A[p, q], q < n)

    c, s = direct(0)
    sweeps = 0
    for _ in range(eigh.MAX_SWEEPS):
        if sumsq(np.where(eye, 0.0, A[:n, :n])) <= thr:
            break
        sweeps += 1
        for r in range(m - 1):
            rn = (r + 1) % (m - 1)
            p, q = tab[r, :, 0], tab[r, :, 1]
            # the look-ahead: round rn's pair j = (p', q') in round r's
            # pairs kp = {p0, p1} and kq = {q0, q1}, listed p' and q'
            # first (s negated where p' or q' is its pair's second), as
            # `eigh.lookahead` records it for the kernel
            h = ahead[r]
            p0, p1, q0, q1 = (h >> b & 31 for b in (0, 5, 10, 15))
            kp, kq, ap, aq = h >> 20 & 15, h >> 24 & 15, h >> 28 & 1, \
                h >> 29 & 1
            assert ((h >> 30 & 1) == (tab[rn, :, 1] >= n)).all()
            assert (tab[r, kp, ap] == p0).all() and (tab[r, kq, aq] == q0
                                                     ).all()
            assert (p0 == tab[rn, :, 0]).all() and (q0 == tab[rn, :, 1]
                                                    ).all()
            sp = np.where(ap == 1, -s[kp], s[kp])
            sq = np.where(aq == 1, -s[kq], s[kq])
            app = _entry00(A[p0, p0], A[p0, p1], A[p1, p0], A[p1, p1],
                           c[kp], sp, c[kp], sp)
            aqq = _entry00(A[q0, q0], A[q0, q1], A[q1, q0], A[q1, q1],
                           c[kq], sq, c[kq], sq)
            apq = np.where(h >> 31 & 1, 0.0, _entry00(
                A[p0, q0], A[p0, q1], A[p1, q0], A[p1, q1], c[kp], sp,
                c[kq], sq))
            c_next, s_next = rotation(app, aqq, apq, tab[rn, :, 1] < n)
            # the round: each block's owner
            pk, qk, pl, ql = p[K], q[K], p[L], q[L]
            rk, rl = qk < n, ql < n
            ck, sk, cl, sl = c[K], s[K], c[L], s[L]
            x = (A[pk, pl], A[pk, ql], A[qk, pl], A[qk, ql])
            diag = (K == L) & rk
            An = np.zeros((m, m))
            written = []
            for a, b, rows, cols, use in (
                    (0, 0, pk, pl, np.ones_like(rk)), (0, 1, pk, ql, rl),
                    (1, 0, qk, pl, rk), (1, 1, qk, ql, rk & rl)):
                z = _block_entry(*x, np.full_like(K, a), np.full_like(K, b),
                                 rk, rl, diag, ck, sk, cl, sl)
                An[rows[use], cols[use]] = z[use]
                written += list(zip(rows[use], cols[use]))
            assert sorted(written) == [(i, j) for i in range(n)
                                       for j in range(n)], (n, r)
            v00, v01, v10, v11 = V[pl, pk], V[pl, qk], V[ql, pk], V[ql, qk]
            for rows, cols, val, use in (
                    (pl, pk, ck * v00 - sk * v01, rk),
                    (pl, qk, sk * v00 + ck * v01, rk),
                    (ql, pk, ck * v10 - sk * v11, rk & rl),
                    (ql, qk, sk * v10 + ck * v11, rk & rl)):
                V[rows[use], cols[use]] = val[use]
            A = An
            c, s = c_next, s_next
            cd, sd = direct(rn)
            assert np.array_equal(c, cd) and np.array_equal(s, sd), (n, r)
    d = np.diagonal(A)[:n]
    order = np.argsort(d, kind="stable")
    return (d[order].astype(np.float32),
            V[:n, :n][:, order].astype(np.float32), sweeps)


def test_schedule_is_the_plain_versions_rounds():
    """The kernel's table holds `pairs(n)` round by round, a bye (odd n)
    first as (i, n) with the index the round leaves out: each round pairs
    every index once, and a sweep every index pair once."""
    for n in range(1, eigh.MAX_N + 1):
        m = n + n % 2
        tab = eigh.schedule(n)
        assert tab.dtype == torch.uint8 and tuple(tab.shape) == (
            m - 1, m // 2, 2), n
        seen = []
        for r, (ps, qs) in enumerate(eigh.pairs(n)):
            row = [tuple(pq) for pq in tab[r].tolist()]
            assert sorted(i for pq in row for i in pq) == list(range(m)), n
            assert all(p < q <= n for p, q in row), n
            real = [pq for pq in row if pq[1] < n]
            assert real == list(zip(ps, qs)), (n, r)
            assert len(row) - len(real) == n % 2 and (n % 2 == 0
                                                       or row[0][1] == n)
            seen += real
        assert sorted(seen) == [(p, q) for p in range(n)
                                for q in range(p + 1, n)], n


@pytest.mark.parametrize("kind", ["psd cond 1e7", "indefinite",
                                  "clustered"])
def test_kernel_rounds_bit_equal_to_reference(kind):
    """The emulation of K3's rounds against `jacobi_reference`, bit for
    bit, at n = 2 to 32: eigenvalues, eigenvectors, sweeps."""
    rng = np.random.default_rng({"psd cond 1e7": 5, "indefinite": 6,
                                 "clustered": 7}[kind])
    sweeps = set()
    for n in range(2, eigh.MAX_N + 1):
        if kind == "psd cond 1e7":
            A = _psd(rng, n, 1e7)
        elif kind == "indefinite":
            A = rng.normal(size=(n, n)) * 10.0 ** rng.uniform(-3, 6)
        else:
            A = _spectrum(rng, 1.0 + 1e-6 * rng.normal(size=n))
        A = _sym32(A)
        w, V, s = _kernel_emulation(A)
        wr, Vr, info = eigh.jacobi_reference(torch.from_numpy(A[None]),
                                             info=True)
        assert s == int(info["sweeps"][0]), (kind, n)
        assert np.array_equal(w, wr[0].numpy()), (kind, n)
        assert np.array_equal(V, Vr[0].numpy()), (kind, n)
        sweeps.add(s)
    assert max(sweeps) >= 5, sweeps
