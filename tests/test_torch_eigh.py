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
