"""The port's public API beyond the replay path, against the JAX reference.

`features.extract_line_features`, `preintegration.preintegrate_sequential`,
`factors.localizability` and the residuals `line_residual`,
`plane_residual`, `imu_residual` complete the port's counterpart of the
JAX package; none sits on the replay path.  Each is held against its JAX
counterpart on seeded numpy inputs, at the tolerance the reference's own
test of it uses:

* labels exactly (tests/test_features.py's lines, plus noisy ones);
* `preintegrate_sequential` against JAX's and against the port's
  parallel `preintegrate` at tests/test_preintegration.py:211's bounds;
* `localizability`: (degenerate, fail) exactly and sv_min within 1e-5 on
  tests/test_solver.py:121-135's corridor normals;
* the residuals against JAX's in f32 (1e-5 relative, or a few f32 ulps
  of the world points) and in float64, their Jacobians finite where a
  residual is exactly zero (the `_safe_norm` guard), and
  `torch.func.jacfwd(imu_residual)` against `imu_residual_and_jac` in
  float64 at tests/test_solver.py:317's bounds.
"""

import numpy as np
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from mmloam_tpu import lie as jlie  # noqa: E402
from mmloam_tpu.config import ImuConfig as JImuConfig  # noqa: E402
from mmloam_tpu.config import tiny_config as jax_tiny_config  # noqa: E402
from mmloam_tpu.estimator import factors as jfac  # noqa: E402
from mmloam_tpu.ops import features as jfeat  # noqa: E402
from mmloam_tpu.ops import preintegration as jpre  # noqa: E402

from mmloam_tpu_torch import lie  # noqa: E402
from mmloam_tpu_torch.config import ImuConfig, tiny_config  # noqa: E402
from mmloam_tpu_torch.estimator import factors  # noqa: E402
from mmloam_tpu_torch.ops import features, preintegration  # noqa: E402

CFG, JCFG = tiny_config(), jax_tiny_config()
N = 256


def t(a):
    return torch.as_tensor(np.array(a))


# --------------------------------------------------------------------------
# extract_line_features
# --------------------------------------------------------------------------

def _sweep(angles, dist_of):
    pts = []
    for a in angles:
        d = np.array([np.cos(a), np.sin(a), 0.0])
        pts.append(dist_of(a, d) * d)
    return np.asarray(pts, np.float32)


def _lines():
    """tests/test_features.py's lines (flat wall, inside corner, depth gap)
    and two seeded noisy ones with intensities."""
    rng = np.random.default_rng(5)
    ang = np.linspace(-0.5, 0.5, 200)
    wall = np.stack([np.full(200, 5.0), 5.0 * np.tan(ang), np.zeros(200)],
                    axis=1).astype(np.float32)
    fold = _sweep(np.linspace(np.pi / 4 - 0.35, np.pi / 4 + 0.35, 200),
                  lambda a, d: 5.0 / d[0] if a <= np.pi / 4 else 5.0 / d[1])
    gap = _sweep(np.linspace(-0.4, 0.4, 200),
                 lambda a, d: (4.0 if a < 0 else 9.0) / d[0])
    noisy = fold + rng.normal(0, 0.01, fold.shape).astype(np.float32)
    room = _sweep(np.linspace(-np.pi, np.pi, 240, endpoint=False),
                  lambda a, d: min(6.0 / max(abs(d[0]), 1e-6),
                                   4.0 / max(abs(d[1]), 1e-6)))
    room = room + rng.normal(0, 0.005, room.shape).astype(np.float32)
    return dict(wall=(wall, None), fold=(fold, None), gap=(gap, None),
                noisy_fold=(noisy, rng.uniform(0, 60, 200)),
                room=(room, rng.uniform(0, 60, 240)))


@pytest.mark.parametrize("name", sorted(_lines()))
def test_extract_line_features_matches_jax(name):
    pts, inten = _lines()[name]
    n = len(pts)
    p = np.zeros((N, 3), np.float32)
    p[:n] = pts
    i = np.zeros(N, np.float32)
    if inten is not None:
        i[:n] = inten
    want = np.asarray(jfeat.extract_line_features(
        jnp.asarray(p), jnp.asarray(i), jnp.int32(n), JCFG))
    got = features.extract_line_features(t(p), t(i), n, CFG)
    assert got.dtype == torch.int32 and got.shape == (N,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).any(), f"{name}: no feature picked"


# --------------------------------------------------------------------------
# preintegrate_sequential
# --------------------------------------------------------------------------

def _imu_inputs(seed=7, M=48, lanes=()):
    """tests/test_preintegration.py:199-208's inputs (seed 7, M 48)."""
    rng = np.random.default_rng(seed)
    sh = tuple(lanes)
    acc = (rng.normal(0, 0.3, sh + (M, 3)) + [0, 0, 1.0]).astype(np.float32)
    gyr = rng.normal(0, 0.5, sh + (M, 3)).astype(np.float32)
    dt = rng.uniform(0.004, 0.006, sh + (M,)).astype(np.float32)
    mask = rng.uniform(size=sh + (M,)) > 0.2
    bg = np.broadcast_to(np.float32([0.01, -0.02, 0.005]), sh + (3,))
    ba = np.broadcast_to(np.float32([-0.03, 0.01, 0.02]), sh + (3,))
    return acc, gyr, dt, mask, bg.copy(), ba.copy()


def _assert_preint_close(a, b):
    """tests/test_preintegration.py:212-219's bounds."""
    np.testing.assert_allclose(np.asarray(a.dq), np.asarray(b.dq), atol=2e-6)
    np.testing.assert_allclose(np.asarray(a.dp), np.asarray(b.dp), atol=2e-5)
    np.testing.assert_allclose(np.asarray(a.dv), np.asarray(b.dv), atol=2e-5)
    np.testing.assert_allclose(np.asarray(a.jac), np.asarray(b.jac),
                               atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(a.cov), np.asarray(b.cov),
                               atol=1e-9, rtol=2e-3)
    np.testing.assert_allclose(np.asarray(a.dtime), np.asarray(b.dtime),
                               rtol=1e-6)


def test_preintegrate_sequential_matches_jax_and_parallel():
    args = _imu_inputs()
    seq = preintegration.preintegrate_sequential(*map(t, args), ImuConfig())
    want = jpre.preintegrate_sequential(*map(jnp.asarray, args),
                                        JImuConfig())
    _assert_preint_close(seq, want)
    par = preintegration.preintegrate(*map(t, args), ImuConfig())
    _assert_preint_close(par, seq)


def test_preintegrate_sequential_lanes_are_independent():
    """Leading axes are lanes: each lane agrees with its own call (the
    batched products round by the batch, so to the bounds above)."""
    args = _imu_inputs(seed=11, M=40, lanes=(3,))
    both = preintegration.preintegrate_sequential(*map(t, args), ImuConfig())
    for b in range(3):
        one = preintegration.preintegrate_sequential(
            *(t(a[b]) for a in args), ImuConfig())
        _assert_preint_close(type(one)(*(f[b] for f in both)), one)


# --------------------------------------------------------------------------
# localizability
# --------------------------------------------------------------------------

LOC_CASES = {
    # normals spanning three directions: localizable
    "three_directions": (np.tile(np.eye(3), (20, 1)), np.ones(60, bool)),
    # a corridor: two wall directions, degenerate
    "corridor": (np.tile(np.array([[1.0, 0, 0], [0, 0, 1.0]]), (30, 1)),
                 np.ones(60, bool)),
    # too few normals: fail, sv_min -1
    "too_few": (np.tile(np.eye(3), (20, 1)), np.arange(60) < 5),
    # seeded unit normals, a third of them masked out
    "random": (np.random.default_rng(2).normal(size=(90, 3)),
               np.random.default_rng(3).uniform(size=90) > 0.33),
}


@pytest.mark.parametrize("name", sorted(LOC_CASES))
def test_localizability_matches_jax(name):
    normals, valid = LOC_CASES[name]
    normals = (normals / np.linalg.norm(normals, axis=1,
                                        keepdims=True)).astype(np.float32)
    want = jfac.localizability(jnp.asarray(normals), jnp.asarray(valid),
                               JCFG)
    got = factors.localizability(t(normals), t(valid), CFG)
    assert bool(got[0]) == bool(want[0]) and bool(got[1]) == bool(want[1])
    np.testing.assert_allclose(float(got[2]), float(want[2]), atol=1e-5)
    if name == "too_few":
        assert bool(got[1]) and float(got[2]) == -1.0


# --------------------------------------------------------------------------
# residuals
# --------------------------------------------------------------------------

def _point_factors(dtype, K=24, seed=4):
    """A pose, a rig extrinsic and K line and plane targets, seeded; the
    first four targets of each pass exactly through their point (a zero
    residual, where `_safe_norm` keeps the Jacobian finite) and the last
    two are invalid."""
    rng = np.random.default_rng(seed)
    x6 = np.concatenate([rng.normal(0, 1.0, 3), rng.normal(0, 0.2, 3)])
    Rbl = np.asarray(jlie.exp_matrix(jnp.asarray(rng.normal(0, 0.05, 3))),
                     np.float64)
    tbl = rng.normal(0, 0.1, 3)
    p_l = rng.uniform(-8, 8, (K, 3))
    Rwb = np.asarray(jlie.exp_matrix(jnp.asarray(x6[3:])), np.float64)
    pw = p_l @ (Rwb @ Rbl).T + (Rwb @ tbl + x6[:3])
    u = rng.normal(size=(K, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    c = pw + rng.normal(0, 0.1, (K, 3))
    c[:4] = pw[:4] - 2.0 * u[:4]          # on the line
    proj = pw + rng.normal(0, 0.05, (K, 3))
    proj[:4] = pw[:4]                     # on the plane
    sqrt_info = np.eye(3) * np.array([1.0, 0.3, 0.3]) + rng.normal(
        0, 0.05, (K, 3, 3))
    valid = np.ones(K, bool)
    valid[-2:] = False
    cast = lambda a: np.asarray(a, dtype)
    return dict(x6=cast(x6), Rbl=cast(Rbl), tbl=cast(tbl), p_l=cast(p_l),
                c=cast(c), u=cast(u), proj=cast(proj),
                sqrt_info=cast(sqrt_info), valid=valid,
                pw_max=float(np.abs(pw).max()))


def _residual_fns(kind, d):
    """(the reference's residual of x6, the port's) on d's targets."""
    if kind == "line":
        make = lambda mod, to: mod.LineTargets(
            p_l=to(d["p_l"]), c=to(d["c"]), u=to(d["u"]), valid=to(d["valid"]))
    else:
        make = lambda mod, to: mod.PlaneTargets(
            p_l=to(d["p_l"]), proj=to(d["proj"]),
            sqrt_info=to(d["sqrt_info"]), valid=to(d["valid"]))
    jtgt, ttgt = make(jfac, jnp.asarray), make(factors, t)
    jres = getattr(jfac, kind + "_residual")
    tres = getattr(factors, kind + "_residual")
    jrig = (jnp.asarray(d["Rbl"]), jnp.asarray(d["tbl"]))
    trig = (t(d["Rbl"]), t(d["tbl"]))
    return (lambda x: jres(x, jtgt, *jrig)), (lambda x: tres(x, ttgt, *trig))


@pytest.mark.parametrize("kind", ["line", "plane"])
def test_point_residual_matches_jax(kind):
    """f32: within 1e-5 relative, or 8 f32 ulps of the largest world
    coordinate absolute (both packages round the world points to f32
    before differencing them); zero on invalid rows, ~0 on the targets.
    float64: the residual within 1e-12 and its Jacobian
    (torch.func.jacfwd against jax.jacfwd) within 1e-9 relative, finite
    at the zero residuals."""
    d = _point_factors(np.float32)
    jfn, tfn = _residual_fns(kind, d)
    want = np.asarray(jfn(jnp.asarray(d["x6"])))
    got = tfn(t(d["x6"]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=8 * 2.0 ** -24 * d["pw_max"])
    assert np.abs(want[-2:]).max() == 0 and got[-2:].abs().max() == 0
    assert float(got[:4].abs().max()) < 1e-4

    d = _point_factors(np.float64)
    jfn, tfn = _residual_fns(kind, d)
    x = d["x6"]
    np.testing.assert_allclose(tfn(t(x)).numpy(),
                               np.asarray(jfn(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    J = torch.func.jacfwd(tfn)(t(x)).numpy()
    J_ref = np.asarray(jax.jacfwd(jfn)(jnp.asarray(x)))
    assert np.isfinite(J).all() and np.isfinite(J_ref).all()
    np.testing.assert_allclose(J, J_ref, rtol=1e-9,
                               atol=1e-9 * np.abs(J_ref).max())


def _imu_meas(rng):
    """tests/test_solver.py:329-339's measurement, float64."""
    return {"dq": np.asarray(jlie.exp_quat(jnp.asarray(
                rng.normal(scale=0.3, size=3)))),
            "dp": rng.normal(size=3), "dv": rng.normal(size=3),
            "jac": np.eye(15) + rng.normal(size=(15, 15)) * 0.1,
            "sqrt_info": np.eye(15) + rng.normal(size=(15, 15)) * 0.05,
            "dt": np.float64(0.1), "bg": rng.normal(scale=0.02, size=3),
            "ba": rng.normal(scale=0.02, size=3)}


@pytest.mark.parametrize("seed", [3, 8])
def test_imu_residual_matches_jax_and_its_jacobian(seed):
    """tests/test_solver.py:317's inputs (seeds 3 and 8).  f32: within
    1e-5 of JAX's relative to the residual's scale.  float64: within
    1e-12 of JAX's, and torch.func.jacfwd(imu_residual) against
    imu_residual_and_jac at tests/test_solver.py:345-348's bounds."""
    rng = np.random.default_rng(seed)
    g = np.array([0.0, 0.0, -9.805])
    for _ in range(4):
        xi = rng.normal(scale=0.8, size=15)
        xj = rng.normal(scale=0.8, size=15)
        meas = _imu_meas(rng)
        for dtype, rtol in ((np.float32, 1e-5), (np.float64, 1e-12)):
            jm = {k: jnp.asarray(v, dtype) for k, v in meas.items()}
            tm = {k: t(np.asarray(v, dtype)) for k, v in meas.items()}
            want = np.asarray(jfac.imu_residual(
                jnp.asarray(xi, dtype), jnp.asarray(xj, dtype), jm,
                jnp.asarray(g, dtype)))
            got = factors.imu_residual(t(xi.astype(dtype)),
                                       t(xj.astype(dtype)), tm,
                                       t(g.astype(dtype)))
            np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                                       atol=rtol * np.abs(want).max())

        z = t(np.concatenate([xi, xj]))
        J_ad = torch.func.jacfwd(lambda zz: factors.imu_residual(
            zz[:15], zz[15:], tm, t(g)))(z)
        r_an, J_an = factors.imu_residual_and_jac(z[:15], z[15:], tm, t(g))
        r = factors.imu_residual(z[:15], z[15:], tm, t(g))
        torch.testing.assert_close(r_an, r, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(J_an, J_ad, rtol=1e-7, atol=1e-9)


def test_imu_residual_jacobian_finite_at_zero():
    """At a zero residual (xj reached from xi = 0 by the measured deltas,
    no gravity, biases at their linearization point) the residual is 0
    and its Jacobian finite."""
    m = {k: t(v) for k, v in _imu_meas(np.random.default_rng(1)).items()}
    m["bg"] = torch.zeros(3, dtype=torch.float64)
    m["ba"] = torch.zeros(3, dtype=torch.float64)
    xi = torch.zeros(15, dtype=torch.float64)
    xj = torch.zeros(15, dtype=torch.float64)
    xj[0:3] = m["dp"]
    xj[3:6] = lie.log_matrix(lie.quat_to_matrix(m["dq"]))
    xj[6:9] = m["dv"]
    g0 = torch.zeros(3, dtype=torch.float64)
    assert float(factors.imu_residual(xi, xj, m, g0).abs().max()) < 1e-12
    J = torch.func.jacfwd(lambda x: factors.imu_residual(xi, x, m, g0))(xj)
    assert torch.isfinite(J).all()
