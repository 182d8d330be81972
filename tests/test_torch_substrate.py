"""Port substrate against the JAX reference: config, synthetic data, lie,
linalg3, undistort, preintegration.

Inputs are made with numpy from a seed and handed to both packages as
explicit float32 (the conftest enables jax_enable_x64).  Tolerances:
f32 closed forms agree to atol 1e-6, preintegration to atol 1e-5.
"""

import dataclasses

import numpy as np
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from mmloam_tpu import config as jcfg  # noqa: E402
from mmloam_tpu import lie as jlie  # noqa: E402
from mmloam_tpu import replay as jreplay  # noqa: E402
from mmloam_tpu.data import synthetic as jsyn  # noqa: E402
from mmloam_tpu.ops import linalg3 as jlin  # noqa: E402
from mmloam_tpu.ops import preintegration as jpre  # noqa: E402
from mmloam_tpu.ops import undistort as jund  # noqa: E402

from mmloam_tpu_torch import config as tcfg  # noqa: E402
from mmloam_tpu_torch import lie as tlie  # noqa: E402
from mmloam_tpu_torch import replay as treplay  # noqa: E402
from mmloam_tpu_torch.data import synthetic as tsyn  # noqa: E402
from mmloam_tpu_torch.ops import linalg3 as tlin  # noqa: E402
from mmloam_tpu_torch.ops import preintegration as tpre  # noqa: E402
from mmloam_tpu_torch.ops import undistort as tund  # noqa: E402

RNG = np.random.default_rng(0)
ATOL = 1e-6


def f32(a):
    return np.asarray(a, np.float32)


def both(fn_j, fn_t, *args):
    """Run the JAX and torch functions on the same f32 numpy inputs."""
    rj = fn_j(*(jnp.asarray(a) for a in args))
    rt = fn_t(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    return np.asarray(rj), rt.numpy()


def rotvecs(n):
    v = RNG.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    ang = np.concatenate([RNG.uniform(0, 3.0, n - 8),
                          [0.0, 1e-7, 1e-6, 5e-6, 2e-5,
                           np.pi - 1e-4, np.pi - 1e-3, 3.1]])
    return f32(v * ang[:, None])


def test_config_copies_equal():
    for name in ("LIOConfig", "tiny_config", "faithful_config"):
        a = getattr(jcfg, name)()
        b = getattr(tcfg, name)()
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name
    Rj, tj = jcfg.reference_rig()
    Rt, tt = tcfg.reference_rig()
    np.testing.assert_array_equal(Rj, Rt)
    np.testing.assert_array_equal(tj, tt)


def test_synthetic_copy_equal():
    traj_j = jsyn.Trajectory(speed=0.9, yaw_rate=0.3)
    traj_t = tsyn.Trajectory(speed=0.9, yaw_rate=0.3)
    ts = np.linspace(0.0, 3.0, 17)
    np.testing.assert_array_equal(traj_j.rot(ts), traj_t.rot(ts))
    np.testing.assert_array_equal(traj_j.pos(ts), traj_t.pos(ts))
    for wj, wt in ((jsyn.default_world(), tsyn.default_world()),
                   (jsyn.corridor_world(), tsyn.corridor_world()),
                   (jsyn.office_world(), tsyn.office_world())):
        d = RNG.normal(size=(64, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        np.testing.assert_array_equal(wj.raycast(np.zeros(3), d),
                                      wt.raycast(np.zeros(3), d))
    a = jsyn.simulate_imu(traj_j, 0.0, 0.1, rng=np.random.default_rng(1),
                          noise_gyr=1e-3, noise_acc=1e-3)
    b = tsyn.simulate_imu(traj_t, 0.0, 0.1, rng=np.random.default_rng(1),
                          noise_gyr=1e-3, noise_acc=1e-3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_make_sequence_bit_exact():
    cfg_j, cfg_t = jcfg.tiny_config(), tcfg.tiny_config()
    kw = dict(n_az=180, seed=3, range_noise=0.003, imu_noise=(1e-3, 1e-3),
              dtype=np.float32, with_hori=True, hori_n_az=120)
    sj, gRj, gpj = jreplay.make_sequence(
        jsyn.default_world(), jsyn.Trajectory(speed=0.8), 0.0, 3, cfg_j,
        to_device=False, **kw)
    st, gRt, gpt = treplay.make_sequence(
        tsyn.default_world(), tsyn.Trajectory(speed=0.8), 0.0, 3, cfg_t,
        device="cpu", **kw)
    assert sj._fields == st._fields
    for name in sj._fields:
        a, b = getattr(sj, name), getattr(st, name)
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
        assert np.asarray(a).dtype == b.numpy().dtype, name
    np.testing.assert_array_equal(gRj, gRt)
    np.testing.assert_array_equal(gpj, gpt)


def test_lie_matches_jax():
    phi = rotvecs(64)
    for fj, ft in ((jlie.exp_matrix, tlie.exp_matrix),
                   (jlie.exp_quat, tlie.exp_quat),
                   (jlie.right_jacobian_inv, tlie.right_jacobian_inv),
                   (jlie.hat, tlie.hat)):
        a, b = both(fj, ft, phi)
        np.testing.assert_allclose(b, a, atol=ATOL, err_msg=fj.__name__)
    # Jr's (1 - cos t)/t cancels in f32: one ulp of cos near 1 (6e-8) in
    # either libm becomes 6e-8/t, so the bound adds two such ulps over t
    a, b = both(jlie.right_jacobian, tlie.right_jacobian, phi)
    theta = np.linalg.norm(phi.astype(np.float64), axis=1)
    tol = ATOL + np.where(theta < 1e-5, 0.0, 1.2e-7 / np.maximum(theta,
                                                                  1e-5))
    assert (np.abs(b - a).reshape(-1, 9).max(1) <= tol).all()
    q = np.asarray(jlie.exp_quat(jnp.asarray(phi)))
    R = np.asarray(jlie.exp_matrix(jnp.asarray(phi)))
    for fj, ft, x in ((jlie.log_quat, tlie.log_quat, q),
                      (jlie.quat_to_matrix, tlie.quat_to_matrix, q),
                      (jlie.matrix_to_quat, tlie.matrix_to_quat, R),
                      (jlie.quat_normalize, tlie.quat_normalize, 1.3 * q)):
        a, b = both(fj, ft, x)
        np.testing.assert_allclose(b, a, atol=ATOL, err_msg=fj.__name__)
    # log near pi is ill-conditioned in f32: compare the rotations
    a, b = both(jlie.log_matrix, tlie.log_matrix, R)
    np.testing.assert_allclose(
        tlie.exp_matrix(torch.from_numpy(b)).numpy(),
        np.asarray(jlie.exp_matrix(jnp.asarray(a))), atol=ATOL)
    q2 = f32(np.roll(q, 5, axis=0))
    v = f32(RNG.normal(size=(64, 3)))
    s = f32(RNG.uniform(0, 1, 64))
    for fj, ft, args in ((jlie.quat_mul, tlie.quat_mul, (q, q2)),
                         (jlie.quat_rotate, tlie.quat_rotate, (q, v)),
                         (jlie.slerp_identity, tlie.slerp_identity, (q, s)),
                         (jlie.quat_angular_distance,
                          tlie.quat_angular_distance, (q, q2))):
        a, b = both(fj, ft, *args)
        np.testing.assert_allclose(b, a, atol=ATOL, err_msg=fj.__name__)


def test_linalg3_matches_jax():
    X = f32(RNG.normal(size=(128, 6, 3)) * RNG.uniform(0.01, 1.0, (128, 1, 3)))
    A = f32(np.einsum("kni,knj->kij", X, X) / 6.0)
    A[:4] = np.diag([0.3, 0.3, 0.3])                 # isotropic
    A[4:8] = np.diag([1.0, 2.0, 3.0])                # exactly diagonal
    ev_j, ev_t = both(jlin.eigvalsh3, tlin.eigvalsh3, A)
    np.testing.assert_allclose(ev_t, ev_j, atol=ATOL)
    for fj, ft in ((jlin.principal_eigvec3, tlin.principal_eigvec3),
                   (jlin.smallest_eigvec3, tlin.smallest_eigvec3)):
        a, b = both(fj, ft, A, ev_j)
        # the eigenvector of a (near-)degenerate spectrum is arbitrary;
        # compare where the gap makes it well defined
        gap = np.minimum(ev_j[:, 2] - ev_j[:, 1], ev_j[:, 1] - ev_j[:, 0])
        ok = gap > 1e-3 * np.maximum(ev_j[:, 2], 1e-9)
        np.testing.assert_allclose(b[ok], a[ok], atol=1e-5,
                                   err_msg=fj.__name__)
    rhs = f32(RNG.normal(size=(128, 3)))
    a, b = both(jlin.solve3, tlin.solve3, A + f32(np.eye(3)), rhs)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=ATOL)


def test_undistort_matches_jax():
    pts = f32(RNG.uniform(-20, 20, (512, 3)))
    rel = f32(RNG.uniform(0, 1, 512))
    dq = f32(np.asarray(jlie.exp_quat(jnp.asarray(f32([0.01, -0.02, 0.05])))))
    dt = f32([0.08, -0.03, 0.01])
    dq2 = f32(np.asarray(jlie.exp_quat(jnp.asarray(f32([0.0, 0.01, 0.04])))))
    dt2 = f32([0.07, -0.02, 0.0])
    for fj, ft, args in (
            (jund.undistort, tund.undistort, (pts, rel, dq, dt)),
            (jund.undistort_inverse, tund.undistort_inverse,
             (pts, rel, dq, dt)),
            (jund.reundistort, tund.reundistort,
             (pts, rel, dq, dt, dq2, dt2))):
        a, b = both(fj, ft, *args)
        np.testing.assert_allclose(b, a, atol=1e-5, err_msg=fj.__name__)


def test_preintegration_matches_jax():
    cfg = jcfg.ImuConfig()
    M = 64
    acc = f32(RNG.normal(size=(M, 3)) * 0.1 + [0.0, 0.0, 1.0])
    gyr = f32(RNG.normal(size=(M, 3)) * 0.3)
    dt = f32(np.full(M, 0.005) + RNG.uniform(0, 1e-4, M))
    mask = np.arange(M) < 21
    bg = f32([0.01, -0.02, 0.005])
    ba = f32([0.05, 0.0, -0.03])
    rj = jpre.preintegrate(*(jnp.asarray(a) for a in
                             (acc, gyr, dt, mask, bg, ba)), cfg)
    rt = tpre.preintegrate(*(torch.from_numpy(a) for a in
                             (acc, gyr, dt, mask, bg, ba)), cfg)
    for name in rj._fields:
        a, b = np.asarray(getattr(rj, name)), getattr(rt, name).numpy()
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, atol=1e-5 * scale, err_msg=name)
    a, b = both(jpre.gyro_integrate, tpre.gyro_integrate, gyr, dt, mask)
    np.testing.assert_allclose(b, a, atol=1e-5)
    a = np.asarray(jpre.average_acc(jnp.asarray(acc), jnp.asarray(mask), cfg))
    b = tpre.average_acc(torch.from_numpy(acc), torch.from_numpy(mask),
                         cfg).numpy()
    np.testing.assert_allclose(b, a, atol=1e-5)
    # sqrt information: compare the information J^T J it encodes
    cov = np.asarray(rj.cov)
    sj = np.asarray(jpre.sqrt_info_from_cov(jnp.asarray(cov)))
    st = tpre.sqrt_info_from_cov(torch.from_numpy(cov)).numpy()
    np.testing.assert_allclose(st.T @ st, sj.T @ sj,
                               rtol=1e-4, atol=1e-3 * np.abs(sj.T @ sj).max())
