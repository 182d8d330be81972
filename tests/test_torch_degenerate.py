"""The direction-selective degenerate update (`pipeline.
project_degenerate_update`) against the JAX package: the four unit tests of
tests/test_degenerate.py:60-122, each on the port and on the reference
with the same seeded windows.

Each test holds the port's output to the reference test's own semantics
and bounds, and to the reference's output within JAX_ATOL: the projector
comes from the closed-form 3x3 eigenvectors (ops/linalg3), whose f32
rounding differs between the packages in the last bits.  The corridor and
box-room replays run on the card (tests/test_torch_reference_checks.py).
"""

import numpy as np
import torch

torch.set_num_threads(1)

from mmloam_tpu import pipeline as jp  # noqa: E402
from mmloam_tpu.config import tiny_config as jax_tiny_config  # noqa: E402

from mmloam_tpu_torch import pipeline as tp  # noqa: E402
from mmloam_tpu_torch.config import tiny_config  # noqa: E402

CFG = tiny_config()
GATE = CFG.solver.degenerate_sv
JAX_ATOL = 1e-5


def _window(seed, W=5):
    rng = np.random.default_rng(seed)
    x_w = rng.normal(size=(W, 15)).astype(np.float32)
    x_opt = x_w + 0.1 * rng.normal(size=(W, 15)).astype(np.float32)
    return x_w, x_opt


def _both(x_opt, x_w, NtN, fail):
    """(port, reference) outputs as numpy."""
    assert jax_tiny_config().solver.degenerate_sv == GATE
    got = tp.project_degenerate_update(
        torch.from_numpy(x_opt), torch.from_numpy(x_w),
        torch.from_numpy(NtN), torch.tensor(fail), GATE).numpy()
    want = np.asarray(jp.project_degenerate_update(x_opt, x_w, NtN, fail,
                                                   GATE))
    np.testing.assert_allclose(got, want, atol=JAX_ATOL)
    return got


def test_projection_holds_unobservable_axis():
    """Corridor axis x unobservable: y/z translation and velocity keep the
    optimized values, x holds the pre-solve ones; rotation and biases stay
    optimized (Estimator.cpp:1050-1066)."""
    x_w, x_opt = _window(0)
    NtN = np.diag([1e-4, 25.0, 49.0]).astype(np.float32)
    out = _both(x_opt, x_w, NtN, True)
    for sl in (slice(0, 3), slice(6, 9)):
        np.testing.assert_allclose(out[:, sl][:, 0], x_w[:, sl][:, 0],
                                   atol=1e-5)
        np.testing.assert_allclose(out[:, sl][:, 1:], x_opt[:, sl][:, 1:],
                                   atol=1e-5)
    np.testing.assert_allclose(out[:, 3:6], x_opt[:, 3:6], atol=1e-6)
    np.testing.assert_allclose(out[:, 9:15], x_opt[:, 9:15], atol=1e-6)


def test_projection_rotated_null_direction():
    """Basis-free: a corridor at 45 deg in the xy plane suppresses the
    along-axis component of the P/V delta and keeps both others."""
    x_w, x_opt = _window(1)
    u = np.array([1.0, 1.0, 0.0], np.float32) / np.sqrt(2.0)
    a = np.array([1.0, -1.0, 0.0], np.float32) / np.sqrt(2.0)
    b = np.array([0.0, 0.0, 1.0], np.float32)
    NtN = (25.0 * np.outer(a, a) + 49.0 * np.outer(b, b)
           + 1e-4 * np.outer(u, u)).astype(np.float32)
    out = _both(x_opt, x_w, NtN, True)
    for sl in (slice(0, 3), slice(6, 9)):
        d_in, d_out = x_opt[:, sl] - x_w[:, sl], out[:, sl] - x_w[:, sl]
        np.testing.assert_allclose(d_out @ u, 0.0, atol=1e-5)
        np.testing.assert_allclose(d_out @ a, d_in @ a, atol=1e-5)
        np.testing.assert_allclose(d_out @ b, d_in @ b, atol=1e-5)


def test_projection_zero_ntn_full_revert():
    """NtN ~ 0 (too few normals): P and V revert to the pre-solve window,
    rotation stays optimized."""
    x_w, x_opt = _window(2)
    out = _both(x_opt, x_w, np.zeros((3, 3), np.float32), True)
    np.testing.assert_allclose(out[:, 0:3], x_w[:, 0:3], atol=1e-6)
    np.testing.assert_allclose(out[:, 6:9], x_w[:, 6:9], atol=1e-6)
    np.testing.assert_allclose(out[:, 3:6], x_opt[:, 3:6], atol=1e-6)


def test_projection_noop_when_not_failed():
    """fail=False passes the optimized window through untouched, even for
    a rank-deficient NtN."""
    x_w, x_opt = _window(3)
    out = _both(x_opt, x_w, np.diag([1e-4, 25.0, 49.0]).astype(np.float32),
                False)
    np.testing.assert_allclose(out, x_opt, atol=0)
