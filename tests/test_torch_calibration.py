"""The port's rig calibration (data/calibration.py) and the selection entry
points it needs (ops/voxelmap.py) against the JAX reference.

* `kth_smallest` and `select_k_smallest` on tied candidate blocks: equal.
* `query_knn` where eight candidates tie: the same neighbours in the same
  order as the reference's `lax.top_k` (lower candidate index first).
* `_cloud_normals` on the same cloud: the same rows fitted, normals
  within NORMAL_ATOL.
* One `_icp_core` GN step (and three) from the same map and `x0`: pose
  within STEP_ATOL, residual and weight sum within 1e-5 relative.  The
  solve is chaotic across basins on cluttered scenes (see the reference),
  so it is held step by step.
* `icp_extrinsic` and `align_startup` against ground truth with the bounds
  of tests/test_calibration.py, and `icp_extrinsic` against the
  reference's T within T_ATOL (a looser bound: 25 + 12 chained steps).
* `estimate_time_offset` picks the reference's offset, scores within
  SCORE_ATOL (sums of a few thousand f32 distances in another order).
"""

import numpy as np
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from mmloam_tpu import lie as jlie  # noqa: E402
from mmloam_tpu.config import tiny_config as jax_tiny_config  # noqa: E402
from mmloam_tpu.data import calibration as jcal  # noqa: E402
from mmloam_tpu.data import synthetic as jsyn  # noqa: E402
from mmloam_tpu.ops import voxelmap as jvm  # noqa: E402

from mmloam_tpu_torch.config import MapConfig, tiny_config  # noqa: E402
from mmloam_tpu_torch.data import calibration as tcal  # noqa: E402
from mmloam_tpu_torch.ops import voxelmap as tvm  # noqa: E402

CFG = tiny_config()
JCFG = jax_tiny_config()
NORMAL_ATOL = 1e-4
STEP_ATOL = 1e-6
T_ATOL = 1e-4
SCORE_ATOL = 1e-5


def _rot_err(Ta, Tb):
    return float(np.linalg.norm(np.asarray(jlie.log_matrix(
        jnp.asarray(Ta[:3, :3] @ Tb[:3, :3].T, jnp.float32)))))


def _T(phi, t):
    T = np.eye(4)
    T[:3, :3] = np.asarray(jlie.exp_matrix(jnp.asarray(phi, jnp.float32)))
    T[:3, 3] = t
    return T


def _two_lidar_clouds(rng, T_true):
    """tests/test_calibration.py's rig: velo and hori clouds of the same
    world, the hori points in the hori frame."""
    world = jsyn.default_world()
    dirs = rng.normal(size=(6000, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    r = world.raycast(np.zeros(3), dirs)
    ok = np.isfinite(r)
    velo = dirs[ok] * r[ok][:, None]
    sel = np.abs(np.arctan2(dirs[ok][:, 1], dirs[ok][:, 0])) < 1.6
    R, t = T_true[:3, :3], T_true[:3, 3]
    hori = (velo[sel] - t) @ R
    return velo.astype(np.float32), hori.astype(np.float32)


def test_kth_and_select_k_smallest_are_exact():
    rng = np.random.default_rng(0)
    # quantized distances: many exact ties, some rows with < k valid
    d2 = (rng.integers(0, 12, (64, 12, 32)) * 0.25).astype(np.float32)
    ok = rng.random((64, 12, 32)) > 0.3
    ok[:4] = rng.random((4, 12, 32)) > 0.995
    for k in (1, 5, 7):
        want = jvm.select_k_smallest(jnp.asarray(d2), jnp.asarray(ok), k)
        got = tvm.select_k_smallest(torch.from_numpy(d2),
                                    torch.from_numpy(ok), k)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(
            tvm.kth_smallest(torch.from_numpy(d2), torch.from_numpy(ok),
                             k).numpy(),
            np.asarray(jvm.kth_smallest(jnp.asarray(d2), jnp.asarray(ok), k)))
    assert np.isinf(got[0].numpy()[:4]).any()


def test_query_knn_ties_match_top_k():
    mcfg = MapConfig(dim_x=16, dim_y=16, dim_z=8, voxel_size=1.0)
    g = np.stack(np.meshgrid(np.arange(-3, 3), np.arange(-3, 3),
                             np.arange(-2, 2), indexing="ij"), -1)
    centers = (g.reshape(-1, 3) + 0.5).astype(np.float32)
    vm = tvm.insert(tvm.empty_map(mcfg), torch.from_numpy(centers),
                    torch.ones(len(centers), dtype=torch.bool), mcfg)
    # queries on cell corners (8 equidistant centroids), on centers, and
    # one masked off
    q = np.array([[0, 0, 0], [1, -1, 0], [-2, 1, 1], [0.5, 0.5, 0.5],
                  [1.5, -0.5, -1.5], [0, 0, 0]], np.float32)
    mask = np.array([1, 1, 1, 1, 1, 0], bool)
    got = tvm.query_knn(vm, torch.from_numpy(q), torch.from_numpy(mask),
                        mcfg)
    want = jvm.query_knn(jvm.VoxelMap(jnp.asarray(vm.cells.numpy())),
                         jnp.asarray(q), jnp.asarray(mask), mcfg)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    d2 = got[2].numpy()
    assert (d2[0] == d2[0, 0]).all() and np.isinf(d2[5]).all()


def _src_map(rng):
    T = _T([0.01, -0.02, 0.05], [0.15, -0.1, 0.05])
    velo, hori = _two_lidar_clouds(rng, T)
    return T, velo, hori


def test_cloud_normals_match_jax():
    _, _, hori = _src_map(np.random.default_rng(0))
    src = torch.from_numpy(hori)
    mask = tcal._crop(src, torch.isfinite(src).all(dim=-1))
    got = tcal._cloud_normals(src, mask, CFG, 0.1).numpy()
    jsrc = jnp.asarray(hori)
    want = np.asarray(jcal._cloud_normals(
        jsrc, jcal._crop(jsrc, jnp.isfinite(jsrc).all(axis=-1)), JCFG, 0.1))
    fitted = np.abs(got).sum(1) > 0
    np.testing.assert_array_equal(fitted, np.abs(want).sum(1) > 0)
    assert fitted.mean() > 0.2
    np.testing.assert_allclose(got, want, atol=NORMAL_ATOL)


def test_icp_core_steps_match_jax():
    """From the same map and x0, one and three GN steps agree."""
    _, velo, hori = _src_map(np.random.default_rng(0))
    dst = torch.from_numpy(velo)
    dst_mask = tcal._crop(dst, torch.isfinite(dst).all(dim=-1))
    mcfg = tcal._fitted_map_config(CFG.map, velo, 0.4, mask=dst_mask.numpy())
    vm = tvm.insert(tvm.empty_map(mcfg), dst, dst_mask, mcfg)
    jvm_map = jvm.insert(jvm.empty_map(mcfg), jnp.asarray(velo),
                         jnp.asarray(dst_mask.numpy()), mcfg)
    np.testing.assert_array_equal(vm.cells.numpy(), np.asarray(jvm_map.cells))
    src = torch.from_numpy(hori)
    src_mask = tcal._crop(src, torch.isfinite(src).all(dim=-1))
    normals = tcal._cloud_normals(src, src_mask, CFG, 0.1)
    x0 = np.array([0.05, -0.03, 0.02, 0.004, -0.01, 0.03], np.float32)
    for iters in (1, 3):
        x, resid, count = tcal._icp_core(src, src_mask, vm,
                                         torch.from_numpy(x0),
                                         CFG.replace(map=mcfg), iters,
                                         src_normals=normals)
        xj, rj, cj = jcal._icp_core(
            jnp.asarray(hori), jnp.asarray(src_mask.numpy()), jvm_map,
            jnp.asarray(x0), JCFG.replace(map=mcfg), iters,
            src_normals=jnp.asarray(normals.numpy()))
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=STEP_ATOL,
                                   err_msg=f"{iters} steps")
        np.testing.assert_allclose(float(resid), float(rj), rtol=1e-5)
        np.testing.assert_allclose(float(count), float(cj), rtol=1e-5)
        assert float(count) > 200


def test_icp_extrinsic_against_truth_and_jax():
    T, velo, hori = _src_map(np.random.default_rng(0))
    T_t, resid, n = tcal.icp_extrinsic(hori, velo, CFG, iters=25,
                                       device="cpu")
    T_j, _, n_j = jcal.icp_extrinsic(hori, velo, JCFG, iters=25)
    assert n > 200 and abs(n - n_j) <= 1
    assert np.linalg.norm(T_t[:3, 3] - T[:3, 3]) < 0.03, resid
    assert _rot_err(T_t, T) < 0.01
    np.testing.assert_allclose(T_t, T_j, atol=T_ATOL)


def test_align_startup_against_truth():
    """tests/test_calibration.py's startup scene: six sparse Horizon frames
    integrated, then one GICP against the Velodyne cloud."""
    rng = np.random.default_rng(5)
    T = _T([0.02, 0.01, 0.06], [0.2, -0.05, 0.08])
    R = T[:3, :3]
    world = jsyn.default_world()
    frames = []
    for _ in range(6):
        dirs = rng.normal(size=(700, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        dirs = dirs[np.abs(np.arctan2(dirs[:, 1], dirs[:, 0])) < 1.6]
        r = world.raycast(np.zeros(3), dirs)
        ok = np.isfinite(r)
        frames.append(((dirs[ok] * r[ok][:, None] - T[:3, 3]) @ R)
                      .astype(np.float32))
    dirs = rng.normal(size=(6000, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    r = world.raycast(np.zeros(3), dirs)
    ok = np.isfinite(r)
    velo = (dirs[ok] * r[ok][:, None]).astype(np.float32)
    T_est, _, n = tcal.align_startup(frames, velo, CFG, device="cpu")
    assert n > 250
    assert np.linalg.norm(T_est[:3, 3] - T[:3, 3]) < 0.04
    assert _rot_err(T_est, T) < 0.012


def test_time_offset_matches_jax():
    """tests/test_calibration.py's scene: a Horizon stream stamped 0.07 s
    late against one Velodyne scan, on a 0.01 s grid."""
    rng = np.random.default_rng(1)
    world = jsyn.default_world()
    traj = jsyn.Trajectory(speed=1.0, yaw_rate=0.8)
    t0, t1 = 1.0, 1.1
    pts_v, valid_v, _ = jsyn.simulate_scan(world, traj.rot(t0 + 0.05),
                                           traj.pos(t0 + 0.05), n_az=720)
    velo = pts_v[valid_v]
    stream_t = np.arange(0.7, 1.4, 0.0005)
    dirs = rng.normal(size=(len(stream_t), 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dw = np.einsum("kij,kj->ki", traj.rot(stream_t), dirs)
    rr = world.raycast(traj.pos(stream_t), dw)
    ok = np.isfinite(rr)
    hori = dirs * np.where(ok, rr, 0.0)[:, None]
    offsets = np.arange(-0.02, 0.16, 0.01)
    args = (stream_t[ok] + 0.07, hori[ok], velo, t0, t1)
    best, scores = tcal.estimate_time_offset(*args, CFG, offsets,
                                             device="cpu")
    best_j, scores_j = jcal.estimate_time_offset(*args, JCFG, offsets)
    assert best == best_j and abs(best - 0.07) <= 0.015
    np.testing.assert_allclose(scores, np.asarray(scores_j), atol=SCORE_ATOL)
