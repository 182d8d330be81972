"""Port feature extraction and voxel downsample against the JAX reference.

Ray-cast rings from the shared scene builder feed both packages as f32.
Labels, masks and counts must match exactly, on noisy rings and on
noise-free ones, where many curvatures of one wall lie a few ulps apart and
only the reference's rounding order reproduces its picks; centroids and voxel-mean
relative times within atol 1e-6 (f32 segment sums in a different order).
"""

import numpy as np
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from mmloam_tpu import replay as jreplay  # noqa: E402
from mmloam_tpu.config import tiny_config  # noqa: E402
from mmloam_tpu.data import synthetic  # noqa: E402
from mmloam_tpu.ops import downsample as jds  # noqa: E402
from mmloam_tpu.ops import features as jfeat  # noqa: E402

from mmloam_tpu_torch.ops import downsample as tds  # noqa: E402
from mmloam_tpu_torch.ops import features as tfeat  # noqa: E402

CFG = tiny_config()


def _scans(with_hori, n_scans=3, seed=0, range_noise=0.003):
    traj = synthetic.Trajectory(speed=1.2, yaw_rate=0.3, z_amp=0.1)
    scans, _, _ = jreplay.make_sequence(
        synthetic.default_world(), traj, 0.0, n_scans, CFG, n_az=360,
        seed=seed, range_noise=range_noise, dtype=np.float32, with_hori=with_hori,
        hori_n_az=240, to_device=False)
    return scans


def _labels(pts, inten, nv):
    lj = np.asarray(jfeat.extract_scan_features(
        jnp.asarray(pts), jnp.asarray(inten), jnp.asarray(nv), CFG))
    lt = tfeat.extract_scan_features(torch.from_numpy(pts),
                                     torch.from_numpy(inten),
                                     torch.from_numpy(nv), CFG).numpy()
    return lj, lt


@pytest.mark.parametrize("range_noise", [0.003, 0.0])
@pytest.mark.parametrize("with_hori", [False, True])
def test_labels_match_jax(with_hori, range_noise):
    scans = _scans(with_hori, range_noise=range_noise)
    for i in range(scans.pts.shape[0]):
        lj, lt = _labels(scans.pts[i], scans.intensity[i], scans.n_valid[i])
        np.testing.assert_array_equal(lt, lj)
        assert (lj == 1).any() and (lj == 2).any()
        if with_hori:
            lj, lt = _labels(scans.hori_pts[i], scans.hori_intensity[i],
                             scans.hori_n_valid[i])
            np.testing.assert_array_equal(lt, lj)


def test_labels_with_reflectivity_and_short_rings():
    """Nonzero intensity exercises the reflectivity picks; rings of varied
    valid length exercise the segment clamping."""
    rng = np.random.default_rng(5)
    scans = _scans(False, n_scans=1, seed=5)
    pts = scans.pts[0].copy()
    nv = scans.n_valid[0].copy()
    nv[0] = 40
    nv[1] = 11
    inten = rng.uniform(0, 60, pts.shape[:2]).astype(np.float32)
    lj, lt = _labels(pts, inten, nv)
    np.testing.assert_array_equal(lt, lj)


def test_downsample_matches_jax():
    scans = _scans(True, n_scans=1)
    rng = np.random.default_rng(1)
    pts = np.concatenate([scans.pts[0].reshape(-1, 3),
                          scans.hori_pts[0].reshape(-1, 3)])
    rel = rng.uniform(0, 1, pts.shape[0]).astype(np.float32)
    lab = rng.integers(0, 3, pts.shape[0])
    valid = np.linalg.norm(pts, axis=1) > 0.5
    masks = [valid & (lab == 1), valid & (lab == 2)]
    leaves, caps = [0.4, 0.2], [256, 1024]
    oj = jds.voxel_downsample_multi(jnp.asarray(pts),
                                    [jnp.asarray(m) for m in masks],
                                    leaves, caps, extra=jnp.asarray(rel))
    ot = tds.voxel_downsample_multi(torch.from_numpy(pts),
                                    [torch.from_numpy(m) for m in masks],
                                    leaves, caps, extra=torch.from_numpy(rel))
    for (cj, mj, nj, ej), (ct, mt, nt, et) in zip(oj, ot):
        assert int(nj) == int(nt) and int(nj) > 10
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
        np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=1e-6)
    # single-class entry point, extreme coordinates near the key limits
    far = pts + np.float32(3000.0)
    cj, mj, nj = jds.voxel_downsample(jnp.asarray(far), jnp.asarray(valid),
                                      0.4, 2048)
    ct, mt, nt = tds.voxel_downsample(torch.from_numpy(far),
                                      torch.from_numpy(valid), 0.4, 2048)
    assert int(nj) == int(nt)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-3)
