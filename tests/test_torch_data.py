"""The port's recorded-log modules against the JAX reference's.

* `data/bagwriter.py` and `metrics.py` are copies: the same messages give
  the same bag bytes; ATE/RPE and the run telemetry are equal.
* `data/rosbag.py`: the port builds its own decoder from
  native/src/rosbag_decode.cpp into mmloam_tpu_torch/_build/ and, on a bag
  the JAX package wrote, returns arrays equal to the JAX `BagReader`'s.
* `data/decode.py`: `ring_organize`, `imu_window`, `azimuth_rel_time`
  exactly; `sequence_from_bag` with a Horizon topic (clock offset and
  extrinsic applied) equal to the reference's on a 4-scan bag written by
  `data/synthetic_bag.py`, every field exactly, on the CPU.
* `checkpoint.py`: a JAX-written checkpoint restores in the port equal to
  `state_from_numpy` of the same state, a port-written one restores in
  JAX equal leaf by leaf (every leaf random, so no leaf can pass by being
  zero), and a checkpoint of another config is rejected.
* `data/export.py`: `save_map_pcd` writes the reference's points for the
  same map; TUM trajectories round-trip.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from mmloam_tpu import checkpoint as jck  # noqa: E402
from mmloam_tpu import metrics as jmet  # noqa: E402
from mmloam_tpu import pipeline as jp  # noqa: E402
from mmloam_tpu import replay as jr  # noqa: E402
from mmloam_tpu.config import tiny_config as jax_tiny_config  # noqa: E402
from mmloam_tpu.data import bagwriter as jbw  # noqa: E402
from mmloam_tpu.data import decode as jdec  # noqa: E402
from mmloam_tpu.data import export as jexp  # noqa: E402
from mmloam_tpu.data import synthetic as jsyn  # noqa: E402
from mmloam_tpu.data.rosbag import BagReader as JBagReader  # noqa: E402
from mmloam_tpu.ops import voxelmap as jvm  # noqa: E402

from mmloam_tpu_torch import checkpoint as tck  # noqa: E402
from mmloam_tpu_torch import cuda_build  # noqa: E402
from mmloam_tpu_torch import metrics as tmet  # noqa: E402
from mmloam_tpu_torch import pipeline as tp  # noqa: E402
from mmloam_tpu_torch.config import tiny_config  # noqa: E402
from mmloam_tpu_torch.data import bagwriter as tbw  # noqa: E402
from mmloam_tpu_torch.data import decode as tdec  # noqa: E402
from mmloam_tpu_torch.data import export as texp  # noqa: E402
from mmloam_tpu_torch.data import rosbag as tros  # noqa: E402
from mmloam_tpu_torch.data import synthetic_bag  # noqa: E402
from mmloam_tpu_torch.ops import voxelmap as tvm  # noqa: E402
from mmloam_tpu_torch.tree import tree_map  # noqa: E402

CFG = tiny_config()
JCFG = jax_tiny_config()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _messages(writer, rng):
    """One message of every kind the writer serializes."""
    n = 40
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    inten = rng.uniform(0, 100, n).astype(np.float32)
    ring = rng.integers(0, 16, n)
    rel = np.linspace(0, 0.1, n).astype(np.float32)
    lp = [(int(i * 1e4), float(i) * 0.1, -float(i) * 0.05, 1.0, 37, 0, i % 6)
          for i in range(30)]
    return [
        ("/imu", "sensor_msgs/Imu", 100.0025,
         writer.serialize_imu(3, 100.0025, rng.normal(size=3),
                              rng.normal(size=3))),
        ("/velo", "sensor_msgs/PointCloud2", 100.1,
         writer.serialize_pointcloud2(0, 100.1, xyz, inten, ring, rel)),
        ("/ouster", "sensor_msgs/PointCloud2", 1.7e9,
         writer.serialize_pointcloud2_ouster(0, 1.7e9, xyz, inten, ring,
                                              (rel * 1e9).astype(np.uint64))),
        ("/hesai", "sensor_msgs/PointCloud2", 1.7e9,
         writer.serialize_pointcloud2_hesai(0, 1.7e9, xyz, inten, ring,
                                            1.7e9 + rel)),
        ("/livox", "livox_ros_driver/CustomMsg", 100.05,
         writer.serialize_livox(0, 100.05, int(100.05e9), lp))]


def test_bagwriter_copy_writes_the_same_bytes(tmp_path):
    paths = []
    for name, writer in (("j", jbw), ("t", tbw)):
        msgs = _messages(writer, np.random.default_rng(0))
        paths.append(tmp_path / f"{name}.bag")
        writer.write_bag(paths[-1], msgs)
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_native_reader_is_the_ports_own_build(tmp_path):
    """The port's reader builds native/src/rosbag_decode.cpp into its own
    _build/ (never the JAX package's library) and decodes a bag the JAX
    package wrote exactly as the JAX reader does."""
    lib = cuda_build.build_host(tros.SOURCE)
    assert os.path.dirname(lib) == cuda_build.BUILD_DIR
    assert os.path.basename(tros.SOURCE) == "rosbag_decode.cpp"
    path = tmp_path / "j.bag"
    jbw.write_bag(path, _messages(jbw, np.random.default_rng(1)))
    a, b = tros.BagReader(path), JBagReader(path)
    assert a.topics() == b.topics()
    for x, y in zip(a.read_imu("/imu"), b.read_imu("/imu")):
        np.testing.assert_array_equal(x, y)
    for topic in ("/velo", "/ouster", "/hesai"):
        pa, pb = a.read_pointcloud2(topic, 0), b.read_pointcloud2(topic, 0)
        assert pa.keys() == pb.keys()
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k], err_msg=topic + k)
        assert a.message_stamp(topic, 0) == b.message_stamp(topic, 0)
    la, lb = a.read_livox("/livox", 0), b.read_livox("/livox", 0)
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    a.close()
    b.close()
    # the port's modules never load the JAX package's library
    code = ("import sys; from mmloam_tpu_torch.data import rosbag; "
            f"rosbag.BagReader({str(path)!r}).topics(); "
            "maps = open('/proc/self/maps').read(); "
            "assert 'libmmloam_native' not in maps; "
            "assert 'librosbag_decode' in maps; "
            "assert 'jax' not in sys.modules")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_decode_helpers_are_exact():
    rng = np.random.default_rng(2)
    xyz = rng.normal(size=(500, 3)).astype(np.float32)
    xyz[7] = np.nan
    ring = rng.integers(0, 5, 500)
    rel = rng.random(500).astype(np.float32)
    inten = rng.uniform(0, 9, 500).astype(np.float32)
    for got, want in zip(
            tdec.ring_organize(xyz, ring, rel, 4, 90, inten),
            jdec.ring_organize(xyz, ring, rel, 4, 90, inten)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tdec.azimuth_rel_time(xyz[8:]),
                                  jdec.azimuth_rel_time(xyz[8:]))
    imu_t = 10.0 + np.sort(rng.uniform(0, 0.5, 120))
    gyr, acc = rng.normal(size=(120, 3)), rng.normal(size=(120, 3))
    for t0, t1, m, g in ((10.1, 10.2, 32, True), (10.05, 10.45, 16, False),
                         (9.0, 9.1, 8, True)):
        for got, want in zip(
                tdec.imu_window(imu_t, gyr, acc, t0, t1, m, g),
                jdec.imu_window(imu_t, gyr, acc, t0, t1, m, g)):
            np.testing.assert_array_equal(got, want)


def test_sequence_from_bag_with_hori_matches_jax(tmp_path):
    scans, _, _ = jr.make_sequence(
        jsyn.default_world(), jsyn.Trajectory(speed=0.8, z_amp=0.15), 0.0,
        4, JCFG, n_az=360, dtype=np.float32, with_hori=True, hori_n_az=240,
        range_noise=0.003, to_device=False)
    T = np.eye(4)
    c, s = np.cos(0.02), np.sin(0.02)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = [0.1, -0.05, 0.02]
    path = tmp_path / "dual.bag"
    synthetic_bag.sequence_to_bag(scans, path, hori_offset=0.07,
                                  T_hori_to_velo=T)
    kw = dict(n_lines=16, max_pts=360, hori_topic="/livox/lidar",
              time_offset=0.07, T_hori_to_velo=T)
    got = tdec.sequence_from_bag(tros.BagReader(path), CFG, device="cpu",
                                 **kw)
    want = jdec.sequence_from_bag(JBagReader(path), JCFG, **kw)
    assert type(got).__name__ == "ScanInput"
    assert got.pts.device.type == "cpu" and got.hori_pts.shape[0] == 4
    for name in want._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the decoded Horizon points are the sequence's, back in the Velodyne
    # frame, within the f32 round trip through the Horizon frame
    n_az = scans.hori_pts.shape[2]
    np.testing.assert_allclose(got.hori_pts.numpy()[:, :, :n_az],
                               scans.hori_pts, atol=1e-5)
    np.testing.assert_array_equal(got.hori_n_valid.numpy(),
                                  scans.hori_n_valid)
    # without a Horizon topic every hori field stays None
    plain = tdec.sequence_from_bag(tros.BagReader(path), CFG, device="cpu",
                                   n_lines=16, max_pts=360)
    assert plain.hori_pts is None and plain.hori_rel_time is None


def test_sequence_from_bag_recalibration_matches_jax(tmp_path, monkeypatch):
    """`extrin_recali_every`: the decoder re-refines the extrinsic every
    second scan and composes the result onto the current one.  Both
    packages' `icp_extrinsic` are replaced by the same fixed refinement, so
    the cadence, the arguments and the composition are held exactly (the
    ICP itself is held step by step in test_torch_calibration.py)."""
    from mmloam_tpu.data import calibration as jcal
    from mmloam_tpu_torch.data import calibration as tcal

    scans, _, _ = jr.make_sequence(
        jsyn.default_world(), jsyn.Trajectory(speed=0.8, z_amp=0.15), 0.0,
        5, JCFG, n_az=360, dtype=np.float32, with_hori=True, hori_n_az=240,
        to_device=False)
    path = tmp_path / "recali.bag"
    synthetic_bag.sequence_to_bag(scans, path)
    dT = np.eye(4)
    dT[:3, 3] = [0.01, -0.02, 0.005]
    calls = {"j": [], "t": []}

    def fake(tag):
        def icp(src, dst, cfg, iters=30, **kw):
            calls[tag].append((np.asarray(src).copy(), np.asarray(dst).copy(),
                               iters))
            return dT, 0.0, 500
        return icp
    monkeypatch.setattr(jcal, "icp_extrinsic", fake("j"))
    monkeypatch.setattr(tcal, "icp_extrinsic", fake("t"))
    kw = dict(n_lines=16, max_pts=360, hori_topic="/livox/lidar",
              extrin_recali_every=2)
    got = tdec.sequence_from_bag(tros.BagReader(path), CFG, device="cpu",
                                 **kw)
    want = jdec.sequence_from_bag(JBagReader(path), JCFG, **kw)
    assert len(calls["t"]) == len(calls["j"]) == 2      # scans 2 and 4
    for (sa, da, ia), (sb, db, ib) in zip(calls["t"], calls["j"]):
        np.testing.assert_array_equal(sa, sb)
        np.testing.assert_array_equal(da, db)
        assert ia == ib == 10
    for name in want._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the refinements moved the Horizon points of scans 2-4 by dT, twice
    # from scan 4 on
    n_az = scans.hori_pts.shape[2]
    shift = got.hori_pts.numpy()[:, :, :n_az] - scans.hori_pts
    valid = np.arange(n_az)[None, :] < scans.hori_n_valid[..., None]
    np.testing.assert_allclose(shift[:2][valid[:2]], 0.0, atol=1e-6)
    np.testing.assert_allclose(shift[2:4][valid[2:4]],
                               np.broadcast_to(dT[:3, 3], shift[2:4][
                                   valid[2:4]].shape), atol=1e-5)
    np.testing.assert_allclose(shift[4][valid[4]],
                               np.broadcast_to(2 * dT[:3, 3], shift[4][
                                   valid[4]].shape), atol=1e-5)


def test_metrics_copy_is_equal():
    rng = np.random.default_rng(3)
    gt_t = 0.1 * np.arange(1, 31)
    yaw = rng.normal(0, 0.1, 30)
    gt_R = np.stack([np.array([[np.cos(a), -np.sin(a), 0],
                               [np.sin(a), np.cos(a), 0], [0, 0, 1]])
                     for a in yaw])
    gt_p = np.cumsum(rng.normal(size=(30, 3)), axis=0)
    est_t = gt_t[rng.integers(0, 30, 25)]
    est_p = rng.normal(size=(25, 3))
    assert tmet.ate(est_p, est_t, gt_p, gt_R, gt_t) == jmet.ate(
        est_p, est_t, gt_p, gt_R, gt_t)
    outs = jp.StepOutput(*(rng.random(20) for _ in jp.StepOutput._fields))
    outs = outs._replace(inited=rng.random(20) > 0.3,
                         fail=rng.random(20) > 0.8,
                         degenerate=rng.random(20) > 0.7)
    assert tmet.run_telemetry(outs) == jmet.run_telemetry(outs)


def _random_state(jcfg, seed):
    """The reference's init_state with every leaf replaced by random
    values of its shape and dtype."""
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == bool:
            return jnp.asarray(rng.random(a.shape) > 0.5)
        if a.dtype.kind in "iu":
            return jnp.asarray(rng.integers(0, 100, a.shape).astype(a.dtype))
        return jnp.asarray(rng.normal(size=a.shape).astype(a.dtype))
    return jax.tree.map(fill, jp.init_state(jcfg))


@pytest.mark.parametrize("nonfeature", [False, True])
def test_checkpoints_cross_between_packages(tmp_path, nonfeature):
    cfg = CFG.replace(use_nonfeature=nonfeature)
    jcfg = JCFG.replace(use_nonfeature=nonfeature)
    sj = _random_state(jcfg, seed=4)
    jck.save(tmp_path / "j.npz", sj)
    got = tck.restore(tmp_path / "j.npz", tp.init_state(cfg, device="cpu"))
    want = tp.state_from_numpy(jax.tree.map(np.asarray, sj), device="cpu")
    assert type(got) is type(want)
    lg = jax.tree.leaves(tree_map(lambda a: a.numpy(), got))
    lw = jax.tree.leaves(tree_map(lambda a: a.numpy(), want))
    assert len(lg) == len(lw) == len(jax.tree.leaves(sj))
    for a, b in zip(lg, lw):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the port's keys are the reference's
    with np.load(tmp_path / "j.npz") as dj:
        tck.save(tmp_path / "t.npz", got)
        with np.load(tmp_path / "t.npz") as dt:
            assert sorted(dj.files) == sorted(dt.files)
    back = jck.restore(tmp_path / "t.npz", jp.init_state(jcfg))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(sj)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_restore_rejects_wrong_config(tmp_path):
    path = tmp_path / "c.npz"
    tck.save(path, tp.init_state(CFG, device="cpu"))
    other = CFG.replace(solver=dataclasses.replace(CFG.solver, window=4))
    with pytest.raises(ValueError, match="config mismatch"):
        tck.restore(path, tp.init_state(other, device="cpu"))
    with pytest.raises(KeyError, match="non"):
        tck.restore(path, tp.init_state(CFG.replace(use_nonfeature=True),
                                        device="cpu"))


def test_export_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    mcfg = dataclasses.replace(CFG.map, dim_x=32, dim_y=32, dim_z=8)
    pts = rng.uniform(-4, 4, (3000, 3)).astype(np.float32)
    mask = rng.random(3000) > 0.2
    vm = tvm.insert(tvm.empty_map(mcfg), torch.from_numpy(pts),
                    torch.from_numpy(mask), mcfg)
    n_t = texp.save_map_pcd(tmp_path / "t.pcd", vm, mcfg)
    n_j = jexp.save_map_pcd(tmp_path / "j.pcd", jvm.VoxelMap(
        jnp.asarray(vm.cells.numpy())), mcfg)
    assert n_t == n_j == int((vm.count > 0).sum()) > 100
    assert (tmp_path / "t.pcd").read_text() == (tmp_path / "j.pcd").read_text()
    ts = 0.1 * np.arange(1, 11)
    pos = rng.normal(size=(10, 3))
    q = rng.normal(size=(10, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    texp.save_trajectory_tum(tmp_path / "t.txt", ts, pos, q)
    jexp.save_trajectory_tum(tmp_path / "j.txt", ts, pos, q)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    for got, want in zip(texp.load_trajectory_tum(tmp_path / "t.txt"),
                         (ts, pos, q)):
        np.testing.assert_allclose(got, want, atol=1e-6)
