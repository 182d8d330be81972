"""The frozen generator against the port's, bit for bit, and the pool's
build against the serial one."""

import json
import os

import numpy as np

from harness import traffic

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spec():
    with open(os.path.join(BENCH, "traffic", "fleet-b16.json")) as f:
        spec = json.load(f)
    spec.update(lanes=3, scans=3)
    return spec


SIZES = (90, 40, 64, 9.805)     # n_az, hori_n_az, max_samples, gnorm


def test_frozen_generator_is_the_ports():
    from mmloam_tpu_torch import replay
    from mmloam_tpu_torch.config import LIOConfig
    from mmloam_tpu_torch.data import synthetic

    spec = _spec()
    seed = 2 ** 31 + 77
    for b in (0, 2):
        got, gR, gp = traffic.build_lane(spec, SIZES, seed, b)
        traj = synthetic.Trajectory(speed=0.6 + 0.05 * b, z_amp=0.1,
                                    yaw_rate=0.2 + 0.02 * b)
        want, wR, wp = replay.make_sequence(
            synthetic.default_world(), traj, 0.0, spec["scans"], LIOConfig(),
            n_az=SIZES[0], seed=[seed, b], range_noise=0.003,
            dtype=np.float32, with_hori=True, hori_n_az=SIZES[1])
        for f in traffic.SCAN_FIELDS:
            a, w = got[f], getattr(want, f)
            assert a.dtype == w.dtype and a.shape == w.shape, f
            assert np.array_equal(a, w), f
        assert np.array_equal(gR, wR) and np.array_equal(gp, wp)


def test_pool_build_is_the_serial_build():
    spec = _spec()
    pooled = traffic.build(spec, SIZES, 5, workers=2)
    serial = traffic.build(spec, SIZES, 5, workers=1)
    for f in traffic.SCAN_FIELDS:
        assert np.array_equal(pooled.scans[f], serial.scans[f]), f
        assert pooled.scans[f].shape[:2] == (spec["scans"], spec["lanes"])
    assert np.array_equal(pooled.gt_p, serial.gt_p)


def test_lane_trajectories_follow_the_fleet():
    spec = _spec()
    for b in (0, 9):
        tr = traffic.lane_trajectory(spec, b)
        assert np.isclose(tr.w * 7.0, 0.6 + 0.05 * (b % 8))
        assert np.isclose(tr.yaw_rate, 0.2 + 0.02 * (b % 8))
