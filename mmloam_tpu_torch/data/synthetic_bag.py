"""A synthetic sequence written as a recorded bag: the inverse of
`decode.sequence_from_bag`, so the whole recorded-log path (bag -> native
decoder -> tensors -> pipeline) can be driven without a real log.

The layout is the rig's: `sensor_msgs/Imu` at the sequence's IMU rate,
one Velodyne `sensor_msgs/PointCloud2` per scan (x, y, z, intensity, ring,
time fields) and, when the sequence has a Horizon block, one
`livox_ros_driver/CustomMsg` per scan.  The Horizon stream can carry a
clock offset (its stamps run `hori_offset` s ahead of the Velodyne's) and
sit in its own sensor frame (`T_hori_to_velo` maps it onto the Velodyne
frame), which is what calibration recovers.
"""

from __future__ import annotations

import numpy as np

from . import bagwriter


def _imu_times(t_prev, dts):
    """Absolute IMU sample times of one interval, snapped to the 200 Hz
    grid so f32 dt accumulation cannot push a sample across an edge."""
    return np.round((t_prev + np.cumsum(dts.astype(np.float64)))
                    * 200.0) / 200.0


def sequence_to_bag(scans, path, t0=100.0, period=0.1, hori_offset=0.0,
                    T_hori_to_velo=None, velo_topic="/velodyne_points",
                    imu_topic="/livox/imu", hori_topic="/livox/lidar"):
    """Write a stacked numpy ScanInput (T, ...) (`replay.make_sequence`)
    to a bag at `path`; bag stamps are `t0` + the sequence's times.  The
    IMU sample times are rebuilt from the windows' dts.
    Returns the number of messages written."""
    n = scans.t.shape[0]
    T_hv = np.eye(4) if T_hori_to_velo is None else np.asarray(
        T_hori_to_velo, np.float64)
    # scan stamps to the microsecond: the sequence's f32 times are ~1e-8 s
    # off the true ones, enough to move the IMU sample on an interval's
    # edge into the neighbouring window
    stamp = lambda i: t0 + round(float(scans.t[i]), 6)
    msgs = []
    seq_imu = 0
    t_prev = stamp(0) - period
    for i in range(n):
        t_curr = stamp(i)
        ts = _imu_times(t_prev, np.asarray(scans.imu_dt[i]))
        for j in np.where(np.asarray(scans.imu_mask[i]))[0]:
            msgs.append((imu_topic, "sensor_msgs/Imu", float(ts[j]),
                         bagwriter.serialize_imu(
                             seq_imu, float(ts[j]),
                             np.asarray(scans.imu_gyr[i, j]),
                             np.asarray(scans.imu_acc[i, j]))))
            seq_imu += 1
        # rings flattened into one cloud with ring and time fields
        L = scans.pts.shape[1]
        xyz, inten, ring, rel = [], [], [], []
        for l in range(L):
            k = int(scans.n_valid[i, l])
            xyz.append(np.asarray(scans.pts[i, l, :k]))
            inten.append(np.asarray(scans.intensity[i, l, :k]))
            ring.append(np.full(k, l, np.int64))
            rel.append(np.asarray(scans.rel_time[i, l, :k]))
        msgs.append((velo_topic, "sensor_msgs/PointCloud2", t_curr,
                     bagwriter.serialize_pointcloud2(
                         i, t_curr, np.concatenate(xyz),
                         np.concatenate(inten), np.concatenate(ring),
                         np.concatenate(rel))))
        if getattr(scans, "hori_pts", None) is not None:
            # points in the Horizon frame, stamped on its clock
            tb = t_curr - period + hori_offset
            pts = []
            for l in range(scans.hori_pts.shape[1]):
                k = int(scans.hori_n_valid[i, l])
                p = np.asarray(scans.hori_pts[i, l, :k], np.float64)
                p_h = ((p - T_hv[:3, 3]) @ T_hv[:3, :3]).astype(np.float32)
                r = np.asarray(scans.hori_rel_time[i, l, :k], np.float64)
                refl = np.clip(np.rint(np.asarray(
                    scans.hori_intensity[i, l, :k])), 0, 255).astype(int)
                pts += [(int(r[j] * period * 1e9), *p_h[j], int(refl[j]), 0,
                         l) for j in range(k)]
            pts.sort(key=lambda p: p[0])
            msgs.append((hori_topic, "livox_ros_driver/CustomMsg", tb,
                         bagwriter.serialize_livox(i, tb, int(tb * 1e9),
                                                   pts)))
        t_prev = t_curr
    msgs.sort(key=lambda m: m[2])
    bagwriter.write_bag(path, msgs)
    return len(msgs)
