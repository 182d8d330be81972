"""The cell's inputs: the one generator that every traffic file feeds.

A frozen copy of the port's synthetic world and sequence builder
(`mmloam_tpu_torch/data/synthetic.py`: `BoxWorld`, `Trajectory`,
`simulate_imu`; `mmloam_tpu_torch/replay.py`: `make_sequence`,
`_hori_dirs`), bit-equal to them (`tests/test_harness_traffic.py`), so
that a change of the port cannot change what the benchmark feeds it.  A
traffic file (`traffic/<name>.json`) gives everything else as data: the
entry the window drives, the lanes and scans of a job, the world's
boxes, each lane's trajectory, the sensor rates and the range noise.

Lane b of a job follows the trajectory whose speed and yaw rate step by
`(b mod period)`, as bench.py's fleet does, and draws its range noise
from the stream `[seed, b]`, so no two seeds share a lane.  The lanes are built in a pool of spawned worker
processes, each lane by itself, so the pool gives the serial build's
arrays.  Numpy only: the workers import nothing else.
"""

from __future__ import annotations

import collections
import multiprocessing
import os

import numpy as np

VLP16_ELEVATIONS_DEG = np.arange(-15.0, 16.0, 2.0)  # 16 rings

# the fields of the port's ScanInput, in its order
SCAN_FIELDS = ("pts", "intensity", "n_valid", "rel_time", "t", "imu_acc",
               "imu_gyr", "imu_dt", "imu_mask", "hori_pts", "hori_intensity",
               "hori_n_valid", "hori_rel_time")

Lanes = collections.namedtuple("Lanes", "scans gt_R gt_p")
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


class BoxWorld:
    """Axis-aligned room interior with solid box pillars (ranges by the
    slab method; inf where a ray leaves max_range)."""

    def __init__(self, room_min, room_max, pillars=()):
        self.room_min = np.asarray(room_min, np.float64)
        self.room_max = np.asarray(room_max, np.float64)
        self.pillars = [(np.asarray(a, np.float64), np.asarray(b, np.float64))
                        for a, b in pillars]

    def raycast(self, origin, dirs, max_range=80.0):
        """origin (3,) or (N,3), dirs (N,3) unit.  Ranges (N,), inf = miss."""
        d = np.asarray(dirs, np.float64)
        o = np.broadcast_to(np.asarray(origin, np.float64), d.shape)
        eps = 1e-12
        inv = 1.0 / np.where(np.abs(d) < eps, eps, d)

        t_wall = np.full(d.shape[0], np.inf)
        for axis in range(3):
            for bound in (self.room_min[axis], self.room_max[axis]):
                t = (bound - o[:, axis]) * inv[:, axis]
                ok = t > 1e-6
                p = o + t[:, None] * d
                in_face = np.ones(d.shape[0], bool)
                for ax2 in range(3):
                    if ax2 == axis:
                        continue
                    in_face &= (p[:, ax2] >= self.room_min[ax2] - 1e-9) & \
                               (p[:, ax2] <= self.room_max[ax2] + 1e-9)
                t_wall = np.where(ok & in_face, np.minimum(t_wall, t), t_wall)

        t_hit = t_wall
        for pmin, pmax in self.pillars:
            t1 = (pmin[None, :] - o) * inv
            t2 = (pmax[None, :] - o) * inv
            tmin = np.minimum(t1, t2).max(axis=1)
            tmax = np.maximum(t1, t2).min(axis=1)
            hit = (tmax > tmin) & (tmax > 1e-6) & (tmin > 1e-6)
            t_hit = np.where(hit, np.minimum(t_hit, tmin), t_hit)

        return np.where(t_hit <= max_range, t_hit, np.inf)


class Trajectory:
    """Smooth figure-eight world-from-body trajectory with exact
    derivatives, yaw-only rotation."""

    def __init__(self, speed=1.0, yaw_rate=0.25, radius_x=7.0, radius_y=4.0,
                 z_amp=0.3):
        self.w = speed / max(radius_x, 1e-6)
        self.yaw_rate = yaw_rate
        self.rx, self.ry, self.za = radius_x, radius_y, z_amp

    def pos(self, t):
        t = np.asarray(t, np.float64)
        return np.stack([self.rx * np.sin(self.w * t),
                         self.ry * np.sin(2.0 * self.w * t) * 0.5,
                         self.za * np.sin(0.7 * self.w * t)], axis=-1)

    def acc(self, t):
        t = np.asarray(t, np.float64)
        return np.stack([-self.rx * self.w**2 * np.sin(self.w * t),
                         -2.0 * self.ry * self.w**2 * np.sin(2.0 * self.w * t),
                         -self.za * 0.49 * self.w**2 * np.sin(0.7 * self.w * t)],
                        axis=-1)

    def yaw(self, t):
        return self.yaw_rate * np.sin(self.w * np.asarray(t, np.float64) * 0.9)

    def yaw_dot(self, t):
        return self.yaw_rate * 0.9 * self.w * np.cos(
            self.w * np.asarray(t, np.float64) * 0.9)

    def rot(self, t):
        y = self.yaw(t)
        c, s = np.cos(y), np.sin(y)
        R = np.zeros(np.shape(y) + (3, 3))
        R[..., 0, 0], R[..., 0, 1] = c, -s
        R[..., 1, 0], R[..., 1, 1] = s, c
        R[..., 2, 2] = 1.0
        return R

    def gyro_body(self, t):
        w = np.zeros(np.shape(np.asarray(t)) + (3,))
        w[..., 2] = self.yaw_dot(t)
        return w


def simulate_imu(traj, t0, t1, rate=200.0, gnorm=9.805):
    """Noise-free IMU samples on (t0, t1]: (acc (M,3) in g units, gyr
    (M,3), ts (M,))."""
    ts = np.arange(np.ceil(t0 * rate + 1e-9),
                   np.floor(t1 * rate + 1e-9) + 1) / rate
    R = traj.rot(ts)
    a_w = traj.acc(ts)
    g_w = np.array([0.0, 0.0, -gnorm])
    f_body = np.einsum("mij,mj->mi", R.transpose(0, 2, 1), a_w - g_w)
    gyr = traj.gyro_body(ts) + np.zeros(3)
    acc = f_body / gnorm + np.zeros(3) / gnorm
    return acc, gyr, ts


def _ring_dirs(el_deg, az):
    el = np.deg2rad(el_deg)
    ca, sa = np.cos(az), np.sin(az)
    ce, se = np.cos(el), np.sin(el)
    return np.stack([ce[:, None] * ca[None, :], ce[:, None] * sa[None, :],
                     np.broadcast_to(se[:, None], (len(el), len(az)))],
                    axis=-1)


def _hori_dirs(n_az):
    """Livox-Horizon-like raster: 81.7 x 25.1 deg FOV, 6 lines."""
    el = np.deg2rad(np.linspace(-12.55, 12.55, 6))
    az = np.deg2rad(np.linspace(-40.85, 40.85, n_az))
    ca, sa = np.cos(az), np.sin(az)
    ce, se = np.cos(el), np.sin(el)
    return np.stack([ce[:, None] * ca[None, :],
                     ce[:, None] * sa[None, :],
                     np.broadcast_to(se[:, None], (6, n_az))], axis=-1)


def _compact(valid, pts, rel):
    """Each ring's valid points and times moved to its front, zeros after."""
    L, N = valid.shape
    pts_c, rel_c = np.zeros((L, N, 3)), np.zeros((L, N))
    for l in range(L):
        sel = np.where(valid[l])[0]
        pts_c[l, :len(sel)] = pts[l, sel]
        rel_c[l, :len(sel)] = rel[l, sel]
    return pts_c, rel_c, valid.sum(axis=1).astype(np.int32)


def make_sequence(world, traj, n_scans, n_az, hori_n_az, max_samples, gnorm,
                  scan_hz=10.0, imu_rate=200.0, range_noise=0.0, seed=0):
    """`n_scans` scans of the VLP-16 and the Horizon with their IMU
    intervals, as the port's `replay.make_sequence(world, traj, 0.0,
    n_scans, cfg, n_az=n_az, seed=seed, range_noise=range_noise,
    dtype=np.float32, with_hori=True, hori_n_az=hori_n_az)` builds them:
    a dict of the ScanInput fields stacked over scans, and the ground
    truth (gt_R (T,3,3), gt_p (T,3)) at each scan's end."""
    rng = np.random.default_rng(seed)
    period = 1.0 / scan_hz
    L = len(VLP16_ELEVATIONS_DEG)
    M = max_samples
    az = -np.pi + 2 * np.pi * (np.arange(n_az) + 0.5) / n_az
    dirs_l = _ring_dirs(VLP16_ELEVATIONS_DEG, az)
    dirs_h = _hori_dirs(hori_n_az)
    f32 = np.float32

    scans, gt = [], []
    for i in range(n_scans):
        ts_start = i * period
        ts_end = ts_start + period
        t_az = ts_start + (np.arange(n_az) + 0.5) / n_az * period
        R_az = traj.rot(t_az)
        p_az = traj.pos(t_az)
        dirs_w = np.einsum("aij,laj->lai", R_az, dirs_l)
        origins = np.broadcast_to(p_az[None, :, :], (L, n_az, 3))
        r = world.raycast(origins.reshape(-1, 3), dirs_w.reshape(-1, 3))
        r = r.reshape(L, n_az)
        valid = np.isfinite(r)
        if range_noise > 0:
            r = r + np.where(valid, rng.normal(0, range_noise, r.shape), 0.0)
        pts = dirs_l * np.where(valid, r, 0.0)[..., None]
        rel = np.broadcast_to((np.arange(n_az) + 0.5) / n_az, (L, n_az))
        pts_c, rel_c, n_val = _compact(valid, pts, rel)

        acc, gyr, its = simulate_imu(traj, ts_start, ts_end, rate=imu_rate,
                                     gnorm=gnorm)
        dts = np.diff(np.concatenate([[ts_start], its]))
        m = len(its)
        imu_acc = np.zeros((M, 3)); imu_acc[:m] = acc[:M]
        imu_gyr = np.zeros((M, 3)); imu_gyr[:m] = gyr[:M]
        imu_dt = np.zeros(M); imu_dt[:m] = dts[:M]
        imu_mask = np.arange(M) < min(m, M)

        Nh = dirs_h.shape[1]
        th_az = ts_start + (np.arange(Nh) + 0.5) / Nh * period
        dw_h = np.einsum("aij,laj->lai", traj.rot(th_az), dirs_h)
        ph = traj.pos(th_az)
        org_h = np.broadcast_to(ph[None], (6,) + ph.shape)
        rh = world.raycast(org_h.reshape(-1, 3), dw_h.reshape(-1, 3))
        rh = rh.reshape(dirs_h.shape[:2])
        hval = np.isfinite(rh)
        if range_noise > 0:
            rh = rh + np.where(hval, rng.normal(0, range_noise, rh.shape),
                               0.0)
        hpts = dirs_h * np.where(hval, rh, 0.0)[..., None]
        hrel = np.broadcast_to((np.arange(Nh) + 0.5) / Nh, dirs_h.shape[:2])
        hp_c, hr_c, hn = _compact(hval, hpts, hrel)

        scans.append(dict(
            pts=pts_c.astype(f32), intensity=np.zeros((L, n_az), f32),
            n_valid=n_val, rel_time=rel_c.astype(f32),
            t=np.asarray(ts_end, f32), imu_acc=imu_acc.astype(f32),
            imu_gyr=imu_gyr.astype(f32), imu_dt=imu_dt.astype(f32),
            imu_mask=imu_mask, hori_pts=hp_c.astype(f32),
            hori_intensity=np.zeros((6, Nh), f32), hori_n_valid=hn,
            hori_rel_time=hr_c.astype(f32)))
        gt.append((traj.rot(ts_end), traj.pos(ts_end)))
    stacked = {f: np.stack([s[f] for s in scans]) for f in SCAN_FIELDS}
    return (stacked, np.stack([g[0] for g in gt]),
            np.stack([g[1] for g in gt]))


def lane_trajectory(spec, b):
    """Lane b's trajectory: speed and yaw rate stepped by (b mod period)."""
    tr = spec["trajectories"]
    k = b % tr["period"]
    return Trajectory(speed=tr["speed"][0] + tr["speed"][1] * k,
                      yaw_rate=tr["yaw_rate"][0] + tr["yaw_rate"][1] * k,
                      radius_x=tr["radius_x"], radius_y=tr["radius_y"],
                      z_amp=tr["z_amp"])


def world_of(spec):
    w = spec["world"]
    return BoxWorld(w["room_min"], w["room_max"],
                    [tuple(p) for p in w["pillars"]])


def build_lane(spec, sizes, seed, b):
    """Lane b of a job of traffic `spec` (the traffic file's dict) for the
    scan sizes `sizes` (n_az, hori_n_az, max_samples, gnorm), its noise
    drawn from the stream [seed, b]."""
    n_az, hori_n_az, max_samples, gnorm = sizes
    return make_sequence(
        world_of(spec), lane_trajectory(spec, b), spec["scans"], n_az,
        hori_n_az, max_samples, gnorm, scan_hz=spec["scan_hz"],
        imu_rate=spec["imu_rate"], range_noise=spec["range_noise"],
        seed=[seed, b])


def build(spec, sizes, seed, workers=None):
    """Every lane of a job: the ScanInput fields stacked as (T, B, ...)
    and each lane's ground truth (B, T, ...).  The lanes are built in a
    pool of at most `workers` (default: the host's cores) spawned
    processes, one lane a task; one lane or one worker builds here."""
    B = spec["lanes"]
    n = min(B, workers or os.cpu_count() or 1)
    args = [(spec, sizes, seed, b) for b in range(B)]
    if n <= 1:
        lanes = [build_lane(*a) for a in args]
    else:
        # one thread a worker: the workers share the host's cores
        saved = {k: os.environ.get(k) for k in THREAD_VARS}
        os.environ.update(dict.fromkeys(THREAD_VARS, "1"))
        try:
            with multiprocessing.get_context("spawn").Pool(n) as pool:
                lanes = pool.starmap(build_lane, args, chunksize=1)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    scans = {f: np.stack([ln[0][f] for ln in lanes], axis=1)
             for f in SCAN_FIELDS}
    return Lanes(scans, np.stack([ln[1] for ln in lanes]),
                 np.stack([ln[2] for ln in lanes]))
