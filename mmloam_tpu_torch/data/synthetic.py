"""Analytic simulation: box worlds, spinning-lidar scans, IMU streams.

The reference's system test is rosbag replay of real sensor logs
(README.md:48-57) — none of which ship with the repo.  This module provides
the equivalent fixture generator: an analytic indoor world (box rooms with
pillars), a VLP-16-style ray-cast scan model, and an IMU model derived by
autodiff from a smooth analytic trajectory, giving *exact* ground truth for
trajectory-error (ATE) and unit-test assertions.

Everything here is host-side setup code (f64 numpy/jax on CPU); the engine
consumes the resulting padded tensors.
"""

from __future__ import annotations

import numpy as np

VLP16_ELEVATIONS_DEG = np.arange(-15.0, 16.0, 2.0)  # 16 rings


# --------------------------------------------------------------------------
# world geometry: axis-aligned box interior + rectangular pillars
# --------------------------------------------------------------------------

class BoxWorld:
    """Axis-aligned room interior with optional box pillars.

    Rays are cast from inside the room; each pillar is a solid axis-aligned
    box that can occlude the walls.  Pillar edges produce the depth
    discontinuities and fold corners the feature extractor keys on.
    """

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

        # exit distance from the room interior (nearest positive wall hit)
        t_wall = np.full(d.shape[0], np.inf)
        for axis in range(3):
            for bound in (self.room_min[axis], self.room_max[axis]):
                t = (bound - o[:, axis]) * inv[:, axis]
                ok = t > 1e-6
                # hit point must lie within the face rectangle
                p = o + t[:, None] * d
                in_face = np.ones(d.shape[0], bool)
                for ax2 in range(3):
                    if ax2 == axis:
                        continue
                    in_face &= (p[:, ax2] >= self.room_min[ax2] - 1e-9) & \
                               (p[:, ax2] <= self.room_max[ax2] + 1e-9)
                t_wall = np.where(ok & in_face, np.minimum(t_wall, t), t_wall)

        # pillar entry distances (slab method)
        t_hit = t_wall
        for pmin, pmax in self.pillars:
            t1 = (pmin[None, :] - o) * inv
            t2 = (pmax[None, :] - o) * inv
            tmin = np.minimum(t1, t2).max(axis=1)
            tmax = np.maximum(t1, t2).min(axis=1)
            hit = (tmax > tmin) & (tmax > 1e-6) & (tmin > 1e-6)
            t_hit = np.where(hit, np.minimum(t_hit, tmin), t_hit)

        return np.where(t_hit <= max_range, t_hit, np.inf)


class MultiRoomWorld:
    """Interior = UNION of axis-aligned room boxes (connected through their
    overlaps), plus solid clutter boxes.  Generalizes BoxWorld to
    corridor networks and multi-room offices — the geometry classes the
    reference is validated on (Corridor/Office datasets, README.md:67-75)
    that a single box cannot reproduce: doorway silhouettes, corridor
    degeneracy, occluding furniture.
    """

    def __init__(self, rooms, clutter=()):
        self.rooms = [(np.asarray(a, np.float64), np.asarray(b, np.float64))
                      for a, b in rooms]
        self.clutter = [(np.asarray(a, np.float64), np.asarray(b, np.float64))
                        for a, b in clutter]

    def raycast(self, origin, dirs, max_range=80.0):
        """origin (3,) or (N,3), dirs (N,3) unit.  Ranges (N,), inf = miss.

        Wall hit = exit distance from the UNION of room interiors: each
        room contributes an inside-interval [tin, tout]; the union's
        contiguous coverage starting at t=0 is grown iteratively (R
        passes suffice for R rooms — each pass absorbs at least one
        interval that extends the frontier).
        """
        d = np.asarray(dirs, np.float64)
        o = np.broadcast_to(np.asarray(origin, np.float64), d.shape)
        eps = 1e-12
        inv = 1.0 / np.where(np.abs(d) < eps, eps, d)

        tins, touts = [], []
        for rmin, rmax in self.rooms:
            t1 = (rmin[None, :] - o) * inv
            t2 = (rmax[None, :] - o) * inv
            tin = np.minimum(t1, t2).max(axis=1)
            tout = np.maximum(t1, t2).min(axis=1)
            ok = tout > np.maximum(tin, 0.0)
            tins.append(np.where(ok, tin, np.inf))
            touts.append(np.where(ok, tout, -np.inf))
        tins = np.stack(tins)                      # (R, N)
        touts = np.stack(touts)

        t_exit = np.zeros(d.shape[0])
        for _ in range(len(self.rooms)):
            covers = (tins <= t_exit[None, :] + 1e-6) & \
                     (touts > t_exit[None, :])
            ext = np.where(covers, touts, -np.inf).max(axis=0)
            t_exit = np.maximum(t_exit, ext)

        t_hit = t_exit
        for pmin, pmax in self.clutter:
            t1 = (pmin[None, :] - o) * inv
            t2 = (pmax[None, :] - o) * inv
            tmin = np.minimum(t1, t2).max(axis=1)
            tmax = np.maximum(t1, t2).min(axis=1)
            hit = (tmax > tmin) & (tmax > 1e-6) & (tmin > 1e-6)
            t_hit = np.where(hit, np.minimum(t_hit, tmin), t_hit)

        t_hit = np.where(t_hit > 1e-6, t_hit, np.inf)
        return np.where(t_hit <= max_range, t_hit, np.inf)


def corridor_world() -> MultiRoomWorld:
    """A 36 m corridor (2.2 m wide) with three side rooms and sparse
    clutter — the reference's Corridor dataset geometry class: long
    stretches where plane normals span only 2 directions (the
    localizability gate's target regime).
    """
    z0, z1 = -1.3, 1.7
    return MultiRoomWorld(
        rooms=[((-18.0, -1.1, z0), (18.0, 1.1, z1)),
               ((-14.0, 1.0, z0), (-8.0, 7.0, z1)),
               ((-2.0, -7.0, z0), (4.0, -1.0, z1)),
               ((10.0, 1.0, z0), (16.0, 6.0, z1))],
        clutter=[((-11.5, 3.2, z0), (-10.7, 4.0, 0.0)),
                 ((0.5, -4.6, z0), (1.3, -3.8, 0.2)),
                 ((12.5, 2.8, z0), (13.3, 3.6, -0.2)),
                 ((6.0, -0.9, z0), (6.5, -0.4, -0.5)),
                 ((-5.0, 0.4, z0), (-4.5, 0.9, -0.6))])


def office_world(seed=7, n_clutter=22) -> MultiRoomWorld:
    """Cluttered multi-room office: four rooms joined by two corridors,
    with `n_clutter` desk/shelf-sized boxes at seeded random positions —
    clutter density matching a working office (the reference's Office
    dataset class).  Clutter keeps a clear 1.2 m radius around the
    figure-eight trajectory region (|y| < 1, x in [-6, 6]).
    """
    rng = np.random.default_rng(seed)
    z0, z1 = -1.3, 1.7
    rooms = [((-12.0, -8.0, z0), (0.0, 0.5, z1)),
             ((0.0 - 0.5, -8.0, z0), (12.0, 0.5, z1)),
             ((-12.0, 0.0, z0), (-2.0, 8.0, z1)),
             ((-2.5, 0.0, z0), (12.0, 8.0, z1))]
    clutter = []
    tries = 0
    while len(clutter) < n_clutter and tries < 400:
        tries += 1
        cx = rng.uniform(-11.0, 11.0)
        cy = rng.uniform(-7.0, 7.0)
        if abs(cy) < 1.6 and -7.0 < cx < 7.0:
            continue                      # keep the trajectory corridor clear
        w = rng.uniform(0.3, 1.2)
        dep = rng.uniform(0.3, 1.2)
        h = rng.uniform(0.4, 1.6)
        clutter.append(((cx - w / 2, cy - dep / 2, z0),
                        (cx + w / 2, cy + dep / 2, z0 + h)))
    return MultiRoomWorld(rooms=rooms, clutter=clutter)


def street_world() -> BoxWorld:
    """Street-scale canyon: a 240 m drive between building facades with
    protruding storefronts — the reference's Street dataset class.  Long
    enough that a flagship 256-cell 0.4 m torus map (102.4 m period)
    wraps twice, exercising epoch-key eviction at scale.
    """
    pillars = []
    for i in range(-5, 6):
        x = 22.0 * i
        pillars.append(((x - 3.0, -14.0, -1.3), (x + 3.0, -9.5, 4.0)))
        pillars.append(((x - 2.0 + 7.0, 9.5, -1.3), (x + 2.0 + 7.0, 13.5, 4.0)))
    return BoxWorld(room_min=(-125.0, -15.0, -1.5),
                    room_max=(125.0, 15.0, 5.5), pillars=pillars)


def default_world() -> BoxWorld:
    """A 24x16x3 m hall with four pillars — Office/Hall-like geometry.

    The 3 m ceiling keeps floor/ceiling returns inside the +-15 deg ring
    fan at non-grazing range, like a real indoor scan.
    """
    return BoxWorld(
        room_min=(-12.0, -8.0, -1.3), room_max=(12.0, 8.0, 1.7),
        pillars=[((-6.5, -3.5, -1.3), (-5.5, -2.5, 1.7)),
                 ((5.5, -3.5, -1.3), (6.5, -2.5, 1.7)),
                 ((-6.5, 2.5, -1.3), (-5.5, 3.5, 1.7)),
                 ((5.5, 2.5, -1.3), (6.5, 3.5, 1.7))])


# --------------------------------------------------------------------------
# trajectory: smooth analytic pose with exact derivatives
# --------------------------------------------------------------------------

class Trajectory:
    """Smooth figure-eight-ish trajectory inside the default world.

    Pose is world-from-body; derivatives are computed analytically so the
    simulated IMU is exactly consistent with the pose.
    """

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

    def vel(self, t):
        t = np.asarray(t, np.float64)
        return np.stack([self.rx * self.w * np.cos(self.w * t),
                         self.ry * self.w * np.cos(2.0 * self.w * t),
                         self.za * 0.7 * self.w * np.cos(0.7 * self.w * t)],
                        axis=-1)

    def acc(self, t):
        t = np.asarray(t, np.float64)
        return np.stack([-self.rx * self.w**2 * np.sin(self.w * t),
                         -2.0 * self.ry * self.w**2 * np.sin(2.0 * self.w * t),
                         -self.za * 0.49 * self.w**2 * np.sin(0.7 * self.w * t)],
                        axis=-1)

    def yaw(self, t):
        return self.yaw_rate * np.sin(self.w * np.asarray(t, np.float64) * 0.9)

    def yaw_dot(self, t):
        return self.yaw_rate * 0.9 * self.w * np.cos(self.w * np.asarray(t, np.float64) * 0.9)

    def rot(self, t):
        """World-from-body rotation (yaw only — keeps gyro exact)."""
        y = self.yaw(t)
        c, s = np.cos(y), np.sin(y)
        R = np.zeros(np.shape(y) + (3, 3))
        R[..., 0, 0], R[..., 0, 1] = c, -s
        R[..., 1, 0], R[..., 1, 1] = s, c
        R[..., 2, 2] = 1.0
        return R

    def gyro_body(self, t):
        """Body angular velocity (exact: yaw-only rotation)."""
        w = np.zeros(np.shape(np.asarray(t)) + (3,))
        w[..., 2] = self.yaw_dot(t)
        return w


def simulate_imu(traj: Trajectory, t0, t1, rate=200.0, gnorm=9.805,
                 bg=(0, 0, 0), ba=(0, 0, 0), noise_gyr=0.0, noise_acc=0.0,
                 rng=None, g_vec=None):
    """IMU samples on (t0, t1]: returns (acc_g (M,3) in g units, gyr (M,3),
    ts (M,)).  acc follows the Livox convention the engine expects
    (specific force in g units, IMUIntegrator.cpp:119-121 scales by gnorm).
    `g_vec` overrides the gravity vector expressed in the trajectory frame
    (default straight down) — use it to simulate a rig whose odometry frame
    is tilted with respect to gravity.
    """
    ts = np.arange(np.ceil(t0 * rate + 1e-9), np.floor(t1 * rate + 1e-9) + 1) / rate
    R = traj.rot(ts)                                   # (M,3,3) world-from-body
    a_w = traj.acc(ts)                                 # world linear acceleration
    g_w = (np.asarray(g_vec, np.float64) if g_vec is not None
           else np.array([0.0, 0.0, -gnorm]))
    f_body = np.einsum("mij,mj->mi", R.transpose(0, 2, 1), a_w - g_w)
    gyr = traj.gyro_body(ts) + np.asarray(bg)
    acc = f_body / gnorm + np.asarray(ba) / gnorm
    if rng is not None and (noise_gyr > 0 or noise_acc > 0):
        gyr = gyr + rng.normal(0, noise_gyr, gyr.shape)
        acc = acc + rng.normal(0, noise_acc, acc.shape)
    return acc, gyr, ts


def simulate_scan(world: BoxWorld, R_wl, t_wl, n_az=900, max_range=80.0,
                  noise=0.0, rng=None,
                  elevations_deg=VLP16_ELEVATIONS_DEG,
                  az_start=-np.pi, az_span=2.0 * np.pi):
    """One spinning-lidar sweep from lidar pose (R_wl, t_wl).

    Returns pts (L, n_az, 3) lidar-frame, valid (L, n_az), rel_time
    (L, n_az) in [0,1) by azimuth (column-major time like a spinning lidar).
    """
    L = len(elevations_deg)
    az = az_start + az_span * (np.arange(n_az) + 0.5) / n_az
    el = np.deg2rad(elevations_deg)
    ca, sa = np.cos(az), np.sin(az)
    ce, se = np.cos(el), np.sin(el)
    dirs_l = np.stack([ce[:, None] * ca[None, :],
                       ce[:, None] * sa[None, :],
                       np.broadcast_to(se[:, None], (L, n_az))], axis=-1)
    dirs_w = dirs_l @ R_wl.T
    rng_all = world.raycast(t_wl, dirs_w.reshape(-1, 3), max_range)
    rng_all = rng_all.reshape(L, n_az)
    valid = np.isfinite(rng_all)
    r = np.where(valid, rng_all, 0.0)
    if rng is not None and noise > 0:
        r = r + np.where(valid, rng.normal(0, noise, r.shape), 0.0)
    pts = dirs_l * r[..., None]
    rel = np.broadcast_to((np.arange(n_az) + 0.5) / n_az, (L, n_az))
    return pts.astype(np.float32), valid, rel.astype(np.float32)
