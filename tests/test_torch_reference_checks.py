"""The reference's end-to-end checks, replayed through the port on the card
(marked `cuda`; skip without one).

This file imports torch only, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -q -s \
        tests/test_torch_reference_checks.py

Each check is one of the JAX package's slow replay tests, at its own
settings (worlds, trajectories, scan counts, noise, config) and its own
bounds, through the port's `replay.replay_batch` on the card; lanes of one
config and length share a batch.  The trajectories and worlds the
reference tests define for themselves are copied here.

* the scene x mode matrix (tests/test_world_matrix.py:31-60): hall,
  corridor and office, default and faithful; prints each ATE;
* corridor-flags-degenerate and box-room-not-degenerate
  (tests/test_degenerate.py:124-165);
* a drive past the torus period (tests/test_long_trajectory.py:71-111);
* the fast-rotation gates (tests/test_hori_fusion.py:44-60);
* the local map's bounded retention (tests/test_local_map.py:127-141);
* the three stress replays (tests/test_stress.py): forest feature churn,
  rotation-heavy motion, the IMU-noise sweep.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from mmloam_tpu_torch import pipeline, replay  # noqa: E402
from mmloam_tpu_torch.config import faithful_config, tiny_config  # noqa: E402
from mmloam_tpu_torch.data import synthetic  # noqa: E402
from mmloam_tpu_torch.ops import voxelmap  # noqa: E402

CFG = tiny_config()


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _run(cfg, seqs):
    """Replay the numpy sequences [(scans, gt_R, gt_p), ...] (one config,
    one length) as one batch on the card.  Returns (final states, outputs
    as numpy (T, B, ...))."""
    dev = _device()
    scans = pipeline.scan_from_numpy(
        replay.stack_sequences([s for s, _, _ in seqs]), dev)
    states = replay.stack_states([pipeline.init_state(cfg, device=dev)
                                  for _ in seqs])
    st, outs = replay.replay_batch(states, scans, cfg)
    torch.cuda.synchronize()
    return st, type(outs)(*(a.cpu().numpy() for a in outs))


def _ate(p, ts, gt_R, gt_p, period=0.1):
    """Stamp-matched ATE RMSE of one lane (the reference tests' `_ate`)."""
    gt_rel = np.einsum("ij,nj->ni", gt_R[0].T, gt_p - gt_p[0])
    err = np.stack([p[i] - gt_rel[int(round(float(ts[i]) / period)) - 1]
                    for i in range(len(p))])
    return float(np.sqrt((err ** 2).sum(1).mean()))


def _lane(outs, b):
    return type(outs)(*(a[:, b] for a in outs))


# --------------------------------------------------------------------------
# tests/test_world_matrix.py
# --------------------------------------------------------------------------

SCENES = {
    "hall": (lambda: synthetic.default_world(),
             dict(speed=0.8), dict(default=0.04, faithful=0.06)),
    "corridor": (lambda: synthetic.corridor_world(),
                 dict(speed=2.0, radius_x=16.0, radius_y=0.8,
                      yaw_rate=0.08, z_amp=0.05),
                 dict(default=0.15, faithful=0.25)),
    "office": (lambda: synthetic.office_world(),
               dict(speed=0.8, radius_x=5.5, radius_y=2.5, z_amp=0.1),
               dict(default=0.04, faithful=0.06)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "faithful"])
def test_scene_mode_matrix(mode):
    _device()
    cfg = faithful_config(CFG) if mode == "faithful" else CFG
    names = sorted(SCENES)
    seqs = [replay.make_sequence(
        SCENES[s][0](), synthetic.Trajectory(**SCENES[s][1]), 0.0, 25, cfg,
        n_az=360, range_noise=0.004, dtype=np.float32) for s in names]
    _, outs = _run(cfg, seqs)
    for b, scene in enumerate(names):
        o = _lane(outs, b)
        bound = SCENES[scene][2][mode]
        rmse = _ate(o.pose_p, o.t, seqs[b][1], seqs[b][2])
        print(f"{scene}/{mode}: ATE RMSE {rmse:.4f} m (bound {bound})")
        assert bool(o.inited[-1]), f"{scene}/{mode} failed to initialize"
        assert rmse < bound, f"{scene}/{mode} ATE {rmse:.3f} >= {bound}"
        assert np.isfinite(o.pose_p).all()


# --------------------------------------------------------------------------
# tests/test_degenerate.py
# --------------------------------------------------------------------------

class Straight(synthetic.Trajectory):
    """Constant-velocity straight-line motion along the corridor axis."""

    def __init__(self, v=1.0):
        super().__init__()
        self.v = v

    def pos(self, t):
        t = np.asarray(t, np.float64)
        return np.stack([self.v * t, np.zeros_like(t), np.zeros_like(t)],
                        axis=-1)

    def vel(self, t):
        t = np.asarray(t, np.float64)
        return np.stack([np.full_like(t, self.v), np.zeros_like(t),
                         np.zeros_like(t)], axis=-1)

    def acc(self, t):
        return np.zeros(np.shape(np.asarray(t)) + (3,))

    def yaw(self, t):
        return np.zeros(np.shape(np.asarray(t)))

    def yaw_dot(self, t):
        return np.zeros(np.shape(np.asarray(t)))


@pytest.mark.cuda
def test_corridor_flags_degenerate():
    _device()
    world = synthetic.BoxWorld(room_min=(-100.0, -2.0, -1.3),
                               room_max=(100.0, 2.0, 1.7))
    seq = replay.make_sequence(world, Straight(1.0), 0.0, 15, CFG, n_az=360)
    _, outs = _run(CFG, [seq])
    o = _lane(outs, 0)
    deg, sv = o.degenerate, o.sv_min
    ran = sv > 0
    assert ran.any()
    warm = ran & (np.arange(len(sv)) < 9)
    assert warm.any() and deg[warm].all(), f"flags {deg}, sv {sv}"
    p = o.pose_p
    assert np.isfinite(p).all()
    assert np.abs(p[:, 1]).max() < 2.0, p[:, 1]
    assert np.abs(p[:, 2]).max() < 8.0, p[:, 2]


@pytest.mark.cuda
def test_box_room_not_degenerate():
    _device()
    seq = replay.make_sequence(synthetic.default_world(), Straight(0.8), 0.0,
                               12, CFG, n_az=360)
    _, outs = _run(CFG, [seq])
    deg = _lane(outs, 0).degenerate
    assert deg[6:].mean() < 0.35, deg


# --------------------------------------------------------------------------
# tests/test_long_trajectory.py
# --------------------------------------------------------------------------

class Cruise(synthetic.Trajectory):
    """Straight line: hold v0 while the IMU initializes, ramp to v, cruise
    (see the reference test)."""

    def __init__(self, v, v0=0.5, hold=2.0, ramp=2.0):
        super().__init__()
        self.v = v
        self.v0 = v0
        self.hold = hold
        self.ramp = ramp

    def _s(self, t):
        t = np.asarray(t, np.float64)
        a = (self.v - self.v0) / self.ramp
        tr = np.clip(t - self.hold, 0.0, self.ramp)
        tc = np.maximum(t - self.hold - self.ramp, 0.0)
        return (self.v0 * np.minimum(t, self.hold)
                + self.v0 * tr + 0.5 * a * tr * tr + self.v * tc)

    def pos(self, t):
        s = self._s(t)
        return np.stack([s, np.zeros_like(s), np.zeros_like(s)], axis=-1)

    def vel(self, t):
        t = np.asarray(t, np.float64)
        a = (self.v - self.v0) / self.ramp
        vx = self.v0 + a * np.clip(t - self.hold, 0.0, self.ramp)
        return np.stack([vx, np.zeros_like(vx), np.zeros_like(vx)], axis=-1)

    def acc(self, t):
        t = np.asarray(t, np.float64)
        a = (self.v - self.v0) / self.ramp
        ax = np.where((t >= self.hold) & (t < self.hold + self.ramp), a, 0.0)
        return np.stack([ax, np.zeros_like(ax), np.zeros_like(ax)], axis=-1)

    def yaw(self, t):
        return np.zeros(np.shape(np.asarray(t)))

    def yaw_dot(self, t):
        return np.zeros(np.shape(np.asarray(t)))


@pytest.mark.cuda
def test_drive_past_torus_period():
    _device()
    period_x = CFG.map.dim_x * CFG.map.voxel_size      # 38.4 m
    n = 170
    pillars = []
    for k, x in enumerate(range(-5, 66, 5)):
        y0 = -4.5 if k % 2 == 0 else 2.5
        pillars.append(((x - 1.0, y0, -1.3), (x + 1.0, y0 + 2.0, 1.7)))
    world = synthetic.BoxWorld(room_min=(-20.0, -8.0, -1.3),
                               room_max=(70.0, 8.0, 1.7), pillars=pillars)
    seq = replay.make_sequence(world, Cruise(3.0), 0.0, n, CFG, n_az=360)
    st, outs = _run(CFG, [seq])
    o = _lane(outs, 0)
    p, ts = o.pose_p, o.t
    assert np.isfinite(p).all()
    assert float(p[-1, 0]) > period_x, "drove past one torus period"
    gt_R, gt_p = seq[1], seq[2]
    gt_rel = np.einsum("ij,nj->ni", gt_R[0].T, gt_p - gt_p[0])
    err = np.stack([p[i] - gt_rel[int(round(float(ts[i]) / 0.1)) - 1]
                    for i in range(n)])
    d = np.linalg.norm(err, axis=1)
    rmse = float(np.sqrt((d ** 2).mean()))
    print(f"torus drive: ATE RMSE {rmse:.4f} m (bound 0.8)")
    assert rmse < 0.8, f"long-run ATE {rmse}; tail {d[-10:]}"
    occ = float((voxelmap.VoxelMap(st.vm_surf.cells[0]).count > 0)
                .float().mean())
    assert occ < 1.0


# --------------------------------------------------------------------------
# tests/test_hori_fusion.py, tests/test_local_map.py
# --------------------------------------------------------------------------

class Spinner(synthetic.Trajectory):
    """Constant 2 rad/s spin."""

    def yaw(self, t):
        return 2.0 * np.asarray(t, np.float64)

    def yaw_dot(self, t):
        return np.full(np.shape(np.asarray(t)), 2.0)


@pytest.mark.cuda
def test_fast_rotation_gates():
    _device()
    cfg = CFG.replace(solver=dataclasses.replace(CFG.solver,
                                                 corner_cnt_gate_hori=5))
    seq = replay.make_sequence(synthetic.default_world(), Spinner(speed=0.3),
                               0.0, 8, cfg, n_az=360, with_hori=True,
                               hori_n_az=512)
    _, outs = _run(cfg, [seq])
    o = _lane(outs, 0)
    fr, merged = o.fast_rotation, o.hori_merged
    assert fr.any(), "fast rotation should be detected"
    assert not (merged & fr).any()


@pytest.mark.cuda
def test_local_map_retention_is_bounded():
    _device()
    n_cells_local = (CFG.local_map.dim_x * CFG.local_map.dim_y
                     * CFG.local_map.dim_z)
    seq = replay.make_sequence(synthetic.default_world(),
                               synthetic.Trajectory(speed=1.0), 0.0, 20, CFG,
                               n_az=360, dtype=np.float32, seed=5)
    st, _ = _run(CFG, [seq])
    occ = int((voxelmap.VoxelMap(st.vm_local_surf.cells[0]).count > 0)
              .sum())
    assert 0 < occ < n_cells_local // 2, occ


# --------------------------------------------------------------------------
# tests/test_stress.py
# --------------------------------------------------------------------------

def clutter_world(seed=3, n_pillars=40):
    """Forest-like: thin random pillars in a large room."""
    rng = np.random.default_rng(seed)
    pillars = []
    for _ in range(n_pillars):
        cx, cy = rng.uniform(-13, 13), rng.uniform(-9, 9)
        if abs(cx) < 8.5 and abs(cy) < 5.5:
            continue
        r = rng.uniform(0.1, 0.3)
        pillars.append(((cx - r, cy - r, -1.3), (cx + r, cy + r, 1.7)))
    return synthetic.BoxWorld(room_min=(-15.0, -11.0, -1.3),
                              room_max=(15.0, 11.0, 1.7), pillars=pillars)


class Spin(synthetic.Trajectory):
    """Constant fast yaw rate on top of the figure-eight translation."""

    def __init__(self, rate, **kw):
        super().__init__(**kw)
        self._rate = rate

    def yaw(self, t):
        return self._rate * np.asarray(t, np.float64)

    def yaw_dot(self, t):
        return np.full(np.shape(np.asarray(t)), self._rate)


def _stress(world, traj, **kw):
    return replay.make_sequence(world, traj, 0.0, 25, CFG, n_az=360,
                                dtype=np.float32, **kw)


@pytest.mark.cuda
def test_stress_replays():
    """Forest feature churn (ATE < 0.25), rotation-heavy motion (< 0.3)
    and the IMU-noise sweep (clean < 0.2, datasheet < 0.25, harsh < 0.6),
    each initialized: five lanes of one batch."""
    _device()
    world = synthetic.default_world()
    traj = synthetic.Trajectory(speed=0.8)
    cases = [
        ("forest", 0.25, _stress(clutter_world(),
                                 synthetic.Trajectory(speed=0.8),
                                 range_noise=0.003, seed=11)),
        ("rotation-heavy", 0.3, _stress(world, Spin(0.8, speed=0.6),
                                        seed=12)),
        ("imu clean", 0.2, _stress(world, traj, imu_noise=(0.0, 0.0),
                                   range_noise=0.005, seed=13)),
        ("imu datasheet", 0.25, _stress(world, traj,
                                        imu_noise=(0.004, 0.003),
                                        range_noise=0.005, seed=13)),
        ("imu harsh", 0.6, _stress(world, traj, imu_noise=(0.04, 0.03),
                                   range_noise=0.005, seed=13)),
    ]
    _, outs = _run(CFG, [c[2] for c in cases])
    for b, (name, bound, seq) in enumerate(cases):
        o = _lane(outs, b)
        rmse = _ate(o.pose_p, o.t, seq[1], seq[2])
        print(f"stress {name}: ATE RMSE {rmse:.4f} m (bound {bound})")
        assert bool(o.inited[-1]), f"{name}: init failed"
        assert rmse < bound, f"{name} ATE RMSE {rmse}"
