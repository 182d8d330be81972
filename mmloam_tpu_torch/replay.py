"""Sequence replay drivers + trajectory metrics (port of
mmloam_tpu/replay.py).

`make_sequence` is a numpy copy of the reference's host-side builder (its
outputs are bit-identical); `replay` steps one sequence; `replay_batch`
steps B sequences in lockstep — `step_core` per lane, then ONE batched
map insert per map through the CUDA kernel K1 — exactly the split the TPU
path makes (`mmloam_tpu/replay.py:190-208`).  With `mesh`, a list of
devices, `replay_batch` splits the batch as the reference splits it over a
1-D mesh (`mmloam_tpu/replay.py:176-224`): each device owns whole
sequences, and no tensor crosses devices during the replay.
"""

from __future__ import annotations

import concurrent.futures
import contextlib

import numpy as np
import torch

from . import lie, pipeline
from .data import synthetic
from .tree import tree_map


def _hori_dirs(n_az):
    """Livox-Horizon-like raster: 81.7 x 25.1 deg FOV, 6 lines."""
    el = np.deg2rad(np.linspace(-12.55, 12.55, 6))
    az = np.deg2rad(np.linspace(-40.85, 40.85, n_az))
    ca, sa = np.cos(az), np.sin(az)
    ce, se = np.cos(el), np.sin(el)
    return np.stack([ce[:, None] * ca[None, :],
                     ce[:, None] * sa[None, :],
                     np.broadcast_to(se[:, None], (6, n_az))], axis=-1)


def make_sequence(world, traj, t0, n_scans, cfg, scan_hz=10.0, imu_rate=200.0,
                  range_noise=0.0, imu_noise=(0.0, 0.0), bg=(0, 0, 0),
                  ba=(0, 0, 0), g_vec=None, n_az=900, seed=0,
                  dtype=np.float32, with_hori=False, hori_n_az=None,
                  device=None):
    """Stacked ScanInput of `n_scans` scans + ground truth (gt_R, gt_p).

    Same construction as the reference's builder; leaves are numpy arrays
    when `device` is None, else tensors on `device`.  The numpy default is
    deliberate: it is the shared input both packages take, not a compute
    path, so it does not default to the card as `pipeline.init_state` does.
    """
    rng = np.random.default_rng(seed)
    period = 1.0 / scan_hz
    L = len(synthetic.VLP16_ELEVATIONS_DEG)
    M = cfg.imu.max_samples

    el = np.deg2rad(synthetic.VLP16_ELEVATIONS_DEG)
    az = -np.pi + 2 * np.pi * (np.arange(n_az) + 0.5) / n_az
    ca, sa = np.cos(az), np.sin(az)
    ce, se = np.cos(el), np.sin(el)
    dirs_l = np.stack([ce[:, None] * ca[None, :],
                       ce[:, None] * sa[None, :],
                       np.broadcast_to(se[:, None], (L, n_az))], axis=-1)
    if with_hori:
        h_az = hori_n_az or (cfg.scan.hori_max_pts_per_line)
        dirs_h = _hori_dirs(h_az)

    scans = []
    gt = []
    for i in range(n_scans):
        ts_start = t0 + i * period
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

        pts_c = np.zeros((L, n_az, 3))
        rel_c = np.zeros((L, n_az))
        n_val = valid.sum(axis=1).astype(np.int32)
        for l in range(L):
            sel = np.where(valid[l])[0]
            pts_c[l, :len(sel)] = pts[l, sel]
            rel_c[l, :len(sel)] = rel[sel] if rel.ndim == 1 else rel[l, sel]

        acc, gyr, its = synthetic.simulate_imu(
            traj, ts_start, ts_end, rate=imu_rate, gnorm=cfg.imu.gnorm,
            bg=bg, ba=np.asarray(ba), noise_gyr=imu_noise[0],
            noise_acc=imu_noise[1], rng=rng if sum(imu_noise) > 0 else None,
            g_vec=g_vec)
        dts = np.diff(np.concatenate([[ts_start], its]))
        m = len(its)
        imu_acc = np.zeros((M, 3)); imu_acc[:m] = acc[:M]
        imu_gyr = np.zeros((M, 3)); imu_gyr[:m] = gyr[:M]
        imu_dt = np.zeros(M); imu_dt[:m] = dts[:M]
        imu_mask = np.arange(M) < min(m, M)

        hori = {}
        if with_hori:
            th_az = ts_start + (np.arange(dirs_h.shape[1]) + 0.5) \
                / dirs_h.shape[1] * period
            Rh = traj.rot(th_az)
            ph = traj.pos(th_az)
            dw_h = np.einsum("aij,laj->lai", Rh, dirs_h)
            org_h = np.broadcast_to(ph[None], (6,) + ph.shape)
            rh = world.raycast(org_h.reshape(-1, 3), dw_h.reshape(-1, 3))
            rh = rh.reshape(dirs_h.shape[:2])
            hval = np.isfinite(rh)
            if range_noise > 0:
                rh = rh + np.where(hval, rng.normal(0, range_noise, rh.shape),
                                   0.0)
            hpts = dirs_h * np.where(hval, rh, 0.0)[..., None]
            hrel = np.broadcast_to(
                (np.arange(dirs_h.shape[1]) + 0.5) / dirs_h.shape[1],
                dirs_h.shape[:2])
            Lh, Nh = dirs_h.shape[:2]
            hp_c = np.zeros((Lh, Nh, 3))
            hr_c = np.zeros((Lh, Nh))
            hn = hval.sum(axis=1).astype(np.int32)
            for l in range(Lh):
                sel = np.where(hval[l])[0]
                hp_c[l, :len(sel)] = hpts[l, sel]
                hr_c[l, :len(sel)] = hrel[l, sel]
            hori = dict(hori_pts=hp_c.astype(dtype),
                        hori_intensity=np.zeros((Lh, Nh), dtype),
                        hori_n_valid=hn,
                        hori_rel_time=hr_c.astype(dtype))

        scans.append(pipeline.ScanInput(
            pts=pts_c.astype(dtype), intensity=np.zeros((L, n_az), dtype),
            n_valid=n_val, rel_time=rel_c.astype(dtype),
            t=np.asarray(ts_end, dtype),
            imu_acc=imu_acc.astype(dtype), imu_gyr=imu_gyr.astype(dtype),
            imu_dt=imu_dt.astype(dtype), imu_mask=imu_mask, **hori))
        gt.append((traj.rot(ts_end), traj.pos(ts_end)))

    stacked = tree_map(lambda *xs: np.stack(xs), scans[0], *scans[1:])
    if device is not None:
        stacked = tree_map(lambda a: torch.as_tensor(a, device=device),
                           stacked)
    gt_R = np.stack([g[0] for g in gt])
    gt_p = np.stack([g[1] for g in gt])
    return stacked, gt_R, gt_p


def _stack_outputs(outs):
    return tree_map(lambda *xs: torch.stack(xs), outs[0], *outs[1:])


def replay(state, scans, cfg):
    """Step one sequence over a stacked ScanInput (T, ...).  Returns
    (final state, StepOutput stacked over T)."""
    outs = []
    for t in range(scans.pts.shape[0]):
        state, out = pipeline.step(state,
                                   tree_map(lambda a: a[t], scans), cfg)
        outs.append(out)
    return state, _stack_outputs(outs)


def stack_states(states):
    """Stack per-sequence LIOStates into a batch (B, ...)."""
    return tree_map(lambda *xs: torch.stack(xs), states[0], *states[1:])


def _restack(lanes, batched):
    """Batch the per-lane states, keeping the batched map tensors (the
    per-lane step never writes maps; K1 updates them in place)."""
    keep = {f: getattr(batched, f) for f in pipeline.MAP_FIELDS}
    rest = [s._replace(**{f: None for f in pipeline.MAP_FIELDS})
            for s in lanes]
    return stack_states(rest)._replace(**keep)


def stack_sequences(seqs):
    """Stack per-sequence ScanInputs (T, ...) into (T, B, ...), numpy or
    tensor leaves (the reference's `stack_sequences`)."""
    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs, dim=1)
        return np.stack(xs, axis=1)
    return tree_map(stack, seqs[0], *seqs[1:])


def _shard(states, scans, i, n, dev):
    """Shard i of n: its lanes' state and scans, on `dev`.  A list of
    shard states (a split replay's result) gives its i-th, moved."""
    to = lambda a: torch.as_tensor(a, device=dev)
    if isinstance(states, list):
        st = tree_map(to, states[i])
        per = st.x.shape[0]
        lo = sum(s.x.shape[0] for s in states[:i])
    else:
        per = states.x.shape[0] // n
        lo = i * per
        st = tree_map(lambda a: to(a[lo:lo + per]), states)
    return st, tree_map(lambda a: to(a[:, lo:lo + per]), scans)


def replay_batch(states, scans, cfg, mesh=None):
    """Replay a BATCH of sequences in lockstep; with `mesh`, split over
    devices.

    Without `mesh`: see `_replay_lockstep`; returns (final states,
    StepOutput stacked as (T, B, ...)).

    `mesh` is a sequence of devices (torch.device or names), the
    counterpart of the reference's 1-D mesh over the batch axis: the B
    lanes split into len(mesh) contiguous shards (B must divide evenly, as
    in the reference), shard i's state and scans go to mesh[i], and each
    shard replays there in lockstep, maps and all; nothing crosses devices
    until the outputs come back.  One worker thread runs per distinct
    device (under `torch.cuda.device` for a CUDA one); shards that share a
    device run in turn in its worker.  `states` is a batched LIOState, or
    the list of shard states a split replay returned.  Returns (the list
    of final shard states, each on its device, in mesh order; StepOutput
    (T, B, ...) in lane order on mesh[0]).  As without a mesh, the maps
    of `states` may be updated in place: callers must not reuse them.
    """
    if mesh is None:
        return _replay_lockstep(states, scans, cfg)
    devs = [torch.device(d) for d in mesh]
    n = len(devs)
    listed = isinstance(states, list)
    B = (sum(s.x.shape[0] for s in states) if listed
         else states.x.shape[0])
    if n == 0 or B % n or (listed and len(states) != n):
        raise ValueError(f"a batch of {B} lanes does not split evenly "
                         f"over {n} devices")
    groups = {}
    for i, dev in enumerate(devs):
        groups.setdefault(dev, []).append(i)

    def work(dev, idx):
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        out = {}
        with ctx:
            for i in idx:
                out[i] = _replay_lockstep(*_shard(states, scans, i, n, dev),
                                          cfg)
        return out

    results = {}
    with concurrent.futures.ThreadPoolExecutor(len(groups)) as ex:
        futs = [ex.submit(work, dev, idx) for dev, idx in groups.items()]
        for fut in futs:
            results.update(fut.result())
    finals = [results[i][0] for i in range(n)]
    outs = tree_map(lambda *xs: torch.cat([x.to(devs[0]) for x in xs],
                                          dim=1),
                    *(results[i][1] for i in range(n)))
    return finals, outs


def gather_states(shards, device=None):
    """One batched LIOState from a split replay's shard states, lanes in
    order, on `device` (the first shard's when None)."""
    dev = shards[0].x.device if device is None else torch.device(device)
    return tree_map(lambda *xs: torch.cat([x.to(dev) for x in xs]),
                    shards[0], *shards[1:])


def _replay_lockstep(states, scans, cfg):
    """Replay a BATCH of sequences in lockstep on one device.

    states: LIOState with a leading batch axis B; scans: ScanInput laid out
    (T, B, ...).  For each scan, `step_core` runs per lane (a Python loop;
    per-lane values equal the reference's vmap), then the four maps of all
    B lanes are written by ONE batched `apply_inserts_batched` each —
    through the CUDA kernel on CUDA tensors.  The maps of `states` are
    updated IN PLACE (the reference donates the batch state the same way):
    callers must not reuse the passed `states`.  Returns (final states,
    StepOutput stacked as (T, B, ...)).
    """
    B = states.x.shape[0]
    outs = []
    for t in range(scans.pts.shape[0]):
        lanes, lane_outs, pends = [], [], []
        for b in range(B):
            lane = tree_map(lambda a: a[b], states)
            sc = tree_map(lambda a: a[t, b], scans)
            lane, out, pend = pipeline.step_core(lane, sc, cfg)
            lanes.append(lane)
            lane_outs.append(out)
            pends.append(pend)
        states = _restack(lanes, states)
        pend = tree_map(lambda *xs: torch.stack(xs), pends[0], *pends[1:])
        states = pipeline.apply_inserts_batched(states, pend, cfg)
        outs.append(_stack_outputs(lane_outs))
    return states, _stack_outputs(outs)


def ate_rmse(est_q, est_p, gt_R, gt_p):
    """ATE RMSE after first-pose alignment (odometry starts at identity)."""
    R0 = gt_R[0]
    p0 = gt_p[0]
    gt_rel = np.einsum("ij,nj->ni", R0.T, gt_p - p0)
    q0 = torch.as_tensor(np.asarray(est_q[0]), dtype=torch.float32)
    ep = torch.as_tensor(np.asarray(est_p), dtype=torch.float32)
    e_rel = lie.quat_rotate(lie.quat_conj(q0)[None], ep - ep[0:1]).numpy()
    err = e_rel - gt_rel
    return float(np.sqrt((err ** 2).sum(axis=1).mean())), err
