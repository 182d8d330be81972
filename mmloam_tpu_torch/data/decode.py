"""Bag streams -> padded, ring-organized ScanInput tensors (port of
mmloam_tpu/data/decode.py).

The ingest is host numpy, as in the reference: ring organization with
per-point relative time, per-scan IMU windows over (t_prev, t_curr] with
an interpolated boundary sample, and the Horizon stream sliced to the
Velodyne intervals by the per-dataset velo->hori time offset.
`ring_organize`, `azimuth_rel_time`, `imu_window` and `livox_frames` are
copies of the reference's.  `sequence_from_bag` stacks the scans over time
into the port's `ScanInput` on `device` (the card unless the caller asks
for another, `pipeline.resolve_device`).
"""

from __future__ import annotations

import numpy as np

from .. import pipeline


def ring_organize(xyz, ring, rel_time, n_lines, max_pts, intensity=None):
    """Scatter a flat cloud into (L, N) prefix-packed ring arrays.

    Points are kept in stream order within each ring (the drivers emit in
    firing order, which is time order — the feature extractor's window
    operators rely on along-scan adjacency).
    """
    L, N = n_lines, max_pts
    pts = np.zeros((L, N, 3), np.float32)
    rel = np.zeros((L, N), np.float32)
    inten = np.zeros((L, N), np.float32)
    n_valid = np.zeros(L, np.int32)
    finite = np.isfinite(xyz).all(axis=1)
    for l in range(L):
        sel = np.where((ring == l) & finite)[0][:N]
        k = len(sel)
        pts[l, :k] = xyz[sel]
        rel[l, :k] = rel_time[sel]
        if intensity is not None:
            inten[l, :k] = intensity[sel]
        n_valid[l] = k
    return pts, inten, n_valid, rel


def azimuth_rel_time(xyz):
    """Relative scan time from azimuth for clouds without a time field
    (a spinning lidar's azimuth is its within-scan clock)."""
    az = np.arctan2(xyz[:, 1], xyz[:, 0])
    rel = (az[0] - az) / (2.0 * np.pi)
    rel = np.mod(rel, 1.0)
    return rel.astype(np.float32)


def imu_window(imu_t, imu_gyr, imu_acc, t0, t1, max_samples, acc_in_g=True,
               gnorm=9.805):
    """Samples on (t0, t1] with an interpolated boundary sample at t0
    (fetchImuMsgs, unionPoseEstimation.cpp:359-376)."""
    M = max_samples
    acc_scale = 1.0 if acc_in_g else 1.0 / gnorm
    sel = np.where((imu_t > t0) & (imu_t <= t1))[0]
    ts = imu_t[sel]
    gyr = imu_gyr[sel]
    acc = imu_acc[sel] * acc_scale
    # boundary interpolation at t0 from the straddling pair
    before = np.where(imu_t <= t0)[0]
    if len(before) and len(sel):
        i0, i1 = before[-1], sel[0]
        if imu_t[i1] > imu_t[i0]:
            w = (t0 - imu_t[i0]) / (imu_t[i1] - imu_t[i0])
            g0 = imu_gyr[i0] * (1 - w) + imu_gyr[i1] * w
            a0 = (imu_acc[i0] * (1 - w) + imu_acc[i1] * w) * acc_scale
            ts = np.concatenate([[t0], ts])
            gyr = np.concatenate([[g0], gyr])
            acc = np.concatenate([[a0], acc])
    dts = np.diff(np.concatenate([[t0], ts]))
    m = min(len(ts), M)
    out_acc = np.zeros((M, 3), np.float32)
    out_gyr = np.zeros((M, 3), np.float32)
    out_dt = np.zeros(M, np.float32)
    out_acc[:m] = acc[:m]
    out_gyr[:m] = gyr[:m]
    out_dt[:m] = dts[:m]
    mask = np.arange(M) < m
    return out_acc, out_gyr, out_dt, mask


def sequence_from_bag(bag, cfg, velo_topic="/velodyne_points",
                      imu_topic="/livox/imu", acc_in_g=True,
                      max_scans=None, skip_frames=1, n_lines=None,
                      max_pts=None, hori_topic=None, time_offset=0.0,
                      T_hori_to_velo=None, extrin_recali_every=0,
                      device=None):
    """Decode a bag's Velodyne + IMU (+ Horizon) streams into the port's
    ScanInput stacked over time, on `device` (the card when None).

    As the reference: `skip_frames` keeps every k-th scan (the aligner's
    `velo_skip_frames`); `n_lines`/`max_pts` override the scan geometry;
    with `hori_topic` the Livox stream is sliced to each Velodyne interval
    with `time_offset` (launch `timeoffset_Velo_to_Hori`), mapped by
    `T_hori_to_velo` and attached as the hori block (the hori fields stay
    None without it); `extrin_recali_every` > 0 re-refines the extrinsic
    by `calibration.icp_extrinsic` every that many scans (on `device`).
    """
    device = pipeline.resolve_device(device)
    sc = cfg.scan
    n_lines = n_lines or sc.n_lines
    max_pts = max_pts or sc.max_pts_per_line
    imu_t, imu_gyr, imu_acc = bag.read_imu(imu_topic)
    n_msgs = bag.message_count(velo_topic)
    idxs = list(range(0, n_msgs, skip_frames))
    if max_scans is not None:
        idxs = idxs[:max_scans]

    hori = None
    T_cur = (np.eye(4) if T_hori_to_velo is None
             else np.asarray(T_hori_to_velo, np.float64))
    if hori_topic is not None:
        frames = livox_frames(bag, hori_topic, time_offset)
        hori = dict(
            raw_xyz=np.concatenate([f["xyz"] for f in frames]),
            t=np.concatenate([f["abs_time"] for f in frames]),
            line=np.concatenate([f["line"] for f in frames]),
            refl=np.concatenate([f["reflect"] for f in frames]))

    scans = []
    t_prev = None
    for i in idxs:
        pc = bag.read_pointcloud2(velo_topic, i)
        t_curr = pc["stamp"]
        if t_prev is None:
            t_prev = t_curr - 0.1
        rel = pc["time_rel"]
        if not np.any(rel):
            rel = azimuth_rel_time(pc["xyz"])
        else:
            span = rel.max() - rel.min()
            rel = (rel - rel.min()) / max(span, 1e-6)
        ring = pc["ring"]
        if (ring < 0).all():
            # no ring field: derive from elevation like getVeloFeature
            # (unionFeatureExtract.cpp:1159-1166, scanID=(angle+15)/2)
            el = np.rad2deg(np.arctan2(
                pc["xyz"][:, 2], np.linalg.norm(pc["xyz"][:, :2], axis=1)))
            ring = np.clip(np.round((el + 15.0) / 2.0), 0,
                           n_lines - 1).astype(np.int32)
        pts, inten, n_valid, rel_t = ring_organize(
            pc["xyz"], ring, rel, n_lines, max_pts, pc["intensity"])
        acc, gyr, dt, mask = imu_window(imu_t, imu_gyr, imu_acc, t_prev,
                                        t_curr, cfg.imu.max_samples,
                                        acc_in_g, cfg.imu.gnorm)
        extra = {}
        if hori is not None:
            span = max(t_curr - t_prev, 1e-6)
            m = (hori["t"] > t_prev) & (hori["t"] <= t_curr)
            h_xyz = (hori["raw_xyz"][m] @ T_cur[:3, :3].T
                     + T_cur[:3, 3]).astype(np.float32)
            # online extrinsic re-refinement (icp_ext_matching cadence)
            if extrin_recali_every and len(scans) > 0 and m.sum() > 200 \
                    and len(scans) % extrin_recali_every == 0:
                from . import calibration
                dT, resid, nm = calibration.icp_extrinsic(
                    h_xyz, pc["xyz"], cfg, iters=10, device=device)
                if nm > 100:
                    T_cur = dT @ T_cur
                    h_xyz = (hori["raw_xyz"][m] @ T_cur[:3, :3].T
                             + T_cur[:3, 3]).astype(np.float32)
            h_rel = ((hori["t"][m] - t_prev) / span).astype(np.float32)
            h_pts, h_int, h_nv, h_rt = ring_organize(
                h_xyz, hori["line"][m], h_rel,
                sc.hori_n_lines, sc.hori_max_pts_per_line, hori["refl"][m])
            extra = dict(hori_pts=h_pts, hori_intensity=h_int,
                         hori_n_valid=h_nv, hori_rel_time=h_rt)
        scans.append(pipeline.ScanInput(
            pts=pts, intensity=inten, n_valid=n_valid, rel_time=rel_t,
            t=np.float32(t_curr), imu_acc=acc, imu_gyr=gyr, imu_dt=dt,
            imu_mask=mask, **extra))
        t_prev = t_curr
    if not scans:
        raise ValueError(f"no scans on topic {velo_topic}")
    stacked = pipeline.ScanInput(*(
        None if x is None else np.stack([getattr(s, f) for s in scans])
        for f, x in zip(scans[0]._fields, scans[0])))
    return pipeline.scan_from_numpy(stacked, device)


def livox_frames(bag, topic="/livox/lidar", time_offset=0.0):
    """Horizon stream as a list of per-message dicts with absolute point
    times (timebase + offset + the per-dataset velo->hori time offset)."""
    out = []
    for i in range(bag.message_count(topic)):
        lv = bag.read_livox(topic, i)
        lv["abs_time"] = lv["timebase"] + lv["offset_s"] - time_offset
        out.append(lv)
    return out
