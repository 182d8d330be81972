"""Spread of the startup extrinsic on chip_smoke.py's rig over noise seeds,
repeated runs and rig variants.

    python3 calib_sweep.py [--seeds 11 12 13 14 15] [--repeats 2]
        [--device cuda] [--reference] [--out calib_sweep.json]

For each seed the rig's static start (chip_smoke.py phase 7: LIOConfig()
widths, 16x1024 VLP-16 and 6x2048 Horizon, 3 mm range noise from the seed,
the Horizon in a frame turned by chip_smoke.rig_extrinsic) is written to a
bag and read back as phase 7 reads it.  Each variant (Horizon frames
integrated, whether they were scanned as a Livox scans them or by the
sequence's repeating raster, static Velodyne scans concatenated, ICP leaf,
the solve's start) then runs
`calibration.align_startup` `--repeats` times, and the translation and
rotation errors against the true extrinsic are printed, one JSON line per
run, with the bounds phase 7 holds them to.

`--reference` runs the JAX package's `align_startup` on the same clouds
instead, on the CPU (the only part of this script that imports it), to
tell the reference's own behaviour on this rig from the port's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

# (name, Horizon frames integrated, of them rescanned as a Livox scans
# them (`livox_startup`; 0: the sequence's repeating raster),
# Velodyne scans, leaf in m, the solve's start: None (identity),
# "nominal" (`rig_nominal`) or "true" (the true extrinsic))
VARIANTS = tuple(
    (f"{f} frames ({'Livox' if n else 'raster'}), {s} scan, {v:.2f} m, "
     f"from {i or 'identity'}", f, n, s, v, i)
    for f, n, s, v, i in (
        # phase 7's rig (the first), its leaf, and more frames and scans
        (3, 0, 1, 0.10, None), (3, 0, 1, 0.08, None), (1, 0, 1, 0.08, None),
        (6, 0, 1, 0.08, None), (3, 0, 3, 0.08, None), (3, 0, 3, 0.10, None),
        (6, 0, 6, 0.08, None), (6, 0, 6, 0.10, None),
        # other starts, and frames scanned as a Livox scans them
        (3, 0, 1, 0.10, "nominal"), (3, 0, 1, 0.08, "nominal"),
        (3, 0, 1, 0.10, "true"), (3, 0, 1, 0.08, "true"),
        (3, 3, 1, 0.10, "nominal"), (3, 3, 1, 0.08, "nominal"),
        (6, 6, 1, 0.08, "nominal")))
REST = 0.65   # s at rest: every variant's frames are static


def livox_startup(scans, R, p, n_frames, seed):
    """Rescan the first `n_frames` Horizon frames of the numpy sequence
    `scans` (in place; the rig rests at world-from-body pose R, p over
    them) as a Livox Horizon scans: its pattern does not repeat, so frame
    i's six lines lie at elevations of their own, between the other
    frames' lines, and the frames together cover the 25.1 deg field at
    1/n_frames of the line spacing, the coverage the startup aligner
    integrates frames for.  `replay.make_sequence`'s raster repeats its six
    lines every frame."""
    from mmloam_tpu_torch.data import synthetic

    world = synthetic.default_world()
    rng = np.random.default_rng([seed, 1])
    L, N = scans.hori_pts.shape[1:3]
    az = np.deg2rad(np.linspace(-40.85, 40.85, N))
    rel = ((np.arange(N) + 0.5) / N).astype(np.float32)
    for i in range(n_frames):
        el = np.deg2rad(-12.55 + 25.1 * (np.arange(L) * n_frames + i + 0.5)
                        / (L * n_frames))
        dirs = np.stack([np.cos(el)[:, None] * np.cos(az)[None],
                         np.cos(el)[:, None] * np.sin(az)[None],
                         np.broadcast_to(np.sin(el)[:, None], (L, N))], -1)
        r = world.raycast(np.broadcast_to(p, (L * N, 3)),
                          dirs.reshape(-1, 3) @ R.T).reshape(L, N)
        ok = np.isfinite(r)
        r = r + np.where(ok, rng.normal(0, cs.REC_NOISE, r.shape), 0.0)
        pts = (dirs * np.where(ok, r, 0.0)[..., None]).astype(np.float32)
        scans.hori_pts[i] = 0.0
        scans.hori_rel_time[i] = 0.0
        for l in range(L):
            sel = np.where(ok[l])[0]
            scans.hori_pts[i, l, :len(sel)] = pts[l, sel]
            scans.hori_rel_time[i, l, :len(sel)] = rel[sel]
        scans.hori_n_valid[i] = ok.sum(axis=1)


def rig_nominal():
    """The rig's nominal extrinsic, as a mounting drawing gives it: the
    translation to 5 cm, the two sensors' axes parallel."""
    T = np.eye(4)
    T[:3, 3] = np.round(np.asarray(cs.REC_TRANS) / 0.05) * 0.05
    return T


def _rig_bag(seed, livox, path, s0):
    from mmloam_tpu_torch.data import synthetic_bag

    cfg = cs.merging_config()
    n = max(v[1] for v in VARIANTS)
    scans, gt_R, gt_p = cs.rig_sequence(
        cfg, n, cfg.scan.max_pts_per_line, cfg.scan.hori_max_pts_per_line,
        seed=seed, rest=REST, s0=s0)
    if livox:
        livox_startup(scans, gt_R[0], gt_p[0], livox, seed)
    synthetic_bag.sequence_to_bag(scans, path, t0=100.0,
                                  hori_offset=cs.REC_OFFSET,
                                  T_hori_to_velo=cs.rig_extrinsic())
    return cfg


def _align(reference, device):
    """align_startup(frames, velo, voxel, init_T) -> T, of the port or of
    the JAX reference."""
    if reference:
        from mmloam_tpu.config import LIOConfig as JConfig
        from mmloam_tpu.data import calibration as jcal

        jcfg = JConfig()
        return lambda fr, velo, voxel, init: jcal.align_startup(
            fr, velo, jcfg, init_T=init, voxel=voxel)[0]
    from mmloam_tpu_torch.data import calibration

    cfg = cs.merging_config()
    return lambda fr, velo, voxel, init: calibration.align_startup(
        fr, velo, cfg, init_T=init, voxel=voxel, device=device)[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[11, 12, 13, 14, 15])
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="the port's device (default: the card)")
    ap.add_argument("--reference", action="store_true",
                    help="run the JAX package's align_startup on the CPU")
    ap.add_argument("--s0", type=float, default=0.0,
                    help="where on the hall trajectory the rig rests (s)")
    ap.add_argument("--variants", type=int, nargs="+", default=None,
                    help="indices into VARIANTS (default: all)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    variants = [VARIANTS[i] for i in (args.variants
                                      or range(len(VARIANTS)))]

    from mmloam_tpu_torch.data import rosbag

    align = _align(args.reference, args.device)
    T_true = cs.rig_extrinsic()
    rows = []
    os.makedirs(os.path.join(HERE, "chip_smoke_out"), exist_ok=True)
    with tempfile.TemporaryDirectory(
            dir=os.path.join(HERE, "chip_smoke_out")) as tmp:
        for seed in args.seeds:
            bags = {}
            for livox in sorted({v[2] for v in variants}):
                path = os.path.join(tmp, f"rig{seed}_{livox}.bag")
                _rig_bag(seed, livox, path, args.s0)
                bags[livox] = rosbag.BagReader(path)
            for name, n_frames, livox, n_velo, voxel, start in variants:
                init = dict(nominal=rig_nominal(), true=T_true).get(start)
                _, startup, velo = cs.startup_clouds(bags[livox], n_frames,
                                                     n_velo)
                for rep in range(args.repeats):
                    t0 = time.perf_counter()
                    T = align(startup, velo, voxel, init)
                    T = np.asarray(T, np.float64)
                    e_t, e_r = cs.extrinsic_error(T, T_true)
                    row = dict(
                        impl="reference" if args.reference else "port",
                        seed=seed, variant=name, repeat=rep, e_t=e_t, e_r=e_r,
                        ok=bool(e_t < cs.EXTRINSIC_T_MAX
                                and e_r < cs.EXTRINSIC_R_MAX),
                        secs=time.perf_counter() - t0,
                        dt=(T[:3, 3] - T_true[:3, 3]).tolist(),
                        dR=(T[:3, :3] @ T_true[:3, :3].T).tolist())
                    rows.append(row)
                    print(json.dumps(row), flush=True)
            for bag in bags.values():
                bag.close()
    for name, *_ in variants:
        er = [r["e_r"] for r in rows if r["variant"] == name]
        et = [r["e_t"] for r in rows if r["variant"] == name]
        print(f"{name}: e_r {min(er):.5f}-{max(er):.5f} rad, e_t "
              f"{min(et):.4f}-{max(et):.4f} m, "
              f"{sum(r['ok'] for r in rows if r['variant'] == name)}/"
              f"{len(er)} within bounds", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
