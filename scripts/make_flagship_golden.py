"""Regenerate the flagship-width golden of the JAX reference,
tests/golden/flagship_lio.npz.

Three runs at `LIOConfig()` (16x1024 VLP-16 rings, 6x2048 Horizon lines,
the 256x256x64 torus, 2048-point stacks, bf16 dense blocks):

* ``batch``: bench.py's inputs (`bench.build_inputs`) at B=4, T=16,
  seed0=7 through `replay.replay_batch` (the main path);
* ``one``: tests/test_flagship.py's 40-scan dual-lidar drive (the hall,
  speed 0.8, seed 7) through `replay.replay`;
* ``street``: scripts/street_drive.py's 500-scan canyon drive (range
  noise 0.004) through `replay.replay`.

For each run and scan the file holds every `StepOutput` field
(``<run>/<field>``), a digest of each scan's inputs (``<run>/in_*``: the
valid point counts, float64 sums of the valid points of each LiDAR and of
the IMU samples), a digest of each final map (``<run>/map_*``: occupied
cells, the float64 sum of the sum lanes, the sum of counts; for ``batch``
a row a lane), the reference's ATE RMSE against the analytic trajectory
(``<run>/ate``), and its provenance (``jax_version``, ``config``: the
config's `asdict` as JSON).  A mismatch of the input digests reads as an
input drift, not as a fault of the code under test.

It also holds the reference's own spread (``<run>/spread_*``): the run
replayed again at each of bench.py's input perturbations (every VLP-16
point shifted by 1e-5, 2e-5, 3e-5 m, `PERTURB`), and for every field
above the largest difference of those runs from the golden run, scan by
scan.  A replay at these widths amplifies rounding: a difference of 1e-6
m flips an association at a gate and grows from there, in the reference
as in anything held against it.  `compare` holds a run against the golden
under these bounds:

* input digests: bit for bit;
* discrete outputs (flags, stamps, counts): within `SPREAD_K` times the
  spread over the run, which is 0, so exact, wherever the reference's own
  perturbed runs never change them;
* pose_p, pose_q, sv_min (relative): within the floor `FLOORS` (pose_p
  `POSE_ATOL`) up to the scan where the spread first exceeds it (the
  horizon), and from there within max(floor, `SPREAD_K` times the
  spread's largest value over the run);
* final maps: occupied cells, counts and sums (relative) within
  `SPREAD_K` times the spread;
* ATE: within max(`ATE_SLACK`, `SPREAD_K` times the spread).

The module's top level imports numpy only: `input_digest`, `map_digest`,
`RUNS`, `build` and `compare` are shared with the checks that hold the
PyTorch port against this file (tests/test_torch_flagship.py,
chip_smoke.py, street_drive_torch.py --golden).  `main` runs the JAX
package on the CPU at its pinned matmul precision
(`mmloam_tpu/__init__.py`), without x64, as the reference's own scripts
run it (~17 min on 8 cores, the perturbed runs included):

    JAX_PLATFORMS=cpu python scripts/make_flagship_golden.py
    JAX_PLATFORMS=cpu python scripts/make_flagship_golden.py --check

`--check` recomputes every run and holds it against the committed file:
the discrete fields and the input and map counts equal, every float
within 1e-6 (absolute or relative).
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "flagship_lio.npz")

FIELDS = ("pose_q", "pose_p", "t", "fail", "degenerate", "sv_min", "inited",
          "n_corner", "n_surf", "fast_rotation", "hori_merged",
          "n_assoc_line", "n_assoc_plane")
MAPS = ("vm_corner", "vm_surf", "vm_non", "vm_local_corner", "vm_local_surf")
EXACT = ("inited", "fail", "degenerate", "fast_rotation", "hori_merged", "t")
COUNTS = ("n_corner", "n_surf", "n_assoc_line", "n_assoc_plane")
META_MOD = 128.0        # a cell's meta lane: key * META_MOD + count

# bench.py's input perturbations (`bench.main`: pts + 1e-5 * (rep + 1))
PERTURB = (1e-5, 2e-5, 3e-5)
SPREAD_K = 2.0          # times the reference's own spread
POSE_ATOL = 0.01        # m: the hall_25 bound (tests/test_torch_pipeline.py)
# floors of the float fields: pose_p (m), pose_q (quaternion components,
# ~0.1 degree), sv_min (relative)
FLOORS = dict(pose_p=POSE_ATOL, pose_q=1e-3, sv_min=1e-2)
ATE_SLACK = 0.01        # m: the hall_25 ATE slack (chip_smoke.py)

# run -> (world, trajectory keywords, make_sequence keywords, scans, lanes)
RUNS = {
    "batch": ("default_world", None,
              dict(seed=7, range_noise=0.003, with_hori=True), 16, 4),
    "one": ("default_world", dict(speed=0.8, z_amp=0.1),
            dict(seed=7, range_noise=0.003, with_hori=True), 40, None),
    "street": ("street_world",
               dict(speed=2.8, radius_x=100.0, radius_y=3.0, yaw_rate=0.05,
                    z_amp=0.1),
               dict(range_noise=0.004), 500, None),
}


def _lane_traj(b):
    """bench.py's trajectory of lane b (`bench.build_inputs`)."""
    return dict(speed=0.6 + 0.05 * (b % 8), z_amp=0.1,
                yaw_rate=0.2 + 0.02 * (b % 8))


def build(run, make_sequence, synthetic, cfg, n_scans=None, **kw):
    """The numpy inputs of `run` through a package's `make_sequence` and
    `synthetic` module (both packages build them bit for bit alike): (scans
    laid out (T, ...) or, for a batch, (T, B, ...); [(gt_R, gt_p)] a
    lane).  `kw` goes to `make_sequence` (the reference's
    ``to_device=False``)."""
    world, traj, seq_kw, T, B = RUNS[run]
    T = T if n_scans is None else n_scans
    world = getattr(synthetic, world)()
    lanes = range(B or 1)
    seqs, gts = [], []
    for b in lanes:
        seed = seq_kw.get("seed", 0) + (b if B else 0)
        tr = synthetic.Trajectory(**(_lane_traj(b) if B else traj))
        extra = dict(hori_n_az=cfg.scan.hori_max_pts_per_line) \
            if seq_kw.get("with_hori") else {}
        scans, gt_R, gt_p = make_sequence(
            world, tr, 0.0, T, cfg, n_az=cfg.scan.max_pts_per_line,
            dtype=np.float32, **dict(seq_kw, seed=seed), **extra, **kw)
        seqs.append(scans)
        gts.append((gt_R, gt_p))
    if B is None:
        return seqs[0], gts
    return type(seqs[0])(*(None if x is None else np.stack(
        [getattr(s, f) for s in seqs], axis=1)
        for f, x in zip(seqs[0]._fields, seqs[0]))), gts


def _valid_sum(pts, n_valid):
    """float64 sum of each coordinate over the valid prefix of each line:
    pts (..., L, N, 3), n_valid (..., L) -> (..., 3)."""
    keep = np.arange(pts.shape[-2]) < np.asarray(n_valid)[..., None]
    return (np.asarray(pts, np.float64) * keep[..., None]).sum(axis=(-3, -2))


def input_digest(scans):
    """A scan's inputs in a few numbers (every leaf numpy, laid out (T,
    ...) or (T, B, ...)): valid point counts a line, float64 sums of the
    valid points of each LiDAR, of the IMU samples ([acc, gyr, dt] over
    the mask) and the stamps."""
    mask = np.asarray(scans.imu_mask, bool)[..., None]
    imu = np.concatenate([np.asarray(scans.imu_acc, np.float64),
                          np.asarray(scans.imu_gyr, np.float64),
                          np.asarray(scans.imu_dt, np.float64)[..., None]],
                         axis=-1)
    out = dict(in_n_valid=np.asarray(scans.n_valid, np.int32),
               in_velo_sum=_valid_sum(scans.pts, scans.n_valid),
               in_imu_sum=(imu * mask).sum(axis=-2),
               in_t=np.asarray(scans.t, np.float64))
    if scans.hori_pts is not None:
        out.update(in_hori_n_valid=np.asarray(scans.hori_n_valid, np.int32),
                   in_hori_sum=_valid_sum(scans.hori_pts,
                                          scans.hori_n_valid))
    return out


def map_digest(cells):
    """A map's packed superrows (Cs, 4 cpr), or a batch of them (B, Cs, 4
    cpr), in three numbers each: occupied cells (count > 0), the float64
    sum of the sum lanes, the sum of the counts."""
    cells = np.asarray(cells, np.float64)
    cpr = cells.shape[-1] // 4
    meta = cells[..., 3 * cpr:]
    count = meta - np.floor(meta / META_MOD) * META_MOD
    return ((count > 0).sum(axis=(-2, -1)),
            cells[..., :3 * cpr].sum(axis=(-2, -1)),
            count.sum(axis=(-2, -1)))


def maps_digest(state, to_numpy=np.asarray):
    """`map_digest` of each of MAPS of a final state (its cells through
    `to_numpy`): {map_occupied, map_sum, map_count}, each (len(MAPS),) or
    (B, len(MAPS))."""
    per = [map_digest(to_numpy(getattr(state, m).cells)) for m in MAPS]
    return {k: np.stack([p[i] for p in per], axis=-1)
            for i, k in enumerate(("map_occupied", "map_sum", "map_count"))}


def ate(pose_p, t, gt_R, gt_p):
    """ATE RMSE of the published positions against the analytic
    trajectory, the street drive's rule (odometry starts at identity)."""
    gt_rel = np.einsum("ij,nj->ni", gt_R[0].T, gt_p - gt_p[0])
    idx = np.rint(np.asarray(t, np.float64) / 0.1).astype(int) - 1
    return float(np.sqrt(((np.asarray(pose_p) - gt_rel[idx]) ** 2)
                         .sum(1).mean()))


def result(outs, final, scans, gts, to_numpy=np.asarray):
    """A run as the golden holds it: {key: numpy} of the StepOutput
    fields (`outs`, stacked (T, ...) or (T, B, ...)), the input digests of
    the numpy `scans`, and, given the `final` state, its maps' digests and
    the ATE against `gts` ([(gt_R, gt_p)] a lane).  `to_numpy` turns a
    leaf into numpy (a tensor on the card: ``lambda a: a.cpu().numpy()``)."""
    got = {f: to_numpy(getattr(outs, f)) for f in FIELDS}
    got.update(input_digest(scans))
    if final is not None:
        got.update(maps_digest(final, to_numpy))
        p, t = got["pose_p"], got["t"]
        got["ate"] = np.array(
            [ate(p[:, b], t[:, b], *gts[b]) for b in range(p.shape[1])]
            if p.ndim == 3 else ate(p, t, *gts[0]))
    return got


def load(path=GOLDEN):
    """{run: {key: array}} of the golden file."""
    g = np.load(path)
    out = {}
    for k in g.files:
        if "/" in k:
            run, key = k.split("/", 1)
            out.setdefault(run, {})[key] = g[k]
    return out


def _per_scan(d, n):
    """Largest |difference| of each scan over every other axis."""
    return np.asarray(d, np.float64)[:n].reshape(n, -1).max(axis=1)


def differences(want, got):
    """{field: |got - want|} of the StepOutput fields (sv_min relative to
    the golden's magnitude), each (T, ...), and of the map digests
    (map_sum relative), as the spread and `compare` measure them."""
    out = {}
    for f in FIELDS:
        g = np.asarray(got[f], np.float64)
        w = np.asarray(want[f], np.float64)
        d = np.abs(g - w)
        if f == "sv_min":
            d = d / np.maximum(np.abs(w), 1e-12)
        out[f] = d
    if "map_occupied" in got:
        for k in ("map_occupied", "map_count", "map_sum"):
            d = np.abs(np.asarray(got[k], np.float64) - want[k])
            out[k] = d / np.maximum(np.abs(want[k]), 1.0) \
                if k == "map_sum" else d
    if "ate" in got:
        out["ate"] = np.abs(np.asarray(got["ate"]) - want["ate"])
    return out


def compare(want, got, n=None):
    """Hold `got` ({key: numpy}: the StepOutput fields over the first `n`
    scans, optionally the input digests, the map digests of the final
    state and "ate") against the golden run `want`, under the bounds the
    module docstring states.  Returns (what failed, {field: largest
    difference, field_bound, field_first_over: the first scan over its
    bound or None})."""
    n = len(want["t"]) if n is None else n
    d = differences({k: v[:n] if k in FIELDS else v
                     for k, v in want.items()}, got)
    bad, seen = [], {}

    def hold(key, diff, bound, per_scan_bound=None, what="scan"):
        over = diff > (bound if per_scan_bound is None else per_scan_bound)
        seen[key] = float(diff.max())
        seen[key + "_bound"] = float(bound)
        seen[key + "_first_over"] = int(np.argmax(over)) if over.any() \
            else None
        if over.any():
            bad.append(f"{key} off by {seen[key]:.4g} (bound {bound:.4g}) "
                       f"from {what} {seen[key + '_first_over']}")

    for f in EXACT + COUNTS:
        hold(f, _per_scan(d[f], n),
             SPREAD_K * _per_scan(want["spread_" + f], n).max())
    for f, floor in FLOORS.items():
        spread = _per_scan(want["spread_" + f], n)
        H = int(np.argmax(spread > floor)) if (spread > floor).any() else n
        late = max(floor, SPREAD_K * spread.max())
        per = np.where(np.arange(n) < H, floor, late)
        hold(f, _per_scan(d[f], n), late, per)
        seen[f + "_horizon"] = H
    for k in want:
        if k.startswith("in_") and k in got \
                and not np.array_equal(np.asarray(got[k])[:n], want[k][:n]):
            bad.append(f"input digest {k} differs: an input drift")
    if "map_occupied" in got:
        for k in ("map_occupied", "map_count", "map_sum"):
            hold(k, d[k].reshape(-1), SPREAD_K * want["spread_" + k].max(),
                 what="map (lane-major)")
    if "ate" in got:
        hold("ate", np.atleast_1d(d["ate"]),
             max(ATE_SLACK, SPREAD_K * want["spread_ate"].max()),
             what="lane")
    return bad, seen


def spread(want, perturbed):
    """The reference's own spread: for each key `differences` measures,
    the largest difference of any perturbed run from the golden run."""
    ds = [differences(want, p) for p in perturbed]
    return {"spread_" + k: np.max([d[k] for d in ds], axis=0)
            for k in ds[0]}


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import dataclasses

    import jax
    import jax.numpy as jnp

    from mmloam_tpu import pipeline, replay
    from mmloam_tpu.config import LIOConfig
    from mmloam_tpu.data import synthetic

    cfg = LIOConfig()
    arrays = dict(jax_version=np.array(jax.__version__),
                  config=np.array(json.dumps(dataclasses.asdict(cfg),
                                             sort_keys=True)))
    def run_once(scans, B, gts):
        dev = jax.tree.map(jnp.asarray, scans)
        if B:
            states = replay.stack_states([pipeline.init_state(cfg)
                                          for _ in range(B)])
            final, outs = replay.replay_batch(states, dev, cfg)
        else:
            final, outs = replay.replay(pipeline.init_state(cfg), dev, cfg)
        res = result(outs, final, scans, gts)
        assert np.isfinite(res["pose_p"]).all(), "non-finite poses"
        return res

    for run, (_, _, _, T, B) in RUNS.items():
        t0 = time.perf_counter()
        scans, gts = build(run, replay.make_sequence, synthetic, cfg,
                           to_device=False)
        built = time.perf_counter() - t0
        res = run_once(scans, B, gts)
        print(f"{run}: T={T} B={B or 1} built {built:.1f} s, replayed "
              f"{time.perf_counter() - t0 - built:.1f} s; ATE "
              f"{np.round(res['ate'], 4).tolist()} m; inited at scan "
              f"{np.argmax(res['inited'], axis=0).tolist()}", flush=True)
        # bench.py's perturbations of its timed repetitions: every
        # VLP-16 point shifted by 1e-5 m times (rep + 1)
        res.update(spread(res, [run_once(scans._replace(
            pts=scans.pts + np.float32(eps)), B, gts) for eps in PERTURB]))
        print(f"{run}: spread {PERTURB}: pose_p "
              f"{res['spread_pose_p'].max():.4g} m, counts "
              f"{[int(res['spread_' + f].max()) for f in COUNTS]}, ATE "
              f"{np.max(res['spread_ate']):.4g} m; wall "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        arrays.update({f"{run}/{k}": v for k, v in res.items()})
    if "--check" in sys.argv:
        old = np.load(GOLDEN)
        for k, v in arrays.items():
            w = old[k]
            same = (np.array_equal(v, w) if v.dtype.kind in "biuU"
                    or k.split("/")[-1] in EXACT + COUNTS
                    else np.allclose(v, w, rtol=1e-6, atol=1e-6))
            assert same, f"{k} drifted from the committed golden"
        print(f"check: every key of {GOLDEN} reproduced (discrete fields "
              "equal, floats within 1e-6)")
        return
    np.savez_compressed(GOLDEN, **arrays)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    main()
