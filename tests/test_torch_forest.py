"""The `mmloam-forest` deployment: the MM-LOAM rig at its sensors'
published point rates in a synthetic forest, where the Horizon's sweep
passes the upstream's 100-corner gate and is fused into the estimate.

* `benchmark/configs/mmloam-forest.json` builds through the harness's
  `spec.build_config` into `LIOConfig()` with the data-sheet widths
  (16 x 1808, 6 x 4000) and the stack caps (3072, 6144), nothing else
  changed; the forest's 300 trunks in `traffic/forest-b16.json` are the
  draw its `about` describes.
* At a small forest on the CPU (the tiny config with stacks that do not
  bind, the Horizon gate at the upstream's 100, 100 trunks), the port's
  `replay_batch` against the benchmark's frozen reference
  (`benchmark/reference`, the lockstep step op by op) and the JAX
  package's `replay_batch` on the same inputs: inited, fail and
  hori_merged exactly, the Horizon merged on every lane-scan, no point
  dropped by a cap (`spans.fusion_counts()`), poses within the bounds
  stated beside them.  The JAX package's compile of its replay takes
  most of this file's time (~60 s on one core).
* The benchmark's `hori_merged_pct` and `stack_drop_pct` readers read
  nothing from a `spans` module without `fusion_counts`, and the
  percentages of a stub's counts.
"""

import dataclasses
import importlib.util
import json
import os
import sys
import types

import numpy as np
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from mmloam_tpu import pipeline as jp  # noqa: E402
from mmloam_tpu import replay as jr  # noqa: E402
from mmloam_tpu.config import tiny_config as jax_tiny_config  # noqa: E402

from mmloam_tpu_torch import pipeline as tp  # noqa: E402
from mmloam_tpu_torch import replay as tr  # noqa: E402
from mmloam_tpu_torch import spans  # noqa: E402
from mmloam_tpu_torch.config import LIOConfig, tiny_config  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import compare, spec, traffic  # noqa: E402

B, T = 2, 6
# stacks no tiny forest fills: the test holds the fusion, not the caps
_CAPS = dict(max_corner=1024, max_surf=2048)
CFG = tiny_config()
CFG = CFG.replace(scan=dataclasses.replace(CFG.scan, **_CAPS))
JCFG = jax_tiny_config()
JCFG = JCFG.replace(scan=dataclasses.replace(JCFG.scan, **_CAPS))
# the frozen reference is a copy of the port's eager step: on the CPU the
# two agree bit for bit; 1e-5 m is the teacher-forced step's bound of the
# JAX tests, room for a later port change that rounds a last bit apart
REF_POSE_ATOL = 1e-5
# the JAX package's vmapped replay fuses the feature curvature otherwise
# than the port rounds it (ops/features._fma), which can move a feature
# pick: the batch replay bound of test_torch_pipeline.py
JAX_POSE_ATOL = 5e-3


def forest(n, seed=5, half=40.0, band=(9.0, 4.0), radius=(0.15, 0.35),
           z=(-1.3, 12.0)):
    """The trunks of `traffic/forest-b16.json`'s `about`: for each
    candidate the centre (x, y) = rng.uniform(-half, half, 2), then the
    half-width r = rng.uniform(*radius), rejected where |x| < band[0] + r
    and |y| < band[1] + r, until n are kept; corners rounded to 0.1 mm."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        x, y = rng.uniform(-half, half, 2)
        r = rng.uniform(*radius)
        if abs(x) < band[0] + r and abs(y) < band[1] + r:
            continue
        out.append([[round(float(x - r), 4), round(float(y - r), 4), z[0]],
                    [round(float(x + r), 4), round(float(y + r), 4), z[1]]])
    return out


def _json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def test_forest_config_builds_the_stated_widths_and_caps():
    values = _json("benchmark", "configs", "mmloam-forest.json")
    cfg = spec.build_config(LIOConfig, values["config"])
    base = LIOConfig()
    assert cfg == base.replace(scan=dataclasses.replace(
        base.scan, max_pts_per_line=1808, hori_max_pts_per_line=4000,
        max_corner=3072, max_surf=6144))
    entry = {c["name"]: c for c in _json("BENCHMARK.json")["configs"]}[
        "mmloam-forest"]
    assert entry["file"] == "benchmark/configs/mmloam-forest.json"
    assert entry["reduced"] == [] and entry["source"] == values["source"]
    # the cell's traffic: fleet-b16's fleet in the drawn forest
    tr_f = _json("benchmark", "traffic", "forest-b16.json")
    tr_h = _json("benchmark", "traffic", "fleet-b16.json")
    assert {k: v for k, v in tr_f.items() if k not in ("world", "about")} \
        == {k: v for k, v in tr_h.items() if k not in ("world", "about")}
    assert tr_f["world"] == dict(room_min=[-60.0, -60.0, -1.3],
                                 room_max=[60.0, 60.0, 40.0],
                                 pillars=forest(300))


def _inputs():
    """B lanes x T scans of a small forest (100 trunks within 15 m) at
    the tiny sizes, a 6 x 512 Horizon, the fleet's trajectories."""
    world = traffic.BoxWorld([-25.0, -25.0, -1.3], [25.0, 25.0, 20.0],
                             forest(100, half=15.0))
    fleet = _json("benchmark", "traffic", "fleet-b16.json")
    lanes = [traffic.make_sequence(
        world, traffic.lane_trajectory(fleet, b), T, 360, 512,
        CFG.imu.max_samples, CFG.imu.gnorm, range_noise=0.003, seed=[7, b])
        for b in range(B)]
    return {f: np.stack([ln[0][f] for ln in lanes], axis=1)
            for f in traffic.SCAN_FIELDS}


def test_small_forest_fuses_the_horizon_as_the_references_do():
    assert CFG.solver.corner_cnt_gate_hori == 100
    scans = _inputs()
    states = tr.stack_states([tp.init_state(CFG, device="cpu")
                              for _ in range(B)])
    _, ot = tr.replay_batch(
        states, tp.scan_from_numpy(tp.ScanInput(**scans), device="cpu"), CFG)
    got = {f: getattr(ot, f).numpy() for f in ot._fields}
    assert got["hori_merged"].all()
    assert (got["n_corner_ds"] <= CFG.scan.max_corner).all()
    assert (got["n_surf_ds"] <= CFG.scan.max_surf).all()
    counts = spans.fusion_counts()
    assert counts["lane_scans"] == counts["hori_merged"] == B * T
    assert counts["corner_dropped"] == counts["surf_dropped"] == 0
    assert counts["corner_kept"] == got["n_corner_ds"].sum()
    assert counts["surf_kept"] == got["n_surf_ds"].sum()

    ref, _ = compare.reference_replay(
        dataclasses.asdict(CFG), dict(entry="replay_batch", lanes=B), scans,
        torch.device("cpu"))
    _, oj = jr.replay_batch(
        jr.stack_states([jp.init_state(JCFG) for _ in range(B)]),
        jax.tree.map(jnp.asarray, jp.ScanInput(**scans)), JCFG)
    jax_out = {f: np.asarray(getattr(oj, f)) for f in oj._fields}
    for want, atol in ((ref, REF_POSE_ATOL), (jax_out, JAX_POSE_ATOL)):
        for name in ("inited", "fail", "hori_merged"):
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)
        np.testing.assert_allclose(got["pose_p"], want["pose_p"], atol=atol)


def _reader(name):
    path = os.path.join(BENCH, "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location("reader_" + name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name", ["hori_merged_pct", "stack_drop_pct"])
def test_fusion_readers(monkeypatch, name):
    from harness import layers

    read = _reader(name)
    ctx = types.SimpleNamespace(T=30)
    monkeypatch.setattr(layers, "spans_module",
                        lambda: types.SimpleNamespace())
    assert read(ctx) is None
    monkeypatch.setattr(layers, "spans_module", lambda: None)
    assert read(ctx) is None
    counts = dict(lane_scans=480, hori_merged=456, corner_kept=900,
                  corner_dropped=100, surf_kept=2900, surf_dropped=100)
    monkeypatch.setattr(layers, "spans_module", lambda: types.SimpleNamespace(
        fusion_counts=lambda: dict(counts)))
    want = dict(hori_merged_pct=95.0, stack_drop_pct=5.0)[name]
    assert read(ctx) == pytest.approx(want, rel=1e-12)
    monkeypatch.setattr(layers, "spans_module", lambda: types.SimpleNamespace(
        fusion_counts=lambda: None))
    assert read(ctx) is None
