"""A tiny cell for the CPU tests: the port's `tiny_config()` with a
128-point Horizon line, the fleet's traffic cut to a few lanes and
scans."""

import dataclasses
import json
import os
import types

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
LIMITS = dict(flags=0, pose_m=1e-3, pose_lane_m=1e-3, ate_m=1e-3,
              ate_lane=1e-3, assoc=0.1, map=0.1)


def config_values():
    from mmloam_tpu_torch.config import tiny_config

    cfg = tiny_config()
    return dataclasses.asdict(cfg.replace(scan=dataclasses.replace(
        cfg.scan, max_pts_per_line=360, hori_max_pts_per_line=128)))


def cell(traffic="fleet-b16", lanes=2, scans=5):
    """A Cell-like object of the tiny sizes (its end-to-end metrics those
    of BENCHMARK.json)."""
    with open(os.path.join(BENCH, "traffic", traffic + ".json")) as f:
        tr = json.load(f)
    tr.update(lanes=lanes, scans=scans, trace_steps=2)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return types.SimpleNamespace(
        name="tiny", chips=1, config=dict(config=config_values()),
        traffic=tr, end_to_end=bench["end_to_end"], per_layer=[])
