"""The frozen reference (`benchmark/reference/`, which decides `correct`)
against the JAX reference's own results at `LIOConfig()`, on the CPU.

tests/golden/flagship_lio.npz holds them (scripts/make_flagship_golden.py
wrote it from the JAX package): bench.py's batch (B=4 x 16 scans, the
lockstep step) and the 40-scan dual-lidar drive (one lane, the one-lane
step).  Each runs here through `compare.reference_replay`, as a cell's
check runs it, from inputs of the benchmark's frozen generator, and is
held to the file by the script's own `compare`: the input digests bit for
bit, flags and stamps exactly, counts within twice the JAX reference's
own spread, positions within 0.01 m up to that spread's horizon and
within twice the spread after, the final maps and the ATE likewise.  So
the reference's agreement with the JAX package is shown, not assumed.
Nothing of the JAX package or of the port is imported: the test reads the
npz and loads the script's numpy-only top level by path.
"""

import collections
import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

import tiny
from harness import compare, traffic

Scans = collections.namedtuple("Scans", traffic.SCAN_FIELDS)


def _golden_module():
    spec = importlib.util.spec_from_file_location(
        "make_flagship_golden",
        os.path.join(tiny.ROOT, "scripts", "make_flagship_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _synthetic():
    """The golden's `synthetic` argument, from the frozen generator: the
    hall of the fleet's traffic file and the frozen trajectory."""
    with open(os.path.join(tiny.BENCH, "traffic", "fleet-b16.json")) as f:
        hall = json.load(f)
    return types.SimpleNamespace(default_world=lambda: traffic.world_of(hall),
                                 Trajectory=traffic.Trajectory)


def _make_sequence(world, traj, t0, n_scans, cfg, n_az, dtype, seed,
                   range_noise, with_hori=False, hori_n_az=None):
    """The port's `make_sequence` signature over the frozen generator,
    which builds the dual-lidar case it copies."""
    assert t0 == 0.0 and with_hori and dtype == np.float32
    scans, gt_R, gt_p = traffic.make_sequence(
        world, traj, n_scans, n_az, hori_n_az, cfg.imu.max_samples,
        cfg.imu.gnorm, range_noise=range_noise, seed=seed)
    return Scans(**scans), gt_R, gt_p


@pytest.mark.parametrize("run", ["batch", "one"])
def test_reference_matches_jax_golden(run):
    from reference.config import LIOConfig

    torch.set_num_threads(min(4, torch.get_num_threads()))
    fg = _golden_module()
    want = fg.load()[run]
    B = fg.RUNS[run][4]
    scans, gts = fg.build(run, _make_sequence, _synthetic(), LIOConfig())
    arrays = scans._asdict()
    if B is None:                          # one lane: add the lane axis
        arrays = {f: a[:, None] for f, a in arrays.items()}
    kept = []
    outs, _ = compare.reference_replay(
        {}, dict(entry="replay" if B is None else "replay_batch",
                 lanes=B or 1), arrays, torch.device("cpu"),
        final=kept.append)
    lane = (lambda a: a[:, 0]) if B is None else (lambda a: a)
    got_outs = types.SimpleNamespace(**{f: lane(a) for f, a in outs.items()})
    # the outputs are numpy already; the final maps' cells are tensors
    # (with the lane axis of one for one lane)
    to_numpy = lambda a: a if isinstance(a, np.ndarray) else (
        a.numpy()[0] if B is None else a.numpy())
    got = fg.result(got_outs, kept[0], scans, gts, to_numpy)
    bad, seen = fg.compare(want, got)
    print(f"{run}: {seen}")
    assert not bad, f"{run}: {bad}"
