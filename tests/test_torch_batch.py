"""The port's lockstep batch: one `pipeline.step_core_batch` over all
lanes, held against each lane run alone.

* Lane independence: a B=3 `replay_batch` of 12 tiny-config scans against
  three B=1 `replay`s of the same lanes.  The lanes diverge on purpose:
  lane 1 starts at rest with its IMU silent for its first six scans, so
  its first init attempt fails (`InitResult.ok` false) and it initializes
  three scans after lane 0; lane 2 starts mid-sequence (four scans of its
  own replayed first, its step counter advanced by 9), so it estimates
  while the fresh lanes' maps are empty, initializes first, and is the
  only lane whose gravity refinement fires; the LM stops at different
  iterations per lane.  Discrete outputs must be equal and poses within
  POSE_ATOL.
* `lm_solve` at per-lane caps and skips against each lane alone (on a
  window captured from that replay), bit for bit.
* K2's plain version with a lane axis against one call per lane, bit for
  bit: every stage, fresh and cached, the rescue with its cap binding and
  not, and under `dedup_gather`.
* No host sync: `torch.profiler` over one `step_core_batch` finds no
  device read (`aten::_local_scalar_dense`, `aten::item`) but the named
  ones, one a `torch.linalg.eigh` call (its error check; on the card the
  kernel K3 solves instead and reads nothing), as many at B=3 as at B=1.  Boolean-mask indexing and `nonzero` do not show here; the card
  checks them (chip_smoke.py phase 13).
"""

import dataclasses
import functools
import importlib.util
import pathlib

import numpy as np
import torch

torch.set_num_threads(1)

import pytest  # noqa: E402

from mmloam_tpu_torch import pipeline as tp  # noqa: E402
from mmloam_tpu_torch import replay as tr  # noqa: E402
from mmloam_tpu_torch.config import tiny_config  # noqa: E402
from mmloam_tpu_torch.data import synthetic as tsyn  # noqa: E402
from mmloam_tpu_torch.estimator import initializer as tinit  # noqa: E402
from mmloam_tpu_torch.estimator import solver as tsol  # noqa: E402
from mmloam_tpu_torch.ops import assoc, voxelmap  # noqa: E402
from mmloam_tpu_torch.tree import tree_map  # noqa: E402

CFG = tiny_config()
T = 12
PRE = 4            # scans lane 2 replays before the batch starts
STEP_SKEW = 9      # lane 2's step counter ahead: its refinement fires
SILENT = 6         # scans lane 1's IMU is silent at its start
POSE_ATOL = 1e-5


def _startup_trajectory():
    """chip_smoke.py's StartupTrajectory (a trajectory held at rest, then
    eased into motion with an exact simulated IMU), loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.StartupTrajectory


def _seq(traj, seed, n=T):
    return tr.make_sequence(tsyn.default_world(), traj, 0.0, n, CFG,
                            n_az=360, dtype=np.float32, range_noise=0.003,
                            seed=seed, device="cpu")[0]


@functools.lru_cache(maxsize=None)
def _lanes():
    """The three lanes' start states and scans (T, ...)."""
    hall = tsyn.Trajectory(speed=0.8, z_amp=0.15)
    rest = _seq(_startup_trajectory()(hall, 0.9, 0.6), 2)
    mask = rest.imu_mask.clone()
    mask[:SILENT] = False
    rest = rest._replace(imu_mask=mask)
    early = _seq(tsyn.Trajectory(speed=0.7, yaw_rate=0.3, z_amp=0.1), 3,
                 T + PRE)
    st2, _ = tr.replay(tp.init_state(CFG, device="cpu"),
                       tree_map(lambda a: a[:PRE], early), CFG)
    st2 = st2._replace(step_idx=st2.step_idx + STEP_SKEW)
    states = [tp.init_state(CFG, device="cpu"),
              tp.init_state(CFG, device="cpu"), st2]
    scans = [_seq(hall, 1), rest, tree_map(lambda a: a[PRE:], early)]
    return states, scans


def _fresh(states):
    """Copies of the start states (the batch writes its maps in place)."""
    return [tree_map(torch.clone, s) for s in states]


@functools.lru_cache(maxsize=None)
def _batch_run():
    """The B=3 lockstep replay, with what it decided per lane: init
    attempts and their ok flags, the gravity after each scan, each LM
    solve's iterations, and the inputs of the last solve."""
    states, scans = _lanes()
    rec = dict(attempt=[], ok=[], iters=[], solve=None)
    init0, try0, lm0 = tinit.initialize, tp._try_init, tsol.lm_solve

    def init_spy(*a, **k):
        res = init0(*a, **k)
        rec["ok_last"] = res.ok
        return res

    def try_spy(s, cfg, attempt):
        out = try0(s, cfg, attempt)
        rec["attempt"].append(attempt)
        rec["ok"].append(rec["ok_last"])
        return out

    def lm_spy(*a, **k):
        rec["solve"] = a[:8]     # the last solve's inputs
        res = lm0(*a, **k)
        rec["iters"].append(res.iters)
        return res

    batch = tr.stack_states(_fresh(states))
    seq = tr.stack_sequences(scans)
    outs, grav = [], []
    tinit.initialize, tp._try_init, tsol.lm_solve = init_spy, try_spy, lm_spy
    try:
        for t in range(T):
            batch, out, pend = tp.step_core_batch(
                batch, tree_map(lambda a: a[t], seq), CFG)
            grav.append(batch.gravity)
            batch = tp.apply_inserts_batched(batch, pend, CFG)
            outs.append(out)
    finally:
        tinit.initialize, tp._try_init, tsol.lm_solve = init0, try0, lm0
    rec["grav"] = torch.stack(grav)
    return batch, tr._stack_outputs(outs), rec


def test_lanes_diverge():
    """The lanes take different branches of every per-lane decision."""
    _, outs, rec = _batch_run()
    inited = outs.inited.numpy()
    first = [int(np.argmax(inited[:, b])) if inited[:, b].any() else None
             for b in range(3)]
    assert first == [8, 11, 4], first
    assert inited[-1].all()
    # lane 1's first attempt (scan 8) fails; every other attempt succeeds
    att = torch.stack(rec["attempt"]).numpy()
    ok = torch.stack(rec["ok"]).numpy()
    failed = np.argwhere(att & ~ok)
    assert failed.tolist() == [[8, 1]], failed
    # scan 0: lane 2 estimates while the fresh lanes' maps hold nothing
    plane0 = outs.n_assoc_plane[0].numpy()
    assert plane0[0] == plane0[1] == 0 and plane0[2] > 100
    # the gravity refinement changes gravity after init on lane 2 alone
    g = rec["grav"]
    moved = ((g[1:] != g[:-1]).any(dim=-1) & outs.inited[:-1]).numpy()
    assert moved.any(axis=0).tolist() == [False, False, True]
    # LM solves that stop at different iterations in one call
    its = torch.stack(rec["iters"])
    assert bool((its.amax(dim=1) != its.amin(dim=1)).any())


def test_batch_matches_each_lane_alone():
    """B=3 lockstep replay == three B=1 replays: discrete outputs exactly,
    poses within POSE_ATOL."""
    states, scans = _lanes()
    final, outs, _ = _batch_run()
    for b in range(3):
        fin1, out1 = tr.replay(_fresh(states)[b], scans[b], CFG)
        for name in ("inited", "fail", "degenerate", "n_corner", "n_surf",
                     "n_assoc_line", "n_assoc_plane", "fast_rotation",
                     "hori_merged", "t"):
            np.testing.assert_array_equal(
                getattr(outs, name)[:, b].numpy(),
                getattr(out1, name).numpy(), err_msg=f"lane {b} {name}")
        for name in ("pose_p", "pose_q", "sv_min"):
            np.testing.assert_allclose(getattr(outs, name)[:, b].numpy(),
                                       getattr(out1, name).numpy(),
                                       atol=POSE_ATOL, rtol=0,
                                       err_msg=f"lane {b} {name}")
        np.testing.assert_allclose(final.x[b].numpy(), fin1.x.numpy(),
                                   atol=POSE_ATOL, rtol=0)
        for f in ("inited", "kf_count", "kf_phase", "step_idx",
                  "frame_valid", "pair_valid", "map_has_data"):
            np.testing.assert_array_equal(getattr(final, f)[b].numpy(),
                                          getattr(fin1, f).numpy(),
                                          err_msg=f"lane {b} {f}")
        for f in tp.MAP_FIELDS:
            np.testing.assert_array_equal(
                getattr(final, f).cells[b].numpy(),
                getattr(fin1, f).cells.numpy(), err_msg=f"lane {b} {f}")


@pytest.mark.parametrize("caps,skip", [((10, 3, 10), (False, False, True)),
                                       ((1, 10, 4), (False, True, False))])
def test_lm_solve_lanes(caps, skip):
    """Per-lane caps and skips against each lane solved alone: bit-equal
    windows, iterations, costs and convergence flags."""
    _, _, rec = _batch_run()
    args, cfg = rec["solve"][:7], rec["solve"][7]
    cap = torch.tensor(caps, dtype=torch.int32)
    sk = torch.tensor(skip)
    res = tsol.lm_solve(*args, cfg, cap, max(caps), skip=sk)
    assert res.iters.tolist() != [0, 0, 0]
    for b in range(3):
        one = tree_map(lambda a: a[b:b + 1], args)
        r1 = tsol.lm_solve(*one, cfg, cap[b:b + 1], caps[b],
                           skip=sk[b:b + 1])
        for name in SolveFields:
            assert torch.equal(getattr(res, name)[b:b + 1],
                               getattr(r1, name)), (b, name)
        assert int(r1.iters) <= caps[b]
        if skip[b]:
            assert int(r1.iters) == 0 and bool(r1.converged)


SolveFields = tsol.SolveResult._fields


def _random_map(seed, mcfg, n=600, span=3.0):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-span, span, (n, 3))
                           .astype(np.float32))
    return voxelmap.insert(voxelmap.empty_map(mcfg, device="cpu"), pts,
                           torch.ones(n, dtype=torch.bool), mcfg)


def _lane_inputs(mcfg, M=96, B=3):
    rng = np.random.default_rng(7)
    vms = [_random_map(11 + b, mcfg) for b in range(B)]
    lvs = [_random_map(21 + b, mcfg, n=300) for b in range(B)]
    pw = torch.from_numpy(rng.uniform(-2.5, 2.5, (B, M, 3))
                          .astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=(B, M)) < 0.85)
    thres = torch.tensor([1.0, 25.0, 10.0])
    stack = lambda vs: voxelmap.VoxelMap(torch.stack([v.cells for v in vs]))
    return stack(vms), stack(lvs), vms, lvs, pw, mask, thres


def _equal(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            if k != "gates":
                _equal(a[k], b[k], f"{what} {k}")
        return
    assert torch.equal(a, b) or (
        a.dtype.is_floating_point and torch.equal(torch.isnan(a),
                                                  torch.isnan(b))
        and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))), what


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("mode", [assoc.PLANE, assoc.LINE])
def test_k2_plain_lanes_bit_equal(dedup, mode):
    """K2's plain version over (B, M) queries and (B, Cs, row) maps, each
    lane's gate its own, against one call per lane: every stage fresh
    and cached, the rescue with its cap binding and not."""
    mcfg = dataclasses.replace(CFG.map, dense_bf16=False,
                               dedup_gather=dedup, dedup_capacity=2)
    lcfg = dataclasses.replace(CFG.local_map, dense_bf16=False,
                               dedup_gather=dedup, dedup_capacity=2)
    vm, vml, vms, lvs, pw, mask, thres = _lane_inputs(mcfg)
    k, sr = CFG.map.knn, 0.01 if mode == assoc.PLANE else 0.0
    moved = pw + 3e-3
    _, blocks = assoc.associate_reference(vm, pw, mask, mcfg, k, mode, thres,
                                          sr)
    for b in range(3):
        one = (vms[b], pw[b], mask[b], mcfg, k, mode, thres[b], sr)
        _, blk1 = assoc.associate_reference(*one)
        _equal({n: v[b] for n, v in blocks._asdict().items()},
               blk1._asdict(), f"lane {b} blocks")
    for stage in range(len(assoc.STAGE_NAMES)):
        for cached, q in ((None, pw), (blocks, moved)):
            if stage == assoc.GATHER and cached is not None:
                continue
            got = assoc.stage_reference(stage, vm, q, mask, mcfg, k, mode,
                                        thres, sr, cached)
            for b in range(3):
                c1 = None if cached is None else assoc.StackBlocks(
                    *(a[b] for a in cached))
                want = assoc.stage_reference(stage, vms[b], q[b], mask[b],
                                             mcfg, k, mode, thres[b], sr, c1)
                _equal({n: v[b] for n, v in got.items() if n != "gates"},
                       {n: v for n, v in want.items() if n != "gates"},
                       f"{assoc.STAGE_NAMES[stage]} cached={c1 is not None}"
                       f" lane {b}")
    M = pw.shape[1]
    for cap in (16, M):
        r, _ = assoc.associate_with_rescue_reference(
            vm, vml, pw, mask, mcfg, lcfg, k, mode, thres, sr, cap)
        rr = assoc.run_rescue(vm, vml, pw, mask, mcfg, lcfg, k, mode, thres,
                              sr, cap)
        for b in range(3):
            r1, _ = assoc.associate_with_rescue_reference(
                vms[b], lvs[b], pw[b], mask[b], mcfg, lcfg, k, mode,
                thres[b], sr, cap)
            _equal(tree_map(lambda a: a[b], dict(r._asdict())),
                   dict(r1._asdict()), f"rescue cap {cap} lane {b}")
            # the wrapper takes the lane axis: lane b alone as a batch of
            # one
            lane = slice(b, b + 1)
            rr1 = assoc.run_rescue(
                voxelmap.VoxelMap(vm.cells[lane]),
                voxelmap.VoxelMap(vml.cells[lane]), pw[lane], mask[lane],
                mcfg, lcfg, k, mode, thres[lane], sr, cap)
            _equal({n: v[lane] for n, v in rr.items()}, rr1,
                   f"run_rescue cap {cap} lane {b}")
        if cap < M:
            need = (mask & ~assoc.associate_reference(
                vm, pw, mask, mcfg, k, mode, thres, sr)[0].valid)
            assert bool((need.sum(dim=1) > cap).any()), "the cap binds"


def _syncs(fn):
    """(device reads `aten::_local_scalar_dense`, `aten::item` calls,
    `torch.linalg.eigh` calls) in fn(), from the profiler's raw events
    (each eigh reads one error flag)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    return (names.count("aten::_local_scalar_dense"),
            names.count("aten::item"), names.count("aten::_linalg_eigh"))


def test_step_core_batch_reads_no_device_value():
    """After a warm-up, one step_core_batch reads no device value but the
    named eigh checks (one each), and as many at B=3 as at B=1."""
    final, _, _ = _batch_run()
    _, scans = _lanes()
    sc = tree_map(lambda a: a[-1], tr.stack_sequences(scans))
    counts = {}
    for lanes in ((0, 1, 2), (2,)):
        st = tree_map(lambda a: a[list(lanes)].clone(), final)
        s = tree_map(lambda a: a[list(lanes)], sc)
        if len(lanes) == 3:
            tp.step_core_batch(st, s, CFG)             # warm-up
        counts[len(lanes)] = _syncs(lambda: tp.step_core_batch(st, s, CFG))
    for reads, items, eighs in counts.values():
        assert reads == items == eighs, counts
        assert eighs == 2          # the marginalization's two (full window)
    assert counts[3] == counts[1], counts
