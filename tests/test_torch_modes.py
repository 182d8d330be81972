"""The rig's modes `use_nonfeature` and `velo_only_mode` in the port against
the JAX reference (the IMU modes are in test_torch_imu_modes.py).

* `init_state` under `use_nonfeature` equals the reference leaf by leaf
  (the full `vm_non` map and the `non` stacks).
* One teacher-forced `step_core` (+ `apply_inserts`) from the reference's
  state before (scan 5) and after (scan 10) IMU init, on the hall with
  Horizon and 3 mm range noise, with `torch_teacher`'s bounds (those of
  test_torch_pipeline.py): discrete outputs exactly, poses within 1e-5 m,
  map sums within 1e-5 with meta lanes exact; under `use_nonfeature` also
  the `non` stacks, the pending `non` insert and `vm_non`.
* The port's `replay` over the same 11 scans against the reference's
  per-scan steps: inited, fail and hori_merged exactly, n_corner within 1
  and poses within REPLAY_POSE_ATOL (the bounds of the batch replay test
  in test_torch_pipeline.py, for the same reason: the curvature's fused
  rounding can move a feature pick).
* Under `use_nonfeature` the non-feature association is one association
  call with no local map (`assoc.LOCAL_CALLS` < `assoc.CALLS`), and the
  batched insert writes `vm_non` as the scatter insert does.
"""

import dataclasses
import functools

import numpy as np
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import pytest  # noqa: E402

from mmloam_tpu import pipeline as jp  # noqa: E402
from mmloam_tpu.config import tiny_config as jax_tiny_config  # noqa: E402

from mmloam_tpu_torch import pipeline as tp  # noqa: E402
from mmloam_tpu_torch import replay as tr  # noqa: E402
from mmloam_tpu_torch.config import tiny_config  # noqa: E402
from mmloam_tpu_torch.ops import assoc  # noqa: E402
from mmloam_tpu_torch.tree import tree_map  # noqa: E402

import torch_teacher as tt  # noqa: E402

# the synthetic hall yields few Horizon corners: the merge gate is lowered
# (as tests/test_hori_fusion.py does) so the fused path runs
_T = tiny_config()
_J = jax_tiny_config()
CFG_H = _T.replace(solver=dataclasses.replace(_T.solver,
                                              corner_cnt_gate_hori=5))
JCFG_H = _J.replace(solver=dataclasses.replace(_J.solver,
                                               corner_cnt_gate_hori=5))
MODES = {"use_nonfeature": dict(use_nonfeature=True),
         "velo_only_mode": dict(velo_only_mode=True)}
N_SCANS = 11
REPLAY_POSE_ATOL = 5e-3


def _cfgs(mode):
    return CFG_H.replace(**MODES[mode]), JCFG_H.replace(**MODES[mode])


@functools.lru_cache(maxsize=None)
def _record(mode):
    return tt.teacher_record(_cfgs(mode)[1], N_SCANS, (5, 10),
                             with_hori=True, hori_n_az=240)


def test_nonfeature_init_state_matches_jax():
    cfg, jcfg = _cfgs("use_nonfeature")
    sj = jax.tree.map(np.asarray, jp.init_state(jcfg))
    st = tp.init_state(cfg, device="cpu")
    assert st.vm_non.cells.shape == sj.vm_non.cells.shape
    assert st.stacks.non.shape == sj.stacks.non.shape
    la = jax.tree.leaves(sj)
    lb = jax.tree.leaves(tree_map(tt.np_, st))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape
        np.testing.assert_array_equal(y, x.astype(y.dtype))


@pytest.mark.parametrize("t", [5, 10])
@pytest.mark.parametrize("mode", list(MODES))
def test_teacher_forced_mode_step_matches_jax(mode, t):
    rec = _record(mode)[0][t]
    cfg = _cfgs(mode)[0]
    calls, local = assoc.CALLS, assoc.LOCAL_CALLS
    s1, out = tt.check_teacher_step(rec, t == 10, cfg)
    if mode == "use_nonfeature":
        # the non-feature stack is associated against vm_non alone
        assert assoc.CALLS - calls > assoc.LOCAL_CALLS - local > 0
        assert bool(rec["core"][2].non_mask.any())
    else:
        assert not bool(out.hori_merged)
        assert assoc.CALLS - calls == assoc.LOCAL_CALLS - local > 0


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_replay_matches_jax(mode):
    _, oj, (scans, _, _) = _record(mode)
    cfg = _cfgs(mode)[0]
    st, ot = tr.replay(tp.init_state(cfg, device="cpu"),
                       tp.scan_from_numpy(scans, device="cpu"), cfg)
    for name in ("inited", "fail", "hori_merged"):
        np.testing.assert_array_equal(tt.np_(getattr(ot, name)),
                                      getattr(oj, name), err_msg=name)
    assert np.abs(tt.np_(ot.n_corner) - oj.n_corner).max() <= 1
    pose = tt.np_(ot.pose_p)
    assert np.isfinite(pose).all()
    np.testing.assert_allclose(pose, oj.pose_p, atol=REPLAY_POSE_ATOL)
    assert bool(oj.inited[-1])
    if mode == "use_nonfeature":
        assert float(st.vm_non.count.sum()) >= 50
    else:
        assert not oj.hori_merged.any()
        assert float(st.vm_non.count.sum()) == 0


def test_nonfeature_batched_insert_writes_vm_non():
    """`apply_inserts_batched` (K1's plain version on CPU tensors) writes
    the third persistent map as the scatter `apply_inserts` does."""
    cfg = _cfgs("use_nonfeature")[0]
    rec = _record("use_nonfeature")[0][10]
    st = tp.state_from_numpy(rec["state"], device="cpu")
    s1, _, pend = tp.step_core(st, tp.scan_from_numpy(rec["scan"],
                                                      device="cpu"), cfg)
    want = tp.apply_inserts(s1, pend, cfg)
    batched = tree_map(lambda a: a[None].clone(), s1)
    got = tp.apply_inserts_batched(
        batched, tree_map(lambda a: a[None], pend), cfg)
    assert float(want.vm_non.count.sum()) > float(s1.vm_non.count.sum())
    for name in tp.MAP_FIELDS:
        tt.assert_maps(getattr(got, name).cells[0],
                       getattr(want, name).cells, name)
