"""The batch split of `replay.replay_batch(..., mesh=...)` on the CPU.

`mesh` is a list of devices, the counterpart of the reference's 1-D mesh
over the batch axis (`mmloam_tpu/replay.py:176-224`): each device owns
whole sequences.  Here every shard's device is the CPU, so the split runs
the same code as on a card, shards in turn in one worker; a mesh of two
distinct CPU device keys runs two workers at once.

* `stack_sequences` stacks as the reference's does.
* `replay_batch(mesh=["cpu", "cpu"])` at B=4 x 4 scans equals the unsplit
  `replay_batch` bit for bit, outputs and final states: lanes are
  independent, and each runs the same operations on the same device.
  Over two distinct device keys (`cpu`, `cpu:0`) two workers replay at
  once, with the same result and counters.
* A batch that does not split evenly raises, as the reference's sharding
  does.
* The split state's checkpoint (saved from its shards) restores onto one
  device as the unsplit state, bit for bit, and the restored state
  replays again, split (`tests/test_batch_replay.py:104-140`).
* The launch and call counters stay exact under many threads.
* One teacher-forced step at `tiny_config` with the map options a split
  deployment may run, `map` pack (2,2,2), `local_map` pack (1,1,1) and
  `dedup_gather` on both, against the reference's step
  (tests/torch_teacher.py's bounds; tests/test_torch_packs.py holds the
  map options piece by piece).
"""

import dataclasses
import sys
import threading

import numpy as np
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import pytest  # noqa: E402

from mmloam_tpu import replay as jr  # noqa: E402
from mmloam_tpu.config import tiny_config as jax_tiny_config  # noqa: E402
from mmloam_tpu.data import synthetic as jsyn  # noqa: E402

from mmloam_tpu_torch import checkpoint, pipeline, replay  # noqa: E402
from mmloam_tpu_torch.config import tiny_config  # noqa: E402
from mmloam_tpu_torch.data import synthetic as tsyn  # noqa: E402
from mmloam_tpu_torch.ops import assoc, map_insert  # noqa: E402
from mmloam_tpu_torch.tree import tree_map  # noqa: E402

import torch_teacher as tt  # noqa: E402

CFG = tiny_config()
JCFG = jax_tiny_config()
B, T = 4, 4


def _seqs(n_scans, B_=B, seed0=0):
    """Per-lane numpy sequences, as the reference's phase-1 dry run builds
    them (`__graft_entry__.phase1_inputs`)."""
    out = []
    for b in range(B_):
        traj = tsyn.Trajectory(speed=0.6 + 0.05 * b, yaw_rate=0.15 + 0.03 * b,
                               z_amp=0.1)
        scans, _, _ = replay.make_sequence(
            tsyn.default_world(), traj, 0.0, n_scans, CFG, n_az=360,
            seed=seed0 + b, dtype=np.float32)
        out.append(scans)
    return out


def _states(B_=B):
    return replay.stack_states([pipeline.init_state(CFG, device="cpu")
                                for _ in range(B_)])


def _leaves(tree):
    return [a for _, a in checkpoint._leaves_with_keys(tree)]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def _calls():
    return assoc.CALLS, assoc.LOCAL_CALLS


def _scans():
    return pipeline.scan_from_numpy(replay.stack_sequences(_seqs(T)),
                                    device="cpu")


@pytest.fixture(scope="module")
def runs():
    """The unsplit and the split replay of the same B=4 x T=4 inputs."""
    scans = _scans()
    st, outs = replay.replay_batch(_states(), scans, CFG)
    shards, souts = replay.replay_batch(_states(), scans, CFG,
                                        mesh=["cpu", torch.device("cpu")])
    return st, outs, shards, souts


def test_stack_sequences_matches_jax():
    seqs = _seqs(2, B_=3)
    jseqs = []
    for b in range(3):
        traj = jsyn.Trajectory(speed=0.6 + 0.05 * b, yaw_rate=0.15 + 0.03 * b,
                               z_amp=0.1)
        jseqs.append(jr.make_sequence(jsyn.default_world(), traj, 0.0, 2,
                                      JCFG, n_az=360, seed=b,
                                      dtype=np.float32, to_device=False)[0])
    got = replay.stack_sequences(seqs)
    want = jr.stack_sequences(jseqs)
    lg, lw = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(lg) == len(lw)
    for a, b in zip(lg, lw):
        assert a.shape[:2] == (2, 3)
        np.testing.assert_array_equal(a, np.asarray(b))
    # tensor leaves stack the same way
    tgot = replay.stack_sequences([pipeline.scan_from_numpy(s, device="cpu")
                                   for s in seqs])
    for a, b in zip(_leaves(tgot), lg):
        np.testing.assert_array_equal(a.numpy(), b.astype(a.numpy().dtype))


def test_split_replay_equals_unsplit(runs):
    st, outs, shards, souts = runs
    assert isinstance(shards, list) and len(shards) == 2
    assert all(s.x.shape[0] == B // 2 for s in shards)
    assert souts.pose_p.shape == (T, B, 3)
    for name in outs._fields:
        torch.testing.assert_close(getattr(souts, name), getattr(outs, name),
                                   rtol=0, atol=0, equal_nan=True,
                                   msg=name)
    _assert_trees_equal(replay.gather_states(shards), st)
    assert bool(torch.isfinite(souts.pose_p).all())
    assert bool((souts.n_surf > 0).all())
    assert bool((shards[1].vm_surf.cells[..., 96:] > 0).any())


def test_two_devices_replay_at_once(runs, monkeypatch):
    """Two distinct device keys (`cpu` and `cpu:0`) give two workers that
    replay at the same time: each shard waits at a barrier the other
    shard must reach, so shards run in turn would time out.  Outputs and
    final states equal the unsplit run's bit for bit, and the association
    counters, taken under the workers' threads, add up to an unsplit
    run's calls."""
    st, outs, _, _ = runs
    barrier = threading.Barrier(2, timeout=120)
    lockstep = replay._replay_lockstep

    def meet_then_replay(*args):
        barrier.wait()
        return lockstep(*args)

    monkeypatch.setattr(replay, "_replay_lockstep", meet_then_replay)
    scans = _scans()
    c0 = _calls()
    shards, souts = replay.replay_batch(
        _states(), scans, CFG, mesh=[torch.device("cpu"),
                                     torch.device("cpu", 0)])
    c1 = _calls()
    monkeypatch.undo()
    _replayed, _ = replay.replay_batch(_states(), scans, CFG)
    c2 = _calls()
    assert barrier.n_waiting == 0 and not barrier.broken
    for name in outs._fields:
        torch.testing.assert_close(getattr(souts, name), getattr(outs, name),
                                   rtol=0, atol=0, equal_nan=True,
                                   msg=name)
    _assert_trees_equal(replay.gather_states(shards), st)
    assert c1[0] - c0[0] == c2[0] - c1[0] > 0
    assert c1[1] - c0[1] == c2[1] - c1[1] > 0


def test_uneven_split_raises():
    scans = pipeline.scan_from_numpy(replay.stack_sequences(_seqs(1, B_=3)),
                                     device="cpu")
    with pytest.raises(ValueError, match="split evenly"):
        replay.replay_batch(_states(3), scans, CFG, mesh=["cpu", "cpu"])
    with pytest.raises(ValueError, match="split evenly"):
        replay.replay_batch(_states(3), scans, CFG, mesh=[])


def test_split_checkpoint_round_trip(runs, tmp_path):
    st, _, shards, _ = runs
    path = tmp_path / "split.npz"
    checkpoint.save(path, shards)
    restored = checkpoint.restore(path, _states())
    _assert_trees_equal(restored, st)
    # the restored state replays again, split; so do the shards themselves
    scans = pipeline.scan_from_numpy(
        replay.stack_sequences(_seqs(1, seed0=50)), device="cpu")
    again, outs = replay.replay_batch(restored, scans, CFG,
                                      mesh=["cpu", "cpu"])
    copies = [tree_map(torch.clone, sh) for sh in shards]
    _, outs2 = replay.replay_batch(copies, scans, CFG, mesh=["cpu", "cpu"])
    assert bool(torch.isfinite(outs.pose_p).all())
    torch.testing.assert_close(outs.pose_p, outs2.pose_p, rtol=0, atol=0)
    assert bool(outs.inited.all()) == bool(outs2.inited.all())


def test_counters_exact_under_threads():
    """The wrappers' counters are taken under a lock: 16 threads adding at
    a short switch interval lose no update."""
    n_threads, n_adds = 16, 2000
    before = (assoc.CALLS, assoc.LOCAL_CALLS)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def add():
            for _ in range(n_adds):
                assoc._count(CALLS=1, LOCAL_CALLS=1)
                map_insert._count_launch()

        threads = [threading.Thread(target=add) for _ in range(n_threads)]
        m0 = map_insert.LAUNCHES
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    total = n_threads * n_adds
    assert (assoc.CALLS, assoc.LOCAL_CALLS) == (before[0] + total,
                                                before[1] + total)
    assert map_insert.LAUNCHES == m0 + total


def test_teacher_forced_step_with_packs_and_dedup():
    """One step at tiny_config (scan 5, before IMU init) with `map` pack
    (2,2,2), `local_map` pack (1,1,1) and dedup_gather on both: every
    output, stack and map against the reference's step, at the default
    step's bounds."""
    jcfg = JCFG.replace(
        map=dataclasses.replace(JCFG.map, pack_x=2, pack_y=2, pack_z=2,
                                dedup_gather=True),
        local_map=dataclasses.replace(JCFG.local_map, pack_x=1, pack_y=1,
                                      pack_z=1, dedup_gather=True))
    cfg = CFG.replace(
        map=dataclasses.replace(CFG.map, pack_x=2, pack_y=2, pack_z=2,
                                dedup_gather=True),
        local_map=dataclasses.replace(CFG.local_map, pack_x=1, pack_y=1,
                                      pack_z=1, dedup_gather=True))
    rec, _, _ = tt.teacher_record(jcfg, 6, (5,))
    s1, out = tt.check_teacher_step(rec[5], False, cfg)
    assert s1.vm_surf.cells.shape[1] == 32
    assert s1.vm_local_surf.cells.shape[1] == 4
    assert int(out.n_assoc_plane) > 0
