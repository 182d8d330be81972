"""The host side of the replay's CUDA graph (`replay._ScanGraph`), on the
CPU: what the runner does around a capture and a replay that does not
need a card.  The graph itself runs on the card only
(tests/test_torch_cuda.py, chip_smoke.py phases 4 and 13).

* `_assign` copies a new state into the static buffers leaf by leaf and
  clones a leaf that shares memory with a buffer first, so a copy never
  reads a buffer another copy has written (two leaves swapped);
* the launch tape: while a thread captures, its count functions note
  their updates and count nothing, and another thread's counts are not
  noted; a runner's replays (the graph's launches, `graph_kernels.count`,
  and the noted call counts) leave the counters where the eager loop's
  launches put them;
* `graph_kernels.launch_key` keys our kernels (K1 to K4) by libcuda's
  mangled names and by the profiler's demangled ones, as the wrappers
  count them;
* the cache: one graph a device, a new key replaces it and frees the old
  one, the same key reuses it (with a stand-in for the capture, which
  needs the card), and the runner's outputs are the eager loop's;
* `_signature` keys the cache by structure, shape and dtype;
* CPU tensors take the eager loop and cache no graph;
* a failed capture names the package's frame of the first error;
* the LU the card factors in groups (so a batch over 16 captures) is
  `lu_factor_ex` of the whole batch bit for bit, failures included.
"""

import collections
import threading
import weakref

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from mmloam_tpu_torch import pipeline, replay  # noqa: E402
from mmloam_tpu_torch.config import tiny_config  # noqa: E402
from mmloam_tpu_torch.data import synthetic  # noqa: E402
from mmloam_tpu_torch.ops import assoc, eigh, graph_kernels  # noqa: E402
from mmloam_tpu_torch.ops import launch_tape, map_insert  # noqa: E402
from mmloam_tpu_torch.tree import tree_map  # noqa: E402


def test_assign_clones_buffers_a_copy_would_overwrite():
    a, b = torch.arange(4.0), torch.arange(4.0) + 10.0
    dst = dict(x=a, y=b, z=torch.zeros(2))
    want_x, want_y = b.clone(), a.clone()
    replay._assign(dst, dict(x=b, y=a, z=torch.ones(2)))
    assert torch.equal(dst["x"], want_x) and torch.equal(dst["y"], want_y)
    assert dst["x"] is a and dst["y"] is b          # the buffers stay
    assert torch.equal(dst["z"], torch.ones(2))
    # a view of a buffer (the step passed a slice on)
    c = torch.arange(6.0)
    dst = dict(p=c, q=torch.zeros(3))
    replay._assign(dst, dict(p=torch.zeros(6), q=c[3:]))
    assert torch.equal(dst["q"], torch.tensor([3.0, 4.0, 5.0]))
    assert torch.equal(dst["p"], torch.zeros(6))
    # a leaf that is its own buffer is left alone; None leaves stay None
    x = torch.ones(3)
    replay._assign(dict(x=x, n=None), dict(x=x, n=None))
    with pytest.raises(ValueError):
        replay._assign(dict(x=torch.zeros(3)), dict(x=torch.zeros(4)))
    with pytest.raises(ValueError):
        replay._assign(dict(x=torch.zeros(3)),
                       dict(x=torch.zeros(3, dtype=torch.float64)))


def _reset():
    map_insert.reset_counts()
    assoc.reset_counts()
    eigh.reset_counts()


def _counts():
    return (map_insert.LAUNCHES, dict(map_insert.INSTANCE_LAUNCHES),
            assoc.LAUNCHES, assoc.CALLS, assoc.RESCUE_LAUNCHES,
            dict(assoc.INSTANCE_LAUNCHES), eigh.LAUNCHES)


def test_launch_tape_records_its_thread_and_plays_back():
    """A capture notes its own thread's counts and counts nothing (another
    thread counting at the same time is neither noted nor held back); each
    replay then adds the graph's launches and plays the noted call counts:
    after a capture and three replays the counters read three scans'."""
    _reset()
    scan = [lambda: map_insert._count_launch("default"),
            lambda: assoc._count("staged", LAUNCHES=1, RESCUE_LAUNCHES=1),
            lambda: assoc._count(CALLS=1, LOCAL_CALLS=1),
            lambda: eigh._count(), lambda: eigh._count()]
    started, other_done = threading.Event(), threading.Event()

    def other():
        started.wait(timeout=30)
        for _ in range(5):
            map_insert._count_launch("rows")
        other_done.set()

    worker = threading.Thread(target=other)
    worker.start()
    tape = []
    with launch_tape.recording(tape):
        started.set()
        for fn in scan:
            fn()
        assert other_done.wait(timeout=30)
    worker.join(timeout=30)
    assert not worker.is_alive()
    assert len(tape) == len(scan)
    assert _counts() == (5, dict(default=0, groups=0, rows=5), 0, 0, 0,
                         dict.fromkeys(assoc.INSTANCES, 0), 0)
    launched = launch_tape.launches(tape)
    assert launched == collections.Counter({
        ("k1", "default", False): 1, ("k2", "staged", True): 1,
        ("k3", "default", False): 2})
    for _ in range(3):                  # what `_ScanGraph.count` adds
        graph_kernels.count(launched)
        launch_tape.play(tape)
    assert _counts() == (8, dict(default=3, groups=0, rows=5), 3, 3, 3,
                         dict(dict.fromkeys(assoc.INSTANCES, 0), staged=3),
                         6)
    assert assoc.LOCAL_CALLS == 3
    _reset()


@pytest.mark.parametrize("name, key", [
    ("_ZN12_GLOBAL__N_117map_insert_kernelILi32EEEvPfPKiPKxS3_PKfS7_S3_ixiff",
     ("k1", "default", False)),
    ("_ZN12_GLOBAL__N_117map_insert_kernelILin1EEEvPfPKiPKxS3_PKfS7_S3_ixiff",
     ("k1", "rows", False)),
    ("void (anonymous namespace)::map_insert_kernel<0>(float*, int const*)",
     ("k1", "rows", False)),
    ("_ZN12_GLOBAL__N_117map_insert_groupsEPfPKiPKxS2_PKfS6_S2_ixiff",
     ("k1", "groups", False)),
    ("_ZN12_GLOBAL__N_112assoc_kernelILi4ELi8ELb1EEEv9AssocArgs",
     ("k2", "default", False)),
    ("_ZN12_GLOBAL__N_112assoc_kernelILi6ELi16ELb0EEEv9AssocArgs",
     ("k2", "regs16", True)),
    ("void (anonymous namespace)::assoc_kernel<6, 8, true>(AssocArgs)",
     ("k2", "default", True)),
    ("void (anonymous namespace)::assoc_kernel<4, 0, false>(AssocArgs)",
     ("k2", "staged", False)),
    ("void (anonymous namespace)::assoc_kernel<4, 4, false>(AssocArgs)",
     ("k2", "regs4", False)),
    ("_ZN12_GLOBAL__N_111eigh_kernelEPKfPfS2_iiid",
     ("k3", "default", False)),
    ("_ZN12_GLOBAL__N_122lm_damped_solve_kernelEPKfS1_S1_S1_S1_Pfi",
     ("k4", "default", False)),
    ("(anonymous namespace)::lm_damped_solve_kernel(float const*, float "
     "const*, float const*, float const*, float const*, float*, int)",
     ("k4", "default", False)),
    ("void at::native::vectorized_elementwise_kernel<4, float>(int)", None),
])
def test_launch_key_reads_mangled_and_profiler_names(name, key):
    assert graph_kernels.launch_key(name) == key
    if key is not None:
        assert key[1] in {"k1": map_insert.INSTANCES, "k2": assoc.INSTANCES,
                          "k3": ("default",), "k4": ("default",)}[key[0]]


def test_cache_keeps_one_graph_a_device(monkeypatch):
    """`_replay_graph`'s cache and copies, on the CPU with a stand-in for
    the capture whose run is the eager step: the same key reuses the
    graph, another key (fewer lanes) replaces it and frees the old one,
    the caller's states are left as they were, and every output is the
    eager loop's."""
    made = []

    class Capture:
        flags = None                    # no IF nodes: the lockstep scan

        def __init__(self, key, state, scan, cfg, one=False):
            self.key, self.state, self.cfg = key, state, cfg
            self.lock = threading.Lock()
            made.append(weakref.ref(self))

        def run(self, scan, clock=None):
            new, out, pend = pipeline.step_core_batch(self.state, scan,
                                                      self.cfg)
            replay._assign(self.state, pipeline.apply_inserts_batched(
                new, pend, self.cfg))
            return out

        def count(self, times, runs=None):
            pass

    monkeypatch.setattr(replay, "_ScanGraph", Capture)
    cfg = tiny_config()
    seqs = [replay.make_sequence(
        synthetic.default_world(), synthetic.Trajectory(speed=0.8), t0, 2,
        cfg, n_az=360, dtype=np.float32, device="cpu")[0]
        for t0 in (0.0, 0.5)]
    sc = replay.stack_sequences(seqs)
    fresh = lambda B: replay.stack_states(
        [pipeline.init_state(cfg, device="cpu") for _ in range(B)])
    replay.clear_graphs()
    try:
        _, want = replay._replay_eager(fresh(2), sc, cfg)
        for n_made, B in ((1, 2), (1, 2), (2, 1)):
            given = fresh(B)
            before = tree_map(torch.clone, given)
            final, got = replay._replay_graph(
                given, tree_map(lambda a: a[:, :B], sc), cfg)
            assert len(made) == n_made and len(replay._GRAPHS) == 1
            (runner,) = replay._GRAPHS.values()
            assert runner is made[-1]()
            for a, b in zip(replay._leaves(given), replay._leaves(before)):
                assert torch.equal(a, b)
            assert final.vm_surf.cells is not runner.state.vm_surf.cells
            for f in got._fields:
                if getattr(got, f) is not None:
                    assert torch.equal(getattr(got, f),
                                       getattr(want, f)[:, :B]), f
            runner = None
        assert made[0]() is None        # the first key's graph was freed
    finally:
        replay.clear_graphs()


def test_signature_keys_structure_shape_and_dtype():
    a = dict(x=torch.zeros(2, 3), y=None)
    assert replay._signature(a) == replay._signature(
        dict(x=torch.ones(2, 3), y=None))
    for other in (dict(x=torch.zeros(3, 2), y=None),
                  dict(x=torch.zeros(2, 3, dtype=torch.float64), y=None),
                  dict(x=torch.zeros(2, 3), y=torch.zeros(1))):
        assert replay._signature(other) != replay._signature(a)


def test_cpu_replay_takes_the_eager_loop():
    cfg = tiny_config()
    scans, _, _ = replay.make_sequence(
        synthetic.default_world(), synthetic.Trajectory(speed=0.8), 0.0, 2,
        cfg, n_az=360, dtype=np.float32, device="cpu")
    replay.clear_graphs()
    st = replay.stack_states([pipeline.init_state(cfg, device="cpu")])
    sc = replay.stack_sequences([scans])
    final, outs = replay.replay_batch(st, sc, cfg)
    assert replay._GRAPHS == {}
    # the eager loop writes the given maps in place (documented)
    assert final.vm_surf.cells is st.vm_surf.cells
    assert outs.pose_p.shape == (2, 1, 3)
    _, eager = replay._replay_eager(
        replay.stack_states([pipeline.init_state(cfg, device="cpu")]), sc,
        cfg)
    for f in outs._fields:
        if getattr(outs, f) is not None:
            assert torch.equal(getattr(outs, f), getattr(eager, f)), f


def test_capture_site_names_the_innermost_frame_of_the_package():
    try:
        raise RuntimeError("outside the package")
    except RuntimeError as e:
        assert replay._capture_site(e) == "an unknown op"
    try:
        replay._assign(dict(x=torch.zeros(1)), dict(x=torch.zeros(2)))
    except ValueError as e:
        site = replay._capture_site(e)
    assert site.startswith("replay.py:") and "raise ValueError" in site
    # the first error of the chain names the op; ending the capture raises
    # a second one
    try:
        try:
            replay._assign(dict(x=torch.zeros(1)), dict(x=torch.zeros(2)))
        finally:
            raise RuntimeError("capture invalidated")
    except RuntimeError as e:
        assert replay._capture_site(e) == site


def test_lu_in_groups_equals_the_whole_batch():
    from mmloam_tpu_torch.ops import preintegration

    g = torch.Generator().manual_seed(3)
    A = torch.randn(2, 37, 18, 18, generator=g)
    A[1, 5] = 0.0                                   # a failed factorization
    whole = torch.linalg.lu_factor_ex(A)
    grouped = preintegration.lu_factor_groups(A)
    for a, b in zip(whole, grouped):
        assert a.shape == b.shape and torch.equal(a, b)
    assert grouped[2][1, 5] != 0
