"""The layer spans, the replay loop's clocks and the set-up's parts
(`mmloam_tpu_torch/spans.py`).

On the CPU:
* spans off, a step leaves no "mmloam.*" range for the profiler; on, each
  leaf layer's range appears on each eager step, association inside the
  estimator, fusion (twice a step) inside the front end and no other leaf
  inside another, lockstep and one lane;
* while a capture records, a span only notes where the capture stands:
  the fusion spans of a step add no range and no device work, nested in
  the front end's notes;
* `spans.fusion_counts()` after a replay call: its lane-scans, the sum of
  its `hori_merged`, and the downsampled points its stack caps kept (the
  sums of the stack masks the step built) and dropped (the frame's
  occupied voxels past the caps);
* the eager replay's outputs and final state are bit-equal with spans on
  and off, lockstep and one lane;
* each call notes its graph's launches of our kernels
  (`spans.call_launches()`), as its replays and the bodies that ran
  count them;
* `spans.node_layers` lays the notes a capture took on each graph's
  chain of nodes (a stand-in for libcuda's graph): the innermost span
  holds, a body's nodes take their IF node's layer, and what cannot be
  laid raises.

On the card (marked `cuda`; this file imports torch only, so it runs
with `--noconftest` there): the lockstep and one-lane graphs hold the same
nodes with spans on and off; every device operation has its place in
`node_layers` and K1-K4 sit in their layers (K4 not named there, as
torch's kernels are not); the set-up's parts; the
counters after a call; the loop's clocks.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from mmloam_tpu_torch import pipeline, replay, spans  # noqa: E402
from mmloam_tpu_torch.config import tiny_config  # noqa: E402
from mmloam_tpu_torch.data import synthetic  # noqa: E402
from mmloam_tpu_torch.ops import assoc, damped_solve, eigh  # noqa: E402
from mmloam_tpu_torch.ops import graph_kernels  # noqa: E402
from mmloam_tpu_torch.ops import map_insert  # noqa: E402
from mmloam_tpu_torch.tree import tree_map  # noqa: E402

CFG = tiny_config()
TOP = ("front_end", "estimator", "gravity", "init", "map_insert")
HOME = dict(k1="map_insert", k2="association", k3="estimator")


@pytest.fixture(autouse=True)
def _spans_off():
    yield
    spans.enable(False)


def _hall(T, device="cpu"):
    """T scans of the hall, the Horizon's among them (so the fusion span
    holds its feature pass)."""
    return replay.make_sequence(
        synthetic.default_world(), synthetic.Trajectory(speed=0.8, z_amp=0.15),
        0.0, T, CFG, n_az=360, dtype=np.float32, range_noise=0.003, seed=1,
        with_hori=True, hori_n_az=128, device=device)[0]


def _lanes(B, device="cpu", cfg=CFG):
    """B lanes of the hall (lane b's scans moved b cm), a lane axis."""
    scans = _hall(4, device)
    seqs = [scans._replace(pts=scans.pts + 0.01 * b) for b in range(B)]
    states = replay.stack_states([pipeline.init_state(cfg, device=device)
                                  for _ in range(B)])
    return states, replay.stack_sequences(seqs)


def _ranges(fn):
    """fn() under the profiler: its "mmloam.*" ranges as (start, end,
    leaf name), in start order."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = [(e.start_ns(), e.end_ns(), e.name()[len(spans.PREFIX):])
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(spans.PREFIX)]
    return sorted(out)


@pytest.mark.parametrize("one", [False, True])
def test_spans_mark_each_layer_of_each_eager_step(one):
    states, scans = _lanes(1 if one else 2)
    T = scans.pts.shape[0]
    run = lambda: replay._replay_eager(tree_map(torch.clone, states), scans,
                                       CFG, one=one)
    assert _ranges(run) == []
    spans.enable(True)
    got = _ranges(run)
    names = [n for _, _, n in got]
    for name in TOP:
        assert names.count(name) == T, (name, names.count(name))
    # one lane estimates only once the map holds data (scan 1 on)
    assert names.count("association") >= (T - 1 if one else T)
    # the Horizon's feature pass and its merge, each in the front end
    assert names.count("fusion") == 2 * T
    inside = dict(association=["estimator"], fusion=["front_end"])
    for s, e, n in got:
        holders = [m for s2, e2, m in got if (s2, e2) != (s, e)
                   and s2 <= s and e <= e2]
        assert holders == inside.get(n, []), (n, holders)


@pytest.mark.parametrize("one", [False, True])
def test_eager_replay_is_bit_equal_with_spans_on_and_off(one):
    states, scans = _lanes(1 if one else 2)
    got = []
    for on in (False, True):
        spans.enable(on)
        got.append(replay._replay_eager(tree_map(torch.clone, states), scans,
                                        CFG, one=one))
    (f_off, o_off), (f_on, o_on) = got
    for a, b in zip(replay._leaves(o_off) + replay._leaves(f_off),
                    replay._leaves(o_on) + replay._leaves(f_on)):
        assert torch.equal(a, b)


def _op_counts(fn):
    """fn(): how often each aten op ran."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts[str(func)] = counts.get(str(func), 0) + 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return counts


def test_fusion_span_only_notes_while_a_capture_records(monkeypatch):
    states, scans = _lanes(2)
    scan = tree_map(lambda a: a[0], scans)
    step = lambda: pipeline.step_core_batch(tree_map(torch.clone, states),
                                            scan, CFG)
    step()                      # fills the constant caches (`lie.const`)
    off = _op_counts(step)
    monkeypatch.setattr(spans, "_position", lambda name: (7, (), name))
    spans.enable(True)
    notes = []
    with spans.recording(notes):
        assert _ranges(step) == []
        on = _op_counts(step)
    assert on == off
    names = [n for _, _, n in notes]
    i = names.index("front_end")
    # the Horizon's feature pass and its merge, each back to the front end
    assert names[i:i + 6] == ["front_end", "fusion", "front_end", "fusion",
                              "front_end", None]


def test_fusion_counts_sum_the_calls_flags_and_stacks(monkeypatch):
    # caps that bind, and the merge gate lowered so the hall's Horizon
    # merges (as tests/test_torch_modes.py lowers it)
    cfg = CFG.replace(
        scan=dataclasses.replace(CFG.scan, max_corner=24, max_surf=96),
        solver=dataclasses.replace(CFG.solver, corner_cnt_gate_hori=5))
    built, real = [], pipeline._build_stacks

    def spy(flat_pts, flat_rel, flat_labels, flat_valid, cfg, dtype):
        out = real(flat_pts, flat_rel, flat_labels, flat_valid, cfg, dtype)
        built.append((flat_pts, flat_labels, flat_valid, out[0]))
        return out

    monkeypatch.setattr(pipeline, "_build_stacks", spy)
    states, scans = _lanes(2, cfg=cfg)
    _, outs = replay.replay_batch(states, scans, cfg)
    T, B = outs.hori_merged.shape
    assert len(built) == T
    want = dict(lane_scans=T * B, hori_merged=int(outs.hori_merged.sum()),
                corner_kept=0, corner_dropped=0, surf_kept=0,
                surf_dropped=0)
    for pts, labels, valid, stack in built:
        want["corner_kept"] += int(stack.corner_mask.sum())
        want["surf_kept"] += int(stack.surf_mask.sum())
        for b in range(B):
            for cls, label, leaf, cap in (
                    ("corner", 1, cfg.scan.filter_corner, cfg.scan.max_corner),
                    ("surf", 2, cfg.scan.filter_surf, cfg.scan.max_surf)):
                m = valid[b] & (labels[b] == label)
                vox = torch.floor(pts[b][m] / leaf).to(torch.int32)
                n = torch.unique(vox, dim=0).shape[0]
                want[cls + "_dropped"] += max(n - cap, 0)
    assert spans.fusion_counts() == want
    assert spans.fusion_counts() == want        # read once, kept
    assert want["hori_merged"] > 0
    assert want["corner_dropped"] > 0 and want["surf_dropped"] > 0


def test_each_call_notes_its_graph_launches():
    """`_ScanGraph.count`, once a call, notes the call's replays and the
    launches of our kernels by kernel: the graph's top level `times` over,
    each body as often as it ran; the last 8 calls are kept."""
    import types

    k3, k4 = ("k3", "default", False), ("k4", "default", False)
    k2r = ("k2", "regs8", True)
    runner = types.SimpleNamespace(launches={k4: 20, k3: 2, k2r: 1},
                                   body_launches=[{k4: 5}, {k3: 1}],
                                   tape=[])
    before = (eigh.LAUNCHES, damped_solve.LAUNCHES)
    try:
        replay._ScanGraph.count(runner, 3, [2, 0])
        assert spans.call_launches()[-1] == dict(scans=3, k1=0, k2=3, k3=6,
                                                 k4=70)
        assert (eigh.LAUNCHES - before[0],
                damped_solve.LAUNCHES - before[1]) == (6, 70)
        for t in range(10):
            replay._ScanGraph.count(runner, t, [0, 1])
        got = spans.call_launches()
        assert len(got) == 8
        assert got[-1] == dict(scans=9, k1=0, k2=9, k3=19, k4=180)
        assert [c["scans"] for c in got] == list(range(2, 10))
    finally:
        eigh.reset_counts()
        damped_solve.reset_counts()
        assoc.reset_counts()


def _fake_chains(monkeypatch, graphs):
    """graph_kernels.chain over {graph: [(node, type, name)]}."""
    monkeypatch.setattr(graph_kernels, "chain", lambda g: graphs[g])


def test_node_layers_lay_the_notes_on_each_chain(monkeypatch):
    k2 = "_ZN12_GLOBAL__N_112assoc_kernelILi4ELi8ELb1EEEv9AssocArgs"
    k1 = "_ZN12_GLOBAL__N_117map_insert_kernelILi32EEEvPfPKiPKxS3_PKfS7_S3_ixiff"
    _fake_chains(monkeypatch, {
        100: [(1, 0, "a"), (2, 1, None), (3, 0, "b"), (4, 13, None),
              (5, 5, None), (6, 0, "c"), (7, 13, None), (8, 0, k1)],
        200: [(11, 0, k2), (12, 13, None), (13, 2, None)],
        300: [(21, 0, "d")],
        400: [],
    })
    notes = [(100, (), "front_end"),         # before node 1
             (100, (2,), None),              # after the memcpy
             (100, (3,), "estimator"),       # the IF node is inside
             (200, (), "association"),       # body 0's own span
             (200, (11,), "estimator"),      # back out: body 1 inherits
             (100, (5,), None),
             (100, (7,), "init"), (100, (7,), "map_insert")]
    got = spans.node_layers([100, 200, 300, 400], [None, 0, None], notes)
    assert got == [
        [("kernel", "front_end", None), ("memcpy", "front_end", None),
         ("kernel", None, None), ("if", 0, None), ("kernel", None, None),
         ("if", 2, None), ("kernel", "map_insert", "k1")],
        [("kernel", "association", "k2"), ("if", 1, None),
         ("memset", "estimator", None)],
        [("kernel", "estimator", None)],
        [],
    ]


@pytest.mark.parametrize("graphs, notes, why", [
    ({1: [(5, 0, "a"), (6, 0, "b")]}, [(1, (5, 6), "init")], "after 2"),
    ({1: [(5, 0, "a")]}, [(1, (9,), "init")], "lacks"),
    ({1: [(5, 4, None)]}, [], "type 4"),
    ({1: [(5, 13, None), (6, 13, None)], 2: []}, [], "more IF nodes"),
    ({1: [(5, 0, "a")]}, [(None, (), "init")], "no capture position"),
])
def test_node_layers_refuse_what_they_cannot_lay(monkeypatch, graphs, notes,
                                                 why):
    _fake_chains(monkeypatch, graphs)
    with pytest.raises(ValueError, match=why):
        spans.node_layers(sorted(graphs), [None] * (len(graphs) - 1), notes)


# ---- on the card ----

def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _runner():
    (runner,) = replay._GRAPHS.values()
    return runner


def _graphs(runner):
    return [runner.graph.raw_cuda_graph()] + (
        [] if runner.bodies is None else list(runner.bodies.graphs))


def _nodes(runner):
    """(type, function name) of each node of each of the runner's graphs,
    in the order a replay runs them."""
    return [[(k, n) for _, k, n in graph_kernels.chain(g)]
            for g in _graphs(runner)]


def _call(one, dev):
    """A call of the entry on the tiny hall: (final, outputs, T)."""
    if one:
        scans = _hall(4, dev)
        final, outs = replay.replay(pipeline.init_state(CFG, device=dev),
                                    scans, CFG)
    else:
        states, scans = _lanes(2, dev)
        final, outs = replay.replay_batch(states, scans, CFG)
    torch.cuda.synchronize()
    return final, outs, scans.pts.shape[0]


def _counts():
    return (map_insert.LAUNCHES, assoc.LAUNCHES, assoc.RESCUE_LAUNCHES,
            assoc.CALLS, eigh.LAUNCHES, damped_solve.LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("one", [False, True])
def test_spans_leave_the_graph_node_for_node_on_card(one):
    dev = _device()
    spans.enable(False)
    replay.clear_graphs()
    _, off_outs, _ = _call(one, dev)
    off = _nodes(_runner())
    assert _runner().node_layers is None
    replay.clear_graphs()
    spans.enable(True)
    _, on_outs, _ = _call(one, dev)
    runner = _runner()
    assert _nodes(runner) == off
    for f in on_outs._fields:
        assert torch.equal(getattr(on_outs, f), getattr(off_outs, f)), f
    layers = runner.node_layers
    assert layers is not None, runner.node_layers_why
    assert len(layers) == len(off)
    for nodes, ops in zip(off, layers):
        kinds = {0: "kernel", 1: "memcpy", 2: "memset", 13: "if"}
        assert [kinds[k] for k, _ in nodes if k in kinds] == \
            [kind for kind, _, _ in ops]
        for (k, name), (kind, lay, ours) in zip(
                [x for x in nodes if x[0] in kinds], ops):
            key = graph_kernels.launch_key(name) if k == 0 else None
            kernel = key and key[0]
            # K4 is laid by its span alone, as torch's kernels are
            assert ours == (kernel if kernel in HOME else None)
            if kernel is not None:
                assert lay == dict(HOME, k4="estimator")[kernel], (kernel, lay)
    laid = {lay for ops in layers for kind, lay, _ in ops if kind != "if"}
    assert set(spans.LEAVES) <= laid
    assert sorted(i for ops in layers for kind, i, _ in ops
                  if kind == "if") == list(range(len(layers) - 1))
    replay.clear_graphs()


@pytest.mark.cuda
@pytest.mark.parametrize("one", [False, True])
def test_setup_parts_counters_and_clocks_on_card(one):
    import time

    dev = _device()
    replay.clear_graphs()
    t0 = time.perf_counter()
    _call(one, dev)
    wall = time.perf_counter() - t0
    runner = _runner()
    parts = spans.last_setup()
    assert parts == dict(eager_s=runner.eager_s, census_s=runner.census_s,
                         instantiate_s=runner.instantiate_s,
                         capture_s=runner.capture_s)
    assert min(parts.values()) > 0
    # capture plus instantiation; the census and scan 0 apart
    assert runner.capture_s > runner.instantiate_s
    assert runner.eager_s + runner.census_s + runner.capture_s < wall

    # a cached call adds each replay's launches once, after its last scan
    c0 = _counts()
    _, _, T = _call(one, dev)
    got = [b - a for a, b in zip(c0, _counts())]
    runs = ([0] * len(runner.body_launches)
            if runner.flag_history is None
            else runner.flag_history.sum(dim=0).tolist())
    want = dict(k1=0, k2=0, rescue=0, k3=0, k4=0)
    for keyed, n in [(runner.launches, T)] + list(zip(runner.body_launches,
                                                      runs)):
        for (kernel, _, rescue), c in keyed.items():
            want[kernel] += c * n
            want["rescue"] += c * n * rescue
    assert (got[0], got[1], got[2], got[4], got[5]) == (
        want["k1"], want["k2"], want["rescue"], want["k3"], want["k4"])
    assert spans.call_launches()[-1] == dict(
        scans=T, k1=want["k1"], k2=want["k2"], k3=want["k3"], k4=want["k4"])
    # the same as the loop op by op on the same inputs
    if one:
        states, scans = pipeline._lane(pipeline.init_state(CFG, device=dev)), \
            tree_map(lambda a: a[:, None], _hall(4, dev))
    else:
        states, scans = _lanes(2, dev)
    c1 = _counts()
    replay._replay_eager(states, scans, CFG, one=one)
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(c1, _counts())] == got

    # the loop's clocks: spans on only
    before = spans._LAST
    _call(one, dev)
    assert spans._LAST is before
    spans.enable(True)
    _call(one, dev)
    clocks = spans.last_call()
    assert clocks["replays"] == T and not clocks["traced"]
    assert clocks["host_s_per_scan"] > 0 and clocks["launch_s_per_scan"] > 0
    assert 0 < clocks["graph_busy_s"] <= clocks["replay_span_s"]
    replay.clear_graphs()
