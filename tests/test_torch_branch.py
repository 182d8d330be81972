"""The one-sequence step (`pipeline.step_core_one`, under `replay.replay`)
on the CPU: one branch of each of the reference's nine per-lane
conditionals, bit-equal to the lockstep step at one lane.

* One lane against lockstep: `replay.replay` and the lockstep loop at one
  lane (`replay._replay_eager`) agree bit for bit in every output and
  every leaf of the final state, maps included, on the hall at the
  default config, at `faithful_config()`, at `imu_mode` 0, and on a
  corridor whose solves gate degenerate.
* Branches taken: counters put in by monkeypatch show that the one-lane
  replay runs what the reference's unbatched step runs: no estimate while
  the map is empty, no init bookkeeping or attempt once initialized,
  `refine_gravity` exactly where its predicate holds, and exactly the
  LM iterations each solve reports.
* The host side of the capture, with a stub for the IF nodes (the graph
  itself runs on the card: tests/test_torch_cuda.py, chip_smoke.py phases
  1c and 15): the bodies' nesting, predicates and buffers, which body
  each kernel the step launches sits in, and the count arithmetic.
* The lockstep step's init gates (`branch.any_lane`): under a stub capture
  the bookkeeping sits in one body and the init solve in a body inside
  it, with none of our kernels in either, and with every lane inited the
  captured step is the step op by op bit for bit; op by op the step
  still runs the init attempt every scan; the replay loop adds the gate
  counts (`spans.gate_counts`) from each replay's predicates.
* K3's algorithm through a replay: the tiny hall replay with the
  marginalization's eigen-decompositions through `eigh.jacobi_reference`
  against tests/golden/hall_25.npz (ROADMAP queue 3).
"""

import collections
import contextlib
import functools
import os
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from mmloam_tpu_torch import branch, pipeline, replay, spans  # noqa: E402
from mmloam_tpu_torch.config import faithful_config  # noqa: E402
from mmloam_tpu_torch.config import tiny_config  # noqa: E402
from mmloam_tpu_torch.data import synthetic  # noqa: E402
from mmloam_tpu_torch.estimator import estimate as est  # noqa: E402
from mmloam_tpu_torch.estimator import initializer, solver  # noqa: E402
from mmloam_tpu_torch.ops import assoc, eigh  # noqa: E402
from mmloam_tpu_torch.ops import launch_tape, map_insert  # noqa: E402
from mmloam_tpu_torch.tree import tree_map  # noqa: E402

CFG = tiny_config()
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "hall_25.npz")
GOLDEN_POSE_ATOL = 0.01     # tests/test_torch_pipeline.py's bound (queue 3)


class _Straight(synthetic.Trajectory):
    """Constant-velocity motion along the corridor's axis (the reference's
    tests/test_degenerate.py)."""

    def pos(self, t):
        t = np.asarray(t, np.float64)
        return np.stack([t, np.zeros_like(t), np.zeros_like(t)], axis=-1)

    def vel(self, t):
        t = np.asarray(t, np.float64)
        return np.stack([np.ones_like(t), np.zeros_like(t),
                         np.zeros_like(t)], axis=-1)

    def acc(self, t):
        return np.zeros(np.shape(np.asarray(t)) + (3,))

    def yaw(self, t):
        return np.zeros(np.shape(np.asarray(t)))

    def yaw_dot(self, t):
        return np.zeros(np.shape(np.asarray(t)))


def _hall(cfg, T):
    return replay.make_sequence(
        synthetic.default_world(), synthetic.Trajectory(speed=0.8, z_amp=0.15),
        0.0, T, cfg, n_az=360, dtype=np.float32, range_noise=0.003, seed=1)


def _corridor(cfg, T):
    world = synthetic.BoxWorld(room_min=(-100.0, -2.0, -1.3),
                               room_max=(100.0, 2.0, 1.7))
    return replay.make_sequence(world, _Straight(), 0.0, T, cfg, n_az=360,
                                dtype=np.float32)


# name -> (config, scene, scans): the default hall runs past a gravity
# refinement (scan 19), the others past initialization (scan 8)
CASES = {
    "hall": (CFG, _hall, 22),
    "hall-faithful": (faithful_config(CFG), _hall, 11),
    "hall-imu0": (CFG.replace(imu_mode=0), _hall, 12),
    "corridor": (CFG, _corridor, 12),
}


class _Spy:
    """Calls of the step's branch functions in a one-lane replay, by
    scan: each wraps the function and notes the scan it ran in."""

    def __init__(self):
        self.scan = -1
        self.calls = collections.defaultdict(list)
        self.before = []        # (inited, frames, map_has_data) per scan
        self.iters = []         # each LM solve's iterations
        self.damped = 0         # LM iterations run (one damped solve each)

    def wrap(self, name, fn):
        @functools.wraps(fn)
        def spied(*a, **k):
            self.calls[name].append(self.scan)
            return fn(*a, **k)
        return spied


@functools.lru_cache(maxsize=None)
def _runs(name):
    """(one-lane replay, lockstep loop at one lane, spy of the one-lane
    run): each a (final state, outputs (T, ...)) without the lane axis."""
    cfg, scene, T = CASES[name]
    scans = pipeline.scan_from_numpy(scene(cfg, T)[0], device="cpu")
    spy = _Spy()
    step_one = pipeline.step_core_one

    def step(state, scan, cfg):
        spy.scan += 1
        spy.before.append((bool(state.inited), int(state.frame_valid.sum()),
                           bool(state.map_has_data)))
        return step_one(state, scan, cfg)

    lm = solver.lm_solve
    damped = solver._damped_solve

    def lm_spy(*a, **k):
        res = lm(*a, **k)
        spy.iters.append(int(res.iters))
        return res

    def damped_spy(*a, **k):
        spy.damped += 1
        return damped(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "step_core_one", step)
        mp.setattr(est, "estimate", spy.wrap("estimate", est.estimate))
        mp.setattr(pipeline, "_init_bookkeeping",
                   spy.wrap("bookkeeping", pipeline._init_bookkeeping))
        mp.setattr(pipeline, "_try_init",
                   spy.wrap("try_init", pipeline._try_init))
        mp.setattr(initializer, "refine_gravity",
                   spy.wrap("refine", initializer.refine_gravity))
        mp.setattr(solver, "lm_solve", lm_spy)
        mp.setattr(solver, "_damped_solve", damped_spy)
        one = replay.replay(pipeline.init_state(cfg, device="cpu"), scans,
                            cfg)
    lock = replay._replay_eager(
        pipeline._lane(pipeline.init_state(cfg, device="cpu")),
        tree_map(lambda a: a[:, None], scans), cfg)
    lock = (pipeline._unlane(lock[0]), tree_map(lambda a: a[:, 0], lock[1]))
    return one, lock, spy


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_lane_replay_is_the_lockstep_replay_bit_for_bit(name):
    (f1, o1), (f2, o2), _ = _runs(name)
    for f in o1._fields:
        if getattr(o1, f) is not None:
            assert torch.equal(getattr(o1, f), getattr(o2, f)), f
    leaves1, leaves2 = replay._leaves(f1), replay._leaves(f2)
    assert len(leaves1) == len(leaves2)
    for i, (a, b) in enumerate(zip(leaves1, leaves2)):
        assert a.dtype == b.dtype and torch.equal(a, b), i
        # laid out as the graph's static buffers hold the state
        assert replay._dense(a) is a, (i, a.stride())
    cfg = CASES[name][0]
    if cfg.imu_mode > 1:
        assert bool(o1.inited[-1]), "the replay never initialized"
    if name == "corridor":
        ran = o1.sv_min > 0
        assert bool((o1.degenerate & ran).any()), "no degenerate solve"


@pytest.mark.parametrize("name", ["hall", "corridor"])
def test_one_lane_replay_takes_the_references_branches(name):
    """No estimate while the map is empty (scan 0); the keyframe
    bookkeeping only before initialization and the init solve only at
    its attempts; `refine_gravity` exactly where do_refine holds (one
    scan in gravity_refine_every, on a full, initialized window whose
    solve passed); exactly the LM iterations each solve reports."""
    cfg, _, T = CASES[name]
    (_, outs), _, spy = _runs(name)
    W = cfg.solver.window
    inited = [b[0] for b in spy.before]
    frames = [b[1] for b in spy.before]
    has_map = [b[2] for b in spy.before]
    assert not has_map[0] and all(has_map[1:])
    assert spy.calls["estimate"] == [t for t in range(T) if has_map[t]]
    assert spy.calls["bookkeeping"] == [t for t in range(T)
                                        if not inited[t]]
    t_init = int(np.argmax(outs.inited.numpy()))
    assert outs.inited[t_init] and not inited[t_init]
    assert spy.calls["try_init"] and spy.calls["try_init"][-1] == t_init
    # an attempt every KF_EVERY scans once N_KF keyframes are open
    assert all(t % pipeline.KF_EVERY == pipeline.KF_EVERY - 1
               and t >= pipeline.KF_EVERY * pipeline.N_KF - 1
               for t in spy.calls["try_init"])
    # the window after the push: full once initialized and W frames in
    fail = outs.fail.numpy()
    refine = [t for t in range(T)
              if inited[t] and min(frames[t] + 1, W) == W and has_map[t]
              and not fail[t]
              and (t + 1) % cfg.solver.gravity_refine_every == 0]
    assert spy.calls["refine"] == refine
    if name == "hall":
        assert refine, "the hall run reached no refinement"
    # two solves an estimate; an iteration is one damped solve
    assert len(spy.iters) == 2 * len(spy.calls["estimate"])
    assert spy.damped == sum(spy.iters)
    cap = max(cfg.solver.max_inner_iters, cfg.solver.max_inner_iters_later)
    assert spy.damped < len(spy.iters) * cap


class _StubBodies(branch.Bodies):
    """`Bodies` with a stand-in for the IF node: the body's ops run as
    they are issued (both branches run), and its graph is a number."""

    @contextlib.contextmanager
    def _captured(self, flag, i):
        self.graphs[i] = 1000 + i
        yield


def test_cond_and_loop_under_a_stub_capture():
    """Two-way cond: two bodies, on pred and ~pred, one set of fresh
    buffers; identity cond: the leaves the branch passed on are the
    operand's own, the others buffers; a loop: one body an iteration,
    each on its own live predicate; nested bodies record their parent,
    and a note made in a body carries its index."""
    bodies = _StubBodies("cpu")
    x = torch.arange(3.0)
    keep = torch.ones(2)
    p = torch.tensor([True])
    tape = []
    with launch_tape.recording(tape), branch.recording(bodies):
        out = branch.cond(p, lambda o: (o[0] * 2, o[1]),
                          lambda o: (o[0] - 1, o[1]), (x, keep))
        same = branch.cond(p, lambda o: (o[0] + 1, o[1]), None, (x, keep))

        def taken(v):
            assoc._count(CALLS=1)                   # noted in this body
            return branch.cond(~p, lambda a: a * 3, None, v)
        nested = branch.cond(p, taken, None, x)
        n = torch.tensor([2], dtype=torch.int32)
        carry = branch.loop(3, lambda it, c: it < n,
                            lambda it, live, c: (c[0] + live.float(),),
                            (torch.zeros(1),))
    assert len(bodies) == 4 + 4 + 3
    # two-way: both bodies ran under the stub, the second wrote last
    assert out[1] is not keep and torch.equal(out[0], x - 1)
    assert same[1] is keep and same[0] is not x
    assert bodies.parents == [None] * 4 + [None, 4, 4, None] + [None] * 3
    flags = bodies.flags[:len(bodies)].tolist()
    assert flags[:8] == [True, False, True, False, True, False, True, False]
    assert flags[8:] == [True, True, False]        # it < 2 at it = 0, 1, 2
    assert torch.equal(carry[0], torch.tensor([2.0]))
    assert [b for _, _, b in tape] == [4]
    assert torch.equal(nested, x)                   # the copy body wrote x
    with pytest.raises(ValueError):
        with branch.recording(_StubBodies("cpu")):
            branch.cond(p, lambda o: o.double(), None, x)


def test_without_a_capture_cond_and_loop_take_one_branch():
    ran = []
    t, f = torch.tensor([True]), torch.tensor([False])
    assert branch.cond(t, lambda o: ran.append("t") or o + 1,
                       lambda o: ran.append("f") or o - 1,
                       torch.zeros(1)).item() == 1.0
    assert branch.cond(f, None, lambda o: ran.append("g") or o,
                       torch.zeros(1)).item() == 0.0
    assert ran == ["t", "g"]
    its = []
    out = branch.loop(5, lambda it, c: c < 3,
                      lambda it, live, c: its.append(it) or c + 1,
                      torch.tensor([0]))
    assert its == [0, 1, 2] and out.item() == 3


def _post_init_state():
    """The hall replay's state after scan 9 and its scan 10, lane axis
    of one."""
    scans = pipeline.scan_from_numpy(_hall(CFG, 11)[0], device="cpu")
    st, _ = replay._replay_eager(
        pipeline._lane(pipeline.init_state(CFG, device="cpu")),
        tree_map(lambda a: a[:10, None], scans), CFG, one=True)
    assert bool(st.inited)
    return st, tree_map(lambda a: a[10:11], scans)


def _noting_kernels(monkeypatch):
    """Note K1's, K2's and K3's launches as their wrappers note them on
    the card (one K2 launch a call, one more a rescue)."""
    real = assoc._count

    def k2_noting(*deltas, **kw):
        real(*deltas, **kw)
        if kw.get("CALLS"):
            real("default", LAUNCHES=1)
            if kw.get("LOCAL_CALLS"):
                real("default", LAUNCHES=1, RESCUE_LAUNCHES=1)

    monkeypatch.setattr(assoc, "_count", k2_noting)
    solve = eigh.eigh
    monkeypatch.setattr(eigh, "eigh",
                        lambda A: (eigh._count(), solve(A))[1])
    insert = map_insert.insert_batched

    def k1_noting(*a, **k):
        map_insert._count_launch("default")
        return insert(*a, **k)
    monkeypatch.setattr(map_insert, "insert_batched", k1_noting)


def test_step_under_a_stub_capture_puts_each_kernel_in_its_body(monkeypatch):
    """The one-lane step captured with stub IF nodes, with the kernels'
    launches noted as their wrappers note them on the card: K1's four at
    the top level, K2's (one per association call, one more per rescue)
    and K3's two in the estimate's body or the bodies it holds (the
    re-association), nothing else in any body, and the bodies nest as
    the reference's conditionals do."""
    state, scan = _post_init_state()
    _noting_kernels(monkeypatch)
    bodies, tape = _StubBodies("cpu"), []
    with launch_tape.recording(tape), branch.recording(bodies):
        bodies.flags.zero_()
        new, _, pend = pipeline.step_core_one(state, scan, CFG)
        pipeline.apply_inserts_batched(new, pend, CFG)
    top = launch_tape.launches(tape)
    assert top == collections.Counter({("k1", "default", False): 4})
    est_body = 0                                # the first cond's body
    assert bodies.parents[est_body] is None

    def inside_estimate(i):
        while i is not None and i != est_body:
            i = bodies.parents[i]
        return i == est_body

    by_body = collections.Counter()
    for launch, _, b in tape:
        if launch is not None and b is not None:
            assert inside_estimate(b), (launch, b)
            by_body[launch[0]] += 1
    k3 = launch_tape.launches(tape, body=est_body)[("k3", "default", False)]
    assert k3 == 2 and by_body["k3"] == 2
    calls = sum(1 for launch, _, b in tape if launch is None)
    assert by_body["k2"] == 2 * calls > 0
    reassoc = {b for launch, _, b in tape
               if launch is not None and launch[0] == "k2" and b != est_body}
    assert reassoc and all(bodies.parents[b] == est_body for b in reassoc)
    # estimate (2) > two LM solves (skip cond 2 + 10 iterations each) and
    # a re-association (2); refinement (2); bookkeeping (2) > keyframe
    # slot (2), attempt (2) > seeding (2)
    assert len(bodies) == 38
    assert sorted(graph for graph in bodies.graphs) == [
        1000 + i for i in range(38)]


@functools.lru_cache(maxsize=None)
def _post_init_lanes():
    """Two hall lanes (lane 1's points moved 1 cm) after scan 9 of a
    lockstep replay, both inited, and their scans (13, 2, ...)."""
    scans = pipeline.scan_from_numpy(_hall(CFG, 13)[0], device="cpu")
    lanes = replay.stack_sequences([scans, scans._replace(
        pts=scans.pts + 0.01)])
    st, _ = replay._replay_eager(
        replay.stack_states([pipeline.init_state(CFG, device="cpu")
                             for _ in range(2)]),
        tree_map(lambda a: a[:10], lanes), CFG)
    assert bool(st.inited.all())
    return st, lanes


@pytest.mark.parametrize("lanes", ["inited", "one_fresh"])
def test_lockstep_step_under_a_stub_capture_gates_init_in_two_bodies(
        monkeypatch, lanes):
    """The lockstep step captured with stub IF nodes: two gates, the
    bookkeeping ("init", on some lane un-inited) and inside its body the
    init solve ("init_solve", on some lane attempting), each beside its
    identity body; K1, K2 and K3 launch at the top level only.  Both
    lanes inited: neither gate's predicate holds; lane 1 fresh: the
    bookkeeping's does (one lane of two), the solve's not (no lane at an
    attempt)."""
    state, scans = _post_init_lanes()
    state = tree_map(torch.clone, state)        # the inserts write maps
    if lanes == "one_fresh":
        fresh = pipeline.init_state(CFG, device="cpu")
        state = tree_map(lambda a, f: torch.stack([a[0], f]), state, fresh)
    scan = tree_map(lambda a: a[10], scans)
    _noting_kernels(monkeypatch)
    bodies, tape = _StubBodies("cpu"), []
    with launch_tape.recording(tape), branch.recording(bodies):
        bodies.flags.zero_()
        new, _, pend = pipeline.step_core_batch(state, scan, CFG)
        pipeline.apply_inserts_batched(new, pend, CFG)
    # the bookkeeping, inside it the solve and its identity, then the
    # bookkeeping's identity
    assert bodies.names == ["init", "init_solve", None, None]
    assert bodies.parents == [None, 0, 0, None]
    # no launch and no counter update noted in either body
    assert tape and all(b is None for _, _, b in tape)
    top = launch_tape.launches(tape)
    assert top[("k1", "default", False)] == 4
    assert top[("k3", "default", False)] == 2
    book = lanes == "one_fresh"
    flags = bodies.flags[:len(bodies)].tolist()
    assert flags == [book, False, True, not book]


def test_lockstep_step_under_a_stub_capture_is_the_step_when_all_inited():
    """With every lane inited, the lockstep step captured with stub IF
    nodes (each gate's identity body writes last, as a replay where no
    lane needs the gate leaves it) is `step_core_batch` op by op, bit for
    bit in the state, the outputs and the pending inserts."""
    state, lanes = _post_init_lanes()
    scan = tree_map(lambda a: a[10], lanes)
    want = pipeline.step_core_batch(state, scan, CFG)
    with branch.recording(_StubBodies("cpu")) as bodies:
        bodies.flags.zero_()
        got = pipeline.step_core_batch(state, scan, CFG)
    assert len(bodies) == 4
    got, want = replay._leaves(got), replay._leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_lockstep_step_op_by_op_attempts_init_every_scan(monkeypatch):
    """Outside a capture the lockstep step runs the bookkeeping and the
    init attempt for every lane every scan, inited or not, and selects,
    as before the gates."""
    calls = []
    attempt = pipeline._try_init

    def counted(*a, **k):
        calls.append(a[0].x.shape[0])
        return attempt(*a, **k)

    monkeypatch.setattr(pipeline, "_try_init", counted)
    state, lanes = _post_init_lanes()
    replay._replay_eager(tree_map(torch.clone, state),
                         tree_map(lambda a: a[10:13], lanes), CFG)
    assert calls == [2, 2, 2]
    fresh = replay.stack_states([pipeline.init_state(CFG, device="cpu")
                                 for _ in range(2)])
    pipeline.step_core_batch(fresh, tree_map(lambda a: a[0], lanes), CFG)
    assert calls == [2, 2, 2, 2]


def _reset():
    map_insert.reset_counts()
    assoc.reset_counts()
    eigh.reset_counts()


def test_body_launches_count_as_often_as_their_bodies_ran():
    """`_ScanGraph`'s count arithmetic, without a card: `count(T, runs)`,
    once a call, adds the top level's launches and call counts T times
    and body i's `runs[i]` times.  With K2's launches noted beside their
    calls, LAUNCHES == CALLS + RESCUE_LAUNCHES holds whatever ran."""
    _reset()
    tape = []
    with launch_tape.recording(tape):
        map_insert._count_launch("default")
        with launch_tape.body(0):
            assoc._count(CALLS=1, LOCAL_CALLS=1)
            assoc._count("default", LAUNCHES=1)
            assoc._count("default", LAUNCHES=1, RESCUE_LAUNCHES=1)
            eigh._count()
            with launch_tape.body(1):
                assoc._count(CALLS=1, LOCAL_CALLS=1)
                assoc._count("default", LAUNCHES=1)
                assoc._count("default", LAUNCHES=1, RESCUE_LAUNCHES=1)
    assert (map_insert.LAUNCHES, assoc.LAUNCHES, assoc.CALLS) == (0, 0, 0)
    runner = object.__new__(replay._ScanGraph)
    runner.tape = tape
    runner.launches = launch_tape.launches(tape)
    runner.body_launches = [launch_tape.launches(tape, body=i)
                            for i in range(2)]
    assert runner.launches == collections.Counter(
        {("k1", "default", False): 1})
    assert runner.body_launches[1] == collections.Counter(
        {("k2", "default", False): 1, ("k2", "default", True): 1})
    T, runs = 5, [4, 1]
    runner.count(T, runs)
    assert map_insert.LAUNCHES == T
    assert assoc.CALLS == assoc.LOCAL_CALLS == runs[0] + runs[1]
    assert assoc.LAUNCHES == assoc.CALLS + assoc.RESCUE_LAUNCHES == 10
    assert eigh.LAUNCHES == runs[0]
    _reset()


def test_replay_graph_counts_bodies_from_the_predicates_each_replay_left(
        monkeypatch):
    """`_replay_graph` copies each replay's IF-node flags out beside the
    step outputs and, after the last scan, hands the call's replays and
    the flags' sums to `count` once (a stand-in for the capture: scan t
    sets body 0's flag where t is even, body 1's where t > 2)."""
    seen = []

    class Capture:
        def __init__(self, key, state, scan, cfg, one=False):
            assert one
            self.key, self.state, self.cfg = key, state, cfg
            self.lock = threading.Lock()
            self.flags = torch.zeros(2, dtype=torch.bool)
            self.t = 0

        def run(self, scan, clock=None):
            self.t += 1
            self.flags.copy_(torch.tensor([self.t % 2 == 0, self.t > 2]))
            new, out, pend = pipeline.step_core_one(self.state, scan,
                                                    self.cfg)
            replay._assign(self.state, pipeline.apply_inserts_batched(
                new, pend, self.cfg))
            return out

        def count(self, times, runs=None):
            seen.append((times, runs))

    monkeypatch.setattr(replay, "_ScanGraph", Capture)
    scans = pipeline.scan_from_numpy(_hall(CFG, 4)[0], device="cpu")
    replay.clear_graphs()
    try:
        lane = pipeline._lane(pipeline.init_state(CFG, device="cpu"))
        sc = tree_map(lambda a: a[:, None], scans)
        _, want = replay._replay_eager(
            pipeline._lane(pipeline.init_state(CFG, device="cpu")), sc, CFG,
            one=True)
        for call in range(2):
            _, got = replay._replay_graph(lane, sc, CFG, one=True)
            for f in got._fields:
                assert torch.equal(getattr(got, f), getattr(want, f)), f
        (runner,) = replay._GRAPHS.values()
        # the first call runs scan 0 eagerly (lockstep) and replays 1-3
        # (the stand-in's replays 1-3), the second replays all four (its
        # replays 4-7)
        assert seen == [(3, [1, 1]), (4, [2, 4])]
        assert runner.key[1] is True
    finally:
        replay.clear_graphs()


def test_lockstep_replay_graph_adds_the_gate_counts_each_replay_left(
        monkeypatch):
    """`_replay_graph` on the lockstep step adds, once a call, its
    replays and the replays in which each gate's body ran to
    `spans.gate_counts()`, from the predicates each replay left (a
    stand-in for the capture: four IF nodes, "init" at 0 and
    "init_solve" at 2; scan t takes the bookkeeping where t < 3 and the
    solve where t == 2)."""
    seen = []

    class Capture:
        def __init__(self, key, state, scan, cfg, one=False):
            assert not one
            self.key, self.state, self.cfg = key, state, cfg
            self.lock = threading.Lock()
            self.flags = torch.zeros(4, dtype=torch.bool)
            self.gates = {"init": 0, "init_solve": 2}
            self.t = 0

        def run(self, scan, clock=None):
            t = self.t % 4
            self.t += 1
            self.flags.copy_(torch.tensor([t < 3, t >= 3, t == 2, t < 2]))
            new, out, pend = pipeline.step_core_batch(self.state, scan,
                                                      self.cfg)
            replay._assign(self.state, pipeline.apply_inserts_batched(
                new, pend, self.cfg))
            return out

        def count(self, times, runs=None):
            seen.append((times, runs))

    monkeypatch.setattr(replay, "_ScanGraph", Capture)
    monkeypatch.setattr(spans, "_GATES", None)
    scans = pipeline.scan_from_numpy(_hall(CFG, 4)[0], device="cpu")
    sc = replay.stack_sequences([scans, scans._replace(pts=scans.pts
                                                       + 0.01)])
    fresh = lambda: replay.stack_states(
        [pipeline.init_state(CFG, device="cpu") for _ in range(2)])
    replay.clear_graphs()
    try:
        assert spans.gate_counts() is None
        _, want = replay._replay_eager(fresh(), sc, CFG)
        # the first call runs scan 0 eagerly and replays 1-3 (the
        # stand-in's t = 0, 1, 2), the second replays all four (t = 0-3)
        _, got = replay._replay_graph(fresh(), sc, CFG)
        assert seen == [(3, [3, 0, 1, 2])]
        assert spans.gate_counts() == dict(scans=3, init=3, init_solve=1)
        _, got = replay._replay_graph(fresh(), sc, CFG)
        for f in got._fields:
            if getattr(got, f) is not None:
                assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert seen[1] == (4, [3, 1, 1, 2])
        assert spans.gate_counts() == dict(scans=7, init=6, init_solve=2)
    finally:
        replay.clear_graphs()


def test_hall_replay_through_jacobi_matches_golden(monkeypatch):
    """ROADMAP queue 3: the marginalization's two eigen-decompositions
    through K3's algorithm (`eigh.jacobi_reference`, the kernel's rotations
    in its order) in the tiny hall_25 replay, against the JAX package's
    golden: inited, fail and t exact, poses within the 0.01 m bound."""
    calls = []

    def jacobi(A):
        calls.append(A.shape)
        return eigh.jacobi_reference(A)

    monkeypatch.setattr(eigh, "eigh", jacobi)
    scans, gt_R, gt_p = replay.make_sequence(
        synthetic.default_world(), synthetic.Trajectory(speed=0.8, z_amp=0.15),
        0.0, 25, CFG, n_az=360, dtype=np.float32)
    g = np.load(GOLDEN)
    _, outs = replay.replay(pipeline.init_state(CFG, device="cpu"),
                            pipeline.scan_from_numpy(scans, device="cpu"),
                            CFG)
    assert len(calls) == 2 * 24          # two a scan with an estimate
    np.testing.assert_array_equal(outs.inited.numpy(), g["inited"])
    np.testing.assert_array_equal(outs.fail.numpy(), g["fail"])
    np.testing.assert_array_equal(outs.t.numpy(), g["t"])
    pose = outs.pose_p.numpy()
    assert np.isfinite(pose).all()
    np.testing.assert_allclose(pose, g["pose_p"], atol=GOLDEN_POSE_ATOL)
