"""The LM's damped solve (`ops.damped_solve`): the plain chain on the CPU,
kernel K4 (csrc/lm_solve.cu) on the card.

Inputs: real windows, the normal equations, damping and radius of every
damped solve of a tiny hall replay on the CPU (the lockstep step over two
lanes, 11 scans: tests/test_torch_estimator.py's lane and one of its own),
and seeded SPD windows (W = 5; per-dim scales over six decades, damping
1e-9 to 100, radii from 0.1 to 1e4).

On the CPU (Tier-1):

* `solver._damped_solve` takes the plain chain, bit-equal to the frozen
  copy of the port's solver in `benchmark/reference` (the chain as it was
  before K4), on the real windows, seeded ones and poisoned ones;
* `check`, the kernel's input check, refuses another dtype, another
  state width, a window over `MAX_W`, non-contiguous input, and accepts
  every damped solve the replay made, lockstep and one lane;
* `graph_kernels` counts K4's graph launches into `damped_solve.LAUNCHES`
  (tests/test_torch_graph.py holds its key); the launch tape notes them
  under a capture; the spans' layering leaves K4 unnamed.

On the card (marked `cuda`; this file imports torch only, so it runs with
`--noconftest` there): at one lane K4 is bit-equal to the plain float32
chain (every damped solve of the replay, seeded, unobservable and
poisoned lanes, the radius as given, free and binding); K4's largest
error against the plain chain in
float64 is at most twice the plain float32 chain's plus `FLOOR` of the
largest entry, at B = 1, 16, 64, on real and seeded windows and with the
radius binding; a zero diagonal gives a zero step exactly there; a
poisoned lane zeroes (or makes NaN) the entries the plain chain does and
leaves the other lanes' bits alone; each lane alone is bit-equal to the
batch; `lm_solve` captured in a CUDA graph is bit-equal to eager, at B =
16 and in the one-lane `branch.loop` at B = 1; the lockstep graph
launches K4 20 times a scan at `LIOConfig()`'s solver and 50 at
`faithful_config`'s, and the main path never runs the plain chain there.
"""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from benchmark.reference.estimator import solver as frozen  # noqa: E402
from mmloam_tpu_torch import branch, pipeline, replay, spans  # noqa: E402
from mmloam_tpu_torch.config import (LIOConfig, faithful_config,  # noqa: E402
                                     tiny_config)
from mmloam_tpu_torch.data import synthetic  # noqa: E402
from mmloam_tpu_torch.estimator import solver  # noqa: E402
from mmloam_tpu_torch.ops import damped_solve, graph_kernels  # noqa: E402
from mmloam_tpu_torch.ops import launch_tape  # noqa: E402
from mmloam_tpu_torch.tree import tree_map  # noqa: E402

CFG = tiny_config()
T = 11
W = 5
# K4's error floor, a share of the case's largest step entry: a few
# float32 roundings of it (u = 2^-24), where the plain chain's own error
# happens to be smaller
FLOOR = 2.0 ** -21


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _lanes():
    hall = synthetic.Trajectory(speed=0.8, z_amp=0.15)
    turn = synthetic.Trajectory(speed=0.7, yaw_rate=0.3, z_amp=0.1)
    return [replay.make_sequence(synthetic.default_world(), traj, 0.0, T,
                                 CFG, n_az=360, dtype=np.float32,
                                 range_noise=0.003, seed=seed,
                                 device="cpu")[0]
            for traj, seed in ((hall, 1), (turn, 3))]


@functools.lru_cache(maxsize=None)
def _recorded():
    """The inputs of every damped solve and every LM solve of the tiny
    lockstep replay (two lanes, T scans) on the CPU, and the damped
    solves of the first lane's one-lane replay: (lockstep damped args,
    lockstep lm_solve (args, kwargs), one-lane damped args)."""
    seqs = _lanes()
    damped0, lm0 = solver._damped_solve, solver.lm_solve
    rec = dict(damped=[], lm=[])

    def damped_spy(*a):
        rec["damped"].append(tuple(t.clone() for t in a))
        return damped0(*a)

    def lm_spy(*a, **k):
        rec["lm"].append((tree_map(lambda t: t.clone()
                                   if torch.is_tensor(t) else t, a),
                          dict(k)))
        return lm0(*a, **k)

    solver._damped_solve, solver.lm_solve = damped_spy, lm_spy
    try:
        states = replay.stack_states(
            [pipeline.init_state(CFG, device="cpu") for _ in seqs])
        replay.replay_batch(states, replay.stack_sequences(seqs), CFG)
        lock = rec["damped"]
        rec["damped"] = []
        solver.lm_solve = lm0
        replay.replay(pipeline.init_state(CFG, device="cpu"), seqs[0], CFG)
    finally:
        solver._damped_solve, solver.lm_solve = damped0, lm0
    return lock, rec["lm"], rec["damped"]


def _real(B):
    """B lane-windows of the lockstep replay's damped solves (distinct
    calls and lanes, post-init ones first), as (diag, up, b, lam,
    radius)."""
    lock = _recorded()[0]
    lanes = [tuple(a[i:i + 1] for a in args) for args in lock
             for i in range(args[0].shape[0])]
    # a lane whose window is full (every frame observed) after init
    full = [x for x in lanes if bool((torch.diagonal(x[0], dim1=-2, dim2=-1)
                                      [..., :6] > 0).all())]
    rest = [x for x in lanes if not any(x is f for f in full)]
    pick = (full[::max(1, len(full) // B)] + rest)[:B]
    assert len(pick) == B
    return tuple(torch.cat(col) for col in zip(*pick))


def _seeded(B, seed=0):
    """B seeded SPD windows (float32), with damping and radii."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-3, 3, (B, W, 15))
    diag = np.zeros((B, W, 15, 15))
    up = np.zeros((B, W - 1, 15, 15))
    for w in range(W):
        J = rng.normal(size=(B, 20, 15)) * scale[:, w, None, :]
        diag[:, w] += np.swapaxes(J, -1, -2) @ J
    for w in range(W - 1):
        s2 = np.concatenate([scale[:, w], scale[:, w + 1]], axis=-1)
        J = rng.normal(size=(B, 15, 30)) * s2[:, None, :]
        H = np.swapaxes(J, -1, -2) @ J
        diag[:, w] += H[:, :15, :15]
        diag[:, w + 1] += H[:, 15:, 15:]
        up[:, w] = H[:, :15, 15:]
    b = rng.normal(size=(B, W, 15)) * scale * 10.0
    lam = 10.0 ** rng.uniform(-9, 2, B)
    radius = 10.0 ** rng.uniform(-1, 4, B)
    return tuple(torch.from_numpy(a.astype(np.float32))
                 for a in (diag, up, b, lam, radius))


def _poisoned(args, where, lane=3):
    """`args` with lane `lane` poisoned at `where`."""
    diag, up, b, lam, radius = (a.clone() for a in args)
    nan = float("nan")
    if where == "diag_diagonal":
        diag[lane, 1, 2, 2] = nan
    elif where == "diag_off_diagonal":
        diag[lane, 3, 0, 7] = nan
    elif where == "diag_inf":
        diag[lane, 2, 9, 9] = float("inf")
    elif where == "up":
        up[lane, 1, 4, 11] = nan
    elif where == "b":
        b[lane, 0, 5] = nan
    elif where == "lam":
        lam[lane] = nan
    elif where == "radius":
        radius[lane] = nan
    return diag, up, b, lam, radius


POISONS = ("diag_diagonal", "diag_off_diagonal", "diag_inf", "up", "b",
           "lam", "radius")


def _bits(a):
    return a.contiguous().view(torch.int32)


# --- on the CPU ------------------------------------------------------------


@pytest.mark.parametrize("case", ["real", "seeded", "unobservable",
                                  *POISONS])
def test_cpu_takes_the_plain_chain_bit_for_bit(case):
    if case == "real":
        args = _real(16)
    else:
        args = _seeded(16, seed=1)
        if case == "unobservable":
            args = _unobservable(args)
        elif case != "seeded":
            args = _poisoned(args, case)
    got = solver._damped_solve(*args)
    want = frozen._damped_solve(*args)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(damped_solve.plain(*args)), _bits(want))


def _unobservable(args, lanes=(0, 5)):
    """`args` with dims zeroed (rows and columns) in some frames of some
    lanes: dim 4 in frame 1, the whole gyro-bias group (9-11) in every
    frame."""
    diag, up, b, lam, radius = (a.clone() for a in args)
    for lane in lanes:
        for w, dims in ((1, [4]), *((w, [9, 10, 11]) for w in range(W))):
            diag[lane, w, dims, :] = 0.0
            diag[lane, w, :, dims] = 0.0
            if w < W - 1:
                up[lane, w, dims, :] = 0.0
            if w > 0:
                up[lane, w - 1, :, dims] = 0.0
    return diag, up, b, lam, radius


def _bad(kind):
    diag, up, b, lam, radius = _seeded(2)
    if kind == "dtype":
        diag = diag.double()
    elif kind == "width":
        diag, up, b = diag[..., :14, :14], up[..., :14, :14], b[..., :14]
        diag, up, b = (a.contiguous() for a in (diag, up, b))
    elif kind == "window":
        n = damped_solve.MAX_W + 1
        diag = diag[:, :1].expand(2, n, 15, 15).contiguous()
        up = up[:, :1].expand(2, n - 1, 15, 15).contiguous()
        b = b[:, :1].expand(2, n, 15).contiguous()
    elif kind == "contiguity":
        diag = diag.transpose(-1, -2)
    elif kind == "lanes":
        lam = lam[:1]
    return diag, up, b, lam, radius


@pytest.mark.parametrize("kind, what", [
    ("dtype", "float32"), ("width", "15-dim"), ("window", "1 to 16"),
    ("contiguity", "contiguous"), ("lanes", "(2,)")])
def test_check_refuses_what_the_kernel_does_not_take(kind, what):
    with pytest.raises(ValueError, match=what.replace("(", r"\(")
                       .replace(")", r"\)")):
        damped_solve.check(*_bad(kind))


def test_check_takes_every_damped_solve_of_the_replay():
    lock, _, one = _recorded()
    assert len(lock) == T * 2 * CFG.solver.max_inner_iters
    assert one and all(a[0].shape[0] == 1 for a in one)
    for args in lock + one:
        damped_solve.check(*args)
    damped_solve.check(*_seeded(1))


def test_graph_kernels_count_k4():
    damped_solve.reset_counts()
    graph_kernels.count({("k4", "default", False): 20}, times=3)
    assert damped_solve.LAUNCHES == 60
    tape = []
    with launch_tape.recording(tape):
        damped_solve._count()
    assert damped_solve.LAUNCHES == 60
    assert launch_tape.launches(tape) == {("k4", "default", False): 1}
    damped_solve.reset_counts()


def test_layering_leaves_k4_unnamed(monkeypatch):
    names = ["(anonymous namespace)::eigh_kernel(float const*)",
             "(anonymous namespace)::lm_damped_solve_kernel(float const*)",
             "void at::native::reduce_kernel<512, 1>()"]
    monkeypatch.setattr(graph_kernels, "chain", lambda g: [
        (i, 0, name) for i, name in enumerate(names)])
    (ops,) = spans.node_layers([1], [], [(1, (), "estimator")])
    assert ops == [("kernel", "estimator", "k3"),
                   ("kernel", "estimator", None),
                   ("kernel", "estimator", None)]


# --- on the card -----------------------------------------------------------


def _on(dev, args):
    return tuple(a.to(dev) for a in args)


def _errors(args, dev):
    """K4's and the plain float32 chain's largest error against the plain
    chain in float64 on `args` on the card, and the largest entry."""
    args = _on(dev, args)
    k4 = damped_solve.damped_solve(*args)
    p32 = damped_solve.plain(*args)
    p64 = damped_solve.plain(*(a.double() for a in args))
    torch.cuda.synchronize()
    err = lambda a: float((a.double() - p64).abs().max())
    return err(k4), err(p32), float(p64.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16, 64])
@pytest.mark.parametrize("case", ["real", "seeded", "radius_binds"])
def test_k4_matches_the_float64_chain_on_card(case, B):
    dev = _device()
    args = _real(B) if case == "real" else _seeded(B, seed=B)
    if case == "radius_binds":
        free = damped_solve.plain(*args[:4], torch.full_like(args[4], 1e30))
        nrm = torch.sqrt((free * free).sum(dim=(-2, -1)))
        args = args[:4] + (0.25 * nrm,)
    k4, p32, top = _errors(args, dev)
    print(f"{case} B={B}: K4 {k4:.3g}, plain f32 {p32:.3g}, largest {top:.3g}")
    assert k4 <= 2.0 * p32 + FLOOR * top
    if case == "radius_binds":
        dx = damped_solve.damped_solve(*_on(dev, args)).double()
        nrm = torch.sqrt((dx * dx).sum(dim=(-2, -1))).cpu()
        torch.testing.assert_close(nrm, args[4].double(), rtol=1e-6, atol=0)


def _radii(args):
    """`args` with the radius as given, free (1e30) and binding (a
    quarter of the free step's norm)."""
    free = damped_solve.plain(*args[:4], torch.full_like(args[4], 1e30))
    nrm = torch.sqrt((free * free).sum(dim=(-2, -1)))
    return (args, args[:4] + (torch.full_like(args[4], 1e30),),
            args[:4] + (0.25 * nrm,))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["real", "seeded", "unobservable",
                                  *POISONS])
def test_k4_alone_is_the_plain_chain_bit_for_bit_on_card(case):
    """At one lane (the one-lane path's B) K4's bits are the plain
    float32 chain's on the card: every damped solve of the tiny replay,
    lockstep lanes alone and the one-lane replay's, and seeded lanes."""
    dev = _device()
    if case == "real":
        lock, _, one = _recorded()
        lanes = [tuple(a[i:i + 1] for a in args) for args in lock
                 for i in range(args[0].shape[0])] + list(one)
    else:
        args = _seeded(16, seed=6)
        if case == "unobservable":
            args = _unobservable(args)
        elif case != "seeded":
            args = _poisoned(args, case)
        lanes = [tuple(a[i:i + 1].contiguous() for a in args)
                 for i in range(16)]
    for i, lane in enumerate(lanes):
        for a in _radii(_on(dev, lane)):
            got = damped_solve.damped_solve(*a)
            assert torch.equal(_bits(got), _bits(damped_solve.plain(*a))), i


@pytest.mark.cuda
def test_zero_diagonal_gives_a_zero_step_on_card():
    dev = _device()
    args = _unobservable(_seeded(16, seed=2))
    dx = damped_solve.damped_solve(*_on(dev, args)).cpu()
    d15 = torch.diagonal(args[0], dim1=-2, dim2=-1)
    assert bool((d15 == 0).any())
    assert bool((dx[d15 == 0] == 0).all())
    # the rule: a dim is observable where its diagonal exceeds 1e-6 of
    # its group's largest over the window
    gmax = d15.amax(dim=1).unflatten(-1, (5, 3)).amax(dim=-1).clamp(min=0)
    floor = 1e-6 * gmax.clamp(min=1e-12).repeat_interleave(3, dim=-1)
    assert torch.equal(dx != 0, d15 > floor[:, None, :])
    want = damped_solve.plain(*_on(dev, args)).cpu()
    assert torch.equal(dx == 0, want == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("where", POISONS)
def test_poisoned_lane_on_card(where):
    dev = _device()
    clean = _seeded(16, seed=3)
    bad = _poisoned(clean, where)
    got = damped_solve.damped_solve(*_on(dev, bad)).cpu()
    ref = damped_solve.damped_solve(*_on(dev, clean)).cpu()
    plain = damped_solve.plain(*_on(dev, bad)).cpu()
    others = torch.arange(16) != 3
    assert torch.equal(_bits(got[others]), _bits(ref[others]))
    assert torch.equal(torch.isnan(got[3]), torch.isnan(plain[3]))
    assert torch.equal(got[3] == 0, plain[3] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 64])
def test_each_lane_alone_is_the_batch_on_card(B):
    dev = _device()
    args = _on(dev, _seeded(B, seed=4))
    batch = damped_solve.damped_solve(*args)
    for i in range(B):
        alone = damped_solve.damped_solve(*(a[i:i + 1].contiguous()
                                            for a in args))
        assert torch.equal(_bits(alone[0]), _bits(batch[i])), i


def _lm_inputs(dev, lanes):
    """`lanes` lanes of the lockstep replay's recorded `lm_solve` calls,
    the last ones that solve (skip false), on `dev`: the positional
    arguments with `skip` appended."""
    live = []
    for a, k in reversed(_recorded()[1]):
        call = tuple(a) + (k["skip"],)
        for i in range(a[0].shape[0]):
            if not bool(k["skip"][i]):
                live.append(tree_map(lambda t: t[i:i + 1] if torch.is_tensor(
                    t) else t, call))
    return tree_map(lambda *xs: torch.cat(xs).to(dev)
                    if torch.is_tensor(xs[0]) else xs[0], *live[:lanes])


def _lm(call, one=False):
    return tuple(solver.lm_solve(*call[:-1], skip=call[-1], one=one))


@pytest.mark.cuda
@pytest.mark.parametrize("B, one", [(16, False), (1, True)])
def test_captured_lm_solve_is_eager_on_card(B, one):
    dev = _device()
    call = _lm_inputs(dev, B)
    eager = _lm(call, one)                          # builds and loads K4
    torch.cuda.synchronize()
    bodies = branch.Bodies(dev)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    damped_solve.reset_counts()
    with launch_tape.recording([]), branch.recording(bodies), \
            torch.cuda.graph(graph, stream=torch.cuda.Stream(dev),
                             capture_error_mode="thread_local"):
        bodies.flags.zero_()
        out = _lm(call, one)
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    assert damped_solve.LAUNCHES == 0
    assert (len(bodies) > 0) == one
    for got, want in zip(out, eager):
        assert torch.equal(got, want)
    key = ("k4", "default", False)
    top = graph_kernels.launches(graph.raw_cuda_graph())[key]
    inner = [graph_kernels.launches(g)[key] for g in bodies.graphs]
    static_cap = call[9]
    assert (top, sum(inner)) == ((0, static_cap) if one else (static_cap, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("faithful, per_scan", [(False, 20), (True, 50)])
def test_lockstep_graph_launches_k4_per_lm_iteration_on_card(
        faithful, per_scan, monkeypatch):
    dev = _device()
    cfg = faithful_config(CFG) if faithful else CFG
    want = faithful_config(LIOConfig()) if faithful else LIOConfig()
    assert cfg.solver == want.solver
    assert per_scan == (cfg.solver.max_outer_iters
                        * cfg.solver.max_inner_iters)
    seqs = [tree_map(lambda a: a[:3].to(dev), s) for s in _lanes()]

    def plain_chain(*a):
        raise AssertionError("the main path ran the plain chain")

    monkeypatch.setattr(damped_solve, "plain", plain_chain)
    replay.clear_graphs()
    damped_solve.reset_counts()
    states = replay.stack_states(
        [pipeline.init_state(cfg, device=dev) for _ in seqs])
    replay.replay_batch(states, replay.stack_sequences(seqs), cfg)
    torch.cuda.synchronize()
    (runner,) = replay._GRAPHS.values()
    assert runner.launches[("k4", "default", False)] == per_scan
    assert all(("k4", "default", False) not in k
               for k in runner.body_launches)
    assert damped_solve.LAUNCHES == 3 * per_scan
    replay.clear_graphs()
