"""Sequence replay drivers + trajectory metrics (port of
mmloam_tpu/replay.py).

`make_sequence` is a numpy copy of the reference's host-side builder (its
outputs are bit-identical); `replay_batch` steps B sequences in lockstep —
one `pipeline.step_core_batch` over all lanes per scan, then ONE batched
map insert per map through the CUDA kernel K1 — exactly the split the TPU
path makes (`mmloam_tpu/replay.py:190-208`).  `replay` steps one
sequence as the reference's `replay` does (a `lax.scan` over the
unbatched step, `mmloam_tpu/replay.py:159-161`): `pipeline.step_core_one`,
where each per-lane conditional takes one branch and the LM stops at its
lane's end, then the same K1 insert on a lane axis of one.  With `mesh`,
a list of devices, `replay_batch` splits the batch as the reference
splits it over a 1-D mesh (`mmloam_tpu/replay.py:176-224`): each device
owns whole sequences, and no tensor crosses devices during the replay.

On the card a replay runs as the reference's `jax.jit` over `lax.scan`
runs it, with no host in the loop: the lockstep scan is captured once as
a CUDA graph (`_ScanGraph`) and replayed for every scan after.  The first
call for a (config, lanes, device, shapes) runs scan 0 eagerly (which
builds the kernels and fills the constant caches), captures the scan, and
replays it for scans 1 .. T-1.  The lockstep graph gates its init in IF
nodes (`branch.any_lane`): the bookkeeping runs while a lane is
un-inited, the init solve where a lane attempts it.  `replay` captures
the one-lane step instead, its branches as CUDA-graph IF nodes
(`branch.py`), after a scan 0 run through the lockstep step at one lane
(bit-equal, and it runs every branch, so every kernel, handle and
constant exists before the capture).  The graph is cached, one a device
(`_GRAPHS`): a later call with the same config and shapes copies its
states into the graph's buffers and replays every scan, and a call with
others replaces it.  A cached graph holds a copy of the batch's state,
maps included, and its private memory pool (PERF.md measures the graph's
peak at 1.24-1.30 times the eager loop's); `clear_graphs`, the
counterpart of `jax.clear_caches`, frees them.  The step reads no device
value on the host, so nothing in the loop waits for the card.  The
kernels' launch counters count a call's replays once, after its last
scan, from the kernel nodes of the captured graph
(`ops/graph_kernels.py`); the launches inside an IF node's body count as
many times as its predicate held, read from the predicates each replay
left; the same host read adds the lockstep graph's replays and the
replays in which each gate's body ran to `spans.gate_counts()`.  Each
call leaves its outputs with `spans.note_fusion` (`spans.fusion_counts()`
sums them when asked).
`_replay_eager` is the loop without a graph (the counterpart of
`jax.disable_jit`): CPU tensors take it, and tests call it.  With spans
on (`spans.py`) the runner keeps the layer of each of its graphs' nodes
(`node_layers`) and the loop clocks each scan's host work and graph launch.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import threading
import time
import traceback

import numpy as np
import torch

from . import branch, lie, pipeline, spans
from .data import synthetic
from .ops import graph_kernels, launch_tape, voxelmap
from .tree import tree_map


def _hori_dirs(n_az):
    """Livox-Horizon-like raster: 81.7 x 25.1 deg FOV, 6 lines."""
    el = np.deg2rad(np.linspace(-12.55, 12.55, 6))
    az = np.deg2rad(np.linspace(-40.85, 40.85, n_az))
    ca, sa = np.cos(az), np.sin(az)
    ce, se = np.cos(el), np.sin(el)
    return np.stack([ce[:, None] * ca[None, :],
                     ce[:, None] * sa[None, :],
                     np.broadcast_to(se[:, None], (6, n_az))], axis=-1)


def make_sequence(world, traj, t0, n_scans, cfg, scan_hz=10.0, imu_rate=200.0,
                  range_noise=0.0, imu_noise=(0.0, 0.0), bg=(0, 0, 0),
                  ba=(0, 0, 0), g_vec=None, n_az=900, seed=0,
                  dtype=np.float32, with_hori=False, hori_n_az=None,
                  device=None):
    """Stacked ScanInput of `n_scans` scans + ground truth (gt_R, gt_p).

    Same construction as the reference's builder; leaves are numpy arrays
    when `device` is None, else tensors on `device`.  The numpy default is
    deliberate: it is the shared input both packages take, not a compute
    path, so it does not default to the card as `pipeline.init_state` does.
    """
    rng = np.random.default_rng(seed)
    period = 1.0 / scan_hz
    L = len(synthetic.VLP16_ELEVATIONS_DEG)
    M = cfg.imu.max_samples

    el = np.deg2rad(synthetic.VLP16_ELEVATIONS_DEG)
    az = -np.pi + 2 * np.pi * (np.arange(n_az) + 0.5) / n_az
    ca, sa = np.cos(az), np.sin(az)
    ce, se = np.cos(el), np.sin(el)
    dirs_l = np.stack([ce[:, None] * ca[None, :],
                       ce[:, None] * sa[None, :],
                       np.broadcast_to(se[:, None], (L, n_az))], axis=-1)
    if with_hori:
        h_az = hori_n_az or (cfg.scan.hori_max_pts_per_line)
        dirs_h = _hori_dirs(h_az)

    scans = []
    gt = []
    for i in range(n_scans):
        ts_start = t0 + i * period
        ts_end = ts_start + period
        t_az = ts_start + (np.arange(n_az) + 0.5) / n_az * period
        R_az = traj.rot(t_az)
        p_az = traj.pos(t_az)
        dirs_w = np.einsum("aij,laj->lai", R_az, dirs_l)
        origins = np.broadcast_to(p_az[None, :, :], (L, n_az, 3))
        r = world.raycast(origins.reshape(-1, 3), dirs_w.reshape(-1, 3))
        r = r.reshape(L, n_az)
        valid = np.isfinite(r)
        if range_noise > 0:
            r = r + np.where(valid, rng.normal(0, range_noise, r.shape), 0.0)
        pts = dirs_l * np.where(valid, r, 0.0)[..., None]
        rel = np.broadcast_to((np.arange(n_az) + 0.5) / n_az, (L, n_az))

        pts_c = np.zeros((L, n_az, 3))
        rel_c = np.zeros((L, n_az))
        n_val = valid.sum(axis=1).astype(np.int32)
        for l in range(L):
            sel = np.where(valid[l])[0]
            pts_c[l, :len(sel)] = pts[l, sel]
            rel_c[l, :len(sel)] = rel[sel] if rel.ndim == 1 else rel[l, sel]

        acc, gyr, its = synthetic.simulate_imu(
            traj, ts_start, ts_end, rate=imu_rate, gnorm=cfg.imu.gnorm,
            bg=bg, ba=np.asarray(ba), noise_gyr=imu_noise[0],
            noise_acc=imu_noise[1], rng=rng if sum(imu_noise) > 0 else None,
            g_vec=g_vec)
        dts = np.diff(np.concatenate([[ts_start], its]))
        m = len(its)
        imu_acc = np.zeros((M, 3)); imu_acc[:m] = acc[:M]
        imu_gyr = np.zeros((M, 3)); imu_gyr[:m] = gyr[:M]
        imu_dt = np.zeros(M); imu_dt[:m] = dts[:M]
        imu_mask = np.arange(M) < min(m, M)

        hori = {}
        if with_hori:
            th_az = ts_start + (np.arange(dirs_h.shape[1]) + 0.5) \
                / dirs_h.shape[1] * period
            Rh = traj.rot(th_az)
            ph = traj.pos(th_az)
            dw_h = np.einsum("aij,laj->lai", Rh, dirs_h)
            org_h = np.broadcast_to(ph[None], (6,) + ph.shape)
            rh = world.raycast(org_h.reshape(-1, 3), dw_h.reshape(-1, 3))
            rh = rh.reshape(dirs_h.shape[:2])
            hval = np.isfinite(rh)
            if range_noise > 0:
                rh = rh + np.where(hval, rng.normal(0, range_noise, rh.shape),
                                   0.0)
            hpts = dirs_h * np.where(hval, rh, 0.0)[..., None]
            hrel = np.broadcast_to(
                (np.arange(dirs_h.shape[1]) + 0.5) / dirs_h.shape[1],
                dirs_h.shape[:2])
            Lh, Nh = dirs_h.shape[:2]
            hp_c = np.zeros((Lh, Nh, 3))
            hr_c = np.zeros((Lh, Nh))
            hn = hval.sum(axis=1).astype(np.int32)
            for l in range(Lh):
                sel = np.where(hval[l])[0]
                hp_c[l, :len(sel)] = hpts[l, sel]
                hr_c[l, :len(sel)] = hrel[l, sel]
            hori = dict(hori_pts=hp_c.astype(dtype),
                        hori_intensity=np.zeros((Lh, Nh), dtype),
                        hori_n_valid=hn,
                        hori_rel_time=hr_c.astype(dtype))

        scans.append(pipeline.ScanInput(
            pts=pts_c.astype(dtype), intensity=np.zeros((L, n_az), dtype),
            n_valid=n_val, rel_time=rel_c.astype(dtype),
            t=np.asarray(ts_end, dtype),
            imu_acc=imu_acc.astype(dtype), imu_gyr=imu_gyr.astype(dtype),
            imu_dt=imu_dt.astype(dtype), imu_mask=imu_mask, **hori))
        gt.append((traj.rot(ts_end), traj.pos(ts_end)))

    stacked = tree_map(lambda *xs: np.stack(xs), scans[0], *scans[1:])
    if device is not None:
        stacked = tree_map(lambda a: torch.as_tensor(a, device=device),
                           stacked)
    gt_R = np.stack([g[0] for g in gt])
    gt_p = np.stack([g[1] for g in gt])
    return stacked, gt_R, gt_p


def _stack_outputs(outs):
    return tree_map(lambda *xs: torch.stack(xs), outs[0], *outs[1:])


def replay(state, scans, cfg):
    """Step one sequence over a stacked ScanInput (T, ...), one branch of
    each conditional (`pipeline.step_core_one`, then K1's insert), on
    copies of the state's maps (the input state is left as it was).  On
    the card through the cached graph of the one-lane scan.  Returns
    (final state, StepOutput stacked over T), bit-equal to the lockstep
    replay at one lane."""
    lane = pipeline._lane(state)
    lane = lane._replace(**{f: voxelmap.VoxelMap(
        getattr(lane, f).cells.clone()) for f in pipeline.MAP_FIELDS})
    final, outs = _replay_lockstep(
        lane, tree_map(lambda a: torch.as_tensor(a)[:, None], scans), cfg,
        one=True)
    return pipeline._unlane(final), tree_map(lambda a: a[:, 0], outs)


def stack_states(states):
    """Stack per-sequence LIOStates into a batch (B, ...)."""
    return tree_map(lambda *xs: torch.stack(xs), states[0], *states[1:])


def stack_sequences(seqs):
    """Stack per-sequence ScanInputs (T, ...) into (T, B, ...), numpy or
    tensor leaves (the reference's `stack_sequences`)."""
    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs, dim=1)
        return np.stack(xs, axis=1)
    return tree_map(stack, seqs[0], *seqs[1:])


def _shard(states, scans, i, n, dev):
    """Shard i of n: its lanes' state and scans, on `dev`.  A list of
    shard states (a split replay's result) gives its i-th, moved."""
    to = lambda a: torch.as_tensor(a, device=dev)
    if isinstance(states, list):
        st = tree_map(to, states[i])
        per = st.x.shape[0]
        lo = sum(s.x.shape[0] for s in states[:i])
    else:
        per = states.x.shape[0] // n
        lo = i * per
        st = tree_map(lambda a: to(a[lo:lo + per]), states)
    return st, tree_map(lambda a: to(a[:, lo:lo + per]), scans)


def replay_batch(states, scans, cfg, mesh=None):
    """Replay a BATCH of sequences in lockstep; with `mesh`, split over
    devices.

    Without `mesh`: see `_replay_lockstep`; returns (final states,
    StepOutput stacked as (T, B, ...)).

    On the card the replay keeps its CUDA graph, one a device, until a
    call with another config or shapes replaces it or `clear_graphs`
    frees it: its copy of the batch's state, maps included, and its
    memory pool stay allocated meanwhile (PERF.md: 1.24-1.30 times the
    eager loop's peak).

    `mesh` is a sequence of devices (torch.device or names), the
    counterpart of the reference's 1-D mesh over the batch axis: the B
    lanes split into len(mesh) contiguous shards (B must divide evenly, as
    in the reference), shard i's state and scans go to mesh[i], and each
    shard replays there in lockstep, maps and all; nothing crosses devices
    until the outputs come back.  One worker thread runs per distinct
    device (under `torch.cuda.device` for a CUDA one); shards that share a
    device run in turn in its worker.  `states` is a batched LIOState, or
    the list of shard states a split replay returned.  Returns (the list
    of final shard states, each on its device, in mesh order; StepOutput
    (T, B, ...) in lane order on mesh[0]).  As without a mesh, the maps
    of `states` may be updated in place: callers must not reuse them.
    """
    if mesh is None:
        return _replay_lockstep(states, scans, cfg)
    devs = [torch.device(d) for d in mesh]
    n = len(devs)
    listed = isinstance(states, list)
    B = (sum(s.x.shape[0] for s in states) if listed
         else states.x.shape[0])
    if n == 0 or B % n or (listed and len(states) != n):
        raise ValueError(f"a batch of {B} lanes does not split evenly "
                         f"over {n} devices")
    groups = {}
    for i, dev in enumerate(devs):
        groups.setdefault(dev, []).append(i)

    def work(dev, idx):
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        out = {}
        with ctx:
            for i in idx:
                out[i] = _replay_lockstep(*_shard(states, scans, i, n, dev),
                                          cfg)
        return out

    results = {}
    with concurrent.futures.ThreadPoolExecutor(len(groups)) as ex:
        futs = [ex.submit(work, dev, idx) for dev, idx in groups.items()]
        for fut in futs:
            results.update(fut.result())
    finals = [results[i][0] for i in range(n)]
    outs = tree_map(lambda *xs: torch.cat([x.to(devs[0]) for x in xs],
                                          dim=1),
                    *(results[i][1] for i in range(n)))
    spans.note_fusion(outs, cfg)
    return finals, outs


def gather_states(shards, device=None):
    """One batched LIOState from a split replay's shard states, lanes in
    order, on `device` (the first shard's when None)."""
    dev = shards[0].x.device if device is None else torch.device(device)
    return tree_map(lambda *xs: torch.cat([x.to(dev) for x in xs]),
                    shards[0], *shards[1:])


def _replay_eager(states, scans, cfg, one=False):
    """Replay a BATCH of sequences in lockstep on one device, op by op
    (with `one`, a batch of one lane through `pipeline.step_core_one`).

    states: LIOState with a leading batch axis B; scans: ScanInput laid out
    (T, B, ...).  For each scan, ONE `step_core_batch` over all lanes (the
    reference's vmap of step_core), then the maps of all B lanes are
    written by ONE batched `apply_inserts_batched` each — through the CUDA
    kernel on CUDA tensors.  The maps of `states` are updated IN PLACE (the
    reference donates the batch state the same way): callers must not
    reuse the passed `states`.  Returns (final states, StepOutput stacked
    as (T, B, ...)).
    """
    step = pipeline.step_core_one if one else pipeline.step_core_batch
    outs = []
    for t in range(scans.pts.shape[0]):
        states, out, pend = step(states, tree_map(lambda a: a[t], scans),
                                 cfg)
        states = pipeline.apply_inserts_batched(states, pend, cfg)
        if one:
            states = tree_map(_dense, states)
        outs.append(out)
    return states, _stack_outputs(outs)


def _dense(a):
    """`a` laid out densely in row-major order (a copy only where it is
    not).  The one-lane loop lays its state out so after each scan, as the
    graph's static buffers hold it: a branch passes its tensors on as it
    made them (a transposed or broadcast view), which a select would have
    copied, and on the card the layout of a product's operands picks the
    cuBLAS kernel and so its rounding in the scans after."""
    want, n = [], 1
    for d in reversed(a.shape):
        want.append(n)
        n *= d
    return a if a.stride() == tuple(reversed(want)) else a.clone(
        memory_format=torch.contiguous_format)


# the captured lockstep scan of each device (`_ScanGraph.key`: the config,
# state and scan shapes it was captured for); a call with another key
# replaces it, and `clear_graphs` frees them.  Torch allows one capture at
# a time in a process, so the workers of a split replay capture in turn.
_GRAPHS = {}
_GRAPHS_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()
_UNCLOCKED = contextlib.nullcontext()      # a scan's loop body, spans off


def clear_graphs():
    """Free every cached lockstep-scan graph with its buffers (the
    counterpart of `jax.clear_caches`): their memory goes back to torch's
    caching allocator."""
    with _GRAPHS_LOCK:
        _GRAPHS.clear()


def _signature(tree):
    """The structure, shapes and dtypes of a tree, hashable."""
    return repr(tree_map(lambda a: (tuple(a.shape), a.dtype), tree))


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _assign(dst, src):
    """Copy tree `src` into the buffers of tree `dst` leaf by leaf (a leaf
    that is its own buffer is skipped).  A leaf of `src` that shares
    memory with any buffer of `dst` (a view the step passed on) is cloned
    first, so no copy reads a buffer another copy has written."""
    owned = {a.untyped_storage().data_ptr() for a in _leaves(dst)}
    pairs = []

    def collect(d, s):
        if s is d:
            return
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"a state leaf changed from {tuple(d.shape)} "
                             f"{d.dtype} to {tuple(s.shape)} {s.dtype}")
        if s.untyped_storage().data_ptr() in owned:
            s = s.clone()
        pairs.append((d, s))

    tree_map(collect, dst, src)
    for d, s in pairs:
        d.copy_(s)


def _capture_site(exc):
    """The op whose capture failed, as "file:line (code)": the innermost
    frame of this package in the traceback of the first error of `exc`'s
    chain (an op that breaks a capture raises; ending the capture then
    raises again)."""
    while exc.__context__ is not None:
        exc = exc.__context__
    site = "an unknown op"
    for fr in traceback.extract_tb(exc.__traceback__):
        if "mmloam_tpu_torch" in fr.filename:
            site = (f"{fr.filename.split('mmloam_tpu_torch')[-1][1:]}:"
                    f"{fr.lineno} ({fr.line})")
    return site


def _end_routing(pool, dev):
    """End the caching allocator's routing of this thread's allocations to
    a graph's memory `pool` after its capture raised.  Torch ends it in
    `capture_end` only after `cudaStreamEndCapture` succeeded, so a
    capture that fails there (an op failed on the capture stream) leaves
    it in place, and the next teardown of a memory pool aborts
    (`captures_underway.empty()` in `~MemPool`).  A capture that ended
    (an error raised in a valid capture, or in an IF node's body) has
    ended its routing already."""
    try:
        torch._C._cuda_endAllocateToPool(dev.index, pool)
    except RuntimeError:
        pass


def _abandon(graph):
    """Keep a graph whose capture failed after it opened an IF node alive
    for the life of the process.  Where an op fails inside an IF node's
    body, the driver frees the body graph with its invalidated capture
    but the node keeps pointing at it, and destroying the graph then
    crashes the process (torch 2.11 with the CUDA 12.8 runtime on an
    H100: "free(): invalid pointer" or a segfault in `CUDAGraph.reset`,
    or a hang).  So the graph object is never released: a few KB of host
    memory a failed capture; its tensors' memory pools go."""
    ctypes.pythonapi.Py_IncRef(ctypes.py_object(graph))


class _ScanGraph:
    """One scan captured as a CUDA graph on static buffers: on the static
    state and scan, the lockstep step (`pipeline.step_core_batch`, its
    init gates in IF nodes) or, with `one`, the one-lane step
    (`pipeline.step_core_one`, its branches in IF nodes), both kept by
    `bodies`, then `apply_inserts_batched` (the maps in place), then the
    new state copied into the static state.  `run(scan)` copies a scan
    in, replays, and returns the static step outputs (overwritten by the
    next run); `flags` then holds each IF node's predicate at that replay
    (None without IF nodes).  `gates` maps each named body (the lockstep
    step's "init" and "init_solve") to its IF node.  Capture raises,
    naming the op, where the scan cannot be captured.

    Counts: under the capture the kernel wrappers launch nothing and count
    nothing (`launch_tape`).  `launches`, the launches of our kernels
    at the graph's top level, and `body_launches[i]`, those in body i,
    are read from the kernel nodes of the graph and of each body graph
    (`graph_kernels.launches`) and held against the launches the wrappers
    noted there.  `count(times, runs)`, once a call, adds the top-level
    launches and plays the top-level call counts `times` over (the call's
    replays), and each body's `runs[i]` over, and notes the call's
    launches by kernel (`spans.note_launches`).  `flag_history` (T, IF
    nodes) int32 on the card: each node's predicate at each scan of the
    last call (None without IF nodes).

    Set-up by part, seconds: `capture_s` (capture plus instantiation),
    `census_s` (the node census and its check), `instantiate_s`, and
    `eager_s` (scan 0's eager step before the capture, set by
    `_replay_graph`).  With spans on at the capture, `node_layers` is
    `spans.node_layers` of the top-level graph and the bodies (None with
    spans off, or where it could not be laid: `node_layers_why` says
    why)."""

    flag_history = None
    eager_s = None
    node_layers = None
    node_layers_why = "spans were off at the capture"

    def __init__(self, key, state, scan, cfg, one=False):
        self.key = key
        self.state = state
        self.scan = tree_map(lambda a: a.clone(), scan)
        self.lock = threading.Lock()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        bodies = branch.Bodies(state.x.device)
        step = pipeline.step_core_one if one else pipeline.step_core_batch
        what = "one-lane" if one else "lockstep"
        stream = torch.cuda.Stream(state.x.device)
        # the graph's private pool, named here: a failed capture has none
        # to ask it for (`_end_routing`)
        pool = torch.cuda.graph_pool_handle()
        tape, notes, on = [], [], spans.enabled()
        with _CAPTURE_LOCK:
            t0 = time.perf_counter()
            # the outer stream context gives the caller its stream back
            # where the capture's own does not end (see _end_routing)
            try:
                with torch.cuda.stream(stream), \
                        launch_tape.recording(tape), \
                        spans.recording(notes), \
                        branch.recording(bodies), torch.cuda.graph(
                            self.graph, pool=pool, stream=stream,
                            capture_error_mode="thread_local"):
                    bodies.flags.zero_()
                    new, self.out, pend = step(self.state, self.scan, cfg)
                    new = pipeline.apply_inserts_batched(new, pend, cfg)
                    _assign(self.state, new)
            except RuntimeError as e:
                _end_routing(pool, state.x.device)
                if len(bodies):
                    _abandon(self.graph)
                raise RuntimeError(f"the {what} scan did not capture at "
                                   f"{_capture_site(e)}: {e}") from e
            capture_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        raw = self.graph.raw_cuda_graph()
        graphs = [raw] + bodies.graphs
        found = [graph_kernels.launches(g) for g in graphs]
        noted = [launch_tape.launches(tape, body=i - 1 if i else None)
                 for i in range(len(graphs))]
        for i, (got, want) in enumerate(zip(found, noted)):
            if got != want:
                where = f"body {i - 1}" if i else "top level"
                unnamed = graph_kernels.kernel_names(
                    graphs[i])[graph_kernels.UNNAMED]
                raise RuntimeError(
                    f"the captured scan holds the kernel nodes "
                    f"{dict(got)} of ours at its {where} ({unnamed} kernel "
                    f"nodes unnamed), its wrappers issued {dict(want)}")
        self.launches, self.body_launches = found[0], found[1:]
        self.census_s = time.perf_counter() - t0
        if on:
            try:
                self.node_layers = spans.node_layers(
                    graphs, bodies.parents, notes)
                self.node_layers_why = None
            except ValueError as e:
                self.node_layers_why = str(e)
        self.flags = bodies.flags[:len(bodies)] if len(bodies) else None
        self.gates = {name: i for i, name in enumerate(bodies.names)
                      if name is not None}
        self.tape = tape
        t0 = time.perf_counter()
        self.graph.instantiate()
        self.instantiate_s = time.perf_counter() - t0
        # capture plus instantiation, the node census left out
        self.capture_s = capture_s + self.instantiate_s
        # set last, so the graph and the tensors the capture made go
        # before the bodies' memory pools when the runner goes
        self.bodies = bodies

    def run(self, scan, clock=None):
        """Copy `scan` in and replay (between `clock`'s events, a
        `spans.Replays`, where given); the counters are left to
        `count`."""
        _assign(self.scan, scan)
        if clock is None:
            self.graph.replay()
        else:
            clock.launch(self.graph)
        return self.out

    def count(self, times, runs=None):
        """Add the launches and call counts of `times` replays, in which
        IF node i's body ran `runs[i]` times."""
        by_kernel = dict.fromkeys(("k1", "k2", "k3", "k4"), 0)
        for keyed, n in ((self.launches, times),
                         *zip(self.body_launches, runs or ())):
            graph_kernels.count(keyed, times=n)
            for (kernel, _, _), m in keyed.items():
                by_kernel[kernel] += m * n
        spans.note_launches(times, by_kernel)
        launch_tape.play(self.tape, times=times, runs=runs)


def _replay_graph(states, scans, cfg, one=False):
    """`_replay_eager` on the card through the cached graph of one scan
    (see the module docstring); the caller's `states` are left as they
    were, and the returned state owns its memory."""
    dev = states.x.device
    scans = tree_map(lambda a: torch.as_tensor(a, device=dev), scans)
    T = scans.pts.shape[0]
    at = lambda t: tree_map(lambda a: a[t], scans)
    key = (cfg, one, _signature(states), _signature(at(0)))
    with _GRAPHS_LOCK:
        runner = _GRAPHS.get(dev)
        if runner is not None and runner.key != key:
            del _GRAPHS[dev]           # freed before the new capture
            runner = None
    first = 0
    if runner is None:
        # scan 0 through the lockstep step, on the graph's buffers-to-be:
        # it runs every branch, so every kernel and constant a body may
        # touch exists before the capture (and its bits are the one-lane
        # step's)
        t0 = time.perf_counter()
        state = tree_map(lambda a: a.clone(), states)
        new, out0, pend = pipeline.step_core_batch(state, at(0), cfg)
        _assign(state, pipeline.apply_inserts_batched(new, pend, cfg))
        eager_s = time.perf_counter() - t0
        runner = _ScanGraph(key, state, at(0), cfg, one)
        runner.eager_s = eager_s
        spans.note_setup(runner)
        with _GRAPHS_LOCK:
            _GRAPHS[dev] = runner
        first = 1
    with runner.lock:
        flags = runner.flags
        hist = None if flags is None else torch.zeros(
            (T,) + tuple(flags.shape), dtype=torch.int32, device=dev)
        clock = spans.Replays(runner, T) if spans.enabled() else None
        scope = (lambda: _UNCLOCKED) if clock is None else clock.scan
        if first == 0:
            _assign(runner.state, states)
            with scope():
                out0 = runner.run(at(0), clock)
                if hist is not None:
                    hist[0].copy_(flags)
        outs = tree_map(lambda a: torch.empty((T,) + tuple(a.shape),
                                              dtype=a.dtype, device=dev),
                        out0)
        tree_map(lambda o, a: o[0].copy_(a), outs, out0)
        for t in range(1, T):
            with scope():
                out = runner.run(at(t), clock)
                tree_map(lambda o, a: o[t].copy_(a), outs, out)
                if hist is not None:
                    hist[t].copy_(flags)
        sums = None if hist is None else hist.sum(dim=0)
        final = tree_map(lambda a: a.clone(), runner.state)
        # the one host read: how often each body ran
        runs = None if sums is None else sums.tolist()
        runner.count(T - first, runs)
        runner.flag_history = hist
        if not one:
            spans.count_gates(T - first, {} if runs is None else {
                name: runs[i] for name, i in runner.gates.items()})
    return final, outs


def _replay_lockstep(states, scans, cfg, one=False):
    """Replay a BATCH of sequences in lockstep on one device: through the
    cached CUDA graph of the lockstep scan on the card (`_replay_graph`;
    the caller's states are left as they were), op by op on the CPU
    (`_replay_eager`: the maps of `states` are updated in place).  states:
    LIOState with a leading batch axis B; scans: ScanInput laid out (T, B,
    ...).  With `one` (B == 1) through the one-lane step.  Returns (final
    states, StepOutput stacked as (T, B, ...))."""
    if states.x.is_cuda:
        final, outs = _replay_graph(states, scans, cfg, one)
    else:
        final, outs = _replay_eager(states, scans, cfg, one)
    spans.note_fusion(outs, cfg)
    return final, outs


def ate_rmse(est_q, est_p, gt_R, gt_p):
    """ATE RMSE after first-pose alignment (odometry starts at identity)."""
    R0 = gt_R[0]
    p0 = gt_p[0]
    gt_rel = np.einsum("ij,nj->ni", R0.T, gt_p - p0)
    q0 = torch.as_tensor(np.asarray(est_q[0]), dtype=torch.float32)
    ep = torch.as_tensor(np.asarray(est_p), dtype=torch.float32)
    e_rel = lie.quat_rotate(lie.quat_conj(q0)[None], ep - ep[0:1]).numpy()
    err = e_rel - gt_rel
    return float(np.sqrt((err ** 2).sum(axis=1).mean())), err
