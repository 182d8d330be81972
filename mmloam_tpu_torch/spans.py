"""Layer spans of the step, the replay loop's own clocks, and the set-up's
parts: where a step's device time and a replay's wall go, as the program
itself sees them.

Spans are off until `enable(True)` turns them on for the process; there
is no other switch.  Off, `layer` returns one shared no-op context and
the replay loop takes no clock reading and records no event, so a replay
runs as it does without this module.  On:

* `with layer(name):` marks a layer of the step (`LEAVES`, nested as the
  step nests them; the innermost span holds).  Op by op (the CPU, scan 0
  of a replay, the eager loop) a span is a
  `torch.profiler.record_function("mmloam.<name>")`.  While a thread
  captures a replay's scan (`recording`) it adds no node: it notes where
  the capture stands (`cuStreamGetCaptureInfo` on the current stream: the
  graph being captured, the top level or an IF node's body, and the node
  the next one will follow).  After the capture, `node_layers` lays those
  notes on the nodes of each graph in the order a replay runs them
  (`graph_kernels.chain`), and the runner keeps the result
  (`replay._ScanGraph.node_layers`).  The captured graph is node for node
  the graph captured with spans off.
* `Replays` clocks a call's replay loop (`replay._replay_graph`): on the
  host, each scan's `graph.replay()` (launch) and the rest of the loop's
  body (host: copies in and out, the flags); on the device, two timing
  events around each `graph.replay()`, from a pool the runner keeps, read
  only when `last_call()` asks (after the caller's synchronize).  Under a
  running profiler the two parts are `record_function` ranges too
  ("mmloam.replay.host", "mmloam.replay.launch").

The set-up's parts are kept whatever the switch says, one clock pair each
a capture (`replay._ScanGraph.eager_s`, `census_s`, `instantiate_s`):
`last_setup()` gives the last capture's.  So are the lockstep graph's
gate counts (`gate_counts()`): its replays since the process started,
and those in which each gate's IF body ran, added once a call from the
predicate sums the replay loop reads anyway.  And so are the last
call's fusion counts (`fusion_counts()`): its lane-scans, those whose
Horizon sweep was merged, and the downsampled points the stack caps kept
and dropped, summed from the outputs the call returned only when asked.
And so are the last calls' launches of our kernels (`call_launches()`),
as their graphs' kernel nodes and the IF bodies that ran count them: what
a trace of such a call has to show.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import threading
import time

import torch

# the step's leaf layers, outermost first where they nest: the Horizon's
# fusion runs inside the front end, association inside the estimator
LEAVES = ("front_end", "fusion", "estimator", "association", "gravity",
          "init", "map_insert")
PREFIX = "mmloam."

_ON = False
_OFF = contextlib.nullcontext()
_LOCAL = threading.local()
_LAST = None             # the last call's `Replays`
_SETUP = None            # the last capture's set-up parts
_GATES = None            # lockstep replays, and those that ran each gate
_GATES_LOCK = threading.Lock()
_FUSION = None           # the last call's outputs and caps, or its counts
_FUSION_LOCK = threading.Lock()
_CALLS = collections.deque(maxlen=8)   # the last calls' graph launches
_CALLS_LOCK = threading.Lock()

# CUgraphNodeType: what a trace shows as a device operation, the IF node,
# and the nodes that run nothing on the device
_KERNEL, _MEMCPY, _MEMSET, _CONDITIONAL = 0, 1, 2, 13
_KINDS = {_KERNEL: "kernel", _MEMCPY: "memcpy", _MEMSET: "memset"}
_SILENT = (3, 5, 6, 7, 10, 11)   # host, empty, event wait/record, alloc/free
# the kernels of ours a layer's trace is held to by name (K4 is laid as
# any other kernel of its span)
_NAMED = ("k1", "k2", "k3")


def enable(on=True):
    """Turn spans on (or off) for the process."""
    global _ON
    _ON = bool(on)


def enabled():
    return _ON


def layer(name):
    """The span of layer `name` (one of `LEAVES`) around a `with` block."""
    if not _ON:
        return _OFF
    return _Span(name)


def _stack():
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Span:
    __slots__ = ("name", "_range")

    def __init__(self, name):
        self.name = name
        self._range = None

    def __enter__(self):
        stack = _stack()
        stack.append(self.name)
        notes = getattr(_LOCAL, "notes", None)
        if notes is not None:
            notes.append(_position(self.name))
        else:
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        stack = _stack()
        stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        else:
            notes = getattr(_LOCAL, "notes", None)
            if notes is not None:
                notes.append(_position(stack[-1] if stack else None))
        return False


@contextlib.contextmanager
def recording(notes):
    """While this thread captures, note each span's entry and exit in the
    list `notes` (as (graph, dependencies, the innermost layer from
    there on)) instead of marking it for the profiler."""
    _LOCAL.notes = notes
    try:
        yield notes
    finally:
        _LOCAL.notes = None


@functools.lru_cache(maxsize=None)
def _capture_info():
    drv = ctypes.CDLL("libcuda.so.1")
    p, ref = ctypes.c_void_p, ctypes.POINTER
    fn = drv.cuStreamGetCaptureInfo_v2
    fn.argtypes = [p, ref(ctypes.c_int), ref(ctypes.c_uint64), ref(p),
                   ref(ref(p)), ref(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    return fn


def _position(name):
    """(graph, dependencies, name): where the current stream's capture
    stands; the nodes it adds next follow `dependencies`."""
    status, ident = ctypes.c_int(), ctypes.c_uint64()
    graph, n = ctypes.c_void_p(), ctypes.c_size_t()
    deps = ctypes.POINTER(ctypes.c_void_p)()
    rc = _capture_info()(
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        ctypes.byref(status), ctypes.byref(ident), ctypes.byref(graph),
        ctypes.byref(deps), ctypes.byref(n))
    if rc != 0 or status.value != 1:        # CU_STREAM_CAPTURE_STATUS_ACTIVE
        return (None, (), name)
    return (graph.value, tuple(deps[i] for i in range(n.value)), name)


def node_layers(graphs, parents, notes):
    """Each graph's device operations in the order a replay runs them,
    with their layers: `graphs[0]` the top level, `graphs[1 + i]` the body
    of IF node i, whose enclosing body is `parents[i]` (None: the top
    level); `notes` as `recording` took them.

    Returns one list a graph, of (kind, layer, ours) for each node a trace
    shows as a device operation ("kernel", "memcpy" or "memset"; the
    innermost span's layer, None outside every span; "k1", "k2", "k3" for
    K1, K2, K3, else None, K4 included: a trace's reader names K1-K3
    only) and ("if", i, None) where IF node i sits
    (its body's operations run there where its predicate held).  A body's
    nodes outside its own spans take the layer of its IF node.  Raises
    ValueError where a graph is not a chain, a note does not sit on one,
    or a node is of a kind a trace cannot be laid against."""
    from .ops import graph_kernels

    by_graph = {}
    for graph, deps, name in notes:
        by_graph.setdefault(graph, []).append((deps, name))
    if None in by_graph:
        raise ValueError("a span noted no capture position")
    children = {}
    for i, parent in enumerate(parents):
        children.setdefault(-1 if parent is None else parent, []).append(i)
    outer = {-1: None}
    out = []
    for g, graph in enumerate(graphs):
        me = g - 1                          # -1: the top level
        nodes = graph_kernels.chain(graph)
        at = {node: k for k, (node, _, _) in enumerate(nodes)}
        marks = []
        for deps, name in by_graph.get(graph, ()):
            if len(deps) > 1:
                raise ValueError(f"graph {g}: a span sits after "
                                 f"{len(deps)} nodes")
            if deps and deps[0] not in at:
                raise ValueError(f"graph {g}: a span sits after a node "
                                 f"the graph lacks")
            marks.append((at[deps[0]] + 1 if deps else 0, name))
        marks.sort(key=lambda m: m[0])      # stable: notes keep their order
        kids = iter(children.get(me, ()))
        cur, m, ops = outer[me], 0, []
        for k, (_, kind, fname) in enumerate(nodes):
            while m < len(marks) and marks[m][0] <= k:
                cur = marks[m][1]
                m += 1
            if kind in _KINDS:
                key = None if fname is None else graph_kernels.launch_key(
                    fname)
                ours = key[0] if key and key[0] in _NAMED else None
                ops.append((_KINDS[kind], cur, ours))
            elif kind == _CONDITIONAL:
                i = next(kids, None)
                if i is None:
                    raise ValueError(f"graph {g} holds more IF nodes than "
                                     f"bodies")
                outer[i] = cur
                ops.append(("if", i, None))
            elif kind not in _SILENT:
                raise ValueError(f"graph {g} holds a node of type {kind}")
        if next(kids, None) is not None:
            raise ValueError(f"graph {g} holds fewer IF nodes than bodies")
        out.append(ops)
    return out


class Replays:
    """The clocks of one call's replay loop (see the module docstring):
    `scan()` around each scan's loop body, `launch(graph)` for its
    replay."""

    def __init__(self, runner, T):
        pool = getattr(runner, "events", None)
        if pool is None:
            pool = runner.events = []
        while len(pool) < T:
            pool.append((torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True)))
        self.events = pool
        self.n = 0
        self.host_ns = 0
        self.launch_ns = 0
        self.traced = torch._C._autograd._profiler_enabled()
        self._open = None
        self._read = None
        global _LAST
        _LAST = self

    @contextlib.contextmanager
    def scan(self):
        t0 = time.perf_counter_ns()
        self._inside = 0
        self._range("host")
        try:
            yield
        finally:
            self._range(None)
            self.host_ns += time.perf_counter_ns() - t0 - self._inside

    def launch(self, graph):
        """`graph.replay()` between this scan's timing events."""
        t0 = time.perf_counter_ns()
        start, end = self.events[self.n]
        self._range("launch")
        start.record()
        t1 = time.perf_counter_ns()
        graph.replay()
        t2 = time.perf_counter_ns()
        end.record()
        self._range("host")
        self.n += 1
        self.launch_ns += t2 - t1
        self._inside += time.perf_counter_ns() - t0

    def _range(self, part):
        """Under a profiler, end the open "mmloam.replay.<part>" range and
        open `part`'s (None: none)."""
        if not self.traced:
            return
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None
        if part is not None:
            self._open = torch.profiler.record_function(
                PREFIX + "replay." + part)
            self._open.__enter__()

    def read(self):
        """The call's numbers (see `last_call`); waits for its last
        event."""
        if self._read is None and self.n:
            first, last = self.events[0][0], self.events[self.n - 1][1]
            last.synchronize()
            busy = sum(s.elapsed_time(e) for s, e in self.events[:self.n])
            self._read = dict(
                replays=self.n, traced=self.traced,
                host_s_per_scan=self.host_ns / self.n / 1e9,
                launch_s_per_scan=self.launch_ns / self.n / 1e9,
                graph_busy_s=busy / 1e3,
                replay_span_s=first.elapsed_time(last) / 1e3)
        return self._read


def last_call():
    """The last replay call's clocks, made with spans on: `replays`, the
    host's seconds a scan outside `graph.replay()` (`host_s_per_scan`) and
    in it (`launch_s_per_scan`), the summed device time between each
    replay's events (`graph_busy_s`), the time from the first replay's
    start event to the last one's end event (`replay_span_s`), and whether
    a profiler ran (`traced`).  None before such a call.  Read it before
    the next call on the same graph, whose replays reuse the events."""
    return None if _LAST is None else _LAST.read()


def note_setup(runner):
    """Keep the set-up parts of the capture `runner` just made."""
    global _SETUP
    _SETUP = {k: getattr(runner, k, None) for k in
              ("eager_s", "census_s", "instantiate_s", "capture_s")}


def last_setup():
    """The last capture's set-up parts, seconds: scan 0's eager step
    before it (`eager_s`, the host's time; its device tail lands in the
    capture's), the node census and its check (`census_s`), the
    instantiation (`instantiate_s`) and `capture_s` (capture plus
    instantiation, as `replay._ScanGraph.capture_s`).  None before a
    capture."""
    return None if _SETUP is None else dict(_SETUP)


def count_gates(replays, runs):
    """Add a call's `replays` of a lockstep graph, and the replays in
    which each gate's body ran (`runs`, by gate name)."""
    global _GATES
    with _GATES_LOCK:
        if _GATES is None:
            _GATES = collections.Counter()
        _GATES["scans"] += replays
        _GATES.update(runs)


def gate_counts():
    """Replays of the lockstep graph since the process started (`scans`)
    and those in which each gate's body ran: `init`, the bookkeeping
    (some lane un-inited), `init_solve`, the init solve (some lane
    attempting).  None before a lockstep graph has replayed."""
    with _GATES_LOCK:
        return None if _GATES is None else dict(_GATES)


def note_launches(replays, launches):
    """Keep a call's `replays` of its scan graph and the launches of our
    kernels they made, by kernel ("k1" to "k4")."""
    with _CALLS_LOCK:
        _CALLS.append(dict(launches, scans=replays))


def call_launches():
    """The last calls' (at most 8, the oldest first) graph replays
    (`scans`) and launches of our kernels by kernel, as the graphs'
    kernel nodes and the IF bodies that ran count them."""
    with _CALLS_LOCK:
        return [dict(c) for c in _CALLS]


def note_fusion(outs, cfg):
    """Keep the outputs of a replay call (StepOutput, (T, B, ...)) that its
    fusion counts are summed from, with the stack caps of `cfg`.  No
    device work and no host read: `fusion_counts` sums them."""
    global _FUSION
    with _FUSION_LOCK:
        _FUSION = (outs.hori_merged, outs.n_corner_ds, outs.n_surf_ds,
                   cfg.scan.max_corner, cfg.scan.max_surf)


def fusion_counts():
    """The last replay call's `lane_scans`, those whose Horizon sweep was
    merged into the estimate (`hori_merged`), and the downsampled corner
    and surf points the stack caps kept (`corner_kept`, `surf_kept`) and
    dropped (`corner_dropped`, `surf_dropped`), summed over its lanes and
    scans.  None before a call.  The first read after a call waits for
    its outputs."""
    global _FUSION
    with _FUSION_LOCK:
        if isinstance(_FUSION, tuple):
            merged, n_c, n_s, cap_c, cap_s = _FUSION
            n_c, n_s = n_c.to(torch.int64), n_s.to(torch.int64)
            _FUSION = dict(
                lane_scans=merged.numel(), hori_merged=int(merged.sum()),
                corner_kept=int(n_c.clamp(max=cap_c).sum()),
                corner_dropped=int((n_c - cap_c).clamp(min=0).sum()),
                surf_kept=int(n_s.clamp(max=cap_s).sum()),
                surf_dropped=int((n_s - cap_s).clamp(min=0).sum()))
        return None if _FUSION is None else dict(_FUSION)
