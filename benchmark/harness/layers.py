"""A step's device time by layer: a traced call's device operations laid
against the layers the program's spans gave its graph's nodes
(`mmloam_tpu_torch.spans`; the runner's `node_layers`), and the set-up's
parts and the replay loop's clocks the program keeps.

A replay of the graph runs its nodes in the order `node_layers` lists
them, an IF node's body where its predicate held at that replay (the
call's `flag_history`).  The profiler ties each operation a graph launch
ran to the launch's `cudaGraphLaunch` by its correlation id; an
operation it gives no id (a copy inside an IF node's body, at times) is
given to the launch whose operations surround it.  Each replay's
operations, in the order they ran, are held against the expected
sequence: as many, kernels where kernels are expected, and each of the
port's kernels (`trace.ours`) where the graph holds that kernel (so K1,
K2 and K3 sit in `map_insert`, `association` and `estimator`).
Operations outside every launch (the call's copies in and out, its
state copies) are `replay_io`; graph nodes outside every span are
`step_rest`.  Where a check fails nothing is laid (`Unlaid` says why).

Only kernels are summed, as `kernels_per_step` and `device_ms_per_step`
count them, so the eight layers' kernels and times add up to those.

Nothing here reads a value where the program keeps none: a program
without spans gives `None` throughout.
"""

from __future__ import annotations

import collections

from . import trace

REST, IO = "step_rest", "replay_io"
GRAPH_LAUNCH = "cudaGraphLaunch"


class Unlaid(Exception):
    """A traced call that cannot be laid against the graph's layers."""


def spans_module():
    """The program's `spans` module, None where the program has none."""
    try:
        from mmloam_tpu_torch import spans
    except ImportError:
        return None
    return spans


def setup_part(ctx, key):
    """Set-up part `key` of the capture the warm-up made, seconds
    (`spans.last_setup()`); None where the program keeps none, or where
    its last capture is not the one whose `capture_s` the run read."""
    spans = spans_module()
    parts = None if spans is None else spans.last_setup()
    if not parts or parts.get("capture_s") != ctx.capture_s:
        return None
    return parts.get(key)


def leaves():
    """The layers a step's kernels are laid in: the program's leaf spans,
    then the graph's nodes outside them, then the call's copies."""
    spans = spans_module()
    return (() if spans is None else tuple(spans.LEAVES)) + (REST, IO)


def events(prof):
    """The traced call's device operations, (start_ns, end_ns, name,
    is_kernel, correlation), and its graph launches, (start_ns,
    correlation), from `torch.profiler`'s events."""
    ops, launches = [], []
    for e in prof.profiler.kineto_results.events():
        s, t = e.start_ns(), e.end_ns()
        name = e.name()
        cuda = "CUDA" in str(e.device_type())
        if e.is_user_annotation() or name == trace.CALL:
            continue
        if cuda and t > s:
            is_kernel = not name.lower().startswith(("memcpy", "memset"))
            ops.append((s, t, name, is_kernel, e.correlation_id()))
        elif not cuda and GRAPH_LAUNCH in name:
            launches.append((s, e.correlation_id()))
    return ops, launches


def expand(node_layers, flags, graph=0):
    """The (kind, layer, ours) of each operation one replay runs, in
    order: graph `graph`'s (0 the top level, 1 + i body i), each IF node's
    body in its place where `flags[i]` held."""
    out = []
    for kind, what, ours in node_layers[graph]:
        if kind == "if":
            if flags is None or what >= len(flags):
                raise Unlaid(f"IF node {what} has no predicate")
            if flags[what]:
                out.extend(expand(node_layers, flags, 1 + what))
        else:
            out.append((kind, what, ours))
    return out


def replays(ops, launches):
    """The operations of each graph launch, in launch order, each in the
    order they ran, and the operations outside every launch."""
    ids = {c: i for i, (_, c) in enumerate(sorted(launches))}
    groups = [[] for _ in ids]
    loose = []
    for op in ops:
        i = ids.get(op[4])
        (loose if i is None else groups[i]).append(op)
    bounds = [(min(o[0] for o in g), max(o[1] for o in g)) if g else None
              for g in groups]
    outside = []
    for op in loose:
        home = [i for i, b in enumerate(bounds)
                if b is not None and b[0] <= op[0] < b[1]]
        (groups[home[0]] if len(home) == 1 else outside).append(op)
    return [sorted(g) for g in groups], outside


def lay(ops, launches, node_layers, history):
    """{layer: [kernel seconds, kernels]} of one traced call: `history`
    the call's flag history (a row of IF-node predicates a replay; None
    without IF nodes).  Raises Unlaid where a replay's operations do not
    match the graph's."""
    if node_layers is None:
        raise Unlaid("the program laid no layers on its graph")
    groups, outside = replays(ops, launches)
    if history is not None and len(history) != len(groups):
        raise Unlaid(f"{len(groups)} graph launches traced, "
                     f"{len(history)} replays' predicates")
    out = collections.defaultdict(lambda: [0.0, 0])
    for r, got in enumerate(groups):
        want = expand(node_layers, None if history is None else history[r])
        if len(got) != len(want):
            raise Unlaid(f"replay {r}: {len(got)} operations traced, "
                         f"{len(want)} in the graph")
        for (s, t, name, is_kernel, _), (kind, layer, ours) in zip(got,
                                                                   want):
            if is_kernel != (kind == "kernel") or (
                    is_kernel and trace.ours(name) != ours):
                raise Unlaid(f"replay {r}: {name[:60]!r} where the graph "
                             f"holds a {kind} ({ours or 'not ours'})")
            if is_kernel:
                acc = out[layer or REST]
                acc[0] += (t - s) / 1e9
                acc[1] += 1
    for s, t, _, is_kernel, _ in outside:
        if is_kernel:
            out[IO][0] += (t - s) / 1e9
            out[IO][1] += 1
    return dict(out)


def idle_pct(clocks):
    """100 x (1 - graph busy / replay span) of a call's clocks
    (`spans.last_call()`); None without them."""
    if not clocks or clocks.get("traced") or not clocks["replay_span_s"]:
        return None
    return 100.0 * (1.0 - clocks["graph_busy_s"] / clocks["replay_span_s"])
