"""The traced stretch of a `--trace 1` run: a few replayed steps of a job
under `torch.profiler`, before init and after, and what the per-layer
metrics read from it.

A stretch is two pieces, each one call of the cell's entry on the cached
graph: the first `pre` scans of a job from a fresh state, and `post`
scans at the job's end from the state the scans before them leave.  The
per-step numbers weigh the two pieces as the job's scans are weighed
(its share of scans before every lane is inited).  Each piece is held
against the graph's node census: the launches of K1, K2 and K3 that the
profiler recorded have to equal those the program's counters add for
the piece (the counters count replays from the graph's kernel nodes); a
piece whose trace falls short is traced again, as the profiler drops
records at times.  No trace file is written: a step holds tens of
thousands of kernels, and the events are read in memory.
"""

from __future__ import annotations

import collections
import re
import time

import torch

OURS = (("k1", re.compile(r"map_insert_kernel|map_insert_groups")),
        ("k2", re.compile(r"assoc_kernel")),
        ("k3", re.compile(r"eigh_kernel")))
TRIES = 3
CALL = "benchmark.call"          # the host span of each traced call


def ours(name):
    """"k1", "k2" or "k3" for a kernel of the port's by its name."""
    for key, pat in OURS:
        if pat.search(name):
            return key
    return None


class Piece:
    """One traced call: its wall, device operations and host ops."""

    def __init__(self, steps, wall_s, dev, host):
        self.steps = steps
        self.wall_s = wall_s
        self.host = host      # [(start_ns, end_ns, name)]
        call = [(s, e) for s, e, n in host if n == CALL]
        self.start_ns, self.end_ns = (call[0] if call else
                                      (min(d[0] for d in dev),
                                       max(d[1] for d in dev)))
        # [(start_ns, end_ns, name, is_kernel)], clipped to the call
        self.dev = [(max(s, self.start_ns), min(e, self.end_ns), n, k)
                    for s, e, n, k in dev
                    if e > self.start_ns and s < self.end_ns]

    def kernels(self):
        return [e for e in self.dev if e[3]]

    def span_s(self):
        """The call's wall on the profiler's clock."""
        return (self.end_ns - self.start_ns) / 1e9

    def busy_s(self):
        """Seconds in which any device operation ran (their union)."""
        total, end = 0, None
        for s, e, _, _ in sorted(self.dev):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e9

    def kernel_s(self, key=None):
        """Summed kernel time (of the port's kernel `key`, if given)."""
        return sum(e - s for s, e, n, k in self.dev
                   if k and (key is None or ours(n) == key)) / 1e9

    def launches(self):
        return collections.Counter(
            ours(n) for _, _, n, k in self.dev if k and ours(n))


def _events(prof):
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, t = e.start_ns(), e.end_ns()
        if t <= s:
            continue
        name = e.name()
        if name == CALL or e.is_user_annotation():
            if "CUDA" not in str(e.device_type()):
                host.append((s, t, name))
            continue            # the span's shadow on the device's row
        if "CUDA" in str(e.device_type()):
            is_kernel = not name.lower().startswith(("memcpy", "memset"))
            dev.append((s, t, name, is_kernel))
        else:
            host.append((s, t, name))
    return dev, host


def trace_call(program, state, scans, steps):
    """One call of the entry over `scans` (`steps` of them) from `state`
    under the profiler, held against the counters' launches; returns
    (Piece, final state)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(TRIES):
        torch.cuda.synchronize()
        before = program.launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function(CALL):
                final, _ = program.run(state, scans)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        after = program.launches()
        want = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        piece = Piece(steps, wall, *_events(prof))
        if dict(piece.launches()) == want:
            return piece, final
        del final
    raise RuntimeError(f"no trace of the stretch matched the graph's "
                       f"launches: traced {dict(piece.launches())}, "
                       f"counted {want}")


def stretch(program, scans_at, fresh, T, pre, post):
    """The two pieces: scans [0, pre) from `fresh`, then [T - post, T)
    after an untraced call over the scans between.  `scans_at(a, b)` gives
    the job's scans a..b-1 as the entry takes them."""
    p1, st = trace_call(program, fresh, scans_at(0, pre), pre)
    if T - post > pre:
        st, _ = program.run(st, scans_at(pre, T - post))
    p2, _ = trace_call(program, st, scans_at(T - post, T), post)
    return p1, p2


def weighted(p1, p2, share_pre, fn):
    """fn(piece) per step, the two pieces weighed as the job's scans:
    share_pre of them before init."""
    return (share_pre * fn(p1) / p1.steps
            + (1 - share_pre) * fn(p2) / p2.steps)


def gaps(piece):
    """The device's idle gaps within the call: (seconds, start_ns), the
    stretch before its first operation and after its last included."""
    out, end = [], piece.start_ns
    for s, e, _, _ in sorted(piece.dev):
        if s > end:
            out.append(((s - end) / 1e9, end))
        end = max(end, e)
    if piece.end_ns > end:
        out.append(((piece.end_ns - end) / 1e9, end))
    return out


def breakdown(pieces, top=10):
    """The device operations that took most time, and the longest idle
    gaps on the device, each named by the innermost host op running when
    it began (what the host was doing while the device waited)."""
    by_name = collections.Counter()
    idle = []
    for p in pieces:
        for s, e, n, _ in p.dev:
            by_name[n] += (e - s) / 1e9
        for dur, at in sorted(gaps(p), reverse=True)[:top]:
            idle.append((_host_during(p.host, at, at + int(dur * 1e9)), dur))
    idle.sort(key=lambda g: -g[1])
    return dict(device_ops=[[n[:160], s] for n, s in by_name.most_common(top)],
                idle_gaps=[[n[:160], s] for n, s in idle[:top]])


def _host_during(hosts, a, b):
    """The host op that overlaps the interval [a, b] the most (the call's
    own span aside): what the host was doing while the device waited."""
    best, most = "host idle", 0
    for s, e, n in hosts:
        over = min(e, b) - max(s, a)
        if n != CALL and over > most:
            best, most = n, over
    return best
