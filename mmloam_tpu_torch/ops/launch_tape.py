"""Counter updates during a CUDA graph capture.

A kernel's wrapper counts a launch where it issues one (`assoc.LAUNCHES`,
`map_insert.LAUNCHES`, `eigh.LAUNCHES`).  Under a capture the wrapper runs
but launches nothing: the graph launches the kernel at each replay.  So
while its thread captures (`recording`), a count function notes its
update on the thread's tape (`note`) and counts nothing.  The graph's
runner counts each replay's launches from the kernel nodes of the graph
(`graph_kernels.launches`), and holds them against the launches the tape
noted (`launches`); the other counters (`assoc.CALLS`,
`assoc.LOCAL_CALLS`: calls of the dispatchers) it plays from the tape at
every replay (`play`).  Tapes are kept per thread, so a worker that
captures does not record another worker's counts.

A capture of the one-lane step puts branches into the bodies of
conditional nodes (`branch.py`), as a capture of the lockstep step puts
its init gates, which a replay runs or not by the data.
So each note also records the innermost body it was made in (`body`, an
index of the capture's bodies; None at the top level): the runner holds
each body's kernel nodes against its own notes, and counts a body's
launches and plays its updates as many times as its predicate held.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading

_LOCAL = threading.local()


def note(launch, count, *args, **kwargs):
    """While this thread records, note a launch (`launch`, its
    `graph_kernels.launch_key`) or, with `launch` None, the counter update
    `count(*args, **kwargs)` (which takes a keyword `times`), and return
    True: the caller then counts nothing.  Else return False."""
    tape = getattr(_LOCAL, "tape", None)
    if tape is None:
        return False
    tape.append((launch, functools.partial(count, *args, **kwargs),
                 getattr(_LOCAL, "body", None)))
    return True


@contextlib.contextmanager
def recording(tape):
    """Note this thread's counter updates into the list `tape`."""
    _LOCAL.tape = tape
    try:
        yield tape
    finally:
        _LOCAL.tape = None


@contextlib.contextmanager
def body(index):
    """Note this thread's counter updates as made in body `index`."""
    outer = getattr(_LOCAL, "body", None)
    _LOCAL.body = index
    try:
        yield
    finally:
        _LOCAL.body = outer


def launches(tape, body=None):
    """The launches noted on `tape` in `body` (None: at the top level),
    by key."""
    return collections.Counter(k for k, _, b in tape
                               if k is not None and b == body)


def play(tape, times=1, runs=None):
    """Apply the counter updates noted on `tape` that are not launches:
    those at the top level `times` over, those in body i `runs[i]` over
    (not at all when `runs` is None)."""
    for launch, count, b in tape:
        if launch is not None:
            continue
        n = times if b is None else (0 if runs is None else runs[b])
        if n:
            count(times=n)
