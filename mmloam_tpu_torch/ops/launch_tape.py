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
    tape.append((launch, functools.partial(count, *args, **kwargs)))
    return True


@contextlib.contextmanager
def recording(tape):
    """Note this thread's counter updates into the list `tape`."""
    _LOCAL.tape = tape
    try:
        yield tape
    finally:
        _LOCAL.tape = None


def launches(tape):
    """The launches noted on `tape`, by key."""
    return collections.Counter(k for k, _ in tape if k is not None)


def play(tape, times=1):
    """Apply the counter updates noted on `tape` that are not launches,
    `times` over."""
    for launch, count in tape:
        if launch is None:
            count(times=times)
