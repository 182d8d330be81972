"""One lane's `lax.cond` and bounded `while_loop`: one branch taken, on
CPU tensors, on the card op by op, and in a captured CUDA graph.

The lockstep batch runs every branch of a per-lane conditional for every
lane and selects (`estimator.estimate.select`), as the reference's `vmap`
does.  One sequence runs as the reference's unbatched `jit(step)` runs:
each `lax.cond` takes one branch, and the LM's `while_loop` stops where
its lane is done.  `cond` and `loop` are those two at one lane (each
predicate holds one element):

* Op by op (CPU tensors, or the card outside a capture) the predicate is
  read on the host (`bool`): free on the CPU, one sync on the card.  Only
  the one-lane path reads the device so; the lockstep path and every
  graph replay read nothing.
* Under a capture (`recording`, used by `replay._ScanGraph`) each branch
  is captured into the body of a CUDA-graph IF node (`csrc/branch.cu`),
  so a replay decides on the device.  A two-way `cond` is two IF nodes,
  on pred and on ~pred, that write the same output buffers (an if/else
  node needs a CUDA 12.8 driver and runtime at both ends); an identity
  branch is one IF node on the negated predicate that copies the operand
  into the leaves the other branch changed.  Each iteration of `loop` is
  an IF node on its `live` predicate and updates the carry's buffers in
  place.

The lockstep step gates work on all its lanes at once with `any_lane`:
`fn(operand)` where a per-lane select inside `fn` keeps its result only
in the lanes of `pred`.  Op by op it runs `fn` (every lane, then the
select: no host read); under a capture it is an IF node on `pred.any()`
with the identity on the other side, so a replay skips the work where no
lane needs it.

`Bodies` keeps one capture's IF nodes: each node's predicate lands in a
slot of `flags` (zeroed at the start of a replay, so a node inside a body
that did not run reads False), each body's graph (for the kernel census)
and its enclosing body, and, per nesting depth, the stream that captures
the body and the memory pool its tensors come from.  A body may hold
kernel, copy, memset and further IF nodes, but no event, host or
allocation node: an op that records an event, forks a stream or calls
back to the host fails the capture.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from .ops import launch_tape
from .tree import tree_map

_LOCAL = threading.local()
_SOURCE = "branch.cu"


def _bind(lib):
    import ctypes

    p = ctypes.c_void_p
    lib.if_node_begin.argtypes = [p, p, p, ctypes.POINTER(ctypes.c_ulonglong)]
    lib.if_node_begin.restype = ctypes.c_int
    lib.if_node_end.argtypes = [p]
    lib.if_node_end.restype = ctypes.c_int


class Bodies:
    """The IF nodes of one capture (see the module docstring).  `flags`
    (MAX,) bool on `device`: slot i holds body i's predicate at the last
    replay; `graphs[i]` is body i's cudaGraph_t (an int), `parents[i]`
    the body that holds it (None: the top level), `names[i]` the name
    its maker gave it (None: none)."""

    MAX = 256
    DEPTH = 6

    def __init__(self, device):
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.flags = torch.zeros(self.MAX, dtype=torch.bool, device=dev)
        self.graphs = []
        self.parents = []
        self.names = []
        self._open = []
        self._levels = []
        if dev.type == "cuda":
            from . import cuda_build

            self._lib = cuda_build.load(_SOURCE, _bind)
            # made before the capture: (stream, pool) of each depth
            self._levels = [(torch.cuda.Stream(dev), torch.cuda.MemPool())
                            for _ in range(self.DEPTH)]

    def __len__(self):
        return len(self.graphs)

    @contextlib.contextmanager
    def body(self, pred, name=None):
        """Capture what the block issues into the body of an IF node on
        `pred` (a bool tensor of one element, read when the replay
        reaches the node), named `name`."""
        i = len(self.graphs)
        if i == self.MAX:
            raise RuntimeError(f"a capture holds more than {self.MAX} IF "
                               f"nodes")
        flag = self.flags[i]
        flag.copy_(pred.reshape(()))
        self.parents.append(self._open[-1] if self._open else None)
        self.graphs.append(None)
        self.names.append(name)
        self._open.append(i)
        try:
            with self._captured(flag, i), launch_tape.body(i):
                yield
        finally:
            self._open.pop()

    @contextlib.contextmanager
    def _captured(self, flag, i):
        """The IF node on `flag`: its body captures on this depth's
        stream, its tensors from this depth's pool (a pool of its own, so
        the memory a body's tensors leave is handed to no other code
        while the graph lives)."""
        import ctypes

        depth = len(self._open) - 1
        if depth >= len(self._levels):
            raise RuntimeError(f"IF nodes nest deeper than {self.DEPTH}")
        stream, pool = self._levels[depth]
        graph = ctypes.c_ulonglong()
        rc = self._lib.if_node_begin(
            torch.cuda.current_stream(self.device).cuda_stream,
            stream.cuda_stream, flag.data_ptr(), ctypes.byref(graph))
        if rc != 0:
            raise RuntimeError(f"a CUDA-graph IF node did not capture "
                               f"(if_node_begin: error {rc})")
        self.graphs[i] = graph.value
        idx = self.device.index
        try:
            with torch.cuda.stream(stream):
                torch._C._cuda_beginAllocateCurrentStreamToPool(idx, pool.id)
                try:
                    yield
                finally:
                    torch._C._cuda_endAllocateToPool(idx, pool.id)
                    torch._C._cuda_releasePool(idx, pool.id)
        finally:
            rc = self._lib.if_node_end(stream.cuda_stream)
            if rc != 0:
                raise RuntimeError(f"an IF node's body did not capture "
                                   f"(if_node_end: error {rc})")


@contextlib.contextmanager
def recording(bodies):
    """While this thread captures, put `cond`'s and `loop`'s branches into
    IF nodes kept by `bodies` (a `Bodies`; None: take them op by op)."""
    outer = getattr(_LOCAL, "bodies", None)
    _LOCAL.bodies = bodies
    try:
        yield bodies
    finally:
        _LOCAL.bodies = outer


def _recorder():
    return getattr(_LOCAL, "bodies", None)


def _check_like(a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"the branches of a cond disagree: "
                         f"{tuple(a.shape)} {a.dtype} against "
                         f"{tuple(b.shape)} {b.dtype}")


def cond(pred, true_fn, false_fn, operand, name=None):
    """`lax.cond(pred, true_fn, false_fn, operand)` at one lane: pred is a
    bool tensor of one element; None for a branch is the identity.  Both
    branches return trees of one structure, shape and dtype (the identity
    returns `operand`).  Under a capture the body of the branch that is
    not the identity is named `name`."""
    bodies = _recorder()
    if bodies is None:
        fn = true_fn if bool(pred) else false_fn
        return operand if fn is None else fn(operand)
    p = pred.reshape(())
    if true_fn is None:
        p, true_fn, false_fn = torch.logical_not(p), false_fn, None
    with bodies.body(p, name):
        a = true_fn(operand)
        if false_fn is None:
            # a leaf the branch passed on needs no buffer
            out = tree_map(lambda x, o: x if x is o else x.clone(), a,
                           operand)
        else:
            out = tree_map(torch.clone, a)
    with bodies.body(torch.logical_not(p)):
        b = operand if false_fn is None else false_fn(operand)

        def put(o, x):
            _check_like(o, x)
            if o is not x:
                o.copy_(x)
        tree_map(put, out, b)
    return out


def any_lane(pred, fn, operand, name=None):
    """`fn(operand)`, where `fn` keeps its work only in the lanes of
    `pred` (B,) bool and returns `operand`'s bits in every other lane.
    Op by op `fn` runs for every lane (its select decides, nothing is
    read on the host); under a capture it is the body of an IF node on
    `pred.any()`, named `name`, and `operand` passes on where no lane
    holds."""
    if _recorder() is None:
        return fn(operand)
    return cond(torch.any(pred), fn, None, operand, name=name)


def _store(dst, src):
    """Copy tree `src` into the buffers of tree `dst` (a leaf that is its
    own buffer is skipped; one that shares memory with a buffer is cloned
    first, so no copy reads a buffer another has written)."""
    owned = set()
    tree_map(lambda d: owned.add(d.untyped_storage().data_ptr()), dst)
    pairs = []

    def collect(d, s):
        _check_like(d, s)
        if s is d:
            return
        if s.untyped_storage().data_ptr() in owned:
            s = s.clone()
        pairs.append((d, s))

    tree_map(collect, dst, src)
    for d, s in pairs:
        d.copy_(s)


def loop(n, live_fn, body_fn, carry):
    """A `while_loop` at one lane bounded by n iterations: for it in
    range(n), while `live = live_fn(it, carry)` (a bool tensor of one
    element) holds, `carry = body_fn(it, live, carry)`.  `live` must stay
    False once it is False (the loop breaks there op by op; under a
    capture every iteration is an IF node on its own `live`)."""
    bodies = _recorder()
    if bodies is None:
        for it in range(n):
            live = live_fn(it, carry)
            if not bool(live):
                break
            carry = body_fn(it, live, carry)
        return carry
    carry = tree_map(torch.clone, carry)
    for it in range(n):
        live = live_fn(it, carry)
        with bodies.body(live):
            _store(carry, body_fn(it, live, carry))
    return carry
