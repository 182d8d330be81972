"""Our kernels among the kernel nodes of a captured CUDA graph.

A replay of a CUDA graph launches every kernel node the graph holds, and
nothing else.  So the launches of K1 to K4 that one replay issues
are read from the captured graph itself (`launches`): its kernel nodes,
walked through libcuda (`cuGraphGetNodes`,
`cuGraphKernelNodeGetParams`), each named by its function
(`cuFuncGetName`, libcuda of CUDA 12.3 or later) and keyed as its
wrapper counts it (`launch_key`).  `count` adds replays' launches to the
wrappers' counters.  `launch_key` also reads the names the profiler gives
(demangled), so a trace is checked by the same keys.  `chain` gives a
graph's nodes in the order a replay runs them, where a single-stream
capture made the graph a chain (`spans.py` lays its layers on them).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import re

from . import assoc, damped_solve, eigh, map_insert

_NODE_KERNEL = 0                      # CUgraphNodeType of a kernel node
UNNAMED = "?"
_K1 = re.compile(r"map_insert_kernel(?:ILi|<)(n?-?\d+)")
_K2 = re.compile(r"assoc_kernel(?:ILi|<)(\d+)(?:ELi|, )(\d+)"
                 r"(?:ELb|, )(1|0|true|false)")


def launch_key(name):
    """(kernel, instance, rescue) of one of our kernels, by its function
    name, mangled or demangled, as its wrapper counts it ("k1" to "k4";
    the instance of the module's INSTANCES; whether it is a K2
    rescue launch); None for any other kernel."""
    if "map_insert_groups" in name:
        return ("k1", "groups", False)
    m = _K1.search(name)
    if m:
        cells = int(m.group(1).replace("n", "-"))
        return ("k1", "default" if cells == 32 else "rows", False)
    m = _K2.search(name)
    if m:
        stage, per = int(m.group(1)), int(m.group(2))
        if m.group(3) in ("1", "true"):
            inst = "default"
        else:
            inst = "staged" if per == 0 else f"regs{per}"
        return ("k2", inst, stage == assoc.RESCUE)
    if "eigh_kernel" in name:
        return ("k3", "default", False)
    if "lm_damped_solve_kernel" in name:
        return ("k4", "default", False)
    return None


class _KernelNodeParams(ctypes.Structure):
    # CUDA_KERNEL_NODE_PARAMS_v2, with room to spare
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p),
                ("spare", ctypes.c_char * 64)]


@functools.lru_cache(maxsize=None)
def _libcuda():
    drv = ctypes.CDLL("libcuda.so.1")
    p, ref = ctypes.c_void_p, ctypes.POINTER
    for fn, args in (
            ("cuGraphGetNodes", [p, p, ref(ctypes.c_size_t)]),
            ("cuGraphNodeGetType", [p, ref(ctypes.c_int)]),
            ("cuGraphKernelNodeGetParams_v2", [p, ref(_KernelNodeParams)]),
            ("cuKernelGetFunction", [ref(p), p]),
            ("cuFuncGetName", [ref(ctypes.c_char_p), p]),
            ("cuGraphGetEdges", [p, p, p, ref(ctypes.c_size_t)])):
        getattr(drv, fn).argtypes = args
        getattr(drv, fn).restype = ctypes.c_int
    return drv


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} failed: libcuda error {rc}")


def kernel_names(graph):
    """How many kernel nodes of each function name (mangled) the CUDA
    graph `graph` (a cudaGraph_t, as an int) holds; a node libcuda does
    not name counts as UNNAMED (a kernel of ours among them shows
    as a launch the graph lacks).  A stream capture puts every kernel
    launched on the stream in a node of its own."""
    return collections.Counter(
        name for _, kind, name in _walk(_nodes(graph))
        if kind == _NODE_KERNEL)


def _nodes(graph):
    """The nodes of `graph`, in libcuda's order."""
    drv = _libcuda()
    g, n = ctypes.c_void_p(graph), ctypes.c_size_t(0)
    _check(drv.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(drv.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    return nodes[:n.value]


def _walk(nodes):
    """(node, CUgraphNodeType, function name) of each of `nodes`; the
    name is None for a node that is not a kernel, UNNAMED for a kernel
    libcuda does not name."""
    drv = _libcuda()
    names, out = {}, []
    kind, params = ctypes.c_int(), _KernelNodeParams()
    for node in nodes:
        _check(drv.cuGraphNodeGetType(node, ctypes.byref(kind)),
               "cuGraphNodeGetType")
        name = None
        if kind.value == _NODE_KERNEL:
            if drv.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)):
                name = UNNAMED
            else:
                handle = (params.func, params.kern)
                if handle not in names:
                    names[handle] = _name(drv, params)
                name = names[handle]
        out.append((node, kind.value, name))
    return out


def chain(graph):
    """(node, CUgraphNodeType, function name) of every node of `graph` in
    the order a replay runs them.  A capture on one stream makes a chain:
    one node without a predecessor, and one edge from each node to the
    next.  Raises ValueError where the graph is not one (its order is then
    not the capture's)."""
    drv = _libcuda()
    nodes = _nodes(graph)
    g, n = ctypes.c_void_p(graph), ctypes.c_size_t(0)
    _check(drv.cuGraphGetEdges(g, None, None, ctypes.byref(n)),
           "cuGraphGetEdges")
    src = (ctypes.c_void_p * n.value)()
    dst = (ctypes.c_void_p * n.value)()
    if n.value:
        _check(drv.cuGraphGetEdges(g, src, dst, ctypes.byref(n)),
               "cuGraphGetEdges")
    nxt, has_pred = {}, set()
    for a, b in zip(src[:n.value], dst[:n.value]):
        if a in nxt or b in has_pred:
            raise ValueError(f"the graph is not a chain: a node has two "
                             f"successors or predecessors ({n.value} edges, "
                             f"{len(nodes)} nodes)")
        nxt[a] = b
        has_pred.add(b)
    roots = [x for x in nodes if x not in has_pred]
    order = []
    if nodes:
        if len(roots) != 1:
            raise ValueError(f"the graph is not a chain: {len(roots)} nodes "
                             f"without a predecessor")
        at = roots[0]
        while at is not None and len(order) <= len(nodes):
            order.append(at)
            at = nxt.get(at)
        if len(order) != len(nodes):
            raise ValueError(f"the graph is not a chain: {len(order)} of "
                             f"{len(nodes)} nodes in one line")
    return _walk(order)


def _name(drv, params):
    """A kernel node's function name, UNNAMED where libcuda gives
    none."""
    func = ctypes.c_void_p(params.func)
    if not params.func and (not params.kern or drv.cuKernelGetFunction(
            ctypes.byref(func), ctypes.c_void_p(params.kern))):
        return UNNAMED
    name = ctypes.c_char_p()
    if drv.cuFuncGetName(ctypes.byref(name), func) or not name.value:
        return UNNAMED
    return name.value.decode()


def launches(graph):
    """The launches of our kernels one replay of `graph` issues, by
    `launch_key`."""
    out = collections.Counter()
    for name, n in kernel_names(graph).items():
        key = launch_key(name)
        if key is not None:
            out[key] += n
    return out


def count(keyed, times=1):
    """Add `times` replays' launches `keyed` (by `launch_key`) to the
    wrappers' counters."""
    for (kernel, inst, rescue), n in keyed.items():
        if kernel == "k1":
            map_insert._count_launch(inst, times=n * times)
        elif kernel == "k2":
            assoc._count(inst, times=n * times, LAUNCHES=1,
                         RESCUE_LAUNCHES=int(rescue))
        elif kernel == "k3":
            eigh._count(times=n * times)
        else:
            damped_solve._count(times=n * times)
