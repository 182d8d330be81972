"""The comparison that decides `correct`: the program's outputs for one
job of the window against the plain reference's on the same inputs.

The reference (`reference/`, a frozen plain copy of the port's eager
replay) runs after the window, once the program's graph and state are
freed: op by op on the card with TF32 off, the lockstep step for a
fleet and the one-lane step for one sequence, its state laid out densely
after each scan as the program's graph buffers hold it, from a fresh
state of its own over the job's scans (the same float32 arrays, moved by
the same shift).  It reads nothing the program made.

The numbers (`numbers`); a cell's limits file (`limits/<cell>.json`)
names those it compares, each with its limit (PERF.md gives the
readings each was set from):

* `flags`: (scan, lane) pairs whose init, fail or degenerate flag
  differs, over the whole job (an exact comparison: every scan of the
  job, the IF bodies after init, the gravity refinements, the refresh).
* `pose_m`: the largest distance between the program's and the
  reference's published position, over lanes and the scans up to
  POST_INIT scans after both have inited (the front end, the init solve,
  the first windowed solves with their marginalization, the association
  and the inserts they read).  Later, the replay amplifies last-bit
  differences into centimetres (PERF.md).
* `pose_lane_m`: the same for the median lane: the median over lanes of
  each lane's largest distance over those scans.  A lane's association
  flips on a last-bit difference now and then and its gap jumps a
  hundredfold from there; the largest over 16 lanes picks such a lane,
  the median does not, while a lower precision moves every lane.
* `assoc`, `assoc_lane`: the largest relative difference of a scan's
  association count (line and plane factors) over the same scans: over
  every lane, and the median lane's.
* `map`, `map_lane`: the relative difference of a lane's occupied cells
  in its four final maps (every insert of the job, K1): the largest, and
  the median lane's.
* `ate_m`, `ate_lane`: the difference of a lane's ATE against the ground
  truth, program against reference, over all its scans: the largest,
  and the median lane's.

The control is the reference one step of precision lower in the
program's place (`CONTROLS`): "tf32", every float32 matrix product
computed as a TF32 tensor core computes it (each operand rounded to
TF32's 10-bit mantissa, `tf32`; the products accumulate in float32) and
a float32 eigen-solver for the marginalization's float64 one.  Turning
on `allow_tf32` alone is not that: cuBLAS keeps the lockstep step's
batched products of a few rows in float32 (PERF.md).
`benchmark/readings.py` reads it; the benchmark's own runs never do.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import spec as specmod

MAP_FIELDS = ("vm_corner", "vm_surf", "vm_local_corner", "vm_local_surf")


def _tree_map(fn, *trees):
    from reference.tree import tree_map

    return tree_map(fn, *trees)


CONTROLS = ("tf32",)
POST_INIT = 4      # scans after init compared point by point
_SPLIT = 2.0 ** 13 + 1.0     # Veltkamp's constant: 24 - 13 = 11 bits kept


def tf32(x):
    """A float32 tensor's elements rounded to nearest at TF32's precision
    (11 significant bits), as a tensor core reads an operand; any other
    argument as it is.  Veltkamp's split in float32 arithmetic, so it
    holds under `torch.func`'s transforms too."""
    if not (isinstance(x, torch.Tensor) and x.dtype == torch.float32):
        return x
    c = x * _SPLIT
    hi = c - (c - x)
    return torch.where(torch.isfinite(hi), hi, x)


def _einsum(orig):
    def einsum(eq, *ops):
        if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
            ops = ops[0]
        return orig(eq, *(tf32(o) for o in ops))
    return einsum


def _product(orig):
    return lambda a, b: orig(tf32(a), tf32(b))


# (owner, name, wrapper) of every matrix product the reference calls:
# `a @ b` and `torch.einsum`
_PRODUCTS = ((torch.Tensor, "__matmul__", _product),
             (torch, "einsum", _einsum))


@contextlib.contextmanager
def precision(lower):
    """TF32 off and the float64 eigen-solver (the configuration's
    precision), or with `lower` ("tf32") every float32 product in TF32
    and a float32 solver."""
    from reference.ops import eigh

    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32, eigh.PRECISION)
    saved = [(o, n, getattr(o, n)) for o, n, _ in _PRODUCTS]
    torch.backends.cuda.matmul.allow_tf32 = bool(lower)
    torch.backends.cudnn.allow_tf32 = bool(lower)
    eigh.PRECISION = torch.float32 if lower else torch.float64
    if lower:
        for (o, n, f), (_, _, orig) in zip(_PRODUCTS, saved):
            setattr(o, n, f(orig))
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, eigh.PRECISION) = old
        for o, n, orig in saved:
            setattr(o, n, orig)


def _dense(a):
    """`a` laid out densely in row-major order, as the port's graph
    buffers hold the state between scans (a copy only where it is not):
    on the card the layout of a product's operands picks the cuBLAS
    kernel and so its rounding in the scans after."""
    want, n = [], 1
    for d in reversed(a.shape):
        want.append(n)
        n *= d
    return a if a.stride() == tuple(reversed(want)) else a.clone(
        memory_format=torch.contiguous_format)


def reference_replay(config_values, traffic, scans, device, lower=None,
                     record=None, final=None):
    """The reference over one job: scans (T, B, ...) float32 arrays (a
    dict of the ScanInput fields, the job's shift applied), B fresh lanes
    on `device`.  Returns (outputs as numpy (T, B, ...), the final maps'
    occupied cells (B, maps)).  `record`, a list, receives each scan's
    association shapes (`reference.ops.assoc.RECORD`); `final`, a
    callable, the final state before it is freed."""
    from reference import config, pipeline
    from reference.ops import assoc

    cfg = specmod.build_config(config.LIOConfig, config_values)
    one = traffic["entry"] == "replay"
    B = traffic["lanes"]
    lanes = [pipeline.init_state(cfg, device=device) for _ in range(B)]
    state = _tree_map(lambda *xs: torch.stack(xs), lanes[0], *lanes[1:])
    sc = pipeline.ScanInput(**{f: torch.as_tensor(a, device=device)
                               for f, a in scans.items()})
    step = pipeline.step_core_one if one else pipeline.step_core_batch
    outs = []
    with precision(lower):
        for t in range(sc.pts.shape[0]):
            calls = []
            assoc.RECORD = calls
            try:
                state, out, pend = step(
                    state, _tree_map(lambda a: a[t], sc), cfg)
            finally:
                assoc.RECORD = None
            state = pipeline.apply_inserts_batched(state, pend, cfg)
            state = _tree_map(_dense, state)
            if record is not None:
                record.append(calls)
            outs.append(_tree_map(lambda a: a.detach().cpu().numpy(), out))
    occ = occupancy(state)
    if final is not None:
        final(state)
    del state
    return _stack(outs), occ


def _stack(outs):
    return {f: np.stack([getattr(o, f) for o in outs])
            for f in outs[0]._fields}


def occupancy(state):
    """Occupied cells of each lane's maps (B, len(MAP_FIELDS)): cells whose
    count lane is above 0 (the count is the last quarter of a row)."""
    cols = []
    for f in MAP_FIELDS:
        cells = getattr(state, f).cells
        cpr = cells.shape[-1] // 4
        cols.append((cells[..., 3 * cpr:] > 0).sum(dim=(-2, -1)))
    return torch.stack(cols, dim=-1).cpu().numpy()


def program_outputs(outs, final):
    """The program's job as the comparison reads it: outputs (T, B, ...)
    numpy (a lane axis added for one sequence) and its maps' occupancy."""
    out = {f: getattr(outs, f).detach().cpu().numpy()
           for f in outs._fields}
    if out["pose_p"].ndim == 2:          # one sequence: (T, 3)
        out = {f: a[:, None] for f, a in out.items()}
        final = _tree_map(lambda a: a[None], final)
    return out, occupancy(final)


def ate_rmse(pose_p, t, gt_R, gt_p):
    """ATE RMSE of one lane's published positions (T, 3), each held
    against the ground truth at its own stamp t (the scan whose end it
    is, so a pose republished before init meets the scan it was made
    at), in the first ground-truth pose's frame (chip_smoke.py's `_ate`,
    the arithmetic the port's card checks report)."""
    gt_rel = np.einsum("ij,nj->ni", gt_R[0].T, gt_p - gt_p[0])
    idx = np.rint(np.asarray(t, np.float64) / 0.1).astype(int) - 1
    err = np.asarray(pose_p, np.float64) - gt_rel[np.clip(idx, 0, None)]
    return float(np.sqrt((err ** 2).sum(1).mean()))


def horizon(got, ref, post):
    """Per lane, the scans compared point by point: up to `post` scans
    after the first on which both sides are inited (every scan where a
    side never inits)."""
    both = got["inited"].astype(bool) & ref["inited"].astype(bool)
    T = both.shape[0]
    return np.where(both.any(axis=0), both.argmax(axis=0) + post, T)


def _lanes(per_lane):
    """(largest, median) over lanes of a per-lane number; both infinite
    where a lane's is not finite (a lost lane is no rounding)."""
    x = np.asarray(per_lane, np.float64)
    if not np.all(np.isfinite(x)):
        return float("inf"), float("inf")
    return float(np.max(x)), float(np.median(x))


def numbers(got, ref, gt_R, gt_p, post=POST_INIT):
    """The compared numbers of `got` (program or control) against `ref`,
    each a float (see the module docstring), and per-scan detail."""
    (o, occ), (r, occ_r) = got, ref
    T, B = o["pose_p"].shape[:2]
    flags = sum(int((o[f].astype(bool) != r[f].astype(bool)).sum())
                for f in ("inited", "fail", "degenerate"))
    h = horizon(o, r, post)
    gap = np.linalg.norm(o["pose_p"].astype(np.float64)
                         - r["pose_p"].astype(np.float64), axis=-1)
    gap = np.where(np.isfinite(gap), gap, np.inf)
    before = np.arange(T)[:, None] < h[None, :]
    ate_of = lambda x, b: ate_rmse(x["pose_p"][:, b], x["t"][:, b], gt_R[b],
                                   gt_p[b])
    ate_o = np.array([ate_of(o, b) for b in range(B)])
    ate_r = np.array([ate_of(r, b) for b in range(B)])
    cnt = lambda x: (x["n_assoc_line"].astype(np.float64)
                     + x["n_assoc_plane"].astype(np.float64))
    rel = np.abs(cnt(o) - cnt(r)) / np.maximum(cnt(r), 1.0)
    tot, tot_r = occ.sum(axis=-1), occ_r.sum(axis=-1)
    nums = dict(flags=float(flags))
    for name, lane_name, per_lane in (
            ("pose_m", "pose_lane_m", np.where(before, gap, 0.0).max(0)),
            ("assoc", "assoc_lane", np.where(before, rel, 0.0).max(0)),
            ("map", "map_lane", np.abs(tot - tot_r) / np.maximum(tot_r, 1)),
            ("ate_m", "ate_lane", np.abs(ate_o - ate_r))):
        nums[name], nums[lane_name] = _lanes(per_lane)
    detail = dict(horizon=h.tolist(), gap=gap.tolist(), assoc=rel.tolist(),
                  ate=ate_o.tolist(), ate_ref=ate_r.tolist(),
                  occ=occ.tolist(), occ_ref=occ_r.tolist())
    return nums, detail


def verdict(nums, limits):
    """(correct, [(name, number, limit)]): every number at or under its
    limit, and none missing or not finite."""
    rows = [(k, nums.get(k, float("nan")), float(v))
            for k, v in limits.items()]
    ok = all(np.isfinite(x) and x <= lim for _, x, lim in rows)
    return ok, rows
