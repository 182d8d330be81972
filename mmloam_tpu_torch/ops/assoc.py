"""Fused stencil association (kernel K2): k-nearest selection, moments and
the closed-form line / plane fit of each query against one voxel map, and
the local-map rescue of the queries the persistent map failed.

Port of the archived Pallas kernel scripts/pallas_assoc.py
(`_assoc_pallas` -> `_assoc_kernel`).  It follows the port's production
path, not the archived f32-only variant: with `MapConfig.dense_bf16` the
candidate offsets and squared distances are rounded to bf16 before the
selection (`voxelmap.query_candidates_dense`), the cached entry
re-expresses the round-0 candidate blocks at moved queries
(`voxelmap.shift_dense_blocks`), and the fit uses ops/linalg3's formulas.

`associate` launches `csrc/assoc.cu` on CUDA tensors (counted in
LAUNCHES; raises if the kernel cannot be built or launched) and takes
`associate_reference`, the plain torch composition, on CPU tensors.
`associate_with_rescue` adds factors' local-map rescue: on CUDA tensors
two launches (NEED against the persistent map, RESCUE against the local
map, counted in RESCUE_LAUNCHES) with no torch op between them unless
the local map dedups, on CPU tensors `associate_with_rescue_reference`.
The kernel computes each query's stencil addressing itself from pw;
`voxelmap.stencil_addresses` is the plain version's.  CALLS counts calls
of the two dispatchers and LOCAL_CALLS those given a local map, so a run
on CUDA tensors that went through the kernel every time shows LAUNCHES ==
CALLS + RESCUE_LAUNCHES and RESCUE_LAUNCHES == LOCAL_CALLS (the
non-feature association has no local map and launches no rescue).

Every map geometry runs: any superrow pack and stencil (S window rows of
cpr cells, C = S cpr candidates a query, up to 32 x MAX_PER_LANE;
`kernel_supports`), each launch carrying its own map's geometry (the
local map's may differ), and `MapConfig.dedup_gather`: a fresh launch
takes one device scalar, `voxelmap.dedup_threshold` of the rows its query
set ranks (every query of the call, masked or not; for a rescue whose cap
binds, the NEED launch's first rescue_cap flags and the pad rows, as the
reference compacts them), computed by torch on the device between the
launches.  The cached entry carries the fresh call's validity, as the
reference does.

The kernel has a compile-time stage and stops after it, writing that
stage's result (`run_stage`; `stage_reference` is the same cut of the
plain version).  The stages are the Mosaic lowering probes of
scripts/bisect_mosaic.py and bisect_mosaic2.py, kept as device tests:

  GATHER   the (M, S, 4 cpr) stencil rows read and the addresses the
           kernel computed: v (M, 3), sv (M, S, 3), slot (M, S), key (M, S),
           and keep (M, S), the rows the dedup gather kept (fresh entry
           only)
  SELECT   t_k, n
  MOMENTS  + s1 (M, 3), s2 (M, 3, 3)
  EIG      evals (M, 3) ascending, vec (M, 3)
  OUT      mu, vec, valid, t_k, n (what `associate` returns)
  NEED     OUT + the rescue flag mask & ~valid and its count

RESCUE, the second launch of a rescue pair, is not a cut: `run_rescue`
returns the merged records with the flags and which map served each
query, and `compare_rescue` holds them against the two maps' plain
versions.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from .. import lie
from . import linalg3, voxelmap

_SOURCE = "assoc.cu"
PLANE, LINE = 0, 1                 # mode numbers of the archived kernel
GATHER, SELECT, MOMENTS, EIG, OUT, NEED, RESCUE = range(7)
STAGE_NAMES = ("GATHER", "SELECT", "MOMENTS", "EIG", "OUT", "NEED")
_REC = 16                          # floats per query in the kernel's output
# the most candidates one lane of the kernel holds (its largest instance):
# up to 32 x MAX_PER_LANE = 512 candidates a query
MAX_PER_LANE = 16

# kernel launches made by the wrapper (counted where it launches, nowhere
# else), the second launches of rescue pairs among them, calls of
# `associate` and `associate_with_rescue`, and the calls among them given a
# local map; callers reset all four to 0 to check a run.  Workers of a
# split replay call from several threads, so counts are taken under a lock
# (`_count`).
LAUNCHES = 0
RESCUE_LAUNCHES = 0
CALLS = 0
LOCAL_CALLS = 0
_COUNT_LOCK = threading.Lock()


def _count(**deltas):
    """Add `deltas` to the module's counters, atomically."""
    with _COUNT_LOCK:
        g = globals()
        for name, d in deltas.items():
            g[name] += d


def window_rows(mcfg):
    """S, the superrows of one query's stencil window."""
    nbx, nby, nbz = voxelmap._super_window(mcfg)
    return nbx * nby * nbz


def n_candidates(mcfg):
    """C = S cpr, the candidates of one query (the dense blocks' width)."""
    return window_rows(mcfg) * voxelmap._cpr(mcfg)


def kernel_supports(mcfg):
    """Whether K2 has an instance for this map's window: at most
    32 x MAX_PER_LANE candidates a query.  On CUDA tensors the wrapper
    raises NotImplementedError naming the limit otherwise; the plain
    version takes any window."""
    return n_candidates(mcfg) <= 32 * MAX_PER_LANE


class StackBlocks(NamedTuple):
    """One stack's persistent-map dense candidate blocks, cached for
    gather-free re-association across outer rounds."""

    pw0: torch.Tensor   # (M,3) f32 query positions at gather time
    dxd: torch.Tensor   # (M,C) storage dtype
    dyd: torch.Tensor
    dzd: torch.Tensor
    d2d: torch.Tensor   # +inf at invalid lanes


class Assoc(NamedTuple):
    """Per-query association result against one map."""

    mu: torch.Tensor     # (M,3) mean offset of the selected centroids
    vec: torch.Tensor    # (M,3) plane normal / line direction (unit)
    valid: torch.Tensor  # (M,) bool: every gate passed
    t_k: torch.Tensor    # (M,) k-th smallest squared distance (inf: < k)
    n: torch.Tensor      # (M,) number of selected candidates


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------

def _neighbor_moments(vm, pw, mask, mcfg, knn, cached: StackBlocks = None):
    """k-nearest selection + first/second moments of (centroid - query)
    over the dense candidate blocks.  Returns (t_k, n, s1 (M,3),
    s2 (M,3,3), blk = (dxf, dyf, dzf, wf), blocks)."""
    if cached is None:
        dxd, dyd, dzd, d2d = voxelmap.query_candidates_dense(vm, pw, mask,
                                                             mcfg)
        blocks = StackBlocks(pw, dxd, dyd, dzd, d2d)
    else:
        dxd, dyd, dzd, d2d = voxelmap.shift_dense_blocks(
            (cached.dxd, cached.dyd, cached.dzd, cached.d2d),
            pw - cached.pw0, mcfg)
        blocks = cached
    t_k = voxelmap.kth_smallest_dense(d2d, knn)
    wf = (d2d <= t_k[:, None]).to(pw.dtype)
    dxf, dyf, dzf = (a.to(pw.dtype) for a in (dxd, dyd, dzd))
    red = lambda a: torch.sum(a, dim=1)
    wx, wy, wz = dxf * wf, dyf * wf, dzf * wf
    s1 = torch.stack([red(wx), red(wy), red(wz)], dim=-1)
    sxx, syy, szz = red(wx * dxf), red(wy * dyf), red(wz * dzf)
    sxy, sxz, syz = red(wx * dyf), red(wx * dzf), red(wy * dzf)
    s2 = torch.stack([
        torch.stack([sxx, sxy, sxz], dim=-1),
        torch.stack([sxy, syy, syz], dim=-1),
        torch.stack([sxz, syz, szz], dim=-1)], dim=-2)
    n = red(wf)
    return t_k.to(pw.dtype), n, s1, s2, (dxf, dyf, dzf, wf), blocks


def _line_fit(pw, mask, t_k, n, s1, s2, thres_dist, k):
    """PCA line fit + gates (Estimator.cpp:189-277).  Returns (Assoc,
    eigenvalues, [(gate quantity, threshold), ...])."""
    have5 = (n >= k) & (t_k < thres_dist)
    nf = torch.clamp(n, min=1).to(pw.dtype)
    mu = s1 / nf[:, None]
    cov = s2 / nf[:, None, None] - mu[:, None, :] * mu[:, :, None]
    evals = linalg3.eigvalsh3(cov)
    u = linalg3.principal_eigvec3(cov, evals)
    line_like = evals[:, 2] > 3.0 * evals[:, 1]
    err0 = torch.sqrt(torch.sum(lie.cross(-mu, u) ** 2, dim=-1))
    valid = mask & have5 & line_like & (err0 > 1e-5)
    return (Assoc(mu, u, valid, t_k, n), evals,
            [(evals[:, 2], 3.0 * evals[:, 1]), (err0, 1e-5)])


def _plane_fit(pw, mask, t_k, n, s1, s2, blk, thres_dist, k, scatter_ratio):
    """Total-LS plane fit + gates (Estimator.cpp:617-696).  Returns (Assoc,
    scatter eigenvalues, [(gate quantity, threshold), ...])."""
    have5 = (n >= k) & (t_k < thres_dist)
    nf = torch.clamp(n, min=1).to(pw.dtype)
    mu = s1 / nf[:, None]
    scov = s2 - nf[:, None, None] * mu[:, None, :] * mu[:, :, None]
    sev = linalg3.eigvalsh3(scov)
    omega = linalg3.smallest_eigvec3(scov, sev)
    dist = -torch.sum(omega * mu, dim=-1)
    dxd, dyd, dzd, wf = blk
    dev = wf * (dxd * omega[:, 0, None] + dyd * omega[:, 1, None]
                + dzd * omega[:, 2, None] + dist[:, None])
    max_dev = torch.amax(torch.abs(dev), dim=1)
    planar = max_dev <= 0.2
    err0 = torch.abs(dist)
    gates = [(max_dev, 0.2), (err0, 1e-5)]
    if scatter_ratio > 0:
        planar = planar & (sev[:, 1] > scatter_ratio * sev[:, 2])
        gates.append((sev[:, 1], scatter_ratio * sev[:, 2]))
    valid = mask & have5 & planar & (err0 > 1e-5)
    return Assoc(mu, omega, valid, t_k, n), sev, gates


def _fit(mode, pw, mask, t_k, n, s1, s2, blk, thres_dist, k, scatter_ratio):
    if mode == LINE:
        return _line_fit(pw, mask, t_k, n, s1, s2, thres_dist, k)
    return _plane_fit(pw, mask, t_k, n, s1, s2, blk, thres_dist, k,
                      scatter_ratio)


def associate_reference(vm, pw, mask, mcfg, k, mode, thres_dist,
                        scatter_ratio=0.0, cached: StackBlocks = None):
    """Plain PyTorch version of the kernel on any device: returns
    (Assoc, StackBlocks of the persistent-map candidate blocks)."""
    t_k, n, s1, s2, blk, blocks = _neighbor_moments(vm, pw, mask, mcfg, k,
                                                    cached)
    fit = _fit(mode, pw, mask, t_k, n, s1, s2, blk, thres_dist, k,
               scatter_ratio)
    return fit[0], blocks


def stage_reference(stage, vm, pw, mask, mcfg, k, mode, thres_dist,
                    scatter_ratio=0.0, cached: StackBlocks = None):
    """The plain version cut after `stage`, as a dict keyed like
    `run_stage`'s result.  OUT and NEED also carry `gates`, the
    (quantity, threshold) pairs of the fit's gates (see `near_threshold`)."""
    if stage == GATHER:
        addr = voxelmap.stencil_addresses(pw, mcfg)
        rows, keep = voxelmap.gather_rows(vm, addr.slot, mcfg)
        if keep is None:
            keep = torch.ones(addr.slot.shape, dtype=torch.bool,
                              device=pw.device)
        return dict(rows=rows, keep=keep, **addr._asdict())
    t_k, n, s1, s2, blk, _ = _neighbor_moments(vm, pw, mask, mcfg, k, cached)
    if stage == SELECT:
        return dict(t_k=t_k, n=n)
    if stage == MOMENTS:
        return dict(t_k=t_k, n=n, s1=s1, s2=s2)
    r, evals, gates = _fit(mode, pw, mask, t_k, n, s1, s2, blk, thres_dist,
                           k, scatter_ratio)
    if stage == EIG:
        return dict(evals=evals, vec=r.vec)
    out = dict(r._asdict(), gates=gates, evals=evals)
    if stage == NEED:
        need = mask & ~r.valid
        out.update(need=need, need_count=torch.sum(need.to(torch.int32)))
    return out


def near_threshold(gates, eps):
    """Queries whose gate quantity lies within relative `eps` of its
    threshold, where the order of the moment sums may decide the gate."""
    near = None
    for qty, thr in gates:
        thr = torch.as_tensor(thr, dtype=qty.dtype, device=qty.device)
        scale = torch.maximum(torch.abs(qty), torch.abs(thr))
        m = torch.abs(qty - thr) <= eps * scale
        near = m if near is None else near | m
    return near


# The kernel against its plain version.  Selection is bit-equal (d2 and
# its bf16 rounding are computed in the same order with -fmad=false); the
# moment sums are warp trees, not torch.sum's order, so the float outputs
# agree to these bounds, set from f32 sums of <= 256 terms of offsets
# <= 2 m (s2 terms <= 4 m^2):
MOMENT_ATOL = 1e-4     # s1, s2 entries
MU_ATOL = 1e-5         # mean offset (m)
EVAL_ATOL = 1e-3       # eigenvalues, relative to the largest |eigenvalue|:
#                        acos amplifies a last-bit change of r near +-1 by
#                        1 / sqrt(1 - r^2)
VEC_ATOL = 1e-3        # unit fit direction, up to sign, where the gap
GAP_MIN = 1e-2         # of the fitted eigenvalue is > GAP_MIN x largest
GATE_EPS = 1e-3        # relative margin within which a gate may flip


def _sign_err(got, want):
    """Per-row distance of unit vectors up to sign."""
    return torch.minimum(torch.linalg.vector_norm(got - want, dim=-1),
                         torch.linalg.vector_norm(got + want, dim=-1))


def _gap_clear(evals, mode):
    """Queries whose fitted eigenvector is well separated."""
    top = torch.clamp(torch.amax(torch.abs(evals), dim=-1), min=1e-30)
    gap = (evals[:, 2] - evals[:, 1] if mode == LINE
           else evals[:, 1] - evals[:, 0])
    return gap > GAP_MIN * top


def compare(stage, got, ref, mask, mode):
    """Hold a kernel stage's result against the same cut of the plain
    version (`run_stage` vs `stage_reference`, both on the card) at the
    bounds above.  Raises AssertionError on a disagreement; returns
    {"max_abs_err": ..., "near": queries excused from the gate check}."""
    def fail(what):
        raise AssertionError(f"K2 {STAGE_NAMES[stage]}: {what}")

    m = mask
    stats = dict(max_abs_err=0.0, near=0)

    def close(name, a, b, atol):
        err = float(torch.nan_to_num(torch.abs(a - b), nan=float("inf"))
                    .max()) if a.numel() else 0.0
        if not err <= atol:
            fail(f"{name} differs by {err} > {atol}")
        stats["max_abs_err"] = max(stats["max_abs_err"], err)

    if stage == GATHER:
        for name in ("v", "sv", "slot", "key"):
            if not torch.equal(got[name], ref[name]):
                fail(f"{name} differs from voxelmap.stencil_addresses")
        if not torch.equal(got["rows"], ref["rows"]):
            fail("rows read differ from the plain gather's")
        if not torch.equal(got["keep"], ref["keep"]):
            fail("rows kept differ from the plain dedup gather's")
        stats["dropped"] = int((~ref["keep"]).sum())
        return stats
    if stage in (SELECT, MOMENTS, OUT, NEED):
        for name in ("t_k", "n"):
            if not torch.equal(got[name][m], ref[name][m]):
                fail(f"{name} not bit-equal")
    if stage == MOMENTS:
        close("s1", got["s1"][m], ref["s1"][m], MOMENT_ATOL)
        close("s2", got["s2"][m], ref["s2"][m], MOMENT_ATOL)
    if stage == EIG:
        top = torch.clamp(torch.amax(torch.abs(ref["evals"][m]), dim=-1,
                                     keepdim=True), min=1.0)
        close("evals / scale", got["evals"][m] / top,
              ref["evals"][m] / top, EVAL_ATOL)
        sel = m & _gap_clear(ref["evals"], mode)
        close("vec", _sign_err(got["vec"][sel], ref["vec"][sel]),
              torch.zeros(()), VEC_ATOL)
    if stage in (OUT, NEED):
        close("mu", got["mu"][m], ref["mu"][m], MU_ATOL)
        both = got["valid"] & ref["valid"] & _gap_clear(ref["evals"], mode)
        close("vec", _sign_err(got["vec"][both], ref["vec"][both]),
              torch.zeros(()), VEC_ATOL)
        near = near_threshold(ref["gates"], GATE_EPS) & m
        differ = got["valid"] != ref["valid"]
        if bool((differ & ~near).any()):
            fail(f"valid differs at {int((differ & ~near).sum())} queries "
                 "away from any gate threshold")
        stats["near"] = int((differ & near).sum())
    if stage == NEED:
        need = got["need"]
        if not torch.equal(need, mask & ~got["valid"]):
            fail("flags are not mask & ~valid of the same launch")
        if int(got["need_count"]) != int(need.sum()):
            fail("flag count differs from the flags")
        if bool(((need != ref["need"]) & ~near).any()):
            fail("flags differ from the plain version away from a gate")
    return stats


# --------------------------------------------------------------------------
# the local-map rescue, plain version
# --------------------------------------------------------------------------

def _compact_indices(fail, Mr):
    """Indices of the first Mr True entries of `fail` (M,), padded with M."""
    M = fail.shape[0]
    dev = fail.device
    pos = torch.cumsum(fail.to(torch.int32), dim=0) - 1
    dst = torch.where(fail & (pos < Mr), pos, torch.full_like(pos, Mr))
    sel = torch.full((Mr + 1,), M, dtype=torch.int32, device=dev)
    sel = sel.index_put((dst.to(torch.int64),),
                        torch.arange(M, dtype=torch.int32, device=dev))
    return sel[:Mr]


def _take_fill(a, idx):
    """a[idx] with out-of-range idx (== len(a)) reading zeros."""
    pad = torch.zeros((1,) + tuple(a.shape[1:]), dtype=a.dtype,
                      device=a.device)
    return torch.cat([a, pad])[idx.to(torch.int64)]


def _set_drop(a, idx, vals):
    """a.at[idx].set(vals, mode="drop") with idx == len(a) dropped."""
    pad = torch.zeros((1,) + tuple(a.shape[1:]), dtype=a.dtype,
                      device=a.device)
    out = torch.cat([a, pad]).index_put((idx.to(torch.int64),),
                                        vals.to(a.dtype))
    return out[:-1]


def associate_with_rescue_reference(vm, vm_local, pw, mask, mcfg, lcfg, k,
                                    mode, thres_dist, scatter_ratio,
                                    rescue_cap, cached: StackBlocks = None,
                                    want_blocks=False):
    """Plain version of `associate_with_rescue` on any device, factors'
    composition as the reference runs it: associate against the persistent
    map; compact the first `rescue_cap` failed queries (mask & ~valid, in
    index order), associate them against the local map, and scatter back
    those valid there (every failed query is tried when rescue_cap >= M).
    Returns (Assoc merged, StackBlocks of the persistent map or None)."""
    r, blocks = associate_reference(vm, pw, mask, mcfg, k, mode, thres_dist,
                                    scatter_ratio, cached)
    blocks = blocks if want_blocks or cached is not None else None
    if vm_local is None:
        return r, blocks
    M = pw.shape[0]
    if rescue_cap >= M:
        r2, _ = associate_reference(vm_local, pw, mask, lcfg, k, mode,
                                    thres_dist, scatter_ratio)
        use2 = ~r.valid & r2.valid
        pick = lambda a, b: torch.where(
            use2.reshape((M,) + (1,) * (a.dim() - 1)), b, a)
        return Assoc(*map(pick, r, r2)), blocks
    sel = _compact_indices(mask & ~r.valid, rescue_cap)
    r2, _ = associate_reference(vm_local, _take_fill(pw, sel), sel < M, lcfg,
                                k, mode, thres_dist, scatter_ratio)
    sel_ok = torch.where(r2.valid, sel, torch.full_like(sel, M))
    return Assoc(*(_set_drop(a, sel_ok, b) for a, b in zip(r, r2))), blocks


def _tried(need, rescue_cap):
    """Flagged queries whose rank among the flags below them is under the
    cap: the ones the rescue associates against the local map."""
    rank = torch.cumsum(need.to(torch.int32), dim=0) - need.to(torch.int32)
    return need & (rank < rescue_cap)


def _merge(first, second, use2):
    """Per-query `second` where use2, else `first` (dicts of stage results;
    gate lists merged pair by pair)."""
    out = {}
    for name, a in first.items():
        b = second.get(name)
        if name == "gates":
            out[name] = []
            for (qa, ta), (qb, tb) in zip(a, b):
                t = lambda x: torch.as_tensor(x, dtype=qa.dtype,
                                              device=qa.device).expand_as(qa)
                out[name].append((torch.where(use2, qb, qa),
                                  torch.where(use2, t(tb), t(ta))))
        elif b is not None and torch.is_tensor(a) and a.dim() >= 1:
            out[name] = torch.where(
                use2.reshape((-1,) + (1,) * (a.dim() - 1)), b, a)
    return out


def _rescue_queries(pw, need, rescue_cap):
    """The rescue's query set as the reference compacts it (rescue_cap <
    M): the first rescue_cap flagged queries, pads at the origin.  Returns
    (sel, pw_r)."""
    sel = _compact_indices(need, rescue_cap)
    return sel, _take_fill(pw, sel)


def rescue_stage_reference(vm, vm_local, pw, mask, mcfg, lcfg, k, mode,
                           thres_dist, scatter_ratio=0.0,
                           cached: StackBlocks = None, rescue_cap=None,
                           need=None):
    """The plain cuts a rescue pair is held against: NEED on the persistent
    map and OUT on the local map, each over every query (each query's
    association is independent of the others).  Under the local map's
    dedup_gather the rows of the rescue's whole query set rank together,
    so with rescue_cap < M the local cut of the queries it tries comes
    from the reference's compacted call (`_rescue_queries`) over the
    flags `need` (the NEED cut's own when None)."""
    first = stage_reference(NEED, vm, pw, mask, mcfg, k, mode, thres_dist,
                            scatter_ratio, cached)
    second = stage_reference(OUT, vm_local, pw, mask, lcfg, k, mode,
                             thres_dist, scatter_ratio)
    M = pw.shape[0]
    if lcfg.dedup_gather and rescue_cap is not None and rescue_cap < M:
        sel, pw_r = _rescue_queries(
            pw, first["need"] if need is None else need, rescue_cap)
        part = stage_reference(OUT, vm_local, pw_r, sel < M, lcfg, k, mode,
                               thres_dist, scatter_ratio)
        second = _scatter_cut(second, part, sel)
    return first, second


def _scatter_cut(full, part, sel):
    """`full` (a stage result over M queries) with the rows of `part` (over
    the compacted queries `sel`, M = pad) written at sel."""
    out = {}
    for name, a in full.items():
        b = part[name]
        if name == "gates":
            out[name] = []
            for (qa, ta), (qb, tb) in zip(a, b):
                t = lambda x, like: torch.as_tensor(
                    x, dtype=like.dtype, device=like.device).expand_as(like)
                out[name].append((_set_drop(qa, sel, qb),
                                  _set_drop(t(ta, qa), sel, t(tb, qb))))
        else:
            out[name] = _set_drop(a, sel, b)
    return out


def compare_rescue(got, refs, mask, mode, rescue_cap):
    """Hold a rescue pair (`run_rescue`) against `rescue_stage_reference`.
    The kernel's own flags rank the queries, so a flag that differs from
    the plain version's (allowed only near a gate) moves no other query's
    rescue.  Raises AssertionError; returns `compare`'s stats plus the
    numbers of flagged and served queries."""
    def fail(what):
        raise AssertionError(f"K2 RESCUE: {what}")

    first, second = refs
    need, served = got["need"], got["served"]
    near1 = near_threshold(first["gates"], GATE_EPS) & mask
    if bool(((need != first["need"]) & ~near1).any()):
        fail("flags differ from the plain version away from a gate")
    tried = _tried(need, rescue_cap)
    if bool((served & ~tried).any()):
        fail("a query outside the ranked flags was served by the local map")
    if not torch.equal(got["valid"], (mask & ~need) | served):
        fail("valid is not the first map's outside the flags, served in them")
    near2 = near_threshold(second["gates"], GATE_EPS) & tried
    if bool(((served != (tried & second["valid"])) & ~near2).any()):
        fail("served differs from the local map's plain fit away from a gate")
    stats = compare(OUT, got, _merge(first, second, served), mask, mode)
    stats.update(flagged=int(need.sum()), served=int(served.sum()))
    return stats


# --------------------------------------------------------------------------
# kernel
# --------------------------------------------------------------------------

_ARGS_CLS = []


def _args_struct():
    """ctypes mirror of `AssocArgs` in csrc/assoc.cu (field for field)."""
    if not _ARGS_CLS:
        import ctypes

        p = ctypes.c_void_p
        i = ctypes.c_int

        class AssocArgs(ctypes.Structure):
            _fields_ = [
                ("cells", p), ("pw", p), ("mask", p), ("blk_in", p * 4),
                ("pw0", p), ("blk_out", p * 4), ("thres", p), ("out", p),
                ("valid", p), ("rows", p), ("g_v", p), ("g_sv", p),
                ("g_slot", p), ("g_key", p), ("need", p), ("need_count", p),
                ("dedup_thr", p), ("g_keep", p),
                ("m", i), ("mode", i), ("bf16", i), ("cached", i), ("k", i),
                ("rescue_cap", i), ("pack", i * 3),
                ("stencil", i * 3), ("sdim", i * 3), ("nb", i * 3),
                ("cpr", i), ("ncand", i),
                ("voxel", ctypes.c_float), ("pvs", ctypes.c_float * 3),
                ("scatter_ratio", ctypes.c_float)]

        assert ctypes.sizeof(AssocArgs) == 296, "see csrc/assoc.cu"
        _ARGS_CLS.append(AssocArgs)
    return _ARGS_CLS[0]


def _check_geometry(mcfg):
    if not kernel_supports(mcfg):
        raise NotImplementedError(
            f"K2 holds at most {32 * MAX_PER_LANE} candidates a query "
            f"({MAX_PER_LANE} a lane); pack {voxelmap._pack(mcfg)} with "
            f"stencil {(mcfg.stencil_x, mcfg.stencil_y, mcfg.stencil_z)} "
            f"gives {window_rows(mcfg)} superrows x {voxelmap._cpr(mcfg)} "
            f"cells = {n_candidates(mcfg)}")


def _check_map(vm, mcfg, dev):
    _check_geometry(mcfg)
    if mcfg.dedup_gather:
        voxelmap.dedup_capacity(mcfg, 1)  # raises below one row a query
    c = vm.cells
    row = 4 * voxelmap._cpr(mcfg)
    if c.dtype != torch.float32 or c.dim() != 2 or c.shape[1] != row \
            or not c.is_contiguous() or c.device != dev:
        raise ValueError(f"cells must be a contiguous (Cs, {row}) float32 "
                         f"tensor on {dev}")
    sd = voxelmap._sdims(mcfg)
    if c.shape[0] != sd[0] * sd[1] * sd[2]:
        raise ValueError(f"cells hold {c.shape[0]} superrows, the map config "
                         f"{sd[0] * sd[1] * sd[2]}")


def _check(vm, pw, mask, mcfg, k, mode, cached):
    dev = pw.device
    M = pw.shape[0] if pw.dim() == 2 else -1
    if pw.dtype != torch.float32 or tuple(pw.shape) != (M, 3):
        raise ValueError(f"pw must be (M, 3) float32, got {tuple(pw.shape)} "
                         f"{pw.dtype}")
    if mask.dtype != torch.bool or tuple(mask.shape) != (M,) \
            or mask.device != dev:
        raise ValueError(f"mask must be ({M},) bool on {dev}")
    C = n_candidates(mcfg)
    if mode not in (PLANE, LINE) or not 1 <= k <= C:
        raise ValueError(f"mode {mode} / k {k} not supported")
    if cached is None:
        _check_map(vm, mcfg, dev)
        return
    _check_geometry(mcfg)
    store = torch.bfloat16 if mcfg.dense_bf16 else torch.float32
    for name in ("dxd", "dyd", "dzd", "d2d"):
        a = getattr(cached, name)
        if a.dtype != store or tuple(a.shape) != (M, C) \
                or not a.is_contiguous() or a.device != dev:
            raise ValueError(f"cached.{name}: expected contiguous "
                             f"({M}, {C}) {store} on {dev}")
    p0 = cached.pw0
    if tuple(p0.shape) != (M, 3) or p0.dtype != torch.float32 \
            or not p0.is_contiguous() or p0.device != dev:
        raise ValueError("cached.pw0 must be a contiguous (M, 3) float32 "
                         "tensor on the queries' device")


def _set_map(a, vm, mcfg):
    """The per-map fields of `AssocArgs`: the map's rows (None for the
    cached entry, which reads none) and its geometry."""
    px, py, pz = voxelmap._pack(mcfg)
    a.cells = None if vm is None else vm.cells.data_ptr()
    a.bf16 = int(bool(mcfg.dense_bf16))
    a.pack[:] = [px, py, pz]
    a.stencil[:] = [mcfg.stencil_x, mcfg.stencil_y, mcfg.stencil_z]
    a.sdim[:] = list(voxelmap._sdims(mcfg))
    a.nb[:] = list(voxelmap._super_window(mcfg))
    a.cpr = voxelmap._cpr(mcfg)
    a.ncand = n_candidates(mcfg)
    a.voxel = mcfg.voxel_size
    a.pvs[:] = [px * mcfg.voxel_size, py * mcfg.voxel_size,
                pz * mcfg.voxel_size]


def _dedup_bound(pw, mcfg, M=None):
    """The dedup bound of a fresh launch over queries pw (the rows of all
    of them rank, masked or not) with a compact table of
    `dedup_capacity(mcfg, M)` rows, on the device; None without
    `mcfg.dedup_gather`."""
    if not mcfg.dedup_gather:
        return None
    slot = voxelmap.stencil_addresses(pw, mcfg).slot
    return voxelmap.dedup_threshold(
        slot, voxelmap.dedup_capacity(mcfg, pw.shape[0] if M is None else M))


def prepare(stage, vm, pw, mask, mcfg, k, mode, thres_dist, scatter_ratio,
            cached, want_blocks, need_count=True):
    """Check the inputs and allocate the outputs of one launch.  Returns
    (args, bufs): the ctypes `AssocArgs` for `launch` and the tensors it
    points to, which must live until the launch has run.  The NEED stage
    counts its flags only with `need_count`."""
    _check(vm, pw, mask, mcfg, k, mode, cached)
    if stage == GATHER and cached is not None:
        raise ValueError("the GATHER stage reads map rows: fresh entry only")
    M = pw.shape[0]
    dev = pw.device
    f32, i32 = torch.float32, torch.int32
    pw = pw.contiguous()
    mask = mask.contiguous()
    a = _args_struct()()
    C, S = n_candidates(mcfg), window_rows(mcfg)
    bufs = dict(pw=pw, mask=mask,
                thres=torch.as_tensor(thres_dist, dtype=f32,
                                      device=dev).reshape(1).contiguous(),
                out=torch.empty((M, _REC), dtype=f32, device=dev),
                valid=torch.empty((M,), dtype=torch.bool, device=dev))
    if cached is None:
        _set_map(a, vm, mcfg)
        bufs["cells"] = vm.cells
        thr = _dedup_bound(pw, mcfg)
        if thr is not None:
            bufs["dedup_thr"] = thr
        if want_blocks:
            store = torch.bfloat16 if mcfg.dense_bf16 else f32
            blk = [torch.empty((M, C), dtype=store, device=dev)
                   for _ in range(4)]
            bufs["blk_out"] = blk
            a.blk_out[:] = [b.data_ptr() for b in blk]
    else:                       # the cached entry reads no map
        _set_map(a, None, mcfg)
        bufs["pw0"] = cached.pw0
        a.blk_in[:] = [cached.dxd.data_ptr(), cached.dyd.data_ptr(),
                       cached.dzd.data_ptr(), cached.d2d.data_ptr()]
    if stage == GATHER:
        R = 4 * voxelmap._cpr(mcfg)
        bufs.update(rows=torch.empty((M, S, R), dtype=f32, device=dev),
                    g_v=torch.empty((M, 3), dtype=i32, device=dev),
                    g_sv=torch.empty((M, S, 3), dtype=i32, device=dev),
                    g_slot=torch.empty((M, S), dtype=i32, device=dev),
                    g_key=torch.empty((M, S), dtype=f32, device=dev),
                    g_keep=torch.empty((M, S), dtype=torch.bool, device=dev))
    if stage == NEED:
        # padded to whole 16-byte words: RESCUE reads 16 flags at a time
        bufs["need"] = torch.empty(((M + 15) // 16 * 16,), dtype=torch.bool,
                                   device=dev)
        if need_count:
            bufs["need_count"] = torch.zeros((1,), dtype=i32, device=dev)
    for name in ("pw", "mask", "pw0", "thres", "out", "valid", "rows", "g_v",
                 "g_sv", "g_slot", "g_key", "g_keep", "need", "need_count",
                 "dedup_thr"):
        if name in bufs:
            setattr(a, name, bufs[name].data_ptr())
    a.m, a.mode, a.k = M, mode, k
    a.cached = int(cached is not None)
    a.scatter_ratio = scatter_ratio
    return a, bufs


def _bind(lib):
    import ctypes

    lib.assoc_launch.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p]
    lib.assoc_launch.restype = ctypes.c_int


def launch(stage, args, device):
    """Launch the kernel stopped after `stage` on `device`'s current
    stream (counted in LAUNCHES, and a RESCUE launch in RESCUE_LAUNCHES);
    raises if it cannot be built or launched."""
    import ctypes

    from .. import cuda_build

    fn = cuda_build.load(_SOURCE, _bind).assoc_launch
    if device.index is None or device.index == torch.cuda.current_device():
        rc = fn(stage, ctypes.byref(args),
                torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            rc = fn(stage, ctypes.byref(args),
                    torch.cuda.current_stream().cuda_stream)
    if args.m > 0:                  # assoc_launch launches nothing for m = 0
        _count(LAUNCHES=1, RESCUE_LAUNCHES=int(stage == RESCUE))
    if rc != 0:
        raise RuntimeError(f"assoc_launch failed: CUDA error {rc}")


def _launch(stage, vm, pw, mask, mcfg, k, mode, thres_dist, scatter_ratio,
            cached, want_blocks):
    """One kernel launch; returns the buffers it wrote."""
    a, bufs = prepare(stage, vm, pw, mask, mcfg, k, mode, thres_dist,
                      scatter_ratio, cached, want_blocks)
    launch(stage, a, pw.device)
    return bufs


def _s2(rec):
    """(M, 3, 3) from the kernel's (xx, xy, xz, yy, yz, zz) lanes."""
    xx, xy, xz, yy, yz, zz = rec.unbind(-1)
    return torch.stack([torch.stack([xx, xy, xz], -1),
                        torch.stack([xy, yy, yz], -1),
                        torch.stack([xz, yz, zz], -1)], -2)


def _decode(stage, bufs):
    out = bufs["out"]
    if stage == GATHER:
        return {name.removeprefix("g_"): bufs[name]
                for name in ("rows", "g_v", "g_sv", "g_slot", "g_key",
                             "g_keep")}
    if stage == SELECT:
        return dict(t_k=out[:, 7], n=out[:, 8])
    if stage == MOMENTS:
        return dict(s1=out[:, 0:3], s2=_s2(out[:, 3:9]), t_k=out[:, 9],
                    n=out[:, 10])
    if stage == EIG:
        return dict(evals=out[:, 0:3], vec=out[:, 3:6])
    res = dict(mu=out[:, 0:3], vec=out[:, 3:6], valid=bufs["valid"],
               t_k=out[:, 7], n=out[:, 8])
    if stage == NEED:
        M = out.shape[0]
        res["need"] = bufs["need"][:M]
        if "need_count" in bufs:
            res["need_count"] = bufs["need_count"][0]
    return res


def run_stage(stage, vm, pw, mask, mcfg, k, mode, thres_dist,
              scatter_ratio=0.0, cached: StackBlocks = None):
    """The kernel stopped after `stage` on CUDA tensors (`stage_reference`
    on CPU tensors); a dict keyed by what that stage returns."""
    if not pw.is_cuda:
        ref = stage_reference(stage, vm, pw, mask, mcfg, k, mode, thres_dist,
                              scatter_ratio, cached)
        ref.pop("gates", None)
        return ref
    return _decode(stage, _launch(stage, vm, pw, mask, mcfg, k, mode,
                                  thres_dist, scatter_ratio, cached, False))


def associate(vm, pw, mask, mcfg, k, mode, thres_dist, scatter_ratio=0.0,
              cached: StackBlocks = None, want_blocks=False):
    """Association of queries pw (M, 3) against one map: the kernel on
    CUDA tensors, `associate_reference` on CPU tensors.

    `cached` (the round-0 StackBlocks) selects the gather-free entry;
    otherwise the map rows are read and, with `want_blocks`, the four dense
    candidate blocks are returned for later `cached` calls.  Returns
    (Assoc, StackBlocks or None)."""
    return associate_with_rescue(vm, None, pw, mask, mcfg, None, k, mode,
                                 thres_dist, scatter_ratio, 0, cached,
                                 want_blocks)


def _rescue_pair(vm, vm_local, pw, mask, mcfg, lcfg, k, mode, thres_dist,
                 scatter_ratio, rescue_cap, cached, want_blocks):
    """Launch NEED on the persistent map, then RESCUE on the local map
    (OUT alone without one); returns the buffers they wrote."""
    dev = pw.device
    M = pw.shape[0]
    stage = OUT if vm_local is None else NEED
    if vm_local is not None:
        _check_map(vm_local, lcfg, dev)
        if not 1 <= k <= n_candidates(lcfg):
            raise ValueError(f"k {k} not supported on the local map")
    a, bufs = prepare(stage, vm, pw, mask, mcfg, k, mode, thres_dist,
                      scatter_ratio, cached, want_blocks, need_count=False)
    launch(stage, a, dev)
    if vm_local is not None:
        a2 = _args_struct().from_buffer_copy(a)
        _set_map(a2, vm_local, lcfg)
        a2.cached, a2.mask, a2.dedup_thr = 0, None, None
        a2.blk_out[:] = [None] * 4
        a2.rescue_cap = min(int(rescue_cap), M)
        bufs["cells_local"] = vm_local.cells
        if lcfg.dedup_gather:
            # the reference ranks the rows of the rescue's own query set:
            # every query when the cap does not bind, else the first
            # rescue_cap flags of the NEED launch and the pads (on the
            # device, between the two launches)
            pw_r = pw if a2.rescue_cap >= M else _rescue_queries(
                pw, bufs["need"][:M], a2.rescue_cap)[1]
            bufs["dedup_thr_local"] = _dedup_bound(pw_r, lcfg)
            a2.dedup_thr = bufs["dedup_thr_local"].data_ptr()
        launch(RESCUE, a2, dev)
    return bufs


def associate_with_rescue(vm, vm_local, pw, mask, mcfg, lcfg, k, mode,
                          thres_dist, scatter_ratio, rescue_cap,
                          cached: StackBlocks = None, want_blocks=False):
    """Association against the persistent map `vm` with the local-map
    rescue of factors (`vm_local` None: none): the queries that failed
    (mask & ~valid), the first `rescue_cap` of them in index order (all
    when rescue_cap >= M), are associated against `vm_local` with `lcfg`,
    and take that result where it is valid.  On CUDA tensors two kernel
    launches and no torch op; `associate_with_rescue_reference` on CPU
    tensors.  Returns (Assoc merged, StackBlocks or None) as `associate`."""
    _count(CALLS=1, LOCAL_CALLS=int(vm_local is not None))
    if not pw.is_cuda:
        return associate_with_rescue_reference(
            vm, vm_local, pw, mask, mcfg, lcfg, k, mode, thres_dist,
            scatter_ratio, rescue_cap, cached, want_blocks)
    bufs = _rescue_pair(vm, vm_local, pw, mask, mcfg, lcfg, k, mode,
                        thres_dist, scatter_ratio, rescue_cap, cached,
                        want_blocks)
    r = Assoc(**_decode(OUT, bufs))
    if cached is not None:
        return r, cached
    if want_blocks:
        return r, StackBlocks(pw, *bufs["blk_out"])
    return r, None


def run_rescue(vm, vm_local, pw, mask, mcfg, lcfg, k, mode, thres_dist,
               scatter_ratio, rescue_cap, cached: StackBlocks = None):
    """A rescue pair as `associate_with_rescue` runs it, with what
    `compare_rescue` reads: the merged mu, vec, valid, t_k, n, the first
    launch's flags `need` and `served` (the local map answered).  The
    kernel on CUDA tensors; on CPU tensors the plain cuts of
    `rescue_stage_reference`, merged as the kernel merges them."""
    if not pw.is_cuda:
        first, second = rescue_stage_reference(
            vm, vm_local, pw, mask, mcfg, lcfg, k, mode, thres_dist,
            scatter_ratio, cached, rescue_cap)
        served = _tried(first["need"], rescue_cap) & second["valid"]
        out = _merge(first, second, served)
        return dict({f: out[f] for f in Assoc._fields}, need=first["need"],
                    served=served)
    bufs = _rescue_pair(vm, vm_local, pw, mask, mcfg, lcfg, k, mode,
                        thres_dist, scatter_ratio, rescue_cap, cached, False)
    res = _decode(NEED, bufs)
    return dict(res, served=bufs["out"][:, 9] > 0.5)
