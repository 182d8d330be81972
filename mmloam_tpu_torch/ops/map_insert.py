"""Batched voxel-map insertion through the CUDA aggregate-and-RMW kernel
(K1).

Port of mmloam_tpu/ops/pallas_insert.py.  What stays plain torch is what
the JAX package also ran outside the Pallas kernel: the cell addressing
(`voxelmap._voxel_coords`, `_cell_addr`) and one stable sort of the points
by superrow slot (`sort_points`).  `csrc/map_insert.cu` (`aggregate_rmw`
on CUDA tensors) then sums each touched row's points per sub-cell, in
sorted order, and read-modify-writes the row.  The plain version is the
reference's composition, `aggregate_updates` (segment-summed per-row
updates, compacted) followed by `rmw_reference`; `insert_batched` takes it
on CPU tensors.

The kernel sums each cell's points one after another; the plain version
sums them by the JAX package's associative scan.  Meta lanes (key and
count) agree exactly, sum lanes within `sum_tolerance`.

Cells are updated IN PLACE (the TPU kernel aliases its map buffer the same
way, `input_output_aliases={5: 0}`).
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from . import voxelmap
from .downsample import _seg_scan_sum

_META_MOD = voxelmap._META_MOD
_SOURCE = "map_insert.cu"
_MASKED = 2 ** 30          # slot of a masked point: sorts after every row

# kernel launches made by `aggregate_rmw` (the wrapper counts each launch,
# nowhere else); callers reset it to 0 to check a run went through the
# kernel.  Workers of a split replay launch from several threads, so the
# count is taken under a lock.
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()


def _count_launch():
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1


class SortedPoints(NamedTuple):
    """Points addressed and stably sorted by superrow slot, per batch
    element: what the kernel reads (through `perm`)."""

    slot: torch.Tensor   # (B, N) int32 slots in sorted order (_MASKED last)
    perm: torch.Tensor   # (B, N) int64 the stable sort's permutation
    sub: torch.Tensor    # (B, N) int32 sub-cell (points' own order)
    key: torch.Tensor    # (B, N) f32 epoch key
    pts: torch.Tensor    # (B, N, 3) f32 points
    v: torch.Tensor      # (B, N, 3) int32 fine-voxel coords


class RowUpdates(NamedTuple):
    """Per-unique-row updates, valid entries compacted to the front."""

    row_slot: torch.Tensor   # (B, N) int32 superrow slot (0 past nv)
    row_key: torch.Tensor    # (B, N) f32 epoch key
    row_upd: torch.Tensor    # (B, N, 4 cpr) f32 [Σx | Σy | Σz | cnt]
    nv: torch.Tensor         # (B,) int32 valid entries


def sort_points(pts, mask, cfg) -> SortedPoints:
    """Address points (B, N, 3) to (slot, sub-cell, key) and stably sort
    them by slot, masked points last (`pallas_insert.py:43-70`)."""
    v = voxelmap._voxel_coords(pts, cfg)
    slot, sub, key = voxelmap._cell_addr(v, cfg)
    srt = torch.sort(torch.where(mask, slot, _MASKED), dim=1, stable=True)
    return SortedPoints(srt.values, srt.indices, sub, key, pts, v)


def _segment_rows(sp: SortedPoints, cfg) -> RowUpdates:
    """Segment-sum sorted points into per-row updates, valid rows
    compacted to the front (`pallas_insert.py:71-105` and `:228-239`).
    Rows are 4 cpr floats wide, at any pack."""
    cpr = voxelmap._cpr(cfg)
    pts = sp.pts
    B, N = pts.shape[:2]
    dtype = pts.dtype
    dev = pts.device
    perm = sp.perm
    g = lambda a: torch.gather(a, 1, perm)
    slot_s, sub_s, key_s = sp.slot, g(sp.sub), g(sp.key)
    m_s = slot_s != _MASKED
    rel0 = pts - sp.v.to(dtype) * cfg.voxel_size
    rel = torch.gather(rel0, 1, perm[..., None].expand(B, N, 3))
    mf = m_s.to(dtype)

    sub_i = sub_s.to(torch.int64)[..., None]
    pay = torch.zeros((B, N, 4 * cpr), dtype=dtype, device=dev)
    pay.scatter_(2, sub_i, rel[..., 0:1] * mf[..., None])
    pay.scatter_(2, sub_i + cpr, rel[..., 1:2] * mf[..., None])
    pay.scatter_(2, sub_i + 2 * cpr, rel[..., 2:3] * mf[..., None])
    pay.scatter_(2, sub_i + 3 * cpr, mf[..., None])

    change = slot_s[:, 1:] != slot_s[:, :-1]
    one = torch.ones((B, 1), dtype=torch.bool, device=dev)
    start = torch.cat([one, change], dim=1)
    is_end = torch.cat([change, one], dim=1)
    # segmented scan along the point axis: at each segment's END row the
    # value is exactly that row's summed update
    seg_sum = _seg_scan_sum(pay.transpose(0, 1),
                            start.transpose(0, 1)).transpose(0, 1)
    end_ok = is_end & m_s
    row_upd = seg_sum * end_ok.to(dtype)[..., None]
    row_slot = torch.where(end_ok, slot_s, torch.zeros_like(slot_s))
    row_key = torch.where(end_ok, key_s, torch.zeros_like(key_s))

    # compact valid entries to the front, slot order preserved
    iota = torch.arange(N, device=dev).expand(B, N)
    ckey = torch.where(end_ok, iota, N + iota)
    cperm = torch.sort(ckey, dim=1, stable=True).indices
    row_slot = torch.gather(row_slot, 1, cperm).to(torch.int32)
    row_key = torch.gather(row_key, 1, cperm)
    row_upd = torch.gather(row_upd, 1,
                           cperm[..., None].expand(B, N, 4 * cpr))
    nv = torch.sum(end_ok, dim=1, dtype=torch.int32)
    return RowUpdates(row_slot.contiguous(), row_key.contiguous(),
                      row_upd.contiguous(), nv)


def aggregate_updates(pts, mask, cfg) -> RowUpdates:
    """Bucket + stable sort + segment-sum points (B, N, 3) into per-row
    updates, valid rows compacted to the front (`pallas_insert.py:43-105`
    and `:228-239`)."""
    return _segment_rows(sort_points(pts, mask, cfg), cfg)


def rmw_reference(cells, upd: RowUpdates, cap: float):
    """Plain PyTorch version of the kernel: gather the touched rows, apply
    `_rmw_kernel`'s math (`pallas_insert.py:165-181`), write them back.
    Updates `cells` (B, Cs, 4 cpr) in place and returns it."""
    B, Np = upd.row_slot.shape
    cpr = cells.shape[2] // 4
    s3 = 3 * cpr
    dev = cells.device
    valid = torch.arange(Np, device=dev)[None, :] < upd.nv[:, None]
    b_idx = torch.arange(B, device=dev)[:, None].expand(B, Np)[valid]
    slot = upd.row_slot.to(torch.int64)[valid]
    old = cells[b_idx, slot]                             # (V, 4 cpr)
    u = upd.row_upd[valid]
    keyf = upd.row_key[valid][:, None]
    capf = torch.tensor(cap, dtype=torch.float32, device=dev)

    ometa = old[:, s3:]
    okey = torch.floor(ometa * (1.0 / _META_MOD))
    ocnt = ometa - okey * _META_MOD
    keep = ((okey == keyf) & (ocnt > 0.0)).to(torch.float32)
    addcnt = u[:, s3:]
    cnt1 = keep * ocnt + addcnt
    scale = torch.clamp(capf / torch.clamp(cnt1, min=1.0), max=1.0)
    keep3 = keep.repeat(1, 3)
    scale3 = scale.repeat(1, 3)
    sums = (keep3 * old[:, 0:s3] + u[:, 0:s3]) * scale3
    meta1 = keyf * _META_MOD + torch.minimum(cnt1, capf)
    t = addcnt > 0.0
    new = torch.cat([torch.where(t.repeat(1, 3), sums, old[:, 0:s3]),
                     torch.where(t, meta1, ometa)], dim=1)
    cells[b_idx, slot] = new
    return cells


# The kernel adds each cell's n points one after another; the plain version
# adds the same n terms in its associative scan's order.  The terms are
# offsets from the voxel corner, in [0, voxel), so no sum cancels: each
# order lies within (n - 1) u of the exact sum relative to it (u = 2^-24),
# and the add of the kept old sum and the cap's rescale round once more
# each.  Relative differences add over a sequence of inserts, so the two
# maps' sum lanes agree within
#     SUM_ATOL + 2 u sum_inserts(n_max + 2) |plain|
# where n_max is the most points one insert puts into one cell (near
# count_cap = 100, a cell gets ~100 points, ~1e-5 relative).  SUM_ATOL
# covers sums within a few ulps of 0.
SUM_ATOL = 1e-6


def cell_load(pts, mask, cfg):
    """The most masked-in points that one insert of `pts` puts into one
    cell of one batch element (n_max of the bound above)."""
    v = voxelmap._voxel_coords(pts, cfg)
    slot, sub, _ = voxelmap._cell_addr(v, cfg)
    B = pts.shape[0]
    lane = torch.arange(B, device=pts.device)[:, None].expand_as(slot)
    cell = (lane.to(torch.int64) * 2 ** 40
            + slot.to(torch.int64) * voxelmap._cpr(cfg) + sub)[mask]
    if cell.numel() == 0:
        return 0
    return int(torch.unique(cell, return_counts=True)[1].max())


def sum_tolerance(plain_sums, loads):
    """Per-lane bound on |kernel - plain| of the sum lanes after inserts
    with the given `cell_load`s (see above)."""
    rel = 2.0 * 2.0 ** -24 * sum(n + 2 for n in loads)
    return SUM_ATOL + rel * torch.abs(plain_sums)


# K1 gives each cell of a row one lane of a warp
MAX_CELLS = 32


def kernel_supports(mcfg):
    """Whether K1 takes rows of this map's pack (at most MAX_CELLS cells a
    row); the wrapper raises NotImplementedError on CUDA tensors
    otherwise."""
    return voxelmap._cpr(mcfg) <= MAX_CELLS


def _check(cells, sp: SortedPoints, cfg):
    row = 4 * voxelmap._cpr(cfg)
    if cells.dtype != torch.float32 or cells.dim() != 3 \
            or cells.shape[2] != row or not cells.is_contiguous():
        raise ValueError(f"cells must be a contiguous (B, Cs, {row}) float32 "
                         f"tensor, got {tuple(cells.shape)} {cells.dtype}")
    B, N = sp.slot.shape
    want = {"slot": ((B, N), torch.int32), "perm": ((B, N), torch.int64),
            "sub": ((B, N), torch.int32), "key": ((B, N), torch.float32),
            "pts": ((B, N, 3), torch.float32), "v": ((B, N, 3), torch.int32)}
    for name, (shape, dtype) in want.items():
        a = getattr(sp, name)
        if tuple(a.shape) != shape or a.dtype != dtype \
                or not a.is_contiguous() or a.device != cells.device:
            raise ValueError(f"{name}: expected contiguous {shape} {dtype} "
                             f"on {cells.device}, got {tuple(a.shape)} "
                             f"{a.dtype} on {a.device}")
    if B != cells.shape[0]:
        raise ValueError("batch sizes of cells and points differ")


def _bind(lib):
    import ctypes

    p = ctypes.c_void_p
    lib.map_insert_launch.argtypes = [p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, p]
    lib.map_insert_launch.restype = ctypes.c_int


def aggregate_rmw(cells, sp: SortedPoints, cfg):
    """Sum the sorted points per row and apply them to `cells` in place:
    the CUDA kernel for CUDA tensors (counted in LAUNCHES), the plain
    version (`_segment_rows` + `rmw_reference`) for CPU tensors."""
    _check(cells, sp, cfg)
    if not cells.is_cuda:
        return rmw_reference(cells, _segment_rows(sp, cfg), cfg.count_cap)
    if not kernel_supports(cfg):
        raise NotImplementedError(
            f"K1 takes at most {MAX_CELLS} cells a row (one warp lane a "
            f"cell); pack {voxelmap._pack(cfg)} has {voxelmap._cpr(cfg)}")
    from .. import cuda_build

    fn = cuda_build.load(_SOURCE, _bind).map_insert_launch
    B, N = sp.slot.shape
    args = (cells.data_ptr(), sp.slot.data_ptr(), sp.perm.data_ptr(),
            sp.sub.data_ptr(), sp.key.data_ptr(), sp.pts.data_ptr(),
            sp.v.data_ptr(), B, N, cells.shape[1], voxelmap._cpr(cfg),
            cfg.voxel_size, float(cfg.count_cap))
    dev = cells.device
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    _count_launch()
    if rc != 0:
        raise RuntimeError(f"map_insert_launch failed: CUDA error {rc}")
    return cells


def insert_batched(cells, pts, mask, cfg):
    """Batched map insertion: cells (B, Cs, 4 cpr) in place, pts (B, N, 3),
    mask (B, N).  Semantics == per-lane voxelmap.insert.  On CUDA tensors
    the torch addressing and sort, then the kernel; on CPU tensors the
    plain version."""
    if not cells.is_cuda:
        return insert_batched_reference(cells, pts, mask, cfg)
    return aggregate_rmw(cells, sort_points(pts.contiguous(), mask, cfg),
                         cfg)


def insert_batched_reference(cells, pts, mask, cfg):
    """`insert_batched` through the plain version on any device."""
    return rmw_reference(cells, aggregate_updates(pts, mask, cfg),
                         cfg.count_cap)
