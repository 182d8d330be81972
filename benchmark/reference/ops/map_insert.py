"""Batched voxel-map insertion, plain (frozen copy of the port's
`ops/map_insert.py` without its kernel K1).

The cell addressing (`voxelmap._voxel_coords`, `_cell_addr`), one stable
sort of the points by superrow slot (`sort_points`), segment-summed
per-row updates (`aggregate_updates`, the JAX package's associative scan)
and the row read-modify-write (`rmw_reference`).  Cells are updated IN
PLACE.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import voxelmap
from .downsample import _seg_scan_sum

_META_MOD = voxelmap._META_MOD
_MASKED = 2 ** 30          # slot of a masked point: sorts after every row


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


def insert_batched(cells, pts, mask, cfg):
    """Batched map insertion: cells (B, Cs, 4 cpr) in place, pts (B, N, 3),
    mask (B, N), through the plain version."""
    return rmw_reference(cells, aggregate_updates(pts, mask, cfg),
                         cfg.count_cap)
