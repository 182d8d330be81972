"""Batched voxel-map insertion through the CUDA row-RMW kernel (K1).

Port of mmloam_tpu/ops/pallas_insert.py.  The prep stays plain torch, as
it stayed XLA outside the Pallas kernel: points are bucketed to (superrow
slot, sub-cell, epoch key), stably sorted by slot, segment-summed into one
128-lane update [Σx | Σy | Σz | cnt] per unique touched row, and the valid
rows are compacted to the front with their count `nv`.  The row
read-modify-write is `csrc/map_insert.cu` on CUDA tensors and
`rmw_reference`, its plain PyTorch version, on CPU tensors.

Cells are updated IN PLACE (the TPU kernel aliases its map buffer the same
way, `input_output_aliases={5: 0}`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import voxelmap
from .downsample import _seg_scan_sum

_META_MOD = voxelmap._META_MOD
_SOURCE = "map_insert.cu"

# kernel launches made by `rmw` (the wrapper counts each launch, nowhere
# else); callers reset it to 0 to check a run went through the kernel
LAUNCHES = 0


class RowUpdates(NamedTuple):
    """Per-unique-row updates, valid entries compacted to the front."""

    row_slot: torch.Tensor   # (B, N) int32 superrow slot (0 past nv)
    row_key: torch.Tensor    # (B, N) f32 epoch key
    row_upd: torch.Tensor    # (B, N, 128) f32 [Σx | Σy | Σz | cnt]
    nv: torch.Tensor         # (B,) int32 valid entries


def aggregate_updates(pts, mask, cfg) -> RowUpdates:
    """Bucket + stable sort + segment-sum points (B, N, 3) into per-row
    updates, valid rows compacted to the front (`pallas_insert.py:43-105`
    and `:228-239`)."""
    if voxelmap._cpr(cfg) != 32:
        raise NotImplementedError(
            "map insert assumes pack_x*pack_y*pack_z == 32 cells per row")
    B, N = pts.shape[:2]
    dtype = pts.dtype
    dev = pts.device

    v = voxelmap._voxel_coords(pts, cfg)
    slot, sub, key = voxelmap._cell_addr(v, cfg)
    slot_m = torch.where(mask, slot, torch.full_like(slot, 2 ** 30))
    perm = torch.sort(slot_m, dim=1, stable=True).indices
    g = lambda a: torch.gather(a, 1, perm)
    slot_s, sub_s, key_s, m_s = g(slot_m), g(sub), g(key), g(mask)
    rel0 = pts - v.to(dtype) * cfg.voxel_size
    rel = torch.gather(rel0, 1, perm[..., None].expand(B, N, 3))
    mf = m_s.to(dtype)

    sub_i = sub_s.to(torch.int64)[..., None]
    pay = torch.zeros((B, N, 128), dtype=dtype, device=dev)
    pay.scatter_(2, sub_i, rel[..., 0:1] * mf[..., None])
    pay.scatter_(2, sub_i + 32, rel[..., 1:2] * mf[..., None])
    pay.scatter_(2, sub_i + 64, rel[..., 2:3] * mf[..., None])
    pay.scatter_(2, sub_i + 96, mf[..., None])

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
    row_upd = torch.gather(row_upd, 1, cperm[..., None].expand(B, N, 128))
    nv = torch.sum(end_ok, dim=1, dtype=torch.int32)
    return RowUpdates(row_slot.contiguous(), row_key.contiguous(),
                      row_upd.contiguous(), nv)


def rmw_reference(cells, upd: RowUpdates, cap: float):
    """Plain PyTorch version of the kernel: gather the touched rows, apply
    `_rmw_kernel`'s math (`pallas_insert.py:165-181`), write them back.
    Updates `cells` (B, Cs, 128) in place and returns it."""
    B, Np = upd.row_slot.shape
    dev = cells.device
    valid = torch.arange(Np, device=dev)[None, :] < upd.nv[:, None]
    b_idx = torch.arange(B, device=dev)[:, None].expand(B, Np)[valid]
    slot = upd.row_slot.to(torch.int64)[valid]
    old = cells[b_idx, slot]                             # (V, 128)
    u = upd.row_upd[valid]
    keyf = upd.row_key[valid][:, None]
    capf = torch.tensor(cap, dtype=torch.float32, device=dev)

    ometa = old[:, 96:128]
    okey = torch.floor(ometa * (1.0 / _META_MOD))
    ocnt = ometa - okey * _META_MOD
    keep = ((okey == keyf) & (ocnt > 0.0)).to(torch.float32)
    addcnt = u[:, 96:128]
    cnt1 = keep * ocnt + addcnt
    scale = torch.clamp(capf / torch.clamp(cnt1, min=1.0), max=1.0)
    keep3 = keep.repeat(1, 3)
    scale3 = scale.repeat(1, 3)
    sums = (keep3 * old[:, 0:96] + u[:, 0:96]) * scale3
    meta1 = keyf * _META_MOD + torch.minimum(cnt1, capf)
    t = addcnt > 0.0
    new = torch.cat([torch.where(t.repeat(1, 3), sums, old[:, 0:96]),
                     torch.where(t, meta1, ometa)], dim=1)
    cells[b_idx, slot] = new
    return cells


def _check(cells, upd: RowUpdates):
    if cells.dtype != torch.float32 or cells.dim() != 3 \
            or cells.shape[2] != 128 or not cells.is_contiguous():
        raise ValueError("cells must be a contiguous (B, Cs, 128) float32 "
                         f"tensor, got {tuple(cells.shape)} {cells.dtype}")
    B, Np = upd.row_slot.shape
    want = {"row_slot": ((B, Np), torch.int32),
            "row_key": ((B, Np), torch.float32),
            "row_upd": ((B, Np, 128), torch.float32),
            "nv": ((B,), torch.int32)}
    for name, (shape, dtype) in want.items():
        a = getattr(upd, name)
        if tuple(a.shape) != shape or a.dtype != dtype \
                or not a.is_contiguous() or a.device != cells.device:
            raise ValueError(f"{name}: expected contiguous {shape} {dtype} "
                             f"on {cells.device}, got {tuple(a.shape)} "
                             f"{a.dtype} on {a.device}")
    if B != cells.shape[0]:
        raise ValueError("batch sizes of cells and updates differ")


def rmw(cells, upd: RowUpdates, cap: float):
    """Apply the row updates to `cells` in place: the CUDA kernel for CUDA
    tensors (counted in LAUNCHES), `rmw_reference` for CPU tensors."""
    global LAUNCHES
    _check(cells, upd)
    if not cells.is_cuda:
        return rmw_reference(cells, upd, cap)
    import ctypes

    from .. import cuda_build

    lib = cuda_build.load(_SOURCE)
    fn = lib.map_insert_rmw
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_float,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, Np = upd.row_slot.shape
    with torch.cuda.device(cells.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(cells.data_ptr(), upd.row_slot.data_ptr(),
                upd.row_key.data_ptr(), upd.row_upd.data_ptr(),
                upd.nv.data_ptr(), B, Np, cells.shape[1], float(cap), stream)
    LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"map_insert_rmw launch failed: CUDA error {rc}")
    return cells


def insert_batched(cells, pts, mask, cfg):
    """Batched map insertion: cells (B, Cs, 128) in place, pts (B, N, 3),
    mask (B, N).  Semantics == per-lane voxelmap.insert."""
    return rmw(cells, aggregate_updates(pts, mask, cfg), cfg.count_cap)


def insert_batched_reference(cells, pts, mask, cfg):
    """`insert_batched` through the plain version on any device."""
    return rmw_reference(cells, aggregate_updates(pts, mask, cfg),
                         cfg.count_cap)
