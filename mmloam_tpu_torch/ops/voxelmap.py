"""Torus voxel-grid map: scatter insert + stencil candidate gather
(port of mmloam_tpu/ops/voxelmap.py).

Same data layout as the reference, so maps compare element by element:
cells (Cs, 4 cpr) f32 superrows, each holding a (pack_x, pack_y, pack_z)
block of cpr = pack_x*pack_y*pack_z fine cells (32 at the default
(4,4,2), a 128-float row), struct-of-arrays [sum_x(cpr) | sum_y(cpr) |
sum_z(cpr) | meta(cpr)], sums relative to each fine-voxel corner, meta =
key*128 + count.  Any pack whose dims divide the map runs, as in the
reference.
Torus addressing uses floor division / remainder (`torch.div(...,
rounding_mode="floor")`, `torch.remainder`) like `//` and `%` in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_NF = 4
_META_MOD = 128.0


def _pack(cfg):
    return cfg.pack_x, cfg.pack_y, cfg.pack_z


def _sdims(cfg):
    px, py, pz = _pack(cfg)
    if cfg.dim_x % px or cfg.dim_y % py or cfg.dim_z % pz:
        raise ValueError("map dims must be multiples of the superrow pack")
    return cfg.dim_x // px, cfg.dim_y // py, cfg.dim_z // pz


def _cpr(cfg):
    px, py, pz = _pack(cfg)
    return px * py * pz


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


class VoxelMap(NamedTuple):
    """One feature class's map: cells (Cs, cpr * 4) f32 superrows."""

    cells: torch.Tensor

    def _field(self, i):
        cpr = self.cells.shape[1] // _NF
        return self.cells[:, i * cpr:(i + 1) * cpr].reshape(-1)

    @property
    def sum_rel(self):
        return torch.stack([self._field(0), self._field(1), self._field(2)],
                           dim=-1)

    @property
    def meta(self):
        return self._field(3)

    @property
    def count(self):
        m = self.meta
        return m - torch.floor(m / _META_MOD) * _META_MOD

    @property
    def key(self):
        return torch.floor(self.meta / _META_MOD)


def empty_map(cfg, device=None) -> VoxelMap:
    sdx, sdy, sdz = _sdims(cfg)
    return VoxelMap(cells=torch.zeros((sdx * sdy * sdz, _cpr(cfg) * _NF),
                                      dtype=torch.float32, device=device))


def _voxel_coords(pts, cfg):
    """Integer fine-voxel coordinates (floor) of points.  The divisor is a
    tensor on the points' device: PyTorch's CUDA division by a host scalar
    multiplies by its reciprocal, one ulp off the correctly rounded
    quotient that the CPU, the JAX package and the association kernel
    floor (a voxel index one ulp off is another cell)."""
    voxel = torch.full((), cfg.voxel_size, dtype=pts.dtype,
                       device=pts.device)
    return torch.floor(pts / voxel).to(torch.int32)


def _super_decompose(sv, cfg):
    """Torus slot index and epoch key for SUPER voxel coords sv (..., 3)."""
    sdx, sdy, sdz = _sdims(cfg)
    mx = torch.remainder(sv[..., 0], sdx)
    my = torch.remainder(sv[..., 1], sdy)
    mz = torch.remainder(sv[..., 2], sdz)
    slot = (mx * sdy + my) * sdz + mz
    qx = torch.clamp(_fdiv(sv[..., 0] - mx, sdx) + 16, 0, 31)
    qy = torch.clamp(_fdiv(sv[..., 1] - my, sdy) + 16, 0, 31)
    qz = torch.clamp(_fdiv(sv[..., 2] - mz, sdz) + 16, 0, 31)
    key = ((qx << 10) | (qy << 5) | qz).to(torch.float32)
    return slot, key


def _cell_addr(v, cfg):
    """(superrow slot, sub-cell index, epoch key) for fine voxel coords v."""
    px, py, pz = _pack(cfg)
    sv = torch.stack([_fdiv(v[..., 0], px), _fdiv(v[..., 1], py),
                      _fdiv(v[..., 2], pz)], dim=-1)
    slot, key = _super_decompose(sv, cfg)
    sub = ((torch.remainder(v[..., 0], px) * py
            + torch.remainder(v[..., 1], py)) * pz
           + torch.remainder(v[..., 2], pz))
    return slot, sub, key


def insert(vm: VoxelMap, pts, mask, cfg) -> VoxelMap:
    """Masked scatter of world-frame points into the map (returns a new map).

    Same three passes as the reference (`voxelmap.py:145-212`): reset
    stale/empty target cells and stamp the epoch key, scatter-add the
    corner-relative sums and counts, then saturate counts at count_cap.
    `mode="drop"` targets (masked points) go to one dummy slot appended
    past the end of the flat view and cut off afterwards.
    """
    cpr = _cpr(cfg)
    row_f = cpr * _NF
    dev = vm.cells.device
    flat = torch.cat([vm.cells.reshape(-1),
                      torch.zeros((1,), dtype=vm.cells.dtype, device=dev)])
    n_flat = flat.shape[0] - 1
    dtype = flat.dtype
    pts = pts.to(dtype)
    N = pts.shape[0]

    v = _voxel_coords(pts, cfg)
    slot, sub, key = _cell_addr(v, cfg)
    slot = slot.to(torch.int64)
    base = slot * row_f + sub
    fidx = torch.stack([base, base + cpr, base + 2 * cpr, base + 3 * cpr],
                       dim=-1)
    fidx = torch.where(mask[:, None], fidx, torch.full_like(fidx, n_flat))
    maskf = mask.to(dtype)

    meta0 = flat[fidx[:, 3]]
    key0 = torch.floor(meta0 / _META_MOD)
    cnt0 = meta0 - key0 * _META_MOD
    fresh = ((key0 != key) | (cnt0 == 0)) & mask

    # 1. reset stale/empty target cells and stamp the new epoch key
    # (duplicate targets write identical values)
    ridx = torch.where(fresh[:, None], fidx, torch.full_like(fidx, n_flat))
    stamp = torch.cat([torch.zeros((N, 3), dtype=dtype, device=dev),
                       (key * _META_MOD)[:, None]], dim=-1)
    flat = flat.index_put((ridx.reshape(-1),), stamp.reshape(-1))

    # 2. accumulate corner-relative sums and counts
    rel = pts - v.to(dtype) * cfg.voxel_size
    payload = torch.cat([rel * maskf[:, None], maskf[:, None]], dim=-1)
    flat = flat.index_put((fidx.reshape(-1),), payload.reshape(-1),
                          accumulate=True)

    # 3. saturate counts at count_cap by rescaling sums; the true count is
    # decoded with the per-point incoming key (see the reference)
    vals = flat[fidx.reshape(-1)].reshape(N, _NF)
    meta1 = vals[:, 3]
    cnt1 = meta1 - key * _META_MOD
    cap = torch.tensor(cfg.count_cap, dtype=dtype, device=dev)
    scale = torch.clamp(cap / torch.clamp(cnt1, min=1.0), max=1.0)
    fixed = torch.cat(
        [vals[:, 0:3] * scale[:, None],
         (key * _META_MOD + torch.minimum(cnt1, cap))[:, None]], dim=-1)
    oidx = torch.where((cnt1 > cap)[:, None], fidx,
                       torch.full_like(fidx, n_flat))
    flat = flat.index_put((oidx.reshape(-1),), fixed.reshape(-1))

    return VoxelMap(cells=flat[:n_flat].reshape(vm.cells.shape))


def insert_guard(pts, center, cfg):
    """Points within half a torus period (x0.96) of `center` on every axis."""
    lim = torch.tensor([cfg.dim_x, cfg.dim_y, cfg.dim_z], dtype=pts.dtype,
                       device=pts.device) * (0.48 * cfg.voxel_size)
    return torch.all(torch.abs(pts - center[..., None, :]) < lim, dim=-1)


def _super_window(cfg):
    """Static superrow-window shape covering the fine stencil."""
    px, py, pz = _pack(cfg)
    nbx = (2 * cfg.stencil_x + px - 1) // px + 1
    nby = (2 * cfg.stencil_y + py - 1) // py + 1
    nbz = (2 * cfg.stencil_z + pz - 1) // pz + 1
    return nbx, nby, nbz


def _grid(nx, ny, nz, device):
    gx, gy, gz = torch.meshgrid(torch.arange(nx, device=device),
                                torch.arange(ny, device=device),
                                torch.arange(nz, device=device),
                                indexing="ij")
    return gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)


class StencilAddr(NamedTuple):
    """Per-query stencil addressing (counterpart of the archived kernel's
    `prepare_queries`, scripts/pallas_assoc.py:76-109)."""

    v: torch.Tensor      # (M, 3) int32 fine-voxel coords of the query
    sv: torch.Tensor     # (M, S, 3) int32 superrow coords of the window
    slot: torch.Tensor   # (M, S) int32 torus slot of each superrow
    key: torch.Tensor    # (M, S) f32 expected epoch key


def stencil_addresses(q, cfg) -> StencilAddr:
    """Voxel, superrow, slot and key addressing of each query's stencil
    window: the plain version's addressing.  The association kernel
    computes the same integers itself (its GATHER stage writes them, held
    bit-equal to these)."""
    px, py, pz = _pack(cfg)
    nbx, nby, nbz = _super_window(cfg)
    v = _voxel_coords(q, cfg)
    sx0 = _fdiv(v[:, 0] - cfg.stencil_x, px)
    sy0 = _fdiv(v[:, 1] - cfg.stencil_y, py)
    sz0 = _fdiv(v[:, 2] - cfg.stencil_z, pz)
    ox, oy, oz = _grid(nbx, nby, nbz, q.device)
    sv = torch.stack([sx0[:, None] + ox[None, :],
                      sy0[:, None] + oy[None, :],
                      sz0[:, None] + oz[None, :]], dim=-1).to(torch.int32)
    slot, key = _super_decompose(sv, cfg)
    return StencilAddr(v, sv, slot, key)


def _dedup_gather_rows(cells, slot, capacity):
    """The reference's two-level superrow gather (`voxelmap.py:239-284`):
    the (M, S) rows of `slot`, each unique row read once into a compact
    table of `capacity` rows, ranked by slot id.  Returns (rows (M, S, R),
    valid (M, S)): a position whose unique rank overflows `capacity` gets
    valid=False and the compact table's last row (candidates dropped,
    never wrong data where valid).  Stable sorts, as `lax.sort`'s."""
    M, S = slot.shape
    n_super = cells.shape[0]
    flat = slot.reshape(-1)
    s_ids, pos = torch.sort(flat, stable=True)
    newrun = torch.cat([torch.ones((1,), dtype=torch.bool,
                                   device=flat.device),
                        s_ids[1:] != s_ids[:-1]])
    rank = torch.cumsum(newrun.to(torch.int32), 0, dtype=torch.int32) - 1
    k_uid = torch.where(newrun, rank, torch.full_like(rank, capacity))
    uid = s_ids[torch.sort(k_uid, stable=True).indices][:capacity]
    inv = torch.empty_like(rank).scatter_(0, pos, rank).reshape(M, S)
    compact = cells[torch.clamp(uid, 0, n_super - 1).to(torch.int64)]
    rows = compact[torch.clamp(inv, max=capacity - 1).to(torch.int64)]
    return rows, inv < capacity


def dedup_threshold(slot, capacity):
    """The largest slot id whose unique rank is below `capacity`, as a (1,)
    int32 tensor on the slots' device: a window row survives
    `_dedup_gather_rows` iff its slot is <= this (all rows when there are
    fewer distinct ids), and an overflowed one reads this slot's row.
    Fixed-shape ops only (sort, neighbour compare, cumsum): no host sync.
    The association kernel takes it as its per-launch dedup bound."""
    s_ids = torch.sort(slot.reshape(-1)).values
    newrun = torch.cat([torch.ones((1,), dtype=torch.bool,
                                   device=s_ids.device),
                        s_ids[1:] != s_ids[:-1]])
    rank = torch.cumsum(newrun.to(torch.int32), 0, dtype=torch.int32) - 1
    low = torch.full_like(s_ids, torch.iinfo(torch.int32).min)
    return torch.amax(torch.where(rank < capacity, s_ids, low)).reshape(1)


def dedup_capacity(cfg, M):
    """Compact-table rows of a dedup gather over M queries.  Raises
    ValueError for `cfg.dedup_capacity` < 1 (a table of no rows)."""
    if int(cfg.dedup_capacity) < 1:
        raise ValueError(f"dedup_capacity must be at least 1, got "
                         f"{cfg.dedup_capacity}")
    return int(cfg.dedup_capacity) * M


def gather_rows(vm: VoxelMap, slot, cfg):
    """The (M, S, 4 cpr) stencil rows of `slot` and their validity (None
    without `cfg.dedup_gather`): the plain gather, or the reference's
    dedup gather with `dedup_capacity(cfg, M)` compact rows."""
    if getattr(cfg, "dedup_gather", False):
        return _dedup_gather_rows(vm.cells, slot,
                                  dedup_capacity(cfg, slot.shape[0]))
    return vm.cells[slot.to(torch.int64)], None


def query_candidates(vm: VoxelMap, q, mask, cfg):
    """Stencil candidate block for each query point — no selection.

    Returns (dx, dy, dz, d2, ok), each (M, S, cpr): centroid offsets from
    the query, squared distances (inf where invalid) and validity.  Under
    `cfg.dedup_gather` every one of the M queries' window rows, masked or
    not, takes part in the ranking, as in the reference.
    """
    px, py, pz = _pack(cfg)
    cpr = _cpr(cfg)
    dtype = q.dtype
    dev = q.device

    v, sv, slot, key = stencil_addresses(q, cfg)
    rows, dedup_ok = gather_rows(vm, slot, cfg)              # (M,S,4cpr)
    sum_x = rows[..., 0:cpr]
    sum_y = rows[..., cpr:2 * cpr]
    sum_z = rows[..., 2 * cpr:3 * cpr]
    meta = rows[..., 3 * cpr:4 * cpr]
    key_st = torch.floor(meta / _META_MOD)
    cnt = meta - key_st * _META_MOD
    ok = (key_st == key[..., None]) & (cnt > 0) & mask[:, None, None]
    if dedup_ok is not None:
        ok = ok & dedup_ok[..., None]

    subg = _grid(px, py, pz, dev)
    for ax, (sub_i, p_i, s_i) in enumerate(
            [(subg[0], px, cfg.stencil_x), (subg[1], py, cfg.stencil_y),
             (subg[2], pz, cfg.stencil_z)]):
        off = (sv[..., ax:ax + 1] * p_i + sub_i[None, None, :]
               - v[:, None, ax:ax + 1])
        ok = ok & (torch.abs(off) <= s_i)
    inv_cnt = 1.0 / torch.clamp(cnt, min=1.0)

    sub_x = (subg[0].to(dtype) * cfg.voxel_size)[None, None, :]
    sub_y = (subg[1].to(dtype) * cfg.voxel_size)[None, None, :]
    sub_z = (subg[2].to(dtype) * cfg.voxel_size)[None, None, :]
    bx = sv[..., 0:1].to(dtype) * (px * cfg.voxel_size) - q[:, None, 0:1]
    by = sv[..., 1:2].to(dtype) * (py * cfg.voxel_size) - q[:, None, 1:2]
    bz = sv[..., 2:3].to(dtype) * (pz * cfg.voxel_size) - q[:, None, 2:3]
    dx = bx + sub_x + sum_x * inv_cnt
    dy = by + sub_y + sum_y * inv_cnt
    dz = bz + sub_z + sum_z * inv_cnt
    d2 = dx * dx + dy * dy + dz * dz
    d2 = torch.where(ok, d2, torch.full_like(d2, float("inf")))
    return dx, dy, dz, d2, ok


def query_candidates_dense(vm: VoxelMap, q, mask, cfg):
    """`query_candidates` as dense (M, C) blocks (bf16 when
    cfg.dense_bf16; +inf survives the cast, so d2d carries validity)."""
    dx, dy, dz, d2, ok = query_candidates(vm, q, mask, cfg)
    M = q.shape[0]
    C = d2.shape[1] * d2.shape[2]
    if getattr(cfg, "dense_bf16", False):
        r = lambda a: a.reshape(M, C).to(torch.bfloat16)
    else:
        r = lambda a: a.reshape(M, C)
    return r(dx), r(dy), r(dz), r(d2)


def shift_dense_blocks(dense, delta, cfg):
    """Re-express cached dense candidate blocks at moved query positions:
    offsets (centroid - q0) - delta, validity carried by d2d = +inf."""
    dxd, dyd, dzd, d2d = dense
    f32 = delta.dtype
    ok = torch.isfinite(d2d.to(f32))
    dx = dxd.to(f32) - delta[:, 0:1]
    dy = dyd.to(f32) - delta[:, 1:2]
    dz = dzd.to(f32) - delta[:, 2:3]
    d2 = torch.where(ok, dx * dx + dy * dy + dz * dz,
                     torch.full_like(dx, float("inf")))
    out_dtype = d2d.dtype
    return (dx.to(out_dtype), dy.to(out_dtype), dz.to(out_dtype),
            d2.to(out_dtype))


def kth_smallest_dense(d2d, k: int):
    """k-th smallest entry per row of a dense (M, C) block, tie-INCLUSIVE:
    the smallest distinct value whose cumulative count reaches k (inf when
    fewer than k finite entries)."""
    inf = torch.full((), float("inf"), dtype=d2d.dtype, device=d2d.device)
    ms = []
    t = torch.full((d2d.shape[0],), float("-inf"), dtype=d2d.dtype,
                   device=d2d.device)
    for _ in range(k):
        t = torch.amin(torch.where(d2d > t[:, None], d2d, inf), dim=1)
        ms.append(t)
    mstack = torch.stack(ms, dim=1)
    cnts = torch.sum(d2d[:, :, None] <= mstack[:, None, :], dim=1)
    return torch.amin(torch.where(cnts >= k, mstack, inf), dim=1)


def kth_smallest(d2, ok, k: int):
    """k-th smallest valid entry per query of an (M, S, cpr) candidate
    block (inf when fewer than k are valid), tie-inclusive as
    `kth_smallest_dense`."""
    M = d2.shape[0]
    cur = torch.where(ok, d2, torch.full_like(d2, float("inf")))
    return kth_smallest_dense(cur.reshape(M, -1), k)


def select_k_smallest(d2, ok, k: int):
    """Value-threshold k-smallest selection over the candidate axes:
    (t_k (M,), n (M,) selected count, w (M, S, cpr) selection mask).  Plain
    torch, as in the reference (XLA there, not a Pallas kernel); it serves
    calibration, not the estimator."""
    t = kth_smallest(d2, ok, k)
    w = ok & (d2 <= t[:, None, None])
    n = torch.sum(w, dim=(1, 2))
    return t, n, w


def query_knn(vm: VoxelMap, q, mask, cfg):
    """k nearest map centroids per query: (neighbors (M,K,3), valid (M,K),
    dist2 (M,K)), ascending; ties keep the lower candidate index, as the
    reference's `lax.top_k` does."""
    cpr = _cpr(cfg)
    M = q.shape[0]
    dx, dy, dz, d2, ok = query_candidates(vm, q, mask, cfg)
    C = d2.shape[1] * cpr
    srt = torch.sort(d2.reshape(M, C), dim=1, stable=True)
    idx = srt.indices[:, :cfg.knn]
    take = lambda a: torch.gather(a.reshape(M, C), 1, idx)
    nbr = torch.stack([take(dx), take(dy), take(dz)], dim=-1) + q[:, None, :]
    return nbr, take(ok), srt.values[:, :cfg.knn]


def cell_centroids(vm: VoxelMap, cfg):
    """All cell centroids (C,3) with a validity mask (C,)."""
    px, py, pz = _pack(cfg)
    sdx, sdy, sdz = _sdims(cfg)
    cpr = _cpr(cfg)
    n = sdx * sdy * sdz * cpr
    dev = vm.cells.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    slot = idx // cpr
    sub = idx % cpr
    mz = slot % sdz
    my = (slot // sdz) % sdy
    mx = slot // (sdz * sdy)
    keyi = torch.floor(vm.meta / _META_MOD).to(torch.int32)
    qz = (keyi & 31) - 16
    qy = ((keyi >> 5) & 31) - 16
    qx = ((keyi >> 10) & 31) - 16
    sux = sub // (py * pz)
    suy = (sub // pz) % py
    suz = sub % pz
    v = torch.stack([(qx * sdx + mx) * px + sux,
                     (qy * sdy + my) * py + suy,
                     (qz * sdz + mz) * pz + suz], dim=-1)
    cnt = vm.count
    valid = cnt > 0
    centroid = (v.to(torch.float32) * cfg.voxel_size
                + vm.sum_rel / torch.clamp(cnt, min=1.0)[:, None])
    return centroid, valid
