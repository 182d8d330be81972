"""Masked voxel-grid downsample to fixed-capacity point stacks
(port of mmloam_tpu/ops/downsample.py:41-176).

Same design: a lexicographic (class, voxel) sort groups each voxel's points
into a contiguous segment, a segmented inclusive scan of
[rel_x rel_y rel_z (extra) 1] read at segment ends gives each centroid, and
a second sort compacts the segment ends to the front in (class, voxel-key)
order.  The reference's 2-key `lax.sort` is two stable `torch.sort`
passes (secondary key first).
"""

from __future__ import annotations

import torch

from .scan import associative_scan

_I32_BIG = 2 ** 30


def _seg_scan_sum(vals, starts):
    """Segmented INCLUSIVE prefix sum along axis 0.

    vals (N, ..., K) f32, starts (N, ...) bool (True at each segment's
    first row; trailing batch axes are independent).  A combine whose right
    operand holds a segment start discards the left partial, so sums never
    cross segments.
    """
    def comb(a, b):
        av, af = a
        bv, bf = b
        return torch.where(bf[..., None], bv, av + bv), af | bf

    return associative_scan(comb, (vals, starts))[0]


def _wrap_i32(x):
    """Two's-complement wrap of an int64 tensor to int32 (the reference's
    intentional int32 overflow in the key packing)."""
    return (((x + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32)


def _stable_argsort2(k1, k2):
    """Permutation sorting by (k1, k2) lexicographically, ties in order."""
    p = torch.sort(k2, stable=True).indices
    p2 = torch.sort(k1[p], stable=True).indices
    return p[p2]


def voxel_downsample_multi(pts, masks, leaves, capacities, table: int = 8192,
                           extra=None):
    """Downsample disjoint point classes of one scan in one sorted sweep.

    Returns a list of (out (capacity, 3), out_mask (capacity,), n ()) per
    class, plus the voxel-mean `extra` payload (capacity,) as a 4th element
    when `extra` is given.  `table` is ignored (API compatibility).
    """
    n_cls = len(masks)
    if n_cls > 8:
        raise ValueError("key packing supports at most 8 classes")
    N = pts.shape[0]
    dtype = pts.dtype
    dev = pts.device

    key1 = torch.full((N,), _I32_BIG, dtype=torch.int32, device=dev)
    key2 = torch.zeros((N,), dtype=torch.int32, device=dev)
    rel = torch.zeros((N, 3), dtype=dtype, device=dev)
    corner = torch.zeros((N, 3), dtype=dtype, device=dev)
    for c, (mask, leaf) in enumerate(zip(masks, leaves)):
        v = torch.floor(pts / leaf).to(torch.int32)
        v64 = v.to(torch.int64)
        k1 = _wrap_i32(c * (1 << 27) + (v64[:, 0] + (1 << 26)))
        # (v_y + 2^15) << 16 overflows int32 on purpose (a raw bit
        # pattern compared as signed): build in int64, wrap explicitly
        k2 = _wrap_i32(((v64[:, 1] + (1 << 15)) << 16)
                       | ((v64[:, 2] + (1 << 15)) & 0xFFFFFFFF))
        key1 = torch.where(mask, k1, key1)
        key2 = torch.where(mask, k2, key2)
        cornr = v.to(dtype) * leaf
        rel = torch.where(mask[:, None], pts - cornr, rel)
        corner = torch.where(mask[:, None], cornr, corner)

    perm = _stable_argsort2(key1, key2)
    k1s, k2s = key1[perm], key2[perm]
    rels, corners = rel[perm], corner[perm]
    exs = extra.to(dtype)[perm] if extra is not None else None

    valid_s = k1s < _I32_BIG
    change = (k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1])
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    starts = torch.cat([one, change])
    ends = torch.cat([change, one])
    cols = [rels[:, 0], rels[:, 1], rels[:, 2]]
    if exs is not None:
        cols.append(exs)
    pay = torch.stack(cols + [torch.ones((N,), dtype=dtype, device=dev)],
                      dim=-1)
    seg = _seg_scan_sum(pay, starts)

    ok_end = ends & valid_s
    cls_s = torch.where(valid_s, k1s >> 27,
                        torch.full_like(k1s, n_cls))
    cnt = torch.clamp(seg[:, -1:], min=1.0)
    centroid = corners + seg[:, 0:3] / cnt
    emean = seg[:, 3] / cnt[:, 0] if exs is not None else None

    # compact ok segment-ends to the front, preserving (class, voxel) order
    grank = torch.cumsum(ok_end.to(torch.int32), dim=0) - 1
    key3 = torch.where(ok_end, grank, torch.full_like(grank, _I32_BIG))
    perm3 = torch.sort(key3, stable=True).indices
    max_cap = max(capacities)
    padz = torch.zeros((max_cap,), dtype=dtype, device=dev)
    ocx = torch.cat([centroid[perm3, 0], padz])
    ocy = torch.cat([centroid[perm3, 1], padz])
    ocz = torch.cat([centroid[perm3, 2], padz])
    oce = torch.cat([emean[perm3], padz]) if emean is not None else None

    okf = ok_end.to(torch.int32)
    outs = []
    for c, capacity in enumerate(capacities):
        n_before = torch.sum(okf * (cls_s < c))
        n = torch.sum(okf * (cls_s == c))
        # n_before + capacity <= N + max_cap, so the reference's
        # dynamic_slice never clamps: a plain offset gather is equal
        take = n_before + torch.arange(capacity, device=dev)
        out_mask = torch.arange(capacity, device=dev) < n
        out = torch.stack([ocx[take], ocy[take], ocz[take]], dim=-1)
        out = torch.where(out_mask[:, None], out, torch.zeros_like(out))
        n = n.to(torch.int32)
        if oce is not None:
            e = torch.where(out_mask, oce[take], torch.zeros_like(oce[take]))
            outs.append((out, out_mask, n, e))
        else:
            outs.append((out, out_mask, n))
    return outs


def voxel_downsample(pts, mask, leaf: float, capacity: int, table: int = 8192):
    """Downsample `pts (N,3)` with validity `mask (N,)` to <= `capacity`."""
    return voxel_downsample_multi(pts, [mask], [leaf], [capacity], table)[0]
