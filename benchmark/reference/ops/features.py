"""Edge / planar feature extraction (port of mmloam_tpu/ops/features.py).

Labels per point: 0 none, 1 corner, 2 surf, with the reference's five
phases (adaptive curvature, per-segment flat selection, break corners,
depth-gap corners, final labels).  Lines are a batch axis here; the
per-segment sequential passes (`features.py:95,108,122`) are Python loops
over the S curvature-ordered positions, batched over lines x segments.
"""

from __future__ import annotations

import torch

BIG = 1e9


def _norm(a):
    return torch.sqrt(torch.sum(a * a, dim=-1))


def _fma(a, b, c):
    """a * b + c rounded once, as a fused multiply-add rounds it.

    XLA:CPU contracts the curvature's multiply-adds into FMAs.  On
    noise-free rings many points of one wall have curvatures a few f32
    ulps apart, so rounding twice (as separate torch ops do) reorders them
    and changes which points become surf picks.  The f64 product of two
    f32 values is exact; only a rare double rounding of the f64 sum can
    differ from a hardware FMA."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def _cosang(a, b):
    return torch.sum(a * b, dim=-1) / torch.clamp(_norm(a) * _norm(b),
                                                  min=1e-9)


def _segment_pass(order, curv, depth, angle, reflect, flat_th_sq, curv_half,
                  gap_ok_r, gap_ok_l, th_num_flat):
    """Sequential pass over segments in curvature-ascending order.

    All inputs carry a leading segment-batch axis R: order/curv/... (R, S),
    gap_ok_* (R, S, 3).  Returns segment-local flags (R, S): 0 none,
    1 suppressed neighbor, 2 chosen flat, 3 flat candidate, 300
    reflectivity pick (unionFeatureExtract.cpp:481-539).
    """
    R, S = order.shape
    dev = order.device
    iota = torch.arange(S, device=dev)[None, :]

    def sel_at(arr, pos):
        return torch.gather(arr, 1, pos[:, None])[:, 0]

    gr = [gap_ok_r[..., j].to(torch.int32) for j in range(3)]
    gl = [gap_ok_l[..., j].to(torch.int32) for j in range(3)]
    flags = torch.zeros((R, S), dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    for k in range(S):
        pos = order[:, k]
        fpos = sel_at(flags, pos)
        is_cand = (fpos == 0) & (sel_at(curv, pos) < sel_at(flat_th_sq, pos))
        at = iota == pos[:, None]
        flags = torch.where(at & is_cand[:, None], 3 * one, flags)
        half = sel_at(curv_half, pos)
        for l in (1, 2, 3):
            ok_r = (l <= half) & is_cand & (sel_at(gr[l - 1], pos) == 1)
            ok_l = (l <= half) & is_cand & (sel_at(gl[l - 1], pos) == 1)
            flags = torch.where((iota == pos[:, None] + l) & ok_r[:, None]
                                & (flags == 0), one, flags)
            flags = torch.where((iota == pos[:, None] - l) & ok_l[:, None]
                                & (flags == 0), one, flags)

    picked = torch.ones((R,), dtype=torch.int32, device=dev)
    for k in range(S):
        pos = order[:, k]
        fpos = sel_at(flags, pos)
        sel = (((fpos == 3) & (picked <= th_num_flat))
               | ((fpos == 3) & (sel_at(depth, pos) > 50.0))
               | (sel_at(angle, pos) == 1))
        picked = picked + sel.to(torch.int32)
        flags = torch.where((iota == pos[:, None]) & sel[:, None], 2 * one,
                            flags)

    finite_r = torch.where(torch.isfinite(reflect), reflect,
                           torch.full_like(reflect, BIG))
    rorder = torch.sort(finite_r, dim=1, stable=True).indices
    rpicked = torch.ones((R,), dtype=torch.int32, device=dev)
    for k in range(S):
        pos = rorder[:, k]
        sel = ((sel_at(curv, pos) < 0.7 * sel_at(flat_th_sq, pos))
               & (rpicked <= 3) & (sel_at(reflect, pos) > 20.0))
        rpicked = rpicked + sel.to(torch.int32)
        flags = torch.where((iota == pos[:, None]) & sel[:, None],
                            300 * one, flags)
    return flags


def extract_scan_features(pts, intensity, n_valid, cfg):
    """Feature labels for padded scan lines: pts (..., L, N, 3), intensity
    (..., L, N), n_valid (..., L).  Returns int32 labels (..., L, N).
    Lines are independent, so the lanes of a batch (leading axes) join the
    line axis: every per-segment pass runs once for all of them."""
    L, N = pts.shape[-3:-1]
    labels = _line_labels(pts.reshape(-1, N, 3), intensity.reshape(-1, N),
                          n_valid.reshape(-1), cfg)
    return labels.reshape(tuple(pts.shape[:-3]) + (L, N))


def extract_line_features(pts, intensity, n_valid, cfg):
    """Feature labels for one padded scan line: pts (N, 3), intensity
    (N,), n_valid () -> int32 labels (N,): 0 none, 1 corner, 2 surf."""
    n = torch.as_tensor(n_valid, device=pts.device).reshape(1)
    return _line_labels(pts[None], intensity[None], n, cfg)[0]


def _line_labels(pts, intensity, n_valid, cfg):
    """`extract_scan_features` of lines pts (L, N, 3)."""
    f = cfg.feature
    L, N = pts.shape[:2]
    dtype = pts.dtype
    dev = pts.device
    n_valid = n_valid.to(torch.int64)[:, None]                    # (L,1)
    idx = torch.arange(N, device=dev)[None, :]
    valid = idx < n_valid
    interior = valid & (idx >= 5) & (idx < torch.clamp(n_valid - 5, min=0))

    # -------- phase 1: curvature & friends (:407-451) --------
    dis = _norm(pts)
    p_prev = torch.roll(pts, 1, dims=1)
    p_next = torch.roll(pts, -1, dims=1)

    angle_last = _cosang(p_prev - pts, pts)
    angle_next = _cosang(p_next - pts, pts)
    both_steep = (torch.abs(angle_last) > 0.966) & (torch.abs(angle_next)
                                                    > 0.966)
    ch_hi = f.th_num_curv_size
    ch_lo = max(f.th_num_curv_size - 1, 1)
    curv_half = torch.where((dis > f.th_distance_faraway) | both_steep,
                            ch_lo, ch_hi).to(torch.int32)
    angle_flag = (both_steep & interior).to(torch.int32)

    # the first multiply-add here and the sum of squares below round once,
    # as the reference's fused CPU code does (see _fma)
    def window_sum(x, s):
        acc = _fma(torch.full_like(x, -2.0 * s), x, torch.roll(x, 1, dims=1))
        acc = acc + torch.roll(x, -1, dims=1)
        for j in range(2, s + 1):
            acc = acc + torch.roll(x, j, dims=1) + torch.roll(x, -j, dims=1)
        return acc

    curvs, refls = [], []
    for s in (ch_lo, ch_hi):
        dx = window_sum(pts[..., 0], s)
        dy = window_sum(pts[..., 1], s)
        dz = window_sum(pts[..., 2], s)
        curvs.append(_fma(dz, dz, _fma(dy, dy, dx * dx)))
        refls.append(window_sum(intensity, s))
    curvature = torch.where(curv_half == ch_lo, curvs[0], curvs[1])
    reflect = torch.where(curv_half == ch_lo, refls[0], refls[1])
    flat_th_sq = (f.th_flat_threshold * dis) ** 2

    gap_sq = torch.sum((p_next - pts) ** 2, dim=-1)

    def chain_ok(shift_sign):
        oks = []
        ok = torch.ones((L, N), dtype=torch.bool, device=dev)
        for l in range(1, 4):
            if shift_sign > 0:
                g = torch.roll(gap_sq, -(l - 1), dims=1)
            else:
                g = torch.roll(gap_sq, l, dims=1)
            ok = ok & (g <= 0.02)
            oks.append(ok & (dis <= f.th_distance_faraway))
        return torch.stack(oks, dim=-1)

    gap_ok_r = chain_ok(+1)
    gap_ok_l = chain_ok(-1)

    # -------- phase 2: segmented flat selection (:453-541) --------
    P = f.th_part_num
    S = max(-(-N // P), 8)
    if N < S:
        # the reference's clip(s_start, 0, N - S) inverts its bounds here
        # (a trace-time shape error there); refuse the shape explicitly
        raise ValueError(f"scan line of {N} points is shorter than the "
                         f"{S}-point feature segment")
    scan_start = 5
    scan_end = torch.clamp(n_valid - 6, min=5)                   # (L,1)
    seg_ids = torch.arange(P, device=dev)[None, :]
    sp = scan_start + torch.div((scan_end - scan_start) * seg_ids, P,
                                rounding_mode="floor")
    ep = scan_start + torch.div((scan_end - scan_start) * (seg_ids + 1), P,
                                rounding_mode="floor")           # (L,P)

    packed = torch.stack(
        [curvature, dis, angle_flag.to(dtype), reflect, flat_th_sq,
         curv_half.to(dtype)]
        + [gap_ok_r[..., j].to(dtype) for j in range(3)]
        + [gap_ok_l[..., j].to(dtype) for j in range(3)], dim=-1)  # (L,N,12)

    start = torch.clamp(sp, 0, N - S)
    g = start[..., None] + torch.arange(S, device=dev)           # (L,P,S)
    rows = torch.gather(
        packed[:, None].expand(L, P, N, 12), 2,
        g[..., None].expand(L, P, S, 12))                        # (L,P,S,12)
    in_seg = (g >= sp[..., None]) & (g < ep[..., None])
    R = L * P
    rs = lambda a: a.reshape((R,) + tuple(a.shape[2:]))
    big = torch.full((), BIG, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    c = torch.where(in_seg, rows[..., 0], big)
    order = torch.sort(rs(c), dim=1, stable=True).indices
    in3 = in_seg[..., None]
    seg_flags = _segment_pass(
        order, rs(c),
        rs(torch.where(in_seg, rows[..., 1], zero)),
        rs(torch.where(in_seg, rows[..., 2].to(torch.int32),
                       torch.zeros((), dtype=torch.int32, device=dev))),
        rs(torch.where(in_seg, rows[..., 3], -big)),
        rs(torch.where(in_seg, rows[..., 4], -torch.ones_like(zero))),
        rs(torch.where(in_seg, rows[..., 5].to(torch.int32),
                       torch.zeros((), dtype=torch.int32, device=dev))),
        rs((rows[..., 6:9] > 0.5) & in3),
        rs((rows[..., 9:12] > 0.5) & in3),
        f.th_num_flat).reshape(L, P, S)
    seg_flags = torch.where(in_seg, seg_flags, torch.zeros_like(seg_flags))
    # segment windows stay inside [0, N) (start is clipped), so the
    # reference's scatter-max with mode="drop" drops nothing here
    flags = torch.zeros((L, N), dtype=torch.int32, device=dev)
    flags = flags.scatter_reduce(1, g.reshape(L, P * S),
                                 seg_flags.reshape(L, P * S), reduce="amax",
                                 include_self=True)
    flags = torch.where(interior, flags, torch.zeros_like(flags))

    # -------- phase 3: break corners, flag 150 (:543-650) --------
    def side_curv(sign):
        acc = pts.clone()
        for j, w in ((1, 1.0), (2, -4.0), (3, 1.0), (4, 1.0)):
            acc = acc + w * torch.roll(pts, sign * j, dims=1)
        return torch.sum(acc * acc, dim=-1)

    left_curv = side_curv(+1)
    right_curv = side_curv(-1)
    left_flat = left_curv < f.th_flat_threshold * dis
    right_flat = right_curv < f.th_flat_threshold * dis

    def weighted_norm(sign):
        acc = torch.zeros_like(pts)
        for k in range(1, 5):
            d = torch.roll(pts, -sign * k, dims=1) - pts
            d = d / torch.clamp(_norm(d)[..., None], min=1e-9)
            acc = acc + (k / 10.0) * d
        return acc

    norm_left = weighted_norm(-1)
    norm_right = weighted_norm(+1)
    cc_fold = torch.abs(_cosang(norm_left, norm_right))
    last_dis = _norm(torch.roll(pts, 4, dims=1) - pts)
    curr_dis = _norm(torch.roll(pts, -4, dims=1) - pts)
    break_cond = (left_flat & right_flat & (cc_fold < 0.5)
                  & (last_dis > 0.05) & (curr_dis > 0.05) & interior)
    flags = torch.where(break_cond, torch.full_like(flags, 150), flags)

    # -------- phase 4: depth-gap corners, 100 -> 101 (:651-806) --------
    dr0 = _norm(p_next - pts)
    dl0 = _norm(p_prev - pts)
    depth_right = torch.roll(dis, -1, dims=1)
    depth_left = torch.roll(dis, 1, dims=1)
    gap_break = torch.abs(dr0 - dl0) > f.th_break_corner_dis

    cc_left = torch.abs(_cosang(p_prev - pts, pts))
    cc_right = torch.abs(_cosang(p_next - pts, pts))
    right_farther = dr0 > dl0
    cond_rf = (gap_break & right_farther & (cc_left < 0.95)
               & ((depth_right > depth_left) | (depth_right == 0)))
    cond_lf = (gap_break & ~right_farther & (cc_right < 0.95)
               & ((depth_right < depth_left) | (depth_left == 0)))
    is_gap_corner = (cond_rf | cond_lf) & interior

    def masked_norm(sign):
        acc = torch.zeros_like(pts)
        for k in range(1, 4):
            nb = torch.roll(pts, -sign * k, dims=1)
            ok = _norm(nb) >= 1.0
            d = nb - pts
            d = d / torch.clamp(_norm(d)[..., None], min=1e-9)
            acc = acc + torch.where(ok[..., None], (k / 6.0) * d,
                                    torch.zeros_like(d))
        return acc

    nf = masked_norm(-1)
    nb = masked_norm(+1)
    cc_gap = torch.abs(_cosang(nf, nb))
    accepted_gap = is_gap_corner & (cc_gap < 0.95)
    flags = torch.where(is_gap_corner,
                        torch.where(accepted_gap, torch.full_like(flags, 100),
                                    torch.full_like(flags, 101)), flags)

    # -------- phase 5: final labels (:818-842) --------
    near_ok = dis * dis >= f.th_lidar_nearest_dis ** 2
    labels = torch.zeros((L, N), dtype=torch.int32, device=dev)
    labels = torch.where(interior & near_ok & (flags == 2),
                         torch.full_like(labels, 2), labels)
    labels = torch.where(interior & near_ok & ((flags == 100)
                                               | (flags == 150)),
                         torch.ones_like(labels), labels)
    return labels
