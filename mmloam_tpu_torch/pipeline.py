"""The LIO pipeline: one `step(state, scan) -> (state, output)` (port of
mmloam_tpu/pipeline.py).

Per scan: features on the raw rings, IMU prediction, undistortion, voxel
downsampled stacks, window push, the windowed estimate, acceptance gates
with the direction-selective degenerate update, post-solve re-deskew,
deferred map inserts, and the IMU-init bookkeeping.  The reference's
`lax.cond`s on per-sequence flags are Python branches here (one host read
each); everything else keeps the reference's select-based form.

The default path, `config.faithful_config()`, the rig's modes
(`imu_mode` 0/1, `velo_only_mode`, `use_nonfeature`) and every map option
of the reference (any superrow pack whose dims divide the map, any
stencil, `dedup_gather`) are ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import lie
from .estimator import estimate as est
from .estimator import initializer, reduced, solver
from .ops import (downsample, features, linalg3, preintegration, undistort,
                  voxelmap)
from .tree import tree_map

N_KF = 3          # init keyframes (unionPoseEstimation.cpp:1481)
KF_EVERY = 3      # keyframe cadence (veloPushCount, :947-960)


class ScanInput(NamedTuple):
    """One decoded scan (ring-organized, padded) + its IMU interval."""

    pts: torch.Tensor        # (L, N, 3) lidar frame, skewed
    intensity: torch.Tensor  # (L, N)
    n_valid: torch.Tensor    # (L,) valid prefix length per ring
    rel_time: torch.Tensor   # (L, N) in [0, 1] over the scan interval
    t: torch.Tensor          # () scan timestamp (s)
    imu_acc: torch.Tensor    # (M, 3) specific force, g units
    imu_gyr: torch.Tensor    # (M, 3) rad/s
    imu_dt: torch.Tensor     # (M,)
    imu_mask: torch.Tensor   # (M,)
    hori_pts: torch.Tensor = None        # (Lh, Nh, 3)
    hori_intensity: torch.Tensor = None  # (Lh, Nh)
    hori_n_valid: torch.Tensor = None    # (Lh,)
    hori_rel_time: torch.Tensor = None   # (Lh, Nh)


class StepOutput(NamedTuple):
    pose_q: torch.Tensor     # (4,) published lidar pose T_wl (front frame)
    pose_p: torch.Tensor     # (3,)
    t: torch.Tensor
    fail: torch.Tensor
    degenerate: torch.Tensor
    sv_min: torch.Tensor
    inited: torch.Tensor
    n_corner: torch.Tensor
    n_surf: torch.Tensor
    fast_rotation: torch.Tensor
    hori_merged: torch.Tensor
    n_assoc_line: torch.Tensor
    n_assoc_plane: torch.Tensor


class LIOState(NamedTuple):
    x: torch.Tensor          # (W, 15) body states [P phi V bg ba]
    t: torch.Tensor          # (W,)
    frame_valid: torch.Tensor
    stacks: est.Stacks
    preint: dict             # pair (j-1, j) at slot j
    pair_valid: torch.Tensor
    prior: solver.Prior
    vm_corner: voxelmap.VoxelMap
    vm_surf: voxelmap.VoxelMap
    vm_non: voxelmap.VoxelMap
    vm_local_corner: voxelmap.VoxelMap
    vm_local_surf: voxelmap.VoxelMap
    cached_rfs: reduced.ReducedFactor
    inited: torch.Tensor
    gravity: torch.Tensor
    last_map_pos: torch.Tensor
    map_has_data: torch.Tensor
    dqb: torch.Tensor
    dtb: torch.Tensor
    kf_x: torch.Tensor       # (N_KF, 7) [q, p] lidar pose
    kf_t: torch.Tensor
    kf_stacks: est.Stacks
    kf_rfs: reduced.ReducedFactor
    kf_imu: torch.Tensor     # (N_KF, Mi, 7) [acc, gyr, dt]
    kf_imu_mask: torch.Tensor
    kf_imu_n: torch.Tensor
    kf_count: torch.Tensor
    kf_phase: torch.Tensor
    avg_acc: torch.Tensor
    Rbl: torch.Tensor
    tbl: torch.Tensor
    step_idx: torch.Tensor


MAP_FIELDS = ("vm_corner", "vm_surf", "vm_non", "vm_local_corner",
              "vm_local_surf")


def _empty_preint(W, dtype, device):
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return dict(
        dq=torch.tensor([1.0, 0, 0, 0], dtype=dtype,
                        device=device).repeat(W, 1),
        dp=z(W, 3), dv=z(W, 3),
        jac=torch.eye(15, dtype=dtype, device=device).repeat(W, 1, 1),
        sqrt_info=z(W, 15, 15), dt=z(W), bg=z(W, 3), ba=z(W, 3))


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when it is None.  The port's entry points run
    on the card unless the caller asks for the CPU: with no CUDA device and
    no `device`, this raises and never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the port runs on the card by '
                           'default; pass device="cpu" to run on the CPU')
    return torch.device("cuda")


def init_state(cfg, Rbl=None, tbl=None, dtype=torch.float32, kf_imu_cap=256,
               device=None):
    """Fresh per-sequence state with maps and window on `device` (the card
    when None, see `resolve_device`)."""
    device = resolve_device(device)
    W = cfg.solver.window
    sc = cfg.scan
    z = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=device)
    b = lambda *s: torch.zeros(s, dtype=torch.bool, device=device)

    def make_stacks(n):
        extra = {}
        if cfg.use_nonfeature:
            extra = dict(non=z(n, sc.max_nonfeature, 3),
                         non_mask=b(n, sc.max_nonfeature),
                         non_rel=z(n, sc.max_nonfeature))
        return est.Stacks(
            corner=z(n, sc.max_corner, 3), corner_mask=b(n, sc.max_corner),
            surf=z(n, sc.max_surf, 3), surf_mask=b(n, sc.max_surf),
            corner_rel=z(n, sc.max_corner), surf_rel=z(n, sc.max_surf),
            **extra)

    def placeholder(mcfg):
        return voxelmap.VoxelMap(cells=z(1, voxelmap._cpr(mcfg) * 4,
                                         dt=torch.float32))

    def stacked(rf, n):
        return tree_map(lambda a: a.expand((n,) + tuple(a.shape)).clone(), rf)

    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    return LIOState(
        x=z(W, 15), t=z(W), frame_valid=b(W),
        stacks=make_stacks(W),
        preint=_empty_preint(W, dtype, device),
        pair_valid=b(W),
        prior=solver.empty_prior(dtype, device),
        vm_corner=voxelmap.empty_map(cfg.map, device),
        vm_surf=voxelmap.empty_map(cfg.map, device),
        # the non-feature map is a 1-row placeholder unless it is used
        vm_non=(voxelmap.empty_map(cfg.map, device) if cfg.use_nonfeature
                else placeholder(cfg.map)),
        vm_local_corner=(voxelmap.empty_map(cfg.local_map, device)
                         if cfg.use_local_map else placeholder(cfg.local_map)),
        vm_local_surf=(voxelmap.empty_map(cfg.local_map, device)
                       if cfg.use_local_map else placeholder(cfg.local_map)),
        cached_rfs=stacked(reduced.empty_reduced(dtype, device), W),
        inited=b(),
        gravity=torch.tensor([0.0, 0.0, -cfg.imu.gnorm], dtype=dtype,
                             device=device),
        last_map_pos=z(3), map_has_data=b(),
        dqb=torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=device),
        dtb=z(3),
        kf_x=torch.tensor([1.0, 0, 0, 0, 0, 0, 0], dtype=dtype,
                          device=device).repeat(N_KF, 1),
        kf_t=z(N_KF),
        kf_stacks=make_stacks(N_KF),
        kf_rfs=stacked(reduced.empty_reduced(dtype, device), N_KF),
        kf_imu=z(N_KF, kf_imu_cap, 7),
        kf_imu_mask=b(N_KF, kf_imu_cap),
        kf_imu_n=z(N_KF, dt=torch.int32),
        kf_count=i32(0), kf_phase=i32(0),
        avg_acc=z(3),
        Rbl=(torch.eye(3, dtype=dtype, device=device) if Rbl is None
             else torch.as_tensor(np.asarray(Rbl), dtype=dtype,
                                  device=device)),
        tbl=(z(3) if tbl is None
             else torch.as_tensor(np.asarray(tbl), dtype=dtype,
                                  device=device)),
        step_idx=i32(0))


# --------------------------------------------------------------------------
# numpy <-> port conversion (hands a reference state to the port)
# --------------------------------------------------------------------------

_CONTAINERS = {}


def _containers():
    if not _CONTAINERS:
        _CONTAINERS.update(
            LIOState=LIOState, ScanInput=ScanInput, StepOutput=StepOutput,
            Stacks=est.Stacks, Prior=solver.Prior,
            ReducedFactor=reduced.ReducedFactor, VoxelMap=voxelmap.VoxelMap,
            PendingInsert=PendingInsert)
    return _CONTAINERS


def _from_numpy(tree, device):
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = _containers()[type(tree).__name__]
        return cls(**{k: _from_numpy(getattr(tree, k), device)
                      for k in tree._fields})
    if isinstance(tree, dict):
        return {k: _from_numpy(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int32)
    # np.array copies into a writable C-contiguous array and, unlike
    # np.ascontiguousarray, keeps 0-d leaves 0-d
    return torch.as_tensor(np.array(a), device=device)


def state_from_numpy(tree, device=None) -> LIOState:
    """Port LIOState from a NamedTuple of numpy arrays with the reference's
    field names (e.g. a JAX LIOState after np.asarray on each leaf).
    Floats become float32 and integers int32, as the reference keeps them
    outside x64 test runs.  On the card unless `device` says otherwise."""
    return _from_numpy(tree, resolve_device(device))


def scan_from_numpy(tree, device=None) -> ScanInput:
    """Port ScanInput (possibly with leading time/batch axes) from numpy,
    on the card unless `device` says otherwise."""
    return _from_numpy(tree, resolve_device(device))


def state_to_numpy(state):
    """The same NamedTuple structure with numpy leaves."""
    return tree_map(lambda a: a.detach().cpu().numpy(), state)


# --------------------------------------------------------------------------
# step
# --------------------------------------------------------------------------

def _clamp_norm(v, max_norm):
    n = torch.sqrt(torch.sum(v * v))
    return v * torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)


def _body_pose(x15):
    return lie.exp_quat(x15[3:6]), x15[0:3]


def _lidar_pose(x15, Rbl, tbl):
    q_wb, p_wb = _body_pose(x15)
    q_bl = lie.matrix_to_quat(Rbl)
    q_wl = lie.quat_mul(q_wb, q_bl)
    p_wl = lie.quat_rotate(q_wb, tbl) + p_wb
    return q_wl, p_wl


def _roll_push(a, new):
    """roll(a, -1, axis 0) with the last slot set to `new`."""
    return torch.cat([a[1:], new[None].to(a.dtype)], dim=0)


def _single(a, new):
    """zeros_like(a) with the last slot set to `new`."""
    return torch.cat([torch.zeros_like(a[1:]), new[None].to(a.dtype)], dim=0)


def _set_last(a, new):
    return torch.cat([a[:-1], new[None].to(a.dtype)], dim=0)


class FrameStack(NamedTuple):
    # field order mirrors est.Stacks
    corner: torch.Tensor
    corner_mask: torch.Tensor
    surf: torch.Tensor
    surf_mask: torch.Tensor
    non: torch.Tensor = None
    non_mask: torch.Tensor = None
    corner_rel: torch.Tensor = None
    surf_rel: torch.Tensor = None
    non_rel: torch.Tensor = None


def _build_stacks(flat_pts, flat_rel, flat_labels, flat_valid, cfg, dtype):
    """Label split + voxel downsample into one frame's fixed stacks; with
    cfg.use_nonfeature the unlabelled points form a third class."""
    sc = cfg.scan
    masks = [flat_valid & (flat_labels == 1), flat_valid & (flat_labels == 2)]
    leaves = [sc.filter_corner, sc.filter_surf]
    caps = [sc.max_corner, sc.max_surf]
    if cfg.use_nonfeature:
        masks.append(flat_valid & (flat_labels == 0))
        leaves.append(sc.filter_nonfeature)
        caps.append(sc.max_nonfeature)
    outs = downsample.voxel_downsample_multi(flat_pts, masks, leaves, caps,
                                             extra=flat_rel)
    (corner, cmask, _, crel), (surf, smask, _, srel) = outs[0], outs[1]
    extra = {}
    if cfg.use_nonfeature:
        non, nmask, _, nrel = outs[2]
        extra = dict(non=non.to(dtype), non_mask=nmask,
                     non_rel=nrel.to(dtype))
    return FrameStack(corner=corner.to(dtype), corner_mask=cmask,
                      surf=surf.to(dtype), surf_mask=smask,
                      corner_rel=crel.to(dtype), surf_rel=srel.to(dtype),
                      **extra)


class PreparedFrame(NamedTuple):
    """Stages 1-5 of `step`: window contents ready for the estimator."""

    x_w: torch.Tensor
    t_w: torch.Tensor
    fv_w: torch.Tensor
    stacks_w: est.Stacks
    preint_w: dict
    pv_w: torch.Tensor
    prior_w: solver.Prior
    rfs_w: reduced.ReducedFactor
    q_wl_pred: torch.Tensor
    p_wl_pred: torch.Tensor
    dq_l: torch.Tensor
    dt_l: torch.Tensor
    q_prev: torch.Tensor
    p_prev: torch.Tensor
    have_prev: torch.Tensor
    fstack: FrameStack
    fast_rotation: torch.Tensor
    hori_merged: torch.Tensor


def prepare_frame(state: LIOState, scan: ScanInput, cfg) -> PreparedFrame:
    """Features, prediction, undistortion, stacks, window push."""
    dtype = state.x.dtype
    dev = state.x.device
    ident_q = torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=dev)

    # ---- 1. features on the raw rings ----
    labels = features.extract_scan_features(scan.pts, scan.intensity,
                                            scan.n_valid, cfg)
    ring_valid = (torch.arange(scan.pts.shape[1], device=dev)[None, :]
                  < scan.n_valid[:, None])
    use_hori = scan.hori_pts is not None and not cfg.velo_only_mode
    if use_hori:
        hlabels = features.extract_scan_features(
            scan.hori_pts, scan.hori_intensity, scan.hori_n_valid, cfg)
        h_valid = (torch.arange(scan.hori_pts.shape[1], device=dev)[None, :]
                   < scan.hori_n_valid[:, None])
        h_dist2 = torch.sum(scan.hori_pts * scan.hori_pts, dim=-1)
        h_valid = (h_valid
                   & (h_dist2 >= cfg.feature.near_points_threshold ** 2)
                   & (h_dist2 <= cfg.feature.far_points_threshold ** 2))

    # rotation gates from the interval's first/last gyro sample (:746-766)
    gz = scan.imu_gyr[:, 2]
    n_imu = torch.sum(scan.imu_mask.to(torch.int32))
    gz0 = gz[0]
    gzN = gz[torch.clamp(n_imu - 1, min=0)]
    have_imu = n_imu > 0
    fs = cfg.failsafe
    slow_rotation = have_imu & ((torch.abs(gz0) < fs.hori_rotate_th)
                                | (torch.abs(gzN) < fs.hori_rotate_th))
    fast_rotation = have_imu & ((torch.abs(gz0) > fs.velo_rotate_th)
                                | (torch.abs(gzN) > fs.velo_rotate_th))

    # ---- 2. prediction ----
    x_prev = state.x[-1]
    q_prev, p_prev = _body_pose(x_prev)
    have_prev = state.frame_valid[-1]
    pre = preintegration.preintegrate(
        scan.imu_acc, scan.imu_gyr, scan.imu_dt, scan.imu_mask,
        x_prev[9:12], x_prev[12:15], cfg.imu)
    dq_gyro = preintegration.gyro_integrate(scan.imu_gyr, scan.imu_dt,
                                            scan.imu_mask)
    # post-init: preintegration prediction, with the velocity and gravity
    # terms only under cfg.predict_full_kinematics (the reference omits
    # them, unionPoseEstimation.cpp:806-817)
    q_pred_full = lie.quat_normalize(lie.quat_mul(q_prev, pre.dq))
    if cfg.predict_full_kinematics:
        dt_scan = pre.dtime.to(dtype)
        p_pred_full = (p_prev + x_prev[6:9] * dt_scan
                       + 0.5 * state.gravity * dt_scan * dt_scan
                       + lie.quat_rotate(q_prev, pre.dp))
        v_pred_full = (x_prev[6:9] + state.gravity * dt_scan
                       + lie.quat_rotate(q_prev, pre.dv))
    else:
        p_pred_full = p_prev + lie.quat_rotate(q_prev, pre.dp)
        v_pred_full = x_prev[6:9] + lie.quat_rotate(q_prev, pre.dv)
    # imu_mode 0 has no IMU: the pre-init rotation replays the previous
    # body delta; modes >= 1 integrate the gyro (modes <= 1 never
    # initialize, so this is their steady state)
    dq_pre = state.dqb if cfg.imu_mode == 0 else dq_gyro
    q_pred_pre = lie.quat_normalize(lie.quat_mul(q_prev, dq_pre))
    p_pred_pre = p_prev + lie.quat_rotate(q_prev, state.dtb)

    inited = state.inited
    q_pred = torch.where(inited, q_pred_full, q_pred_pre)
    p_pred = torch.where(inited, p_pred_full, p_pred_pre)
    v_pred = torch.where(inited, v_pred_full, x_prev[6:9])
    q_pred = torch.where(have_prev, q_pred, ident_q)
    p_pred = torch.where(have_prev, p_pred, torch.zeros_like(p_pred))
    x_new = torch.cat([p_pred, lie.log_quat(q_pred), v_pred, x_prev[9:15]])

    # ---- 3. undistortion by the predicted lidar delta (:402-421) ----
    q_bl = lie.matrix_to_quat(state.Rbl)
    q_wl_prev = lie.quat_mul(q_prev, q_bl)
    p_wl_prev = lie.quat_rotate(q_prev, state.tbl) + p_prev
    q_wl_pred = lie.quat_mul(q_pred, q_bl)
    p_wl_pred = lie.quat_rotate(q_pred, state.tbl) + p_pred
    dq_l = lie.quat_mul(lie.quat_conj(q_wl_prev), q_wl_pred)
    dt_l = lie.quat_rotate(lie.quat_conj(q_wl_prev), p_wl_pred - p_wl_prev)
    dq_l = torch.where(have_prev, dq_l, ident_q)
    dt_l = torch.where(have_prev, dt_l, torch.zeros_like(dt_l))

    flat_pts = scan.pts.reshape(-1, 3).to(dtype)
    flat_rel = scan.rel_time.reshape(-1).to(dtype)
    flat_lab = labels.reshape(-1)
    flat_ok = ring_valid.reshape(-1)
    hori_merged = torch.zeros((), dtype=torch.bool, device=dev)
    if use_hori:
        h_corner_cnt = torch.sum((hlabels == 1) & h_valid)
        hori_merged = slow_rotation & (
            h_corner_cnt > cfg.solver.corner_cnt_gate_hori)
        flat_pts = torch.cat([flat_pts,
                              scan.hori_pts.reshape(-1, 3).to(dtype)])
        flat_rel = torch.cat([flat_rel,
                              scan.hori_rel_time.reshape(-1).to(dtype)])
        flat_lab = torch.cat([flat_lab, hlabels.reshape(-1)])
        flat_ok = torch.cat([flat_ok, h_valid.reshape(-1) & hori_merged])

    pts_ds = undistort.undistort(flat_pts, flat_rel, dq_l, dt_l)

    # ---- 4. stacks ----
    fstack = _build_stacks(pts_ds, flat_rel, flat_lab, flat_ok, cfg, dtype)

    # ---- 5. window push ----
    new_preint = dict(dq=pre.dq.to(dtype), dp=pre.dp.to(dtype),
                      dv=pre.dv.to(dtype), jac=pre.jac.to(dtype),
                      sqrt_info=(cfg.imu.lidar_m
                                 * preintegration.sqrt_info_from_cov(pre.cov)
                                 ).to(dtype),
                      dt=pre.dtime.to(dtype),
                      bg=x_prev[9:12], ba=x_prev[12:15])
    pair_ok = inited & have_prev & torch.any(scan.imu_mask)

    new_stack = est.Stacks(*fstack)
    sel = lambda rolled, fresh: torch.where(inited, rolled, fresh)
    x_w = sel(_roll_push(state.x, x_new), _single(state.x, x_new))
    t_w = sel(_roll_push(state.t, scan.t), _single(state.t, scan.t))
    fv_true = torch.ones((), dtype=torch.bool, device=dev)
    fv_w = sel(_roll_push(state.frame_valid, fv_true),
               _single(state.frame_valid, fv_true))
    stacks_w = tree_map(lambda old, new: sel(_roll_push(old, new),
                                             _single(old, new)),
                        state.stacks, new_stack)
    preint_w = {k: sel(_roll_push(state.preint[k], new_preint[k]),
                       _single(state.preint[k], new_preint[k]))
                for k in state.preint}
    pv_w = sel(_roll_push(state.pair_valid, pair_ok),
               torch.zeros_like(state.pair_valid))
    prior_w = tree_map(lambda p: sel(p, torch.zeros_like(p)), state.prior)
    rfs_w = tree_map(lambda a: sel(torch.roll(a, -1, dims=0),
                                   torch.zeros_like(a)), state.cached_rfs)

    return PreparedFrame(x_w=x_w, t_w=t_w, fv_w=fv_w, stacks_w=stacks_w,
                         preint_w=preint_w, pv_w=pv_w, prior_w=prior_w,
                         rfs_w=rfs_w, q_wl_pred=q_wl_pred,
                         p_wl_pred=p_wl_pred, dq_l=dq_l, dt_l=dt_l,
                         q_prev=q_prev, p_prev=p_prev, have_prev=have_prev,
                         fstack=fstack, fast_rotation=fast_rotation,
                         hori_merged=hori_merged)


class PendingInsert(NamedTuple):
    """Stage-8 map updates, deferred so a batched driver can apply them
    over all lanes at once (one K1 launch per map)."""

    corner: torch.Tensor       # (Kc, 3) lidar-frame front stack
    corner_mask: torch.Tensor
    surf: torch.Tensor
    surf_mask: torch.Tensor
    Rwl: torch.Tensor          # (3, 3) insertion pose
    p: torch.Tensor            # (3,)
    do_map: torch.Tensor       # () global-map gate
    do_map_local: torch.Tensor = None
    non: torch.Tensor = None
    non_mask: torch.Tensor = None


def _insert_targets(cfg):
    """(state field, PendingInsert points field, map config, gate field)."""
    out = [("vm_corner", "corner", cfg.map, "do_map"),
           ("vm_surf", "surf", cfg.map, "do_map")]
    if cfg.use_nonfeature:
        out.append(("vm_non", "non", cfg.map, "do_map"))
    if cfg.use_local_map:
        out += [("vm_local_corner", "corner", cfg.local_map, "do_map_local"),
                ("vm_local_surf", "surf", cfg.local_map, "do_map_local")]
    return out


def apply_inserts(state: LIOState, pend: PendingInsert, cfg):
    """Single-sequence map insertion through the scatter `voxelmap.insert`
    (returns new maps; the input state's maps are left as they were)."""
    upd = {}
    for field, pts_f, mcfg, gate_f in _insert_targets(cfg):
        pts = getattr(pend, pts_f)
        wpts = pts @ pend.Rwl.T + pend.p[None, :]
        ok = (getattr(pend, pts_f + "_mask") & getattr(pend, gate_f)
              & voxelmap.insert_guard(wpts, pend.p, mcfg))
        upd[field] = voxelmap.insert(getattr(state, field), wpts, ok, mcfg)
    return state._replace(**upd)


def apply_inserts_batched(state: LIOState, pend: PendingInsert, cfg):
    """Map insertion over a leading batch axis through the CUDA row-RMW
    kernel (ops/map_insert.py): one launch per map.  The maps are updated
    IN PLACE.  Semantics == per-lane apply_inserts."""
    from .ops import map_insert

    for field, pts_f, mcfg, gate_f in _insert_targets(cfg):
        pts = getattr(pend, pts_f)
        wpts = (torch.einsum("bki,bji->bkj", pts, pend.Rwl)
                + pend.p[:, None, :])
        ok = (getattr(pend, pts_f + "_mask")
              & getattr(pend, gate_f)[:, None]
              & voxelmap.insert_guard(wpts, pend.p, mcfg))
        map_insert.insert_batched(getattr(state, field).cells, wpts, ok,
                                  mcfg)
    return state


def project_degenerate_update(x_opt, x_w, NtN, fail, degenerate_sv):
    """Direction-selective degenerate update (stage 7a): when `fail`,
    translation/velocity deltas are projected onto the observable subspace
    of NtN = Σ ω ωᵀ (see the reference)."""
    dtype = x_opt.dtype
    evN = linalg3.eigvalsh3(NtN)
    v_lo = linalg3.smallest_eigvec3(NtN, evN)
    v_hi = linalg3.principal_eigvec3(NtN, evN)
    v_mid = lie.cross(v_hi, v_lo)
    VN = torch.stack([v_lo, v_mid, v_hi], dim=1)
    sv_dir = torch.sqrt(torch.clamp(evN, min=0.0))
    obs = (sv_dir >= degenerate_sv).to(dtype)
    P_obs = (VN * obs[None, :]) @ VN.T
    dP = (x_opt[:, 0:3] - x_w[:, 0:3]) @ P_obs.T
    dV = (x_opt[:, 6:9] - x_w[:, 6:9]) @ P_obs.T
    x_sel = torch.cat([x_w[:, 0:3] + dP, x_opt[:, 3:6], x_w[:, 6:9] + dV,
                       x_opt[:, 9:15]], dim=1)
    return torch.where(fail, x_sel, x_opt)


def step(state: LIOState, scan: ScanInput, cfg):
    """One scan through the full LIO stack."""
    state, out, pend = step_core(state, scan, cfg)
    return apply_inserts(state, pend, cfg), out


def step_core(state: LIOState, scan: ScanInput, cfg):
    """`step` minus the map writes — returns (state, out, PendingInsert)."""
    dtype = state.x.dtype
    dev = state.x.device
    W = cfg.solver.window

    pf = prepare_frame(state, scan, cfg)
    x_w, t_w, fv_w = pf.x_w, pf.t_w, pf.fv_w
    stacks_w, preint_w, pv_w, prior_w = (pf.stacks_w, pf.preint_w, pf.pv_w,
                                         pf.prior_w)
    q_prev, p_prev, have_prev = pf.q_prev, pf.p_prev, pf.have_prev

    # ---- 6. estimate ----
    n_frames = torch.sum(fv_w)
    full = state.inited & (n_frames == W)
    can_estimate = state.map_has_data
    refresh_slot = state.step_idx % (W - 1)
    false = torch.zeros((), dtype=torch.bool, device=dev)

    if bool(can_estimate):
        res = est.estimate(
            x_w, stacks_w, pf.rfs_w, state.vm_corner, state.vm_surf,
            preint_w, pv_w, prior_w, fv_w, state.gravity, state.Rbl,
            state.tbl, cfg, full_window=full, refresh_slot=refresh_slot,
            vm_local_corner=state.vm_local_corner,
            vm_local_surf=state.vm_local_surf, vm_non=state.vm_non)
    else:
        zi = torch.zeros((), dtype=torch.int32, device=dev)
        res = est.EstimateResult(
            x=x_w, degenerate=false, fail=false,
            sv_min=torch.tensor(-1.0, dtype=dtype, device=dev),
            prior=prior_w, rfs=pf.rfs_w, n_line=zi, n_plane=zi,
            NtN=torch.zeros((3, 3), dtype=dtype, device=dev))
    x_sel = project_degenerate_update(res.x, x_w, res.NtN, res.fail,
                                      cfg.solver.degenerate_sv)
    jump = torch.sqrt(torch.sum((x_sel[-1, 0:3] - x_w[-1, 0:3]) ** 2))
    revert = res.fail & (jump > cfg.failsafe.max_solve_jump)
    res = res._replace(x=torch.where(revert, x_w, x_sel),
                       prior=res.prior._replace(
                           valid=res.prior.valid & ~res.fail))
    prior_next = res.prior

    # ---- 7. acceptance gates (EstimateLidarPose :1041-1067) ----
    corner_cnt = torch.sum(fv_w[:, None] & stacks_w.corner_mask)
    accept = corner_cnt > cfg.solver.corner_cnt_gate_velo
    x_opt = res.x
    front_idx = W - n_frames
    x_front = x_opt[front_idx]
    q_pub, p_pub = _lidar_pose(x_front, state.Rbl, state.tbl)
    p_fb = torch.stack([p_pub[0], p_pub[1], pf.p_wl_pred[2]])
    p_pub = torch.where(accept, p_pub, p_fb)
    q_pub = torch.where(accept, q_pub, pf.q_wl_pred)
    x_next = x_opt

    # ---- 7b. post-solve re-deskew of the newest frame's stacks ----
    q_bl_c = lie.matrix_to_quat(state.Rbl)
    q_wl_prev_c = lie.quat_mul(q_prev, q_bl_c)
    p_wl_prev_c = lie.quat_rotate(q_prev, state.tbl) + p_prev
    q_wl_new, p_wl_new = _lidar_pose(x_next[-1], state.Rbl, state.tbl)
    dq_s = lie.quat_mul(lie.quat_conj(q_wl_prev_c), q_wl_new)
    dt_s = lie.quat_rotate(lie.quat_conj(q_wl_prev_c),
                           p_wl_new - p_wl_prev_c)
    dq_s = torch.where(have_prev, dq_s, pf.dq_l)
    dt_s = torch.where(have_prev, dt_s, pf.dt_l)

    def _redeskew(pts_s, rel_s, mask_s):
        fixed = undistort.reundistort(pts_s[-1], rel_s[-1], pf.dq_l,
                                      pf.dt_l, dq_s, dt_s)
        fixed = torch.where(mask_s[-1][:, None], fixed, pts_s[-1])
        return _set_last(pts_s, fixed)

    stacks_w = stacks_w._replace(
        corner=_redeskew(stacks_w.corner, stacks_w.corner_rel,
                         stacks_w.corner_mask),
        surf=_redeskew(stacks_w.surf, stacks_w.surf_rel,
                       stacks_w.surf_mask),
        **(dict(non=_redeskew(stacks_w.non, stacks_w.non_rel,
                              stacks_w.non_mask))
           if cfg.use_nonfeature else {}))

    # ---- 8. map update (deferred; gating as in the reference) ----
    # the local map is move-gated at map_move_dist_sq only under
    # cfg.solver.local_map_move_gate (Estimator.cpp:1083,:1125)
    do_map = ~res.fail
    if cfg.solver.local_map_move_gate:
        moved = (torch.sum((p_pub - state.last_map_pos) ** 2)
                 >= cfg.solver.map_move_dist_sq)
        do_map_local = do_map & (moved | ~state.map_has_data)
    else:
        do_map_local = do_map
    front_stack = tree_map(lambda a: a[front_idx], stacks_w)
    Rwl = lie.quat_to_matrix(q_pub)
    pend = PendingInsert(
        corner=front_stack.corner, corner_mask=front_stack.corner_mask,
        surf=front_stack.surf, surf_mask=front_stack.surf_mask,
        Rwl=Rwl, p=p_pub, do_map=do_map, do_map_local=do_map_local,
        non=front_stack.non, non_mask=front_stack.non_mask)
    last_map_pos = torch.where(do_map_local, p_pub, state.last_map_pos)
    map_has_data = state.map_has_data | do_map

    # ---- 9. pre-init bookkeeping + TryMAPInitialization ----
    new_state = state._replace(
        x=x_next, t=t_w, frame_valid=fv_w, stacks=stacks_w,
        preint=preint_w, pair_valid=pv_w, prior=prior_next,
        cached_rfs=res.rfs,
        last_map_pos=last_map_pos, map_has_data=map_has_data,
        dqb=torch.where(have_prev,
                        lie.quat_mul(lie.quat_conj(q_prev),
                                     lie.exp_quat(x_next[-1][3:6])),
                        state.dqb),
        dtb=torch.where(have_prev,
                        _clamp_norm(lie.quat_rotate(lie.quat_conj(q_prev),
                                                    x_next[-1][0:3] - p_prev),
                                    cfg.failsafe.max_pred_delta),
                        state.dtb),
        step_idx=state.step_idx + 1)

    # ---- 9b. periodic online gravity re-refinement ----
    if cfg.solver.gravity_refine_every > 0:
        do_refine = (state.inited & full & can_estimate & (~res.fail)
                     & (new_state.step_idx % cfg.solver.gravity_refine_every
                        == 0))
        if bool(do_refine):
            s = new_state
            g_new, v_new = initializer.refine_gravity(
                s.x, s.preint, s.pair_valid, s.gravity, cfg.imu.gnorm)
            lin_J = s.prior.lin_J.clone()
            lin_J[:, 6:9] = 0.0
            px0 = s.prior.x0.clone()
            px0[6:9] = v_new[0]
            x = s.x.clone()
            x[:, 6:9] = v_new
            new_state = s._replace(gravity=g_new, x=x,
                                   prior=s.prior._replace(lin_J=lin_J,
                                                          x0=px0))

    # modes <= 1 never initialize (init needs the accelerometer)
    if not (bool(state.inited) or cfg.imu_mode <= 1):
        new_state = _init_bookkeeping(
            new_state, scan, q_pub, p_pub,
            tree_map(lambda a: a[-1], stacks_w), cfg)

    out = StepOutput(
        pose_q=q_pub, pose_p=p_pub, t=t_w[front_idx],
        fail=res.fail, degenerate=res.degenerate,
        sv_min=res.sv_min, inited=new_state.inited,
        n_corner=corner_cnt.to(torch.int32),
        n_surf=torch.sum(fv_w[:, None] & stacks_w.surf_mask).to(torch.int32),
        fast_rotation=pf.fast_rotation, hori_merged=pf.hori_merged,
        n_assoc_line=res.n_line, n_assoc_plane=res.n_plane)
    return new_state, out, pend


def _init_bookkeeping(state: LIOState, scan: ScanInput, q_pub, p_pub, fstack,
                      cfg):
    """Keyframe accumulation + init attempt (unionPoseEstimation :934-985)."""
    dtype = state.x.dtype
    dev = state.x.device
    Mi = state.kf_imu.shape[1]
    phase = state.kf_phase
    new_kf_stack = est.Stacks(*fstack)
    rf_cur = tree_map(lambda a: a[-1], state.cached_rfs)
    pose = torch.cat([q_pub, p_pub])

    if int(phase) == 0:
        state = state._replace(
            kf_x=_roll_push(state.kf_x, pose),
            kf_t=_roll_push(state.kf_t, scan.t),
            kf_stacks=tree_map(_roll_push, state.kf_stacks, new_kf_stack),
            kf_rfs=tree_map(_roll_push, state.kf_rfs, rf_cur),
            kf_imu=_roll_push(state.kf_imu, torch.zeros_like(state.kf_imu[0])),
            kf_imu_mask=_roll_push(state.kf_imu_mask,
                                   torch.zeros_like(state.kf_imu_mask[0])),
            kf_imu_n=_roll_push(state.kf_imu_n,
                                torch.zeros_like(state.kf_imu_n[0])),
            kf_count=torch.clamp(state.kf_count + 1, max=N_KF))
    else:
        state = state._replace(
            kf_x=_set_last(state.kf_x, pose),
            kf_t=_set_last(state.kf_t, scan.t),
            kf_stacks=tree_map(_set_last, state.kf_stacks, new_kf_stack),
            kf_rfs=tree_map(_set_last, state.kf_rfs, rf_cur))

    # append this scan's IMU into the newest keyframe buffer; masked or
    # overflowing samples are dropped (mode="drop")
    n0 = state.kf_imu_n[-1].to(torch.int64)
    samples = torch.cat([scan.imu_acc, scan.imu_gyr, scan.imu_dt[:, None]],
                        dim=-1).to(dtype)
    idx = n0 + torch.arange(samples.shape[0], device=dev)
    idx = torch.where(scan.imu_mask & (idx < Mi), idx, torch.full_like(idx, Mi))
    buf = torch.cat([state.kf_imu[-1], torch.zeros((1, 7), dtype=dtype,
                                                   device=dev)])
    buf = buf.index_put((idx,), samples)
    mbuf = torch.cat([state.kf_imu_mask[-1],
                      torch.zeros((1,), dtype=torch.bool, device=dev)])
    mbuf = mbuf.index_put((idx,), torch.ones_like(scan.imu_mask))
    n_new = torch.clamp(n0 + torch.sum(scan.imu_mask.to(torch.int64)), max=Mi)
    state = state._replace(
        kf_imu=_set_last(state.kf_imu, buf[:Mi]),
        kf_imu_mask=_set_last(state.kf_imu_mask, mbuf[:Mi]),
        kf_imu_n=_set_last(state.kf_imu_n, n_new.to(state.kf_imu_n.dtype)))

    avg = -preintegration.average_acc(scan.imu_acc, scan.imu_mask, cfg.imu)
    state = state._replace(
        avg_acc=torch.where((state.kf_count == 1) & (phase == 0),
                            avg.to(dtype), state.avg_acc))

    phase_next = (phase + 1) % KF_EVERY
    try_init = (phase_next == 0) & (state.kf_count == N_KF)
    state = state._replace(kf_phase=phase_next)
    if bool(try_init):
        state = _try_init(state, cfg)
    return state


def _try_init(state: LIOState, cfg):
    """TryMAPInitialization (:425-627) + window seeding on success."""
    dtype = state.x.dtype
    dev = state.x.device
    z3 = torch.zeros(3, dtype=dtype, device=dev)

    def pre_all(bg, ba):
        prs = [preintegration.preintegrate(
            state.kf_imu[i, :, 0:3], state.kf_imu[i, :, 3:6],
            state.kf_imu[i, :, 6], state.kf_imu_mask[i], bg, ba, cfg.imu)
            for i in range(N_KF)]
        return preintegration.PreintResult(
            *(torch.stack(f) for f in zip(*prs)))

    pr = pre_all(z3, z3)
    preint9 = dict(dq=pr.dq, dp=pr.dp, dv=pr.dv, jac=pr.jac, cov=pr.cov,
                   dt=pr.dtime, bg=pr.bg, ba=pr.ba)
    Rlb = state.Rbl.T
    tlb = -state.Rbl.T @ state.tbl
    res = initializer.initialize(state.kf_x[:, 4:7], state.kf_x[:, 0:4],
                                 state.avg_acc, preint9, cfg.imu.gnorm,
                                 Rlb, tlb,
                                 gravity_prior_w=cfg.init_gravity_prior_w,
                                 bias_bound=cfg.failsafe.init_bias_bound,
                                 velocity_bound=cfg.failsafe.init_velocity_bound)
    if not bool(res.ok):
        return state

    s = state
    W = cfg.solver.window
    x = torch.zeros((W, 15), dtype=dtype, device=dev)
    t = torch.zeros((W,), dtype=dtype, device=dev)
    fv = torch.zeros((W,), dtype=torch.bool, device=dev)

    def seed(a, kf):
        out = torch.zeros_like(a)
        out[W - N_KF:] = kf
        return out

    stacks = tree_map(seed, s.stacks, s.kf_stacks)
    for i in range(N_KF):
        slot = W - N_KF + i
        q_l = s.kf_x[i, 0:4]
        p_l = s.kf_x[i, 4:7]
        if i == N_KF - 1:
            q_b = lie.quat_mul(q_l, lie.matrix_to_quat(Rlb))
            p_b = p_l + lie.quat_rotate(q_l, tlb)
        else:
            q_b, p_b = q_l, p_l
        x[slot] = torch.cat([p_b, lie.log_quat(q_b), res.v[i], res.bg,
                             res.ba])
        t[slot] = s.kf_t[i]
        fv[slot] = True

    pr2 = pre_all(res.bg, res.ba)
    preint = _empty_preint(W, dtype, dev)
    pv = torch.zeros((W,), dtype=torch.bool, device=dev)
    for i in range(1, N_KF):
        slot = W - N_KF + i
        si = cfg.imu.lidar_m * preintegration.sqrt_info_from_cov(pr2.cov[i])
        for k, v in (("dq", pr2.dq[i]), ("dp", pr2.dp[i]), ("dv", pr2.dv[i]),
                     ("jac", pr2.jac[i]), ("sqrt_info", si),
                     ("dt", pr2.dtime[i]), ("bg", res.bg), ("ba", res.ba)):
            preint[k][slot] = v.to(dtype)
        pv[slot] = True

    def seed_rfs(a, kf):
        out = torch.zeros_like(a)
        out[W - N_KF:W - 1] = kf[:N_KF - 1].to(a.dtype)
        return out

    rfs0 = tree_map(seed_rfs, s.cached_rfs, s.kf_rfs)
    return s._replace(x=x, t=t, frame_valid=fv, stacks=stacks,
                      preint=preint, pair_valid=pv,
                      inited=torch.ones((), dtype=torch.bool, device=dev),
                      gravity=res.gravity.to(dtype),
                      prior=solver.empty_prior(dtype, dev),
                      cached_rfs=rfs0)
