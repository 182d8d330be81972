"""The LIO pipeline: one batched step over the lanes of a lockstep batch
(port of mmloam_tpu/pipeline.py).

Per scan: features on the raw rings, IMU prediction, undistortion, voxel
downsampled stacks, window push, the windowed estimate, acceptance gates
with the direction-selective degenerate update, post-solve re-deskew,
deferred map inserts, and the IMU-init bookkeeping.

`step_core_batch(states, scans, cfg)` is the counterpart of the
reference's `jax.vmap(step_core)` (mmloam_tpu/replay.py:201-208): every
field of `states` and `scans` carries a leading lane axis B and every
function it reaches takes it.  `step_core` and `step` are the reference's
unbatched step (mmloam_tpu/replay.py:159-161): the same code at one lane
(a lane axis of 1 added and dropped) with `one` set, where each of the
nine per-lane conditionals below takes one branch (`branch.cond`) and the
LM runs only the iterations its lane needs (`branch.loop`).  The skipped
work is what the lockstep selects drop, so its results are the lockstep
step's at one lane, bit for bit.  The lockstep translation rules:

* `lax.cond` under `vmap` runs both branches for every lane and selects
  per lane (`estimate.select`, `torch.where`): can_estimate
  (mmloam_tpu/pipeline.py:661), do_refine (:804), inited | imu_mode <= 1
  (:806), phase == 0 (:870), try_init (:897), res.ok (:992), do_refresh
  (estimator/estimate.py:239) and the LM's skip (estimator/solver.py:312).
  Branches on the config alone stay Python `if`s (imu_mode, use_nonfeature,
  velo_only_mode, use_local_map, gravity_refine_every > 0); what the
  reference decides per lane is a tensor per lane (the threshold schedule,
  weight_tan, huber, the LM caps, the marginalization flag, the old-slot
  choice, read with a gather).  Two of these selects, inited | imu_mode
  <= 1 and try_init, keep their branch's result in few lanes and few
  scans: under a capture each is an IF node on "any lane takes it"
  (`branch.any_lane`, the second inside the first), so a replay runs the
  init bookkeeping only while a lane is un-inited and the init solve
  only on scans where a lane attempts it; the select inside decides per
  lane as before.
* `while_loop` (estimator/solver.py:319) runs the largest lane's cap with
  a done flag per lane; a lane stops at its own cap or convergence and
  keeps its carry, so it gets the iterates it would get alone.
* Nothing reads the device from the host: no `.item()`, no `bool()`,
  `int()` or `float()` of a device tensor, no boolean-mask indexing, and
  no library call that checks its result on the host (the
  marginalization's eigen-decompositions run through the kernel K3,
  `ops/eigh.py`).  Constants are built once (`lie.const`).  So a scan
  can be captured as a CUDA graph and replayed (`replay._ScanGraph`, the
  counterpart of `jax.jit` over `lax.scan`).
* A branch a lane does not take must neither fail nor write: eigh is fed
  identity where a lane's matrix is not finite, the factorizations are
  the `_ex` kinds with NaN on failure, and the slot writes of the
  keyframe and init bookkeeping build new tensors that the select takes.
  The maps are written only by `apply_inserts_batched`.

The default path, `config.faithful_config()`, the rig's modes
(`imu_mode` 0/1, `velo_only_mode`, `use_nonfeature`) and every map option
of the reference (any superrow pack whose dims divide the map, any
stencil, `dedup_gather`) are ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import branch, lie, spans
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
    # each lane's downsampled corner and surf points of the scan before
    # the stack caps (max_corner, max_surf) keep the first of them (the
    # port's own: the JAX package's StepOutput has no such field)
    n_corner_ds: torch.Tensor
    n_surf_ds: torch.Tensor


class LIOState(NamedTuple):
    """One sequence's state (shapes below); a batch carries a leading lane
    axis B on every field."""

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
        dq=lie.const((1.0, 0.0, 0.0, 0.0), dtype, device).repeat(W, 1),
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

def _lane(tree):
    """`tree` with a leading lane axis of 1 (views of its tensors)."""
    return tree_map(lambda a: a[None], tree)


def _unlane(tree):
    """`tree` without its lane axis of 1."""
    return tree_map(lambda a: a[0], tree)


def _clamp_norm(v, max_norm):
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return v * torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)


def _body_pose(x15):
    return lie.exp_quat(x15[..., 3:6]), x15[..., 0:3]


def _lidar_pose(x15, Rbl, tbl):
    q_wb, p_wb = _body_pose(x15)
    q_bl = lie.matrix_to_quat(Rbl)
    q_wl = lie.quat_mul(q_wb, q_bl)
    p_wl = lie.quat_rotate(q_wb, tbl) + p_wb
    return q_wl, p_wl


def _roll_push(a, new):
    """Each lane's roll(a, -1) along its window axis (1) with the last slot
    set to `new`."""
    return torch.cat([a[:, 1:], new[:, None].to(a.dtype)], dim=1)


def _single(a, new):
    """zeros_like(a) with each lane's last slot set to `new`."""
    return torch.cat([torch.zeros_like(a[:, 1:]), new[:, None].to(a.dtype)],
                     dim=1)


def _set_last(a, new):
    return torch.cat([a[:, :-1], new[:, None].to(a.dtype)], dim=1)


def _at(a, idx):
    """a[b, idx[b]] for each lane b: a per-lane slot, read by a gather."""
    return a[torch.arange(a.shape[0], device=a.device), idx]


def _select_state(m, a: "LIOState", b: "LIOState"):
    """Per lane, state `a` where m (B,) else `b`; the maps, which the step
    never writes, are b's (a `lax.cond` over the state under `vmap`)."""
    keep = {f: getattr(b, f) for f in MAP_FIELDS}
    drop = {f: None for f in MAP_FIELDS}
    return est.select(m, a._replace(**drop), b._replace(**drop)
                      )._replace(**keep)


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
    """Label split + voxel downsample into each lane's fixed stacks; with
    cfg.use_nonfeature the unlabelled points form a third class.  Returns
    the FrameStack and each lane's downsampled corner and surf points
    before the caps (int32, (B,) each)."""
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
    (corner, cmask, n_c, crel), (surf, smask, n_s, srel) = outs[0], outs[1]
    extra = {}
    if cfg.use_nonfeature:
        non, nmask, _, nrel = outs[2]
        extra = dict(non=non.to(dtype), non_mask=nmask,
                     non_rel=nrel.to(dtype))
    return FrameStack(corner=corner.to(dtype), corner_mask=cmask,
                      surf=surf.to(dtype), surf_mask=smask,
                      corner_rel=crel.to(dtype), surf_rel=srel.to(dtype),
                      **extra), n_c, n_s


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
    n_corner_ds: torch.Tensor
    n_surf_ds: torch.Tensor


def prepare_frame(state: LIOState, scan: ScanInput, cfg) -> PreparedFrame:
    """Features, prediction, undistortion, stacks, window push of one
    sequence: `prepare_frame_batch` at one lane."""
    return _unlane(prepare_frame_batch(_lane(state), _lane(scan), cfg))


def prepare_frame_batch(state: LIOState, scan: ScanInput, cfg
                        ) -> PreparedFrame:
    """Features, prediction, undistortion, stacks, window push of every
    lane (state and scan with a leading lane axis B)."""
    dtype = state.x.dtype
    dev = state.x.device
    B = state.x.shape[0]
    ident_q = lie.const((1.0, 0.0, 0.0, 0.0), dtype, dev)
    lane_sel = lambda m, a, b: torch.where(m[:, None], a, b)

    # ---- 1. features on the raw rings ----
    labels = features.extract_scan_features(scan.pts, scan.intensity,
                                            scan.n_valid, cfg)
    ring_valid = (torch.arange(scan.pts.shape[-2], device=dev)
                  < scan.n_valid[..., None])
    use_hori = scan.hori_pts is not None and not cfg.velo_only_mode
    with spans.layer("fusion"):
        if use_hori:
            hlabels = features.extract_scan_features(
                scan.hori_pts, scan.hori_intensity, scan.hori_n_valid, cfg)
            h_valid = (torch.arange(scan.hori_pts.shape[-2], device=dev)
                       < scan.hori_n_valid[..., None])
            h_dist2 = torch.sum(scan.hori_pts * scan.hori_pts, dim=-1)
            h_valid = (h_valid
                       & (h_dist2 >= cfg.feature.near_points_threshold ** 2)
                       & (h_dist2 <= cfg.feature.far_points_threshold ** 2))

    # rotation gates from the interval's first/last gyro sample (:746-766)
    gz = scan.imu_gyr[..., 2]
    n_imu = torch.sum(scan.imu_mask.to(torch.int32), dim=-1)
    gz0 = gz[:, 0]
    gzN = _at(gz, torch.clamp(n_imu - 1, min=0))
    have_imu = n_imu > 0
    fs = cfg.failsafe
    slow_rotation = have_imu & ((torch.abs(gz0) < fs.hori_rotate_th)
                                | (torch.abs(gzN) < fs.hori_rotate_th))
    fast_rotation = have_imu & ((torch.abs(gz0) > fs.velo_rotate_th)
                                | (torch.abs(gzN) > fs.velo_rotate_th))

    # ---- 2. prediction ----
    x_prev = state.x[:, -1]
    q_prev, p_prev = _body_pose(x_prev)
    have_prev = state.frame_valid[:, -1]
    pre = preintegration.preintegrate(
        scan.imu_acc, scan.imu_gyr, scan.imu_dt, scan.imu_mask,
        x_prev[:, 9:12], x_prev[:, 12:15], cfg.imu)
    dq_gyro = preintegration.gyro_integrate(scan.imu_gyr, scan.imu_dt,
                                            scan.imu_mask)
    # post-init: preintegration prediction, with the velocity and gravity
    # terms only under cfg.predict_full_kinematics (the reference omits
    # them, unionPoseEstimation.cpp:806-817)
    q_pred_full = lie.quat_normalize(lie.quat_mul(q_prev, pre.dq))
    if cfg.predict_full_kinematics:
        dt_scan = pre.dtime.to(dtype)[:, None]
        p_pred_full = (p_prev + x_prev[:, 6:9] * dt_scan
                       + 0.5 * state.gravity * dt_scan * dt_scan
                       + lie.quat_rotate(q_prev, pre.dp))
        v_pred_full = (x_prev[:, 6:9] + state.gravity * dt_scan
                       + lie.quat_rotate(q_prev, pre.dv))
    else:
        p_pred_full = p_prev + lie.quat_rotate(q_prev, pre.dp)
        v_pred_full = x_prev[:, 6:9] + lie.quat_rotate(q_prev, pre.dv)
    # imu_mode 0 has no IMU: the pre-init rotation replays the previous
    # body delta; modes >= 1 integrate the gyro (modes <= 1 never
    # initialize, so this is their steady state)
    dq_pre = state.dqb if cfg.imu_mode == 0 else dq_gyro
    q_pred_pre = lie.quat_normalize(lie.quat_mul(q_prev, dq_pre))
    p_pred_pre = p_prev + lie.quat_rotate(q_prev, state.dtb)

    inited = state.inited
    q_pred = lane_sel(inited, q_pred_full, q_pred_pre)
    p_pred = lane_sel(inited, p_pred_full, p_pred_pre)
    v_pred = lane_sel(inited, v_pred_full, x_prev[:, 6:9])
    q_pred = lane_sel(have_prev, q_pred, ident_q.expand(B, 4))
    p_pred = lane_sel(have_prev, p_pred, torch.zeros_like(p_pred))
    x_new = torch.cat([p_pred, lie.log_quat(q_pred), v_pred,
                       x_prev[:, 9:15]], dim=-1)

    # ---- 3. undistortion by the predicted lidar delta (:402-421) ----
    q_bl = lie.matrix_to_quat(state.Rbl)
    q_wl_prev = lie.quat_mul(q_prev, q_bl)
    p_wl_prev = lie.quat_rotate(q_prev, state.tbl) + p_prev
    q_wl_pred = lie.quat_mul(q_pred, q_bl)
    p_wl_pred = lie.quat_rotate(q_pred, state.tbl) + p_pred
    dq_l = lie.quat_mul(lie.quat_conj(q_wl_prev), q_wl_pred)
    dt_l = lie.quat_rotate(lie.quat_conj(q_wl_prev), p_wl_pred - p_wl_prev)
    dq_l = lane_sel(have_prev, dq_l, ident_q.expand(B, 4))
    dt_l = lane_sel(have_prev, dt_l, torch.zeros_like(dt_l))

    flat_pts = scan.pts.reshape(B, -1, 3).to(dtype)
    flat_rel = scan.rel_time.reshape(B, -1).to(dtype)
    flat_lab = labels.reshape(B, -1)
    flat_ok = ring_valid.reshape(B, -1)
    hori_merged = torch.zeros((B,), dtype=torch.bool, device=dev)
    with spans.layer("fusion"):
        if use_hori:
            h_corner_cnt = torch.sum(
                ((hlabels == 1) & h_valid).reshape(B, -1), dim=-1)
            hori_merged = slow_rotation & (
                h_corner_cnt > cfg.solver.corner_cnt_gate_hori)
            flat_pts = torch.cat(
                [flat_pts, scan.hori_pts.reshape(B, -1, 3).to(dtype)], 1)
            flat_rel = torch.cat(
                [flat_rel, scan.hori_rel_time.reshape(B, -1).to(dtype)], 1)
            flat_lab = torch.cat([flat_lab, hlabels.reshape(B, -1)], 1)
            flat_ok = torch.cat([flat_ok, h_valid.reshape(B, -1)
                                 & hori_merged[:, None]], 1)

    pts_ds = undistort.undistort(flat_pts, flat_rel, dq_l, dt_l)

    # ---- 4. stacks ----
    fstack, n_corner_ds, n_surf_ds = _build_stacks(
        pts_ds, flat_rel, flat_lab, flat_ok, cfg, dtype)

    # ---- 5. window push ----
    new_preint = dict(dq=pre.dq.to(dtype), dp=pre.dp.to(dtype),
                      dv=pre.dv.to(dtype), jac=pre.jac.to(dtype),
                      sqrt_info=(cfg.imu.lidar_m
                                 * preintegration.sqrt_info_from_cov(pre.cov)
                                 ).to(dtype),
                      dt=pre.dtime.to(dtype),
                      bg=x_prev[:, 9:12], ba=x_prev[:, 12:15])
    pair_ok = inited & have_prev & torch.any(scan.imu_mask, dim=-1)

    new_stack = est.Stacks(*fstack)
    push = lambda old, new: est.select(inited, _roll_push(old, new),
                                       _single(old, new))
    fv_true = torch.ones((B,), dtype=torch.bool, device=dev)
    x_w = push(state.x, x_new)
    t_w = push(state.t, scan.t)
    fv_w = push(state.frame_valid, fv_true)
    stacks_w = tree_map(push, state.stacks, new_stack)
    preint_w = {k: push(state.preint[k], new_preint[k]) for k in state.preint}
    pv_w = est.select(inited, _roll_push(state.pair_valid, pair_ok),
                      torch.zeros_like(state.pair_valid))
    prior_w = est.select(inited, state.prior,
                         tree_map(torch.zeros_like, state.prior))
    rfs_w = est.select(inited,
                       tree_map(lambda a: torch.roll(a, -1, dims=1),
                                state.cached_rfs),
                       tree_map(torch.zeros_like, state.cached_rfs))

    return PreparedFrame(x_w=x_w, t_w=t_w, fv_w=fv_w, stacks_w=stacks_w,
                         preint_w=preint_w, pv_w=pv_w, prior_w=prior_w,
                         rfs_w=rfs_w, q_wl_pred=q_wl_pred,
                         p_wl_pred=p_wl_pred, dq_l=dq_l, dt_l=dt_l,
                         q_prev=q_prev, p_prev=p_prev, have_prev=have_prev,
                         fstack=fstack, fast_rotation=fast_rotation,
                         hori_merged=hori_merged, n_corner_ds=n_corner_ds,
                         n_surf_ds=n_surf_ds)


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

    with spans.layer("map_insert"):
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
    of NtN = Σ ω ωᵀ (see the reference).  Leading axes (lanes) broadcast:
    x (..., W, 15), NtN (..., 3, 3), fail (...)."""
    dtype = x_opt.dtype
    evN = linalg3.eigvalsh3(NtN)
    v_lo = linalg3.smallest_eigvec3(NtN, evN)
    v_hi = linalg3.principal_eigvec3(NtN, evN)
    v_mid = lie.cross(v_hi, v_lo)
    VN = torch.stack([v_lo, v_mid, v_hi], dim=-1)
    sv_dir = torch.sqrt(torch.clamp(evN, min=0.0))
    obs = (sv_dir >= degenerate_sv).to(dtype)
    P_obsT = ((VN * obs[..., None, :]) @ VN.transpose(-1, -2)
              ).transpose(-1, -2)
    dP = (x_opt[..., 0:3] - x_w[..., 0:3]) @ P_obsT
    dV = (x_opt[..., 6:9] - x_w[..., 6:9]) @ P_obsT
    x_sel = torch.cat([x_w[..., 0:3] + dP, x_opt[..., 3:6],
                       x_w[..., 6:9] + dV, x_opt[..., 9:15]], dim=-1)
    return torch.where(fail[..., None, None], x_sel, x_opt)


def step(state: LIOState, scan: ScanInput, cfg):
    """One scan of one sequence through the full LIO stack: `step_core`,
    then the scatter map insert."""
    state, out, pend = step_core(state, scan, cfg)
    return apply_inserts(state, pend, cfg), out


def step_core(state: LIOState, scan: ScanInput, cfg):
    """`step` minus the map writes — returns (state, out, PendingInsert):
    the reference's unbatched step_core, one branch of each conditional
    (`step_core_one` without its lane axis)."""
    return _unlane(step_core_one(_lane(state), _lane(scan), cfg))


def step_core_one(state: LIOState, scan: ScanInput, cfg):
    """`step_core` on a lane axis of 1 (state and scan (1, ...)): each
    per-lane conditional takes one branch (`branch.cond`; op by op the
    predicate is read on the host, in a captured graph it is an IF node),
    the LM stops at its lane's end (`branch.loop`).  Bit-equal to
    `step_core_batch` at one lane."""
    if state.x.shape[0] != 1:
        raise ValueError(f"step_core_one takes one lane, got "
                         f"{state.x.shape[0]}")
    return _step_core(state, scan, cfg, one=True)


def step_core_batch(state: LIOState, scan: ScanInput, cfg):
    """One scan of every lane of a batch, minus the map writes: the
    counterpart of the reference's `jax.vmap(step_core)`.  state and scan
    carry a leading lane axis B; returns (state, StepOutput (B, ...),
    PendingInsert (B, ...)).  Every per-lane branch is a select (see the
    module docstring); nothing here reads the device from the host."""
    return _step_core(state, scan, cfg, one=False)


def _step_core(state: LIOState, scan: ScanInput, cfg, one):
    """The step of `step_core_batch` (`one` False: every branch, then a
    select) or of `step_core_one` (`one` True: one branch)."""
    dtype = state.x.dtype
    dev = state.x.device
    W = cfg.solver.window
    B = state.x.shape[0]
    lane_sel = lambda m, a, b: torch.where(m[:, None], a, b)

    with spans.layer("front_end"):
        pf = prepare_frame_batch(state, scan, cfg)
    x_w, t_w, fv_w = pf.x_w, pf.t_w, pf.fv_w
    stacks_w, preint_w, pv_w, prior_w = (pf.stacks_w, pf.preint_w, pf.pv_w,
                                         pf.prior_w)
    q_prev, p_prev, have_prev = pf.q_prev, pf.p_prev, pf.have_prev

    # ---- 6. estimate (lax.cond(can_estimate, estimate, skip)) ----
    n_frames = torch.sum(fv_w, dim=-1)
    full = state.inited & (n_frames == W)
    can_estimate = state.map_has_data
    refresh_slot = state.step_idx % (W - 1)

    def est_branch(_):
        return est.estimate(
            x_w, stacks_w, pf.rfs_w, state.vm_corner, state.vm_surf,
            preint_w, pv_w, prior_w, fv_w, state.gravity, state.Rbl,
            state.tbl, cfg, full_window=full, refresh_slot=refresh_slot,
            vm_local_corner=state.vm_local_corner,
            vm_local_surf=state.vm_local_surf, vm_non=state.vm_non, one=one)

    def skip_branch(_):
        false = torch.zeros((B,), dtype=torch.bool, device=dev)
        zi = torch.zeros((B,), dtype=torch.int32, device=dev)
        return est.EstimateResult(
            x=x_w, degenerate=false, fail=false,
            sv_min=torch.full((B,), -1.0, dtype=dtype, device=dev),
            prior=prior_w, rfs=pf.rfs_w, n_line=zi, n_plane=zi,
            NtN=torch.zeros((B, 3, 3), dtype=dtype, device=dev))

    with spans.layer("estimator"):
        if one:
            res = branch.cond(can_estimate, est_branch, skip_branch, None)
        else:
            res = est.select(can_estimate, est_branch(None),
                             skip_branch(None))
    x_sel = project_degenerate_update(res.x, x_w, res.NtN, res.fail,
                                      cfg.solver.degenerate_sv)
    jump = torch.sqrt(torch.sum((x_sel[:, -1, 0:3] - x_w[:, -1, 0:3]) ** 2,
                                dim=-1))
    revert = res.fail & (jump > cfg.failsafe.max_solve_jump)
    res = res._replace(x=torch.where(revert[:, None, None], x_w, x_sel),
                       prior=res.prior._replace(
                           valid=res.prior.valid & ~res.fail))
    prior_next = res.prior

    # ---- 7. acceptance gates (EstimateLidarPose :1041-1067) ----
    corner_cnt = torch.sum(fv_w[..., None] & stacks_w.corner_mask,
                           dim=(-2, -1))
    accept = corner_cnt > cfg.solver.corner_cnt_gate_velo
    x_opt = res.x
    front_idx = W - n_frames
    x_front = _at(x_opt, front_idx)
    q_pub, p_pub = _lidar_pose(x_front, state.Rbl, state.tbl)
    p_fb = torch.stack([p_pub[:, 0], p_pub[:, 1], pf.p_wl_pred[:, 2]],
                       dim=-1)
    p_pub = lane_sel(accept, p_pub, p_fb)
    q_pub = lane_sel(accept, q_pub, pf.q_wl_pred)
    x_next = x_opt

    # ---- 7b. post-solve re-deskew of the newest frame's stacks ----
    q_bl_c = lie.matrix_to_quat(state.Rbl)
    q_wl_prev_c = lie.quat_mul(q_prev, q_bl_c)
    p_wl_prev_c = lie.quat_rotate(q_prev, state.tbl) + p_prev
    q_wl_new, p_wl_new = _lidar_pose(x_next[:, -1], state.Rbl, state.tbl)
    dq_s = lie.quat_mul(lie.quat_conj(q_wl_prev_c), q_wl_new)
    dt_s = lie.quat_rotate(lie.quat_conj(q_wl_prev_c),
                           p_wl_new - p_wl_prev_c)
    dq_s = lane_sel(have_prev, dq_s, pf.dq_l)
    dt_s = lane_sel(have_prev, dt_s, pf.dt_l)

    def _redeskew(pts_s, rel_s, mask_s):
        fixed = undistort.reundistort(pts_s[:, -1], rel_s[:, -1], pf.dq_l,
                                      pf.dt_l, dq_s, dt_s)
        fixed = torch.where(mask_s[:, -1][..., None], fixed, pts_s[:, -1])
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
        moved = (torch.sum((p_pub - state.last_map_pos) ** 2, dim=-1)
                 >= cfg.solver.map_move_dist_sq)
        do_map_local = do_map & (moved | ~state.map_has_data)
    else:
        do_map_local = do_map
    front_stack = tree_map(lambda a: _at(a, front_idx), stacks_w)
    Rwl = lie.quat_to_matrix(q_pub)
    pend = PendingInsert(
        corner=front_stack.corner, corner_mask=front_stack.corner_mask,
        surf=front_stack.surf, surf_mask=front_stack.surf_mask,
        Rwl=Rwl, p=p_pub, do_map=do_map, do_map_local=do_map_local,
        non=front_stack.non, non_mask=front_stack.non_mask)
    last_map_pos = lane_sel(do_map_local, p_pub, state.last_map_pos)
    map_has_data = state.map_has_data | do_map

    # ---- 9. pre-init bookkeeping + TryMAPInitialization ----
    new_state = state._replace(
        x=x_next, t=t_w, frame_valid=fv_w, stacks=stacks_w,
        preint=preint_w, pair_valid=pv_w, prior=prior_next,
        cached_rfs=res.rfs,
        last_map_pos=last_map_pos, map_has_data=map_has_data,
        dqb=lane_sel(have_prev,
                     lie.quat_mul(lie.quat_conj(q_prev),
                                  lie.exp_quat(x_next[:, -1, 3:6])),
                     state.dqb),
        dtb=lane_sel(have_prev,
                     _clamp_norm(lie.quat_rotate(lie.quat_conj(q_prev),
                                                 x_next[:, -1, 0:3] - p_prev),
                                 cfg.failsafe.max_pred_delta),
                     state.dtb),
        step_idx=state.step_idx + 1)

    # ---- 9b. periodic online gravity re-refinement ----
    if cfg.solver.gravity_refine_every > 0:
        do_refine = (state.inited & full & can_estimate & (~res.fail)
                     & (new_state.step_idx % cfg.solver.gravity_refine_every
                        == 0))

        def refine(s):
            g_new, v_new = initializer.refine_gravity(
                s.x, s.preint, s.pair_valid, s.gravity, cfg.imu.gnorm)
            lin_J = s.prior.lin_J
            lin_J = torch.cat([lin_J[..., 0:6],
                               torch.zeros_like(lin_J[..., 6:9]),
                               lin_J[..., 9:15]], dim=-1)
            px0 = s.prior.x0
            px0 = torch.cat([px0[:, 0:6], v_new[:, 0], px0[:, 9:15]], dim=-1)
            x = torch.cat([s.x[..., 0:6], v_new, s.x[..., 9:15]], dim=-1)
            return s._replace(gravity=g_new, x=x,
                              prior=s.prior._replace(lin_J=lin_J, x0=px0))

        s = new_state
        with spans.layer("gravity"):
            if one:
                new_state = branch.cond(do_refine, refine, None, s)
            else:
                r = refine(s)
                g_sel, x_sel, prior_sel = est.select(
                    do_refine, (r.gravity, r.x, r.prior),
                    (s.gravity, s.x, s.prior))
                new_state = s._replace(gravity=g_sel, x=x_sel,
                                       prior=prior_sel)

    # modes <= 1 never initialize (init needs the accelerometer); lanes
    # already initialized keep their state
    if cfg.imu_mode > 1:
        fstack = tree_map(lambda a: a[:, -1], stacks_w)

        def book(s):
            return _init_bookkeeping(s, scan, q_pub, p_pub, fstack, cfg, one)

        with spans.layer("init"):
            if one:
                new_state = branch.cond(state.inited, None, book, new_state)
            else:
                # captured, skipped where every lane is inited
                new_state = branch.any_lane(
                    ~state.inited,
                    lambda s: _select_state(state.inited, s, book(s)),
                    new_state, name="init")

    out = StepOutput(
        pose_q=q_pub, pose_p=p_pub, t=_at(t_w, front_idx),
        fail=res.fail, degenerate=res.degenerate,
        sv_min=res.sv_min, inited=new_state.inited,
        n_corner=corner_cnt.to(torch.int32),
        n_surf=torch.sum(fv_w[..., None] & stacks_w.surf_mask,
                         dim=(-2, -1)).to(torch.int32),
        fast_rotation=pf.fast_rotation, hori_merged=pf.hori_merged,
        n_assoc_line=res.n_line, n_assoc_plane=res.n_plane,
        n_corner_ds=pf.n_corner_ds, n_surf_ds=pf.n_surf_ds)
    return new_state, out, pend


_KF_FIELDS = ("kf_x", "kf_t", "kf_stacks", "kf_rfs", "kf_imu", "kf_imu_mask",
              "kf_imu_n", "kf_count")


def _init_bookkeeping(state: LIOState, scan: ScanInput, q_pub, p_pub, fstack,
                      cfg, one=False):
    """Keyframe accumulation + init attempt (unionPoseEstimation :934-985)
    of every lane, its branches selects (with `one`, one branch each)."""
    dtype = state.x.dtype
    dev = state.x.device
    B, Mi = state.kf_imu.shape[0], state.kf_imu.shape[2]
    phase = state.kf_phase
    new_kf_stack = est.Stacks(*fstack)
    rf_cur = tree_map(lambda a: a[:, -1], state.cached_rfs)
    pose = torch.cat([q_pub, p_pub], dim=-1)

    # lax.cond(phase == 0, open_slot, update_slot) over the keyframe fields
    def open_slot(s):
        return (_roll_push(s.kf_x, pose), _roll_push(s.kf_t, scan.t),
                tree_map(_roll_push, s.kf_stacks, new_kf_stack),
                tree_map(_roll_push, s.kf_rfs, rf_cur),
                _roll_push(s.kf_imu, torch.zeros_like(s.kf_imu[:, 0])),
                _roll_push(s.kf_imu_mask,
                           torch.zeros_like(s.kf_imu_mask[:, 0])),
                _roll_push(s.kf_imu_n, torch.zeros_like(s.kf_imu_n[:, 0])),
                torch.clamp(s.kf_count + 1, max=N_KF))

    def update_slot(s):
        return (_set_last(s.kf_x, pose), _set_last(s.kf_t, scan.t),
                tree_map(_set_last, s.kf_stacks, new_kf_stack),
                tree_map(_set_last, s.kf_rfs, rf_cur),
                s.kf_imu, s.kf_imu_mask, s.kf_imu_n, s.kf_count)

    if one:
        kf = branch.cond(phase == 0, open_slot, update_slot, state)
    else:
        kf = est.select(phase == 0, open_slot(state), update_slot(state))
    state = state._replace(**dict(zip(_KF_FIELDS, kf)))

    # append this scan's IMU into the newest keyframe buffer; masked or
    # overflowing samples go to a dropped slot (mode="drop")
    n0 = state.kf_imu_n[:, -1].to(torch.int64)
    samples = torch.cat([scan.imu_acc, scan.imu_gyr, scan.imu_dt[..., None]],
                        dim=-1).to(dtype)
    idx = n0[:, None] + torch.arange(samples.shape[1], device=dev)
    idx = torch.where(scan.imu_mask & (idx < Mi), idx, torch.full_like(idx, Mi))
    buf = torch.cat([state.kf_imu[:, -1],
                     torch.zeros((B, 1, 7), dtype=dtype, device=dev)], dim=1)
    buf = buf.scatter(1, idx[..., None].expand(samples.shape), samples)
    mbuf = torch.cat([state.kf_imu_mask[:, -1],
                      torch.zeros((B, 1), dtype=torch.bool, device=dev)],
                     dim=1)
    mbuf = mbuf.scatter(1, idx, torch.ones_like(scan.imu_mask))
    n_new = torch.clamp(n0 + torch.sum(scan.imu_mask.to(torch.int64), dim=-1),
                        max=Mi)
    state = state._replace(
        kf_imu=_set_last(state.kf_imu, buf[:, :Mi]),
        kf_imu_mask=_set_last(state.kf_imu_mask, mbuf[:, :Mi]),
        kf_imu_n=_set_last(state.kf_imu_n, n_new.to(state.kf_imu_n.dtype)))

    avg = -preintegration.average_acc(scan.imu_acc, scan.imu_mask, cfg.imu)
    state = state._replace(
        avg_acc=torch.where(((state.kf_count == 1) & (phase == 0))[:, None],
                            avg.to(dtype), state.avg_acc))

    phase_next = (phase + 1) % KF_EVERY
    try_init = (phase_next == 0) & (state.kf_count == N_KF)
    state = state._replace(kf_phase=phase_next)
    if one:
        return branch.cond(try_init, lambda s: _try_init(s, cfg, None, True),
                           None, state)
    # captured, skipped where no lane attempts
    return branch.any_lane(try_init, lambda s: _try_init(s, cfg, try_init),
                           state, name="init_solve")


def _try_init(state: LIOState, cfg, attempt, one=False):
    """TryMAPInitialization (:425-627) + window seeding on success, for the
    lanes of `attempt` (B,) whose solve passes its gates; every lane runs
    it, the others keep `state` (lax.cond under vmap).  With `one` the
    caller has taken the attempt's branch (`attempt` unused) and the
    seeding runs only where the solve passed (lax.cond(res.ok, ...))."""
    dtype = state.x.dtype
    dev = state.x.device
    B = state.x.shape[0]
    W = cfg.solver.window
    lead = W - N_KF

    def pre_all(bg, ba):
        bg = bg[:, None].expand(B, N_KF, 3)
        ba = ba[:, None].expand(B, N_KF, 3)
        return preintegration.preintegrate(
            state.kf_imu[..., 0:3], state.kf_imu[..., 3:6],
            state.kf_imu[..., 6], state.kf_imu_mask, bg, ba, cfg.imu)

    z3 = torch.zeros((B, 3), dtype=dtype, device=dev)
    pr = pre_all(z3, z3)
    preint9 = dict(dq=pr.dq, dp=pr.dp, dv=pr.dv, jac=pr.jac, cov=pr.cov,
                   dt=pr.dtime, bg=pr.bg, ba=pr.ba)
    RblT = state.Rbl.transpose(-1, -2)
    Rlb = RblT
    tlb = -(RblT @ state.tbl[..., None])[..., 0]
    res = initializer.initialize(state.kf_x[..., 4:7], state.kf_x[..., 0:4],
                                 state.avg_acc, preint9, cfg.imu.gnorm,
                                 Rlb, tlb,
                                 gravity_prior_w=cfg.init_gravity_prior_w,
                                 bias_bound=cfg.failsafe.init_bias_bound,
                                 velocity_bound=cfg.failsafe.init_velocity_bound)

    def seed(kf, n=lead, tail=0):
        """zeros in the first n window slots, then kf (B, k, ...), then
        `tail` zero slots."""
        z = lambda k: torch.zeros((B, k) + tuple(kf.shape[2:]),
                                  dtype=kf.dtype, device=dev)
        return torch.cat([z(n), kf] + ([z(tail)] if tail else []), dim=1)

    def seed_window(s):
        """`s` with its window seeded from the keyframes and the solve
        (the reference's on_ok)."""
        xs = []
        for i in range(N_KF):
            q_l = s.kf_x[:, i, 0:4]
            p_l = s.kf_x[:, i, 4:7]
            if i == N_KF - 1:
                q_b = lie.quat_mul(q_l, lie.matrix_to_quat(Rlb))
                p_b = p_l + lie.quat_rotate(q_l, tlb)
            else:
                q_b, p_b = q_l, p_l
            xs.append(torch.cat([p_b, lie.log_quat(q_b), res.v[:, i], res.bg,
                                 res.ba], dim=-1))
        x = seed(torch.stack(xs, dim=1))
        t = seed(s.kf_t)
        fv = seed(torch.ones((B, N_KF), dtype=torch.bool, device=dev))
        stacks = tree_map(lambda a, kf: seed(kf.to(a.dtype)), s.stacks,
                          s.kf_stacks)

        pr2 = pre_all(res.bg, res.ba)
        k1 = N_KF - 1
        rest = dict(dq=pr2.dq[:, 1:], dp=pr2.dp[:, 1:], dv=pr2.dv[:, 1:],
                    jac=pr2.jac[:, 1:],
                    sqrt_info=cfg.imu.lidar_m
                    * preintegration.sqrt_info_from_cov(pr2.cov[:, 1:]),
                    dt=pr2.dtime[:, 1:], bg=res.bg[:, None].expand(B, k1, 3),
                    ba=res.ba[:, None].expand(B, k1, 3))
        empty = _empty_preint(W, dtype, dev)
        preint = {k: torch.cat([empty[k][None, :lead + 1].expand(
            (B, lead + 1) + tuple(empty[k].shape[1:])), rest[k].to(dtype)],
            dim=1) for k in empty}
        pv = seed(torch.ones((B, k1), dtype=torch.bool, device=dev), lead + 1)
        rfs0 = tree_map(lambda a, kf: seed(kf[:, :k1].to(a.dtype), tail=1),
                        s.cached_rfs, s.kf_rfs)
        prior0 = tree_map(lambda a: a.expand((B,) + tuple(a.shape)),
                          solver.empty_prior(dtype, dev))
        inited = torch.ones((B,), dtype=torch.bool, device=dev)
        return s._replace(x=x, t=t, frame_valid=fv, stacks=stacks,
                          preint=preint, pair_valid=pv, inited=inited,
                          gravity=res.gravity.to(dtype), prior=prior0,
                          cached_rfs=rfs0)

    if one:
        return branch.cond(res.ok, seed_window, None, state)
    return _select_state(attempt & res.ok, seed_window(state), state)
