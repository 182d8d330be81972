"""Typed static configuration for the whole engine.

The reference scatters configuration across the ROS parameter server
(unionPoseEstimation.cpp:1399-1441, unionFeatureExtract.cpp:234-241,
unionLidarsAligner.cpp:143-154), launch files (launch/mm_lio_full.launch) and
hard-coded constants (Estimator.h:30,326; Map_Manager.h:117-120;
IMUIntegrator.h:79-84; unionFeatureExtract.cpp:353-359).  Here everything is
a frozen (hashable) dataclass so configs can be closed over by `jax.jit`
without retracing, and shapes derived from them are static.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ImuConfig:
    """IMU noise model and constants (reference: IMUIntegrator.h:79-84)."""

    acc_n: float = 0.08          # accelerometer noise density
    gyr_n: float = 0.004         # gyroscope noise density
    acc_w: float = 2.0e-4        # accelerometer bias random walk
    gyr_w: float = 2.0e-5        # gyroscope bias random walk
    lidar_m: float = 1.5e-3      # lidar measurement sigma (point factors)
    gnorm: float = 9.805         # gravity magnitude
    max_samples: int = 64        # static per-scan-interval IMU sample capacity


@dataclass(frozen=True)
class FeatureConfig:
    """Edge/planar feature extraction thresholds
    (reference: unionFeatureExtract.cpp:353-359 and detectFeaturePoints :341).
    """

    th_num_curv_size: int = 3        # half-window for curvature (adaptive 2/3)
    th_distance_faraway: float = 50.0
    th_num_flat: int = 1             # max flats chosen per segment
    th_part_num: int = 50            # segments per scan line
    th_flat_threshold: float = 0.02
    th_lidar_nearest_dis: float = 1.0
    th_break_corner_dis: float = 1.0
    near_points_threshold: float = 2.0   # unionFeatureExtract.cpp:234
    far_points_threshold: float = 50.0


@dataclass(frozen=True)
class ScanConfig:
    """Static scan-tensor geometry (ring-organized, padded)."""

    n_lines: int = 16            # scan lines / rings (VLP-16)
    max_pts_per_line: int = 1024  # padded points per line
    hori_n_lines: int = 6        # Livox Horizon scan lines
    hori_max_pts_per_line: int = 2048
    # static capacities for compacted feature stacks (per scan)
    max_corner: int = 512
    max_surf: int = 2048
    max_nonfeature: int = 512
    # per-frame-stack downsample leaf sizes (reference Estimator.cpp:76-80,
    # launch filter_parameter_corner=0.4 / filter_parameter_surf=0.2)
    filter_corner: float = 0.4
    filter_surf: float = 0.2
    filter_nonfeature: float = 0.4


@dataclass(frozen=True)
class MapConfig:
    """Dense torus voxel-grid map.

    Replaces the reference's 21x11x21 grid of 50 m cubes with per-cube
    kd-trees and VoxelGrid downsampling (Map_Manager.h:117-120,
    Map_Manager.cpp:125-286).  Each cell stores the running centroid of the
    points that fell into it — equivalent to the reference's voxel-grid
    downsampled map at the same leaf size.  Slots are addressed modulo the
    grid dims, so recentering (MapMove, Map_Manager.cpp:288) is free: a cell
    is valid only if its stored integer voxel coordinate matches the queried
    one, which implicitly evicts stale cells as the window scrolls.
    """

    voxel_size: float = 0.4          # leaf size (= reference map downsample)
    dim_x: int = 256                 # torus dims (power of two)
    dim_y: int = 256
    dim_z: int = 64
    count_cap: float = 100.0         # running-mean inertia cap (<= 127:
    #                                  count lives in meta's 7-bit field)
    # superrow packing: fine cells stored (pack_x, pack_y, pack_z) blocks
    # to a 128-lane row so the stencil gather fetches 8 512-byte rows per
    # query instead of 75 16-byte cells (TPU row gathers cost per row,
    # ~10 ns, nearly independent of row size — measured,
    # scripts/gather_bench.py)
    pack_x: int = 4
    pack_y: int = 4
    pack_z: int = 2
    # stencil half-extent per axis for the k-NN gather.  The reference's
    # kd-tree nearestKSearch is range-unbounded (gated afterwards at
    # thres_dist, up to 5 m pre-init); a (2,2,1) stencil reaches ~0.9-1.8 m
    # at the 0.4 m leaf, which bootstraps association on a one-scan-old
    # sparse map where a 27-cell stencil starves (<5 neighbors).
    stencil_x: int = 2
    stencil_y: int = 2
    stencil_z: int = 1
    knn: int = 5                     # neighbors per query (reference: 5-NN)
    # store the DENSE candidate blocks (offsets + squared distances,
    # voxelmap.query_candidates_dense) in bfloat16: halves the HBM traffic
    # of the association pipeline's dominant intermediates (the k-smallest
    # selection re-reads d2d ~6x).  Moment accumulation upcasts to f32
    # in-register, so fit math stays f32; the bf16 quantization (~0.4%
    # relative on offsets <= stencil reach) only perturbs near-tie
    # neighbor selection, which the kd-tree this replaces broke
    # arbitrarily anyway (ATE re-measured on the scene matrix: unchanged).
    dense_bf16: bool = True
    # Two-level superrow gather (scripts/gather_dedup_bench.py, r5):
    # downsampled queries cluster, so the (M, S) stencil gather touches
    # few unique superrows — worst measured unique/M across the scene
    # matrix x {surf, corner} x {persistent, local} query streams is
    # 0.94 (street world, fine local map; hall flagship surf is 0.43 =
    # 5.4% of the M*S rows — BASELINE.md r5).  Gather each unique row
    # ONCE from the big map table into a compact table of
    # `dedup_capacity x M` rows, then expand via cheap compact-table
    # gathers (~3.5 ns/row vs ~9.3 ns/row from the 64 MB table).  Exact:
    # a query position whose unique rank overflows the compact capacity
    # just drops those candidates (same bounded-structure failure mode
    # as every stack cap; capacity 2*M keeps >=2.1x margin at the worst
    # measured stream), never wrong data.
    dedup_gather: bool = False
    dedup_capacity: int = 2          # compact-table rows as multiple of M

    @property
    def dims(self) -> tuple[int, int, int]:
        return (self.dim_x, self.dim_y, self.dim_z)


@dataclass(frozen=True)
class SolverConfig:
    """Sliding-window MAP solver (reference: Estimator.cpp:1143-1581)."""

    window: int = 5                  # SLIDEWINDOWSIZE (Estimator.h:30)
    # outer relinearize/assoc rounds.  The reference runs 5 (:1210) with
    # the member threshold schedule 25-10-1-1-1; rounds 3-5 re-associate
    # at converged poses and change nothing measurable (hall / fast /
    # corridor ATE within noise at 2 vs 3 vs 5 rounds, scripts/
    # ab_outer2 A/B: 2 rounds 0.063/0.101 m vs 3 rounds 0.064/0.109 m),
    # while each round costs a frame association + LM solve in the hot
    # step — AND, because pre-init and post-init sequences share one
    # batched program, a round's association executes for every batch
    # lane regardless of mode (lax.cond under vmap runs both branches).
    # The compiled schedule is 25-10.  Set 5 for the faithful schedule.
    max_outer_iters: int = 2
    max_inner_iters: int = 10        # dogleg iterations per outer (:1428)
    # inner-iteration budget for outer rounds AFTER the first: those solves
    # start from an already-optimized window (only the association targets
    # moved), so they converge in a couple of steps — the reference spends
    # its full 10-iteration Ceres budget there, but each LM iteration is a
    # full residual/Jacobian pass and dominates the step program
    max_inner_iters_later: int = 4
    thres_dist: float = 1.0          # 5th-NN squared-dist gate, full window
    thres_dist_short: float = 25.0   # short-window gate (:1207)
    plan_weight_tan: float = 0.0003  # tangential plane weight (:1203)
    huber_delta_scale: float = 0.1   # HuberLoss(0.1/lidar_m) (:1216)
    # outer-loop convergence (Estimator.cpp:1448): when one LM solve moves
    # every pose by less than these, further re-association rounds are
    # skipped (the reference breaks its iterOpt loop and marginalizes)
    converge_rot_deg: float = 0.05
    converge_trans: float = 0.05
    # inner LM convergence: accepted step's max pose delta below these ->
    # stop iterating.  The reference's OUTER gates are 0.05 m / 0.05 deg
    # (:1448); these inner gates only need to be comfortably below that.
    inner_converge_trans: float = 3.0e-4   # meters
    inner_converge_rot: float = 3.0e-5     # radians
    # marginalization eigen threshold, RELATIVE to the largest eigenvalue
    # (the reference uses absolute 1e-8 in f64, ceresfunc.h:261; the
    # relative form is the f32-meaningful equivalent)
    marg_eps: float = 1.0e-6
    # Point-factor sigma used when BUILDING the marginalization prior.
    # The reference folds point factors into the prior at lidar_m = 1.5 mm
    # (ceresfunc.h:321 sqrt infos), wildly overconfident vs the real map
    # error (>= leaf-size centroid noise); the prior's information then
    # grows ~700 units/scan without forgetting, progressively freezing the
    # window against fresh measurements (measured: monotone backward drift
    # under sustained motion).  0.05 m bounds the prior realistically;
    # set to imu.lidar_m for strict reference behavior.
    marg_point_sigma: float = 0.05
    # Re-associate the NEWEST frame in the first N outer rounds of
    # FULL-window mode (0 = reference behavior).  The reference freezes
    # full-window associations at the entry (predicted) poses (the
    # vLineFeatures cache, Estimator.cpp:160-170); under sustained motion
    # the stale targets lag the true pose, the window under-tracks, and the
    # accelerometer bias absorbs the discrepancy — a measured
    # velocity-decay feedback loop.  The moved-distance-priority OLD-slot
    # refresh (refresh_old_frames below) re-associates any frame whose
    # pose moved since its factors were built, which breaks the loop one
    # scan later at no extra cost; the within-scan post-solve refresh
    # measurably adds nothing on top of it (ab_reassoc A/B: ATE identical
    # at 1 vs 2 refresh rounds, fast-motion scene slightly BETTER without
    # the second) while costing a full frame association per round.
    full_reassoc_rounds: int = 1
    # How many OLD window frames get their cached point factors rebuilt per
    # scan (rotating through slots 0..W-2).  The reference re-associates
    # every window frame every scan (Estimator.cpp:1262-1299); here old
    # frames' factor sets are cached across scans (their poses move
    # millimeters once optimized, so the 5-NN sets are stable) and
    # refreshed round-robin: 1 = each old frame refreshes every W-1 scans
    # (default), W-1 = every old frame refreshed every scan
    # (reference-equivalent cadence, ~4x the association cost).
    refresh_old_frames: int = 1
    # initial trust-region radius for the inner LM loop.  Ceres defaults to
    # 1e4; here 1.0 (meters-scale on the Jacobi-normalized step) measures
    # better — the first predicted window is already near the optimum, and
    # a huge first step along a near-flat direction wastes an iteration
    init_radius: float = 1.0
    min_plane_normals: int = 10      # localizability gate (Estimator.cpp:540)
    # Scatter-rank gate for plane fits: reject 5-NN sets whose middle
    # covariance eigenvalue is below this fraction of the largest (i.e.
    # near-collinear neighborhoods, whose fitted normal is arbitrary).
    # The reference's colPivHouseholderQr fit + 0.2 planarity check accepts
    # such sets (Estimator.cpp:640-668), which both injects junk factors
    # and defeats the localizability check in corridors; 0 disables.
    plane_scatter_ratio: float = 0.01
    degenerate_sv: float = 2.0       # smallest singular value gate (:553)
    # Re-refine the gravity vector against the sliding window every N
    # scans (0 = reference behavior: gravity frozen at init,
    # unionPoseEstimation.cpp:577).  Initializing while the rig
    # accelerates leaves a residual gravity tilt that bleeds velocity at
    # g*sin(tilt) per second forever; the window poses are lidar-pinned,
    # so a small GN over [tilt, window velocities] recovers it online.
    gravity_refine_every: int = 10
    corner_cnt_gate_hori: int = 100  # pose-acceptance / merge gates (:1041,:751)
    corner_cnt_gate_velo: int = 50
    # LOCAL-map insert gating.  The reference runs MapIncrementLocal only
    # after >= 0.5 m^2 of motion (Estimator.cpp:1083,:1125) — a CPU-cost
    # bound on the per-insert kd-tree rebuild, not a semantic requirement.
    # Our insert is a row-RMW kernel whose cost is already paid every scan
    # (the global map IS inserted every non-degenerate scan, :1074-1077 +
    # threadMapIncrement), so the default keeps the fine local history
    # maximally fresh; faithful_config() restores the reference's gate.
    local_map_move_gate: bool = False
    map_move_dist_sq: float = 0.5    # local-map min move (m^2) (:1083,:1125)
    # LOCAL-tier rescue buffer, as a fraction of each stack's size: points
    # whose persistent-map association fails are compacted (first-come) to
    # ceil(frac * M) queries before the local-tier stencil gather — the
    # gather is association's dominant cost and steady-state failure rates
    # are a few percent, so most of the local tier's row traffic vanishes.
    # The cap binds only during the first scans (sparse maps), where the
    # rescued factors already over-constrain the pose.  >= 1.0 disables
    # the compaction (reference-equivalent: the kd-tree local fallback
    # runs for every failed point, Estimator.cpp:283-360).
    local_rescue_frac: float = 0.5


@dataclass(frozen=True)
class FailsafeConfig:
    """Failure detection / fallback gates (SURVEY §5.3)."""

    velo_rotate_th: float = 1.5      # |yaw rate| gates (launch :45-46)
    hori_rotate_th: float = 0.3
    # NOTE: the reference's cross-sensor hori/velo pose-divergence gates
    # (unionPoseEstimation.cpp:1196-1260) are DEAD CODE in the shipped
    # reference (newHoriFullCloud=false at :690) and are formally descoped —
    # see PARITY.md "Descoped" — so no cross_* thresholds exist here.
    init_bias_bound: float = 0.5     # init sanity (unionPoseEstimation.cpp:583)
    init_velocity_bound: float = 2.0
    # sanity clamp on the pre-init constant-motion replay delta (m/scan):
    # keeps one bad degenerate solve from becoming permanent dead-reckoning
    # runaway (the reference has no guard here and relies on Ceres behaving)
    max_pred_delta: float = 1.0
    # When the localizability check flags failure (sv_min < degenerate_sv)
    # AND the optimized newest pose jumped further than this from the
    # prediction, the whole solve is untrusted and the window reverts to
    # the predicted states: in a degenerate corridor the cost surface is
    # flat along the unobservable direction and the solver can slide
    # meters per scan on junk-factor noise (the reference commits such
    # poses too, Estimator.cpp:1046; this guard dead-reckons through the
    # degenerate stretch instead and re-anchors once sv recovers)
    max_solve_jump: float = 0.3


@dataclass(frozen=True)
class LIOConfig:
    """Top-level engine configuration."""

    imu: ImuConfig = ImuConfig()
    feature: FeatureConfig = FeatureConfig()
    scan: ScanConfig = ScanConfig()
    map: MapConfig = MapConfig()
    # Fine-leaf recent-history map: the reference's 50-frame local map
    # (MapIncrementLocal, Estimator.cpp:1585-1643; surf leaf 0.2 =
    # filter_parameter_surf), queried when the persistent-map association
    # misses (the kd-tree local branch, Estimator.cpp:283-360).  The
    # smaller torus period (38.4 m here) plays the role of the 50-frame
    # ring: cells more than half a period behind the pose alias out,
    # which at the reference's >=0.7 m insert spacing is ~27-55 frames of
    # history.  The tier is consulted per point whenever the persistent
    # association fails (starvation OR fit-gate rejection); its
    # pack/stencil may differ from `map` (fits are computed per map and
    # merged by a validity select, factors._plane_fit/_line_fit).
    local_map: MapConfig = MapConfig(voxel_size=0.2, dim_x=192, dim_y=192,
                                     dim_z=32)
    use_local_map: bool = True
    # Association engine: the pure-XLA path (voxelmap row gather + fused
    # moment reductions) is the production engine — it beat the fused
    # Pallas association kernel end-to-end on v5e at flagship shapes
    # (121.7 vs 117.3 scans/sec/chip, r3; the manual-DMA variant was 2x
    # slower still).  The kernel family is archived in
    # scripts/pallas_assoc.py with one interpret-mode equivalence test.
    solver: SolverConfig = SolverConfig()
    failsafe: FailsafeConfig = FailsafeConfig()
    velo_only_mode: bool = False     # reference: Velo_Only_Mode rosparam
    imu_mode: int = 2                # 0: none, 1: gyro predict, 2: tightly coupled
    # Non-feature ICP path (Estimator::processNonFeatureICP +
    # Cost_NonFeature_ICP, ceresfunc.h:573-622).  The shipped reference
    # never labels non-feature points (unionFeatureExtract.cpp assigns only
    # 1/2) and has the factors commented out of the solve
    # (Estimator.cpp:1290-1296), so this defaults off; enabling it labels
    # residual unclassified points, maintains the non-feature map, and adds
    # 1-dim point-to-plane factors.
    use_nonfeature: bool = False
    # The reference's pose prediction drops the velocity and gravity terms
    # (unionPoseEstimation.cpp:811-814 commented out), which biases the
    # per-scan undistortion by ~|V|*dt along the motion direction.  True =
    # full kinematic prediction P+ = P + V dt + 0.5 g dt^2 + R dP
    # (36% better ATE on the synthetic hall); False = reference-faithful.
    predict_full_kinematics: bool = True
    # Weight (sqrt-info) of the init gravity-rotation prior.  The reference
    # pins gravity to the averaged-accelerometer seed with sqrt-info 2000
    # (Cost_Initialization_Prior_R, ceresfunc.h:781-818, built at
    # unionPoseEstimation.cpp:515), assuming a quasi-static start; 20
    # merely regularizes the yaw null direction and lets the IMU factors
    # separate acceleration from gravity (see initializer.py) — measured
    # necessary when init happens under acceleration.
    init_gravity_prior_w: float = 20.0

    def replace(self, **kw) -> "LIOConfig":
        return dataclasses.replace(self, **kw)


def reference_rig():
    """The reference sensor rig's body-from-lidar extrinsic.

    `Extrinsic_Tlb` from mm_lio_full.launch:49-52 (identity rotation,
    [-0.05512, -0.02226, 0.0297] m translation), inverted to the
    body-from-lidar (Rbl, tbl) convention the pipeline consumes
    (EstimateLidarPose computes exRbl = R^T, exPbl = -R^T t,
    Estimator.cpp:972-973).  Returns (Rbl, tbl) as numpy arrays for
    `pipeline.init_state(cfg, Rbl=..., tbl=...)`.
    """
    import numpy as np

    T_lb = np.eye(4)
    T_lb[:3, 3] = [-0.05512, -0.02226, 0.0297]
    R_bl = T_lb[:3, :3].T
    t_bl = -R_bl @ T_lb[:3, 3]
    return R_bl, t_bl


def tiny_config() -> LIOConfig:
    """Small shapes for unit tests / CPU dry-runs."""
    return LIOConfig(
        scan=ScanConfig(n_lines=4, max_pts_per_line=256,
                        max_corner=256, max_surf=1024, max_nonfeature=64),
        map=MapConfig(dim_x=96, dim_y=96, dim_z=32),
        local_map=MapConfig(voxel_size=0.2, dim_x=64, dim_y=64, dim_z=32),
        imu=ImuConfig(max_samples=32),
    )


def faithful_config(base: LIOConfig | None = None) -> LIOConfig:
    """Reference-faithful settings: every deliberate algorithmic deviation
    that is ON by default flipped back to the reference's behavior.

    The defaults are measured improvements (each justified at its
    definition); this constructor exists so tests can assert the engine
    still tracks with the reference's exact semantics — i.e. that the
    improvements are opt-in refinements, not load-bearing crutches.
    Mapping (deviation -> reference value / citation):

    * predict_full_kinematics=False — prediction omits velocity/gravity
      terms (unionPoseEstimation.cpp:806-817, :811-814 commented out).
    * init_gravity_prior_w=2000 — gravity pinned to the accelerometer
      seed (ceresfunc.h:781-818, unionPoseEstimation.cpp:515).
    * solver.marg_point_sigma=imu.lidar_m — point factors enter the
      marginalization prior at lidar sigma (ceresfunc.h:321 sqrt infos).
    * solver.full_reassoc_rounds=0 — full-window associations frozen at
      the entry poses (the vLineFeatures cache, Estimator.cpp:160-170).
    * solver.refresh_old_frames=window-1 — every window frame's point
      factors rebuilt every scan (Estimator.cpp:1262-1299).
    * solver.max_outer_iters=5 — the full outer schedule (:1210).
    * solver.plane_scatter_ratio=0 — no scatter-rank gate on plane fits
      (colPivHouseholderQr accepts collinear sets, Estimator.cpp:640-668).
    * solver.init_radius=1e4 — Ceres' default initial trust radius.
    * solver.gravity_refine_every=0 — gravity frozen after init
      (unionPoseEstimation.cpp:577-578).
    * solver.local_map_move_gate=True — MapIncrementLocal only after
      >= 0.5 m^2 of motion (Estimator.cpp:1083,:1125).
    * solver.local_rescue_frac=1.0 — the local-map fallback runs for
      every failed point, uncapped (Estimator.cpp:283-360).

    Not toggleable: the init velocity prior's trapezoidal two-state form
    (initializer.py) — it shares the factor structure, not a flag; its
    effect is bounded by the init prior weights.
    """
    cfg = base if base is not None else LIOConfig()
    return cfg.replace(
        predict_full_kinematics=False,
        init_gravity_prior_w=2000.0,
        solver=dataclasses.replace(
            cfg.solver,
            marg_point_sigma=cfg.imu.lidar_m,
            full_reassoc_rounds=0,
            refresh_old_frames=cfg.solver.window - 1,
            max_outer_iters=5,
            plane_scatter_ratio=0.0,
            init_radius=1.0e4,
            gravity_refine_every=0,
            local_map_move_gate=True,
            local_rescue_frac=1.0,
        ))
