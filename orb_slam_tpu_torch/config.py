"""Typed configuration, a field-for-field copy of ``orb_slam_tpu.config``.

The port keeps its own copy so that it never imports the JAX package
(``import orb_slam_tpu`` imports jax).  ``tests/test_torch_config.py`` holds
every field name and default equal to the JAX package's.  Some fields only
steer the JAX package's TPU machinery (``frame_batch``,
``prefetch_host_blob``, ``ba_matmul_precision``); they are kept so the two
configs stay interchangeable.

Every magic number of the reference system (worxli/ORB_SLAM) becomes a named
field with the reference value as default.  Citations are file:line into the
reference tree (see SURVEY.md §5.6 for the catalogue).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera + radial-tangential distortion.

    Reference: Data/Settings.yaml:6-22, parsed at src/Tracking.cc:52-76.
    Defaults are the reference example sequence's calibration.
    """

    fx: float = 646.83766
    fy: float = 646.61414
    cx: float = 355.05657
    cy: float = 221.66888
    # Distortion k1, k2, p1, p2, k3 (OpenCV order, Settings.yaml:13-17).
    k1: float = 0.148805
    k2: float = -0.317586
    p1: float = -0.002859
    p2: float = 0.000229
    k3: float = 0.0
    width: int = 752
    height: int = 480
    fps: float = 30.0
    rgb: bool = True  # Camera.RGB ordering flag (Settings.yaml:22)

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    @property
    def dist(self) -> np.ndarray:
        return np.array([self.k1, self.k2, self.p1, self.p2, self.k3], dtype=np.float32)

    @property
    def has_distortion(self) -> bool:
        return any(abs(d) > 0 for d in (self.k1, self.k2, self.p1, self.p2, self.k3))


@dataclasses.dataclass(frozen=True)
class ExtractorConfig:
    """ORB extractor parameters.

    Reference: Data/Settings.yaml:28-40, ORBextractor ctor src/ORBextractor.cc:457-511.
    """

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    fast_threshold: int = 20        # ORBextractor.fastTh (Settings.yaml:37)
    fast_threshold_min: int = 7     # fallback threshold (ORBextractor.cc:607-614)
    score_harris: bool = False      # nScoreType 0=Harris 1=FAST (Settings.yaml:40)
    edge_threshold: int = 16        # border margin (ORBextractor.h EDGE_THRESHOLD)
    patch_size: int = 31            # descriptor patch (ORBextractor.cc HALF_PATCH 15)
    init_features_mult: int = 2     # 2x features during init (src/Tracking.cc:128)
    # Static capacity: keypoint slots per frame (n_features padded to a TPU-
    # friendly multiple of 128; unused slots are masked).
    max_keypoints: int = 1024
    # grid cells along x/y per level for quota distribution
    # (reference sizes cells so ~5 features land in each; ORBextractor.cc:527-547)
    cells_x: int = 16
    cells_y: int = 10

    @property
    def scale_factors(self) -> np.ndarray:
        return self.scale_factor ** np.arange(self.n_levels, dtype=np.float32)

    @property
    def sigma2(self) -> np.ndarray:
        f = self.scale_factors
        return (f * f).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Data-association thresholds (src/ORBmatcher.cc:40-42 and call sites)."""

    th_high: int = 100              # TH_HIGH
    th_low: int = 50                # TH_LOW
    histo_length: int = 30          # rotation histogram bins
    nn_ratio_tracking: float = 0.9  # tracking matcher ctor (Tracking.cc:574),
    #                                 applied in the wide f2f fallback pass
    nn_ratio_init: float = 0.9      # SearchForInitialization (Tracking.cc:355)
    nn_ratio_localmap: float = 0.8  # SearchReferencePointsInFrustum matcher(0.8)
    #                                 (Tracking.cc:741)
    check_orientation: bool = True
    window_init: int = 100          # init window search (Tracking.cc:362)
    # frame-to-frame projection search radii (scaled by the keypoint's level):
    radius_f2f: float = 15.0        # SearchByProjection(cur, last, 15) (Tracking.cc:584)
    radius_f2f_fallback: float = 50.0  # last-opportunity th=50 (Tracking.cc:548)
    # local-map projection search: radius = RadiusByViewingCos * th * scale
    radius_view_cos_tight: float = 2.5  # viewCos > 0.998 (ORBmatcher.cc:127-134)
    radius_view_cos_wide: float = 4.0
    localmap_th: float = 1.0        # SearchReferencePointsInFrustum th (Tracking.cc:737)
    localmap_th_coarse: float = 5.0  # coarser search after recent reloc (Tracking.cc:739-740)
    # relocalisation escalation rounds (Tracking.cc:984-1021):
    reloc_proj_th_wide: float = 10.0   # round-2 window (Tracking.cc:991)
    reloc_proj_th_narrow: float = 3.0  # round-3 window (Tracking.cc:1007)
    reloc_orb_dist: int = 64           # round-3 ORBdist (Tracking.cc:1007)


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Tracking state-machine thresholds (src/Tracking.cc)."""

    min_init_keypoints: int = 100     # FirstInitialization needs >100 kp (Tracking.cc:333)
    min_init_matches: int = 100       # SearchForInitialization >=100 (Tracking.cc:368)
    min_track_inliers: int = 10       # TrackPreviousFrame/MotionModel success (Tracking.cc:252)
    min_localmap_inliers: int = 30    # TrackLocalMap success (Tracking.cc:641-647)
    # stricter floor within max_frames_between_kf (mMaxFrames) frames of
    # a relocalisation (Tracking.cc:640-647)
    min_localmap_inliers_reloc: int = 50
    max_local_keyframes: int = 80     # local KF cap (Tracking.cc:819)
    min_frames_between_kf: int = 0    # mMinFrames (Tracking.cc:78)
    max_frames_between_kf: int = 18   # mMaxFrames = 18*fps/30 (Tracking.cc:79)
    kf_min_tracked_ratio: float = 0.9  # need-new-KF: tracked < 90% of ref KF (Tracking.cc:672)
    # NeedNewKeyFrame's lower inlier gate: the reference inserts whenever
    # mnMatchesInliers > 15 (c2, Tracking.cc:672).  This was 50 through
    # r5 — a misread of the post-reloc tracking-success threshold
    # (Tracking.cc:641) — which deadlocked marginal stretches: 30-49-
    # inlier tracking could never insert the keyframe that would extend
    # the map, and the endurance world spiralled into losses (~200
    # insertion-free frames before each episode, diagnosed under the
    # pinned-schedule run; see test_endurance).
    kf_min_inliers_insert: int = 15
    # "healthy tracking" level: the starvation heuristic forces a
    # keyframe through backpressure when inliers fall below 2x this
    kf_min_tracked: int = 50
    reset_if_lost_before_kfs: int = 5  # early-failure full reset (Tracking.cc:278-285)
    use_motion_model: bool = True     # UseMotionModel flag (Settings.yaml:44)
    # run local mapping + loop closing on a worker thread over functional map
    # snapshots, like the reference's LocalMapping/LoopClosing threads
    # (src/main.cc:123-133); keyframe insertion is skipped while the worker
    # is busy (SetAcceptKeyFrames backpressure, src/LocalMapping.cc:522-532)
    async_mapping: bool = False
    # tracked frames dispatched per device program (frame_step_scan):
    # B > 1 amortizes the fixed per-dispatch cost of latency-bound runtimes
    # (tunneled/multi-tenant accelerators) at the price of up to B-1 frames
    # of keyframe-decision lag.  1 = per-frame dispatch (lowest latency).
    frame_batch: int = 1
    # keyframe-pressure release toward the busy mapping worker: a need
    # while the worker is busy signals it to drop the pending local BA
    # (InterruptBA/mbAbortBA, src/Tracking.cc:679-685), and a starved
    # forced insertion marks a queued keyframe so fuse+BA+culling are
    # skipped for the in-flight job (the CheckNewKeyFrames gate,
    # src/LocalMapping.cc:58-66).
    #
    # Default OFF — the reference's valve does not transplant as a
    # default onto a batched mapper: its LocalMapping pass is per-KF and
    # an abort loses milliseconds of BA, while this worker's pass is the
    # whole ~1 s cull/triangulate/fuse/BA cycle, so under sustained
    # pressure nearly every pass sheds its BA+culling tail and the map
    # never gets optimized or pruned.  Measured on the 700-frame
    # endurance world (idle box, frame_batch=4): ON -> ATE 0.57 m,
    # 0 keyframe culls; OFF -> ATE 0.022 m, 6 cull-driven compactions.
    # ON remains the right trade for latency-critical deployments where
    # a starved tracker must never wait a full mapping pass.
    interrupt_ba: bool = False
    # Pin the mapping worker's visible service interval to exactly N
    # poll() calls (= N tracked frames): 0 = live wall-clock timing
    # (production); > 0 makes long async runs bit-reproducible across
    # machines/loads/compile-cache states (AsyncMapper.service_polls —
    # the endurance suite's chaotic trajectories flipped on ulp-level
    # timing shifts before this).  Deterministic-schedule testing is the
    # functional answer to the reference's mutex/race surface
    # (SURVEY.md §5.2).
    mapper_service_polls: int = 0
    # Start the per-batch host-blob D2H transfer at DISPATCH time
    # (jax.Array.copy_to_host_async) instead of at retire time: under
    # depth-1 pipelining the blob is consumed one batch period after its
    # program is enqueued, so on relay-tunneled runtimes the ~1-RTT
    # fetchHostBlob stall overlaps the next batch's fill/dispatch —
    # lowering both pose latency and the per-batch period.  Value-
    # neutral (the transfer is of committed program outputs); if the
    # runtime's PJRT client rejects async D2H the tracker falls back to
    # the synchronous fetch after the first failure.
    prefetch_host_blob: bool = False


@dataclasses.dataclass(frozen=True)
class InitializerConfig:
    """Two-view bootstrap (src/Initializer.cc)."""

    sigma: float = 1.0
    ransac_iterations: int = 200     # Initializer ctor (Tracking.cc:341)
    sample_size: int = 8
    rh_threshold: float = 0.40       # model-select ratio (Initializer.cc:110-116)
    min_triangulated: int = 50       # ReconstructF winner floor (Initializer.cc:522)
    min_parallax_deg: float = 1.0    # parallax gate (Initializer.cc:486)
    h_second_best_ratio: float = 0.75  # ReconstructH best-vs-second (Initializer.cc:700)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Optimization budgets (src/Optimizer.cc)."""

    # Pose-only optimization: 4 rounds x its with chi2 gates (Optimizer.cc:242-243)
    pose_rounds: Tuple[int, ...] = (10, 10, 7, 5)
    pose_chi2: Tuple[float, ...] = (9.21, 7.38, 5.991, 5.991)
    huber_delta2: float = 5.991      # Huber delta^2 for BA edges (Optimizer.cc:118)
    local_ba_iters1: int = 5         # LocalBundleAdjustment first pass (Optimizer.cc:450)
    local_ba_iters2: int = 10        # second pass (Optimizer.cc:494)
    local_ba_chi2: float = 5.991     # outlier gate between passes
    global_ba_iters: int = 20        # init BA (Tracking.cc:448)
    essential_graph_iters: int = 20  # pose graph (Optimizer.cc:734)
    sim3_iters1: int = 5             # OptimizeSim3 (Optimizer.cc:791-987)
    sim3_iters2: int = 10
    sim3_chi2: float = 10.0
    lm_lambda_init: float = 1e-4     # LM damping seed (g2o default; essential graph 1e-16)
    # EPnP RANSAC (SetRansacParameters at Tracking.cc:922)
    pnp_prob: float = 0.99
    pnp_min_inliers: int = 10
    pnp_max_iters: int = 300
    pnp_min_set: int = 4
    pnp_epsilon: float = 0.5
    pnp_th2: float = 5.991
    # Sim3 RANSAC (LoopClosing.cc:276)
    sim3_prob: float = 0.99
    sim3_min_inliers: int = 20
    sim3_max_iters: int = 300
    # f32 conditioning for city-scale worlds: similarity-normalize the
    # world (centroid shift + median-radius scale) inside the BA program.
    # Reprojection is invariant to a world similarity applied to both
    # poses and points, so pixel-space semantics (residuals, Huber, chi2
    # gates) are EXACT — only the f32 representation of coordinates
    # improves (relative instead of absolute rounding).  g2o runs f64 and
    # needs no such option (SURVEY aux: f32-first design).
    ba_normalize_world: bool = False
    # BA edge layout (bundle_adjust.BAEdges docstring): "grid" keeps the
    # observations in the camera-major [K, N] table the map already stores
    # — no edge compaction, no camera gathers/scatters in the LM
    # iteration, and no two-index G block scatter (the ~24 GB lowering
    # that killed 512-KF problems, BA_CITY_r04.json).  "flat" is the
    # compacted edge list (required by the distributed landmark-sharded
    # solver, which shards edges by point).  Both solve live problems to
    # ulp-level agreement; see BA_CITY_r05.json for the measured choice.
    ba_layout: str = "flat"
    # grid-layout G placement: "scatter" (vmapped single-index row
    # scatter) or "onehot" (per-camera MXU matmul) — see BA_CITY_r05.json
    ba_placement: str = "scatter"
    # Matmul precision for every BA contraction (J^T W J assembly, Schur
    # G G^T, reduced solves).  The TPU default lowers f32 matmuls to
    # single-pass bf16 products; measured on-chip that plateaus LM ~77%
    # above the f32 optimum (final cost 32.5k vs 18.3k at 64 KF x 8k pts)
    # while costing nothing to fix — BA is dispatch-latency-bound, the
    # extra MXU passes hide under the per-call floor (BA_PRECISION_r05.
    # json).  'float32' == Precision.HIGHEST; the CPU backend is f32
    # natively and ignores it.  The reference runs g2o in f64
    # (solvers/cholmod, BlockSolver typedefs) — this is the TPU-native
    # equivalent of that accuracy contract.
    ba_matmul_precision: str = "float32"


@dataclasses.dataclass(frozen=True)
class LocalMappingConfig:
    """Keyframe-rate map building (src/LocalMapping.cc)."""

    culling_min_found_ratio: float = 0.25   # MapPointCulling (:190-218)
    culling_obs_window_kfs: int = 2
    culling_min_obs: int = 2                # actually 3 obs required after 2 KFs (mono)
    triangulation_neighbor_kfs: int = 20    # CreateNewMapPoints (:227)
    fuse_neighbor_kfs: int = 20             # SearchInNeighbors 1st neighbors (:391)
    fuse_second_neighbor_kfs: int = 5       # ...each extended by 5 2nd neighbors (:402)
    min_baseline_depth_ratio: float = 0.01  # baseline/medianDepth gate (:262)
    epipolar_chi2: float = 3.84             # SearchForTriangulation gate (ORBmatcher.cc:150)
    reproj_chi2: float = 5.991              # triangulation reprojection gate (:340)
    kf_culling_redundancy: float = 0.9      # KeyFrameCulling 90% rule (:539-593)
    kf_culling_min_obs: int = 3


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Loop detection / correction (src/LoopClosing.cc, KeyFrameDatabase.cc)."""

    min_kfs_between_loops: int = 10     # gate (:111)
    consistency_threshold: int = 3      # mnCovisibilityConsistencyTh (:152-228)
    min_bow_matches: int = 20           # SearchByBoW gate (:300)
    min_sim3_inliers: int = 20          # OptimizeSim3 gate (:328)
    min_total_matches: int = 40         # final accept (:391)
    shared_word_ratio: float = 0.8      # KeyFrameDatabase (:128)
    acc_score_ratio: float = 0.75       # (:172)
    covisibility_group_top: int = 10
    covisibility_weight_strong: int = 100  # essential graph strong edges (Optimizer.cc:604)
    covisibility_weight_min: int = 15      # UpdateConnections threshold (KeyFrame.cc:378)
    # vocabulary tree (the reference ships a pre-trained k=10, L=6 ORBvoc;
    # when no file is given we train on the init frames with these params —
    # dense MXU scoring favors <= ~10^4 words, see place/vocabulary.py)
    vocab_path: str = ""                # optional ORBvoc.txt to load
    vocab_use_prebuilt: bool = True     # use shipped data/vocab10k.npz
    vocab_branching: int = 8            # k when training in-situ
    vocab_depth: int = 3                # L when training in-situ


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Fixed SoA capacities (replaces std::set + new/delete with masked pools)."""

    max_keyframes: int = 512
    max_points: int = 32768
    # (per-keyframe observation capacity == ExtractorConfig.max_keypoints;
    # per-point observation lists don't exist — covisibility and fuse sets
    # are derived from the [K, N] incidence, so no per-point cap is needed)
    local_ba_max_kfs: int = 64          # local BA window capacity
    local_ba_max_fixed: int = 64
    local_ba_max_points: int = 8192


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh for scale-out (SURVEY.md §2.3 / §7 phase 10)."""

    data_axis: str = "data"          # shard landmark blocks
    model_axis: str = "model"        # shard keyframe blocks
    data_parallel: int = 1
    model_parallel: int = 1
    # landmark partitioning for the sharded BA ("index" = allocation order,
    # "spatial" = Morton map-block sharding, SURVEY §5.7)
    ba_strategy: str = "index"


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    extractor: ExtractorConfig = dataclasses.field(default_factory=ExtractorConfig)
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    initializer: InitializerConfig = dataclasses.field(default_factory=InitializerConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    local_mapping: LocalMappingConfig = dataclasses.field(default_factory=LocalMappingConfig)
    loop: LoopConfig = dataclasses.field(default_factory=LoopConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    seed: int = 0

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


def tum_freiburg1_config(width: int = 640, height: int = 480) -> SystemConfig:
    """Calibration for TUM RGB-D freiburg1 sequences (public benchmark values)."""
    cam = CameraConfig(
        fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
        k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314,
        width=width, height=height, fps=30.0,
    )
    return SystemConfig(camera=cam)


def tum_freiburg2_config(width: int = 640, height: int = 480) -> SystemConfig:
    cam = CameraConfig(
        fx=520.908620, fy=521.007327, cx=325.141442, cy=249.701764,
        k1=0.231222, k2=-0.784899, p1=-0.003257, p2=-0.000105, k3=0.917205,
        width=width, height=height, fps=30.0,
    )
    return SystemConfig(camera=cam)
