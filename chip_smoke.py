#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: its two hand kernels, the
per-frame tracking step, the synchronous System path, the bench
configuration (async mapping, 16-frame batches), relocalisation, the
command line with its dataset reader and map checkpoints, bundle
adjustment on the grid layout, in the System and at scale, the
loop-closing solvers (Sim3 RANSAC and refinement, the essential graph), the
loop closer's geometric check of loop candidates, the loop correction, the
multi-device solvers on virtual shards of the card, and the per-level
reference extractor with the vocabulary trainer's front end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device   the card's name and power limit (nvidia-smi), torch/CUDA
              versions; requires compute capability 9.0 (Hopper)
  2. build    both kernels from orb_slam_tpu_torch/csrc, one nvcc each, in
              parallel
  3. kernel 1 (FAST + NMS + blur) against its plain PyTorch version on a
              rendered 640x480 frame's [8, 480, 640] pyramid and on the
              ragged [4, 240, 384] canvas, bit for bit, then timed
  4. kernel 2 (IC moments + steered BRIEF) against its plain version on the
              same frame's [8, 217] keypoint slots and on a small edge case
              (no live slot, every slot live, keypoints at level and canvas
              edges, a flat patch), then timed
  5. main path: frame_step at the bench configuration (640x480, 8 levels,
              1000 features, 8192-point local window, 32768-point pool) on a
              ground-truth map of 4 views, 30 chained frames on the card;
              each kernel must launch once per frame, every frame must
              track, the median camera-centre error must stay under
              POSE_BOUND_M, and the first 5 frames must agree with the
              port's CPU path
  6. system   the bootstrap and end-to-end path: both kernels against
              their plain versions at the init shape (2000 features, the
              init budget), then System.process_image at the bench
              configuration (synchronous mapping, frame_batch 1) on
              N_SYSTEM_FRAMES frames of the bench sweep from frame 0: the
              map must initialize within INIT_WITHIN frames, >= 95% of
              the later frames track, >= 3 keyframes each run local
              mapping with local BA, the Sim3-aligned ATE stays under
              ATE_SPAN_FRACTION of the path span, the compiled graphops
              run, and each kernel launches once per frame; prints the
              {"system": {...}} line (stage times, host syncs)
  7. bench    System.process_image at the bench configuration
              (bench.py:152-177: async mapping, frame_batch 16, the default
              MapConfig) on N_BENCH_FRAMES frames of the sweep from frame 0,
              the mapping worker on its own CUDA stream: the map must
              initialize within INIT_WITHIN frames, >= 95% of the later
              frames track, every frame from initialization on has exactly
              one trajectory record, >= 3 keyframes are submitted to the
              worker and committed, at least one poll finds the worker busy,
              the ATE stays under ATE_SPAN_FRACTION of the span, each kernel
              launches once per frame and every host mirror equals its
              table; prints the {"bench": {...}} line (fps, pose latency,
              tracking ms per frame with the worker idle and busy, commit
              and insertion ms, the worker's stage times, host syncs per
              batch)
  8. reloc    System.process_image at the bench configuration on
              N_RELOC_FRAMES frames of the sweep from frame 0, with
              BLACKOUT_LEN frames from BLACKOUT_START blacked out (zero
              images) once >= MIN_KF_BEFORE_BLACKOUT keyframes exist: one
              tracking_lost and no system_reset, BoW relocalisation within
              RELOC_WITHIN frames of the blackout's end, >= 95% of the
              frames after it tracked, one record per frame, the ATE of the
              frames after it under ATE_SPAN_FRACTION of their span, >= 1
              keyframe added to the place-recognition database on the
              worker and one database row per live keyframe, each kernel
              launched once per frame, host mirrors equal to their tables;
              then the winning attempt's PnP RANSAC on the card against the
              CPU with the same samples, and that call's host syncs with
              the best hypothesis picked by index_select against the same
              pick by 0-d CUDA indexing; prints the {"reloc": {...}} line
  9. cli      the user's entry points from disk: N_CLI frames of the sweep
              rendered through fr1's intrinsics and distortion (rays of the
              undistorted pixel grid, from an independent numpy inverse of
              the Brown model) and written as a TUM folder (8-bit RGB PNGs
              whose rows cycle through the five filter types, rgb.txt,
              groundtruth.txt); the port's TumSequence must yield every
              frame exactly (decode ms per frame reported); then
              pipeline.system.main() on the card (--calib fr1): a
              map_initialized event, >= 95% of the later frames tracked,
              KeyFrameTrajectory.txt of 8-column rows, the printed ATE
              under ATE_PATH_FRACTION of the ground-truth path length, each
              kernel once per frame; prints the {"cli": {...}} line.
              Resume: System A tracks the first RESUME_SAVE_AT frames and
              saves a checkpoint, which loads on the card and on the CPU
              with equal arrays; a fresh System B resumes it (LOST, the same
              keyframes, mirrors equal to tables) and replays frames
              RESUME_REPLAY with later timestamps: it must relocalize within
              RELOC_WITHIN_REPLAY frames and track every frame after, its
              camera centres within RESUME_CENTRE_FRACTION of A's path
              length of A's centres for the same frames; prints the
              {"resume": {...}} line
 10. ba       the GRID edge layout: phase 6's System path with
              SolverConfig(ba_layout="grid") on N_BA_FRAMES frames from
              frame 0 (initialization within BA_INIT_WITHIN frames, every
              later frame tracked, the ATE under ATE_SPAN_FRACTION of the
              span, each kernel once per frame; localBA ms per keyframe
              beside phase 6's flat figure); then
              scripts/torch_ba_city_bench.py's ring world at 64 KF x 8192
              points in all five layout / placement / solver combinations
              (ms per LM iteration, bound, peak memory; final costs within
              BA_COST_AGREE of flat/dense), scatter and onehot placing the
              same G, flat/dense and grid/cg on the card against the CPU
              (cost within BA_COST_AGREE), and the 256 KF x 16384 grid/cg
              case once; prints the {"ba": {...}} line
 11. loop_solvers  the loop-closing solvers on the card against the same
              calls on the CPU, at the loop closer's sizes: (a) sim3_ransac
              over max_keypoints (1024) pair slots, LOOP_VALID_PAIRS valid
              with LOOP_OUTLIER_FRACTION displaced, scale LOOP_SCALE, with
              the loop closer's budget (pipeline/loop_closer.py:271-284,
              rounded up to a power of two) of samples drawn once on the
              CPU: the same ok, count and inlier mask, s / R / t within
              LOOP_POSE_AGREE, near the ground truth; (b) optimize_sim3
              (5 + 10 iterations) from (a)'s result: the same count, the
              pose within LOOP_POSE_AGREE; (c) optimize_essential_graph at
              max_keyframes (512) on the drifted ring of
              tests/test_sim3_and_posegraph.py (odometry, strong-covisibility
              and one loop edge), essential_graph_iters (20) iterations in
              float32: the first cost within EG_COST0_AGREE, every cost
              within EG_COST_AGREE of the first, translations within
              EG_POSE_AGREE of the ring's radius, the error to ground truth
              down by EG_ERROR_DROP; EG64_ITERS iterations in float64 on
              both devices within EG64_AGREE; ms per iteration and the LU
              solve's share of device time (utils/profiling.device_trace);
              (d) correct_points over max_points (32768) points: card vs
              CPU and S_new(X') = S_old(X) within POINTS_AGREE; prints the
              {"loop_solvers": {...}} line
 12. loop_check  the loop closer's geometric check (LoopCloser._compute_sim3)
              on the card against the same check on the CPU, at full width:
              smoke_world.revisit_map with 1024 slots per keyframe in the
              default MapConfig (512 keyframes, 32768 points, 8192-point
              guided window), keyframe 13 re-observing ~300 landmarks of
              keyframe 3 through a drift Sim3 (scale 1.3) with
              LOOP_OUTLIER_FRACTION displaced, and one decoy per gate
              (matches, RANSAC, refined inliers, guided matches); the draws
              come from one CPU generator and are replayed on the CPU: each
              candidate stops at its designed gate on both devices with the
              same pairs, ok, inlier masks and counts and guided count, both
              accept keyframe 3, g12 within LOOP_CHECK_AGREE of the CPU's
              and LOOP_TRUTH of the drift; ms per candidate by stage (card
              and CPU), host syncs per candidate (sync debug mode), and
              process_keyframe on keyframe 13 after 0-12 (loop_with 3,
              the loop closed); prints the {"loop_check": {...}} line
 13. loop_correct  the loop correction (LoopCloser._correct: propagation,
              loop fusion, LoopConnections, the essential graph, the
              re-map of every landmark, the mirrors' refresh) on phase
              12's revisit map on the card against the same correction on
              the CPU with the same g12 (the card's verified one): keyframe
              poses within LOOP_CORRECT_AGREE, every valid landmark too,
              the edge list, kf_obs, mp_valid and loop_edges exactly equal,
              every mirror equal to its table, keyframes 10-13 moved toward
              their true poses; ms per stage on both devices and host
              syncs (sync debug mode); prints the {"loop_correct": {...}}
              line
 14. dist     the multi-device solvers (parallel/) on virtual shards of
              the one card: the BA twin's ring world at DIST_CASE, sharded
              dense and cg at DIST_SHARDS shards with both landmark
              strategies, each final cost within DIST_COST_AGREE of the
              single-device flat/dense solve on the card, ms per LM
              iteration, the psum's share of it (CUDA events around each
              psum) and peak memory per D; phase 11's 512-KF essential
              graph sharded over 2 shards against the single-device graph;
              two ranks spawned here on cuda:0 (gloo), their replicated
              outputs bit-identical; entry.dryrun_multichip(8); phase 6's
              System path with data_parallel=2 on a 2-shard virtual mesh,
              every frame tracked, each kernel once per frame, its local
              BAs through bundle_adjust_dist; prints the {"dist": {...}}
              line.  Virtual shards share one card's SMs: the times check
              the sharded program and are no scaling figure
 15. extract_per_level  the per-level reference extractor
              (frontend/extractor.py::extract_default: plain PyTorch ops,
              no hand kernel) at the bench configuration on the main
              path's first 640x480 frame: the card against the CPU (valid,
              level, xy and response equal, angles within
              EXTRACT_ANGLE_AGREE, descriptors <= EXTRACT_DESC_BITS bits
              and equal on >= EXTRACT_DESC_EQUAL of the keypoints), with
              score_harris too; the card's per-level against its batched
              extractor on the image and configuration of
              tests/test_extractor_batched.py with its bounds (overlap >=
              PER_LEVEL_OVERLAP, <= PER_LEVEL_HAMMING bits on common
              keypoints, > PER_LEVEL_MIN_COMMON of them), and on the frame
              (overlap; the bits are reported: the JAX package's two paths
              differ there by up to 13 bits too); neither
              kernel launched by the per-level extractor; median ms per
              frame of both extractors on the card over N_EXTRACT_FRAMES
              frames after warm-up; the vocabulary trainer's extract_descs
              (scripts/torch_train_vocabulary.py) on one training image,
              card against CPU; prints the {"extract_per_level": {...}}
              line
 16. report   a JSON line of per-kernel numbers (with each kernel's share
              of its bound and its registers and spill bytes from the
              build), the card's name and power limit, then the last line
              {"ok": true, "device": {...}}

Kernel times are CUDA-event means over replays of a captured CUDA graph
(time_ms), after a warm-up; the plain versions run the same arithmetic as PyTorch ops and are no yardstick
of speed.  Neither function has a single PyTorch library call, so
library_ms is null.
"""
import json
import subprocess
import sys
import time
import warnings

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 rate and float32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
POSE_BOUND_M = 0.05          # median camera-centre error on the card
CPU_POSE_AGREE_M = 1e-3      # card vs CPU camera centres, first 5 frames
N_FRAMES = 30
SYNC_FRAMES = 5              # frames run under torch's sync debug mode
MAP_VIEWS = (0, 4, 8, 12)    # frames whose features seed the map
FIRST_TRACKED = 13
WINDOW, POOL = 8192, 32768
SEED = 11                    # the bench's texture seed
GRAPH_CALLS, GRAPH_REPLAYS = 20, 5   # kernel timing (time_ms)
N_SYSTEM_FRAMES = 90         # phase 6: frames of the sweep from frame 0
INIT_WITHIN = 40             # the map must initialize within these frames
TRACKED_FRACTION = 0.95      # of the frames after initialization
MIN_KEYFRAMES = 3            # inserted after initialization
ATE_SPAN_FRACTION = 0.02     # Sim3-aligned ATE / path span (test_pipeline)
MAPPING_STAGES = ("cullPoints", "triangulate", "fuse", "pointStats",
                  "localBA", "cullKeyframes")
# phase 7: one period of the sweep (one and a half until phase 14 came:
# the script's time limit stays).  The first keyframe after
# initialization enters the map two batches late (16-frame batches, each
# retired when the next is dispatched), so the early frames track on the
# two-view initial map and carry most of the error; the ATE over shorter
# prefixes is in the record
N_BENCH_FRAMES = 300
ATE_PREFIXES = (90, 200)
BENCH_BATCH = 16             # bench.py's frame_batch
# phase 8: a blackout in the second half of the run, after the map has
# grown past reset_if_lost_before_kfs (5), so the LOST path is taken
N_RELOC_FRAMES = 260
BLACKOUT_START, BLACKOUT_LEN = 160, 8
MIN_KF_BEFORE_BLACKOUT = 6
RELOC_WITHIN = 15            # frames after the blackout's end
PNP_INLIER_MASK_AGREE = 0.01  # card vs CPU: share of rows that may differ
PNP_POSE_AGREE = 1e-4        # refined pose, rotation Frobenius / rel. t
FNB_TILE = (32, 32)          # kernel 1's tile, (width, height), as its .cu
# phase 9: the CLI on a TUM-layout folder of the sweep rendered through
# fr1's calibration, then a checkpoint saved by one System and resumed by
# a fresh one
N_CLI = 120
ATE_PATH_FRACTION = 0.02      # printed ATE / ground-truth path length
BROWN_NEWTON_ITERS = 20
BROWN_RESIDUAL_PX = 1e-6      # the numpy inverse of the distortion model
RESUME_SAVE_AT = 90           # System A's frames before the checkpoint
RESUME_REPLAY = range(40, 60)  # frames of the mapped region System B replays
RELOC_WITHIN_REPLAY = 5
RESUME_CENTRE_FRACTION = 0.02  # of System A's path length (map units)
# phase 10: bundle adjustment on the GRID layout, in the System and at scale
N_BA_FRAMES = 60
BA_INIT_WITHIN = 5
BA_COST_AGREE = 1e-3          # relative: variants against flat/dense, card
                              # against the CPU
# phase 11: the loop-closing solvers at the sizes the loop closer feeds them
LOOP_VALID_PAIRS = 300        # matched pairs among max_keypoints slots
LOOP_OUTLIER_FRACTION = 0.4
LOOP_SCALE = 1.3
LOOP_POSE_AGREE = 1e-4        # card vs CPU: s and t relative, R entries
EG_COVIS = (2, 3)             # strong-covisibility edges to the k+2, k+3 KF
EG_COST0_AGREE = 1e-5         # card vs CPU: the cost before any step
# card vs CPU, float32: every cost / the first cost.  The first step from
# the drifted start is ill-conditioned in float32: after it the cost gaps
# were 1.05e-2 of the first cost card vs CPU, 6.3e-3 between two card runs
# (index_add_'s atomics) and 5.1e-3 CPU float32 vs float64, then <= 1.1e-4
EG_COST_AGREE = 3e-2
EG_POSE_AGREE = 2e-4          # card vs CPU translations / the ring's radius
                              # (measured 2.0e-5)
EG64_ITERS = 5                # the float64 pair: costs and translations
EG64_AGREE = 1e-9             # within this (measured 5.8e-12, 2.5e-14)
EG_ERROR_DROP = 0.25          # error to ground truth, after / before
POINTS_AGREE = 1e-5           # corrected points: card vs CPU, and the
                              # invariant, over the points' largest coordinate
# phase 12: the loop closer's geometric check on a scripted revisit
LOOP_SCENE_A = 500            # scene A's landmarks: ~300 pairs at 1024 slots
LOOP_SCENE_B = 800
# card vs CPU, g12 of the accepted candidate: s relative, R entries, t over
# the norm of the drift's translation (phase 11 measured <= 7.3e-7 on the
# refinement's s and R, 4.65e-6 on RANSAC's t)
LOOP_CHECK_AGREE = dict(s=1e-6, R=1e-6, t=1e-5)
# the recovered g12 against the scripted drift: scale relative, rotation
# in degrees, translation in map units (the pairs lie 5-9 units deep)
LOOP_TRUTH = dict(s=0.01, deg=0.5, t=0.03)
# phase 13: the loop correction on phase 12's revisit map, card vs CPU:
# keyframe rotation entries, translations over the largest keyframe
# translation, landmark positions over the largest landmark coordinate
LOOP_CORRECT_AGREE = dict(R=1e-5, t=1e-5, pos=1e-5)
# keyframes 10-13 against their true poses: camera-centre error after the
# correction at most this share of the error before it
LOOP_CORRECT_GAIN = 0.25
# phase 14: the multi-device solvers on virtual shards of the one card
DIST_CASE = (512, 24576)      # the BA twin's ring world (keyframes, points)
DIST_SHARDS = (1, 2, 4, 8)
DIST_ITERS = 3                # robust LM iterations per solve
# final cost against the single-device flat/dense solve, relative: dense
# sums the same reduced system in another order; cg is the JAX package's
# sharded PCG (block-Jacobi, 48 steps, no warm start).  Measured on the
# H100: dense <= 3.1e-5, cg <= 7.6e-5
DIST_COST_AGREE = 1e-3
DIST_MP_CASE = (64, 8192)     # the two-rank run's ring world
DIST_LOCAL = 2                # shards per rank
DIST_GRAPH_GAP = 1e-4         # two ranks: graph translations vs single
DIST_CHILD_TIMEOUT_S = 120
N_DIST_FRAMES = 40            # the System with data_parallel=2
# phase 15: the per-level reference extractor.  Card vs CPU: angles in
# radians, descriptor bits per keypoint and the share bit-identical (the
# bounds tests/test_torch_extract.py holds the batched extractor to);
# per-level vs batched: tests/test_extractor_batched.py's bounds
EXTRACT_ANGLE_AGREE = 1e-5
EXTRACT_DESC_BITS = 2
EXTRACT_DESC_EQUAL = 0.99
PER_LEVEL_OVERLAP = 0.9
PER_LEVEL_HAMMING = 8
PER_LEVEL_MIN_COMMON = 30
N_EXTRACT_FRAMES = 20         # timed frames of the sweep, after warm-up
LOOP_GATES = dict(matches=("match",), ransac=("match", "ransac"),
                  refine=("match", "ransac", "refine"),
                  guided=("match", "ransac", "refine", "guided"),
                  verified=("match", "ransac", "refine", "guided"))


def log(msg):
    print(msg, flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn):
    """Device ms per call of fn: GRAPH_CALLS calls captured in one CUDA
    graph, replayed GRAPH_REPLAYS times between CUDA events, so the host's
    launch overhead (larger than a ~30 us kernel) does not enter the time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (GRAPH_CALLS * GRAPH_REPLAYS)


def bit_diffs(a, b):
    """Differing bits per row of two [N, 8] int32 descriptor tables."""
    x = np.bitwise_xor(a, b).view(np.uint32)
    return np.unpackbits(x.view(np.uint8), axis=1).sum(axis=1)


def tile_classes(dims, H, W):
    """Kernel 1's tiles as its .cu sorts them: (all padding, edge,
    interior) counts for true level sizes `dims` on an [H, W] canvas, with
    the 4-px halo; interior tiles take the 16-byte path when W % 4 == 0."""
    tw, th = FNB_TILE

    def min_reflected(a, b, n):
        if a <= 0:
            return 0
        return max(min(a, 2 * n - 2 - b), 0) if b >= n else a

    zero = edge = inner = 0
    for lh, lw in dims:
        for y0 in range(0, H, th):
            for x0 in range(0, W, tw):
                if (min_reflected(y0 - 4, y0 + th + 3, H) >= lh
                        or min_reflected(x0 - 4, x0 + tw + 3, W) >= lw):
                    zero += 1
                elif (W % 4 == 0 and y0 >= 4 and y0 + th + 4 <= H
                      and x0 >= 4 and x0 + tw + 4 <= W):
                    inner += 1
                else:
                    edge += 1
    return zero, edge, inner


def describe_edge_case(dev):
    """Kernel 2's edge cases on a [3, 96, 128] canvas, integer-valued like
    the pyramid: level 0 fills the canvas and every slot is live, with
    keypoints at the canvas edge (some on .5) and one on a flat patch
    (moments 0, so steering falls back to (1, 0)); level 1 is 70 x 90 with
    half its slots live, keypoints within 15 px of its true edges; level 2
    has no live slot."""
    import torch
    rng = np.random.default_rng(SEED)
    dims = np.array([[96, 128], [70, 90], [50, 60]], np.int32)
    cap = 12
    stack = np.zeros((3, 96, 128), np.float32)
    blurred = np.zeros_like(stack)
    for li, (h, w) in enumerate(dims):
        stack[li, :h, :w] = rng.integers(0, 256, (h, w))
        blurred[li, :h, :w] = rng.integers(0, 256, (h, w))
    stack[0, 30:70, 40:90] = 100.0
    xy = rng.uniform(20.0, 40.0, (3, cap, 2)).astype(np.float32)
    xy[0, :6] = [(65.0, 50.0), (0.0, 0.0), (127.0, 95.0), (2.5, 93.5),
                 (125.5, 1.5), (14.0, 80.0)]
    xy[1, :6] = [(1.0, 1.0), (89.0, 69.0), (80.5, 5.5), (3.0, 60.0),
                 (60.0, 68.5), (76.0, 56.0)]
    counts = np.array([cap, 6, 0], np.int32)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (stack, blurred, xy, dims, counts))


def check_describe(got, ref, counts, what):
    """Kernel 2 against its plain version: moments bit-equal, descriptors
    <= 2 bits apart and >= 99% identical, exact zeros past counts."""
    import torch
    m01_k, m10_k, desc_k = got
    m01_p, m10_p, desc_p = ref
    cap = m01_k.shape[1]
    check(torch.equal(m01_k, m01_p) and torch.equal(m10_k, m10_p),
          f"{what}: moments exactly equal to the plain version")
    live = (torch.arange(cap, device=counts.device)[None, :]
            < counts[:, None]).cpu().numpy()
    bits = bit_diffs(desc_k.cpu().numpy()[live], desc_p.cpu().numpy()[live])
    check(bits.max(initial=0) <= 2, f"{what}: descriptors differ by <= 2 "
          f"bits (max {bits.max(initial=0)})")
    same = float((bits == 0).mean())
    check(same >= 0.99, f"{what}: {same:.4f} of {live.sum()} descriptors "
          f"identical")
    dead = ~live
    check(not desc_k.cpu().numpy()[dead].any()
          and not m01_k.cpu().numpy()[dead].any()
          and not m10_k.cpu().numpy()[dead].any(),
          f"{what}: exact zeros beyond counts")
    return float(torch.maximum((m01_k - m01_p).abs().max(),
                               (m10_k - m10_p).abs().max()))


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    log(f"  ok: {what}")


def bench_configs():
    """The bench configuration: the camera and the frame_step keywords."""
    from orb_slam_tpu_torch.config import (CameraConfig, ExtractorConfig,
                                           MatcherConfig, SolverConfig)
    cam_cfg = CameraConfig(fx=500, fy=500, cx=320, cy=240, k1=0, k2=0, p1=0,
                           p2=0, k3=0, width=640, height=480)
    kw = dict(ext_cfg=ExtractorConfig(n_features=1000, max_keypoints=1024,
                                      n_levels=8),
              matcher_cfg=MatcherConfig(window_init=120),
              solver_cfg=SolverConfig())
    return cam_cfg, kw


def first_frame(dev):
    """The main path's first tracked 640x480 frame and its detections on
    `dev`: the pyramid, blur and keypoint slots the two kernels take."""
    import smoke_world as syn
    from orb_slam_tpu_torch.frontend import extractor_batched as eb
    cam_cfg, kw = bench_configs()
    ext = kw["ext_cfg"]
    renderer = syn.SceneRenderer(np.random.default_rng(SEED), cam_cfg.K)
    frame = renderer.render(*syn.pose_at(FIRST_TRACKED))
    return frame, eb.detect_pyramid(eb.to_device_image(frame, dev), ext,
                                     ext.n_features)


def bench_world(dev, n_frames):
    """The main path's world on `dev`: the camera, the frame_step keywords,
    the numpy state after the MAP_VIEWS map (built from the port's own
    extraction on `dev`) and the next `n_frames` rendered frames."""
    import smoke_world as syn
    from orb_slam_tpu_torch.frontend.extractor_batched import extract_batched
    from orb_slam_tpu_torch.geometry.camera import make_camera
    cam_cfg, kw = bench_configs()
    renderer, arrays = syn.tracking_world(
        lambda img: extract_batched(img, kw["ext_cfg"], device=dev),
        cam_cfg.K, MAP_VIEWS, window=WINDOW, pool=POOL, seed=SEED)
    frames = [renderer.render(*syn.pose_at(FIRST_TRACKED + k))
              for k in range(n_frames)]
    return make_camera(cam_cfg, device=dev), kw, arrays, frames


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import smoke_world as syn
    from orb_slam_tpu_torch import _build, state as st
    from orb_slam_tpu_torch.config import ExtractorConfig
    from orb_slam_tpu_torch.device import resolve_device
    from orb_slam_tpu_torch.frontend import extractor_batched as eb
    from orb_slam_tpu_torch.geometry.camera import make_camera
    from orb_slam_tpu_torch.ops import describe_cuda, fast_cuda, patches
    from orb_slam_tpu_torch.pipeline import frame_step as fs
    from orb_slam_tpu_torch.pipeline.track_kernels import HOST_SYNCS_PER_FRAME

    dev = resolve_device("cuda")

    # --- 1. device ---------------------------------------------------------
    card = gpu_line()
    log(f"# phase 1: device: {card}")
    cap = torch.cuda.get_device_capability(0)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} capability {cap}")
    check(cap == (9, 0), "compute capability 9.0 (sm_90a build target)")

    # --- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"# phase 2: built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")

    # --- a 640x480 frame and its pyramid, as the main path builds them ------
    cam_cfg, kw = bench_configs()
    ext = kw["ext_cfg"]
    frame0, det = first_frame(dev)
    stack, dims = det.stack, det.dims
    L, H, W = stack.shape
    kernels = []

    # --- 3. kernel 1 -------------------------------------------------------
    log(f"# phase 3: fast_nms_blur on [{L}, {H}, {W}]")
    dims_l = dims.tolist()
    zero, edge, inner = tile_classes(dims_l, H, W)
    log(f"  {FNB_TILE[0]}x{FNB_TILE[1]} tiles: {zero} all padding, {edge} "
        f"edge, {inner} interior")
    thr, border = float(ext.fast_threshold_min), ext.edge_threshold
    score_k, blur_k = fast_cuda.fast_nms_blur_stack(stack, dims, thr, border)
    score_p, blur_p = fast_cuda.fast_nms_blur_plain(stack, dims, thr, border)
    torch.cuda.synchronize()
    check(torch.equal(score_k, score_p), "score bit-equal to the plain version")
    err1 = float((blur_k - blur_p).abs().max())
    check(torch.equal(blur_k, blur_p),
          f"blur bit-equal to the plain version (max abs err {err1:.3g})")
    # a canvas whose rows are not a multiple of the 32-row tile: the
    # 320x240, 4-level pyramid [4, 240, 384], border 8
    small = ExtractorConfig(n_features=300, max_keypoints=512, n_levels=4)
    half = np.ascontiguousarray(frame0[::2, ::2])
    det_s = eb.detect_pyramid(eb.to_device_image(half, dev),
                              small, small.n_features)
    got = fast_cuda.fast_nms_blur_stack(det_s.stack, det_s.dims, thr, 8)
    ref = fast_cuda.fast_nms_blur_plain(det_s.stack, det_s.dims, thr, 8)
    check(all(torch.equal(a, b) for a, b in zip(got, ref)),
          f"ragged canvas {list(det_s.stack.shape)}: score and blur "
          f"bit-equal")
    n_px = stack.numel()
    true_px = sum(h * w for h, w in dims_l)
    ms1 = time_ms(lambda: fast_cuda.fast_nms_blur_stack(stack, dims, thr,
                                                        border))
    plain1 = time_ms(lambda: fast_cuda.fast_nms_blur_plain(stack, dims, thr,
                                                           border))
    # what the output needs: the true pyramid read once, both full outputs
    # written once; 16 differences, 2 x 47 arc min/max, 2 compares, 8 NMS
    # compares, 26 blur operations per true pixel
    bytes1 = (true_px + 2 * n_px) * 4 + dims.numel() * 4
    ops1 = 146 * true_px
    t_bytes, t_ops = bytes1 / HBM_BYTES_PER_S * 1e3, ops1 / FP32_OPS_PER_S * 1e3
    # the padded canvas read whole (the bound before padding was skipped)
    canvas_ms = (3 * n_px * 4 + dims.numel() * 4) / HBM_BYTES_PER_S * 1e3
    kernels.append(kernel_entry(
        "fast_nms_blur", "orb_slam_tpu/ops/fast_pallas.py:146", err1, ms1,
        plain1, t_bytes, t_ops))
    log(f"  {true_px} true pixels; kernel {ms1:.5f} ms, plain {plain1:.4f} "
        f"ms, bound {max(t_bytes, t_ops):.5f} ms (bytes {t_bytes:.5f}, ops "
        f"{t_ops:.5f}; whole canvas {canvas_ms:.5f})")

    # --- 4. kernel 2 -------------------------------------------------------
    kp_xy = det.kp.xy.contiguous()
    counts = det.valid.sum(dim=1).to(torch.int32)
    cap_slots = kp_xy.shape[1]
    log(f"# phase 4: orient_describe on [{L}, {cap_slots}] slots, counts "
        f"{counts.tolist()}")
    args2 = (stack, det.blurred, kp_xy, dims, counts)
    m01_k, m10_k, desc_k = describe_cuda.orient_describe(*args2)
    ref2 = describe_cuda.orient_describe_plain(*args2)
    torch.cuda.synchronize()
    err2 = check_describe((m01_k, m10_k, desc_k), ref2, counts, "main path")
    edge2 = describe_edge_case(dev)
    got_e = describe_cuda.orient_describe(*edge2)
    ref_e = describe_cuda.orient_describe_plain(*edge2)
    torch.cuda.synchronize()
    err2 = max(err2, check_describe(got_e, ref_e, edge2[4], "edge case"))
    check(float(got_e[0][0, 0]) == 0.0 and float(got_e[1][0, 0]) == 0.0
          and torch.equal(got_e[2][0, 0], ref_e[2][0, 0]),
          "edge case: flat patch has zero moments and the plain version's "
          "(1, 0)-steered descriptor")
    ms2 = time_ms(lambda: describe_cuda.orient_describe(*args2))
    plain2 = time_ms(lambda: describe_cuda.orient_describe_plain(*args2))
    raw_px, blur_px = touched_pixels(det, counts, m01_k, m10_k, patches)
    n_live = int(counts.sum())
    bytes2 = ((raw_px + blur_px) * 4 + kp_xy.numel() * 4 + dims.numel() * 4
              + counts.numel() * 4 + (m01_k.numel() * 2 + desc_k.numel()) * 4)
    # per live keypoint: 709 taps x (2 mul + 2 add), cos/sin, 512 rotated
    # samples x (4 mul/add + round), 256 compares
    ops2 = n_live * (709 * 4 + 6 + 512 * 5 + 256)
    t_bytes, t_ops = bytes2 / HBM_BYTES_PER_S * 1e3, ops2 / FP32_OPS_PER_S * 1e3
    kernels.append(kernel_entry(
        "orient_describe", "orb_slam_tpu/ops/describe_pallas.py:211", err2,
        ms2, plain2, t_bytes, t_ops))
    log(f"  {n_live} live keypoints; {raw_px} raw + {blur_px} blurred pixels "
        f"touched; kernel {ms2:.5f} ms, plain {plain2:.4f} ms, bound "
        f"{max(t_bytes, t_ops):.5f} ms")

    # --- 5. main path ------------------------------------------------------
    log(f"# phase 5: frame_step, {N_FRAMES} chained frames at 640x480")
    cam, kw, arrays, frames = bench_world(dev, N_FRAMES)
    log(f"  map: {int(arrays['mp_valid'].sum())} points from views "
        f"{MAP_VIEWS}")

    # warm the caching allocator and the kernels' libraries: one frame,
    # not counted
    state = st.state_from_numpy(arrays, device=dev)
    fs.frame_step(frames[0], *state, cam, **kw, device=dev)
    torch.cuda.synchronize()

    state = st.state_from_numpy(arrays, device=dev)
    torch.cuda.synchronize()
    fast_cuda.fast_nms_blur_stack.launches = 0
    describe_cuda.orient_describe.launches = 0
    outs, step_ms = [], []
    for img in frames:
        t0 = time.perf_counter()
        out = fs.frame_step(img, *state, cam, **kw, device=dev)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        state = st.chain(state, out)
        outs.append(out)
    launches = {"fast_nms_blur": fast_cuda.fast_nms_blur_stack.launches,
                "orient_describe": describe_cuda.orient_describe.launches}
    for k in kernels:
        k["launches"] = launches[k["name"]]
        check(k["launches"] == N_FRAMES,
              f"{k['name']} launched {k['launches']} times in "
              f"{N_FRAMES} frames")

    blobs = np.stack([o.host_blob.cpu().numpy() for o in outs])
    inliers = blobs[:, 15]
    check(inliers.min() >= 30, f"every frame tracks: inliers "
          f"min {inliers.min():.0f} median {np.median(inliers):.0f}")
    errs = []
    for k, b in enumerate(blobs):
        Rg, tg = syn.pose_at(FIRST_TRACKED + k)
        c = syn.camera_center(b[:9].reshape(3, 3), b[9:12])
        errs.append(float(np.linalg.norm(c - syn.camera_center(Rg, tg))))
    med_err = float(np.median(errs))
    check(med_err <= POSE_BOUND_M, f"median camera-centre error "
          f"{med_err:.4f} m <= {POSE_BOUND_M} m (max {max(errs):.4f} m)")
    check(all(np.isfinite(blobs).all(axis=1)), "host blobs finite")

    # the first 5 frames through the port on the CPU
    state_c = st.state_from_numpy(arrays, device="cpu")
    cam_c = make_camera(cam_cfg, device="cpu")
    agree, pid_same = [], []
    for k in range(5):
        out_c = fs.frame_step(frames[k], *state_c, cam_c, **kw, device="cpu")
        state_c = st.chain(state_c, out_c)
        bc = out_c.host_blob.numpy()
        agree.append(float(np.linalg.norm(
            syn.camera_center(bc[:9].reshape(3, 3), bc[9:12])
            - syn.camera_center(blobs[k, :9].reshape(3, 3),
                                blobs[k, 9:12]))))
        pid_same.append(float((bc[16:] == blobs[k, 16:]).mean()))
    check(max(agree) <= CPU_POSE_AGREE_M, f"card vs CPU camera centres "
          f"within {max(agree):.2e} m <= {CPU_POSE_AGREE_M} m")
    check(min(pid_same) >= 0.95, f"card vs CPU pid_global equal on "
          f">= {min(pid_same):.4f} of slots")
    # host syncs, counted apart from the timed run: torch's sync debug mode
    # warns at every operation that makes the host wait for the card
    state = st.state_from_numpy(arrays, device=dev)
    torch.cuda.synchronize()
    with ThreadWarnings() as sync_w:
        for img in frames[:SYNC_FRAMES]:
            torch.cuda.set_sync_debug_mode("warn")
            out = fs.frame_step(img, *state, cam, **kw, device=dev)
            torch.cuda.set_sync_debug_mode("default")
            state = st.chain(state, out)
    syncs, sites = sync_w.count, sync_w.sites
    log(f"  frame_step median {np.median(step_ms):.3f} ms/frame "
        f"(min {min(step_ms):.3f}, max {max(step_ms):.3f}); host syncs "
        f"{syncs / SYNC_FRAMES:.2f}/frame measured, {HOST_SYNCS_PER_FRAME} by "
        f"design, by site over {SYNC_FRAMES} frames {sites}; f2f median "
        f"{np.median(blobs[:, 12]):.0f}, local-map median "
        f"{np.median(blobs[:, 13]):.0f}")

    # --- 6. system ---------------------------------------------------------
    system = system_phase(dev, card, kernels)

    # --- 7. bench ----------------------------------------------------------
    bench = bench_phase(dev, card, kernels, system)

    # --- 8. reloc ----------------------------------------------------------
    reloc = reloc_phase(dev, card, kernels)

    # --- 9. cli and resume ------------------------------------------------
    cli, resume = cli_phase(dev, card, kernels)

    # --- 10. ba -------------------------------------------------------------
    ba = ba_phase(dev, card, kernels, system)

    # --- 11. loop solvers --------------------------------------------------
    loop_solvers = loop_solvers_phase(dev, card)

    # --- 12. loop check ---------------------------------------------------
    loop_check = loop_check_phase(dev, card)

    # --- 13. loop correction ----------------------------------------------
    loop_correct = loop_correct_phase(dev, card)

    # --- 14. the multi-device solvers on virtual shards -------------------
    dist = dist_phase(dev, card, kernels)

    # --- 15. the per-level reference extractor ---------------------------
    extract = extract_per_level_phase(dev, card)

    # --- 16. report --------------------------------------------------------
    print(card, flush=True)
    print(json.dumps({"system": system}), flush=True)
    print(json.dumps({"bench": bench}), flush=True)
    print(json.dumps({"reloc": reloc}), flush=True)
    print(json.dumps({"cli": cli}), flush=True)
    print(json.dumps({"resume": resume}), flush=True)
    print(json.dumps({"ba": ba}), flush=True)
    print(json.dumps({"loop_solvers": loop_solvers}), flush=True)
    print(json.dumps({"loop_check": loop_check}), flush=True)
    print(json.dumps({"loop_correct": loop_correct}), flush=True)
    print(json.dumps({"dist": dist}), flush=True)
    print(json.dumps({"extract_per_level": extract}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def system_config():
    """The slice's configuration: the bench's (bench.py:152-158) with
    synchronous mapping and frame_batch 1, the default MapConfig."""
    from orb_slam_tpu_torch.config import SystemConfig
    cam_cfg, kw = bench_configs()
    return SystemConfig(camera=cam_cfg, extractor=kw["ext_cfg"],
                        matcher=kw["matcher_cfg"])


def init_shape_kernels(dev, kernels):
    """Both kernels against their plain versions on the first sweep frame's
    pyramid at the init budget (init_features_mult x 1000 features), bit
    for bit, and both timed there."""
    import torch
    import smoke_world as syn
    from orb_slam_tpu_torch.frontend import extractor_batched as eb
    from orb_slam_tpu_torch.ops import describe_cuda, fast_cuda
    cam_cfg, kw = bench_configs()
    ext = kw["ext_cfg"]
    n_init = ext.n_features * ext.init_features_mult
    renderer = syn.SceneRenderer(np.random.default_rng(SEED), cam_cfg.K)
    det = eb.detect_pyramid(eb.to_device_image(
        renderer.render(*syn.pose_at(0)), dev), ext, n_init)
    thr, border = float(ext.fast_threshold_min), ext.edge_threshold
    got = fast_cuda.fast_nms_blur_stack(det.stack, det.dims, thr, border)
    ref = fast_cuda.fast_nms_blur_plain(det.stack, det.dims, thr, border)
    check(all(torch.equal(a, b) for a, b in zip(got, ref)),
          f"init shape: kernel 1 score and blur bit-equal on "
          f"{list(det.stack.shape)}")
    counts = det.valid.sum(dim=1).to(torch.int32)
    args = (det.stack, det.blurred, det.kp.xy.contiguous(), det.dims,
            counts)
    err = check_describe(describe_cuda.orient_describe(*args),
                         describe_cuda.orient_describe_plain(*args), counts,
                         f"init shape ({n_init} features, "
                         f"{list(det.kp.xy.shape[:2])} slots)")
    ms1 = time_ms(lambda: fast_cuda.fast_nms_blur_stack(det.stack, det.dims,
                                                        thr, border))
    ms2 = time_ms(lambda: describe_cuda.orient_describe(*args))
    for k, ms, e in zip(kernels, (ms1, ms2), (0.0, err)):
        k["init_shape_ms"] = ms
        k["init_shape_max_abs_err"] = e
    log(f"  init shape: kernel 1 {ms1:.5f} ms, kernel 2 {ms2:.5f} ms "
        f"({int(counts.sum())} live slots, counts {counts.tolist()})")


def system_phase(dev, card, kernels):
    """Phase 6: System.process_image from frame 0 of the bench sweep on the
    card.  Returns the {"system": ...} record; every check raises."""
    log(f"# phase 6: system, {N_SYSTEM_FRAMES} frames of the sweep from "
        f"frame 0")
    init_shape_kernels(dev, kernels)
    record = system_run(dev, card, system_config(), N_SYSTEM_FRAMES,
                        INIT_WITHIN, TRACKED_FRACTION)
    for k in kernels:
        k["system_launches"] = record["launches"][k["name"]]
    return record


def system_run(dev, card, cfg, n_frames, init_within, tracked_fraction):
    """System.process_image with synchronous mapping on the first
    `n_frames` frames of the bench sweep on the card, under configuration
    `cfg`: the map must initialize within `init_within` frames, at least
    `tracked_fraction` of the later frames track, >= MIN_KEYFRAMES
    keyframes each run local mapping with local BA, the ATE stays under
    ATE_SPAN_FRACTION of the span, the compiled graphops run and each
    kernel launches once per frame.  Returns the record (stage times,
    host syncs, launches); every check raises."""
    import torch
    import smoke_world as syn
    from orb_slam_tpu_torch import native
    from orb_slam_tpu_torch.dataio import trajectory as traj
    from orb_slam_tpu_torch.ops import describe_cuda, fast_cuda
    from orb_slam_tpu_torch.pipeline.system import System
    from orb_slam_tpu_torch.utils.timing import GLOBAL_TIMER

    renderer = syn.SceneRenderer(np.random.default_rng(SEED), cfg.camera.K)
    frames = [renderer.render(*syn.pose_at(i)) for i in range(n_frames)]
    t0 = time.perf_counter()
    system = System.create(cfg, device=dev)
    check(native.backend() == "compiled",
          f"compiled graphops in use (built in "
          f"{time.perf_counter() - t0:.2f} s with the tracker)")

    # stage clocks include the device work each stage queued; if the sync
    # debug mode flags an explicit synchronize, those are taken back out
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("default")
    probe = sum("synchroniz" in str(w.message) for w in caught)
    GLOBAL_TIMER.reset()
    GLOBAL_TIMER.sync = torch.cuda.synchronize
    torch.cuda.synchronize()
    fast_cuda.fast_nms_blur_stack.launches = 0
    describe_cuda.orient_describe.launches = 0
    logs, wall, syncs = [], [], []
    for i, img in enumerate(frames):
        n_stages = sum(GLOBAL_TIMER.counts.values())
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t1 = time.perf_counter()
            m = system.process_image(img, i / 30.0)
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t1) * 1e3)
        timer_syncs = probe * (sum(GLOBAL_TIMER.counts.values()) - n_stages)
        syncs.append(sum("synchroniz" in str(w.message) for w in caught)
                     - timer_syncs)
        logs.append(m)
    launches = {"fast_nms_blur": fast_cuda.fast_nms_blur_stack.launches,
                "orient_describe": describe_cuda.orient_describe.launches}
    GLOBAL_TIMER.sync = None
    for name, count in launches.items():
        check(count == n_frames, f"{name} launched {count} times in "
              f"{n_frames} frames (one per extracting frame)")

    events = [m.get("event") for m in logs]
    log("  events: " + ", ".join(f"{i}:{e}" for i, e in enumerate(events)
                                 if e))
    check("map_initialized" in events[:init_within],
          f"map initialized within {init_within} frames")
    init = events.index("map_initialized")
    tr = system.tracker
    after = [r for r in tr.trajectory if r.frame_id > init]
    frac = sum(r.tracked for r in after) / max(len(after), 1)
    check(frac >= tracked_fraction, f"{frac:.4f} of the {len(after)} frames "
          f"after initialization (frame {init}) tracked")
    kf_frames = [i for i, e in enumerate(events) if e == "keyframe_inserted"]
    n_ba = GLOBAL_TIMER.counts.get("mapping/localBA", 0)
    check(len(kf_frames) >= MIN_KEYFRAMES
          and all("culled_kfs" in logs[i] for i in kf_frames)
          and n_ba == len(kf_frames),
          f"{len(kf_frames)} keyframes inserted after initialization, each "
          f"with local mapping and local BA ({n_ba} local BAs)")
    rec = [r for r in tr.trajectory if r.tracked]
    est = np.array([-r.R.T @ r.t for r in rec])
    gt = np.array([syn.camera_center(*syn.pose_at(r.frame_id)) for r in rec])
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    ate = float(traj.ate_rmse(est, gt, with_scale=True))
    check(np.isfinite(est).all() and ate < ATE_SPAN_FRACTION * span,
          f"Sim3-aligned ATE {ate:.5f} m over a {span:.3f} m path "
          f"({ate / span:.4f} < {ATE_SPAN_FRACTION})")
    smap = tr.slam_map
    check(np.array_equal(smap.state.kf_obs.cpu().numpy(), smap.obs_np)
          and np.array_equal(smap.state.mp_valid.cpu().numpy(),
                             smap.mp_valid_np),
          "host mirrors equal to the device tables after the run")

    working = [i for i in range(init + 1, n_frames)
               if events[i] is None and logs[i]["state"] == "WORKING"]
    kf_after = [i for i in kf_frames if i > init]

    def stage_ms(name):
        total = GLOBAL_TIMER.totals.get(f"mapping/{name}", 0.0)
        return total * 1e3 / max(len(kf_after), 1)

    w_ms = [wall[i] for i in working]
    record = dict(
        frames=n_frames, init_frame=init, init_ms=wall[init],
        init_frames_ms=sum(wall[:init + 1]),
        tracking_ms_per_frame=dict(
            median=float(np.median(w_ms)), min=float(min(w_ms)),
            max=float(max(w_ms)), frames=len(w_ms)),
        keyframe_frame_ms=dict(
            median=float(np.median([wall[i] for i in kf_after])),
            max=float(max(wall[i] for i in kf_after))),
        mapping_ms_per_keyframe={n: stage_ms(n) for n in MAPPING_STAGES},
        host_syncs=dict(
            per_working_frame=float(np.mean([syncs[i] for i in working])),
            per_keyframe_frame=float(np.mean([syncs[i] for i in kf_after])),
            init_frame=syncs[init],
            before_init=int(sum(syncs[:init]))),
        keyframes=int(tr.slam_map.kf_valid_np.sum()),
        keyframes_inserted=len(kf_after), map_points=int(
            tr.slam_map.mp_valid_np.sum()),
        tracked_fraction_after_init=frac, ate_m=ate, path_span_m=span,
        ate_span_fraction=ate / span, graphops=native.backend(),
        launches=launches, synchronize_flagged=bool(probe),
        ba_layout=cfg.solver.ba_layout, card=card)
    log(f"  tracking {record['tracking_ms_per_frame']} ms/frame; keyframe "
        f"frames {record['keyframe_frame_ms']} ms; mapping per keyframe "
        f"{record['mapping_ms_per_keyframe']}; syncs "
        f"{record['host_syncs']}")
    return record


def ba_city_bench():
    """scripts/torch_ba_city_bench.py as a module (its ring world, timing
    and bounds)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "torch_ba_city_bench.py")
    spec = importlib.util.spec_from_file_location("torch_ba_city_bench",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ba_phase(dev, card, kernels, system_record):
    """Phase 10: bundle adjustment on the GRID layout.  (a) the System path
    of phase 6 with ba_layout="grid" on N_BA_FRAMES frames; (b) the ring
    world at 64 KF x 8192 points in all five layout / placement / solver
    combinations, their final costs against flat/dense, scatter against
    onehot G, and flat/dense and grid/cg on the card against the CPU;
    (c) the 256 KF grid/cg case.  Returns the {"ba": ...} record; every
    check raises."""
    import torch
    from orb_slam_tpu_torch.config import SolverConfig
    from orb_slam_tpu_torch.solvers import bundle_adjust as ba
    log(f"# phase 10: ba, the System path on the grid layout "
        f"({N_BA_FRAMES} frames), then BA at 64 and 256 keyframes")
    t_phase = time.perf_counter()

    # (a) the System path with every BA on the grid
    cfg = system_config().replace(solver=SolverConfig(ba_layout="grid"))
    system = system_run(dev, card, cfg, N_BA_FRAMES, BA_INIT_WITHIN, 1.0)
    for k in kernels:
        k["ba_launches"] = system["launches"][k["name"]]
    grid_ms = system["mapping_ms_per_keyframe"]["localBA"]
    flat_ms = system_record["mapping_ms_per_keyframe"]["localBA"]
    log(f"  localBA {grid_ms:.1f} ms per keyframe on the grid, "
        f"{flat_ms:.1f} on the flat layout (phase 6)")

    # (b) BA at local-BA scale, every combination
    bcb = ba_city_bench()
    K, P = 64, bcb.CASES[64]
    cases = [bcb.time_case(K, P, s, lay, pl, str(dev), reps=1)
             for s, lay, pl in bcb.VARIANTS[64]]
    ref = cases[0]["final_cost"]                       # flat / dense
    for c in cases:
        rel = abs(c["final_cost"] / ref - 1.0)
        c["cost_rel_to_flat_dense"] = rel
        check(c["valid"] and np.isfinite(c["final_cost"])
              and rel <= BA_COST_AGREE,
              f"{K} KF {c['layout']}/{c['placement'] or '-'}/{c['solver']}: "
              f"final cost {c['final_cost']:.2f} within {rel:.2e} of "
              f"flat/dense (<= {BA_COST_AGREE}); {c['ms_per_iter']:.3f} "
              f"ms/iter, bound {c['speed_of_light_ms']:.4f} ms "
              f"({c['bound_by']}), peak "
              f"{(c['peak_mem_bytes'] or 0) / 2**20:.0f} MiB")
    # scatter and onehot place the same G: random blocks at the grid's
    # own (camera, point) structure, masked slots zero
    problem = bcb.make_problem(np.random.default_rng(1), K, P, str(dev),
                               layout="grid")
    pt, valid = problem[4].pt_idx, problem[4].valid
    gen = torch.Generator(device=dev).manual_seed(1)
    blk = torch.randn(pt.shape + (6, 3), generator=gen, device=dev) \
        * valid[..., None, None]
    from orb_slam_tpu_torch.device import true_fp32
    with true_fp32():
        g_sc = ba._place_grid(blk, pt, P, "scatter")
        g_oh = ba._place_grid(blk, pt, P, "onehot")
    g_err = float((g_sc - g_oh).abs().max())
    check(g_err == 0.0, f"scatter and onehot place the same G "
          f"{list(g_sc.shape)} (max abs err {g_err})")
    del g_sc, g_oh, blk, problem
    # the card against the CPU on the same problem
    cpu_rel = {}
    for solver, layout in (("dense", "flat"), ("cg", "grid")):
        costs = []
        for d in (str(dev), "cpu"):
            pr = bcb.make_problem(np.random.default_rng(2), K, P, d,
                                  layout=layout)
            costs.append(float(bcb.solve(pr, solver, "scatter",
                                         bcb.I_HI).cost))
        cpu_rel[f"{layout}/{solver}"] = abs(costs[0] / costs[1] - 1.0)
        check(cpu_rel[f"{layout}/{solver}"] <= BA_COST_AGREE,
              f"{K} KF {layout}/{solver}: card cost {costs[0]:.3f} against "
              f"the CPU's {costs[1]:.3f} (rel "
              f"{cpu_rel[f'{layout}/{solver}']:.2e} <= {BA_COST_AGREE})")

    # (c) city scale: 256 KF grid / cg
    city = bcb.time_case(256, bcb.CASES[256], "cg", "grid", "scatter",
                         str(dev), reps=1)
    check(city["valid"] and np.isfinite(city["final_cost"]),
          f"256 KF grid/cg: {city['ms_per_iter']:.3f} ms/iter against a "
          f"{city['speed_of_light_ms']:.3f} ms bound ({city['bound_by']}), "
          f"peak {(city['peak_mem_bytes'] or 0) / 2**20:.0f} MiB, final cost "
          f"{city['final_cost']:.1f}")
    record = dict(
        system=dict(
            frames=N_BA_FRAMES, init_frame=system["init_frame"],
            tracked_fraction_after_init=system[
                "tracked_fraction_after_init"],
            ate_span_fraction=system["ate_span_fraction"],
            keyframes_inserted=system["keyframes_inserted"],
            localBA_ms_per_keyframe_grid=grid_ms,
            localBA_ms_per_keyframe_flat_phase6=flat_ms,
            mapping_ms_per_keyframe=system["mapping_ms_per_keyframe"],
            tracking_ms_per_frame=system["tracking_ms_per_frame"],
            host_syncs=system["host_syncs"], launches=system["launches"]),
        cases_64kf=cases, g_scatter_vs_onehot_max_abs_err=g_err,
        card_vs_cpu_cost_rel=cpu_rel, case_256kf_grid_cg=city,
        phase_s=time.perf_counter() - t_phase, card=card)
    log(f"  phase 10 took {record['phase_s']:.1f} s")
    return record


def loop_pair_scene(n_slots, rng):
    """3D-3D pairs as the loop closer builds them over `n_slots` keypoint
    slots: LOOP_VALID_PAIRS valid ones at random slots, landmarks 3-8 units
    in front of KF2 mapped into KF1 through a Sim3 of scale LOOP_SCALE, 0.3
    px pixel noise, each pair's octave drawn as a pyramid's keypoints are
    (level l with weight 1.2^-2l) and its 9.21 sigma^2 gate, and
    LOOP_OUTLIER_FRACTION of the valid pairs displaced by 1-3 units on the
    KF2 side (wrong associations).  Returns numpy arrays and the ground
    truth (s, R, t)."""
    import torch
    from orb_slam_tpu_torch.geometry import sim3
    cam_cfg, kw = bench_configs()
    K = np.asarray(cam_cfg.K, np.float32)
    sigma2 = kw["ext_cfg"].sigma2
    zeta = np.array([0.4, -0.2, 0.3, 0.05, -0.08, 0.03, np.log(LOOP_SCALE)],
                    np.float32)
    g = [x.numpy() for x in sim3.exp(torch.from_numpy(zeta))]
    X2 = np.stack([rng.uniform(-2, 2, n_slots), rng.uniform(-1.5, 1.5, n_slots),
                   rng.uniform(3, 8, n_slots)], 1).astype(np.float32)
    X1 = (g[0] * X2 @ g[1].T + g[2]).astype(np.float32)

    def project(X):
        return np.stack([K[0, 0] * X[:, 0] / X[:, 2] + K[0, 2],
                         K[1, 1] * X[:, 1] / X[:, 2] + K[1, 2]], 1)

    uv1 = (project(X1) + rng.normal(0, 0.3, (n_slots, 2))).astype(np.float32)
    uv2 = (project(X2) + rng.normal(0, 0.3, (n_slots, 2))).astype(np.float32)
    w = 1.0 / sigma2
    lv1 = rng.choice(len(sigma2), n_slots, p=w / w.sum())
    lv2 = rng.choice(len(sigma2), n_slots, p=w / w.sum())
    valid = np.zeros(n_slots, bool)
    valid[rng.choice(n_slots, LOOP_VALID_PAIRS, replace=False)] = True
    out = rng.choice(np.flatnonzero(valid),
                     int(LOOP_OUTLIER_FRACTION * LOOP_VALID_PAIRS),
                     replace=False)
    X2[out] += rng.uniform(1, 3, (len(out), 3)).astype(np.float32)
    is_out = np.zeros(n_slots, bool)
    is_out[out] = True
    args = [X1, X2, uv1, uv2, (9.21 * sigma2[lv1]).astype(np.float32),
            (9.21 * sigma2[lv2]).astype(np.float32), valid, K]
    return args, g, is_out


def drifted_ring(n):
    """The pose graph of tests/test_sim3_and_posegraph.py at n keyframes:
    keyframes on a circle (0.3 units and 2 pi / n per step), the start
    drifted by composing each odometry step with exp(N(0, 0.02^2) in all 7
    dims) from a generator seeded 3; edges with ground-truth measurements
    for odometry, strong covisibility to the keyframes EG_COVIS ahead and
    one loop edge (n-1, 0).  Returns (ground truth, start, Sim3Edges) on
    the CPU."""
    import torch
    from orb_slam_tpu_torch.geometry import se3, sim3
    from orb_slam_tpu_torch.solvers import pose_graph as pg
    rel = sim3.exp(torch.tensor([0.3, 0.0, 0.02, 0.0, 2 * np.pi / n, 0.0,
                                 0.0], dtype=torch.float32))
    noise = sim3.exp(torch.from_numpy(np.random.default_rng(3).normal(
        0, 0.02, (n - 1, 7)).astype(np.float32)))
    gt, start = [sim3.identity()], [sim3.identity()]
    for k in range(1, n):
        gt.append(sim3.compose(*rel, *gt[-1]))
        step = sim3.compose(*[x[k - 1] for x in noise], *rel)
        start.append(sim3.compose(*step, *start[-1]))
    # rotations back onto SO(3): 511 float32 products drift ~1e-5 off it,
    # and a keyframe's pose is kept orthonormal
    gt, start = ([torch.stack(x) for x in zip(*g)] for g in (gt, start))
    gt[1], start[1] = se3.orthonormalize(gt[1]), se3.orthonormalize(start[1])
    pairs = [(k, k - d) for d in (1,) + EG_COVIS for k in range(d, n)]
    pairs.append((n - 1, 0))
    i = torch.tensor([a for a, _ in pairs])
    j = torch.tensor([b for _, b in pairs])
    meas = sim3.compose(*[x[i] for x in gt],
                        *sim3.inverse(*[x[j] for x in gt]))
    edges = pg.Sim3Edges(i, j, *meas, torch.ones(len(pairs),
                                                 dtype=torch.bool))
    return gt, start, edges


def loop_solvers_phase(dev, card):
    """Phase 11: the loop-closing solvers on `dev` against the same calls
    on the CPU, at the loop closer's sizes.  Returns the {"loop_solvers":
    ...} record; every check raises."""
    import os
    import tempfile
    import torch
    from orb_slam_tpu_torch.config import LoopConfig, MapConfig, SolverConfig
    from orb_slam_tpu_torch.geometry import sim3
    from orb_slam_tpu_torch.pipeline.loop_closer import ransac_budget
    from orb_slam_tpu_torch.solvers import pnp, pose_graph as pg
    from orb_slam_tpu_torch.solvers import sim3_opt, sim3_solver
    from orb_slam_tpu_torch.utils.profiling import device_trace, top_ops
    cam_cfg, kw = bench_configs()
    n_slots = kw["ext_cfg"].max_keypoints
    scfg, mcfg = SolverConfig(), MapConfig()
    n_kf, n_points = mcfg.max_keyframes, mcfg.max_points
    log(f"# phase 11: loop solvers, Sim3 RANSAC over {n_slots} pair slots, "
        f"the essential graph at {n_kf} keyframes, {n_points} points")
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn, reps=1):
        fn()                                   # warm-up
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3 / reps

    def apart(a, b, scale=1.0):
        return float((a.cpu().double() - b.cpu().double()).abs().max()
                     / scale)

    # (a) Sim3 RANSAC with the loop closer's budget for this many pairs
    args, g_gt, is_out = loop_pair_scene(n_slots, np.random.default_rng(SEED))
    n_samp = ransac_budget(scfg, LOOP_VALID_PAIRS)
    samples = pnp.draw_samples(torch.Generator().manual_seed(SEED),
                               args[6], n_samp, 3)
    # the inputs on each device before any timing
    inputs = {d: [torch.from_numpy(a).to(d) for a in args]
              + [torch.from_numpy(9.21 / a).to(d) for a in args[4:6]]
              for d in (dev, cpu)}
    min_inl = LoopConfig().min_sim3_inliers

    def ransac(d):
        return sim3_solver.sim3_ransac(*inputs[d][:8], samples=samples,
                                       min_inliers=min_inl)

    res, ransac_ms = timed(lambda: ransac(dev), reps=3)
    ref, ransac_cpu_ms = timed(lambda: ransac(cpu))
    same_mask = bool(torch.equal(res.inliers.cpu(), ref.inliers))
    ransac_err = dict(s=apart(res.s, ref.s, float(ref.s)),
                      R=apart(res.R, ref.R),
                      t=apart(res.t, ref.t, float(ref.t.norm())))
    check(bool(res.ok) == bool(ref.ok) and bool(res.ok)
          and int(res.n_inliers) == int(ref.n_inliers) and same_mask,
          f"sim3_ransac ({n_samp} samples, {LOOP_VALID_PAIRS} of {n_slots} "
          f"pairs valid): card and CPU ok with {int(res.n_inliers)} inliers, "
          f"the same inlier mask")
    check(max(ransac_err.values()) <= LOOP_POSE_AGREE,
          f"sim3_ransac card vs CPU: s {ransac_err['s']:.2e}, R "
          f"{ransac_err['R']:.2e}, t {ransac_err['t']:.2e} "
          f"(<= {LOOP_POSE_AGREE}); card {ransac_ms:.2f} ms, CPU "
          f"{ransac_cpu_ms:.2f} ms")
    dR = res.R.cpu().double() @ torch.from_numpy(g_gt[1]).double().T
    ang = float(torch.rad2deg(torch.arccos(torch.clamp(
        (torch.trace(dR) - 1) / 2, -1, 1))))
    kept_out = float(res.inliers.cpu().numpy()[is_out].mean())
    check(abs(float(res.s) / float(g_gt[0]) - 1) < 0.02 and ang < 0.5
          and kept_out < 0.1,
          f"sim3_ransac near the truth: s {float(res.s):.4f} (truth "
          f"{float(g_gt[0]):.4f}), rotation {ang:.3f} deg, {kept_out:.3f} of "
          f"the outliers kept")

    # (b) the refinement from (a)'s result, 5 + 10 iterations, with each
    # pair's information 1 / sigma^2 of its octave
    start_g = {d: [x.to(d) for x in (res.s, res.R, res.t, res.inliers)]
               for d in (dev, cpu)}

    def refine(d):
        s0, R0, t0, inl = start_g[d]
        x = inputs[d]
        return sim3_opt.optimize_sim3(
            s0, R0, t0, *x[:4], x[8], x[9], inl, x[7],
            chi2_th=scfg.sim3_chi2, iters1=scfg.sim3_iters1,
            iters2=scfg.sim3_iters2)

    opt, opt_ms = timed(lambda: refine(dev))
    opt_ref, opt_cpu_ms = timed(lambda: refine(cpu))
    opt_err = dict(s=apart(opt.s, opt_ref.s, float(opt_ref.s)),
                   R=apart(opt.R, opt_ref.R),
                   t=apart(opt.t, opt_ref.t, float(opt_ref.t.norm())))
    check(int(opt.n_inliers) == int(opt_ref.n_inliers)
          and int(opt.n_inliers) >= min_inl
          and max(opt_err.values()) <= LOOP_POSE_AGREE,
          f"optimize_sim3 ({scfg.sim3_iters1} + {scfg.sim3_iters2} "
          f"iterations): {int(opt.n_inliers)} inliers on both, card vs CPU "
          f"s {opt_err['s']:.2e}, R {opt_err['R']:.2e}, t "
          f"{opt_err['t']:.2e} (<= {LOOP_POSE_AGREE}); card {opt_ms:.2f} ms, "
          f"CPU {opt_cpu_ms:.2f} ms")

    # (c) the essential graph at max_keyframes, in float32 as the loop
    # closer runs it; and a few iterations in float64 on both devices, which
    # separates the algorithm's agreement from float32's conditioning
    gt, start, edges = drifted_ring(n_kf)
    fixed = torch.arange(n_kf) == 0
    n_it = scfg.essential_graph_iters
    radius = 0.3 / (2 * np.sin(np.pi / n_kf))

    def graph(d, n_iters=n_it, dtype=torch.float32):
        def put(x):
            return x.to(d, dtype) if x.is_floating_point() else x.to(d)
        return pg.optimize_essential_graph(
            *[put(x) for x in start], put(fixed),
            pg.Sim3Edges(*[put(x) for x in edges]), n_iters=n_iters)

    def traj_err(a, b):
        """(largest cost gap / the first cost, first cost's relative gap,
        largest translation gap / the ring's radius) of two runs."""
        ca, cb = a[3].cpu().double(), b[3].cpu().double()
        return (float((ca - cb).abs().max() / cb[0]),
                abs(float(ca[0] / cb[0]) - 1), apart(a[2], b[2], radius))

    graph(dev, 1)
    sync()
    t0 = time.perf_counter()
    eg = graph(dev)
    sync()
    eg_ms = (time.perf_counter() - t0) * 1e3 / n_it
    t0 = time.perf_counter()
    eg_ref = graph(cpu)
    eg_cpu_ms = (time.perf_counter() - t0) * 1e3 / n_it
    cost_err, cost0_err, pose_err = traj_err(eg, eg_ref)
    costs = eg[3].cpu().double()
    e0 = float((start[2] - gt[2]).norm(dim=1).sum())
    e1 = float((eg[2].cpu() - gt[2]).norm(dim=1).sum())
    check(torch.isfinite(costs).all() and cost0_err <= EG_COST0_AGREE
          and cost_err <= EG_COST_AGREE,
          f"essential graph, {n_kf} KF, {len(edges.i)} edges, {n_it} "
          f"iterations: costs {float(costs[0]):.4g} -> {float(costs[-1]):.4g}; "
          f"card vs CPU: first cost {cost0_err:.2e} (<= {EG_COST0_AGREE}), "
          f"every cost within {cost_err:.2e} of the first (<= "
          f"{EG_COST_AGREE})")
    check(pose_err <= EG_POSE_AGREE and e1 < EG_ERROR_DROP * e0,
          f"essential graph: translations card vs CPU within {pose_err:.2e} "
          f"of the ring's radius (<= {EG_POSE_AGREE}); error to ground truth "
          f"{e0:.1f} -> {e1:.3f} (< {EG_ERROR_DROP}x)")
    err64 = traj_err(graph(dev, EG64_ITERS, torch.float64),
                     graph(cpu, EG64_ITERS, torch.float64))
    check(max(err64) <= EG64_AGREE,
          f"essential graph in float64, {EG64_ITERS} iterations: card vs CPU "
          f"costs within {err64[0]:.2e} of the first, translations within "
          f"{err64[2]:.2e} of the radius (<= {EG64_AGREE})")
    with tempfile.TemporaryDirectory() as tdir:
        with device_trace(os.path.join(tdir, "graph"), device=dev):
            graph(dev)
        ops = top_ops(os.path.join(tdir, "graph"))
        H, b, _ = pg._normal_equations(
            *[x.to(dev) for x in start], fixed.to(dev),
            pg.Sim3Edges(*[x.to(dev) for x in edges]))
        with device_trace(os.path.join(tdir, "solve"), device=dev):
            for _ in range(n_it):
                torch.linalg.solve_ex(H, b, check_errors=False)
        solve_ops = top_ops(os.path.join(tdir, "solve"))
    dev_ms = sum(ms for ms, _ in ops) / n_it
    solve_ms = sum(ms for ms, _ in solve_ops) / n_it
    check(0 < solve_ms < dev_ms,
          f"essential graph: {eg_ms:.2f} ms per iteration on the card "
          f"({eg_cpu_ms:.1f} on the CPU); device time {dev_ms:.2f} ms per "
          f"iteration, the {7 * n_kf}^2 LU solve {solve_ms:.2f} ms of it "
          f"({solve_ms / dev_ms:.1%}); top ops "
          f"{[(round(ms / n_it, 3), name[:50]) for ms, name in ops[:5]]}")

    # (d) the landmark correction over max_points points
    rng = np.random.default_rng(SEED)
    ref_kf = torch.from_numpy(rng.integers(0, n_kf, n_points))
    Xc = torch.from_numpy(rng.normal(0, 1, (n_points, 3)).astype(np.float32)
                          + np.array([0, 0, 5], np.float32))
    # world points seen by their reference keyframe at the start
    P = sim3.transform(*sim3.inverse(*[x[ref_kf] for x in start]), Xc)
    new_card = eg[:3]
    card_in = [x.to(dev) for x in (P, ref_kf, *start)]
    pts, pts_ms = timed(lambda: pg.correct_points(*card_in, *new_card),
                        reps=3)
    pts_ref = pg.correct_points(P, ref_kf, *start,
                                *[x.cpu() for x in new_card])
    scale = float(pts_ref.abs().max())
    pts_err = apart(pts, pts_ref, scale)
    back = sim3.transform(*[x[card_in[1]] for x in new_card], pts)
    inv_err = apart(back, Xc, scale)
    check(pts_err <= POINTS_AGREE and inv_err <= POINTS_AGREE,
          f"correct_points, {n_points} points through {n_kf} keyframes: card "
          f"vs CPU within {pts_err:.2e} and S_new(X') = S_old(X) within "
          f"{inv_err:.2e} of the point scale (<= {POINTS_AGREE}); "
          f"{pts_ms:.3f} ms")

    record = dict(
        ransac=dict(slots=n_slots, valid=LOOP_VALID_PAIRS,
                    outlier_fraction=LOOP_OUTLIER_FRACTION,
                    n_samples=n_samp, n_inliers=int(res.n_inliers),
                    card_vs_cpu=ransac_err, same_inlier_mask=same_mask,
                    rot_err_deg=ang, ms=ransac_ms, cpu_ms=ransac_cpu_ms),
        sim3_opt=dict(iters=[scfg.sim3_iters1, scfg.sim3_iters2],
                      n_inliers=int(opt.n_inliers), card_vs_cpu=opt_err,
                      ms=opt_ms, cpu_ms=opt_cpu_ms),
        essential_graph=dict(
            keyframes=n_kf, edges=len(edges.i), iters=n_it,
            costs=costs.tolist(), costs_cpu=eg_ref[3].double().tolist(),
            cost_err_of_first=cost_err, first_cost_err=cost0_err,
            translation_err_of_radius=pose_err,
            float64_iters=EG64_ITERS, float64_errs=err64,
            gt_error_before=e0, gt_error_after=e1,
            ms_per_iter=eg_ms, cpu_ms_per_iter=eg_cpu_ms,
            device_ms_per_iter=dev_ms, solve_ms=solve_ms,
            solve_share=solve_ms / dev_ms,
            top_ops=[(ms / n_it, name[:80]) for ms, name in ops[:8]],
            solve_ops=[(ms / n_it, name[:80]) for ms, name in solve_ops[:4]]),
        correct_points=dict(points=n_points, keyframes=n_kf,
                            err_of_scale=pts_err, inverse_err=inv_err,
                            ms=pts_ms),
        tolerances=dict(pose=LOOP_POSE_AGREE, eg_cost0=EG_COST0_AGREE,
                        eg_cost=EG_COST_AGREE, eg_pose=EG_POSE_AGREE,
                        eg64=EG64_AGREE, eg_drop=EG_ERROR_DROP,
                        points=POINTS_AGREE),
        phase_s=time.perf_counter() - t_phase, card=card)
    log(f"  phase 11 took {record['phase_s']:.1f} s")
    return record


def revisit_slam_map(cfg, world, device):
    """smoke_world.revisit_map's rows written into a SlamMap on `device`
    (every point first, then the 14 keyframes in order)."""
    from orb_slam_tpu_torch.mapping import mapstore
    smap = mapstore.SlamMap.create(cfg.map, cfg.extractor.max_keypoints,
                                   device=device)
    p = world["points"]
    m = len(p["pos"])
    smap.add_points(p["pos"], p["desc"].view(np.int32),
                    np.zeros((m, 3), np.float32), np.zeros(m, np.float32),
                    np.full(m, np.inf, np.float32), 0, np.ones(m, bool))
    for k, a in enumerate(world["kfs"]):
        smap.add_keyframe(a["R"], a["t"], a["xy"], a["level"], a["angle"],
                          a["desc"].view(np.int32), a["kp_valid"], a["obs"],
                          k, k / 30.0, parent=k - 1)
    return smap


def staged_check(lc, smap, kf, cands):
    """LoopCloser._compute_sim3 with each stage of each candidate timed on
    the host's clock between synchronizations of the map's device: returns
    (hit, stages) with stages [(stage, result, ms)] in call order (match:
    the LoopPairs or None; ransac / refine: the solver's result; guided:
    the count)."""
    import torch
    from orb_slam_tpu_torch.solvers import sim3_opt, sim3_solver
    dev = smap.device
    stages = []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(stage, fn):
        def call(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            stages.append((stage, out, (time.perf_counter() - t0) * 1e3))
            return out
        return call

    ransac, refine = sim3_solver.sim3_ransac, sim3_opt.optimize_sim3
    lc._loop_pairs = timed("match", lc._loop_pairs)
    lc._count_guided_matches = timed("guided", lc._count_guided_matches)
    sim3_solver.sim3_ransac = timed("ransac", ransac)
    sim3_opt.optimize_sim3 = timed("refine", refine)
    try:
        hit = lc._compute_sim3(smap, kf, cands)
    finally:
        del lc._loop_pairs, lc._count_guided_matches
        sim3_solver.sim3_ransac, sim3_opt.optimize_sim3 = ransac, refine
    return hit, stages


def per_candidate(stages):
    """Split a staged_check's stages into one list per candidate (each
    candidate's stages start at its match)."""
    out = []
    for st in stages:
        if st[0] == "match":
            out.append([])
        out[-1].append(st)
    return out


def loop_check_phase(dev, card):
    """Phase 12: the loop closer's geometric check on `dev` against the
    same check on the CPU, on smoke_world.revisit_map at full width.
    Returns the {"loop_check": ...} record; every check raises."""
    import torch
    import smoke_world as syn
    from orb_slam_tpu_torch.geometry.camera import make_camera
    from orb_slam_tpu_torch.pipeline import loop_closer as lcm
    from orb_slam_tpu_torch.solvers import pnp
    cfg = system_config()
    n_slots = cfg.extractor.max_keypoints
    log(f"# phase 12: loop check at {n_slots} slots, a "
        f"{cfg.map.max_keyframes}-keyframe / {cfg.map.max_points}-point "
        f"pool; {card}")
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    world = syn.revisit_map(np.random.default_rng(SEED), n_slots,
                            LOOP_SCENE_A, LOOP_SCENE_B, cfg.camera.K,
                            outlier_fraction=LOOP_OUTLIER_FRACTION)
    q, match = syn.REVISIT_QUERY, syn.REVISIT_MATCH
    cands = {**syn.REVISIT_DECOYS, "verified": match}
    order = list(LOOP_GATES)
    cand_list = [cands[n] for n in order]
    maps = {d: revisit_slam_map(cfg, world, d) for d in (dev, cpu)}
    cams = {d: make_camera(cfg.camera, device=d) for d in (dev, cpu)}

    def closer(d, sampler=None):
        lc = lcm.LoopCloser(cfg=cfg, cam=cams[d])
        lc.sim3_sampler = sampler
        return lc

    # warm-up (cuBLAS / cuSOLVER handles, the caching allocator), then the
    # timed run with draws from one CPU generator, replayed on the CPU
    closer(dev)._compute_sim3(maps[dev], q, cand_list)
    gen = torch.Generator().manual_seed(SEED)
    drawn = []

    def draw(valid, n):
        drawn.append(pnp.draw_samples(gen, valid, n, 3))
        return drawn[-1]

    replay = iter(drawn)
    hit, stages = staged_check(closer(dev, draw), maps[dev], q, cand_list)
    hit_c, stages_c = staged_check(
        closer(cpu, lambda valid, n: next(replay)), maps[cpu], q, cand_list)
    by_cand, by_cand_c = per_candidate(stages), per_candidate(stages_c)
    check(len(by_cand) == len(by_cand_c) == len(order),
          f"every candidate checked on both devices ({len(by_cand)}, "
          f"{len(by_cand_c)} of {len(order)})")
    rows = {}
    for name, got, ref in zip(order, by_cand, by_cand_c):
        gates = tuple(st[0] for st in got)
        check(gates == tuple(st[0] for st in ref) == LOOP_GATES[name],
              f"candidate {cands[name]} ({name}): stages {gates} on both "
              f"devices, as designed {LOOP_GATES[name]}")
        row = dict(kf=cands[name], stages=list(gates),
                   ms={st[0]: st[2] for st in got},
                   cpu_ms={st[0]: st[2] for st in ref})
        for (stage, a, _), (_, b, _) in zip(got, ref):
            if stage == "match":
                same = (a is None) == (b is None) and (
                    a is None or np.array_equal(a.valid_np, b.valid_np))
                row["pairs"] = None if a is None else int(a.valid_np.sum())
            elif stage == "guided":
                same = a == b
                row["n_total"] = a
            else:
                same = (int(a.n_inliers) == int(b.n_inliers) and torch.equal(
                    a.inliers.cpu(), b.inliers))
                if stage == "ransac":
                    same &= bool(a.ok) == bool(b.ok)
                    row["ransac_ok"] = bool(a.ok)
                row[f"{stage}_inliers"] = int(a.n_inliers)
            check(same, f"candidate {cands[name]} ({name}) {stage}: card and "
                  f"CPU agree (pairs, ok, inlier masks and counts, guided "
                  f"count)")
        rows[name] = row
    check(hit is not None and hit_c is not None and hit[0] == hit_c[0]
          == match, f"both devices accept keyframe {match} "
          f"(card {None if hit is None else hit[0]}, CPU "
          f"{None if hit_c is None else hit_c[0]})")
    s, R, t = (x.cpu().double() for x in hit[1])
    sc, Rc, tc = (x.double() for x in hit_c[1])
    s0, R0, t0 = (torch.from_numpy(np.asarray(x, np.float64))
                  for x in world["g12"])
    gap = dict(s=float(abs(s / sc - 1)), R=float((R - Rc).abs().max()),
               t=float((t - tc).abs().max() / t0.norm()))
    check(all(gap[k] <= LOOP_CHECK_AGREE[k] for k in gap),
          f"g12 card vs CPU: s {gap['s']:.2e}, R {gap['R']:.2e}, t "
          f"{gap['t']:.2e} of the drift's translation (<= "
          f"{LOOP_CHECK_AGREE})")
    # the angle of R R0^T from its chord (stable for small angles)
    ang = float(torch.rad2deg(2 * torch.asin(torch.clamp(
        torch.linalg.norm(R - R0) / 8 ** 0.5, max=1.0))))
    truth = dict(s=float(abs(s / s0 - 1)), deg=ang,
                 t=float((t - t0).norm()))
    check(all(truth[k] <= LOOP_TRUTH[k] for k in truth),
          f"g12 against the scripted drift (scale {float(s0):.2f}, "
          f"|t| {float(t0.norm()):.3f}): scale {truth['s']:.2e}, rotation "
          f"{ang:.4f} deg, translation {truth['t']:.4f} (<= {LOOP_TRUTH})")
    v = rows["verified"]
    check(v["pairs"] >= 250 and v["n_total"] >= cfg.loop.min_total_matches,
          f"the verified candidate: {v['pairs']} pairs, "
          f"{v['ransac_inliers']} RANSAC and {v['refine_inliers']} refined "
          f"inliers, {v['n_total']} guided matches")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # host syncs: a fresh check under torch's sync debug mode
    sync()
    with ThreadWarnings() as sync_w:
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            closer(dev)._compute_sim3(maps[dev], q, cand_list)
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
    # the port's own: the debug mode's switch may warn from this file
    syncs = sum(n for site, n in sync_w.sites.items()
                if site.startswith("orb_slam_tpu_torch"))

    # process_keyframe on the verified revisit: database, detection, the
    # check of keyframe 13 after 0-12 and the correction
    lc = closer(dev)
    lc.ensure_vocabulary(None)
    for k in range(q):
        lc.process_keyframe(maps[dev], k)
    sync()
    t0_ = time.perf_counter()
    m = lc.process_keyframe(maps[dev], q)
    sync()
    pk_ms = (time.perf_counter() - t0_) * 1e3
    check(m.get("loop_with") == match and m.get("loop_closed")
          and lc.last_loop_kf == q and lc.n_loops_closed == 1,
          f"process_keyframe({q}) reports loop_with {m.get('loop_with')} "
          f"({m.get('loop_candidates')} candidates) and closes the loop in "
          f"{pk_ms:.1f} ms")
    for name in order:
        r = rows[name]
        log(f"  {name:8s} kf {r['kf']}: stages {r['stages']}, card ms "
            f"{ {k: round(x, 3) for k, x in r['ms'].items()} }, CPU ms "
            f"{ {k: round(x, 3) for k, x in r['cpu_ms'].items()} }")
    record = dict(
        slots=n_slots, pool=[cfg.map.max_keyframes, cfg.map.max_points],
        local_ba_max_points=cfg.map.local_ba_max_points,
        candidates=rows, accepted=hit[0],
        card_vs_cpu=gap, against_truth=truth,
        budgets=[len(x) for x in drawn],
        host_syncs=syncs, host_syncs_per_candidate=syncs / len(order),
        sync_sites=sync_w.sites,
        check_ms=sum(st[2] for st in stages),
        check_cpu_ms=sum(st[2] for st in stages_c),
        process_keyframe_ms=pk_ms,
        tolerances=dict(card_vs_cpu=LOOP_CHECK_AGREE, truth=LOOP_TRUTH),
        phase_s=time.perf_counter() - t_phase, card=card)
    log(f"  {syncs} host syncs for {len(order)} candidates, sites "
        f"{sync_w.sites}; the check {record['check_ms']:.1f} ms on the card "
        f"({record['check_cpu_ms']:.1f} on the CPU); phase 12 took "
        f"{record['phase_s']:.1f} s")
    return record


def timed_correct(lc, smap, correct, *args):
    """correct(smap, *args), LoopCloser._correct or a wrapper of it, with
    each of lc's correction stages timed on the host's clock between
    synchronizations of the map's device, exclusive of the stages nested
    in it (refresh_host inside the writes); the stages are unwrapped again
    after the call.  Returns (ms by stage, total ms, the graph's edges, the
    LoopConnections)."""
    import torch
    dev = smap.device
    ms, stack, seen = {}, [], {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(name, fn):
        def call(*a, **kw):
            sync()
            stack.append(0.0)
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
            finally:
                sync()
                dt = (time.perf_counter() - t0) * 1e3
                ms[name] = ms.get(name, 0.0) + dt - stack.pop()
                if stack:
                    stack[-1] += dt
            seen[name] = out
            return out
        return call

    stages = (("_propagate", "propagation"),
              ("_write_propagated", "propagation"),
              ("_search_and_fuse", "fuse"),
              ("_loop_connections", "loop_connections"),
              ("_graph_edges", "graph_edges"), ("_solve_graph", "graph_solve"),
              ("_remap", "remap"))
    for attr, name in stages:
        setattr(lc, attr, timed(name, getattr(lc, attr)))
    smap.refresh_host = timed("refresh_host", smap.refresh_host)
    try:
        sync()
        t0 = time.perf_counter()
        correct(smap, *args)
        sync()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        del smap.refresh_host
        for attr, _ in stages:
            del lc.__dict__[attr]
    ms["other"] = total - sum(ms.values())
    return ms, total, seen["graph_edges"], seen["loop_connections"]


def loop_correct_phase(dev, card):
    """Phase 13: the loop correction on `dev` against the same correction
    on the CPU with the same g12, on phase 12's revisit map at full width.
    Returns the {"loop_correct": ...} record; every check raises."""
    import torch
    import smoke_world as syn
    from orb_slam_tpu_torch.geometry.camera import make_camera
    from orb_slam_tpu_torch.pipeline import loop_closer as lcm
    cfg = system_config()
    n_slots = cfg.extractor.max_keypoints
    log(f"# phase 13: loop correction at {n_slots} slots, a "
        f"{cfg.map.max_keyframes}-keyframe / {cfg.map.max_points}-point "
        f"pool; {card}")
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    world = syn.revisit_map(np.random.default_rng(SEED), n_slots,
                            LOOP_SCENE_A, LOOP_SCENE_B, cfg.camera.K,
                            outlier_fraction=LOOP_OUTLIER_FRACTION)
    q, match = syn.REVISIT_QUERY, syn.REVISIT_MATCH
    cams = {d: make_camera(cfg.camera, device=d) for d in (dev, cpu)}

    def closer(d):
        return lcm.LoopCloser(cfg=cfg, cam=cams[d])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # the card's verified g12; a first correction on that map warms the
    # card's handles up
    warm = revisit_slam_map(cfg, world, dev)
    hit = closer(dev)._compute_sim3(warm, q, [match])
    check(hit is not None and hit[0] == match,
          f"the check verifies keyframe {match} for keyframe {q}")
    g12 = tuple(x.detach().cpu() for x in hit[1])
    closer(dev)._correct(warm, q, match, tuple(x.to(dev) for x in g12))
    runs = {}
    for d in (dev, cpu):
        smap = revisit_slam_map(cfg, world, d)
        before = {k: smap.host[k][:q + 1].copy() for k in ("kf_R", "kf_t")}
        lc = closer(d)
        ms, total, edges, conn = timed_correct(
            lc, smap, lc._correct, q, match, tuple(x.to(d) for x in g12))
        runs[d.type] = dict(smap=smap, ms=ms, total=total, edges=edges,
                            conn=conn, before=before)
    card_r, cpu_r = runs[dev.type], runs["cpu"]
    a, b = card_r["smap"], cpu_r["smap"]
    pairs = [list(zip(r["edges"].i.tolist(), r["edges"].j.tolist()))
             for r in (card_r, cpu_r)]
    check(pairs[0] == pairs[1] and card_r["conn"] == cpu_r["conn"],
          f"the essential graph: the same {len(pairs[0])} edges on both "
          f"devices, {len(card_r['conn'])} LoopConnections")
    same = (torch.equal(a.state.kf_obs.cpu(), b.state.kf_obs)
            and torch.equal(a.state.mp_valid.cpu(), b.state.mp_valid)
            and np.array_equal(a.obs_np, b.obs_np)
            and np.array_equal(a.mp_valid_np, b.mp_valid_np)
            and a.loop_edges == b.loop_edges == [(q, match)])
    merged = int((b.obs_np != revisit_slam_map(cfg, world, cpu).obs_np)
                 .sum())
    check(same, f"kf_obs, mp_valid, their mirrors and loop_edges equal on "
          f"both devices after the fusion ({merged} slots changed)")
    n = q + 1
    valid = b.mp_valid_np
    R_gap = float((a.state.kf_R[:n].cpu() - b.state.kf_R[:n]).abs().max())
    t_gap = float((a.state.kf_t[:n].cpu() - b.state.kf_t[:n]).abs().max()
                  / b.state.kf_t[:n].abs().max())
    pa, pb = a.state.mp_pos.cpu()[valid], b.state.mp_pos[valid]
    pos_gap = float((pa - pb).abs().max() / pb.abs().max())
    gap = dict(R=R_gap, t=t_gap, pos=pos_gap)
    check(all(gap[k] <= LOOP_CORRECT_AGREE[k] for k in gap),
          f"corrected poses and landmarks card vs CPU: R {R_gap:.2e}, t "
          f"{t_gap:.2e}, positions {pos_gap:.2e} (<= {LOOP_CORRECT_AGREE})")
    check_mirrors(a)

    def centre_err(R, t, k):
        Rt, tt = world["true"][k]
        R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
        return float(np.linalg.norm(R.T @ t - Rt.T @ tt))

    st = a.state
    truth = {k: (centre_err(card_r["before"]["kf_R"][k],
                            card_r["before"]["kf_t"][k], k),
                 centre_err(st.kf_R[k].cpu().numpy(),
                            st.kf_t[k].cpu().numpy(), k))
             for k in range(10, n)}
    check(all(after <= LOOP_CORRECT_GAIN * bef
              for bef, after in truth.values()),
          f"keyframes 10-13 toward their true poses, camera-centre error "
          f"before -> after "
          f"{ {k: tuple(round(x, 4) for x in v) for k, v in truth.items()} } "
          f"(after <= {LOOP_CORRECT_GAIN} x before)")

    # host syncs: a fresh correction under torch's sync debug mode
    smap = revisit_slam_map(cfg, world, dev)
    sync()
    with ThreadWarnings() as sync_w:
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            closer(dev)._correct(smap, q, match,
                                 tuple(x.to(dev) for x in g12))
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
    syncs = sum(k for site, k in sync_w.sites.items()
                if site.startswith("orb_slam_tpu_torch"))
    record = dict(
        slots=n_slots, pool=[cfg.map.max_keyframes, cfg.map.max_points],
        keyframes=n, edges=len(pairs[0]),
        loop_connections=len(card_r["conn"]), slots_fused=merged,
        ms=card_r["ms"], total_ms=card_r["total"], cpu_ms=cpu_r["ms"],
        cpu_total_ms=cpu_r["total"], card_vs_cpu=gap,
        centre_error_before_after=truth, host_syncs=syncs,
        sync_sites=sync_w.sites,
        tolerances=dict(card_vs_cpu=LOOP_CORRECT_AGREE,
                        gain=LOOP_CORRECT_GAIN),
        phase_s=time.perf_counter() - t_phase, card=card)
    rounded = {k: round(v, 3) for k, v in card_r["ms"].items()}
    log(f"  ms by stage, card {rounded} "
        f"(total {card_r['total']:.1f}); CPU "
        f"{ {k: round(v, 3) for k, v in cpu_r['ms'].items()} } (total "
        f"{cpu_r['total']:.1f}); {syncs} host syncs, sites {sync_w.sites}; "
        f"phase 13 took {record['phase_s']:.1f} s")
    return record


def features_agree(a, b, what):
    """Check two FrameFeatures of one image, from the card and the CPU:
    valid, level, xy and response equal, angles and descriptors within
    phase 15's bounds.  Returns (valid keypoints, max angle gap, max
    bits, share of equal descriptors)."""
    a = [x.cpu().numpy() for x in a]
    b = [x.cpu().numpy() for x in b]
    xy, resp, ang, lev, desc, valid = range(6)
    check(np.array_equal(a[valid], b[valid])
          and np.array_equal(a[lev], b[lev])
          and np.array_equal(a[xy], b[xy])
          and np.array_equal(a[resp], b[resp]),
          f"{what}: valid, level, xy and response equal card vs CPU")
    v = b[valid]
    gap = float(np.abs(a[ang][v] - b[ang][v]).max())
    bits = bit_diffs(a[desc][v], b[desc][v])
    same = float((bits == 0).mean())
    check(gap <= EXTRACT_ANGLE_AGREE,
          f"{what}: angles within {EXTRACT_ANGLE_AGREE} (max {gap:.3g})")
    check(bits.max() <= EXTRACT_DESC_BITS and same >= EXTRACT_DESC_EQUAL,
          f"{what}: descriptors <= {EXTRACT_DESC_BITS} bits (max "
          f"{bits.max()}), {same:.4f} bit-identical")
    return int(v.sum()), gap, int(bits.max()), same


def keypoint_table(feats):
    """{(x, y, level): descriptor} of the valid keypoints, coordinates to
    0.1 px, as tests/test_extractor_batched.py keys them."""
    v = feats.valid.cpu().numpy()
    return {(round(float(x), 1), round(float(y), 1), int(lv)): d
            for (x, y), lv, d in zip(feats.xy.cpu().numpy()[v],
                                     feats.level.cpu().numpy()[v],
                                     feats.desc.cpu().numpy()[v])}


def corners_image(h, w, rng, n_squares):
    """Bright squares on a flat background: a copy of
    tests/test_extractor.py::synthetic_corners_image (that module imports
    JAX)."""
    img = np.full((h, w), 30.0, np.float32)
    count, cell = 0, 30
    for gy in range(20, h - cell, cell):
        for gx in range(20, w - cell, cell):
            if count >= n_squares:
                break
            sz = int(rng.integers(10, 18))
            y = gy + int(rng.integers(0, cell - sz - 1))
            x = gx + int(rng.integers(0, cell - sz - 1))
            img[y:y + sz, x:x + sz] = 200.0
            count += 1
    return img


def per_level_vs_batched(img, ext, dev, per_level=None):
    """(keypoint overlap over the smaller set, Hamming bits per common
    keypoint) of the per-level and the batched extractor on `dev`."""
    from orb_slam_tpu_torch.frontend import extractor as ex
    from orb_slam_tpu_torch.frontend import extractor_batched as eb
    a = keypoint_table(per_level if per_level is not None
                       else ex.extract_default(img, ext, device=dev))
    b = keypoint_table(eb.extract_batched_default(img, ext, device=dev))
    common = a.keys() & b.keys()
    ham = [int(bit_diffs(a[k][None], b[k][None])[0]) for k in common]
    return len(common) / max(min(len(a), len(b)), 1), ham


def median_ms(fn, frames, dev):
    """Median wall ms per call of fn over `frames`, each call finished on
    the device before the clock stops, after one warm-up call."""
    import torch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    fn(frames[0])
    sync()
    ms = []
    for img in frames:
        t0 = time.perf_counter()
        fn(img)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def extract_per_level_phase(dev, card):
    """Phase 15: the per-level reference extractor at the bench
    configuration, on `dev` against the CPU and against the batched
    extractor on `dev`, timed, with the vocabulary trainer's front end.
    Rehearse it here on the CPU with dev=torch.device('cpu')."""
    import dataclasses
    import os
    import torch
    import smoke_world as syn
    from orb_slam_tpu_torch.frontend import extractor as ex
    from orb_slam_tpu_torch.frontend import extractor_batched as eb
    from orb_slam_tpu_torch.ops import describe_cuda, fast_cuda
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    import torch_train_vocabulary as tv
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    cam_cfg, kw = bench_configs()
    ext = kw["ext_cfg"]
    frame, _ = first_frame(dev)
    log(f"# phase 15: extract_per_level at {ext.n_levels} levels x "
        f"{ext.scale_factor}, {ext.n_features} features in "
        f"{ext.max_keypoints} slots, 640x480, on {dev}")
    record = dict(card=card, device=str(dev), n_levels=ext.n_levels,
                  n_features=ext.n_features, slots=ext.max_keypoints)

    # (1) card vs CPU, and which kernels the per-level path launches
    fast_cuda.fast_nms_blur_stack.launches = 0
    describe_cuda.orient_describe.launches = 0
    on_dev = ex.extract_default(frame, ext, device=dev)
    record["per_level_kernel_launches"] = {
        "fast_nms_blur": fast_cuda.fast_nms_blur_stack.launches,
        "orient_describe": describe_cuda.orient_describe.launches}
    check(sum(record["per_level_kernel_launches"].values()) == 0,
          "the per-level extractor launches neither hand kernel")
    on_cpu = ex.extract_default(frame, ext, device=cpu)
    n, gap, bits, same = features_agree(on_dev, on_cpu, "extract_default")
    check(n >= 0.9 * ext.n_features, f"{n} valid keypoints")
    record.update(valid=n, angle_gap=gap, max_bits=bits, desc_equal=same)

    # (2) per-level against batched, both on the device: on the image and
    # configuration of tests/test_extractor_batched.py with its bounds,
    # then on this frame (where the JAX package's own two paths differ by
    # up to 13 bits on 929 common keypoints, on the CPU)
    corners = corners_image(240, 320, np.random.default_rng(42), 30)
    small = dataclasses.replace(ext, n_features=200, max_keypoints=256,
                                n_levels=4)
    overlap, ham = per_level_vs_batched(corners, small, dev)
    check(overlap >= PER_LEVEL_OVERLAP,
          f"per-level vs batched, the test's image: {overlap:.3f} overlap")
    check(len(ham) > PER_LEVEL_MIN_COMMON and max(ham) <= PER_LEVEL_HAMMING,
          f"per-level vs batched, the test's image: <= {PER_LEVEL_HAMMING} "
          f"bits on {len(ham)} common keypoints (max {max(ham)})")
    record["batched_test_image"] = dict(overlap=overlap, common=len(ham),
                                        max_bits=max(ham))
    overlap, ham = per_level_vs_batched(frame, ext, dev, on_dev)
    check(overlap >= PER_LEVEL_OVERLAP,
          f"per-level vs batched, this frame: {overlap:.3f} overlap, "
          f"{len(ham)} common, max {max(ham)} bits")
    record["batched_frame"] = dict(
        overlap=overlap, common=len(ham), max_bits=max(ham),
        equal=float(np.mean(np.asarray(ham) == 0)))

    # (3) score_harris, card vs CPU
    hcfg = dataclasses.replace(ext, score_harris=True)
    n, gap, bits, same = features_agree(
        ex.extract_default(frame, hcfg, device=dev),
        ex.extract_default(frame, hcfg, device=cpu), "score_harris")
    record["harris"] = dict(valid=n, angle_gap=gap, max_bits=bits,
                            desc_equal=same)

    # (4) ms per frame of both extractors on the device
    renderer = syn.SceneRenderer(np.random.default_rng(SEED), cam_cfg.K)
    frames = [renderer.render(*syn.pose_at(FIRST_TRACKED + k))
              for k in range(N_EXTRACT_FRAMES)]
    fast_cuda.fast_nms_blur_stack.launches = 0
    describe_cuda.orient_describe.launches = 0
    record["per_level_ms"] = median_ms(
        lambda img: ex.extract_default(img, ext, device=dev), frames, dev)
    per_level_launches = (fast_cuda.fast_nms_blur_stack.launches
                          + describe_cuda.orient_describe.launches)
    record["batched_ms"] = median_ms(
        lambda img: eb.extract_batched_default(img, ext, device=dev),
        frames, dev)
    record["timed_kernel_launches"] = {
        "fast_nms_blur": fast_cuda.fast_nms_blur_stack.launches,
        "orient_describe": describe_cuda.orient_describe.launches}
    if dev.type == "cuda":
        check(per_level_launches == 0 and all(
            v == N_EXTRACT_FRAMES + 1
            for v in record["timed_kernel_launches"].values()),
            f"timed runs: the per-level extractor launches no kernel, the "
            f"batched one each kernel once per frame "
            f"({record['timed_kernel_launches']})")
    log(f"  per-level {record['per_level_ms']:.2f} ms per frame, batched "
        f"{record['batched_ms']:.2f} (median of {N_EXTRACT_FRAMES}, {card})")

    # (5) the vocabulary trainer's front end on one training image
    img = tv.render_patch_world(np.random.default_rng(0))
    d_dev = tv.extract_descs(img, device=dev)
    d_cpu = tv.extract_descs(img, device=cpu)
    check(d_dev.shape == d_cpu.shape and len(d_dev) > 500,
          f"extract_descs: {d_dev.shape} card, {d_cpu.shape} CPU")
    vbits = bit_diffs(d_dev, d_cpu)
    vsame = float((vbits == 0).mean())
    check(vbits.max() <= EXTRACT_DESC_BITS and vsame >= EXTRACT_DESC_EQUAL,
          f"extract_descs: <= {EXTRACT_DESC_BITS} bits (max {vbits.max()}),"
          f" {vsame:.4f} bit-identical")
    record["vocab_descs"] = dict(rows=int(len(d_dev)),
                                 max_bits=int(vbits.max()), equal=vsame)
    record["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 15 took {record['phase_s']:.1f} s")
    return record


def ba_cost(problem, R, t, X):
    """The non-robust reprojection cost sum(|r|^2 inv_sigma2) over the
    valid edges of a flat ring-world problem at (R, t, X): the objective
    that the sharded and single-device solves are held to (the free
    monocular scale of one fixed camera leaves poses comparable only up
    to a similarity)."""
    import torch
    from orb_slam_tpu_torch.solvers import bundle_adjust as ba
    edges, cam = problem[4], problem[5]
    r, _, _, z = ba._edge_terms(R, t, X, edges, cam)
    ok = edges.valid & (z > 0)
    return float(torch.sum((r * r).sum(-1) * edges.inv_sigma2 * ok))


def dist_child():
    """One rank of phase 14's two-process run (started by dist_phase with
    the ORB_SLAM_TPU_* environment): 2 ranks x DIST_LOCAL shards over
    cuda:0, gloo.  Prints one JSON line: digests of the replicated
    outputs, which must be bit-identical on both ranks, and their gaps to
    the single-device solves of this rank."""
    import hashlib
    import torch
    from orb_slam_tpu_torch.config import SolverConfig
    from orb_slam_tpu_torch.parallel import dist_ba, dist_pose_graph, hostmesh
    from orb_slam_tpu_torch.solvers import bundle_adjust as ba
    from orb_slam_tpu_torch.solvers import pose_graph as pg
    hostmesh.declare_virtual_devices("cuda", DIST_LOCAL)
    check(hostmesh.maybe_init_distributed("cuda"), "joined the group")
    dev = torch.device("cuda", torch.cuda.current_device())
    D = hostmesh.device_count("cuda")

    def digest(*xs):
        h = hashlib.sha256()
        for x in xs:
            h.update(x.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()

    bcb = ba_city_bench()
    K, P = DIST_MP_CASE
    problem = bcb.make_problem(np.random.default_rng(SEED), K, P, str(dev))
    Rs, ts, Xs, fixed, edges, cam, _ = problem
    cfg = SolverConfig(global_ba_iters=DIST_ITERS)
    single = ba.bundle_adjust(Rs, ts, Xs, fixed, edges, cam, cfg,
                              two_phase=False, solver="dense")
    c1 = ba_cost(problem, single.R, single.t, single.points)
    out = dict(rank=hostmesh.process_index(), world=hostmesh.process_count(),
               shards=D, backend=torch.distributed.get_backend())
    for solver in ("dense", "cg"):
        res = dist_ba.bundle_adjust_dist(
            Rs, ts, Xs, fixed, edges, cam, cfg, two_phase=False,
            n_shards=D, solver=solver)
        out[solver] = dict(
            digest=digest(res.R, res.t, res.points, res.edge_inliers),
            cost_rel=abs(ba_cost(problem, res.R, res.t, res.points) / c1
                         - 1.0))
    gt, start, g_edges = drifted_ring(DIST_MP_CASE[0])
    put = [x.to(dev) for x in start]
    ge = pg.Sim3Edges(*[x.to(dev) for x in g_edges])
    gfixed = torch.arange(len(put[0]), device=dev) == 0
    s1, R1, t1, _ = dist_pose_graph.optimize_essential_graph_dist(
        *put, gfixed, ge, n_iters=5, mesh=dist_ba.make_mesh(D, device=dev))
    s0, R0, t0, _ = pg.optimize_essential_graph(*put, gfixed, ge, n_iters=5)
    out["graph"] = dict(digest=digest(s1, R1, t1),
                        t_gap=float((t1 - t0).abs().max()))
    torch.distributed.destroy_process_group()
    print("DIST_CHILD " + json.dumps(out), flush=True)


def dist_two_process(card):
    """Phase 14 (c): two ranks on the one card, spawned here; returns the
    record.  Each rank has DIST_CHILD_TIMEOUT_S: a hung collective fails
    the phase."""
    import os
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, ORB_SLAM_TPU_COORDINATOR=f"127.0.0.1:{port}",
               ORB_SLAM_TPU_NUM_PROCS="2")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.dist_child()"],
        cwd=root, env=dict(env, ORB_SLAM_TPU_PROC_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DIST_CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for p, text in zip(procs, logs):
        check(p.returncode == 0, f"rank exited {p.returncode}: "
              f"{text[-3000:]}")
        line = [x for x in text.splitlines() if x.startswith("DIST_CHILD ")]
        recs.append(json.loads(line[-1][len("DIST_CHILD "):]))
    a, b = recs
    for key in ("dense", "cg", "graph"):
        check(a[key]["digest"] == b[key]["digest"],
              f"two ranks ({a['backend']}, {a['shards']} shards over "
              f"cuda:0): {key} outputs bit-identical on both ranks")
    for key in ("dense", "cg"):
        check(a[key]["cost_rel"] <= DIST_COST_AGREE,
              f"two ranks: {key} cost within {a[key]['cost_rel']:.2e} of "
              f"the single-device dense solve (<= {DIST_COST_AGREE})")
    check(a["graph"]["t_gap"] <= DIST_GRAPH_GAP,
          f"two ranks: sharded graph translations within "
          f"{a['graph']['t_gap']:.2e} of the single-device graph (<= "
          f"{DIST_GRAPH_GAP})")
    return dict(ranks=recs, wall_s=time.perf_counter() - t0, card=card)


def dist_phase(dev, card, kernels):
    """Phase 14: the multi-device solvers on virtual shards of the one
    card (parallel/).  (a) the ring world at DIST_CASE: sharded dense and
    cg at each of DIST_SHARDS, both strategies, against the single-device
    flat/dense solve on the card, ms per LM iteration, the psum's share of
    it and peak memory; (b) phase 11's drifted ring sharded over 2 shards
    against the single-device graph; (c) two ranks on the card
    (dist_two_process); (d) entry.dryrun_multichip(8); (e) phase 6's
    System path with data_parallel=2 on a 2-shard virtual mesh.  Virtual
    shards share one card's SMs: the per-D times check the sharded
    program, they are no scaling figure.  Returns the {"dist": ...}
    record; every check raises."""
    import torch
    from orb_slam_tpu_torch import entry
    from orb_slam_tpu_torch.config import MeshConfig, SolverConfig
    from orb_slam_tpu_torch.parallel import dist_ba, dist_pose_graph, hostmesh
    from orb_slam_tpu_torch.solvers import bundle_adjust as ba
    from orb_slam_tpu_torch.solvers import pose_graph as pg
    K, P = DIST_CASE
    log(f"# phase 14: dist, sharded BA at {K} KF x {P} points on "
        f"{DIST_SHARDS} virtual shards of one card, the sharded essential "
        f"graph, two ranks, dryrun_multichip(8), the System with "
        f"data_parallel=2")
    t_phase = time.perf_counter()

    def sync():
        torch.cuda.synchronize(dev)

    # (a) the ring world's BA, sharded and single-device
    bcb = ba_city_bench()
    problem = bcb.make_problem(np.random.default_rng(SEED), K, P, str(dev))
    Rs, ts, Xs, fixed, edges, cam, n_obs = problem
    cfg = SolverConfig(global_ba_iters=DIST_ITERS)
    ba.bundle_adjust(Rs, ts, Xs, fixed, edges, cam,
                     SolverConfig(global_ba_iters=1), two_phase=False)
    sync()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    single = ba.bundle_adjust(Rs, ts, Xs, fixed, edges, cam, cfg,
                              two_phase=False, solver="dense")
    sync()
    single_ms = (time.perf_counter() - t0) * 1e3 / DIST_ITERS
    single_peak = torch.cuda.max_memory_allocated(dev)
    c_single = ba_cost(problem, single.R, single.t, single.points)
    c_start = ba_cost(problem, Rs, ts, Xs)
    check(np.isfinite(c_single) and c_single < 0.5 * c_start,
          f"single-device flat/dense, {K} KF x {P} points ({n_obs} edges), "
          f"{DIST_ITERS} iterations: cost {c_start:.1f} -> {c_single:.1f}, "
          f"{single_ms:.2f} ms/iter, peak {single_peak / 2**20:.0f} MiB")
    cases = []
    with hostmesh.virtual_devices("cuda", max(DIST_SHARDS)):
        warm = dist_ba.partition_problem(Xs, edges, 2)
        for solver in ("dense", "cg"):               # warm-up, not timed
            dist_ba.bundle_adjust_sharded(
                dist_ba.make_mesh(2, device=dev), Rs, ts, warm, fixed, cam,
                cfg, n_iters=1, solver=solver)
        for D in DIST_SHARDS:
            mesh = dist_ba.make_mesh(D, device=dev)
            for strategy in ("index", "spatial"):
                prob = dist_ba.partition_problem(Xs, edges, D,
                                                 strategy=strategy)
                for solver in ("dense", "cg"):
                    sync()
                    torch.cuda.reset_peak_memory_stats(dev)
                    mesh.psum_events = []
                    t0 = time.perf_counter()
                    R1, t1, Xsh, inl = dist_ba.bundle_adjust_sharded(
                        mesh, Rs, ts, prob, fixed, cam, cfg,
                        n_iters=DIST_ITERS, solver=solver)
                    sync()
                    ms = (time.perf_counter() - t0) * 1e3 / DIST_ITERS
                    psum_ms = sum(a.elapsed_time(b) for a, b in
                                  mesh.psum_events) / DIST_ITERS
                    mesh.psum_events = None
                    X1 = Xsh.reshape(-1, 3)[:P]
                    if prob.perm is not None:
                        X1 = X1[torch.from_numpy(prob.perm).to(dev)]
                    rel = abs(ba_cost(problem, R1, t1, X1) / c_single - 1.0)
                    case = dict(
                        shards=D, strategy=strategy, solver=solver,
                        ms_per_iter=ms, psum_ms_per_iter=psum_ms,
                        psum_share=psum_ms / ms,
                        peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
                        cost_rel_to_single_dense=rel)
                    cases.append(case)
                    check(np.isfinite(rel) and rel <= DIST_COST_AGREE,
                          f"D={D} {strategy}/{solver}: cost within "
                          f"{rel:.2e} of single dense (<= "
                          f"{DIST_COST_AGREE}); {ms:.2f} ms/iter, "
                          f"psum {psum_ms:.3f} ms ({psum_ms / ms:.1%}), peak "
                          f"{case['peak_mem_bytes'] / 2**20:.0f} MiB")
                    del R1, t1, Xsh, inl, X1
        # (b) phase 11's essential graph sharded over 2 shards
        n_kf = 512
        gt, start, g_edges = drifted_ring(n_kf)
        put = [x.to(dev) for x in start]
        ge = pg.Sim3Edges(*[x.to(dev) for x in g_edges])
        gfixed = torch.arange(n_kf, device=dev) == 0
        n_it = SolverConfig().essential_graph_iters
        radius = 0.3 / (2 * np.sin(np.pi / n_kf))
        sizes = []
        orig = dist_pose_graph.optimize_essential_graph_sharded

        def spy(mesh, *a, **kw):
            sizes.append(mesh.size)
            return orig(mesh, *a, **kw)

        for n_sh in (1, 2):                          # warm-up, not timed
            dist_pose_graph.optimize_essential_graph_dist(
                *put, gfixed, ge, n_iters=1, n_shards=n_sh)
        pg.optimize_essential_graph(*put, gfixed, ge, n_iters=1)
        dist_pose_graph.optimize_essential_graph_sharded = spy
        try:
            sync()
            t0 = time.perf_counter()
            s2, R2, t2, _ = dist_pose_graph.optimize_essential_graph_dist(
                *put, gfixed, ge, n_iters=n_it, n_shards=2)
            sync()
            g2_ms = (time.perf_counter() - t0) * 1e3 / n_it
        finally:
            dist_pose_graph.optimize_essential_graph_sharded = orig
        t0 = time.perf_counter()
        s1, R1, t1, _ = pg.optimize_essential_graph(*put, gfixed, ge,
                                                    n_iters=n_it)
        sync()
        g1_ms = (time.perf_counter() - t0) * 1e3 / n_it
        g_gap = float((t2 - t1).abs().max()) / radius
        check(sizes == [2] and g_gap <= EG_POSE_AGREE,
              f"essential graph, {n_kf} KF, {len(g_edges.i)} edges, over "
              f"{sizes} shards: translations within {g_gap:.2e} of the "
              f"single-device graph's over the radius (<= {EG_POSE_AGREE}); "
              f"{g2_ms:.2f} ms/iter sharded, {g1_ms:.2f} single")

    # (c) two ranks on the one card
    two = dist_two_process(card)

    # (d) the dry run of the JAX package's entry, on 8 virtual shards
    dry = entry.dryrun_multichip(8, device=dev)
    check(dry["ba_finite"] and dry["cg_finite"] and dry["graph_finite"],
          "dryrun_multichip(8): sharded BA, CG + spatial, sharded graph "
          "finite")

    # (e) the System path with its local BA landmark-sharded
    calls = []
    orig_dist = dist_ba.bundle_adjust_dist

    def spy_ba(*a, **kw):
        calls.append(kw.get("n_shards"))
        return orig_dist(*a, **kw)

    cfg_sys = system_config().replace(mesh=MeshConfig(data_parallel=2))
    dist_ba.bundle_adjust_dist = spy_ba
    try:
        with hostmesh.virtual_devices("cuda", 2):
            system = system_run(dev, card, cfg_sys, N_DIST_FRAMES,
                                BA_INIT_WITHIN, 1.0)
    finally:
        dist_ba.bundle_adjust_dist = orig_dist
    check(len(calls) >= MIN_KEYFRAMES and set(calls) == {2},
          f"System with data_parallel=2: {len(calls)} local BAs went "
          f"through bundle_adjust_dist over 2 shards")
    for k in kernels:
        k["dist_launches"] = system["launches"][k["name"]]
    record = dict(
        ba_case=dict(keyframes=K, points=P, edges=n_obs, iters=DIST_ITERS,
                     single_dense_ms_per_iter=single_ms,
                     single_dense_peak_mem_bytes=single_peak,
                     cost_start=c_start, cost_single_dense=c_single,
                     sharded=cases),
        graph=dict(keyframes=n_kf, edges=len(g_edges.i), shards=2,
                   ms_per_iter_sharded=g2_ms, ms_per_iter_single=g1_ms,
                   t_gap_over_radius=g_gap),
        two_ranks=two, dryrun_multichip=dry,
        system=dict(frames=N_DIST_FRAMES, data_parallel=2,
                    sharded_local_bas=len(calls),
                    init_frame=system["init_frame"],
                    tracked_fraction_after_init=system[
                        "tracked_fraction_after_init"],
                    ate_span_fraction=system["ate_span_fraction"],
                    mapping_ms_per_keyframe=system[
                        "mapping_ms_per_keyframe"],
                    launches=system["launches"]),
        note="virtual shards share one card: per-D times check the "
             "sharded program, not scaling",
        phase_s=time.perf_counter() - t_phase, card=card)
    log(f"  phase 14 took {record['phase_s']:.1f} s")
    return record


def bench_config():
    """The bench's configuration (bench.py:152-177 without its environment
    knobs): async mapping, frame_batch 16, the default MapConfig."""
    from orb_slam_tpu_torch.config import TrackerConfig
    return system_config().replace(tracker=TrackerConfig(
        async_mapping=True, frame_batch=BENCH_BATCH))


class MainThreadClock:
    """The stage timer's wait for the current stream, counting its calls:
    the timer calls it from threads without a sync of their own (the
    mapping worker has one), so `calls` counts this thread's stage ends."""

    def __init__(self):
        self.calls = 0

    def __call__(self):
        import torch
        self.calls += 1
        torch.cuda.current_stream().synchronize()


class ThreadWarnings:
    """Counts the warnings of torch's sync debug mode raised in the calling
    thread (the mapping worker's own go elsewhere): it warns at every
    operation that makes the host wait for the card.  `sites` counts them
    by where they were issued: the innermost line of this repository on the
    stack, and the innermost line when that lies outside it."""

    def __init__(self):
        import threading
        self.ident = threading.get_ident()
        self.count = 0
        self.sites = {}

    def _note_site(self):
        import os
        import traceback
        root = os.path.dirname(os.path.abspath(__file__)) + os.sep
        stack = traceback.extract_stack()
        while stack and (stack[-1].name in ("_note_site", "show")
                         or stack[-1].filename.endswith("warnings.py")):
            stack.pop()                         # this hook's own frames
        ours = [f for f in stack if f.filename.startswith(root)]
        key = (f"{os.path.relpath(ours[-1].filename, root)}:{ours[-1].lineno}"
               if ours else "?")
        if stack and not stack[-1].filename.startswith(root):
            key += (f" via {os.path.basename(stack[-1].filename)}:"
                    f"{stack[-1].lineno}")
        self.sites[key] = self.sites.get(key, 0) + 1

    def __enter__(self):
        import threading
        self._saved = warnings.showwarning
        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter("always")

        def show(message, *args, **kw):
            if (threading.get_ident() == self.ident
                    and "synchroniz" in str(message)):
                self.count += 1
                self._note_site()
        warnings.showwarning = show
        return self

    def __exit__(self, *exc):
        warnings.showwarning = self._saved
        self._ctx.__exit__(*exc)


def bench_phase(dev, card, kernels, system_record):
    """Phase 7: System.process_image at the bench configuration from frame 0
    of the sweep, mapping on the worker.  Returns the {"bench": ...}
    record; every check raises."""
    import torch
    import smoke_world as syn
    from orb_slam_tpu_torch.dataio import trajectory as traj
    from orb_slam_tpu_torch.ops import describe_cuda, fast_cuda
    from orb_slam_tpu_torch.pipeline.system import System
    from orb_slam_tpu_torch.utils.timing import GLOBAL_TIMER

    log(f"# phase 7: bench, {N_BENCH_FRAMES} frames of the sweep from frame "
        f"0, async mapping, frame_batch {BENCH_BATCH}")
    cfg = bench_config()
    renderer = syn.SceneRenderer(np.random.default_rng(SEED), cfg.camera.K)
    frames = [renderer.render(*syn.pose_at(i))
              for i in range(N_BENCH_FRAMES)]
    system = System.create(cfg, device=dev)
    tr, am = system.tracker, system.tracker.async_mapper
    check(am is not None and tr.cfg.tracker.frame_batch == BENCH_BATCH,
          "System.create at the bench configuration (async mapping, "
          f"frame_batch {BENCH_BATCH})")

    # what the checks and the record read: job spans on the worker, polls
    # that found it busy, commits, submissions, per-batch tracking times
    jobs, busy_polls, commits, submits, batches = [], [0], [], [], []
    logs, wall, submit_t, retire_t, n_stages = [], [], [], {}, {}
    job, poll, submit = am._job, am.poll, am.submit
    commit, dispatch = tr._commit_mapping, tr._dispatch_batch
    backpressure, deferred = tr._backpressure, set()

    def timed_job(*item):
        t0 = time.perf_counter()
        res = job(*item)
        jobs.append((t0, time.perf_counter()))
        return res

    def counted_poll():
        res = poll()
        busy_polls[0] += res is None and am.busy
        return res

    def counted_submit(smap, kf):
        submits.append((len(logs), kf))
        return submit(smap, kf)

    def timed_commit(res, metrics):
        t0 = time.perf_counter()
        commit(res, metrics)
        torch.cuda.current_stream().synchronize()
        commits.append((len(logs), res.kf, (time.perf_counter() - t0) * 1e3))

    def timed_dispatch():
        n, busy0 = len(tr._batch_buf), am.busy
        t0 = time.perf_counter()
        dispatch()
        torch.cuda.current_stream().synchronize()
        batches.append((len(logs), n, (time.perf_counter() - t0) * 1e3,
                        busy0 or am.busy))

    def noted_backpressure(n_inl):
        if tr._adopting:        # a keyframe due while a commit drains
            deferred.add(len(logs))
        return backpressure(n_inl)

    am._job, am.poll, am.submit = timed_job, counted_poll, counted_submit
    tr._commit_mapping, tr._dispatch_batch = timed_commit, timed_dispatch
    tr._backpressure = noted_backpressure

    # each thread's stage clock waits for its own stream only: the worker's
    # through its own sync (set_thread_sync), this thread's through
    # GLOBAL_TIMER.sync, counted here
    GLOBAL_TIMER.reset()
    clock = MainThreadClock()
    GLOBAL_TIMER.sync = clock
    with ThreadWarnings() as probe_w:
        torch.cuda.set_sync_debug_mode("warn")
        GLOBAL_TIMER.sync()
        torch.cuda.set_sync_debug_mode("default")
    probe = probe_w.count
    torch.cuda.synchronize()
    fast_cuda.fast_nms_blur_stack.launches = 0
    describe_cuda.orient_describe.launches = 0
    with ThreadWarnings() as sync_w:
        torch.cuda.set_sync_debug_mode("warn")
        t_run = time.perf_counter()
        for i, img in enumerate(frames):
            submit_t.append(time.perf_counter())
            n0, c0 = sum(GLOBAL_TIMER.counts.values()), clock.calls
            s0 = sync_w.count
            m = system.process_image(img, i / 30.0)
            wall.append((time.perf_counter() - submit_t[-1]) * 1e3)
            n_stages[i] = (sync_w.count - s0, clock.calls - c0,
                           sum(GLOBAL_TIMER.counts.values()) - n0)
            logs.append(m)
            now = time.perf_counter()
            for r in tr.trajectory:
                retire_t.setdefault(r.frame_id, now)
        t_drain = time.perf_counter()
        tr._drain_pipe()
        now = time.perf_counter()
        for r in tr.trajectory:
            retire_t.setdefault(r.frame_id, now)
        drain_ms = (now - t_drain) * 1e3
        run_s = now - t_run
        torch.cuda.set_sync_debug_mode("default")
    system.shutdown()                 # flush, commit, join the worker
    GLOBAL_TIMER.sync = None
    launches = {"fast_nms_blur": fast_cuda.fast_nms_blur_stack.launches,
                "orient_describe": describe_cuda.orient_describe.launches}
    for k in kernels:
        k["bench_launches"] = launches[k["name"]]
        check(k["bench_launches"] == N_BENCH_FRAMES,
              f"{k['name']} launched {k['bench_launches']} times in "
              f"{N_BENCH_FRAMES} frames (once per frame, in frame_step_scan's "
              f"rows once the map exists)")

    events = [m.get("event") for m in logs]
    log("  events: " + ", ".join(f"{i}:{e}" for i, e in enumerate(events)
                                 if e))
    check("map_initialized" in events[:INIT_WITHIN],
          f"map initialized within {INIT_WITHIN} frames")
    init = events.index("map_initialized")
    ids = [r.frame_id for r in tr.trajectory if r.frame_id >= init]
    check(ids == list(range(init, N_BENCH_FRAMES)),
          f"one trajectory record per frame from initialization (frame "
          f"{init}) on")
    after = [r for r in tr.trajectory if r.frame_id > init]
    frac = sum(r.tracked for r in after) / max(len(after), 1)
    check(frac >= TRACKED_FRACTION, f"{frac:.4f} of the {len(after)} frames "
          f"after initialization tracked")
    committed = {kf for _, kf, _ in commits}
    check(len(submits) >= MIN_KEYFRAMES
          and {kf for _, kf in submits} <= committed,
          f"{len(submits)} keyframes submitted to the worker, each "
          f"committed ({len(commits)} commits)")
    check(busy_polls[0] >= 1, f"{busy_polls[0]} polls found the worker busy "
          f"(mapping ran beside tracking)")
    rec = [r for r in tr.trajectory if r.tracked]
    est = np.array([-r.R.T @ r.t for r in rec])
    gt = np.array([syn.camera_center(*syn.pose_at(r.frame_id)) for r in rec])
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    ate = float(traj.ate_rmse(est, gt, with_scale=True))
    check(np.isfinite(est).all() and ate < ATE_SPAN_FRACTION * span,
          f"Sim3-aligned ATE {ate:.5f} m over a {span:.3f} m path "
          f"({ate / span:.4f} < {ATE_SPAN_FRACTION})")
    check_mirrors(tr.slam_map)
    prefix_ate = {}
    for n in ATE_PREFIXES:
        sel = np.array([r.frame_id < n for r in rec])
        prefix_ate[n] = float(traj.ate_rmse(est[sel], gt[sel], with_scale=True)
                              / np.linalg.norm(gt[sel].max(0)
                                               - gt[sel].min(0)))

    # the record
    lat = np.array([(retire_t[f] - submit_t[f]) * 1e3
                    for f in range(init + 1, N_BENCH_FRAMES)
                    if f in retire_t])
    full = [(n, ms, busy) for _, n, ms, busy in batches if n == BENCH_BATCH]
    per_frame = {k: [ms / n for n, ms, b in full if b == k]
                 for k in (False, True)}
    job_ms = [(b - a) * 1e3 for a, b in jobs]
    busy_s = sum(b - a for a, b in jobs)
    n_jobs = max(len(jobs), 1)
    # host syncs per batch: those of the calls that dispatched a full batch
    # (and retired the one before it) with no commit or insertion, less the
    # explicit waits of this thread's stage clocks.  (Subtracting the stage
    # ends of every thread, the worker's included, whose waits this thread
    # never sees, undercounts: that figure is kept beside the count.)
    other = {i for i, *_ in commits} | {i for i, _ in submits}
    batch_calls = [i for i, n, _, _ in batches
                   if n == BENCH_BATCH and i not in other and i in n_stages]
    syncs = [n_stages[i][0] - probe * n_stages[i][1] for i in batch_calls]
    syncs_pr4 = [n_stages[i][0] - probe * n_stages[i][2]
                 for i in batch_calls]
    record = dict(
        frames=N_BENCH_FRAMES, frame_batch=BENCH_BATCH, init_frame=init,
        fps_after_init=(N_BENCH_FRAMES - init - 1)
        / ((sum(wall[init + 1:]) + drain_ms) / 1e3),
        run_s=run_s,
        pose_latency_ms=dict(p50=float(np.percentile(lat, 50)),
                             p95=float(np.percentile(lat, 95)),
                             max=float(lat.max())),
        tracking_ms_per_frame=dict(
            worker_idle=float(np.median(per_frame[False]))
            if per_frame[False] else None,
            worker_busy=float(np.median(per_frame[True]))
            if per_frame[True] else None,
            batches_idle=len(per_frame[False]),
            batches_busy=len(per_frame[True]),
            sync_path_phase6=system_record["tracking_ms_per_frame"]["median"]),
        commit_ms=dict(median=float(np.median([c for *_, c in commits])),
                       max=float(max(c for *_, c in commits)),
                       commits=len(commits)),
        insert_keyframe_ms=GLOBAL_TIMER.summary().get(
            "tracking/insertKeyframe"),
        submit_mapping_ms=GLOBAL_TIMER.summary().get(
            "tracking/submitMapping"),
        keyframes_submitted=len(submits),
        # commits whose drain met a due keyframe: it waited for the commit
        # (the JAX tracker inserts it into the map the commit replaces)
        commits_meeting_a_due_keyframe=len(deferred),
        worker_job_ms=dict(median=float(np.median(job_ms)),
                           max=float(max(job_ms))),
        worker_busy_share=busy_s / run_s,
        mapping_ms_per_job={
            n: GLOBAL_TIMER.totals.get(f"mapping/{n}", 0.0) * 1e3 / n_jobs
            for n in MAPPING_STAGES},
        mapping_ms_per_keyframe_sync_phase6=system_record[
            "mapping_ms_per_keyframe"],
        busy_polls=busy_polls[0],
        host_syncs_per_batch=float(np.mean(syncs)) if syncs else None,
        host_syncs_per_batch_all_threads_stages=float(np.mean(syncs_pr4))
        if syncs_pr4 else None,
        tracked_fraction_after_init=frac, ate_m=ate, path_span_m=span,
        ate_span_fraction=ate / span,
        ate_span_fraction_first_frames=prefix_ate, keyframes=int(
            tr.slam_map.kf_valid_np.sum()),
        map_points=int(tr.slam_map.mp_valid_np.sum()),
        launches=launches, place_recognition=True, loop_closing=True,
        loop_verified=verified_loops(logs), loop_closed=closed_loops(logs),
        card=card)
    log(f"  fps {record['fps_after_init']:.3f}; latency "
        f"{record['pose_latency_ms']}; tracking ms/frame "
        f"{record['tracking_ms_per_frame']}; commits {record['commit_ms']}; "
        f"worker busy {record['worker_busy_share']:.3f} of the run; "
        f"mapping per job {record['mapping_ms_per_job']}; syncs per batch "
        f"{record['host_syncs_per_batch']}")
    return record


RELOC_STAGES = ("relocBow", "relocCandidates", "relocMatch", "relocPnP",
                "relocPoseLM", "relocLocalMap")


def reloc_phase(dev, card, kernels):
    """Phase 8: a blackout in the bench configuration's run; the LOST frames
    relocalize through the BoW database and EPnP RANSAC.  Returns the
    {"reloc": ...} record; every check raises."""
    import threading
    import torch
    import smoke_world as syn
    from orb_slam_tpu_torch.dataio import trajectory as traj
    from orb_slam_tpu_torch.ops import describe_cuda, fast_cuda
    from orb_slam_tpu_torch.pipeline.system import System
    from orb_slam_tpu_torch.solvers import pnp
    from orb_slam_tpu_torch.utils.timing import GLOBAL_TIMER

    black = range(BLACKOUT_START, BLACKOUT_START + BLACKOUT_LEN)
    log(f"# phase 8: reloc, {N_RELOC_FRAMES} frames of the sweep from frame "
        f"0 at the bench configuration, frames {black.start}-{black.stop - 1}"
        f" black")
    cfg = bench_config()
    renderer = syn.SceneRenderer(np.random.default_rng(SEED), cfg.camera.K)
    frames = [renderer.render(*syn.pose_at(i)) for i in range(N_RELOC_FRAMES)]
    for i in black:
        frames[i] = np.zeros_like(frames[i])
    system = System.create(cfg, device=dev)
    tr, am = system.tracker, system.tracker.async_mapper
    lc = tr.loop_closer
    check(lc is not None and am is not None and am.loop_closer is lc,
          "Tracker.create built a LoopCloser, shared with the mapping worker")

    # what the checks and the record read: each relocalisation call (time,
    # host syncs, the worker flush inside it, stage times), the winning
    # attempt's PnP inputs, keyframes added to the database by the worker,
    # extraction time of frames that arrive LOST
    main = threading.get_ident()
    attempts, pnp_calls, won, worker_adds = [], [], [], [0]
    flush_ms, extract_ms = [0.0], []
    relocalize, candidate = tr._relocalize, tr._reloc_candidate
    add_kf, flush, extract = lc.add_keyframe, am.flush, tr.extract
    pnp_ransac = pnp.pnp_ransac

    def counted_add(smap, kf):
        worker_adds[0] += threading.get_ident() != main
        return add_kf(smap, kf)

    def timed_flush(*a, **kw):
        t0 = time.perf_counter()
        try:
            return flush(*a, **kw)
        finally:
            flush_ms[0] += (time.perf_counter() - t0) * 1e3

    def timed_extract(image):
        lost = tr.state.name == "LOST"
        t0 = time.perf_counter()
        out = extract(image)
        if lost:
            torch.cuda.current_stream().synchronize()
            extract_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def recorded_pnp(*a, **kw):
        res = pnp_ransac(*a, **kw)
        pnp_calls.append((a, kw, res))
        return res

    def noted_candidate(fd, timestamp, metrics, cand):
        n0 = len(pnp_calls)
        ok = candidate(fd, timestamp, metrics, cand)
        if ok and not won:
            won.append((pnp_calls[-1] if len(pnp_calls) > n0 else None,
                        dict(metrics)))
        return ok

    def timed_relocalize(fd, timestamp, metrics):
        totals0 = {n: GLOBAL_TIMER.totals.get(f"tracking/{n}", 0.0)
                   for n in RELOC_STAGES}
        n0, s0, f0 = clock.calls, sync_w.count, flush_ms[0]
        t0 = time.perf_counter()
        relocalize(fd, timestamp, metrics)
        s1, n_st = sync_w.count, clock.calls - n0
        torch.cuda.current_stream().synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        attempts.append(dict(
            frame=tr.frame_id, event=metrics.get("event"), ms=ms,
            flush_ms=flush_ms[0] - f0,
            syncs=s1 - s0 - probe * n_st,
            stages={n: (GLOBAL_TIMER.totals.get(f"tracking/{n}", 0.0)
                        - totals0[n]) * 1e3 for n in RELOC_STAGES}))

    lc.add_keyframe, am.flush, tr.extract = counted_add, timed_flush, \
        timed_extract
    tr._relocalize, tr._reloc_candidate = timed_relocalize, noted_candidate
    pnp.pnp_ransac = recorded_pnp

    GLOBAL_TIMER.reset()
    clock = MainThreadClock()
    GLOBAL_TIMER.sync = clock
    with ThreadWarnings() as probe_w:
        torch.cuda.set_sync_debug_mode("warn")
        GLOBAL_TIMER.sync()
        torch.cuda.set_sync_debug_mode("default")
    probe = probe_w.count
    torch.cuda.synchronize()
    fast_cuda.fast_nms_blur_stack.launches = 0
    describe_cuda.orient_describe.launches = 0
    logs, kf_at_blackout = [], None
    try:
        with ThreadWarnings() as sync_w:
            torch.cuda.set_sync_debug_mode("warn")
            t_run = time.perf_counter()
            for i, img in enumerate(frames):
                if i == black.start:
                    kf_at_blackout = int(tr.slam_map.kf_valid_np.sum())
                logs.append(system.process_image(img, i / 30.0))
            tr._drain_pipe()
            run_s = time.perf_counter() - t_run
            torch.cuda.set_sync_debug_mode("default")
    finally:
        pnp.pnp_ransac = pnp_ransac
    system.shutdown()                 # flush, commit, join the worker
    GLOBAL_TIMER.sync = None
    launches = {"fast_nms_blur": fast_cuda.fast_nms_blur_stack.launches,
                "orient_describe": describe_cuda.orient_describe.launches}
    for k in kernels:
        k["reloc_launches"] = launches[k["name"]]
        check(k["reloc_launches"] == N_RELOC_FRAMES,
              f"{k['name']} launched {k['reloc_launches']} times in "
              f"{N_RELOC_FRAMES} frames (once per frame, LOST frames "
              f"included)")

    events = [m.get("event") for m in logs]
    log("  events: " + ", ".join(f"{i}:{e}" for i, e in enumerate(events)
                                 if e and e != "lost"))
    check(kf_at_blackout is not None
          and kf_at_blackout >= MIN_KF_BEFORE_BLACKOUT,
          f"{kf_at_blackout} live keyframes when the blackout starts "
          f"(>= {MIN_KF_BEFORE_BLACKOUT})")
    check(events.count("tracking_lost") == 1
          and "system_reset" not in events,
          f"one tracking_lost (frame {events.index('tracking_lost')}) and no "
          f"system_reset")
    lost_at = events.index("tracking_lost")
    check("relocalized" in events, "a LOST frame relocalized")
    rec_at = events.index("relocalized")
    delay = rec_at - black.stop
    check(black.start <= lost_at < black.stop and 0 <= delay <= RELOC_WITHIN,
          f"relocalized at frame {rec_at}, {delay} frames after the "
          f"blackout's end (<= {RELOC_WITHIN})")
    init = events.index("map_initialized")
    ids = [r.frame_id for r in tr.trajectory if r.frame_id >= init]
    check(ids == list(range(init, N_RELOC_FRAMES)),
          f"one trajectory record per frame from initialization (frame "
          f"{init}) on")
    after = [r for r in tr.trajectory if r.frame_id > rec_at]
    frac = sum(r.tracked for r in after) / max(len(after), 1)
    check(frac >= TRACKED_FRACTION, f"{frac:.4f} of the {len(after)} frames "
          f"after relocalisation tracked")
    rec = [r for r in tr.trajectory if r.tracked and r.frame_id >= rec_at]
    est = np.array([-r.R.T @ r.t for r in rec])
    gt = np.array([syn.camera_center(*syn.pose_at(r.frame_id)) for r in rec])
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    ate = float(traj.ate_rmse(est, gt, with_scale=True))
    check(np.isfinite(est).all() and ate < ATE_SPAN_FRACTION * span,
          f"Sim3-aligned ATE after relocalisation {ate:.5f} m over a "
          f"{span:.3f} m path ({ate / span:.4f} < {ATE_SPAN_FRACTION})")
    live = int(tr.slam_map.kf_valid_np.sum())
    check(worker_adds[0] >= 1 and len(lc.db) == live,
          f"{worker_adds[0]} keyframes added to the database on the worker; "
          f"{len(lc.db)} database rows for {live} live keyframes")
    check_mirrors(tr.slam_map)

    pnp_check = pnp_card_vs_cpu(won[0][0], tr.cam, cfg.solver)
    win = won[0][1]
    lost = attempts
    n_lost = max(len(lost), 1)
    stage_ms = {n: sum(a["stages"][n] for a in lost) / n_lost
                for n in RELOC_STAGES}
    won_attempt = [a for a in attempts if a["event"] == "relocalized"][0]
    n_lc = GLOBAL_TIMER.counts.get("mapping/loopClosing", 0)
    record = dict(
        frames=N_RELOC_FRAMES, blackout=[black.start, black.stop],
        keyframes_at_blackout=kf_at_blackout, lost_frame=lost_at,
        recovered_frame=rec_at, recovery_delay_frames=delay,
        attempted_frames=[a["frame"] for a in attempts],
        winning_attempt=dict(
            reloc_kf=win.get("reloc_kf"),
            candidates=win.get("reloc_candidates"),
            matches=win.get("reloc_matches"),
            pnp_inliers=int(won[0][0][2].n_inliers),
            final_inliers=win.get("reloc_inliers"),
            ms=won_attempt["ms"], flush_ms=won_attempt["flush_ms"],
            stages_ms=won_attempt["stages"], host_syncs=won_attempt["syncs"]),
        ms_per_lost_frame=dict(
            median=float(np.median([a["ms"] for a in lost])),
            mean=float(np.mean([a["ms"] for a in lost])),
            worker_flush=float(np.mean([a["flush_ms"] for a in lost])),
            **stage_ms,
            extract_when_lost=float(np.median(extract_ms))
            if extract_ms else None,
            frames=len(lost)),
        host_syncs_per_lost_frame=float(np.mean([a["syncs"] for a in lost])),
        worker_loop_closing_ms_per_keyframe=GLOBAL_TIMER.totals.get(
            "mapping/loopClosing", 0.0) * 1e3 / max(n_lc, 1),
        worker_place_recognition_passes=n_lc,
        worker_keyframes_added=worker_adds[0], database_rows=len(lc.db),
        loop_verified=verified_loops(logs), loop_closed=closed_loops(logs),
        tracked_fraction_after_reloc=frac, ate_after_reloc_m=ate,
        path_span_after_reloc_m=span, ate_span_fraction=ate / span,
        run_s=run_s, pnp_card_vs_cpu=pnp_check, launches=launches,
        card=card)
    log(f"  lost at {lost_at}, relocalized at {rec_at} (+{delay}); "
        f"per LOST frame {record['ms_per_lost_frame']}; syncs "
        f"{record['host_syncs_per_lost_frame']:.2f}; winning attempt "
        f"{record['winning_attempt']}; worker loopClosing "
        f"{record['worker_loop_closing_ms_per_keyframe']:.3f} ms/keyframe")
    return record


def encode_png(pixels, palette=None, level=6):
    """An 8-bit non-interlaced PNG file's bytes, from the standard library:
    uint8 pixels [H, W] or [H, W, C] (C = 1 grey, 2 grey + alpha, 3 RGB,
    4 RGBA), or palette indices [H, W] with `palette` [n, 3] uint8.  Row y
    is filtered with filter type y % 5, so a file of 5 rows or more holds
    every filter (None, Sub, Up, Average, Paeth)."""
    import struct
    import zlib
    px = np.asarray(pixels, np.uint8)
    if px.ndim == 2:
        px = px[..., None]
    h, w, c = px.shape
    ctype = 3 if palette is not None else {1: 0, 2: 4, 3: 2, 4: 6}[c]
    x = px.reshape(h, w * c).astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, c:] = x[:, :-c]
    upleft = np.zeros_like(x)
    upleft[:, c:] = up[:, :-c]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    pred = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    ft = np.arange(h) % 5
    rows = np.concatenate([ft[:, None], (x - pred[ft, np.arange(h)]) & 255],
                          axis=1).astype(np.uint8)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(body, zlib.crc32(kind))))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return (out + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))


def undistorted_rays(cam_cfg):
    """[H, W, 3] float32 rays (x, y, 1) of the pixel grid of a camera with
    cam_cfg's intrinsics and Brown distortion (k1, k2, k3 radial, p1, p2
    tangential): each pixel's distorted normalized coordinates inverted
    through the model by Newton's method in float64, independently of the
    port's geometry/camera.py.  Returns (rays, the largest residual of the
    inversion in pixels)."""
    c = cam_cfg
    uu, vv = np.meshgrid(np.arange(c.width, dtype=np.float64),
                         np.arange(c.height, dtype=np.float64))
    xd, yd = (uu - c.cx) / c.fx, (vv - c.cy) / c.fy

    def distort(x, y):
        r2 = x * x + y * y
        rad = 1 + r2 * (c.k1 + r2 * (c.k2 + r2 * c.k3))
        drad = c.k1 + r2 * (2 * c.k2 + 3 * c.k3 * r2)     # d rad / d r2
        fx_ = x * rad + 2 * c.p1 * x * y + c.p2 * (r2 + 2 * x * x)
        fy_ = y * rad + c.p1 * (r2 + 2 * y * y) + 2 * c.p2 * x * y
        j11 = rad + 2 * x * x * drad + 2 * c.p1 * y + 6 * c.p2 * x
        j12 = 2 * x * y * drad + 2 * c.p1 * x + 2 * c.p2 * y
        j22 = rad + 2 * y * y * drad + 6 * c.p1 * y + 2 * c.p2 * x
        return fx_, fy_, j11, j12, j22       # j21 == j12

    x, y = xd.copy(), yd.copy()
    for _ in range(BROWN_NEWTON_ITERS):
        fx_, fy_, j11, j12, j22 = distort(x, y)
        rx, ry = fx_ - xd, fy_ - yd
        det = j11 * j22 - j12 * j12
        x -= (j22 * rx - j12 * ry) / det
        y -= (j11 * ry - j12 * rx) / det
    fx_, fy_ = distort(x, y)[:2]
    residual = float(max(np.abs(fx_ - xd).max() * c.fx,
                         np.abs(fy_ - yd).max() * c.fy))
    rays = np.stack([x, y, np.ones_like(x)], -1).astype(np.float32)
    return rays, residual


def write_tum_folder(root, cam_cfg):
    """N_CLI frames of the bench sweep rendered through cam_cfg (rays of
    the undistorted pixel grid) into a TUM-layout folder: rgb/*.png (8-bit
    RGB, three equal channels), rgb.txt with a comment header and
    groundtruth.txt (ts tx ty tz qx qy qz qw, camera to world).  Returns
    (the frames [H, W] uint8, the camera centres [N, 3], the inversion's
    residual in pixels)."""
    import os
    from scipy.spatial.transform import Rotation
    import smoke_world as syn
    renderer = syn.SceneRenderer(np.random.default_rng(SEED), cam_cfg.K)
    renderer.dirs, residual = undistorted_rays(cam_cfg)
    os.makedirs(os.path.join(root, "rgb"))
    frames, centres, rgb_lines, gt_lines = [], [], [], []
    for i in range(N_CLI):
        R, t = syn.pose_at(i)
        img = renderer.render(R, t)
        name = f"rgb/{i:04d}.png"
        with open(os.path.join(root, name), "wb") as f:
            f.write(encode_png(np.repeat(img[..., None], 3, axis=2),
                               level=1))
        C = syn.camera_center(R, t)
        q = Rotation.from_matrix(np.asarray(R, np.float64).T).as_quat()
        ts = i / 30.0
        rgb_lines.append(f"{ts:.6f} {name}")
        gt_lines.append(f"{ts:.6f} " + " ".join(f"{v:.7f}" for v in C)
                        + " " + " ".join(f"{v:.7f}" for v in q))
        frames.append(img)
        centres.append(C)
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("# color images\n# timestamp filename\n"
                + "\n".join(rgb_lines) + "\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("# ground truth trajectory\n# timestamp tx ty tz qx qy qz "
                "qw\n" + "\n".join(gt_lines) + "\n")
    return frames, np.asarray(centres, np.float64), residual


def path_length(centres):
    c = np.asarray(centres, np.float64)
    return float(np.linalg.norm(np.diff(c, axis=0), axis=1).sum())


def cli_phase(dev, card, kernels):
    """Phase 9: the user's entry points from disk.  Writes a TUM-layout
    folder, reads it back through the port's TumSequence, runs the CLI's
    main() on the card, then saves a checkpoint from one System and
    resumes it in a fresh one, which relocalizes into the loaded map.
    Returns the {"cli": ...} and {"resume": ...} records; every check
    raises."""
    import contextlib
    import io
    import os
    import re
    import tempfile
    import torch
    from orb_slam_tpu_torch.config import tum_freiburg1_config
    from orb_slam_tpu_torch.dataio.datasets import TumSequence, load_gray
    from orb_slam_tpu_torch.ops import describe_cuda, fast_cuda
    from orb_slam_tpu_torch.pipeline import system as system_mod

    log(f"# phase 9: cli and resume, {N_CLI} frames of the sweep through "
        f"fr1's intrinsics and distortion, written as a TUM folder")
    cfg = tum_freiburg1_config()
    kernel_fns = {"fast_nms_blur": fast_cuda.fast_nms_blur_stack,
                  "orient_describe": describe_cuda.orient_describe}

    def reset_launches():
        torch.cuda.synchronize()
        for fn in kernel_fns.values():
            fn.launches = 0

    def read_launches(n_frames, what):
        out = {n: fn.launches for n, fn in kernel_fns.items()}
        for n, count in out.items():
            check(count == n_frames,
                  f"{n} launched {count} times in the {n_frames} frames of "
                  f"{what} (once per frame)")
        return out

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "seq")
        t0 = time.perf_counter()
        frames, centres, residual = write_tum_folder(root, cfg.camera)
        write_s = time.perf_counter() - t0
        check(residual <= BROWN_RESIDUAL_PX,
              f"the Brown model's numpy inverse reproduces every pixel "
              f"within {residual:.2e} px (<= {BROWN_RESIDUAL_PX})")

        # the reader on the card's host: every frame exact, decode timed
        # (after a first decode, which builds the compiled unfilter)
        seq = TumSequence.open(root)
        t0 = time.perf_counter()
        load_gray(seq.paths[0])
        first_decode_ms = (time.perf_counter() - t0) * 1e3
        it = seq.frames()
        decoded, decode_ms = [], []
        for _ in range(len(seq)):
            t0 = time.perf_counter()
            ts, img = next(it)
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            decoded.append((ts, img))
        exact = all(img.dtype == np.float32 and img.shape == (480, 640)
                    and np.array_equal(img, f.astype(np.float32))
                    for (_, img), f in zip(decoded, frames))
        check(len(seq) == N_CLI and exact,
              f"TumSequence yields the {N_CLI} rendered frames exactly "
              f"(float32 [480, 640])")
        gt = seq.groundtruth()
        check(gt.shape == (N_CLI, 8)
              and np.abs(gt[:, 1:4] - centres).max() < 1e-6,
              "TumSequence.groundtruth reads the written centres")

        # the CLI, as a user calls it: main() on the card
        out_dir = os.path.join(tmp, "out")
        buf = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            system = system_mod.main(["--dataset", "tum", "--root", root,
                                      "--calib", "fr1", "--out-dir",
                                      out_dir])
        cli_s = time.perf_counter() - t0
        out = buf.getvalue()
        for line in out.splitlines():
            if line.startswith(("frame ", "tracked ", "trajectory ", "ATE")):
                log("  | " + line)
        cli_launches = read_launches(N_CLI, "the CLI run")
        for k in kernels:
            k["cli_launches"] = cli_launches[k["name"]]
        m = re.search(r"^frame (\d+): map_initialized", out, re.M)
        check(m is not None, "the CLI printed a map_initialized event")
        init = int(m.group(1)) - 1
        tr = system.tracker
        after = [r for r in tr.trajectory if r.frame_id > init]
        check([r.frame_id for r in after] == list(range(init + 1, N_CLI)),
              f"one trajectory record per frame after initialization "
              f"(frame {init})")
        frac = sum(r.tracked for r in after) / max(len(after), 1)
        check(frac >= TRACKED_FRACTION,
              f"{frac:.4f} of the {len(after)} frames after initialization "
              f"tracked (>= {TRACKED_FRACTION})")
        with open(os.path.join(out_dir, "KeyFrameTrajectory.txt")) as f:
            rows = [r.split() for r in f.read().strip().splitlines()]
        check(len(rows) >= 3 and all(len(r) == 8 for r in rows),
              f"KeyFrameTrajectory.txt: {len(rows)} rows of 8 columns")
        m_fps = re.search(r"^tracked (\d+) frames in ([0-9.]+)s "
                          r"\(([0-9.]+) fps\)", out, re.M)
        m_ate = re.search(r"^ATE RMSE \(Sim3-aligned\): ([0-9.]+) m", out,
                          re.M)
        check(m_fps is not None and int(m_fps.group(1)) == N_CLI,
              f"the CLI printed the fps line for {N_CLI} frames")
        length = path_length(centres)
        check(m_ate is not None
              and float(m_ate.group(1)) < ATE_PATH_FRACTION * length,
              f"the printed ATE {m_ate and m_ate.group(1)} m is below "
              f"{ATE_PATH_FRACTION} of the {length:.3f} m ground-truth path")
        ate = float(system.evaluate_ate(gt))
        cli = dict(
            frames=N_CLI, write_folder_s=write_s, brown_residual_px=residual,
            decode_ms_per_frame=dict(
                median=float(np.median(decode_ms)),
                p95=float(np.percentile(decode_ms, 95)),
                max=float(np.max(decode_ms)),
                first_call_with_build=first_decode_ms,
                png_bytes_median=float(np.median([
                    os.path.getsize(p) for p in seq.paths]))),
            init_frame=init, tracked_fraction_after_init=frac,
            keyframe_rows=len(rows), printed_fps=float(m_fps.group(3)),
            main_s=cli_s, printed_ate_m=float(m_ate.group(1)), ate_m=ate,
            path_length_m=length, ate_path_fraction=ate / length,
            path_span_m=float(np.linalg.norm(centres.max(0)
                                             - centres.min(0))),
            events=[line for line in out.splitlines()
                    if line.startswith("frame ")],
            launches=cli_launches, card=card)
        log(f"  decode {cli['decode_ms_per_frame']}; init at {init}; "
            f"{frac:.4f} tracked; ATE {ate:.5f} m over a {length:.3f} m "
            f"path; {cli['printed_fps']} fps printed")

        resume = resume_run(cfg, decoded, tmp, reset_launches,
                            read_launches, card)
        for k in kernels:
            k["resume_launches"] = sum(
                r[k["name"]] for r in resume["launches"].values())
    return cli, resume


def resume_run(cfg, decoded, tmp, reset_launches, read_launches, card):
    """Phase 9's second half: System A tracks the first RESUME_SAVE_AT
    frames and saves a checkpoint; the file loads on the card and on the
    CPU alike; a fresh System B resumes it and replays frames of the
    mapped region with later timestamps: it must relocalize within
    RELOC_WITHIN_REPLAY frames, track every frame after, and put the
    camera where System A had it."""
    import os
    import torch
    from orb_slam_tpu_torch.mapping import checkpoint, mapstore
    from orb_slam_tpu_torch.pipeline.system import System

    reset_launches()
    sys_a = System.create(cfg)
    for ts, img in decoded[:RESUME_SAVE_AT]:
        sys_a.process_image(img, ts)
    launches_a = read_launches(RESUME_SAVE_AT, "System A's run")
    tra = sys_a.tracker
    check(tra.state.name == "WORKING",
          f"System A tracks at frame {RESUME_SAVE_AT - 1}")
    path = os.path.join(tmp, "map.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sys_a.save_checkpoint(path)
    save_ms = (time.perf_counter() - t0) * 1e3
    mb = os.path.getsize(path) / 1e6
    centres_a = {r.frame_id: -r.R.T @ r.t for r in tra.trajectory
                 if r.tracked}
    n_kf = tra.slam_map.n_kf
    sys_a.shutdown()

    t0 = time.perf_counter()
    card_map = checkpoint.load_map(path, cfg.map)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    cpu_map = checkpoint.load_map(path, cfg.map, device="cpu")
    same = (card_map.device.type == "cuda" and cpu_map.device.type == "cpu"
            and (card_map.n_kf, card_map.n_mp) == (cpu_map.n_kf,
                                                    cpu_map.n_mp) == (
                n_kf, tra.slam_map.n_mp))
    for name in mapstore.MapState._fields:
        same &= torch.equal(getattr(card_map.state, name).cpu(),
                            getattr(cpu_map.state, name))
    for name in ("parent", "kf_frame_id", "kf_timestamp", "obs_np",
                 "kf_valid_np", "mp_valid_np"):
        same &= np.array_equal(getattr(card_map, name),
                               getattr(cpu_map, name))
    for name, arr in card_map.host.items():
        same &= np.array_equal(arr, cpu_map.host[name])
    check(same, f"the checkpoint ({mb:.2f} MB) loads on the card and on the "
          f"CPU with equal arrays, counters and mirrors")
    del card_map, cpu_map

    sys_b = System.create(cfg)
    trb = sys_b.tracker
    adopt_ms, attempts = [], []
    adopt, relocalize = trb.adopt_map, trb._relocalize

    def timed_adopt(smap):
        t0 = time.perf_counter()
        adopt(smap)
        adopt_ms.append((time.perf_counter() - t0) * 1e3)

    def timed_relocalize(fd, timestamp, metrics):
        s0 = sync_w.count
        t0 = time.perf_counter()
        relocalize(fd, timestamp, metrics)
        syncs = sync_w.count - s0
        torch.cuda.current_stream().synchronize()
        attempts.append(dict(frame=trb.frame_id, event=metrics.get("event"),
                             ms=(time.perf_counter() - t0) * 1e3,
                             host_syncs=syncs,
                             reloc_kf=metrics.get("reloc_kf"),
                             candidates=metrics.get("reloc_candidates"),
                             inliers=metrics.get("reloc_inliers")))

    trb.adopt_map, trb._relocalize = timed_adopt, timed_relocalize
    t0 = time.perf_counter()
    sys_b.resume_checkpoint(path)
    torch.cuda.synchronize()
    resume_ms = (time.perf_counter() - t0) * 1e3
    check(trb.state.name == "LOST" and trb.slam_map.n_kf == n_kf,
          f"System B resumes LOST with the saved {n_kf} keyframes")
    st = trb.slam_map.state
    mirrors = (np.array_equal(st.kf_obs.cpu().numpy(), trb.slam_map.obs_np)
               and np.array_equal(st.kf_valid.cpu().numpy(),
                                  trb.slam_map.kf_valid_np)
               and np.array_equal(st.mp_valid.cpu().numpy(),
                                  trb.slam_map.mp_valid_np))
    for name, arr in trb.slam_map.host.items():
        mirrors &= np.array_equal(getattr(st, name).cpu().numpy(), arr)
    check(mirrors, "every host mirror of the resumed map equals its table")
    first_id = trb.frame_id
    check(len(trb.loop_closer.db) == int(trb.slam_map.kf_valid_np.sum()),
          "one database row per live keyframe after the resume")

    reset_launches()
    logs = []
    with ThreadWarnings() as sync_w:
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for k, i in enumerate(RESUME_REPLAY):
                ts = decoded[RESUME_SAVE_AT - 1][0] + (k + 1) / 30.0
                logs.append(sys_b.process_image(decoded[i][1], ts))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sys_b.shutdown()
    launches_b = read_launches(len(RESUME_REPLAY), "System B's replay")
    events = [m.get("event") for m in logs]
    log("  replay events: " + ", ".join(
        f"{RESUME_REPLAY[k]}:{e}" for k, e in enumerate(events) if e))
    check("relocalized" in events[:RELOC_WITHIN_REPLAY],
          f"System B relocalized within {RELOC_WITHIN_REPLAY} replayed "
          f"frames ({events})")
    r = events.index("relocalized")
    recs = [x for x in trb.trajectory if x.frame_id >= first_id + r]
    check([x.frame_id for x in recs]
          == list(range(first_id + r, first_id + len(RESUME_REPLAY)))
          and all(x.tracked for x in recs),
          f"every replayed frame from the relocalized one ({r}) on tracked")
    err = max(float(np.linalg.norm(
        -x.R.T @ x.t - centres_a[RESUME_REPLAY[x.frame_id - first_id]]))
        for x in recs)
    length = path_length([centres_a[f] for f in sorted(centres_a)])
    check(err <= RESUME_CENTRE_FRACTION * length,
          f"System B's centres within {err:.5f} of System A's for the same "
          f"frames (<= {RESUME_CENTRE_FRACTION} of A's {length:.4f} path, "
          f"map units)")
    won = [a for a in attempts if a["event"] == "relocalized"][0]
    record = dict(
        saved_after_frames=RESUME_SAVE_AT, keyframes=n_kf,
        map_points=int(trb.slam_map.n_mp), checkpoint_mb=mb,
        save_ms=save_ms, load_ms_card=load_ms, resume_ms=resume_ms,
        adopt_ms=adopt_ms[0],
        replayed=[RESUME_REPLAY.start, RESUME_REPLAY.stop],
        relocalized_replay_index=r,
        relocalized_frame=RESUME_REPLAY[r], attempts=len(attempts),
        winning_attempt=won,
        lost_attempt_ms=[a["ms"] for a in attempts
                         if a["event"] != "relocalized"],
        centre_err_max=err, path_length_a=length,
        centre_err_path_fraction=err / length,
        launches=dict(system_a=launches_a, replay=launches_b), card=card)
    log(f"  checkpoint {mb:.2f} MB, save {save_ms:.1f} ms, load "
        f"{load_ms:.1f} ms, adopt {adopt_ms[0]:.1f} ms; relocalized at "
        f"replay {r} (frame {RESUME_REPLAY[r]}) in {won['ms']:.1f} ms, "
        f"{won['host_syncs']} host syncs; centres within {err:.5f} "
        f"({err / length:.5f} of the path)")
    return record


def pnp_card_vs_cpu(call, cam, solver_cfg):
    """The winning attempt's pnp_ransac on the card and on the CPU with the
    same inputs and samples: the same ok and inlier count, inlier masks
    apart on <= PNP_INLIER_MASK_AGREE of the rows, and the pose refined by
    the pose LM over each device's inliers within PNP_POSE_AGREE.  The raw
    RANSAC poses are reported, not gated: a 4-point EPnP hypothesis is the
    solution of a 4-dimensional numerical null space whose basis the two
    eigh implementations pick differently."""
    import torch
    from orb_slam_tpu_torch.geometry.camera import CameraParams
    from orb_slam_tpu_torch.solvers import pnp, pose_opt
    args, kw, _ = call
    cpu = [a.cpu() for a in args]
    t0 = time.perf_counter()
    card_res = pnp.pnp_ransac(*args, **kw)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cpu_res = pnp.pnp_ransac(*cpu, **kw)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    X, uv, inv_s2, valid, _ = args
    cam_c = CameraParams(*[x.cpu() if isinstance(x, torch.Tensor) else x
                           for x in cam])
    r_card = pose_opt.optimize_pose(card_res.R, card_res.t, X, uv, inv_s2,
                                    valid & card_res.inliers, cam, solver_cfg)
    r_cpu = pose_opt.optimize_pose(cpu_res.R, cpu_res.t, *cpu[:3],
                                   cpu[3] & cpu_res.inliers, cam_c,
                                   solver_cfg)

    def apart(Ra, ta, Rb, tb):
        Ra, ta = Ra.cpu().double(), ta.cpu().double()
        Rb, tb = Rb.cpu().double(), tb.cpu().double()
        return (float(torch.linalg.matrix_norm(Ra - Rb)),
                float(torch.linalg.vector_norm(ta - tb)
                      / torch.linalg.vector_norm(tb)))

    mask_diff = float((card_res.inliers.cpu() != cpu_res.inliers).float()
                      .mean())
    raw = apart(card_res.R, card_res.t, cpu_res.R, cpu_res.t)
    refined = apart(r_card.R, r_card.t, r_cpu.R, r_cpu.t)
    check(bool(card_res.ok) == bool(cpu_res.ok)
          and int(card_res.n_inliers) == int(cpu_res.n_inliers),
          f"pnp_ransac card vs CPU: same ok and {int(cpu_res.n_inliers)} "
          f"inliers")
    check(mask_diff <= PNP_INLIER_MASK_AGREE,
          f"pnp_ransac card vs CPU: inlier masks apart on {mask_diff:.4f} of "
          f"the rows (<= {PNP_INLIER_MASK_AGREE})")
    check(max(refined) <= PNP_POSE_AGREE,
          f"pnp_ransac card vs CPU: refined poses within {refined[0]:.2e} "
          f"(rotation) and {refined[1]:.2e} (relative translation) <= "
          f"{PNP_POSE_AGREE}; raw RANSAC poses {raw[0]:.2e} / {raw[1]:.2e}")
    syncs = pnp_selection_syncs(args, kw)
    log(f"  pnp_ransac host syncs: {syncs['call']} per call (sites "
        f"{syncs['call_sites']}); picking the best hypothesis: "
        f"{syncs['index_select']} with index_select, "
        f"{syncs['zero_d_index']} by 0-d CUDA indexing")
    return dict(n_inliers=int(card_res.n_inliers), mask_diff=mask_diff,
                raw_pose_apart=raw, refined_pose_apart=refined,
                n_samples=int(kw["samples"].shape[0]),
                min_set=int(kw["samples"].shape[1]),
                card_ms=card_ms, cpu_ms=cpu_ms, host_syncs=syncs)


def pnp_selection_syncs(args, kw):
    """Host syncs of one pnp_ransac call on the card (sync debug mode),
    and of its best-hypothesis pick on that call's scored hypotheses two
    ways: with index_select, as shipped, and by indexing with the 0-d
    argmax, as before (which reads the index to the host at each use)."""
    import torch
    from orb_slam_tpu_torch.geometry import se3
    from orb_slam_tpu_torch.solvers import epnp, pnp
    X, uv, inv_s2, valid, K = args
    samples = kw["samples"].to(device=X.device, dtype=torch.int64)
    Rs, ts = epnp.epnp(X[samples], uv[samples], K)
    xc = se3.transform(Rs[:, None], ts[:, None], X[None])
    z = xc[..., 2]
    u = xc[..., 0] / torch.clamp(z, min=1e-6) * K[0, 0] + K[0, 2]
    v = xc[..., 1] / torch.clamp(z, min=1e-6) * K[1, 1] + K[1, 2]
    inls = valid[None] & (z > 0) & (
        ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) * inv_s2 <= 5.991)
    counts = inls.sum(dim=1)
    torch.cuda.synchronize()

    def counted(fn):
        with ThreadWarnings() as w:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return w

    def by_index_select():
        best = torch.argmax(counts)[None]
        return [x.index_select(0, best)[0] for x in (counts, Rs, ts, inls)]

    def by_zero_d():
        best = torch.argmax(counts)
        return counts[best] >= 1, Rs[best], ts[best], inls[best], counts[best]

    # the debug mode's own switch may warn once: counted apart
    probe = counted(lambda: None).count
    call = counted(lambda: pnp.pnp_ransac(*args, **kw))
    return dict(call=call.count - probe, call_sites=call.sites,
                index_select=counted(by_index_select).count - probe,
                zero_d_index=counted(by_zero_d).count - probe)


def verified_loops(logs):
    """Keyframes whose loop check verified a candidate (``loop_with``)."""
    return sum(("loop_with" in m.get("mapping", {})) + ("loop_with" in m)
               for m in logs)


def closed_loops(logs):
    """Keyframes whose verified loop was corrected (``loop_closed``)."""
    return sum(bool(m.get("mapping", {}).get("loop_closed"))
               + bool(m.get("loop_closed")) for m in logs)


def check_mirrors(smap):
    """Every host mirror bitwise equal to its table (the landmark counts'
    mirrors are insertion-time snapshots by design)."""
    st = smap.state
    same = (np.array_equal(st.kf_obs.cpu().numpy(), smap.obs_np)
            and np.array_equal(st.kf_valid.cpu().numpy(), smap.kf_valid_np)
            and np.array_equal(st.mp_valid.cpu().numpy(), smap.mp_valid_np))
    for name, arr in smap.host.items():
        if name not in ("mp_found", "mp_visible"):
            same &= np.array_equal(getattr(st, name).cpu().numpy(), arr)
    check(same, "every host mirror equal to its table after the run")


def kernel_entry(name, replaces, err, ms, plain_ms, t_bytes, t_ops):
    """One kernel's record of the `kernels` JSON line, with the registers
    and spill bytes of its build; launches are filled in by the main
    path."""
    from orb_slam_tpu_torch import _build
    bound = max(t_bytes, t_ops)
    return dict(
        name=name, route="cuda", source=f"orb_slam_tpu_torch/csrc/{name}.cu",
        replaces=replaces, launches=None, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, share_of_bound=bound / ms, **_build.ptxas_info(name))


def touched_pixels(det, counts, m01, m10, patches):
    """Distinct raw and blurred pixels that kernel 2 reads for this frame's
    live keypoints (the bytes its bound counts)."""
    import torch
    from orb_slam_tpu_torch.ops import brief
    stack = det.stack
    L, H, W = stack.shape
    dev = stack.device
    cap = det.kp.xy.shape[1]
    live = torch.arange(cap, device=dev)[None, :] < counts[:, None]
    lvl = torch.arange(L, device=dev)[:, None].expand(L, cap)[live]
    xy = det.kp.xy[live]
    lh = det.dims[lvl, 0].long()[:, None]
    lw = det.dims[lvl, 1].long()[:, None]
    r = patches.HALF_PATCH
    d = torch.arange(-r, r + 1, device=dev)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    disc = (dx * dx + dy * dy <= r * r).reshape(-1)
    cx = torch.round(xy[:, 0]).long()[:, None]
    cy = torch.round(xy[:, 1]).long()[:, None]
    ys = torch.minimum(torch.clamp(cy + dy.reshape(-1)[disc], min=0), lh - 1)
    xs = torch.minimum(torch.clamp(cx + dx.reshape(-1)[disc], min=0), lw - 1)
    raw = torch.unique((lvl[:, None] * H + ys) * W + xs).numel()
    m01l, m10l = m01[live], m10[live]
    hyp = torch.sqrt(m10l * m10l + m01l * m01l)
    ca = torch.where(hyp > 0, m10l / hyp.clamp(min=1e-30),
                     torch.ones_like(hyp))[:, None]
    sa = torch.where(hyp > 0, m01l / hyp.clamp(min=1e-30),
                     torch.zeros_like(hyp))[:, None]
    pts = torch.from_numpy(brief._POINTS).to(dev)
    sx = torch.round(pts[:, 0] * ca - pts[:, 1] * sa + xy[:, 0:1]).long()
    sy = torch.round(pts[:, 0] * sa + pts[:, 1] * ca + xy[:, 1:2]).long()
    sx = torch.minimum(torch.clamp(sx, min=0), lw - 1)
    sy = torch.minimum(torch.clamp(sy, min=0), lh - 1)
    blur = torch.unique((lvl[:, None] * H + sy) * W + sx).numel()
    return raw, blur


if __name__ == "__main__":
    sys.exit(main())
