#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's per-frame tracking step on one NVIDIA GPU.

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
  7. report   a JSON line of per-kernel numbers (with each kernel's share
              of its bound and its registers and spill bytes from the
              build), then the last line {"ok": true, "device": {...}}

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
FNB_TILE = (32, 32)          # kernel 1's tile, (width, height), as its .cu


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
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for img in frames[:SYNC_FRAMES]:
            torch.cuda.set_sync_debug_mode("warn")
            out = fs.frame_step(img, *state, cam, **kw, device=dev)
            torch.cuda.set_sync_debug_mode("default")
            state = st.chain(state, out)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    log(f"  frame_step median {np.median(step_ms):.3f} ms/frame "
        f"(min {min(step_ms):.3f}, max {max(step_ms):.3f}); host syncs "
        f"{syncs / SYNC_FRAMES:.2f}/frame measured, {HOST_SYNCS_PER_FRAME} by "
        f"design; f2f median {np.median(blobs[:, 12]):.0f}, local-map "
        f"median {np.median(blobs[:, 13]):.0f}")

    # --- 6. system ---------------------------------------------------------
    system = system_phase(dev, card, kernels)

    # --- 7. report ---------------------------------------------------------
    print(card, flush=True)
    print(json.dumps({"system": system}), flush=True)
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
    import torch
    import smoke_world as syn
    from orb_slam_tpu_torch import native
    from orb_slam_tpu_torch.dataio import trajectory as traj
    from orb_slam_tpu_torch.ops import describe_cuda, fast_cuda
    from orb_slam_tpu_torch.pipeline.system import System
    from orb_slam_tpu_torch.utils.timing import GLOBAL_TIMER

    log(f"# phase 6: system, {N_SYSTEM_FRAMES} frames of the sweep from "
        f"frame 0")
    init_shape_kernels(dev, kernels)
    cfg = system_config()
    renderer = syn.SceneRenderer(np.random.default_rng(SEED), cfg.camera.K)
    frames = [renderer.render(*syn.pose_at(i))
              for i in range(N_SYSTEM_FRAMES)]
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
    for k in kernels:
        k["system_launches"] = launches[k["name"]]
        check(k["system_launches"] == N_SYSTEM_FRAMES,
              f"{k['name']} launched {k['system_launches']} times in "
              f"{N_SYSTEM_FRAMES} frames (one per extracting frame)")

    events = [m.get("event") for m in logs]
    log("  events: " + ", ".join(f"{i}:{e}" for i, e in enumerate(events)
                                 if e))
    check("map_initialized" in events[:INIT_WITHIN],
          f"map initialized within {INIT_WITHIN} frames")
    init = events.index("map_initialized")
    tr = system.tracker
    after = [r for r in tr.trajectory if r.frame_id > init]
    frac = sum(r.tracked for r in after) / max(len(after), 1)
    check(frac >= TRACKED_FRACTION, f"{frac:.4f} of the {len(after)} frames "
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

    working = [i for i in range(init + 1, N_SYSTEM_FRAMES)
               if events[i] is None and logs[i]["state"] == "WORKING"]
    kf_after = [i for i in kf_frames if i > init]

    def stage_ms(name):
        total = GLOBAL_TIMER.totals.get(f"mapping/{name}", 0.0)
        return total * 1e3 / max(len(kf_after), 1)

    w_ms = [wall[i] for i in working]
    record = dict(
        frames=N_SYSTEM_FRAMES, init_frame=init, init_ms=wall[init],
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
        launches=launches, synchronize_flagged=bool(probe), card=card)
    log(f"  tracking {record['tracking_ms_per_frame']} ms/frame; keyframe "
        f"frames {record['keyframe_frame_ms']} ms; mapping per keyframe "
        f"{record['mapping_ms_per_keyframe']}; syncs "
        f"{record['host_syncs']}")
    return record


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
