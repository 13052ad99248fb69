#!/usr/bin/env python3
"""Steady-state frames/s of the PyTorch/CUDA port's live tracker on rendered
images: the twin of the repository's ``bench.py`` for
``orb_slam_tpu_torch``.

    python3 scripts/torch_bench.py [--frames 600]

The same world (``smoke_world.SceneRenderer`` and ``pose_at``, renderer
seed 11), the same configuration (``bench.py:152-177`` without its
environment knobs: 640x480, 8 levels, 1000 features in 1024 slots,
``window_init=120``, the default MapConfig, async mapping, frame_batch 16),
the same bootstrap (up to 40 frames until WORKING with >= 3 keyframes), the
same warm-up (>= 4 more keyframes and the mapping worker idle, then
``finish()``), the same measured window (pre-rendered frames, the clock
stopped after the pipeline is drained, pose latency from submit to retire)
and the same gates (>= 90% of the window tracked, >= 5 keyframe
insertions).  The mapping worker runs local mapping and loop closing
(every keyframe into the BoW database, loop detection, the check of
consistent candidates and the correction of a verified loop), as the JAX
bench's does; ``"loop_verified"`` counts the keyframes whose check
verified a candidate, ``"loop_closed"`` those whose loop was corrected.
Difference: no prewarm calls (nothing compiles).  It runs on the card and
fails without one.

Prints detail lines, then one JSON line:
  {"metric": "tracking_fps", "value": N, "unit": "frames/s",
   "vs_baseline": N / 30, ..., "place_recognition": true,
   "loop_closing": true, "loop_verified": N, "loop_closed": N,
   "card": "..."}
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=600,
                    help="frames in the measured window (bench.py: 600)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_bench: no CUDA device", file=sys.stderr)
        return 1
    import smoke_world as syn
    from orb_slam_tpu_torch.config import (
        CameraConfig, ExtractorConfig, MatcherConfig, SystemConfig,
        TrackerConfig)
    from orb_slam_tpu_torch.pipeline.system import System
    from orb_slam_tpu_torch.pipeline.tracker import TrackState
    from orb_slam_tpu_torch.utils.timing import GLOBAL_TIMER

    card = gpu_line()
    print(f"# card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    rng = np.random.default_rng(11)
    cfg = SystemConfig(
        camera=CameraConfig(fx=500, fy=500, cx=320, cy=240,
                            k1=0, k2=0, p1=0, p2=0, k3=0,
                            width=640, height=480),
        extractor=ExtractorConfig(n_features=1000, max_keypoints=1024,
                                  n_levels=8),
        matcher=MatcherConfig(window_init=120),
        tracker=TrackerConfig(async_mapping=True, frame_batch=16))
    system = System.create(cfg)
    tracker = system.tracker
    scene = syn.SceneRenderer(rng, cfg.camera.K)

    # bootstrap: init + first keyframes (not measured)
    t_boot = time.perf_counter()
    i = 0
    while i < 40 and not (tracker.state == TrackState.WORKING
                          and tracker.slam_map.n_kf >= 3):
        system.process_image(scene.render(*syn.pose_at(i)),
                             timestamp=i / 30.0)
        i += 1
    if tracker.state != TrackState.WORKING:
        raise RuntimeError("bootstrap failed")

    # warm-up: several keyframes mapped and the worker idle, so the window
    # starts in steady state
    warm_kf0 = tracker.slam_map.n_kf
    warm_deadline = i + 120
    while i < warm_deadline and (tracker.slam_map.n_kf < warm_kf0 + 4
                                 or tracker.async_mapper.busy):
        system.process_image(scene.render(*syn.pose_at(i)),
                             timestamp=i / 30.0)
        i += 1
    tracker.finish()
    print(f"# bootstrap + warm-up: {i} frames, {tracker.slam_map.n_kf} "
          f"keyframes, {time.perf_counter() - t_boot:.1f} s (unmeasured)",
          flush=True)

    n_frames = args.frames
    frames = [scene.render(*syn.pose_at(i + j)) for j in range(n_frames)]
    n_kf0 = tracker.slam_map.n_kf
    fid0 = tracker.frame_id
    traj = tracker.trajectory
    n_traj0 = len(traj)
    submit_t = np.zeros(n_frames)
    retire_t = np.full(n_frames, np.nan)
    all_metrics = []

    def scan_retired():
        now = time.perf_counter()
        for rec in traj[n_traj0:]:
            j = rec.frame_id - fid0
            if 0 <= j < n_frames and np.isnan(retire_t[j]):
                retire_t[j] = now

    GLOBAL_TIMER.reset()
    t_all0 = time.perf_counter()
    for j, img in enumerate(frames):
        submit_t[j] = time.perf_counter()
        all_metrics.append(system.process_image(img,
                                                timestamp=(i + j) / 30.0))
        scan_retired()
    # drain the in-flight tail: the rate includes every frame's pose
    tracker._drain_pipe()
    scan_retired()
    dt = time.perf_counter() - t_all0
    tracker.finish()
    print("# stages:", json.dumps(GLOBAL_TIMER.summary()))

    tracked = sum(1 for r in traj[n_traj0:] if r.tracked)
    n_kf = tracker.slam_map.n_kf - n_kf0
    n_kf_events = sum(1 for m in all_metrics
                      if m.get("event") == "keyframe_inserted")
    fps = n_frames / dt
    lat_ms = (retire_t - submit_t) * 1e3
    lat_ms = lat_ms[~np.isnan(lat_ms)]
    lat = {
        "p50": round(float(np.percentile(lat_ms, 50)), 1),
        "p95": round(float(np.percentile(lat_ms, 95)), 1),
        "max": round(float(lat_ms.max()), 1),
    } if len(lat_ms) else {}
    print(f"# {n_frames} frames in {dt:.2f}s ({fps:.1f} fps, pipeline "
          f"drained), {tracked} tracked, {n_kf} net new keyframes "
          f"({n_kf_events} insertions), {tracker.slam_map.n_mp} map points")
    print(f"# pose latency ms (submit->retire): p50={lat.get('p50')} "
          f"p95={lat.get('p95')} max={lat.get('max')}")
    loop_verified = sum(("loop_with" in m.get("mapping", {}))
                        + ("loop_with" in m) for m in all_metrics)
    loop_closed = sum(bool(m.get("mapping", {}).get("loop_closed"))
                      + bool(m.get("loop_closed")) for m in all_metrics)
    lc_ms = GLOBAL_TIMER.summary().get("mapping/loopClosing", {})
    print(f"# mapping worker: local mapping and loop closing "
          f"(loopClosing {lc_ms.get('mean_ms')} ms per keyframe, host "
          f"clock); {loop_verified} keyframes with a verified loop, "
          f"{loop_closed} loops corrected")
    system.shutdown()
    if tracked < int(0.9 * n_frames):
        raise RuntimeError("tracking degraded during bench")
    if n_kf_events < 5:
        raise RuntimeError(
            f"bench window carried only {n_kf_events} keyframe insertions; "
            "the measurement would understate the mapping tax")

    print(json.dumps({
        "metric": "tracking_fps",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / 30.0, 2),
        "window_frames": n_frames,
        "keyframe_insertions": n_kf_events,
        "pose_latency_ms": lat,
        "place_recognition": True,
        "loop_closing": True,
        "loop_verified": loop_verified,
        "loop_closed": loop_closed,
        "card": card,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
