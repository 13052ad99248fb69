#!/usr/bin/env python3
"""Where the System path's time goes in the PyTorch/CUDA port, on one GPU.

    python3 scripts/torch_system_profile.py [--frames 30] [--skip 10]
                                            [--out DIR]

Runs ``System.process_image`` at chip_smoke.py's slice configuration (the
bench's 640x480, 8 levels, 1000 features, default MapConfig, synchronous
mapping) over the bench sweep from frame 0, twice:

  1. the first --frames frames under torch's sync debug mode: every
     operation that made the host wait for the card, by source line, per
     WORKING frame and per keyframe frame;
  2. frames --skip .. --frames under torch.profiler, each StageTimer stage
     and each frame annotated: per stage, host ms (inclusive, with the
     stage's device work synchronized) against its own device busy ms (the
     summed times of the kernels launched inside it and not inside a
     nested stage) per call; per frame class (WORKING, keyframe), wall ms
     and device busy ms; the device's idle share over the profiled wall
     time.

Prints the summary; with --out DIR also writes it to
DIR/torch_system_profile.json.
"""
import argparse
import collections
import json
import os
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--skip", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    if not torch.cuda.is_available():
        print("torch_system_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import smoke_world as syn
    from orb_slam_tpu_torch.device import resolve_device
    from orb_slam_tpu_torch.pipeline.system import System
    from orb_slam_tpu_torch.utils.timing import GLOBAL_TIMER

    card = chip_smoke.gpu_line()
    print(f"# {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    dev = resolve_device("cuda")
    cfg = chip_smoke.system_config()
    renderer = syn.SceneRenderer(np.random.default_rng(chip_smoke.SEED),
                                 cfg.camera.K)
    frames = [renderer.render(*syn.pose_at(i)) for i in range(args.frames)]

    def kind(m):
        if m.get("event") == "keyframe_inserted":
            return "keyframe"
        if m["state"] == "WORKING" and not m.get("event"):
            return "working"
        return "init"

    # 1. host syncs by source line
    system = System.create(cfg, device=dev)
    sites = {"working": collections.Counter(),
             "keyframe": collections.Counter(), "init": collections.Counter()}
    n_kind = collections.Counter()
    for i, img in enumerate(frames):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            m = system.process_image(img, i / 30.0)
            torch.cuda.set_sync_debug_mode("default")
        k = kind(m)
        n_kind[k] += 1
        for w in caught:
            if "synchroniz" in str(w.message):
                sites[k][f"{os.path.relpath(w.filename, ROOT)}:"
                         f"{w.lineno}"] += 1
    torch.cuda.synchronize()

    # 2. the profile, after --skip unprofiled frames of a fresh system
    system = System.create(cfg, device=dev)
    for i, img in enumerate(frames[:args.skip]):
        system.process_image(img, i / 30.0)
    torch.cuda.synchronize()
    GLOBAL_TIMER.reset()
    GLOBAL_TIMER.range = record_function
    GLOBAL_TIMER.sync = torch.cuda.synchronize
    kinds, walls = [], []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(args.skip, args.frames):
            t0 = time.perf_counter()
            with record_function(f"frame/{i}"):
                m = system.process_image(frames[i], i / 30.0)
                torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            kinds.append(kind(m))
    GLOBAL_TIMER.range = None
    GLOBAL_TIMER.sync = None

    # device busy time, attributed to the innermost stage and to the frame
    # whose range launched each kernel (walking up from the launching op)
    stage_keys = set(GLOBAL_TIMER.counts)
    busy_stage, busy_frame = collections.Counter(), collections.Counter()
    busy_us, n_kernels = 0.0, 0
    for e in prof.events():
        ks = getattr(e, "kernels", None) or []
        if not ks:
            continue
        us = sum(k.duration for k in ks)
        busy_us += us
        n_kernels += len(ks)
        stage = frame = None
        q = e
        while q is not None and (stage is None or frame is None):
            if stage is None and q.name in stage_keys:
                stage = q.name
            if frame is None and q.name.startswith("frame/"):
                frame = q.name
            q = q.cpu_parent
        busy_stage[stage or "(no stage)"] += us
        busy_frame[frame] += us
    busy_ms = busy_us / 1e3

    per_kind = {}
    for k in ("working", "keyframe", "init"):
        idx = [j for j, kk in enumerate(kinds) if kk == k]
        if not idx:
            continue
        dev_ms = [busy_frame[f"frame/{args.skip + j}"] / 1e3 for j in idx]
        per_kind[k] = dict(
            frames=len(idx), wall_ms_median=float(np.median(
                [walls[j] for j in idx])),
            device_busy_ms_median=float(np.median(dev_ms)),
            host_syncs_per_frame=sum(sites[k].values()) / max(n_kind[k], 1))
    # stages nest (trackFused holds dispatchFrameStep and the mapping
    # stages): host ms are inclusive, device ms are the stage's own
    stages = {}
    for key, n in GLOBAL_TIMER.counts.items():
        stages[key] = dict(
            calls=n, host_ms_per_call=GLOBAL_TIMER.totals[key] * 1e3 / n,
            own_device_busy_ms_per_call=busy_stage[key] / 1e3 / n)
    res = dict(
        device=card, frames=args.frames, profiled=args.frames - args.skip,
        profiled_wall_ms=sum(walls), device_busy_ms=busy_ms,
        idle_share=1.0 - busy_ms / sum(walls),
        kernel_launches=n_kernels, per_frame_kind=per_kind,
        stages=stages,
        host_sync_sites={k: {s: c / max(n_kind[k], 1)
                             for s, c in v.most_common()}
                         for k, v in sites.items()})
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "torch_system_profile.json"),
                  "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
