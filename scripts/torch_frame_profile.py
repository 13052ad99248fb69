#!/usr/bin/env python3
"""Where a tracked frame's time goes in the PyTorch/CUDA port, on one GPU.

    python3 scripts/torch_frame_profile.py [--frames 20] [--out DIR]

The world and configuration are chip_smoke.py's ``bench_world`` (the
bench's: 640x480, 8 levels, 1000 features, a 4-view ground-truth map in an
8192-point window of a 32768-point pool).  After a warm-up chain it
reports, for chained frame_step calls on the card:

  * wall ms per frame (host clock around frame_step + synchronize), and
    the same for extract_batched alone, so extraction and tracking split;
  * torch.profiler over the frames: device busy time per frame (the sum
    of CUDA kernel times; its complement over wall time is the idle
    share), kernel launches per frame, and the top operators by host time
    and by device time;
  * every operation that made the host wait for the card, by source line
    (torch's sync debug mode).

Prints the summary; with --out DIR also writes the full result to
DIR/torch_frame_profile.json.
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
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("torch_frame_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from orb_slam_tpu_torch import state as st
    from orb_slam_tpu_torch.device import resolve_device
    from orb_slam_tpu_torch.frontend.extractor_batched import extract_batched
    from orb_slam_tpu_torch.pipeline.frame_step import frame_step

    card = chip_smoke.gpu_line()
    print(f"# {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    dev = resolve_device("cuda")
    n = args.frames
    cam, kw, arrays, frames = chip_smoke.bench_world(dev, n)
    ext = kw["ext_cfg"]

    def run_chain():
        state = st.state_from_numpy(arrays, device=dev)
        torch.cuda.synchronize()
        ms = []
        for img in frames:
            t0 = time.perf_counter()
            out = frame_step(img, *state, cam, **kw, device=dev)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            state = st.chain(state, out)
        return ms

    def run_extract():
        ms = []
        for img in frames:
            t0 = time.perf_counter()
            extract_batched(img, ext, device=dev)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    run_chain()                                   # warm-up
    frame_ms = run_chain()
    extract_ms = run_extract()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_ms = run_chain()
    events = prof.key_averages()
    dev_attr = ("self_device_time_total"
                if hasattr(events[0], "self_device_time_total")
                else "self_cuda_time_total")
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")]
    busy_us = sum(getattr(e, "device_time_total", None)
                  or getattr(e, "cuda_time_total", 0) for e in kernels)
    # the same total from the averages: every kernel's time is the self
    # device time of exactly one entry
    busy_avg_us = sum(getattr(e, dev_attr) for e in events)
    top_host = sorted(events, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:20]
    top_dev = sorted(events, key=lambda e: getattr(e, dev_attr),
                     reverse=True)[:20]

    # operations that made the host wait, by the Python line that called
    syncs = collections.Counter()
    state = st.state_from_numpy(arrays, device=dev)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for img in frames:
            torch.cuda.set_sync_debug_mode("warn")
            out = frame_step(img, *state, cam, **kw, device=dev)
            torch.cuda.set_sync_debug_mode("default")
            state = st.chain(state, out)
    for w in caught:
        if "synchroniz" in str(w.message):
            syncs[f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"] += 1

    res = dict(
        device=card, frames=n,
        frame_ms_median=float(np.median(frame_ms)),
        frame_ms=frame_ms, extract_ms_median=float(np.median(extract_ms)),
        profiled_frame_ms_median=float(np.median(prof_ms)),
        device_busy_ms_per_frame=busy_us / 1e3 / n,
        device_busy_ms_per_frame_from_averages=busy_avg_us / 1e3 / n,
        kernel_launches_per_frame=len(kernels) / n,
        idle_share=1.0 - (busy_us / 1e3) / sum(prof_ms),
        host_syncs_per_frame=sum(syncs.values()) / n,
        host_sync_sites={k: v / n for k, v in syncs.most_common()},
        top_host_ops=[dict(name=e.key, count_per_frame=e.count / n,
                           self_host_ms_per_frame=e.self_cpu_time_total
                           / 1e3 / n) for e in top_host],
        top_device_ops=[dict(name=e.key, count_per_frame=e.count / n,
                             self_device_ms_per_frame=getattr(e, dev_attr)
                             / 1e3 / n) for e in top_dev])
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "torch_frame_profile.json"),
                  "w") as f:
            json.dump(res, f, indent=1)
    print(events.table(sort_by="self_cpu_time_total", row_limit=25))
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("frame_ms", "top_host_ops",
                                   "top_device_ops")}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
