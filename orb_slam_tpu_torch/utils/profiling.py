"""Device-trace capture on ``torch.profiler`` (port of
``orb_slam_tpu.utils.profiling``, the same names).

StageTimer gives host wall-clock per stage; this records per-kernel DEVICE
time, the honest number where the host's launches and the card's work
overlap.  On ``cuda`` the trace holds CUDA activity and ``top_ops`` sums
the kernels' (and device copies') time; on an explicit ``device="cpu"`` it
records CPU activity only and sums the operators.

Usage:
    from orb_slam_tpu_torch.utils.profiling import device_trace, top_ops
    with device_trace("traces/slam"):
        for img in frames:
            system.process_image(img, ts)
    for dur_ms, name in top_ops("traces/slam")[:15]:
        print(f"{dur_ms:8.2f} ms  {name}")
"""
from __future__ import annotations

import collections
import glob
import json
import os
import time
from contextlib import contextmanager
from typing import List, Tuple

import torch

from ..device import resolve_device

# Chrome-trace categories of work that ran on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextmanager
def device_trace(log_dir: str, device=None):
    """Record what runs inside the block and write it to
    ``log_dir/trace-<ns>.json`` (Chrome trace format).  ``device`` defaults
    to the card, as every entry point of the port, and raises without
    one."""
    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace-{time.time_ns()}.json"))


def top_ops(log_dir: str) -> List[Tuple[float, str]]:
    """Summed duration (ms) per trace event name, descending, from the most
    recent trace under log_dir: the device's kernels and copies where the
    trace holds any, else the operators (a CPU trace)."""
    paths = sorted(glob.glob(os.path.join(log_dir, "trace-*.json")))
    if not paths:
        raise FileNotFoundError(f"no trace under {log_dir}")
    with open(paths[-1]) as f:
        # complete events, less the profiler's own span over the block
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e
                  and e.get("cat") != "Trace"]
    on_device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    tot: collections.Counter = collections.Counter()
    for e in on_device or events:
        tot[e.get("name", "")] += float(e["dur"])
    return sorted(((d / 1e3, n) for n, d in tot.items()), reverse=True)
