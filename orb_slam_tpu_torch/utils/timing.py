"""Per-stage wall-clock instrumentation (port of
``orb_slam_tpu.utils.timing``: host clocks, the same stage names).

Keeps the worxli fork's stage taxonomy (`[time] <thread> run <stage>` lines,
SURVEY.md §5.1: src/Tracking.cc:208,323; src/LocalMapping.cc:65-99;
src/LoopClosing.cc:77-559) so numbers are comparable, and adds aggregate
statistics.  Enable printing with ORB_SLAM_TPU_TIME=1 or `StageTimer(echo=True)`.
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Dict


class StageTimer:
    def __init__(self, echo: bool | None = None, sync=None):
        self.echo = (os.environ.get("ORB_SLAM_TPU_TIME") == "1"
                     if echo is None else echo)
        # called before each stage's clock is read at its end (e.g.
        # torch.cuda.synchronize), so a stage's time includes the device
        # work it queued; None = host time only, as in the JAX package
        self.sync = sync
        # optional context-manager factory opened around each stage with
        # its "group/name" key (e.g. torch.profiler.record_function, so a
        # profile attributes device time to stages); None = no range
        self.range = None
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextmanager
    def stage(self, group: str, name: str):
        key = f"{group}/{name}"
        rng = self.range(key) if self.range is not None else nullcontext()
        t0 = time.perf_counter()
        try:
            with rng:
                yield
        finally:
            if self.sync is not None:
                self.sync()
            dt = time.perf_counter() - t0
            self.totals[key] += dt
            self.counts[key] += 1
            if self.echo:
                print(f"[time] {group} run {name} {time.time():.6f} {dt:.6f}")

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()

    def summary(self) -> Dict[str, dict]:
        return {
            k: {
                "total_s": round(self.totals[k], 4),
                "count": self.counts[k],
                "mean_ms": round(1e3 * self.totals[k] / max(self.counts[k], 1), 3),
            }
            for k in sorted(self.totals)
        }


GLOBAL_TIMER = StageTimer()
