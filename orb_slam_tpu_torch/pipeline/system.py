"""System wrapper (port of ``orb_slam_tpu.pipeline.system``): the entry
point a user calls — frames in, a map and a trajectory out.

    system = System.create(cfg)              # on the card (device="cpu" for
    for ts, image in frames:                 #   the plain PyTorch path)
        system.process_image(image, ts)
    system.shutdown()
    system.save_trajectory("KeyFrameTrajectory.txt")

The CLI and the dataset readers wait for data in the repository;
checkpoint save/resume waits for relocalisation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..config import SystemConfig
from ..dataio import trajectory as traj_mod
from ..utils.timing import StageTimer
from .tracker import Tracker


@dataclass
class System:
    """End-to-end SLAM system: extractor + tracker + synchronous mapper."""

    cfg: SystemConfig
    tracker: Tracker = None
    timer: StageTimer = field(default_factory=StageTimer)

    @staticmethod
    def create(cfg: SystemConfig, device=None) -> "System":
        return System(cfg=cfg, tracker=Tracker.create(cfg, device=device))

    def process_image(self, image, timestamp: float) -> dict:
        """image: [H, W] grayscale or [H, W, 3] colour in [0, 255].  Colour
        frames are converted on the host with BT.601 luma weights in the
        channel order of Camera.RGB (src/Tracking.cc:141-152)."""
        if getattr(image, "ndim", 2) == 3:
            w = np.asarray([0.299, 0.587, 0.114], np.float32)
            if not self.cfg.camera.rgb:
                w = w[::-1]                     # channels arrive as BGR
            image = np.asarray(image, np.float32) @ w
        with self.timer.stage("tracking", "grabImage"):
            return self.tracker.process_image(image, timestamp)

    def save_trajectory(self, path: str):
        traj_mod.save_tum(path, self.tracker.keyframe_trajectory())

    def shutdown(self):
        """Retire in-flight frames (System::Shutdown)."""
        self.tracker.shutdown()

    def evaluate_ate(self, gt: np.ndarray) -> Optional[float]:
        """gt: [N, 8] TUM rows.  Associates keyframes by timestamp."""
        rows = self.tracker.keyframe_trajectory()
        if len(rows) < 3:
            return None
        est_ts = np.asarray([r[0] for r in rows])
        est_p = np.asarray([r[1] for r in rows])
        ia, ib = traj_mod.associate_by_time(est_ts, gt[:, 0])
        if len(ia) < 3:
            return None
        return traj_mod.ate_rmse(est_p[ia], gt[ib][:, 1:4], with_scale=True)
