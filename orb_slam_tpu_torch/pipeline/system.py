"""System wrapper and CLI (port of ``orb_slam_tpu.pipeline.system``): the
entry points a user calls, the equivalent of the reference's ROS node
(src/main.cc).

    system = System.create(cfg)              # on the card (device="cpu" for
    for ts, image in frames:                 #   the plain PyTorch path)
        system.process_image(image, ts)
    system.shutdown()
    system.save_trajectory("KeyFrameTrajectory.txt")

``save_checkpoint`` writes the whole map; ``resume_checkpoint`` loads one
into a fresh System, which relocalizes into it and tracks on.  The CLI
reads a TUM or KITTI sequence from disk, tracks every frame, writes the
TUM-format keyframe trajectory, optionally a map picture (``--viz``, which
needs matplotlib), and reports ATE against the ground truth:

    python -m orb_slam_tpu_torch.pipeline.system --dataset tum \
        --root <seq_dir> --calib fr1 --out-dir results/

It runs on the card; from Python, ``main(argv, device="cpu")`` runs the
plain PyTorch path.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..config import SystemConfig, tum_freiburg1_config, tum_freiburg2_config
from ..dataio import trajectory as traj_mod
from ..dataio.datasets import KittiSequence, TumSequence
from ..mapping import checkpoint as ckpt
from ..utils.timing import StageTimer
from .tracker import Tracker


@dataclass
class System:
    """End-to-end SLAM system: extractor + tracker (with BoW
    relocalisation) + local mapper and place recognition (on the tracking
    thread, or on a worker with ``async_mapping``)."""

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
        """Retire in-flight frames, commit in-flight mapping work and join
        the mapping worker (System::Shutdown)."""
        self.tracker.shutdown()

    def save_checkpoint(self, path: str):
        """Flush mapping, then write the whole map (the reference keeps
        nothing but the final trajectory)."""
        self.tracker.finish()
        ckpt.save_map(path, self.tracker.slam_map)

    def resume_checkpoint(self, path: str):
        """Load a saved map onto the tracker's device and re-enter tracking
        LOST: the next frames relocalize into the loaded map and tracking
        continues."""
        smap = ckpt.load_map(path, self.tracker.cfg.map,
                             device=self.tracker.device)
        self.tracker.adopt_map(smap)

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


def main(argv=None, device=None) -> System:
    """The CLI on `argv` (sys.argv when None), on `device` (the card unless
    the caller names another).  Returns the shut-down System."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", choices=["tum", "kitti"], required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--calib", default="fr1", choices=["fr1", "fr2"])
    ap.add_argument("--out-dir", default="results")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--viz", action="store_true")
    args = ap.parse_args(argv)

    cfg = tum_freiburg1_config() if args.calib == "fr1" \
        else tum_freiburg2_config()
    system = System.create(cfg, device=device)

    seq = (TumSequence.open(args.root) if args.dataset == "tum"
           else KittiSequence.open(args.root))
    os.makedirs(args.out_dir, exist_ok=True)

    t_start = time.perf_counter()
    n = 0
    for ts, img in seq.frames():
        m = system.process_image(img, ts)
        n += 1
        if m.get("event"):
            print(f"frame {n}: {m['event']} (kf={m['n_keyframes']}, "
                  f"mp={m['n_map_points']})")
        if args.max_frames and n >= args.max_frames:
            break
    wall = time.perf_counter() - t_start
    system.shutdown()

    out_traj = os.path.join(args.out_dir, "KeyFrameTrajectory.txt")
    system.save_trajectory(out_traj)
    print(f"tracked {n} frames in {wall:.1f}s ({n / wall:.1f} fps)")
    print(f"trajectory -> {out_traj}")
    print(json.dumps(system.timer.summary(), indent=1))

    if args.dataset == "tum":
        gt = seq.groundtruth()
        if gt is not None:
            ate = system.evaluate_ate(gt)
            print(f"ATE RMSE (Sim3-aligned): {ate:.4f} m" if ate else
                  "ATE: not enough keyframes/associations")

    if args.viz:
        from ..utils.viz import export_map_png
        export_map_png(os.path.join(args.out_dir, "map.png"),
                       system.tracker.slam_map, system.tracker.trajectory)
    return system


if __name__ == "__main__":
    main()
