"""Dataset readers (port of ``orb_slam_tpu.dataio.datasets``): TUM RGB-D
(monocular stream) and KITTI odometry.

They replace the reference's ROS image topic (/vio_ros/raw_image,
src/Tracking.cc:165) with host-side iteration over a recorded sequence.
Frames are float32 grey [H, W] in [0, 255], the extractor's input, decoded
by the port's own PNG reader (``png.py``, equal to the bit to PIL's
``convert("L")``, which the JAX package uses).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .png import decode_gray


def load_gray(path: str) -> np.ndarray:
    """float32 [H, W] grey of a PNG frame."""
    return decode_gray(path)


@dataclass
class TumSequence:
    """TUM RGB-D monocular stream: reads rgb.txt (timestamp path per line)."""

    root: str
    timestamps: List[float]
    paths: List[str]

    @staticmethod
    def open(root: str) -> "TumSequence":
        ts, paths = [], []
        with open(os.path.join(root, "rgb.txt")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                a, b = line.split()[:2]
                ts.append(float(a))
                paths.append(os.path.join(root, b))
        return TumSequence(root=root, timestamps=ts, paths=paths)

    def __len__(self):
        return len(self.paths)

    def frames(self) -> Iterator[Tuple[float, np.ndarray]]:
        for t, p in zip(self.timestamps, self.paths):
            yield t, load_gray(p)

    def groundtruth(self) -> Optional[np.ndarray]:
        """[N, 8] ts,tx,ty,tz,qx,qy,qz,qw if groundtruth.txt exists."""
        gt = os.path.join(self.root, "groundtruth.txt")
        if not os.path.exists(gt):
            return None
        rows = []
        with open(gt) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                rows.append([float(x) for x in line.split()[:8]])
        return np.asarray(rows)


@dataclass
class KittiSequence:
    """KITTI odometry grey sequence (image_0/ + times.txt)."""

    root: str
    timestamps: List[float]
    paths: List[str]

    @staticmethod
    def open(root: str) -> "KittiSequence":
        img_dir = os.path.join(root, "image_0")
        names = sorted(os.listdir(img_dir))
        times_path = os.path.join(root, "times.txt")
        if os.path.exists(times_path):
            with open(times_path) as f:
                ts = [float(x) for x in f.read().split()]
        else:
            ts = [i / 10.0 for i in range(len(names))]
        return KittiSequence(
            root=root, timestamps=ts[: len(names)],
            paths=[os.path.join(img_dir, n) for n in names])

    def __len__(self):
        return len(self.paths)

    def frames(self) -> Iterator[Tuple[float, np.ndarray]]:
        for t, p in zip(self.timestamps, self.paths):
            yield t, load_gray(p)

    def groundtruth_poses(self) -> Optional[np.ndarray]:
        """KITTI pose file ([N, 3, 4] cam-to-world) if poses.txt exists."""
        p = os.path.join(self.root, "poses.txt")
        if not os.path.exists(p):
            return None
        rows = np.loadtxt(p)
        return rows.reshape(-1, 3, 4)
