"""ORB feature record and the static pyramid layout (port of the parts of
``orb_slam_tpu.frontend.extractor`` that the batched extractor uses).

Keypoint coordinates are level-0 pixels (x * 1.2^level) with the level kept
for scale-aware matching, like the reference's cv::KeyPoint.octave; the
per-level results live in fixed-size slots with a validity mask.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import ExtractorConfig


class FrameFeatures(NamedTuple):
    """Fixed-capacity ORB features for one frame (SoA)."""

    xy: torch.Tensor        # [N, 2] float32, level-0 (raw/distorted) pixels
    response: torch.Tensor  # [N] float32
    angle: torch.Tensor     # [N] float32 radians
    level: torch.Tensor     # [N] int64 pyramid level
    desc: torch.Tensor      # [N, 8] int32 packed 256-bit descriptors
    valid: torch.Tensor     # [N] bool

    @property
    def n(self) -> int:
        return self.xy.shape[0]


def level_shapes(cfg: ExtractorConfig, height: int,
                 width: int) -> Tuple[Tuple[int, int], ...]:
    """Static per-level image shapes, mirroring ComputePyramid's rounding."""
    shapes = []
    for lv in range(cfg.n_levels):
        s = 1.0 / (cfg.scale_factor ** lv)
        shapes.append((int(round(height * s)), int(round(width * s))))
    return tuple(shapes)


def level_quotas(cfg: ExtractorConfig, n_features: int) -> Tuple[int, ...]:
    """Geometric per-level feature quotas (ORBextractor ctor :457-511)."""
    inv = 1.0 / cfg.scale_factor
    total = (1.0 - inv ** cfg.n_levels) / (1.0 - inv)
    base = n_features / total
    quotas = [int(round(base * inv ** lv)) for lv in range(cfg.n_levels - 1)]
    quotas.append(max(n_features - sum(quotas), 0))
    return tuple(quotas)
