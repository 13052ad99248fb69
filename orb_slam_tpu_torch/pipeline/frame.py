"""Per-frame record: extractor output + undistorted coordinates + per-level
information weights (port of ``orb_slam_tpu.pipeline.frame``; the Frame of
src/Frame.cc minus the lookup grid — radius queries are dense masked
scans)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import ExtractorConfig
from ..frontend.extractor import FrameFeatures
from ..geometry import camera as cam_mod
from .frame_step import _sigma2


class FrameData(NamedTuple):
    feats: FrameFeatures
    xy_und: torch.Tensor      # [N, 2] undistorted keypoint coords
    inv_sigma2: torch.Tensor  # [N] 1 / sigma^2(level)
    sigma2: torch.Tensor      # [N]


def build_frame(feats: FrameFeatures, cam: cam_mod.CameraParams,
                ext_cfg: ExtractorConfig) -> FrameData:
    xy_und = cam_mod.undistort_pixels(feats.xy, cam)
    s2 = _sigma2(ext_cfg, feats.xy.device)[
        torch.clamp(feats.level, 0, ext_cfg.n_levels - 1)]
    return FrameData(feats=feats, xy_und=xy_und, inv_sigma2=1.0 / s2,
                     sigma2=s2)
