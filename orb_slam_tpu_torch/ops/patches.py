"""Intensity-centroid mask and the 7x7 Gaussian blur (port of
``orb_slam_tpu.ops.patches``).

Replaces the reference's IC_Angle mask (src/ORBextractor.cc:124-151) and
its 7x7 sigma=2 blur (src/ORBextractor.cc:760).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

HALF_PATCH = 15  # reference HALF_PATCH_SIZE (ORBextractor.cc:52)


def _circular_mask(radius: int) -> np.ndarray:
    d = np.arange(-radius, radius + 1)
    yy, xx = np.meshgrid(d, d, indexing="ij")
    return (xx * xx + yy * yy <= radius * radius).astype(np.float32)


_IC_MASK = _circular_mask(HALF_PATCH)          # [31, 31]
_IC_DX = np.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=np.float32)
_SIGMA = 2.0     # the reference's blur sigma (ORBextractor.cc:760)


@lru_cache(maxsize=None)
def gaussian_taps_on(device: torch.device) -> torch.Tensor:
    """gaussian_taps as a float32 tensor on `device`, uploaded once."""
    return torch.from_numpy(gaussian_taps()).to(device)


def gaussian_taps() -> np.ndarray:
    """The 7 float32 taps of the separable sigma-2 Gaussian (sum 1)."""
    d = np.arange(-3, 4, dtype=np.float32)
    k = np.exp(-0.5 * (d / _SIGMA) ** 2)
    return k / k.sum()


def gaussian_blur7(img: torch.Tensor) -> torch.Tensor:
    """Separable 7x7 Gaussian of img [..., H, W] with reflect-101 borders
    (cv::GaussianBlur(..., Size(7,7), 2, 2, BORDER_REFLECT_101)).

    Vertical pass first, then horizontal, each a left-to-right sum of the 7
    taps — the order the blur kernel (``csrc/fast_nms_blur.cu``) uses, so
    the two agree to the last bit."""
    k = gaussian_taps_on(img.device)
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    # F.pad's "reflect" mode is reflect-101 (the edge pixel is not repeated)
    p = F.pad(img.reshape((-1, 1, h, w)), (3, 3, 3, 3),
              mode="reflect").reshape(lead + (h + 6, w + 6))
    rows = k[0] * p[..., 0:h, :]
    for i in range(1, 7):
        rows = rows + k[i] * p[..., i:i + h, :]
    out = k[0] * rows[..., :, 0:w]
    for i in range(1, 7):
        out = out + k[i] * rows[..., :, i:i + w]
    return out
