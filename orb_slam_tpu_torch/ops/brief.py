"""Steered-BRIEF 256-bit descriptors, batched over keypoints (port of
``orb_slam_tpu.ops.brief``).

Replaces computeOrbDescriptor (src/ORBextractor.cc:155-194): every
keypoint samples all 512 pattern points in one gather, compares the 256
pairs and packs the bits.  ``brief_descriptors`` serves the per-level
extractor (``frontend/extractor.py``), which steers by the IC angle; the
batched extractor describes in kernel 2 (``ops/describe_cuda.py``), which
steers by m10/|m|.

The 256-pair pattern is the public ORB constant (bit_pattern_31, reproduced
at ORBextractor.cc:197-455).  The port keeps its own copy,
``data/brief_pattern.npy`` (int32 [256, 4] = x1, y1, x2, y2 per pair);
``tests/test_torch_config.py`` holds it equal to the JAX package's file.
Descriptors are 8 32-bit words per keypoint, bit b of word w holding pair
32w+b, stored as int32 (bit-identical to the JAX package's uint32).
"""
from __future__ import annotations

import os

from functools import lru_cache

import numpy as np
import torch

_PATTERN_PATH = os.path.join(os.path.dirname(__file__), "..", "data",
                             "brief_pattern.npy")
_PATTERN = np.load(os.path.abspath(_PATTERN_PATH)).astype(np.float32)
# sample points: [512, 2] alternating (x1,y1),(x2,y2) per pair
_POINTS = _PATTERN.reshape(256, 2, 2).reshape(512, 2)


@lru_cache(maxsize=None)
def _points_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_POINTS).to(device)


@lru_cache(maxsize=None)
def _bit_weights(device: torch.device) -> torch.Tensor:
    return torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=device),
        torch.arange(32, device=device))


def brief_descriptors(img: torch.Tensor, xy: torch.Tensor,
                      angle: torch.Tensor) -> torch.Tensor:
    """Descriptors [N, 8] int32 of the keypoints xy [N, 2] at `angle` [N]
    (radians) on the blurred level image img [H, W].

    The pattern is steered by cos/sin of the angle, rounded half to even
    (as jnp.round; the reference's cvRound), clamped to the image, and
    pair j sets bit j % 32 of word j // 32."""
    h, w = img.shape
    ca = torch.cos(angle)[:, None]                      # [N, 1]
    sa = torch.sin(angle)[:, None]
    pts = _points_on(img.device)
    px = pts[None, :, 0]                                # [1, 512]
    py = pts[None, :, 1]
    sx = torch.round(px * ca - py * sa + xy[:, 0:1])
    sy = torch.round(px * sa + py * ca + xy[:, 1:2])
    xi = torch.clamp(sx.long(), 0, w - 1)
    yi = torch.clamp(sy.long(), 0, h - 1)
    samples = img[yi, xi]                               # [N, 512]
    bits = (samples[:, 0::2] < samples[:, 1::2]).to(torch.int64)
    words = torch.sum(bits.reshape(-1, 8, 32) * _bit_weights(img.device),
                      dim=-1)
    # uint32 words viewed as int32: subtract 2^32 above 2^31 - 1
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)
