"""Patch gathering, the intensity-centroid orientation and the 7x7
Gaussian blur (port of ``orb_slam_tpu.ops.patches``).

Replaces the reference's IC_Angle (src/ORBextractor.cc:124-151) and its
7x7 sigma=2 blur (src/ORBextractor.cc:760).  ``ic_angle`` serves the
per-level extractor (``frontend/extractor.py``); the batched extractor
takes its moments from kernel 2 (``ops/describe_cuda.py``), which uses the
same mask.
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
def _ic_weights(device: torch.device):
    """(mask * dx, mask * dy) as [31, 31] float64 on `device`."""
    m = torch.from_numpy(_IC_MASK).to(device, torch.float64)
    dx = torch.from_numpy(_IC_DX).to(device, torch.float64)
    return m * dx[None, :], m * dx[:, None]


def gather_patches(img: torch.Tensor, xy: torch.Tensor,
                   size: int) -> torch.Tensor:
    """size x size patches of img [H, W] centred at the integer-rounded
    xy [N, 2] (x, y); taps outside the image clamp to the border.
    Returns [N, size, size]."""
    h, w = img.shape
    r = size // 2
    cx = torch.round(xy[:, 0]).long()
    cy = torch.round(xy[:, 1]).long()
    d = torch.arange(-r, r + 1, device=img.device)
    ys = torch.clamp(cy[:, None] + d[None, :], 0, h - 1)    # [N, size]
    xs = torch.clamp(cx[:, None] + d[None, :], 0, w - 1)
    return img[ys[:, :, None], xs[:, None, :]]


def ic_angle(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation [N] (radians) of the keypoints xy
    [N, 2] on img [H, W]: atan2(m01, m10) in float32, with m10 = sum x*I
    and m01 = sum y*I over the radius-15 circle of the clamped 31x31
    patch.  The moments are summed in float64: where the patch's nonzero
    values are at least 2^-7 in magnitude (below 2^9), every product is
    a multiple of 2^-30 below 2^13 and the sum is exact in any order, so
    the result does not depend on the device.  On integer images it
    equals the float32 sums (|m| < 2^24)."""
    pat = gather_patches(img, xy, 2 * HALF_PATCH + 1).double()
    w10, w01 = _ic_weights(img.device)
    m10 = torch.sum(pat * w10, dim=(1, 2)).float()
    m01 = torch.sum(pat * w01, dim=(1, 2)).float()
    return torch.atan2(m01, m10)


@lru_cache(maxsize=None)
def gaussian_taps_on(device: torch.device) -> torch.Tensor:
    """gaussian_taps as a float32 tensor on `device`, uploaded once."""
    return torch.from_numpy(gaussian_taps()).to(device)


def gaussian_taps() -> np.ndarray:
    """The 7 float32 taps of the separable sigma-2 Gaussian (sum 1)."""
    d = np.arange(-3, 4, dtype=np.float32)
    k = np.exp(-0.5 * (d / _SIGMA) ** 2)
    return k / k.sum()


def gaussian_blur7_fused(img: torch.Tensor) -> torch.Tensor:
    """The 7x7 Gaussian of img [H, W] (reflect-101) as the JAX package's
    compiled per-level extractor evaluates it: XLA's CPU fusion contracts
    each pass into a chain of fused multiply-adds, acc = fma(k0, t0,
    k1*t1), then acc = fma(ki, ti, acc) for i = 2..6.  Each fma is taken
    exactly in float64 (the product of two float32 is exact there) and
    rounded to float32, on any device.

    On flat image regions many BRIEF pairs compare taps that are equal in
    exact arithmetic, so the last bit of the blur decides them: this order
    keeps the per-level descriptors equal to the JAX package's."""
    k = gaussian_taps_on(img.device).double()
    h, w = img.shape
    p = F.pad(img[None, None], (3, 3, 3, 3), mode="reflect")[0, 0]

    def chain(taps):
        acc = (k[0] * taps[0].double()
               + (k[1].float() * taps[1]).double()).float()
        for i in range(2, 7):
            acc = (k[i] * taps[i].double() + acc.double()).float()
        return acc
    rows = chain([p[i:i + h, :] for i in range(7)])
    return chain([rows[:, i:i + w] for i in range(7)])


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
