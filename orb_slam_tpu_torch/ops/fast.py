"""FAST-9 corner score, 3x3 NMS and Harris response as batched tensor ops
(port of ``orb_slam_tpu.ops.fast``).

Every function takes [..., H, W] and treats the leading dims as a batch, so
the whole pyramid stack goes through in one call.  The ``roll`` wrap and
the 3-px border mask, the -inf fill at the canvas edges in the NMS and its
asymmetric tie rule are kept as in the JAX package: these functions are the
plain version that the FAST kernel (``ops/fast_cuda.py``) is held against.
"""
from __future__ import annotations

import torch

# OpenCV's 16-point Bresenham circle of radius 3, clockwise from 12 o'clock,
# as (dx, dy) offsets.
CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
ARC_LEN = 9  # FAST-9


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = a[y + dy, x + dx] with wrap-around (jnp.roll by -d)."""
    return torch.roll(a, shifts=(-dy, -dx), dims=(-2, -1))


def _interior(h: int, w: int, b: int, device) -> torch.Tensor:
    row = torch.arange(h, device=device)[:, None]
    col = torch.arange(w, device=device)[None, :]
    return (row >= b) & (row < h - b) & (col >= b) & (col < w - b)


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-9 score map of img [..., H, W] float32.

    0 where the segment test fails at `threshold`, otherwise the largest
    t' >= threshold at which it still passes (max over the 16 arcs of the
    min arc-pixel margin), as OpenCV's FAST score.  The 3-px border, where
    the roll wraps, scores 0."""
    diffs = torch.stack([_shift(img, dy, dx) - img for dx, dy in CIRCLE],
                        dim=0)                           # [16, ..., H, W]

    def arc_scores(margin):
        # circular window-9 min over the 16 starts, by log-step doubling
        m = margin
        m = torch.minimum(m, torch.roll(m, -1, dims=0))   # window 2
        m = torch.minimum(m, torch.roll(m, -2, dims=0))   # window 4
        m = torch.minimum(m, torch.roll(m, -4, dims=0))   # window 8
        m = torch.minimum(m, torch.roll(margin, -8, dims=0))  # window 9
        return torch.amax(m, dim=0)

    score = torch.maximum(arc_scores(diffs), arc_scores(-diffs))
    score = torch.where(score > threshold, score, torch.zeros_like(score))
    h, w = img.shape[-2:]
    return torch.where(_interior(h, w, 3, img.device), score,
                       torch.zeros_like(score))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression of score [..., H, W]: strict `>` against
    the earlier raster neighbours, `>=` against the later ones; neighbours
    outside the canvas count as -inf."""
    h, w = score.shape[-2:]
    row = torch.arange(h, device=score.device)[:, None]
    col = torch.arange(w, device=score.device)[None, :]
    neg = torch.full_like(score, float("-inf"))
    is_max = torch.ones_like(score, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            valid = ((row + dy >= 0) & (row + dy < h)
                     & (col + dx >= 0) & (col + dx < w))
            n = torch.where(valid, _shift(score, dy, dx), neg)
            if (dy, dx) < (0, 0):
                is_max = is_max & (score > n)
            else:
                is_max = is_max & (score >= n)
    return torch.where(is_max, score, torch.zeros_like(score))


_HARRIS_K = 0.04
_HARRIS_BLOCK = 7


def harris_score(img: torch.Tensor) -> torch.Tensor:
    """Harris corner response (ORBextractor.cc:79-120, nScoreType=0): Sobel
    gradients and a 7 x 7 box-summed structure tensor, k = 0.04."""
    def s(a, dy, dx):
        return _shift(a, dy, dx)

    gx = ((s(img, -1, 1) + 2 * s(img, 0, 1) + s(img, 1, 1))
          - (s(img, -1, -1) + 2 * s(img, 0, -1) + s(img, 1, -1))) * 0.125
    gy = ((s(img, 1, -1) + 2 * s(img, 1, 0) + s(img, 1, 1))
          - (s(img, -1, -1) + 2 * s(img, -1, 0) + s(img, -1, 1))) * 0.125
    ixx, iyy, ixy = gx * gx, gy * gy, gx * gy

    def box(a):
        r = _HARRIS_BLOCK // 2
        out = torch.zeros_like(a)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                out = out + s(a, dy, dx)
        return out

    sxx, syy, sxy = box(ixx), box(iyy), box(ixy)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - _HARRIS_K * tr * tr
