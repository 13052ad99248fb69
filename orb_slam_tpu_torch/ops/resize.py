"""Separable antialiased bilinear resize as two matrix products (port of
``orb_slam_tpu.ops.resize``).

The interpolation weights replicate jax.image.resize's triangle kernel with
antialiasing, so the port builds the same pyramid as the JAX package.
Replaces the role of cv::resize in the reference pyramid
(src/ORBextractor.cc:781-822).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import true_fp32


@lru_cache(maxsize=None)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] separable interpolation weights (triangle kernel, widened
    by the downscale factor — antialiased bilinear)."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    w = np.where((sample_f[None, :] >= -0.5)
                 & (sample_f[None, :] <= in_size - 0.5), w, 0.0)
    return np.ascontiguousarray(w.T.astype(np.float32))


def resize_bilinear(image: torch.Tensor, out_h: int,
                    out_w: int) -> torch.Tensor:
    """[H, W] -> [out_h, out_w], antialiased bilinear via two matmuls in
    true float32."""
    in_h, in_w = image.shape
    ay = torch.from_numpy(resize_matrix(in_h, out_h)).to(image.device)
    ax = torch.from_numpy(resize_matrix(in_w, out_w)).to(image.device)
    with true_fp32():
        return (ay @ image) @ ax.T
