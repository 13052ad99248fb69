"""Separable antialiased bilinear resize as two matrix products (port of
``orb_slam_tpu.ops.resize``).

The interpolation weights replicate jax.image.resize's triangle kernel with
antialiasing, so the port builds the same pyramid as the JAX package.
Replaces the role of cv::resize in the reference pyramid
(src/ORBextractor.cc:781-822).  ``resize_bilinear`` (two matrix products)
builds the batched extractor's pyramid; ``resize_bilinear_fused`` (the
same weights as explicit fused multiply-add chains) builds the per-level
extractor's, the same on every device.
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


@lru_cache(maxsize=None)
def _band(in_size: int, out_size: int, device: torch.device):
    """resize_matrix as a band: (first input index [out] , taps [out, T]
    float64 weights, zero past each row's last tap)."""
    a = resize_matrix(in_size, out_size)
    nz = a != 0
    k0 = nz.argmax(axis=1)
    n = nz.sum(axis=1)
    taps = int(n.max())
    w = np.zeros((out_size, taps), np.float64)
    for t in range(taps):
        k = np.minimum(k0 + t, in_size - 1)
        w[:, t] = np.where(t < n, a[np.arange(out_size), k], 0.0)
    return (torch.from_numpy(k0).to(device),
            torch.from_numpy(w).to(device))


def _fma_rows(x: torch.Tensor, in_size: int, out_size: int) -> torch.Tensor:
    """out[i] = the fused multiply-add chain, in input order, of row i's
    taps over the rows of x [in, C]; float32 out."""
    k0, w = _band(in_size, out_size, x.device)
    acc = torch.zeros((out_size, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for t in range(w.shape[1]):
        rows = x[torch.clamp(k0 + t, max=in_size - 1)].double()
        acc = (w[:, t, None] * rows + acc.double()).float()
    return acc


def resize_bilinear_fused(image: torch.Tensor, out_h: int,
                          out_w: int) -> torch.Tensor:
    """resize_bilinear of a float32 [H, W] image as a CPU matrix product
    evaluates it (XLA's dot and MKL's sgemm alike): each output a chain of
    fused multiply-adds over its nonzero taps in input order, rows then
    columns.  Each fma is taken exactly in float64 and rounded to float32,
    so the result does not depend on the device; the card's sgemm sums in
    another order, and a level that is then rounded to integers moves
    pixels that lie on a half."""
    in_h, in_w = image.shape
    rows = _fma_rows(image, in_h, out_h)                   # [out_h, W]
    return _fma_rows(rows.T, in_w, out_w).T.contiguous()   # [out_h, out_w]
