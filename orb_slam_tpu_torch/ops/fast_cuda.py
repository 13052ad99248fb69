"""Fused FAST-9 score + 3x3 NMS + border mask + 7x7 Gaussian blur over the
padded pyramid stack: the wrapper of the CUDA kernel
``csrc/fast_nms_blur.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``orb_slam_tpu/ops/fast_pallas.py::
fast_nms_blur_stack``.  The function computed is the JAX package's XLA
path (``extractor_batched.py:102-119,146-147``): the blur reflects at the
canvas edges (reflect-101) where the Pallas kernel clamps at tile seams.

On the H100 the kernel is bound by device memory (read the true pyramid
once, write score and blur once: 23.5 MB, 7.0 us at [8, 480, 640]) and,
about as much, by FAST's min/max chain (~4 us at one op per lane per
clock); tiles that hold only padding are written as zeros without being
staged.  See the source note in the .cu file for the design.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .. import _build
from .fast import fast_score, nms3x3
from .patches import gaussian_blur7, gaussian_taps_on


def _check_inputs(stack: torch.Tensor, dims: torch.Tensor) -> None:
    if stack.dtype != torch.float32 or stack.dim() != 3:
        raise ValueError(f"stack must be float32 [L, H, W], got "
                         f"{stack.dtype} {tuple(stack.shape)}")
    if dims.dtype != torch.int32 or tuple(dims.shape) != (stack.shape[0], 2):
        raise ValueError(f"dims must be int32 [L, 2], got {dims.dtype} "
                         f"{tuple(dims.shape)}")
    if dims.device != stack.device:
        raise ValueError("stack and dims must be on the same device")
    if stack.shape[1] < 8 or stack.shape[2] < 8:
        raise ValueError(f"canvas {tuple(stack.shape[1:])} is below 8x8")
    if not (stack.is_contiguous() and dims.is_contiguous()):
        raise ValueError("stack and dims must be contiguous")


def fast_nms_blur_plain(stack: torch.Tensor, dims: torch.Tensor,
                        threshold: float, border: int):
    """Plain PyTorch version: (score, blur), each [L, H, W] float32.

    score = nms3x3(fast_score(level, threshold)) zeroed outside
    [border, h-border) x [border, w-border) of each level's true (h, w);
    blur = gaussian_blur7 of each padded level (reflect-101 at the canvas
    edges), not rounded.  The kernel computes the same function for a stack
    that is zero outside each level's true (h, w), as the pyramid builder
    makes it; this version takes any stack."""
    L, H, W = stack.shape
    score = nms3x3(fast_score(stack, float(threshold)))
    lh = dims[:, 0].long()[:, None, None]
    lw = dims[:, 1].long()[:, None, None]
    row = torch.arange(H, device=stack.device)[None, :, None]
    col = torch.arange(W, device=stack.device)[None, None, :]
    interior = ((row >= border) & (row < lh - border)
                & (col >= border) & (col < lw - border))
    score = torch.where(interior, score, torch.zeros_like(score))
    return score, gaussian_blur7(stack)


@lru_cache(maxsize=None)
def _lib():
    lib = _build.load("fast_nms_blur")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fast_nms_blur_launch.argtypes = [p, p, p, p, p, i, i, i,
                                         ctypes.c_float, i, p]
    lib.fast_nms_blur_launch.restype = i
    return lib


def fast_nms_blur_stack(stack: torch.Tensor, dims: torch.Tensor,
                        threshold: float, border: int):
    """stack: [L, H, W] float32 padded pyramid, zero outside each level's
    true (h, w) (``extractor_batched._build_stack`` makes it so: the kernel
    skips tiles that hold only that padding); dims: [L, 2] int32 true (h, w)
    per level.  Returns (score, blur), each [L, H, W] float32.

    A CUDA tensor launches the kernel (``launches`` counts the launches); a
    CPU tensor takes the plain version."""
    _check_inputs(stack, dims)
    if stack.device.type == "cpu":
        return fast_nms_blur_plain(stack, dims, threshold, border)
    if stack.device.type != "cuda":
        raise ValueError(f"unsupported device {stack.device}")
    L, H, W = stack.shape
    score = torch.empty_like(stack)
    blur = torch.empty_like(stack)
    taps = gaussian_taps_on(stack.device)
    stream = torch.cuda.current_stream(stack.device).cuda_stream
    err = _lib().fast_nms_blur_launch(
        stack.data_ptr(), dims.data_ptr(), taps.data_ptr(), score.data_ptr(),
        blur.data_ptr(), L, H, W, float(threshold), int(border), stream)
    _build.check(err, "fast_nms_blur_launch")
    fast_nms_blur_stack.launches += 1
    return score, blur


fast_nms_blur_stack.launches = 0
