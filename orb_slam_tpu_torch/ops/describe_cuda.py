"""Intensity-centroid moments + steered BRIEF for the whole pyramid: the
wrapper of the CUDA kernel ``csrc/orient_describe.cu`` and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``orb_slam_tpu/ops/describe_pallas.py::
orient_describe`` (IC_Angle, ORBextractor.cc:124-151, and
computeOrbDescriptor, :155-194).  Like the TPU kernel it steers with
cos/sin = m10/|m|, m01/|m| (the same angle as atan2(m01, m10) up to
rounding) and returns the moments, so the caller computes atan2 once.

On the H100 the kernel is bound by the latency of its gathers: one warp
per slot in a single wave, three dependent memory round trips per warp; see
the source note in the .cu file for the design.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .. import _build
from . import brief, patches


def _check_inputs(stack, blurred, kp_xy, dims, counts) -> None:
    if stack.dtype != torch.float32 or stack.dim() != 3:
        raise ValueError(f"stack must be float32 [L, H, W], got "
                         f"{stack.dtype} {tuple(stack.shape)}")
    L = stack.shape[0]
    if blurred.dtype != torch.float32 or blurred.shape != stack.shape:
        raise ValueError("blurred must be float32 of the stack's shape")
    if (kp_xy.dtype != torch.float32 or kp_xy.dim() != 3
            or kp_xy.shape[0] != L or kp_xy.shape[2] != 2):
        raise ValueError(f"kp_xy must be float32 [L, cap, 2], got "
                         f"{kp_xy.dtype} {tuple(kp_xy.shape)}")
    if dims.dtype != torch.int32 or tuple(dims.shape) != (L, 2):
        raise ValueError("dims must be int32 [L, 2]")
    if counts.dtype != torch.int32 or tuple(counts.shape) != (L,):
        raise ValueError("counts must be int32 [L]")
    tensors = (stack, blurred, kp_xy, dims, counts)
    if any(t.device != stack.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")


@lru_cache(maxsize=None)
def _consts(device: torch.device):
    """(IC mask * dx, IC mask * dy, BRIEF end points [2, 256, 2]: the p
    point of every pair, then the q point, in pair order).  The kernel
    reads the end points from this tensor."""
    mask = torch.from_numpy(patches._IC_MASK)
    d = torch.from_numpy(patches._IC_DX)
    w10 = mask * d[None, :]
    w01 = mask * d[:, None]
    pts = torch.from_numpy(brief._POINTS)
    pattern = torch.stack([pts[0::2], pts[1::2]]).contiguous()
    return w10.to(device), w01.to(device), pattern.to(device)


def orient_describe_plain(stack, blurred, kp_xy, dims, counts):
    """Plain PyTorch version: (m01 [L, cap], m10 [L, cap], desc [L, cap, 8]
    int32).  Slots at or past counts[l] are exact zeros."""
    L, H, W = stack.shape
    cap = kp_xy.shape[1]
    w10, w01, pattern = _consts(stack.device)
    lh = dims[:, 0].long()[:, None, None]
    lw = dims[:, 1].long()[:, None, None]
    lvl = torch.arange(L, device=stack.device)[:, None, None]
    fx = kp_xy[..., 0:1]                               # [L, cap, 1]
    fy = kp_xy[..., 1:2]

    # moments over the clamped 31x31 window of the raw level
    r = patches.HALF_PATCH
    d = torch.arange(-r, r + 1, device=stack.device)
    ys = torch.clamp(torch.round(fy).long() + d, min=0)
    ys = torch.minimum(ys, lh - 1)                      # [L, cap, 31]
    xs = torch.clamp(torch.round(fx).long() + d, min=0)
    xs = torch.minimum(xs, lw - 1)
    flat = ((lvl[..., None] * H + ys[..., :, None]) * W + xs[..., None, :])
    pat = stack.reshape(-1)[flat]                       # [L, cap, 31, 31]
    m10 = torch.sum(pat * w10, dim=(-2, -1))
    m01 = torch.sum(pat * w01, dim=(-2, -1))

    hyp = torch.sqrt(m10 * m10 + m01 * m01)
    pos = hyp > 0
    safe = torch.where(pos, hyp, torch.ones_like(hyp))
    ca = torch.where(pos, m10 / safe, torch.ones_like(hyp))[..., None]
    sa = torch.where(pos, m01 / safe, torch.zeros_like(hyp))[..., None]

    def samples(pts):                                   # -> [L, cap, 256]
        px = pts[:, 0]
        py = pts[:, 1]
        sx = torch.round(px * ca - py * sa + fx).long()
        sy = torch.round(px * sa + py * ca + fy).long()
        xi = torch.minimum(torch.clamp(sx, min=0), lw - 1)
        yi = torch.minimum(torch.clamp(sy, min=0), lh - 1)
        return blurred.reshape(-1)[(lvl * H + yi) * W + xi]

    bits = (samples(pattern[0]) < samples(pattern[1])).to(torch.int64)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=stack.device),
        torch.arange(32, device=stack.device))
    words = torch.sum(bits.reshape(L, cap, 8, 32) * weights, dim=-1)
    # uint32 words viewed as int32: subtract 2^32 above 2^31 - 1
    desc = torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)

    live = torch.arange(cap, device=stack.device)[None, :] < counts[:, None]
    zero = torch.zeros_like(m10)
    return (torch.where(live, m01, zero), torch.where(live, m10, zero),
            torch.where(live[..., None], desc, torch.zeros_like(desc)))


@lru_cache(maxsize=None)
def _lib():
    lib = _build.load("orient_describe")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.orient_describe_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i,
                                           i, i, p]
    lib.orient_describe_launch.restype = i
    return lib


def orient_describe(stack, blurred, kp_xy, dims, counts):
    """stack/blurred: [L, H, W] float32 (padded pyramid and its rounded
    blur); kp_xy: [L, cap, 2] float32 level-local pixels; dims: [L, 2] int32
    true (h, w); counts: [L] int32 live keypoints per level (the live slots
    are a prefix).  Returns (m01 [L, cap], m10 [L, cap], desc [L, cap, 8]
    int32), exact zeros at slots >= counts.

    A CUDA tensor launches the kernel (``launches`` counts the launches); a
    CPU tensor takes the plain version."""
    _check_inputs(stack, blurred, kp_xy, dims, counts)
    if stack.device.type == "cpu":
        return orient_describe_plain(stack, blurred, kp_xy, dims, counts)
    if stack.device.type != "cuda":
        raise ValueError(f"unsupported device {stack.device}")
    L, H, W = stack.shape
    cap = kp_xy.shape[1]
    pattern = _consts(stack.device)[2]
    m01 = torch.empty((L, cap), dtype=torch.float32, device=stack.device)
    m10 = torch.empty_like(m01)
    desc = torch.empty((L, cap, 8), dtype=torch.int32, device=stack.device)
    stream = torch.cuda.current_stream(stack.device).cuda_stream
    err = _lib().orient_describe_launch(
        stack.data_ptr(), blurred.data_ptr(), kp_xy.data_ptr(),
        dims.data_ptr(), counts.data_ptr(), pattern.data_ptr(),
        m01.data_ptr(), m10.data_ptr(), desc.data_ptr(), L, H, W, cap,
        stream)
    _build.check(err, "orient_describe_launch")
    orient_describe.launches += 1
    return m01, m10, desc


orient_describe.launches = 0
