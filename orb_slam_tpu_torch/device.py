"""Device choice and the float32 contract shared by the port's entry points."""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Never falls back to the CPU: asking for CUDA without a card
    raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "orb_slam_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # tensors report cuda:N; compare like with like
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def upload(a, device: torch.device, dtype=None) -> torch.Tensor:
    """A host array as a tensor on `device`.  To the card it goes through
    pinned memory with a non-blocking copy, so the host does not wait for
    the work already queued there (a pageable copy synchronizes)."""
    t = torch.as_tensor(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone() if t.device == device else t.to(device)


@contextlib.contextmanager
def true_fp32():
    """Run float32 matrix products in full float32 (TF32 off).

    The pyramid resize is rounded to integers per level, and TF32 (10-bit
    mantissa) would move pixels across the .5 boundary; the pose LM normal
    equations need true fp32 like the reference's f32 solvers.  The previous
    flags are restored on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
