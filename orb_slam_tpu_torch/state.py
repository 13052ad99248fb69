"""The tracking state that crosses from the JAX package to the port.

The system has no weights: what a frame step needs besides the image is the
map (landmark tables and the local window), the last frame's features and
associations, the last two poses and the camera.  ``state_from_numpy``
takes these as numpy arrays — the inputs of the JAX package's
``frame_step`` under the same names — and puts the port's tensors on a
device, so both packages compute the same step from the same state.
Descriptors arrive as uint32 and are kept as int32 views of the same bits.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from .device import resolve_device
from .geometry.camera import CameraParams, camera_from_values


class FrameState(NamedTuple):
    """frame_step's state arguments, in its positional order."""

    last_desc: torch.Tensor    # [N, 8] int32
    last_level: torch.Tensor   # [N] int64
    last_angle: torch.Tensor   # [N] float32
    last_pos: torch.Tensor     # [N, 3] float32
    last_valid: torch.Tensor   # [N] bool
    mp_pos: torch.Tensor       # [P, 3] float32
    mp_desc: torch.Tensor      # [P, 8] int32
    mp_normal: torch.Tensor    # [P, 3] float32
    mp_min_dist: torch.Tensor  # [P] float32
    mp_max_dist: torch.Tensor  # [P] float32
    mp_valid: torch.Tensor     # [P] bool
    sel: torch.Tensor          # [cap] int64 local window (-1 = padding)
    mp_visible: torch.Tensor   # [P] int32
    mp_found: torch.Tensor     # [P] int32
    R_last: torch.Tensor       # [3, 3] float32
    t_last: torch.Tensor       # [3] float32
    R_prev: torch.Tensor       # [3, 3] float32
    t_prev: torch.Tensor       # [3] float32
    prev_lm_matches: torch.Tensor  # 0-d int64


_KINDS = {
    "last_desc": "desc", "last_level": "index", "last_angle": "float",
    "last_pos": "float", "last_valid": "bool", "mp_pos": "float",
    "mp_desc": "desc", "mp_normal": "float", "mp_min_dist": "float",
    "mp_max_dist": "float", "mp_valid": "bool", "sel": "index",
    "mp_visible": "count", "mp_found": "count", "R_last": "float",
    "t_last": "float", "R_prev": "float", "t_prev": "float",
    "prev_lm_matches": "index",
}


def _convert(kind: str, a) -> np.ndarray:
    a = np.asarray(a)
    if kind == "desc":
        if a.dtype not in (np.uint32, np.int32):
            raise ValueError(f"descriptors must be 32-bit words, got {a.dtype}")
        return np.ascontiguousarray(a).view(np.int32)
    dtype = {"float": np.float32, "bool": np.bool_, "index": np.int64,
             "count": np.int32}[kind]
    return np.ascontiguousarray(a, dtype=dtype)


def state_from_numpy(arrays: Mapping[str, np.ndarray],
                     device=None) -> FrameState:
    """FrameState on `device` (cuda unless the caller asks for the CPU)
    from numpy arrays named as frame_step's arguments."""
    dev = resolve_device(device)
    missing = set(FrameState._fields) - set(arrays)
    if missing:
        raise ValueError(f"missing state arrays: {sorted(missing)}")
    return FrameState(**{
        name: torch.tensor(_convert(_KINDS[name], arrays[name]), device=dev)
        for name in FrameState._fields})


def camera_from_numpy(fields: Mapping, device=None) -> CameraParams:
    """The port's CameraParams from the JAX package's CameraParams fields
    (fx, fy, cx, cy, dist, width, height, min_x, min_y, max_x, max_y),
    each taken as float32, so both packages use the same bounds."""
    return camera_from_values(
        *(np.asarray(fields[k]) for k in ("fx", "fy", "cx", "cy", "dist")),
        int(fields["width"]), int(fields["height"]),
        *(np.asarray(fields[k]) for k in ("min_x", "min_y", "max_x",
                                          "max_y")),
        device=device)


def chain(state: FrameState, out) -> FrameState:
    """The state of the next frame after `out` (a FrameStepOut), without
    leaving the device: the frame's features and inlier associations
    become the last frame, its pose the last pose, the landmark counts
    carry over."""
    return state._replace(
        last_desc=out.desc, last_level=out.level, last_angle=out.angle,
        last_pos=out.next_last_pos, last_valid=out.next_last_valid,
        mp_visible=out.mp_visible, mp_found=out.mp_found,
        R_last=out.R, t_last=out.t, R_prev=state.R_last,
        t_prev=state.t_last, prev_lm_matches=out.lm_matches)
