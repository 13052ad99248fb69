"""Pinhole camera with radial-tangential distortion (port of
``orb_slam_tpu.geometry.camera``).

The scalars are float32 0-d tensors on the camera's device, so every
expression rounds as the JAX package's float32 scalars do and nothing
waits on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import CameraConfig
from ..device import resolve_device


class CameraParams(NamedTuple):
    """Device-resident camera constants."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor  # [5] = k1, k2, p1, p2, k3
    width: int
    height: int
    # undistorted image bounds (Frame::ComputeImageBounds,
    # src/Frame.cc:320-348)
    min_x: torch.Tensor
    min_y: torch.Tensor
    max_x: torch.Tensor
    max_y: torch.Tensor

    @property
    def inv_fx(self) -> torch.Tensor:
        return 1.0 / self.fx

    @property
    def inv_fy(self) -> torch.Tensor:
        return 1.0 / self.fy


def distort_normalized(xn: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Apply k1..k3,p1,p2 to normalized coords xn[..., 2]."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


_UNDISTORT_ITERS = 8


def undistort_normalized(xd: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Invert the distortion model by fixed-point iteration (OpenCV-style):
    x_{n+1} = (xd - tangential(x_n)) / radial(x_n), 8 iterations."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x = xd[..., 0]
    y = xd[..., 1]
    x0, y0 = x, y
    for _ in range(_UNDISTORT_ITERS):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        inv = 1.0 / radial
        x = (x0 - dx) * inv
        y = (y0 - dy) * inv
    return torch.stack([x, y], dim=-1)


def undistort_pixels(uv: torch.Tensor, cam: CameraParams) -> torch.Tensor:
    """Distorted pixel coords -> undistorted pixel coords (same K);
    Frame::UndistortKeyPoints (src/Frame.cc:288-318)."""
    xn = torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                      (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    xu = undistort_normalized(xn, cam.dist)
    return torch.stack([xu[..., 0] * cam.fx + cam.cx,
                        xu[..., 1] * cam.fy + cam.cy], dim=-1)


def project(xc: torch.Tensor, cam: CameraParams) -> torch.Tensor:
    """Camera-frame 3D points [..., 3] -> undistorted pixel coords [..., 2].
    Points behind the camera stay finite; frustum checks mask them."""
    z = xc[..., 2]
    zi = 1.0 / torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    u = xc[..., 0] * zi * cam.fx + cam.cx
    v = xc[..., 1] * zi * cam.fy + cam.cy
    return torch.stack([u, v], dim=-1)


def unproject(uv: torch.Tensor, depth: torch.Tensor,
              cam: CameraParams) -> torch.Tensor:
    """Undistorted pixels + depth -> camera-frame 3D points."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def bearings(uv: torch.Tensor, cam: CameraParams) -> torch.Tensor:
    """Undistorted pixels -> unit-z normalized rays [..., 3]."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def in_image(uv: torch.Tensor, cam: CameraParams) -> torch.Tensor:
    """Inside the undistorted image bounds (Frame::isInFrustum checks)."""
    return ((uv[..., 0] >= cam.min_x) & (uv[..., 0] < cam.max_x)
            & (uv[..., 1] >= cam.min_y) & (uv[..., 1] < cam.max_y))


def camera_from_values(fx, fy, cx, cy, dist, width: int, height: int,
                       min_x, min_y, max_x, max_y,
                       device=None) -> CameraParams:
    """CameraParams from plain numbers, each rounded to float32 and placed
    on ``device`` (cuda unless the caller asks for the CPU)."""
    dev = resolve_device(device)

    def f32(v):
        return torch.tensor(np.float32(v), dtype=torch.float32, device=dev)

    return CameraParams(
        fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy),
        dist=torch.tensor(np.array(dist, np.float32), device=dev),
        width=int(width), height=int(height),
        min_x=f32(min_x), min_y=f32(min_y), max_x=f32(max_x),
        max_y=f32(max_y))


def make_camera(cfg: CameraConfig, device=None) -> CameraParams:
    """Build CameraParams, computing undistorted bounds from the 4 image
    corners like Frame::ComputeImageBounds (src/Frame.cc:320-348)."""
    base = camera_from_values(cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.dist,
                              cfg.width, cfg.height, 0.0, 0.0,
                              cfg.width, cfg.height, device=device)
    if not cfg.has_distortion:
        return base
    corners = torch.tensor(
        [[0.0, 0.0], [cfg.width, 0.0], [0.0, cfg.height],
         [cfg.width, cfg.height]], dtype=torch.float32,
        device=base.fx.device)
    und = undistort_pixels(corners, base)
    return base._replace(
        min_x=torch.minimum(und[0, 0], und[2, 0]),
        max_x=torch.maximum(und[1, 0], und[3, 0]),
        min_y=torch.minimum(und[0, 1], und[1, 1]),
        max_y=torch.maximum(und[2, 1], und[3, 1]),
    )
