"""The port's twin of ``__graft_entry__.entry()``: the per-frame tracking
core (``track_kernels.tracking_megastep``: frame-to-frame and local-map
projection matching with the motion-only pose LM) at that function's
shapes, 512 keypoints against 2048 landmarks, from the same seeded numpy
inputs.

    fn, args = entry()            # on the card; entry(device="cpu") on the CPU
    R, t, n_inliers = fn(*args)
"""
from __future__ import annotations

import numpy as np
import torch

from .config import CameraConfig, SystemConfig
from .device import resolve_device
from .geometry import camera as cam_mod
from .pipeline import track_kernels as tk


def example_tracking_arrays(n_kp: int = 512, n_pts: int = 2048,
                            seed: int = 0) -> dict:
    """The numpy inputs of ``__graft_entry__._example_tracking_args``:
    landmarks in front of an identity camera, and a frame whose keypoints
    are the visible landmarks' projections (0.4 px noise) carrying their
    descriptors.  Descriptors are uint32."""
    rng = np.random.default_rng(seed)
    mp_pos = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                       rng.uniform(2, 8, n_pts)], 1).astype(np.float32)
    mp_desc = rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint32)
    uv = np.stack([500 * mp_pos[:, 0] / mp_pos[:, 2] + 320,
                   500 * mp_pos[:, 1] / mp_pos[:, 2] + 240], 1)
    vis = ((uv[:, 0] > 8) & (uv[:, 0] < 632) & (uv[:, 1] > 8)
           & (uv[:, 1] < 472))
    sel = np.where(vis)[0][:n_kp]
    cur_xy = np.full((n_kp, 2), 320.0, np.float32)
    cur_desc = rng.integers(0, 2**32, (n_kp, 8), dtype=np.uint32)
    cur_xy[: len(sel)] = uv[sel] + rng.normal(0, 0.4, (len(sel), 2))
    cur_desc[: len(sel)] = mp_desc[sel]
    # the scale band as point_stats computes it: the predicted level is 0
    d = np.linalg.norm(mp_pos, axis=1)
    return dict(
        cur_xy=cur_xy, cur_desc=cur_desc, cur_level=np.zeros(n_kp, np.int64),
        cur_angle=np.zeros(n_kp, np.float32), cur_valid=np.ones(n_kp, bool),
        mp_pos=mp_pos, mp_desc=mp_desc,
        mp_normal=np.tile(np.array([0.0, 0.0, 1.0], np.float32), (n_pts, 1)),
        mp_min=(d * 1.05 / 1.2**7).astype(np.float32),
        mp_max=(d * 1.05).astype(np.float32), mp_valid=np.ones(n_pts, bool),
        R=np.eye(3, dtype=np.float32), t=np.zeros(3, np.float32),
        inv_sigma2=np.ones(n_kp, np.float32))


def entry(device=None):
    """(fn, args): fn(*args) -> (R, t, n_inliers) of tracking_megastep,
    with the last frame modelled by the first n_kp landmarks and the
    current frame's own features, as ``__graft_entry__.entry`` does."""
    dev = resolve_device(device)
    a = example_tracking_arrays()
    cfg = SystemConfig(camera=CameraConfig(
        fx=500.0, fy=500.0, cx=320.0, cy=240.0, k1=0.0, k2=0.0, p1=0.0,
        p2=0.0, k3=0.0, width=640, height=480))
    cam = cam_mod.make_camera(cfg.camera, device=dev)

    def put(x):
        x = np.ascontiguousarray(x)
        if x.dtype == np.uint32:      # descriptors: int32 views of the words
            x = x.view(np.int32)
        return torch.from_numpy(x).to(dev)

    n_kp = a["cur_xy"].shape[0]
    cur = [put(a[k]) for k in ("cur_xy", "cur_desc", "cur_level",
                               "cur_angle", "cur_valid", "inv_sigma2")]
    last = [put(a["mp_pos"][:n_kp]), cur[1], cur[2], cur[3], cur[4]]
    mp = [put(a[k]) for k in ("mp_pos", "mp_desc", "mp_normal", "mp_min",
                              "mp_max", "mp_valid", "R", "t")]

    def tracking_step(cur_xy, cur_desc, cur_level, cur_angle, cur_valid,
                      inv_sigma2, last_pos, last_desc, last_level,
                      last_angle, last_valid, mp_pos, mp_desc, mp_normal,
                      mp_min, mp_max, mp_valid, R, t):
        R2, t2, _, _, _, stats = tk.tracking_megastep(
            cur_xy, cur_desc, cur_level, cur_angle, cur_valid, inv_sigma2,
            last_pos, last_desc, last_level, last_angle, last_valid,
            mp_pos, mp_desc, mp_normal, mp_min, mp_max, mp_valid,
            R, t, cam, cfg.solver)
        return R2, t2, stats["n_inliers"]

    return tracking_step, tuple(cur + last + mp)
