"""The tracked-frame hot path (port of
``orb_slam_tpu.pipeline.frame_step.frame_step``).

    image -> pyramid ORB extraction (kernels 1 and 2) -> keypoint
    undistortion -> frame-to-frame projection matching (+fallback) -> pose
    LM -> local-map frustum matching (+fallback) -> pose LM -> landmark
    visible/found counts and the packed host blob.

The reference spreads this over the Frame constructor and the Tracking
thread (src/Frame.cc:55-127, src/Tracking.cc:170-323).  Everything stays on
the device except the two fallback decisions of ``tracking_megastep``
(``track_kernels.HOST_SYNCS_PER_FRAME``); the motion model runs from the
last two poses on the device, so consecutive frames chain without reading
anything back (see ``state.chain``).
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from ..config import ExtractorConfig, MatcherConfig, SolverConfig
from ..device import resolve_device
from ..frontend.extractor_batched import extract_batched
from ..geometry.camera import CameraParams, undistort_pixels
from . import track_kernels as tk


class FrameStepOut(NamedTuple):
    # frame features
    xy: torch.Tensor          # [N, 2] raw (distorted) level-0 pixels
    xy_und: torch.Tensor      # [N, 2] undistorted
    response: torch.Tensor    # [N]
    angle: torch.Tensor       # [N]
    level: torch.Tensor       # [N] int64
    desc: torch.Tensor        # [N, 8] int32
    kp_valid: torch.Tensor    # [N] bool
    inv_sigma2: torch.Tensor  # [N]
    sigma2: torch.Tensor      # [N]
    # tracking results
    R: torch.Tensor           # [3, 3]
    t: torch.Tensor           # [3]
    pid_global: torch.Tensor  # [N] int64 global landmark id per slot (-1 none)
    next_last_pos: torch.Tensor    # [N, 3] positions of associated landmarks
    next_last_valid: torch.Tensor  # [N] bool (pid_global >= 0)
    inliers: torch.Tensor     # [N] bool
    # updated landmark statistics (full-map arrays)
    mp_visible: torch.Tensor  # [P] int32
    mp_found: torch.Tensor    # [P] int32
    lm_matches: torch.Tensor  # 0-d int64 local-map match count
    # packed host readback, one fetch per frame:
    # [R(9), t(3), f2f, localmap, visible, inliers, pid_global(N)]
    host_blob: torch.Tensor   # [16 + N] float32 (pids exact: < 2^24)


@lru_cache(maxsize=16)
def _sigma2(cfg: ExtractorConfig, device) -> torch.Tensor:
    return torch.from_numpy(cfg.sigma2).to(device)


def frame_step(
    image,
    last_desc, last_level, last_angle, last_pos, last_valid,
    mp_pos, mp_desc, mp_normal, mp_min_dist, mp_max_dist, mp_valid,
    sel,
    mp_visible, mp_found,
    R_last, t_last, R_prev, t_prev, prev_lm_matches,
    cam: CameraParams,
    *, ext_cfg: ExtractorConfig, matcher_cfg: MatcherConfig,
    solver_cfg: SolverConfig, min_track_inliers: int = 10,
    has_vel: bool = True, device=None,
) -> FrameStepOut:
    """image: [H, W] grayscale (any numeric dtype, 0..255; numpy or
    tensor).  sel: [cap] int64 indices of the local-map points (-1 =
    padding); mp_* are the FULL map tables, and the local window is
    gathered here.  The state tensors must already be on `device` (cuda
    unless the caller asks for the CPU; ``state.state_from_numpy`` puts
    them there).  Landmark tables are not modified: the updated counts come
    back in the result."""
    dev = resolve_device(device)
    if mp_pos.device != dev or R_last.device != dev:
        raise ValueError(f"frame state lies on {mp_pos.device}, "
                         f"frame_step runs on {dev}")
    if has_vel:
        # in-program motion model (Tracking.cc:130-139)
        vel_R = R_last @ R_prev.T
        vel_t = t_last - vel_R @ t_prev
        R_pred = vel_R @ R_last
        t_pred = vel_R @ t_last + vel_t
    else:
        R_pred, t_pred = R_last, t_last

    feats = extract_batched(image, ext_cfg, ext_cfg.n_features,
                            ext_cfg.max_keypoints, device=dev)
    xy_und = undistort_pixels(feats.xy, cam)
    s2 = _sigma2(ext_cfg, dev)[torch.clamp(feats.level, 0,
                                           ext_cfg.n_levels - 1)]
    inv_s2 = 1.0 / s2

    # local-map window gather (UpdateReference's point set)
    sel_valid = sel >= 0
    selc = torch.clamp(sel, min=0)
    lvalid = mp_valid[selc] & sel_valid

    R_fin, t_fin, assoc, inliers, visible, stats = tk.tracking_megastep(
        xy_und, feats.desc, feats.level, feats.angle, feats.valid, inv_s2,
        last_pos, last_desc, last_level, last_angle, last_valid,
        mp_pos[selc], mp_desc[selc], mp_normal[selc], mp_min_dist[selc],
        mp_max_dist[selc], lvalid,
        R_pred, t_pred, cam, solver_cfg,
        min_track_inliers=min_track_inliers,
        prev_localmap_matches=prev_lm_matches,
        scale_factor=ext_cfg.scale_factor, n_levels=ext_cfg.n_levels,
        matcher_cfg=matcher_cfg)

    # global landmark id per keypoint slot (tracked inliers only — the next
    # frame's "last frame" associations, Tracking.cc:597-608)
    pid_global = torch.where(assoc.valid & inliers, sel[assoc.point_idx],
                             torch.full_like(assoc.point_idx, -1))
    pidc = torch.clamp(pid_global, min=0)

    # landmark statistics (MapPoint::IncreaseVisible/IncreaseFound,
    # src/Tracking.cc:634-639,716-721).  selc repeats index 0 for padding,
    # with zero increments there, so the scatter is an add.
    mp_visible2 = mp_visible.clone().index_add_(
        0, selc, (visible & lvalid).to(mp_visible.dtype))
    mp_found2 = mp_found.clone().index_add_(
        0, pidc, (pid_global >= 0).to(mp_found.dtype))

    host_blob = torch.cat([
        R_fin.reshape(9), t_fin,
        torch.stack([stats["f2f_matches"], stats["localmap_matches"],
                     stats["n_visible"], stats["n_inliers"]]).to(
            torch.float32),
        pid_global.to(torch.float32)])

    return FrameStepOut(
        xy=feats.xy, xy_und=xy_und, response=feats.response,
        angle=feats.angle, level=feats.level, desc=feats.desc,
        kp_valid=feats.valid, inv_sigma2=inv_s2, sigma2=s2,
        R=R_fin, t=t_fin, pid_global=pid_global,
        next_last_pos=mp_pos[pidc], next_last_valid=pid_global >= 0,
        inliers=inliers, mp_visible=mp_visible2, mp_found=mp_found2,
        lm_matches=stats["localmap_matches"], host_blob=host_blob)
