"""The tracked-frame hot path (port of ``frame_step``, ``frame_step_scan``
and ``slice_frame`` of ``orb_slam_tpu.pipeline.frame_step``).

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

import numpy as np
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


class FrameStepScanOut(NamedTuple):
    """Stacked per-frame outputs of frame_step_scan ([B, ...] leading axis)
    and the final chain for the next batch."""
    xy: torch.Tensor          # [B, N, 2]
    xy_und: torch.Tensor      # [B, N, 2]
    response: torch.Tensor    # [B, N]
    angle: torch.Tensor       # [B, N]
    level: torch.Tensor       # [B, N]
    desc: torch.Tensor        # [B, N, 8]
    kp_valid: torch.Tensor    # [B, N]
    inv_sigma2: torch.Tensor  # [B, N]
    sigma2: torch.Tensor      # [B, N]
    R: torch.Tensor           # [B, 3, 3]
    t: torch.Tensor           # [B, 3]
    host_blob: torch.Tensor   # [B, 16 + N]: one fetch per batch
    # final chain (last row) for the next dispatch
    last_desc: torch.Tensor        # [N, 8]
    last_level: torch.Tensor       # [N]
    last_angle: torch.Tensor       # [N]
    next_last_pos: torch.Tensor    # [N, 3]
    next_last_valid: torch.Tensor  # [N]
    R_last: torch.Tensor
    t_last: torch.Tensor
    R_prev: torch.Tensor
    t_prev: torch.Tensor
    lm_matches: torch.Tensor
    mp_visible: torch.Tensor  # [P]
    mp_found: torch.Tensor    # [P]


@lru_cache(maxsize=16)
def _sigma2(cfg: ExtractorConfig, device) -> torch.Tensor:
    return torch.from_numpy(cfg.sigma2).to(device)


def _check_device(dev, mp_pos, R_last):
    if mp_pos.device != dev or R_last.device != dev:
        raise ValueError(f"frame state lies on {mp_pos.device}, "
                         f"frame_step runs on {dev}")


def _window(sel, mp_pos, mp_desc, mp_normal, mp_min_dist, mp_max_dist,
            mp_valid):
    """The local-map window gather (UpdateReference's point set):
    (selc, positions, descriptors, normals, bands, validity)."""
    selc = torch.clamp(sel, min=0)
    return (selc, mp_pos[selc], mp_desc[selc], mp_normal[selc],
            mp_min_dist[selc], mp_max_dist[selc], mp_valid[selc] & (sel >= 0))


def _track_frame(image, last_desc, last_level, last_angle, last_pos,
                 last_valid, win, sel, mp_pos, mp_visible, mp_found,
                 R_last, t_last, R_prev, t_prev, prev_lm_matches, cam, *,
                 ext_cfg, matcher_cfg, solver_cfg, min_track_inliers,
                 has_vel, count, dev) -> FrameStepOut:
    """One tracked frame against a gathered window.  count=False leaves the
    landmark counts as they came in (a padded row of a batch)."""
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

    selc, lpos, ldesc, lnorm, lmin, lmax, lvalid = win
    R_fin, t_fin, assoc, inliers, visible, stats = tk.tracking_megastep(
        xy_und, feats.desc, feats.level, feats.angle, feats.valid, inv_s2,
        last_pos, last_desc, last_level, last_angle, last_valid,
        lpos, ldesc, lnorm, lmin, lmax, lvalid,
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
    if count:
        mp_visible = mp_visible.clone().index_add_(
            0, selc, (visible & lvalid).to(mp_visible.dtype))
        mp_found = mp_found.clone().index_add_(
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
        inliers=inliers, mp_visible=mp_visible, mp_found=mp_found,
        lm_matches=stats["localmap_matches"], host_blob=host_blob)


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
    _check_device(dev, mp_pos, R_last)
    win = _window(sel, mp_pos, mp_desc, mp_normal, mp_min_dist, mp_max_dist,
                  mp_valid)
    return _track_frame(
        image, last_desc, last_level, last_angle, last_pos, last_valid, win,
        sel, mp_pos, mp_visible, mp_found, R_last, t_last, R_prev, t_prev,
        prev_lm_matches, cam, ext_cfg=ext_cfg, matcher_cfg=matcher_cfg,
        solver_cfg=solver_cfg, min_track_inliers=min_track_inliers,
        has_vel=has_vel, count=True, dev=dev)


def frame_step_scan(
    images, row_valid,
    last_desc, last_level, last_angle, last_pos, last_valid,
    mp_pos, mp_desc, mp_normal, mp_min_dist, mp_max_dist, mp_valid,
    sel,
    mp_visible, mp_found,
    R_last, t_last, R_prev, t_prev, prev_lm_matches, has_vel0: bool,
    cam: CameraParams,
    *, ext_cfg: ExtractorConfig, matcher_cfg: MatcherConfig,
    solver_cfg: SolverConfig, min_track_inliers: int = 10, device=None,
) -> FrameStepScanOut:
    """B tracked frames in one call (``frame_step_scan`` of the JAX
    package): images [B, H, W] (or a sequence of B frames), row_valid [B]
    bool on the host.  The local window is gathered once; the per-frame
    body of ``frame_step`` runs row after row with the pose, features,
    associations, local-map count and landmark counts chained from one row
    to the next.  The first row predicts with velocity iff has_vel0, every
    later one with velocity.  A row with row_valid False (the padding of a
    partial flush) is tracked like any other but adds nothing to
    mp_visible / mp_found.  The per-frame outputs come back stacked; their
    host blobs are one [B, 16 + N] tensor, fetched once per batch.

    The rows run as a loop on the host: tracking_megastep's two fallback
    decisions read the card on every row (``track_kernels``)."""
    dev = resolve_device(device)
    _check_device(dev, mp_pos, R_last)
    ok = np.asarray(row_valid, bool)
    win = _window(sel, mp_pos, mp_desc, mp_normal, mp_min_dist, mp_max_dist,
                  mp_valid)
    chain = (last_desc, last_level, last_angle, last_pos, last_valid)
    R_p, t_p, lm, vis, fnd, has_vel = (R_prev, t_prev, prev_lm_matches,
                                       mp_visible, mp_found, bool(has_vel0))
    R_l, t_l = R_last, t_last
    rows = []
    for b in range(len(ok)):
        out = _track_frame(
            images[b], *chain, win, sel, mp_pos, vis, fnd, R_l, t_l, R_p,
            t_p, lm, cam, ext_cfg=ext_cfg, matcher_cfg=matcher_cfg,
            solver_cfg=solver_cfg, min_track_inliers=min_track_inliers,
            has_vel=has_vel, count=bool(ok[b]), dev=dev)
        rows.append(out)
        chain = (out.desc, out.level, out.angle, out.next_last_pos,
                 out.next_last_valid)
        R_p, t_p, R_l, t_l = R_l, t_l, out.R, out.t
        lm, vis, fnd, has_vel = (out.lm_matches, out.mp_visible,
                                 out.mp_found, True)

    def stack(name):
        return torch.stack([getattr(o, name) for o in rows])

    return FrameStepScanOut(
        *(stack(n) for n in ("xy", "xy_und", "response", "angle", "level",
                             "desc", "kp_valid", "inv_sigma2", "sigma2",
                             "R", "t", "host_blob")),
        last_desc=chain[0], last_level=chain[1], last_angle=chain[2],
        next_last_pos=chain[3], next_last_valid=chain[4],
        R_last=R_l, t_last=t_l, R_prev=R_p, t_prev=t_p, lm_matches=lm,
        mp_visible=vis, mp_found=fnd)


def slice_frame(tree, b: int) -> tuple:
    """Row b of each stacked tensor of `tree` (views)."""
    return tuple(x[b] for x in tree)
