"""The per-frame tracking core (port of
``orb_slam_tpu.pipeline.track_kernels``).

 - match_last_frame: TrackWithMotionModel's SearchByProjection against the
   last frame (src/ORBmatcher.cc:1507-1620).
 - match_local_map: TrackLocalMap's frustum filter + SearchByProjection
   (src/Frame.cc:136-197, src/ORBmatcher.cc:49-125).
 - tracking_megastep: both matchers with their fallbacks and the two
   motion-only pose LMs.
 - init_window_match: SearchForInitialization (src/ORBmatcher.cc:598-713).

The JAX package's two ``lax.cond`` fallbacks are Python branches here with
the same triggers; each reads one count on the host, so a frame on the card
costs two host syncs (``HOST_SYNCS_PER_FRAME``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import MatcherConfig, SolverConfig
from ..geometry import se3
from ..geometry.camera import CameraParams, in_image
from ..ops import match as m
from ..ops.scatter import invert_matches
from ..solvers import pose_opt as po

# device -> host reads per tracked frame: the f2f and local-map fallback
# decisions of tracking_megastep
HOST_SYNCS_PER_FRAME = 2


class Association(NamedTuple):
    """Per-keypoint-slot landmark association of the current frame."""

    point_idx: torch.Tensor  # [N] int64 index into the supplied point table
    pos: torch.Tensor        # [N, 3] world position of the associated point
    valid: torch.Tensor      # [N] bool


def _project(R, t, pts, cam: CameraParams):
    xc = se3.transform(R, t, pts)
    z = xc[:, 2]
    zc = torch.clamp(z, min=1e-6)
    uv = torch.stack([xc[:, 0] / zc * cam.fx + cam.cx,
                      xc[:, 1] / zc * cam.fy + cam.cy], dim=1)
    return uv, z


def _associate(mm: m.Matches, pos: torch.Tensor, n_cur: int) -> Association:
    """Invert the 1:1 matches into a per-current-slot association."""
    inv = invert_matches(mm.idx, mm.valid, n_cur)
    src = torch.clamp(inv, min=0)
    return Association(point_idx=src, pos=pos[src], valid=inv >= 0)


def match_last_frame(
    cur_xy, cur_desc, cur_level, cur_angle, cur_valid,
    last_pos, last_desc, last_level, last_angle, last_pt_valid,
    R_pred, t_pred, cam: CameraParams,
    radius: float = 15.0, max_dist: int = 100, scale_factor: float = 1.2,
    ratio: float = 1.0, histo_length: int = 30,
    check_orientation: bool = True,
) -> Association:
    """Rows = last frame's landmark-bearing slots, cols = current keypoints."""
    uv, z = _project(R_pred, t_pred, last_pos, cam)
    proj_ok = last_pt_valid & (z > 0) & in_image(uv, cam)

    dist = m.hamming_matrix(last_desc, cur_desc)
    r = radius * scale_factor ** last_level.to(torch.float32)
    mask = (m.window_mask(uv, cur_xy, r)
            & m.level_mask(last_level, cur_level, lo=1, hi=1)
            & m.valid_mask(proj_ok, cur_valid))
    mm = m.match_nn(m.apply_masks(dist, mask), max_dist=max_dist,
                    ratio=ratio)
    if check_orientation:   # mbCheckOrientation (ORBmatcher.cc ctor)
        keep = m.rotation_consistency(last_angle, cur_angle, mm,
                                      histo_length=histo_length)
        mm = m.Matches(idx=torch.where(keep, mm.idx,
                                       torch.full_like(mm.idx, -1)),
                       dist=mm.dist, valid=keep)
    mm = m.resolve_duplicates(mm, cur_xy.shape[0])
    return _associate(mm, last_pos, cur_xy.shape[0])


_VIEW_COS_LIMIT = 0.5   # viewing cone, cos 60 deg (Frame::isInFrustum)


def match_local_map(
    cur_xy, cur_desc, cur_level, cur_angle, cur_valid,
    mp_pos, mp_desc, mp_normal, mp_min_dist, mp_max_dist, mp_valid,
    R, t, cam: CameraParams,
    th: float = 1.0, max_dist: int = 100, ratio: float = 0.8,
    scale_factor: float = 1.2, n_levels: int = 8,
    radius_tight: float = 2.5, radius_wide: float = 4.0,
):
    """Frustum-gated projection matching of local map points (rows) against
    current keypoints (cols).  Returns (Association, visible [P] bool).

    The search radius is RadiusByViewingCos (2.5 px head-on, 4.0 oblique,
    ORBmatcher.cc:127-134) x th x the predicted level's scale."""
    uv, z = _project(R, t, mp_pos, cam)

    # frustum: in image, positive depth, distance band, viewing cone
    cam_center = -torch.einsum("ji,j->i", R, t)   # -R^T t
    rays = mp_pos - cam_center[None, :]
    d = torch.linalg.vector_norm(rays, dim=1)
    view_cos = torch.sum(rays * mp_normal, dim=1) / torch.clamp(
        d * torch.linalg.vector_norm(mp_normal, dim=1), min=1e-9)
    # distance band with the reference's margins [0.8 min, 1.2 max]
    # (Frame::isInFrustum, src/Frame.cc:170-173)
    visible = (mp_valid & (z > 0) & in_image(uv, cam)
               & (d >= 0.8 * mp_min_dist) & (d <= 1.2 * mp_max_dist)
               & (view_cos > _VIEW_COS_LIMIT))

    # scale prediction from distance (KeyFrame::PredictScale)
    ratio_d = torch.log(torch.clamp(mp_max_dist, min=1e-9)
                        / torch.clamp(d, min=1e-9))
    log_sf = torch.log(torch.full((), scale_factor, dtype=torch.float32,
                                  device=d.device))
    pred_level = torch.clamp(torch.ceil(ratio_d / log_sf).to(torch.int64),
                             0, n_levels - 1)

    dist = m.hamming_matrix(mp_desc, cur_desc)
    base_r = torch.where(view_cos > 0.998,
                         torch.full_like(view_cos, radius_tight),
                         torch.full_like(view_cos, radius_wide))
    r = base_r * th * scale_factor ** pred_level.to(torch.float32)
    # level gate [pred-1, pred] (GetFeaturesInArea, ORBmatcher.cc:75-76)
    mask = (m.window_mask(uv, cur_xy, r)
            & m.level_mask(pred_level, cur_level, lo=1, hi=0)
            & m.valid_mask(visible, cur_valid))
    mm = m.match_nn(m.apply_masks(dist, mask), max_dist=max_dist,
                    ratio=ratio)
    mm = m.resolve_duplicates(mm, cur_xy.shape[0])
    return _associate(mm, mp_pos, cur_xy.shape[0]), visible


def tracking_megastep(
    cur_xy, cur_desc, cur_level, cur_angle, cur_valid, cur_inv_sigma2,
    last_pos, last_desc, last_level, last_angle, last_pt_valid,
    mp_pos, mp_desc, mp_normal, mp_min_dist, mp_max_dist, mp_valid,
    R_pred, t_pred, cam: CameraParams, solver_cfg: SolverConfig,
    min_track_inliers: int = 10,
    prev_localmap_matches=0,
    scale_factor: float = 1.2, n_levels: int = 8,
    matcher_cfg: MatcherConfig = None,
):
    """Frame-to-frame projection matching with the wide-window fallback,
    motion-only pose LM, frustum-gated local-map matching with the coarse
    fallback, final pose LM.

    Returns (R, t, assoc into the local-map table, inliers [N] bool,
    visible [P] bool, stats dict of 0-d tensors)."""
    mcfg = matcher_cfg if matcher_cfg is not None else MatcherConfig()

    # narrow = SearchByProjection(cur, last, 15) (Tracking.cc:584); wide =
    # the last-opportunity th=50 pass (Tracking.cc:548) with the tracking
    # matcher's 0.9 ratio test
    def f2f(radius, ratio):
        return match_last_frame(
            cur_xy, cur_desc, cur_level, cur_angle, cur_valid,
            last_pos, last_desc, last_level, last_angle, last_pt_valid,
            R_pred, t_pred, cam, radius=radius, max_dist=mcfg.th_high,
            scale_factor=scale_factor, ratio=ratio,
            histo_length=mcfg.histo_length,
            check_orientation=mcfg.check_orientation)

    assoc1 = f2f(mcfg.radius_f2f, 1.0)
    if bool(assoc1.valid.sum() < 2 * min_track_inliers):     # host sync 1
        assoc1 = f2f(mcfg.radius_f2f_fallback, mcfg.nn_ratio_tracking)
    n_f2f = assoc1.valid.sum()

    r1 = po.optimize_pose(R_pred, t_pred, assoc1.pos, cur_xy, cur_inv_sigma2,
                          assoc1.valid, cam, solver_cfg)
    ok1 = r1.n_inliers >= min_track_inliers
    R_cur = torch.where(ok1, r1.R, R_pred)
    t_cur = torch.where(ok1, r1.t, t_pred)

    # narrow = th 1 (Tracking.cc:737); wide = the coarse th used after
    # relocalisation (Tracking.cc:739-740), taken when the narrow pass
    # under-yields
    def lmm(th):
        return match_local_map(
            cur_xy, cur_desc, cur_level, cur_angle, cur_valid,
            mp_pos, mp_desc, mp_normal, mp_min_dist, mp_max_dist, mp_valid,
            R_cur, t_cur, cam, th=th,
            max_dist=mcfg.th_high, ratio=mcfg.nn_ratio_localmap,
            scale_factor=scale_factor, n_levels=n_levels,
            radius_tight=mcfg.radius_view_cos_tight,
            radius_wide=mcfg.radius_view_cos_wide)

    assoc2, visible = lmm(mcfg.localmap_th)
    if isinstance(prev_localmap_matches, torch.Tensor):   # chained frames
        floor = torch.clamp(
            (0.6 * prev_localmap_matches.to(torch.float32)).to(torch.int64),
            min=min_track_inliers * 6)
    else:   # a host count: the same float32 product, without an upload
        floor = max(int(np.float32(0.6) * np.float32(prev_localmap_matches)),
                    min_track_inliers * 6)
    if bool(assoc2.valid.sum() < floor):                      # host sync 2
        assoc2, visible = lmm(mcfg.localmap_th_coarse)

    r2 = po.optimize_pose(R_cur, t_cur, assoc2.pos, cur_xy, cur_inv_sigma2,
                          assoc2.valid, cam, solver_cfg)
    stats = {
        "f2f_matches": n_f2f,
        "localmap_matches": assoc2.valid.sum(),
        "n_visible": visible.sum(),
        "n_inliers": r2.n_inliers,
    }
    return se3.orthonormalize(r2.R), r2.t, assoc2, r2.inliers, visible, stats


def init_window_match(
    xy1, desc1, level1, angle1, valid1,
    xy2, desc2, level2, angle2, valid2,
    radius: float = 100.0, max_dist: int = 50, ratio: float = 0.9,
    histo_length: int = 30, check_orientation: bool = True,
) -> m.Matches:
    """SearchForInitialization (src/ORBmatcher.cc:598-713): window search at
    level 0, mutual best, ratio test, rotation consistency.  Returns Matches
    with rows = frame 1."""
    dist = m.hamming_matrix(desc1, desc2)
    mask = (m.window_mask(xy1, xy2, radius)
            & m.valid_mask(valid1 & (level1 == 0), valid2 & (level2 == 0)))
    mm = m.match_nn(m.apply_masks(dist, mask), max_dist=max_dist,
                    ratio=ratio, mutual=True)
    if check_orientation:
        keep = m.rotation_consistency(angle1, angle2, mm,
                                      histo_length=histo_length)
        mm = m.Matches(idx=torch.where(keep, mm.idx,
                                       torch.full_like(mm.idx, -1)),
                       dist=mm.dist, valid=keep)
    return m.resolve_duplicates(mm, xy2.shape[0])
