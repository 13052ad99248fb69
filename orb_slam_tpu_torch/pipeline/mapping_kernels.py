"""Keyframe-rate map-building compute (port of
``orb_slam_tpu.pipeline.mapping_kernels``).

 - triangulate_between / triangulate_multi: CreateNewMapPoints' epipolar
   search + triangulation (src/LocalMapping.cc:220-386,
   src/ORBmatcher.cc:852-1014), batched over the neighbour keyframes.
 - point_stats: UpdateNormalAndDepth (src/MapPoint.cc:273-312) over the
   whole observation table.
 - medoid_descriptors / refresh_medoid_descriptors:
   ComputeDistinctiveDescriptors (src/MapPoint.cc:185-250).
 - fuse_into_keyframe(_tables)(_multi): ORBmatcher::Fuse
   (src/ORBmatcher.cc:1016-1134), batched over the fuse targets.

The JAX package's ``vmap``s are leading tensor axes here; the Hamming work
goes through ``ops/match.py`` (SWAR popcount).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3, triangulate
from ..geometry.camera import CameraParams, in_image
from ..ops import match as m


def fundamental_from_poses(R1, t1, R2, t2, K):
    """F12 such that x2^T F12 x1 = 0 for pixel coords (ComputeF12,
    src/LocalMapping.cc:467-484); batched over leading axes."""
    R12 = R1 @ R2.transpose(-1, -2)
    t12 = t1 - (R12 @ t2[..., None])[..., 0]
    E = se3.hat(t12) @ R12
    Ki = torch.linalg.inv_ex(K).inverse
    F_a = Ki.T @ E @ Ki
    return F_a.transpose(-1, -2)


class TriangulationResult(NamedTuple):
    slot2: torch.Tensor   # [..., N1] matched slot in kf2 (-1 none)
    X: torch.Tensor       # [..., N1, 3] world points
    ok: torch.Tensor      # [..., N1] all gates passed


def _transform(R, t, X):
    """R [..., 3, 3], t [..., 3] applied to X [..., N, 3]."""
    return X @ R.transpose(-1, -2) + t[..., None, :]


def triangulate_between(
    xy1, desc1, level1, angle1, free1,
    xy2, desc2, level2, angle2, free2,
    R1, t1, R2, t2, sigma2_1, sigma2_2, K, cam: CameraParams,
    max_dist: int = 50, epipolar_chi2: float = 3.84,
    reproj_chi2: float = 5.991, scale_factor: float = 1.2,
    histo_length: int = 30, check_orientation: bool = True,
) -> TriangulationResult:
    """Epipolar-gated matching of unassociated keypoints between keyframe 1
    and keyframe(s) 2, then triangulation with the reference's gates.
    Keyframe-2 arguments may carry a leading neighbour axis [B]."""
    F12 = fundamental_from_poses(R1, t1, R2, t2, K)
    n2 = xy2.shape[-2]

    dist = m.hamming_matrix(desc1, desc2)
    mask = (m.epipolar_mask(xy1, xy2, F12, sigma2_2, chi2=epipolar_chi2)
            & m.valid_mask(free1, free2))
    mm = m.match_nn(m.apply_masks(dist, mask), max_dist=max_dist)
    if check_orientation:
        keep = m.rotation_consistency(angle1, angle2, mm,
                                      histo_length=histo_length)
        mm = m.Matches(idx=torch.where(keep, mm.idx,
                                       torch.full_like(mm.idx, -1)),
                       dist=mm.dist, valid=keep)
    mm = m.resolve_duplicates(mm, n2)

    j = torch.clamp(mm.idx, min=0)
    xy2m = torch.gather(xy2, -2, j[..., None].expand(j.shape + (2,)))

    P1 = triangulate.projection_matrix(K, R1, t1)
    P2 = triangulate.projection_matrix(K, R2, t2)
    X = triangulate.triangulate_dlt(P1, P2, xy1.expand_as(xy2m), xy2m)
    finite = torch.all(torch.isfinite(X), dim=-1)
    Xs = torch.where(finite[..., None], X, torch.zeros_like(X))

    c1 = -(R1.transpose(-1, -2) @ t1[..., None])[..., 0]
    c2 = -(R2.transpose(-1, -2) @ t2[..., None])[..., 0]
    cosp = triangulate.parallax_cos(Xs, c1, c2)

    xc1 = _transform(R1, t1, Xs)
    xc2 = _transform(R2, t2, Xs)

    def reproj(xc, xy, s2):
        z = torch.clamp(xc[..., 2], min=1e-6)
        uv = torch.stack([xc[..., 0] / z * cam.fx + cam.cx,
                          xc[..., 1] / z * cam.fy + cam.cy], dim=-1)
        return torch.sum((uv - xy) ** 2, dim=-1) / s2

    e1 = reproj(xc1, xy1, sigma2_1)
    e2 = reproj(xc2, xy2m, torch.gather(sigma2_2, -1, j))

    # scale consistency (LocalMapping.cc:352-366)
    d1 = torch.linalg.vector_norm(Xs - c1[..., None, :], dim=-1)
    d2 = torch.linalg.vector_norm(Xs - c2[..., None, :], dim=-1)
    ratio_dist = d2 / torch.clamp(d1, min=1e-9)
    lvl2 = torch.gather(level2.expand(j.shape[:-1] + level2.shape[-1:]),
                        -1, j)
    ratio_octave = scale_factor ** (level1 - lvl2).to(torch.float32)
    rf = 1.5 * scale_factor
    scale_ok = ((ratio_dist < ratio_octave * rf)
                & (ratio_dist * rf > ratio_octave))

    ok = (mm.valid & finite & (cosp > 0) & (cosp < 0.9998)
          & (xc1[..., 2] > 0) & (xc2[..., 2] > 0)
          & (e1 < reproj_chi2) & (e2 < reproj_chi2) & scale_ok)
    return TriangulationResult(
        slot2=torch.where(ok, mm.idx, torch.full_like(mm.idx, -1)), X=Xs,
        ok=ok)


def point_stats(kf_obs, kf_R, kf_t, kf_level, kf_valid, mp_pos, mp_valid,
                mp_ref_kf, n_levels: int = 8, scale_factor: float = 1.2):
    """UpdateNormalAndDepth over the whole map: mean viewing direction and
    the scale-invariance distance band from the reference keyframe's
    octave.  Returns (normal [P,3], min_dist [P], max_dist [P])."""
    K, N = kf_obs.shape
    P = mp_pos.shape[0]
    dev = mp_pos.device
    centers = -torch.einsum("kji,kj->ki", kf_R, kf_t)          # [K, 3]

    obs_flat = kf_obs.reshape(-1).long()
    kf_of_obs = torch.arange(K, device=dev).repeat_interleave(N)
    valid_obs = (obs_flat >= 0) & kf_valid[kf_of_obs]
    pid = torch.where(valid_obs, obs_flat, P)

    rays = mp_pos[torch.clamp(obs_flat, 0, P - 1)] - centers[kf_of_obs]
    rays = rays / torch.clamp(torch.linalg.vector_norm(
        rays, dim=1, keepdim=True), min=1e-9)
    rays = torch.where(valid_obs[:, None], rays, torch.zeros_like(rays))

    normal_sum = torch.zeros((P + 1, 3), dtype=mp_pos.dtype,
                             device=dev).index_add_(0, pid, rays)
    counts = torch.zeros(P + 1, dtype=mp_pos.dtype, device=dev).index_add_(
        0, pid, valid_obs.to(mp_pos.dtype))
    normal = normal_sum[:P] / torch.clamp(counts[:P, None], min=1.0)

    ref = torch.clamp(mp_ref_kf.long(), 0, K - 1)
    d_ref = torch.linalg.vector_norm(mp_pos - centers[ref], dim=1)
    is_ref_obs = valid_obs & (kf_of_obs == ref[torch.clamp(obs_flat, 0,
                                                           P - 1)])
    pid_ref = torch.where(is_ref_obs, obs_flat, P)
    ref_level = torch.full((P + 1,), n_levels, dtype=torch.int64,
                           device=dev).scatter_reduce(
        0, pid_ref, kf_level.reshape(-1).long(), reduce="amin",
        include_self=True)
    ref_level = torch.clamp(ref_level[:P], 0, n_levels - 1)

    level_scale = scale_factor ** ref_level.to(mp_pos.dtype)
    max_dist = d_ref * level_scale
    min_dist = max_dist / (scale_factor ** (n_levels - 1))
    return normal, min_dist, max_dist


_BIG = 1 << 20


def medoid_descriptors(desc_sets: torch.Tensor, valid: torch.Tensor):
    """For each point's observation descriptors, the one with the least
    median Hamming distance to its siblings.  desc_sets: [P, M, 8] int32;
    valid: [P, M].  Returns (best_desc [P, 8], has_any [P])."""
    P, M, _ = desc_sets.shape
    d = m.hamming_matrix(desc_sets, desc_sets)               # [P, M, M]
    pair_ok = valid[:, :, None] & valid[:, None, :]
    d = torch.where(pair_ok, d, torch.full_like(d, _BIG))
    d_sorted = torch.sort(d, dim=-1).values
    n_valid = torch.sum(valid, dim=1)
    mid = torch.clamp(torch.div(n_valid - 1, 2, rounding_mode="floor"),
                      0, M - 1)
    med = torch.gather(d_sorted, -1,
                       mid[:, None, None].expand(P, M, 1))[..., 0]
    med = torch.where(valid, med, torch.full_like(med, _BIG))
    best = torch.argmin(med, dim=1)
    out = torch.gather(desc_sets, 1, best[:, None, None].expand(P, 1, 8))
    return out[:, 0, :], n_valid > 0


def refresh_medoid_descriptors(kf_obs, kf_desc, mp_desc, kf_row: int,
                               max_obs: int = 8):
    """Medoid descriptors of every landmark keyframe kf_row observes, from
    up to max_obs observations each (the first in keyframe-major order),
    written into a copy of mp_desc."""
    K, N = kf_obs.shape
    P = mp_desc.shape[0]
    BIG = 2 ** 31 - 1
    # the row's distinct ids in a fixed [N] shape (repeats and empty slots
    # invalid), so nothing waits on a data-dependent size
    row = kf_obs[kf_row].long()
    pids = torch.sort(torch.where(row >= 0, row,
                                  torch.full_like(row, BIG))).values
    pid_valid = pids < BIG
    pid_valid[1:] &= pids[1:] != pids[:-1]
    flat = kf_obs.reshape(-1).long()
    flat = torch.where(flat >= 0, flat, torch.full_like(flat, BIG))
    sorted_pid, order = torch.sort(flat, stable=True)
    lo = torch.searchsorted(sorted_pid, pids)
    idx = torch.clamp(lo[:, None] + torch.arange(max_obs, device=flat.device),
                      0, K * N - 1)
    valid = (sorted_pid[idx] == pids[:, None]) & pid_valid[:, None]
    sets = kf_desc.reshape(K * N, 8)[order[idx]]
    best, has = medoid_descriptors(sets, valid)
    # inactive rows write to a scratch row past the pool
    tgt = torch.where(pid_valid & has, torch.clamp(pids, max=P - 1),
                      torch.full_like(pids, P))
    out = torch.cat([mp_desc, mp_desc[:1]])
    out[tgt] = best
    return out[:P]


class MultiTriangulation(NamedTuple):
    X: torch.Tensor       # [N, 3] winning world point per kf slot
    ok: torch.Tensor      # [N] any neighbour triangulated this slot
    slot2: torch.Tensor   # [N] matched slot in the winning neighbour
    nb_of: torch.Tensor   # [N] winning neighbour keyframe id
    blob: torch.Tensor    # [N, 6] float32 [ok, X, slot2, nb_of], one fetch


def triangulate_multi(
    kf_row: int, nb_idx: torch.Tensor,
    kf_xy, kf_desc, kf_level, kf_angle, kf_kp_valid, kf_obs, kf_R, kf_t,
    sigma2_table, K, cam: CameraParams,
    max_dist: int = 50, epipolar_chi2: float = 3.84,
    reproj_chi2: float = 5.991, scale_factor: float = 1.2,
    histo_length: int = 30, check_orientation: bool = True,
) -> MultiTriangulation:
    """CreateNewMapPoints over all covisible neighbours nb_idx [B] (in
    covisibility order) in one batch; the first neighbour that triangulates
    a slot wins it (the reference's sequential first association)."""
    s2 = sigma2_table
    L = s2.shape[0]
    level1 = kf_level[kf_row].long()
    free1 = kf_kp_valid[kf_row] & (kf_obs[kf_row] < 0)
    lv2 = kf_level[nb_idx].long()
    free2 = kf_kp_valid[nb_idx] & (kf_obs[nb_idx] < 0)
    res = triangulate_between(
        kf_xy[kf_row], kf_desc[kf_row], level1, kf_angle[kf_row], free1,
        kf_xy[nb_idx], kf_desc[nb_idx], lv2, kf_angle[nb_idx], free2,
        kf_R[kf_row], kf_t[kf_row], kf_R[nb_idx], kf_t[nb_idx],
        s2[torch.clamp(level1, 0, L - 1)], s2[torch.clamp(lv2, 0, L - 1)],
        K, cam, max_dist=max_dist, epipolar_chi2=epipolar_chi2,
        reproj_chi2=reproj_chi2, scale_factor=scale_factor,
        histo_length=histo_length, check_orientation=check_orientation)
    oks = res.ok                                             # [B, N]
    first = torch.argmax(oks.to(torch.int32), dim=0)         # first True
    any_ok = torch.any(oks, dim=0)
    cols = torch.arange(oks.shape[1], device=oks.device)
    X_win = res.X[first, cols]
    slot2_win = res.slot2[first, cols]
    nb_win = nb_idx[first]
    blob = torch.cat([any_ok.to(torch.float32)[:, None], X_win,
                      slot2_win.to(torch.float32)[:, None],
                      nb_win.to(torch.float32)[:, None]], dim=1)
    return MultiTriangulation(X=X_win, ok=any_ok, slot2=slot2_win,
                              nb_of=nb_win, blob=blob)


def point_stats_and_medoid(kf_obs, kf_R, kf_t, kf_level, kf_valid, mp_pos,
                           mp_valid, mp_ref_kf, kf_desc, mp_desc,
                           kf_row: int, n_levels: int, scale_factor: float,
                           max_obs: int = 8):
    """point_stats + refresh_medoid_descriptors, back to back."""
    normal, min_d, max_d = point_stats(
        kf_obs, kf_R, kf_t, kf_level, kf_valid, mp_pos, mp_valid, mp_ref_kf,
        n_levels=n_levels, scale_factor=scale_factor)
    new_desc = refresh_medoid_descriptors(kf_obs, kf_desc, mp_desc, kf_row,
                                          max_obs=max_obs)
    return normal, min_d, max_d, new_desc


def fuse_into_keyframe(kf_xy, kf_desc, kf_level, kf_kp_valid, R, t,
                       mp_pos, mp_desc, mp_valid, sigma2_kf,
                       cam: CameraParams, radius: float = 3.0,
                       max_dist: int = 50):
    """Project candidate map points into keyframe(s) and match them to the
    keypoints; arguments may carry a leading target axis [T].  Returns
    (slot [..., M], ok [..., M]): the keypoint slot each point should be
    associated with (the caller merges duplicates, MapPoint::Replace)."""
    xc = _transform(R, t, mp_pos)
    z = xc[..., 2]
    zc = torch.clamp(z, min=1e-6)
    uv = torch.stack([xc[..., 0] / zc * cam.fx + cam.cx,
                      xc[..., 1] / zc * cam.fy + cam.cy], dim=-1)
    proj_ok = mp_valid & (z > 0) & in_image(uv, cam)

    dist = m.hamming_matrix(mp_desc, kf_desc)
    du = uv[..., :, None, 0] - kf_xy[..., None, :, 0]
    dv = uv[..., :, None, 1] - kf_xy[..., None, :, 1]
    e2 = du * du + dv * dv
    r_kp = radius * (1.2 ** kf_level.to(torch.float32))
    mask = ((e2 <= (r_kp * r_kp)[..., None, :])
            & (e2 / torch.clamp(sigma2_kf, min=1e-9)[..., None, :] < 5.99)
            & m.valid_mask(proj_ok, kf_kp_valid))
    mm = m.match_nn(m.apply_masks(dist, mask), max_dist=max_dist)
    mm = m.resolve_duplicates(mm, kf_xy.shape[-2])
    return torch.where(mm.valid, mm.idx, torch.full_like(mm.idx, -1)), \
        mm.valid


def fuse_into_keyframe_tables_multi(kf_xy, kf_desc, kf_level, kf_kp_valid,
                                    kf_R, kf_t, targets, mp_pos, mp_desc,
                                    sels, cand_valids, sigma2_table,
                                    cam: CameraParams, radius, max_dist):
    """fuse_into_keyframe over targets [T] with candidate ids sels [T, M]
    (cand_valids [T, M]).  Returns [T, M, 2] int64 (slot, ok)."""
    lv = kf_level[targets].long()
    s2 = sigma2_table[torch.clamp(lv, 0, sigma2_table.shape[0] - 1)]
    selc = torch.clamp(sels, min=0)
    slot, ok = fuse_into_keyframe(
        kf_xy[targets], kf_desc[targets], lv, kf_kp_valid[targets],
        kf_R[targets], kf_t[targets], mp_pos[selc], mp_desc[selc],
        cand_valids, s2, cam, radius=radius, max_dist=max_dist)
    return torch.stack([slot, ok.to(slot.dtype)], dim=-1)


def fuse_into_keyframe_tables(kf_xy, kf_desc, kf_level, kf_kp_valid, kf_R,
                              kf_t, target: int, mp_pos, mp_desc, sel,
                              cand_valid, sigma2_table, cam: CameraParams,
                              radius, max_dist):
    """fuse_into_keyframe for one target with the gathers done here;
    returns [M, 2] (slot, ok)."""
    tg = torch.full((1,), int(target), dtype=torch.int64,
                    device=kf_xy.device)
    return fuse_into_keyframe_tables_multi(
        kf_xy, kf_desc, kf_level, kf_kp_valid, kf_R, kf_t, tg, mp_pos,
        mp_desc, sel[None], cand_valid[None], sigma2_table, cam, radius,
        max_dist)[0]
