"""A rendered two-plane world and a ground-truth map built from it (numpy).

``SceneRenderer``, ``make_texture``, ``rotmat`` and ``pose_at`` are copies
of the ones in the repo's ``bench.py``: two textured fronto-parallel walls
(near at z=6 m, far at z=12 m) seen by a camera sweeping sideways.
``plane_map`` turns features extracted at known poses into a landmark map
(each keypoint back-projected onto the wall its ray hits, with the normal
and distance band of the JAX package's ``mapping_kernels.point_stats``),
and ``state_arrays`` lays the map and the last frame out as the numpy
arrays that ``orb_slam_tpu_torch.state.state_from_numpy`` takes.  The test
world of ``chip_smoke.py``, ``scripts/torch_frame_profile.py`` and the
port's differential tests; the package does not import it.
"""
from __future__ import annotations

import numpy as np


def _sample_bilinear(tex, u, v):
    h, w = tex.shape
    u = np.mod(u, float(w))
    v = np.mod(v, float(h))
    x0 = np.minimum(u.astype(np.int32), w - 1)
    y0 = np.minimum(v.astype(np.int32), h - 1)
    fx = u - x0
    fy = v - y0
    x1 = (x0 + 1) % w
    y1 = (y0 + 1) % h
    return (tex[y0, x0] * (1 - fx) * (1 - fy) + tex[y0, x1] * fx * (1 - fy)
            + tex[y1, x0] * (1 - fx) * fy + tex[y1, x1] * fx * fy)


def make_texture(rng, size=1024):
    """Multi-octave band-limited value noise (finest features ~4 px)."""
    img = np.zeros((size, size), np.float32)
    yy, xx = np.meshgrid(np.arange(size, dtype=np.float32),
                         np.arange(size, dtype=np.float32), indexing="ij")
    for cells, amp in ((8, 0.7), (32, 1.0), (64, 1.0), (128, 1.0),
                       (256, 0.8)):
        g = rng.uniform(0, 1, (cells, cells)).astype(np.float32)
        s = cells / size
        img += amp * _sample_bilinear(g, xx * s, yy * s)
    img -= img.min()
    return (img / img.max() * 255.0).astype(np.float32)


class SceneRenderer:
    """Two textured fronto-parallel planes rendered by inverse ray casting
    into 8-bit frames."""

    Z_NEAR, Z_FAR = 6.0, 12.0
    NEAR_HALF = (4.2, 2.8)     # world half-extent of the near wall (m)
    PX_NEAR = 85.0
    PX_FAR = 42.0

    def __init__(self, rng, K, width=640, height=480):
        self.K = np.asarray(K, np.float32)
        self.tex_near = make_texture(rng)
        self.tex_far = make_texture(rng)
        uu, vv = np.meshgrid(np.arange(width, dtype=np.float32),
                             np.arange(height, dtype=np.float32))
        self.dirs = np.stack([(uu - K[0, 2]) / K[0, 0],
                              (vv - K[1, 2]) / K[1, 1],
                              np.ones_like(uu)], -1)      # [H, W, 3]

    def _hits(self, o, D):
        dz = np.where(np.abs(D[..., 2]) < 1e-9, 1e-9, D[..., 2])
        s_near = (self.Z_NEAR - o[..., 2]) / dz
        wn = o + s_near[..., None] * D
        s_far = (self.Z_FAR - o[..., 2]) / dz
        wf = o + s_far[..., None] * D
        near_hit = ((s_near > 0)
                    & (np.abs(wn[..., 0]) < self.NEAR_HALF[0])
                    & (np.abs(wn[..., 1]) < self.NEAR_HALF[1]))
        return wn, wf, near_hit

    def render(self, R, t):
        o = -R.T @ t                                      # camera center
        wn, wf, near_hit = self._hits(o[None, None, :], self.dirs @ R)
        img = _sample_bilinear(self.tex_far, wf[..., 0] * self.PX_FAR,
                               wf[..., 1] * self.PX_FAR)
        img_n = _sample_bilinear(self.tex_near, wn[..., 0] * self.PX_NEAR,
                                 wn[..., 1] * self.PX_NEAR)
        return np.clip(np.round(np.where(near_hit, img_n, img)),
                       0, 255).astype(np.uint8)

    def backproject(self, uv, R, t):
        """World points [N, 3] of the wall each pixel's ray hits."""
        K = self.K
        d = np.stack([(uv[:, 0] - K[0, 2]) / K[0, 0],
                      (uv[:, 1] - K[1, 2]) / K[1, 1],
                      np.ones(len(uv), np.float32)], -1)
        o = -R.T @ t
        wn, wf, near_hit = self._hits(o[None, :], d @ R)
        return np.where(near_hit[:, None], wn, wf).astype(np.float32)


def rotmat(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.cos(angle / 2)
    b, c, d = -axis * np.sin(angle / 2)
    return np.array([
        [a*a+b*b-c*c-d*d, 2*(b*c+a*d), 2*(b*d-a*c)],
        [2*(b*c-a*d), a*a+c*c-b*b-d*d, 2*(c*d+a*b)],
        [2*(b*d+a*c), 2*(c*d-a*b), a*a+d*d-b*b-c*c]], np.float32)


def pose_at(i):
    """World->camera pose of frame i on the bench's panning sweep."""
    ph = 2.0 * np.pi * i / 300.0
    R = rotmat([0, 1, 0], np.radians(-10.0 * np.sin(ph + 0.5)))
    t = np.array([-1.8 * np.sin(ph) + 0.0025 * i,
                  0.05 * np.sin(2.3 * ph),
                  0.3 * np.sin(0.7 * ph)], np.float32)
    return R, t


def camera_center(R, t):
    return (-R.T @ t).astype(np.float32)


SCALE_FACTOR, N_LEVELS = 1.2, 8     # the bench's pyramid


def plane_map(renderer: SceneRenderer, views):
    """Landmarks from features seen at known poses.

    views: list of (R, t, feats) with feats a dict of numpy arrays xy
    [N, 2] (level-0 pixels, undistorted), level [N], desc [N, 8] (32-bit
    words), valid [N].  Returns (points dict of [P, ...] arrays, per-view
    list of [N] landmark ids with -1 where a slot has none)."""
    pos, desc, normal, min_d, max_d, ids = [], [], [], [], [], []
    n = 0
    for R, t, f in views:
        v = np.asarray(f["valid"], bool)
        X = renderer.backproject(np.asarray(f["xy"], np.float32)[v], R, t)
        ray = X - camera_center(R, t)
        d = np.linalg.norm(ray, axis=1)
        lev = np.asarray(f["level"])[v].astype(np.float32)
        mx = d * SCALE_FACTOR ** lev
        pos.append(X)
        desc.append(np.asarray(f["desc"])[v].view(np.uint32))
        normal.append(ray / d[:, None])
        max_d.append(mx)
        min_d.append(mx / SCALE_FACTOR ** (N_LEVELS - 1))
        slot = np.full(len(v), -1, np.int64)
        slot[v] = np.arange(n, n + v.sum())
        ids.append(slot)
        n += int(v.sum())
    pts = dict(pos=np.concatenate(pos), desc=np.concatenate(desc),
               normal=np.concatenate(normal).astype(np.float32),
               min_dist=np.concatenate(min_d).astype(np.float32),
               max_dist=np.concatenate(max_d).astype(np.float32))
    return pts, ids


def state_arrays(pts, last_feats, last_ids, pose_last, pose_prev,
                 window: int, pool: int):
    """The numpy arrays of a frame_step state: the map padded to a `pool`
    of landmark slots, the local window `sel` = every landmark padded to
    `window` with -1, the last frame's features and associations, and the
    last two poses."""
    P = len(pts["pos"])
    if P > window or window > pool:
        raise ValueError(f"{P} landmarks, window {window}, pool {pool}")

    def padded(a, fill=0):
        out = np.full((pool,) + a.shape[1:], fill, a.dtype)
        out[:P] = a
        return out

    last_valid = last_ids >= 0
    last_pos = np.zeros((len(last_ids), 3), np.float32)
    last_pos[last_valid] = pts["pos"][last_ids[last_valid]]
    sel = np.full(window, -1, np.int64)
    sel[:P] = np.arange(P)
    return dict(
        last_desc=np.asarray(last_feats["desc"]).view(np.uint32),
        last_level=np.asarray(last_feats["level"]),
        last_angle=np.asarray(last_feats["angle"], np.float32),
        last_pos=last_pos, last_valid=last_valid,
        mp_pos=padded(pts["pos"]), mp_desc=padded(pts["desc"]),
        mp_normal=padded(pts["normal"]),
        mp_min_dist=padded(pts["min_dist"]),
        mp_max_dist=padded(pts["max_dist"], np.float32(np.inf)),
        mp_valid=padded(np.ones(P, bool)), sel=sel,
        mp_visible=np.zeros(pool, np.int32), mp_found=np.zeros(pool, np.int32),
        R_last=pose_last[0], t_last=pose_last[1],
        R_prev=pose_prev[0], t_prev=pose_prev[1],
        prev_lm_matches=np.int64(0))


def tracking_world(extract, K, map_views, window: int, pool: int,
                   width: int = 640, height: int = 480, seed: int = 11):
    """A renderer and the numpy state of the frame after the last map view.

    extract(image) -> features with numpy-convertible fields xy, level,
    desc, angle, valid (either package's extractor).  The map holds every
    valid keypoint of the `map_views` frames of the sweep, the last frame is
    the last map view, and the previous pose is the frame before it, so the
    motion model predicts the next frame of the sweep."""
    renderer = SceneRenderer(np.random.default_rng(seed), K, width, height)
    views = []
    for i in map_views:
        R, t = pose_at(i)
        f = extract(renderer.render(R, t))
        views.append((R, t, {k: np.asarray(_host(getattr(f, k)))
                             for k in ("xy", "level", "desc", "angle",
                                       "valid")}))
    pts, ids = plane_map(renderer, views)
    arrays = state_arrays(pts, views[-1][2], ids[-1], pose_at(map_views[-1]),
                          pose_at(map_views[-1] - 1), window, pool)
    return renderer, arrays


def _host(x):
    """numpy value of a host array or a device tensor."""
    return x.cpu().numpy() if hasattr(x, "cpu") else x
