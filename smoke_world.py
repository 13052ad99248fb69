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


# ---------------------------------------------------------------------------
# a scripted loop revisit for the loop closer (no rendering)

REVISIT_QUERY = 13          # the keyframe whose loop is checked
REVISIT_MATCH = 3           # the early keyframe it re-observes
# one keyframe per gate of the check, each failing that gate alone
REVISIT_DECOYS = {"matches": 4, "ransac": 5, "refine": 6, "guided": 7}
DRIFT_SCALE = 1.3
REFINE_SHIFT_PX = 2.8       # the refine decoy's pixel offsets


def _flip_bits(rng, desc, n_bits):
    """desc [M, 8] uint32 with n_bits distinct random bits flipped per
    row."""
    bits = np.argsort(rng.random((len(desc), 256)), axis=1)[:, :n_bits]
    out = desc.copy()
    rows = np.repeat(np.arange(len(desc)), n_bits)
    np.bitwise_xor.at(out, (rows, (bits // 32).ravel()),
                      (np.uint32(1) << (bits % 32).astype(np.uint32)).ravel())
    return out


def _rand_desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)


def revisit_map(rng, n_slots, n_a, n_b, K, width=640, height=480,
                outlier_fraction=0.4, n_levels=3):
    """A map of 14 keyframes whose last one closes a loop, as numpy rows for
    ``SlamMap.add_points`` / ``add_keyframe``.

    Keyframes 0-3 see scene A (n_a landmarks; each observes 80% of those in
    view), 4-9 a chain over scene B (n_b landmarks in a sliding window),
    10-13 revisit 0-3 (3 degrees and 0.73 units off their poses) in a map
    that drifted by the Sim3 D (scale DRIFT_SCALE, 3.4 degrees, a
    translation): they observe new landmarks, D's images of 75% of scene A
    in view, `outlier_fraction` of them displaced by 1-3 units (wrong
    positions).  Every keyframe's slot descriptors are independent random
    words, except that a revisit keyframe's slot of a copy carries the
    descriptor of its original's slot in keyframe k - 10 with 3 bits
    flipped; scene A's landmark descriptors are keyframe 3's.  So BoW
    detection finds 1, 2, 3 from 11, 12, 13 and no neighbour scores high.

    Keyframe 13 also holds three groups of slots for the decoys 5-7 (B
    keyframes with extra slots on landmarks only they observe, paired with
    landmarks only 13 observes, descriptors 2 bits apart): 24 pairs with
    unrelated positions (RANSAC finds no Sim3); 22 pairs exact under a Sim3
    g0 at level 0, whose pixels in 13 are shifted sideways by
    REFINE_SHIFT_PX, 19 one way, 3 (beside 3 of the 19) the other: every
    pair is within RANSAC's 9.21 px^2 of g0, but the refinement, pulled by
    the 19, pushes the 3 past its 10 px^2 and keeps 19 < 20; and 28 exact
    pairs whose landmarks are the only ones the
    guided count can match (28 < 40).  Keyframe 4 matches nothing.

    Returns dict(points=dict(pos, desc, ref_kf), kfs=[dict(R, t, xy,
    level, angle, desc, kp_valid, obs)], g12=(s, R, t) of 13 against 3,
    pairs=the number of landmarks 3 and 13 both observe, guided_g12=the
    guided decoy's Sim3, true=[(R, t)] every keyframe's true world->camera
    pose, float64; keyframes 0-9 are mapped at theirs)."""
    K = np.asarray(K, np.float64)
    fx, cx, cy = K[0, 0], K[0, 2], K[1, 2]
    n_kf, margin = 14, 8.0

    def proj(Xc):
        return np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx,
                         K[1, 1] * Xc[:, 1] / Xc[:, 2] + cy], 1)

    def in_view(Xc):
        uv = proj(Xc)
        return ((Xc[:, 2] > 0.5) & (uv[:, 0] >= margin)
                & (uv[:, 0] < width - margin) & (uv[:, 1] >= margin)
                & (uv[:, 1] < height - margin))

    def cam_points(n, half_u, half_v, z_lo, z_hi):
        z = rng.uniform(z_lo, z_hi, n)
        return np.stack([rng.uniform(-half_u, half_u, n) * z,
                         rng.uniform(-half_v, half_v, n) * z, z], 1)

    # true world->camera poses
    true = []
    for k in range(n_kf):
        if k < 4:
            R = rotmat([0, 1, 0], 0.03 * k).astype(np.float64)
            C = np.array([0.25 * k, 0.0, 0.0])
        elif k < 10:
            R = rotmat([0, 1, 0], 1.2 + 0.02 * (k - 4)).astype(np.float64)
            C = np.array([3.0 + 0.1 * (k - 4), 0.0, 1.0])
        else:
            Rj, tj = true[k - 10]
            R = rotmat([0.3, 1.0, 0.2], 0.05).astype(np.float64) @ Rj
            C = -Rj.T @ tj + np.array([0.6, 0.1, -0.4])
        true.append((R, -R @ C))
    # the drift D and the revisit keyframes' poses in the drifted map
    sD, RD = DRIFT_SCALE, rotmat([0.2, 1.0, 0.1], 0.06).astype(np.float64)
    tD = np.array([0.4, -0.2, 0.3])
    poses = [true[k] if k < 10 else
             (true[k][0] @ RD.T, sD * true[k][1] - true[k][0] @ RD.T @ tD)
             for k in range(n_kf)]

    pos, pdesc, pref = [], [], []

    def new_points(Xw, ref, desc=None):
        first = sum(len(p) for p in pos)
        pos.append(np.asarray(Xw, np.float64))
        pdesc.append(_rand_desc(rng, len(Xw)) if desc is None else desc)
        pref.append(np.full(len(Xw), ref, np.int32))
        return first + np.arange(len(Xw))

    def world(Xc, k):
        R, t = poses[k]
        return (Xc - t) @ R

    # scene A and its drifted copies
    XA = np.stack([rng.uniform(-1.5, 2.2, n_a), rng.uniform(-1.2, 1.2, n_a),
                   rng.uniform(5.0, 9.0, n_a)], 1)
    ida = new_points(XA, 0)
    XA2 = sD * XA @ RD.T + tD
    bad = rng.random(n_a) < outlier_fraction
    XA2[bad] += rng.uniform(1.0, 3.0, (int(bad.sum()), 3))
    idc = new_points(XA2, 10)

    # observations: (point ids, true camera coordinates) per keyframe
    obs = [[] for _ in range(n_kf)]          # (ids, pixels, desc, level)
    desc_of = [dict() for _ in range(n_kf)]  # keyframe -> {point: desc}
    sigma_px = 0.3

    def observe(k, ids, Xw_true, desc=None, level=None, noise=sigma_px,
                uv=None):
        R, t = true[k]
        Xc = Xw_true @ R.T + t
        if uv is None:
            uv = proj(Xc) + rng.normal(0, noise, (len(ids), 2))
        d = _rand_desc(rng, len(ids)) if desc is None else desc
        lv = (rng.integers(0, n_levels, len(ids)) if level is None
              else np.full(len(ids), level))
        obs[k].append((np.asarray(ids), uv, d, lv))
        desc_of[k].update(zip(np.asarray(ids).tolist(), d))

    for k in range(4):
        R, t = true[k]
        vis = in_view(XA @ R.T + t) & (rng.random(n_a) < 0.8)
        observe(k, ida[vis], XA[vis])
    for k in range(10, 14):
        R, t = true[k]
        vis = np.flatnonzero(in_view(XA @ R.T + t)
                             & (rng.random(n_a) < 0.75))
        src = desc_of[k - 10]
        d = np.stack([src[int(ida[i])] if int(ida[i]) in src
                      else _rand_desc(rng, 1)[0] for i in vis])
        has = np.array([int(ida[i]) in src for i in vis])
        d[has] = _flip_bits(rng, d[has], 3)
        observe(k, idc[vis], XA[vis], desc=d)
    # scene A's landmark descriptors: keyframe 3's slots
    da = pdesc[0]
    for j, p in enumerate(ida):
        if int(p) in desc_of[3]:
            da[j] = desc_of[3][int(p)]

    # the decoys: landmarks seen only by keyframe d, paired with landmarks
    # seen only by keyframe 13
    q = REVISIT_QUERY

    def decoy(d, X2, X1, uv1=None, level=None, guided=False):
        dd = _rand_desc(rng, len(X2))
        p2 = new_points(world(X2, d), d, dd if guided else None)
        p1 = new_points(world(X1, q), q)
        observe(d, p2, world_true(X2, d), desc=dd, level=level,
                noise=0.0 if level is not None else sigma_px)
        observe(q, p1, world_true(X1, q), desc=_flip_bits(rng, dd, 2),
                level=level, uv=uv1,
                noise=0.0 if level is not None else sigma_px)

    def world_true(Xc, k):
        R, t = true[k]
        s = sD if k >= 10 else 1.0
        return (Xc / s - t) @ R

    def sim3_apply(s, R, t, X):
        return s * X @ R.T + t

    # RANSAC decoy: unrelated positions
    decoy(REVISIT_DECOYS["ransac"], cam_points(24, 0.4, 0.3, 3.0, 8.0),
          cam_points(24, 0.4, 0.3, 3.0, 8.0))
    # refine decoy: exact under g0, pixels in 13 shifted sideways
    X2 = cam_points(19, 0.3, 0.25, 4.0, 7.0)
    X2 = np.concatenate([X2, X2[:3] + rng.normal(0, 0.02, (3, 3))])
    g0 = (1.1, rotmat([0.3, 1.0, 0.0], 0.02).astype(np.float64),
          np.array([0.1, -0.05, 0.8]))
    X1 = sim3_apply(*g0, X2)
    uv1 = proj(X1)
    uv1[:19, 0] += REFINE_SHIFT_PX
    uv1[19:, 0] -= REFINE_SHIFT_PX
    decoy(REVISIT_DECOYS["refine"], X2, X1, uv1=uv1, level=0)
    # guided decoy: exact pairs, too few to reach min_total_matches
    X2 = cam_points(28, 0.4, 0.3, 3.0, 8.0)
    gg = (0.9, rotmat([1.0, 0.5, 0.0], 0.03).astype(np.float64),
          np.array([-0.4, 0.2, 0.6]))
    decoy(REVISIT_DECOYS["guided"], X2, sim3_apply(*gg, X2), guided=True)
    ret_gg = tuple(np.asarray(x, np.float32) for x in gg)

    # scene B, in front of keyframe 6 (its ids after the decoys', so a
    # neighbourhood cut to local_ba_max_points keeps the decoys' landmarks)
    R6, t6 = true[6]
    XB = (cam_points(n_b, 0.45, 0.35, 4.0, 8.0) - t6) @ R6
    idb = new_points(XB, 4)
    for k in range(4, 10):
        R, t = true[k]
        lo = (k - 4) * n_b // 12
        win = np.zeros(n_b, bool)
        win[lo:lo + n_b // 2] = True
        vis = in_view(XB @ R.T + t) & win
        observe(k, idb[vis], XB[vis])

    # slot layout
    kfs = []
    for k in range(n_kf):
        ids = np.concatenate([o[0] for o in obs[k]]).astype(np.int32)
        n = len(ids)
        if n > n_slots:
            raise ValueError(f"keyframe {k}: {n} observations > {n_slots}")
        slots = rng.permutation(n_slots)
        xy = rng.uniform([0, 0], [width, height], (n_slots, 2))
        level = rng.integers(0, n_levels, n_slots)
        desc = _rand_desc(rng, n_slots)
        kp_valid = rng.random(n_slots) < 0.5
        o = np.full(n_slots, -1, np.int32)
        at = slots[:n]
        xy[at] = np.concatenate([x[1] for x in obs[k]])
        desc[at] = np.concatenate([x[2] for x in obs[k]])
        level[at] = np.concatenate([x[3] for x in obs[k]])
        kp_valid[at] = True
        o[at] = ids
        R, t = poses[k]
        kfs.append(dict(R=R.astype(np.float32), t=t.astype(np.float32),
                        xy=xy.astype(np.float32),
                        level=level.astype(np.int32),
                        angle=rng.uniform(0, 6.28, n_slots).astype(
                            np.float32),
                        desc=desc, kp_valid=kp_valid, obs=o))
    Rq, tq = true[q]
    Rm, tm = true[REVISIT_MATCH]
    Rg = Rq @ Rm.T
    both = np.intersect1d(kfs[REVISIT_MATCH]["obs"], ida)
    n_pairs = int(np.isin(idc[np.searchsorted(ida, both)],
                          kfs[q]["obs"]).sum())
    return dict(
        points=dict(pos=np.concatenate(pos).astype(np.float32),
                    desc=np.concatenate(pdesc),
                    ref_kf=np.concatenate(pref)),
        kfs=kfs, pairs=n_pairs, guided_g12=ret_gg, true=true,
        g12=(np.float32(sD), Rg.astype(np.float32),
             (sD * (tq - Rg @ tm)).astype(np.float32)))
