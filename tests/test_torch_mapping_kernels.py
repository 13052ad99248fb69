"""Keyframe-rate mapping compute: the port against the JAX package.

A small map is made from a seed with numpy: 4 keyframes along a sideways
path, 160 landmarks observed in slots 0..39 of each keyframe, and 24
unmapped points seen in the free slots 40..63 of every keyframe (what
triangulation finds); descriptors are per-point words with a few flipped
bits per observation.  Both packages get the same tables.

Tolerances: integer outputs exact (slots, ok masks, winning neighbours,
medoid descriptors, reference levels); positions, normals and distance
bands within rtol 1e-4 / atol 1e-5 (float32 SVD and scatter-sum order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import orb_slam_tpu.config as jc
import orb_slam_tpu_torch.config as tc
from orb_slam_tpu.geometry.camera import make_camera as jcam
from orb_slam_tpu.pipeline import mapping_kernels as jmk
from orb_slam_tpu_torch.geometry.camera import make_camera as tcam
from orb_slam_tpu_torch.pipeline import mapping_kernels as tmk
from smoke_world import rotmat
from torch_port_util import np_of, t_of

KF, N, P, NEW, L = 4, 64, 200, 24, 4
TOL = dict(rtol=1e-4, atol=1e-5)
CAM = dict(fx=500, fy=500, cx=320, cy=240, k1=0, k2=0, p1=0, p2=0, k3=0,
           width=640, height=480)


def _flip(rng, d, n_bits=2):
    d = d.copy()
    for _ in range(n_bits):
        w = rng.integers(0, 8, len(d))
        b = rng.integers(0, 32, len(d)).astype(np.uint32)
        d[np.arange(len(d)), w] ^= np.uint32(1) << b
    return d


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(17)
    X = np.stack([rng.uniform(-2.5, 2.5, P), rng.uniform(-1.8, 1.8, P),
                  rng.uniform(5, 9, P)], 1).astype(np.float32)
    Y = np.stack([rng.uniform(-2, 2, NEW), rng.uniform(-1.5, 1.5, NEW),
                  rng.uniform(5, 8, NEW)], 1).astype(np.float32)
    pdesc = rng.integers(0, 2**32, (P, 8), dtype=np.uint64).astype(np.uint32)
    ydesc = rng.integers(0, 2**32, (NEW, 8), dtype=np.uint64).astype(
        np.uint32)
    pang = rng.uniform(0, 6, P).astype(np.float32)
    yang = rng.uniform(0, 6, NEW).astype(np.float32)
    ylev = rng.integers(0, 2, NEW)
    K = np.array([[500, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    Rs = np.stack([rotmat([0, 1, 0], 0.02 * k) for k in range(KF)])
    ts = np.stack([np.array([-0.3 * k, 0.02 * k, 0.0], np.float32)
                   for k in range(KF)])
    xy = np.zeros((KF, N, 2), np.float32)
    lev = np.zeros((KF, N), np.int32)
    ang = np.zeros((KF, N), np.float32)
    desc = np.zeros((KF, N, 8), np.uint32)
    obs = np.full((KF, N), -1, np.int32)
    for k in range(KF):
        pid = rng.choice(160, 40, replace=False)
        pts = np.concatenate([X[pid], Y])
        xc = pts @ Rs[k].T + ts[k]
        xy[k] = (xc[:, :2] / xc[:, 2:3] * 500 + [320, 240]
                 + rng.normal(0, 0.3, (N, 2)))
        lev[k] = np.concatenate([rng.integers(0, L, 40), ylev])
        ang[k] = np.concatenate([pang[pid], yang]) + rng.normal(0, 0.02, N)
        desc[k] = _flip(rng, np.concatenate([pdesc[pid], ydesc]))
        obs[k, :40] = pid
    mp_valid = np.arange(P) < 160
    mp_ref = np.where(mp_valid, rng.integers(0, KF, P), -1).astype(np.int32)
    # a point's reference keyframe must observe it for a finite band
    for p in range(160):
        seen = np.where((obs == p).any(axis=1))[0]
        mp_ref[p] = seen[0] if len(seen) else -1
    return dict(
        kf_xy=xy, kf_desc=desc, kf_level=lev, kf_angle=ang,
        kf_kp_valid=np.ones((KF, N), bool), kf_obs=obs,
        kf_R=Rs.astype(np.float32), kf_t=ts, kf_valid=np.ones(KF, bool),
        mp_pos=(X + rng.normal(0, 0.01, X.shape)).astype(np.float32),
        mp_desc=pdesc, mp_valid=mp_valid, mp_ref_kf=mp_ref, K=K,
        sigma2=np.asarray(tc.ExtractorConfig(n_levels=L).sigma2, np.float32))


def _j(w, name):
    return jnp.asarray(w[name])


def _t(w, name):
    a = w[name]
    if name.endswith("desc"):
        a = a.view(np.int32)
    if name in ("kf_level",):
        a = a.astype(np.int64)
    return t_of(a)


def test_point_stats_and_medoid(world):
    w = world
    names = ("kf_obs", "kf_R", "kf_t", "kf_level", "kf_valid", "mp_pos",
             "mp_valid", "mp_ref_kf")
    jn, jmin, jmax, jdesc = jmk.point_stats_and_medoid(
        *(_j(w, n) for n in names), _j(w, "kf_desc"), _j(w, "mp_desc"),
        np.int32(2), n_levels=L, scale_factor=1.2)
    tn, tmin, tmax, tdesc = tmk.point_stats_and_medoid(
        *(_t(w, n) for n in names), _t(w, "kf_desc"), _t(w, "mp_desc"), 2,
        n_levels=L, scale_factor=1.2)
    np.testing.assert_allclose(np_of(tn), np.asarray(jn), **TOL)
    np.testing.assert_allclose(np_of(tmin), np.asarray(jmin), **TOL)
    np.testing.assert_allclose(np_of(tmax), np.asarray(jmax), **TOL)
    np.testing.assert_array_equal(np_of(tdesc).view(np.uint32),
                                  np.asarray(jdesc))
    assert (np.asarray(jdesc) != w["mp_desc"]).any()   # medoids moved


def test_medoid_descriptors(rng):
    base = rng.integers(0, 2**32, (30, 1, 8), dtype=np.uint64).astype(
        np.uint32)
    sets = np.repeat(base, 6, axis=1)
    for m in range(6):
        sets[:, m] = _flip(rng, sets[:, m], n_bits=int(rng.integers(0, 6)))
    valid = rng.random((30, 6)) < 0.7
    valid[0] = False
    jb, jh = jmk.medoid_descriptors(jnp.asarray(sets), jnp.asarray(valid))
    tb, th = tmk.medoid_descriptors(t_of(sets.view(np.int32)), t_of(valid))
    np.testing.assert_array_equal(np_of(th), np.asarray(jh))
    np.testing.assert_array_equal(np_of(tb).view(np.uint32)[np_of(th)],
                                  np.asarray(jb)[np.asarray(jh)])


def test_triangulate_between(world):
    w = world
    jcam_, tcam_ = jcam(jc.CameraConfig(**CAM)), tcam(tc.CameraConfig(**CAM),
                                                      device="cpu")
    s2 = w["sigma2"]

    def args(pkg_t, a, b):
        conv = _t if pkg_t else _j
        free = (w["kf_kp_valid"] & (w["kf_obs"] < 0))
        lv = w["kf_level"]
        out = []
        for k in (a, b):
            out += [conv(w, "kf_xy")[k], conv(w, "kf_desc")[k],
                    conv(w, "kf_level")[k], conv(w, "kf_angle")[k],
                    (t_of(free[k]) if pkg_t else jnp.asarray(free[k]))]
        out += [conv(w, "kf_R")[a], conv(w, "kf_t")[a], conv(w, "kf_R")[b],
                conv(w, "kf_t")[b]]
        s2a, s2b = s2[lv[a]], s2[lv[b]]
        out += ([t_of(s2a), t_of(s2b)] if pkg_t
                else [jnp.asarray(s2a), jnp.asarray(s2b)])
        out += [conv(w, "K"), tcam_ if pkg_t else jcam_]
        return out

    ref = jmk.triangulate_between(*args(False, 0, 2))
    got = tmk.triangulate_between(*args(True, 0, 2))
    ok = np.asarray(ref.ok)
    assert ok.sum() >= 15
    np.testing.assert_array_equal(np_of(got.ok), ok)
    np.testing.assert_array_equal(np_of(got.slot2), np.asarray(ref.slot2))
    np.testing.assert_allclose(np_of(got.X)[ok], np.asarray(ref.X)[ok],
                               **TOL)


def test_triangulate_multi(world):
    w = world
    jcam_, tcam_ = jcam(jc.CameraConfig(**CAM)), tcam(tc.CameraConfig(**CAM),
                                                      device="cpu")
    tables = ("kf_xy", "kf_desc", "kf_level", "kf_angle", "kf_kp_valid",
              "kf_obs", "kf_R", "kf_t")
    nb = np.array([2, 1, 3], np.int32)
    ref = jmk.triangulate_multi(
        np.int32(0), np.concatenate([nb, np.zeros(2, np.int32)]),
        np.array([True] * 3 + [False] * 2), *(_j(w, n) for n in tables),
        jnp.asarray(w["sigma2"]), _j(w, "K"), jcam_)
    got = tmk.triangulate_multi(0, t_of(nb.astype(np.int64)),
                                *(_t(w, n) for n in tables),
                                t_of(w["sigma2"]), _t(w, "K"), tcam_)
    rb, gb = np.asarray(ref.blob), np_of(got.blob)
    ok = rb[:, 0] > 0
    assert ok.sum() >= 15
    np.testing.assert_array_equal(gb[:, 0], rb[:, 0])
    np.testing.assert_array_equal(gb[ok, 4:], rb[ok, 4:])
    np.testing.assert_allclose(gb[ok, 1:4], rb[ok, 1:4], **TOL)


def test_fuse_tables(world):
    w = world
    jcam_, tcam_ = jcam(jc.CameraConfig(**CAM)), tcam(tc.CameraConfig(**CAM),
                                                      device="cpu")
    tables = ("kf_xy", "kf_desc", "kf_level", "kf_kp_valid", "kf_R", "kf_t")
    M = 60
    sels, cvs = [], []
    for target in (1, 3):
        # the points the keyframe sees (found again at their slots) and
        # points it does not see
        own = w["kf_obs"][target][:40]
        rest = np.array([p for p in range(160) if p not in set(own)])
        cand = np.concatenate([own, rest[:M - 40]]).astype(np.int32)
        sels.append(cand)
        cv = np.ones(M, bool)
        cv[[3, 50]] = False
        cvs.append(cv)
    sels, cvs = np.stack(sels), np.stack(cvs)
    ref1 = jmk.fuse_into_keyframe_tables(
        *(_j(w, n) for n in tables), np.int32(1),
        jnp.asarray(w["kf_obs"][1]), _j(w, "mp_pos"), _j(w, "mp_desc"),
        jnp.asarray(sels[0]), jnp.asarray(cvs[0]), jnp.asarray(w["sigma2"]),
        jcam_, np.float32(30.0), np.int32(128))
    got1 = tmk.fuse_into_keyframe_tables(
        *(_t(w, n) for n in tables), 1, _t(w, "mp_pos"), _t(w, "mp_desc"),
        t_of(sels[0].astype(np.int64)), t_of(cvs[0]), t_of(w["sigma2"]),
        tcam_, 30.0, 128)
    assert np.asarray(ref1)[:, 1].sum() >= 20
    np.testing.assert_array_equal(np_of(got1), np.asarray(ref1))
    refm = jmk.fuse_into_keyframe_tables_multi(
        *(_j(w, n) for n in tables), np.array([1, 3], np.int32),
        jnp.asarray(w["kf_obs"][[1, 3]]), _j(w, "mp_pos"), _j(w, "mp_desc"),
        jnp.asarray(sels), jnp.asarray(cvs), jnp.asarray(w["sigma2"]),
        jcam_, np.float32(30.0), np.int32(128))
    gotm = tmk.fuse_into_keyframe_tables_multi(
        *(_t(w, n) for n in tables), t_of(np.array([1, 3])),
        _t(w, "mp_pos"), _t(w, "mp_desc"), t_of(sels.astype(np.int64)),
        t_of(cvs), t_of(w["sigma2"]), tcam_, 30.0, 128)
    np.testing.assert_array_equal(np_of(gotm), np.asarray(refm))


def test_fundamental_from_poses(world):
    w = world
    ref = jmk.fundamental_from_poses(_j(w, "kf_R")[0], _j(w, "kf_t")[0],
                                     _j(w, "kf_R")[2], _j(w, "kf_t")[2],
                                     _j(w, "K"))
    got = tmk.fundamental_from_poses(_t(w, "kf_R")[0], _t(w, "kf_t")[0],
                                     _t(w, "kf_R")[2], _t(w, "kf_t")[2],
                                     _t(w, "K"))
    np.testing.assert_allclose(np_of(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-9)
