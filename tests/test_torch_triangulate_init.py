"""Two-view geometry and the initializer: the port against the JAX package.

Inputs are made from a seed with numpy: a random 3-D scene (general or on
a plane, so that the fundamental and the homography branch both win once)
seen by two cameras with 0.5 px noise.  ``initialize`` gets the JAX
package's own RANSAC draws (``jax.random.choice`` over the same key), so
both fit the same hypotheses.

Tolerances: ``check_rt`` counts exact, parallax within 1e-3 deg, points
within 1e-4 relative, ``good`` equal on >= 99% of rows; ``initialize`` the
same ok / used_homography, R and t (same sign) within 1e-4, ``good`` equal
on >= 99% of rows (float32 SVDs of LAPACK and torch may differ in the last
bits); ``init_window_match`` integers exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orb_slam_tpu.config import InitializerConfig
from orb_slam_tpu.geometry import triangulate as jtri
from orb_slam_tpu.pipeline import track_kernels as jtk
from orb_slam_tpu.solvers import initializer as jinit
from orb_slam_tpu_torch.geometry import triangulate as ttri
from orb_slam_tpu_torch.pipeline import track_kernels as ttk
from orb_slam_tpu_torch.solvers import initializer as tinit
from smoke_world import rotmat
from torch_port_util import np_of, t_of

K = np.array([[500, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)


def _two_view(seed, planar=False, n=300):
    rng = np.random.default_rng(seed)
    if planar:
        X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                      np.full(n, 6.0)], 1)
    else:
        X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                      rng.uniform(4, 9, n)], 1)
    R = rotmat([0.1, 1, 0], np.radians(4.0)).astype(np.float32)
    t = np.array([-0.6, 0.05, 0.03], np.float32)

    def proj(Xc):
        return (Xc[:, :2] / Xc[:, 2:3]) * 500 + np.array([320, 240])

    xy1 = proj(X) + rng.normal(0, 0.5, (n, 2))
    xy2 = proj(X @ R.T + t) + rng.normal(0, 0.5, (n, 2))
    valid = rng.random(n) < 0.9
    return (xy1.astype(np.float32), xy2.astype(np.float32), valid, R,
            t / np.linalg.norm(t))


def _jax_samples(key, valid, cfg):
    w = jnp.asarray(valid).astype(jnp.float32)
    p = w / jnp.maximum(jnp.sum(w), 1.0)
    keys = jax.random.split(key, cfg.ransac_iterations)
    return np.array(jax.vmap(lambda k: jax.random.choice(
        k, valid.shape[0], shape=(cfg.sample_size,), replace=False,
        p=p))(keys))


def test_triangulate_dlt(rng):
    xy1, xy2, _, R, t = _two_view(3)
    P1 = np.asarray(jtri.projection_matrix(jnp.asarray(K), jnp.eye(3),
                                           jnp.zeros(3)))
    P2 = np.asarray(jtri.projection_matrix(jnp.asarray(K), jnp.asarray(R),
                                           jnp.asarray(t)))
    ref = np.asarray(jtri.triangulate_dlt(jnp.asarray(P1), jnp.asarray(P2),
                                          jnp.asarray(xy1), jnp.asarray(xy2)))
    got = np_of(ttri.triangulate_dlt(t_of(P1), t_of(P2), t_of(xy1),
                                     t_of(xy2)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        np_of(ttri.projection_matrix(t_of(K), t_of(R), t_of(t))), P2,
        rtol=1e-6)


def test_check_rt():
    xy1, xy2, valid, R, t = _two_view(4)
    jn, jX, jgood, jpar = jtri.check_rt(
        jnp.asarray(R), jnp.asarray(t), jnp.asarray(xy1), jnp.asarray(xy2),
        jnp.asarray(valid), jnp.asarray(K))
    tn, tX, tgood, tpar = ttri.check_rt(
        t_of(R), t_of(t), t_of(xy1), t_of(xy2), t_of(valid), t_of(K))
    assert int(tn) == int(jn) > 250
    assert abs(float(tpar) - float(jpar)) < 1e-3
    assert np.mean(np_of(tgood) == np.asarray(jgood)) >= 0.99
    np.testing.assert_allclose(np_of(tX), np.asarray(jX), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("planar", [False, True])
def test_initialize_with_jax_samples(planar):
    xy1, xy2, valid, R_gt, t_gt = _two_view(5, planar=planar)
    cfg = InitializerConfig()
    key = jax.random.PRNGKey(7)
    ref = jinit.initialize(key, jnp.asarray(xy1), jnp.asarray(xy2),
                           jnp.asarray(valid), jnp.asarray(K), cfg)
    samples = _jax_samples(key, valid, cfg)
    got = tinit.initialize(t_of(samples), t_of(xy1), t_of(xy2),
                           t_of(valid), t_of(K), cfg)
    assert bool(ref.ok) and bool(got.ok)
    assert bool(got.used_homography) == bool(ref.used_homography) == planar
    np.testing.assert_allclose(np_of(got.R), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(np_of(got.t), np.asarray(ref.t), atol=1e-4)
    assert np.mean(np_of(got.good) == np.asarray(ref.good)) >= 0.99
    # and both recover the true motion
    np.testing.assert_allclose(np_of(got.R), R_gt, atol=2e-2)
    assert float(np_of(got.t) @ t_gt) > 0.98


def test_draw_samples_distinct_valid_rows():
    valid = torch.from_numpy(np.random.default_rng(0).random(50) < 0.5)
    g = torch.Generator().manual_seed(3)
    s = tinit.draw_samples(g, valid, 200, 8).numpy()
    assert s.shape == (200, 8)
    assert valid.numpy()[s].all()
    assert all(len(set(row)) == 8 for row in s)
    g2 = torch.Generator().manual_seed(3)
    np.testing.assert_array_equal(tinit.draw_samples(g2, valid, 200, 8), s)


def test_init_window_match(rng):
    n = 256
    d1 = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    perm = rng.permutation(n)
    d2 = d1[perm].copy()
    flips = rng.integers(0, 32, (n, 3))
    for k in range(3):
        d2[np.arange(n), k] ^= (np.uint32(1) << flips[:, k].astype(np.uint32))
    xy1 = rng.uniform(20, 600, (n, 2)).astype(np.float32)
    xy2 = xy1[perm] + rng.normal(0, 5, (n, 2)).astype(np.float32)
    lv1 = (rng.random(n) < 0.2).astype(np.int32)
    lv2 = lv1[perm]
    a1 = rng.uniform(0, 6.28, n).astype(np.float32)
    a2 = (a1[perm] + rng.normal(0, 0.05, n)).astype(np.float32)
    v1 = rng.random(n) < 0.95
    v2 = v1[perm]
    kw = dict(radius=100.0, max_dist=50, ratio=0.9)
    ref = jtk.init_window_match(xy1, d1, lv1, a1, v1, xy2, d2, lv2, a2, v2,
                                **kw)
    got = ttk.init_window_match(
        t_of(xy1), t_of(d1.view(np.int32)), t_of(lv1).long(), t_of(a1),
        t_of(v1), t_of(xy2), t_of(d2.view(np.int32)), t_of(lv2).long(),
        t_of(a2), t_of(v2), **kw)
    assert int(np.sum(np.asarray(ref.valid))) > 150
    np.testing.assert_array_equal(np_of(got.valid), np.asarray(ref.valid))
    np.testing.assert_array_equal(np_of(got.idx), np.asarray(ref.idx))
    np.testing.assert_array_equal(np_of(got.dist), np.asarray(ref.dist))
