"""EPnP and PnP RANSAC on the CPU: the port's batched solvers against the
JAX package's vmapped ones, with the JAX package's RANSAC draws injected.

Tolerances, and why:
  - EPnP on 64 well-conditioned 6-point sets (noise-free, the camera 3-6
    units from the world origin, 5-30 degree rotations): poses within
    POSE_TOL (rotation Frobenius, translation relative to the JAX
    package's); measured <= 4.6e-5;
  - 4-point sets: not compared pose by pose.  At n = 4 the 8 x 12 system
    has a 4-dimensional null space, all its eigenvalues numerically zero,
    and the hypothesis depends on which orthonormal basis of it the eigh
    returns (LAPACK builds differ: measured median 0.6 Frobenius apart on
    noise-free sets, each package ~0.1 from the truth).  What is held: each
    4-point hypothesis is a rotation with a finite translation in both
    packages, and the RANSAC consensus over 4-point sets below;
  - a 512-sample batch with degenerate members (repeated points, collinear
    points, points at the origin, a NaN coordinate): the well-conditioned
    members within POSE_TOL; a degenerate member scores at most the one
    inlier of its own point in both packages (measured: 0 or 1 in each),
    and points at the origin or a NaN give JAX's fallback pose in both
    (torch's eigh and SVD would raise on the NaN; the port zeroes such a
    sample before them and marks its result NaN);
  - pnp_ransac with JAX's samples: the same ok, inlier count and inlier
    mask; the 6-point DLT pose within POSE_TOL; for EPnP the pose refined by
    each package's pose LM over its inliers within POSE_TOL.  The raw EPnP
    RANSAC pose is not compared: many hypotheses reach the top count, and
    which is first depends on ulp-level differences of ill-conditioned
    solves (measured up to 3.8e-3 Frobenius apart at equal counts);
  - the three cases of tests/test_pnp.py on the port alone, with its own
    draws.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orb_slam_tpu.solvers import pnp as jpnp
from orb_slam_tpu.solvers import pose_opt as jpose
from orb_slam_tpu.geometry.camera import make_camera as jcam
from orb_slam_tpu.solvers.epnp import epnp as jepnp
import orb_slam_tpu.config as jc
import orb_slam_tpu_torch.config as tc
from orb_slam_tpu_torch.geometry.camera import make_camera as tcam
from orb_slam_tpu_torch.solvers import pnp as tpnp
from orb_slam_tpu_torch.solvers import pose_opt as tpose
from orb_slam_tpu_torch.solvers.epnp import epnp as tepnp
from synthetic import default_K, make_scene, rotmat
from test_pnp import setup
from torch_port_util import np_of, t_of

POSE_TOL = 1e-4
K = default_K()


def jax_samples(key, valid, n_samples, min_set):
    """The JAX package's draws (solvers/pnp.py:89-92)."""
    n = valid.shape[0]
    w = jnp.asarray(valid).astype(jnp.float32)
    p = w / jnp.maximum(jnp.sum(w), 1.0)
    keys = jax.random.split(key, n_samples)
    return np.array(jax.vmap(lambda k: jax.random.choice(
        k, n, shape=(min_set,), replace=False, p=p))(keys))


def problems(rng, S, n):
    """S well-conditioned noise-free n-point problems: [S, n, 3], [S, n, 2]."""
    Xs, uvs = [], []
    for _ in range(S):
        X = make_scene(rng, n)
        R = rotmat(rng.normal(size=3), np.radians(rng.uniform(5, 30)))
        t = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1),
                      rng.uniform(3, 6)], np.float32)
        xc = X @ R.T + t
        uvs.append(np.stack([500 * xc[:, 0] / xc[:, 2] + 320,
                             500 * xc[:, 1] / xc[:, 2] + 240], 1))
        Xs.append(X)
    return (np.stack(Xs).astype(np.float32),
            np.stack(uvs).astype(np.float32))


def both_epnp(Xs, uvs):
    jR, jt = jax.vmap(lambda a, b: jepnp(a, b, jnp.asarray(K)))(
        jnp.asarray(Xs), jnp.asarray(uvs))
    tR, tt = tepnp(t_of(Xs), t_of(uvs), t_of(K))
    return np.asarray(jR), np.asarray(jt), np_of(tR), np_of(tt)


def apart(jR, jt, tR, tt):
    """(rotation Frobenius, translation relative to JAX's) per sample."""
    return (np.linalg.norm(jR - tR, axis=(-2, -1)),
            np.linalg.norm(jt - tt, axis=-1) / np.linalg.norm(jt, axis=-1))


def test_epnp_six_point_sets_match_jax():
    Xs, uvs = problems(np.random.default_rng(0), 64, 6)
    dR, dt = apart(*both_epnp(Xs, uvs))
    assert dR.max() <= POSE_TOL and dt.max() <= POSE_TOL, (dR.max(),
                                                           dt.max())


def test_epnp_four_point_hypotheses_are_rotations():
    Xs, uvs = problems(np.random.default_rng(1), 64, 4)
    poses = both_epnp(Xs, uvs)
    for R, t in (poses[:2], poses[2:]):
        assert np.isfinite(R).all() and np.isfinite(t).all()
        np.testing.assert_allclose(R @ np.swapaxes(R, 1, 2),
                                   np.broadcast_to(np.eye(3), R.shape),
                                   atol=1e-5)
        np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)


def _inlier_counts(R, t, X, uv):
    xc = np.einsum("sij,nj->sni", R, X) + t[:, None]
    z = xc[..., 2]
    zi = 1.0 / np.maximum(z, 1e-6)
    u = xc[..., 0] * zi * K[0, 0] + K[0, 2]
    v = xc[..., 1] * zi * K[1, 1] + K[1, 2]
    c2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
    with np.errstate(invalid="ignore"):
        return ((z > 0) & (c2 <= 5.991)).sum(axis=1)


def test_epnp_batch_with_degenerate_members():
    """512 6-point samples of one scene, a third of them degenerate: the
    same point six times, six collinear points, six points at the origin,
    a NaN coordinate.  The others match JAX within POSE_TOL.  In both
    packages no degenerate hypothesis scores more than the one inlier its
    own point can give (far below min_inliers), points at the origin give
    JAX's fallback pose (identity, zero: no beta case is finite), and a NaN
    input gives the same fallback instead of an error."""
    rng = np.random.default_rng(2)
    X = make_scene(rng, 200)
    R = rotmat([0.3, 1.0, -0.2], np.radians(25.0))
    t = np.array([0.5, -0.3, 4.0], np.float32)
    xc = X @ R.T + t
    uv = np.stack([500 * xc[:, 0] / xc[:, 2] + 320,
                   500 * xc[:, 1] / xc[:, 2] + 240], 1).astype(np.float32)
    idx = np.stack([rng.choice(200, 6, replace=False) for _ in range(512)])
    Xs, uvs = X[idx], uv[idx]
    kind = np.full(512, -1)
    kind[::3] = np.arange(0, 512, 3) // 3 % 4
    for s in np.where(kind == 0)[0]:
        Xs[s], uvs[s] = Xs[s, :1], uvs[s, :1]       # one point, six times
    for s in np.where(kind == 1)[0]:
        a, b = X[idx[s, 0]], X[idx[s, 1]]
        Xs[s] = a + np.linspace(0, 1, 6)[:, None] * (b - a)
    Xs[kind == 2] = 0.0
    Xs[kind == 3, 2, 1] = np.nan
    jR, jt, tR, tt = both_epnp(Xs, uvs)
    good = kind < 0
    dR, dt = apart(jR, jt, tR, tt)
    assert dR[good].max() <= POSE_TOL and dt[good].max() <= POSE_TOL, (
        dR[good].max(), dt[good].max())
    for R_, t_ in ((jR, jt), (tR, tt)):
        counts = _inlier_counts(R_, t_, X, uv)
        assert (counts[good] == 200).all()
        assert counts[~good].max() <= 1
        fallback = kind >= 2
        np.testing.assert_allclose(R_[fallback],
                                   np.broadcast_to(np.eye(3), (
                                       fallback.sum(), 3, 3)), atol=1e-6)
        np.testing.assert_allclose(t_[fallback], 0.0, atol=1e-6)


def _cam_cfg(mod):
    """default_K's camera, without distortion."""
    return mod.CameraConfig(fx=500, fy=500, cx=320, cy=240, k1=0, k2=0,
                            p1=0, p2=0, k3=0, width=640, height=480)


def _refined(res, X, uv, valid, pkg):
    """The RANSAC pose refined over its inliers by the package's pose LM,
    as the tracker does (Tracking.cc:958-980)."""
    if pkg == "jax":
        r = jpose.optimize_pose(res.R, res.t, jnp.asarray(X), jnp.asarray(uv),
                                jnp.ones(len(X)),
                                jnp.asarray(valid) & res.inliers,
                                jcam(_cam_cfg(jc)), jc.SolverConfig())
    else:
        r = tpose.optimize_pose(res.R, res.t, t_of(X), t_of(uv),
                                torch.ones(len(X)),
                                t_of(valid) & res.inliers,
                                tcam(_cam_cfg(tc), device="cpu"),
                                tc.SolverConfig())
    return np_of(r.R), np_of(r.t)


@pytest.mark.parametrize("solver,min_set", [("epnp", 4), ("epnp", 6),
                                            ("p6p", 6)])
@pytest.mark.parametrize("seed", [0, 1])
def test_pnp_ransac_with_jax_samples(solver, min_set, seed):
    rng = np.random.default_rng(seed)
    X, uv, R_gt, t_gt, _, is_out = setup(rng)
    valid = rng.random(len(X)) >= 0.1
    key = jax.random.PRNGKey(seed)
    j = jpnp.pnp_ransac(key, jnp.asarray(X), jnp.asarray(uv),
                        jnp.ones(len(X)), jnp.asarray(valid), jnp.asarray(K),
                        n_samples=512, min_set=min_set, solver=solver)
    samples = jax_samples(key, valid, 512, min_set)
    t = tpnp.pnp_ransac(t_of(X), t_of(uv), torch.ones(len(X)), t_of(valid),
                        t_of(K), n_samples=512, min_set=min_set,
                        solver=solver, samples=torch.from_numpy(samples))
    assert bool(t.ok) == bool(j.ok) and bool(t.ok)
    assert int(t.n_inliers) == int(j.n_inliers)
    np.testing.assert_array_equal(np_of(t.inliers), np.asarray(j.inliers))
    assert not np_of(t.inliers)[~valid].any()
    if solver == "p6p":
        pose_j, pose_t = (np.asarray(j.R), np.asarray(j.t)), (np_of(t.R),
                                                             np_of(t.t))
    else:
        pose_j = _refined(j, X, uv, valid, "jax")
        pose_t = _refined(t, X, uv, valid, "port")
    dR, dt = apart(pose_j[0], pose_j[1], pose_t[0], pose_t[1])
    assert dR <= POSE_TOL and dt <= POSE_TOL, (dR, dt)


def _port_ransac(X, uv, valid, seed, **kw):
    gen = torch.Generator().manual_seed(seed)
    return tpnp.pnp_ransac(t_of(X), t_of(uv), torch.ones(len(X)),
                           t_of(valid), t_of(K), generator=gen, **kw)


def test_port_recovers_pose_with_outliers(rng):
    """tests/test_pnp.py::test_recovers_pose_with_outliers on the port, with
    its own draws."""
    X, uv, R_gt, t_gt, _, is_out = setup(rng)
    res = _port_ransac(X, uv, np.ones(len(X), bool), 0)
    assert bool(res.ok)
    dR = np_of(res.R) @ R_gt.T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 1.0
    assert np.linalg.norm(np_of(res.t) - t_gt) < 0.05
    inl = np_of(res.inliers)
    assert inl[is_out].mean() < 0.05 and inl[~is_out].mean() > 0.8


def test_port_fails_gracefully_all_outliers(rng):
    X, uv, *_ = setup(rng, outlier_frac=1.0)
    res = _port_ransac(X, uv, np.ones(len(X), bool), 0, min_inliers=20)
    assert not bool(res.ok)


def test_port_respects_valid_mask(rng):
    X, uv, *_ = setup(rng, outlier_frac=0.0)
    valid = np.arange(len(X)) < 30
    res = _port_ransac(X, uv, valid, 1)
    assert not np_of(res.inliers)[~valid].any()
    assert bool(res.ok)


def test_draw_samples():
    """Distinct valid rows per sample, the same draws from the same seed."""
    valid = np.zeros(50, bool)
    valid[[3, 7, 8, 20, 31, 40, 41, 49]] = True
    a = tpnp.draw_samples(torch.Generator().manual_seed(5), valid, 256, 4)
    b = tpnp.draw_samples(torch.Generator().manual_seed(5),
                          torch.from_numpy(valid), 256, 4)
    assert a.shape == (256, 4) and a.dtype == torch.int64
    assert torch.equal(a, b)
    s = a.numpy()
    assert valid[s].all()
    assert all(len(set(row)) == 4 for row in s)
    assert len(np.unique(s)) == valid.sum()       # every valid row drawn
