"""Motion-only pose LM of the port vs the JAX package on a well-conditioned
problem with planted outliers: the pose within 1e-4, the inlier set
identical.  The unrolled 6x6 Cholesky agrees to float32 rounding."""
import numpy as np
import jax.numpy as jnp

from orb_slam_tpu.config import CameraConfig as JCameraConfig, SolverConfig
from orb_slam_tpu.geometry import camera as jcam, se3 as jse3
from orb_slam_tpu.solvers import pose_opt as jpo
from orb_slam_tpu_torch.config import SolverConfig as TSolverConfig
from orb_slam_tpu_torch.solvers import pose_opt as tpo
from orb_slam_tpu_torch.state import camera_from_numpy
from torch_port_util import np_of, t_of


def test_chol_solve6(rng):
    A = rng.normal(0, 1, (6, 6)).astype(np.float32)
    A = (A @ A.T + 6 * np.eye(6)).astype(np.float32)
    b = rng.normal(0, 1, 6).astype(np.float32)
    x_t = np_of(tpo._chol_solve6(t_of(A), t_of(b)))
    x_j = np_of(jpo._chol_solve6(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(x_t, x_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(A @ x_t, b, atol=1e-4)


def test_optimize_pose_with_outliers(rng):
    jc = jcam.make_camera(JCameraConfig(
        fx=500.0, fy=500.0, cx=320.0, cy=240.0, k1=0.0, k2=0.0, p1=0.0,
        p2=0.0, k3=0.0, width=640, height=480))
    tc = camera_from_numpy({k: np.asarray(getattr(jc, k))
                            for k in jc._fields}, device="cpu")
    n = 300
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 9, n)], 1).astype(np.float32)
    R_true, t_true = jse3.exp(jnp.asarray(
        np.array([0.05, -0.02, 0.1, 0.01, -0.02, 0.015], np.float32)))
    xc = np_of(jse3.transform(R_true, t_true, jnp.asarray(X)))
    uv = np.stack([500 * xc[:, 0] / xc[:, 2] + 320,
                   500 * xc[:, 1] / xc[:, 2] + 240], 1)
    level = rng.integers(0, 4, n)
    inv_s2 = (1.0 / 1.44 ** level).astype(np.float32)
    uv = (uv + rng.normal(0, 0.5, uv.shape) * 1.2 ** level[:, None])
    outliers = rng.choice(n, 30, replace=False)
    uv[outliers] += rng.uniform(20, 60, (30, 2)) * rng.choice([-1, 1],
                                                              (30, 2))
    uv = uv.astype(np.float32)
    valid = np.ones(n, bool)
    valid[:5] = False
    R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)

    j = jpo.optimize_pose(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X),
                          jnp.asarray(uv), jnp.asarray(inv_s2),
                          jnp.asarray(valid), jc, SolverConfig())
    t = tpo.optimize_pose(t_of(R0), t_of(t0), t_of(X), t_of(uv),
                          t_of(inv_s2), t_of(valid), tc, TSolverConfig())
    np.testing.assert_allclose(np_of(t.R), np_of(j.R), atol=1e-4)
    np.testing.assert_allclose(np_of(t.t), np_of(j.t), atol=1e-4)
    np.testing.assert_array_equal(np_of(t.inliers), np_of(j.inliers))
    assert int(t.n_inliers) == int(j.n_inliers)
    assert not np_of(t.inliers)[outliers].any()
    np.testing.assert_allclose(np_of(t.t), np_of(t_true), atol=0.05)
