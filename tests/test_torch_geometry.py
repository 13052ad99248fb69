"""se3 and camera of the port vs the JAX package (float32 on the CPU).
Tolerance: 1e-6 absolute for rotations and unit-scale values, 1e-4 px for
pixel coordinates (float32 rounding of a few ops at ~1e3 magnitude)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam_tpu.config import CameraConfig as JCameraConfig
from orb_slam_tpu.config import tum_freiburg1_config as j_fr1
from orb_slam_tpu.geometry import camera as jcam, se3 as _jse3
from orb_slam_tpu_torch.config import CameraConfig, tum_freiburg1_config
from orb_slam_tpu_torch.geometry import camera as tcam, se3 as tse3
from torch_port_util import np_of, t_of


class _Jitted:
    """A JAX module's functions, each compiled once, as the package runs
    them inside its jitted steps (op-by-op dispatch is the slow part of
    these tests)."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        f = getattr(self._mod, name)
        return jax.jit(f) if callable(f) and not isinstance(f, type) else f


jse3 = _Jitted(_jse3)


def _tangents(rng, n=64):
    xi = rng.normal(0, 0.5, (n, 6)).astype(np.float32)
    xi[0] = 0.0                          # zero tangent: Taylor branches
    xi[1, 3:] = 0.0                      # pure translation
    xi[2, 3:] = np.float32(1e-5)         # tiny rotation
    return xi


def test_hat_and_so3(rng):
    w = _tangents(rng)[:, 3:]
    np.testing.assert_array_equal(np_of(tse3.hat(t_of(w))),
                                  np_of(jse3.hat(jnp.asarray(w))))
    Rj = np_of(jse3.so3_exp(jnp.asarray(w)))
    Rt = np_of(tse3.so3_exp(t_of(w)))
    np.testing.assert_allclose(Rt, Rj, atol=1e-6)
    np.testing.assert_array_equal(Rt[0], np.eye(3, dtype=np.float32))
    np.testing.assert_allclose(np_of(tse3.so3_log(t_of(Rj))),
                               np_of(jse3.so3_log(jnp.asarray(Rj))),
                               atol=1e-5)


def test_exp_log_retract_transform(rng):
    xi = _tangents(rng)
    Rj, tj = jse3.exp(jnp.asarray(xi))
    Rt, tt = tse3.exp(t_of(xi))
    np.testing.assert_allclose(np_of(Rt), np_of(Rj), atol=1e-6)
    np.testing.assert_allclose(np_of(tt), np_of(tj), atol=1e-6)
    np.testing.assert_allclose(np_of(tse3.log(Rt, tt)),
                               np_of(jse3.log(Rj, tj)), atol=2e-5)
    R0, t0 = np_of(Rj)[5], np_of(tj)[5]
    d = xi[7] * 0.1
    Rr_j, tr_j = jse3.retract(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(d))
    Rr_t, tr_t = tse3.retract(t_of(R0), t_of(t0), t_of(d))
    np.testing.assert_allclose(np_of(Rr_t), np_of(Rr_j), atol=1e-6)
    np.testing.assert_allclose(np_of(tr_t), np_of(tr_j), atol=1e-6)
    X = rng.normal(0, 3, (100, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np_of(tse3.transform(t_of(R0), t_of(t0), t_of(X))),
        np_of(jse3.transform(jnp.asarray(R0), jnp.asarray(t0),
                             jnp.asarray(X))), atol=1e-5)
    Ri_t, ti_t = tse3.inverse(t_of(R0), t_of(t0))
    Ri_j, ti_j = jse3.inverse(jnp.asarray(R0), jnp.asarray(t0))
    np.testing.assert_allclose(np_of(ti_t), np_of(ti_j), atol=1e-6)
    np.testing.assert_array_equal(np_of(Ri_t), np_of(Ri_j))


def test_orthonormalize_and_quaternion(rng):
    xi = _tangents(rng, 16)
    R = np_of(jse3.exp(jnp.asarray(xi))[0])
    noisy = (R + rng.normal(0, 1e-3, R.shape)).astype(np.float32)
    On_j = np_of(jse3.orthonormalize(jnp.asarray(noisy)))
    On_t = np_of(tse3.orthonormalize(t_of(noisy)))
    np.testing.assert_allclose(On_t, On_j, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(On_t), 1.0, atol=1e-5)
    q_j = np_of(jse3.to_quaternion(jnp.asarray(R)))
    q_t = np_of(tse3.to_quaternion(t_of(R)))
    np.testing.assert_allclose(q_t, q_j, atol=1e-6)
    np.testing.assert_allclose(np_of(tse3.from_quaternion(t_of(q_j))),
                               np_of(jse3.from_quaternion(jnp.asarray(q_j))),
                               atol=1e-6)
    T = np_of(tse3.to_matrix(t_of(R), t_of(xi[:, :3])))
    np.testing.assert_array_equal(
        T, np_of(jse3.to_matrix(jnp.asarray(R), jnp.asarray(xi[:, :3]))))


@pytest.mark.parametrize("which", ["fr1", "pinhole", "reference"])
def test_camera(which, rng):
    if which == "fr1":
        jcfg, tcfg = j_fr1().camera, tum_freiburg1_config().camera
    elif which == "pinhole":
        kw = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, k1=0.0, k2=0.0,
                  p1=0.0, p2=0.0, k3=0.0, width=640, height=480)
        jcfg, tcfg = JCameraConfig(**kw), CameraConfig(**kw)
    else:
        jcfg, tcfg = JCameraConfig(), CameraConfig()
    jc = jcam.make_camera(jcfg)
    tc = tcam.make_camera(tcfg, device="cpu")
    for f in ("fx", "fy", "cx", "cy", "min_x", "min_y", "max_x", "max_y"):
        np.testing.assert_allclose(np_of(getattr(tc, f)),
                                   np_of(getattr(jc, f)), atol=1e-4,
                                   err_msg=f)
    # pixels including the far corner, where fr1's strong k3 bites
    uv = np.concatenate([
        rng.uniform(0, [tcfg.width, tcfg.height], (200, 2)),
        [[0, 0], [tcfg.width, tcfg.height], [tcfg.width, 0]]]
    ).astype(np.float32)
    und_j = np_of(jcam.undistort_pixels(jnp.asarray(uv), jc))
    und_t = np_of(tcam.undistort_pixels(t_of(uv), tc))
    np.testing.assert_allclose(und_t, und_j, atol=1e-3)
    assert np.isfinite(und_t).all()
    np.testing.assert_allclose(
        np_of(tcam.distort_normalized(t_of(uv / 1000), tc.dist)),
        np_of(jcam.distort_normalized(jnp.asarray(uv / 1000), jc.dist)),
        atol=1e-6)
    # points behind and at the camera stay finite; masking is elsewhere
    xc = rng.normal(0, 2, (50, 3)).astype(np.float32)
    xc[:10, 2] = -np.abs(xc[:10, 2])
    xc[10, 2] = 0.0
    p_j = np_of(jcam.project(jnp.asarray(xc), jc))
    p_t = np_of(tcam.project(t_of(xc), tc))
    assert np.isfinite(p_t).all()
    np.testing.assert_allclose(p_t, p_j, rtol=1e-5)
    np.testing.assert_array_equal(np_of(tcam.in_image(t_of(p_j), tc)),
                                  np_of(jcam.in_image(jnp.asarray(p_j), jc)))
    depth = np.abs(xc[:, 2]) + 1
    np.testing.assert_allclose(
        np_of(tcam.unproject(t_of(uv[:50]), t_of(depth), tc)),
        np_of(jcam.unproject(jnp.asarray(uv[:50]), jnp.asarray(depth), jc)),
        rtol=1e-5)


def test_entry_points_need_a_card_or_the_cpu():
    """No silent CPU fallback: without a card, the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcam.make_camera(CameraConfig())
