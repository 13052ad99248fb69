"""Flat-layout bundle adjustment with the dense reduced solve: the port
against the JAX package on a synthetic window.

Made from a seed with numpy: 7 cameras (the first 2 fixed: the gauge),
150 landmarks seen by ~70% of the cameras with 0.5 px noise, 5% gross
outliers; poses and points start perturbed.  Both solvers get the same
edges (the JAX package's problem padded with invalid edges as its local
mapper pads, the port's sized exactly).

Tolerances: final cost within rtol 1e-3; pose entries within 1e-5;
points within 1e-3 (float32 LM steps summed in another order drift apart
by a few ulps per iteration; measured here: cost 1e-6 relative, poses
7e-7, points 3e-5); the returned inlier masks identical.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import orb_slam_tpu.config as jc
import orb_slam_tpu_torch.config as tc
from orb_slam_tpu.geometry.camera import make_camera as jcam
from orb_slam_tpu.solvers import bundle_adjust as jba
from orb_slam_tpu_torch.geometry.camera import make_camera as tcam
from orb_slam_tpu_torch.solvers import bundle_adjust as tba
from smoke_world import rotmat
from torch_port_util import np_of, t_of

CAM = dict(fx=500, fy=500, cx=320, cy=240, k1=0, k2=0, p1=0, p2=0, k3=0,
           width=640, height=480)
NK, NP, FIXED, PAD = 7, 150, 2, 64


def _problem(seed=9):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, NP), rng.uniform(-2, 2, NP),
                  rng.uniform(5, 10, NP)], 1)
    Rs = np.stack([rotmat([0.1, 1, 0], 0.03 * k) for k in range(NK)])
    ts = np.stack([[-0.25 * k, 0.01 * k, 0.02 * k] for k in range(NK)])
    cams, pts, uv = [], [], []
    for k in range(NK):
        for p in range(NP):
            if rng.random() < 0.7:
                xc = Rs[k] @ X[p] + ts[k]
                cams.append(k)
                pts.append(p)
                uv.append(xc[:2] / xc[2] * 500 + [320, 240])
    uv = np.asarray(uv) + rng.normal(0, 0.5, (len(uv), 2))
    out = rng.random(len(uv)) < 0.05
    uv[out] += rng.uniform(-40, 40, (out.sum(), 2))
    lev = rng.integers(0, 3, len(uv))
    inv_s2 = (1.0 / 1.44 ** lev).astype(np.float32)
    # perturbed start (free cameras and every point)
    R0 = Rs.copy()
    t0 = ts.copy()
    for k in range(FIXED, NK):
        R0[k] = rotmat(rng.normal(0, 1, 3), 0.004) @ Rs[k]
        t0[k] = ts[k] + rng.normal(0, 0.02, 3)
    X0 = X + rng.normal(0, 0.05, X.shape)
    fixed = np.arange(NK) < FIXED
    return dict(R=R0.astype(np.float32), t=t0.astype(np.float32),
                X=X0.astype(np.float32), fixed=fixed,
                cam=np.asarray(cams), pt=np.asarray(pts),
                uv=uv.astype(np.float32), inv_s2=inv_s2)


def _jax(pr, two_phase):
    O = len(pr["cam"])
    pad = PAD
    edges = jba.BAEdges(
        cam_idx=jnp.asarray(np.concatenate([pr["cam"], np.zeros(pad)])
                            .astype(np.int32)),
        pt_idx=jnp.asarray(np.concatenate([pr["pt"], np.zeros(pad)])
                           .astype(np.int32)),
        uv=jnp.asarray(np.concatenate([pr["uv"], np.zeros((pad, 2),
                                                          np.float32)])),
        inv_sigma2=jnp.asarray(np.concatenate([pr["inv_s2"],
                                               np.ones(pad, np.float32)])),
        valid=jnp.asarray(np.arange(O + pad) < O))
    res = jba.bundle_adjust(jnp.asarray(pr["R"]), jnp.asarray(pr["t"]),
                            jnp.asarray(pr["X"]), jnp.asarray(pr["fixed"]),
                            edges, jcam(jc.CameraConfig(**CAM)),
                            jc.SolverConfig(), two_phase=two_phase)
    return res, np.asarray(res.edge_inliers)[:O]


def _port(pr, two_phase):
    edges = tba.BAEdges(
        cam_idx=t_of(pr["cam"]).long(), pt_idx=t_of(pr["pt"]).long(),
        uv=t_of(pr["uv"]), inv_sigma2=t_of(pr["inv_s2"]),
        valid=torch.ones(len(pr["cam"]), dtype=torch.bool))
    res = tba.bundle_adjust(t_of(pr["R"]), t_of(pr["t"]), t_of(pr["X"]),
                            t_of(pr["fixed"]), edges,
                            tcam(tc.CameraConfig(**CAM), device="cpu"),
                            tc.SolverConfig(), two_phase=two_phase)
    return res, np_of(res.edge_inliers)


@pytest.mark.parametrize("two_phase", [True, False],
                         ids=["local_two_phase", "global"])
def test_bundle_adjust_matches_jax(two_phase):
    pr = _problem()
    jr, jin = _jax(pr, two_phase)
    tr, tin = _port(pr, two_phase)
    cost_j, cost_t = float(jr.cost), float(tr.cost)
    assert cost_t == pytest.approx(cost_j, rel=1e-3)
    np.testing.assert_array_equal(tin, jin)
    assert 0.90 < tin.mean() < 0.97            # the outliers are gated
    np.testing.assert_allclose(np_of(tr.R), np.asarray(jr.R), atol=1e-5)
    np.testing.assert_allclose(np_of(tr.t), np.asarray(jr.t), atol=1e-5)
    np.testing.assert_allclose(np_of(tr.points), np.asarray(jr.points),
                               atol=1e-3)
    # the fixed cameras (the gauge) do not move
    np.testing.assert_array_equal(np_of(tr.R)[:FIXED], pr["R"][:FIXED])
    np.testing.assert_array_equal(np_of(tr.t)[:FIXED], pr["t"][:FIXED])
    # the packed blob is (R, t, points, inliers)
    blob = np_of(tr.host_blob)
    np.testing.assert_array_equal(blob[:9 * NK], np_of(tr.R).reshape(-1))
    np.testing.assert_array_equal(blob[-len(tin):] != 0, tin)


def test_unported_layouts_raise():
    pr = _problem()
    edges = tba.BAEdges(
        cam_idx=t_of(pr["cam"]).long(), pt_idx=t_of(pr["pt"]).long(),
        uv=t_of(pr["uv"]), inv_sigma2=t_of(pr["inv_s2"]),
        valid=torch.ones(len(pr["cam"]), dtype=torch.bool))
    args = (t_of(pr["R"]), t_of(pr["t"]), t_of(pr["X"]), t_of(pr["fixed"]),
            edges, tcam(tc.CameraConfig(**CAM), device="cpu"))
    with pytest.raises(NotImplementedError):
        tba.bundle_adjust(*args, layout="grid")
    with pytest.raises(NotImplementedError):
        tba.bundle_adjust(*args, solver="cg")
