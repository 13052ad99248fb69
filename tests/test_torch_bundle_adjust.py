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
import os

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


def test_unported_layouts_raise(monkeypatch):
    """Every layout, placement and solver of the JAX package runs in the
    port, the landmark-sharded solver too: with mesh.data_parallel = 2 the
    local mapper solves on one device while it has fewer devices (a map on
    the CPU counts one), bit-equal to bundle_adjust, and through
    bundle_adjust_dist once it has two (declared virtual CPU devices),
    to the same poses within 1e-5 and points within 1e-3 (measured:
    rotations 1.2e-7, translations 7.7e-7, points 3.3e-5; two fixed
    cameras pin the gauge); an unknown solver raises."""
    from orb_slam_tpu_torch.parallel import dist_ba, hostmesh
    from orb_slam_tpu_torch.pipeline.local_mapper import LocalMapper
    pr = _problem()
    edges = tba.BAEdges(
        cam_idx=t_of(pr["cam"]).long(), pt_idx=t_of(pr["pt"]).long(),
        uv=t_of(pr["uv"]), inv_sigma2=t_of(pr["inv_s2"]),
        valid=torch.ones(len(pr["cam"]), dtype=torch.bool))
    args = (t_of(pr["R"]), t_of(pr["t"]), t_of(pr["X"]), t_of(pr["fixed"]),
            edges)
    cam = tcam(tc.CameraConfig(**CAM), device="cpu")
    lm = LocalMapper(cfg=tc.SystemConfig(mesh=tc.MeshConfig(
        data_parallel=2)), cam=cam)
    ref = tba.bundle_adjust(*args, cam, two_phase=True)
    one = lm._run_ba(*args, two_phase=True)
    for a, b in zip(one[:4], ref[:4]):
        assert torch.equal(a, b)
    calls = []
    orig = dist_ba.bundle_adjust_dist

    def spy(*a, **kw):
        calls.append(kw["n_shards"])
        return orig(*a, **kw)

    monkeypatch.setattr(dist_ba, "bundle_adjust_dist", spy)
    with hostmesh.virtual_devices("cpu", 2):
        two = lm._run_ba(*args, two_phase=True)
    assert calls == [2]
    for a, b, tol in zip(two[:3], ref[:3], (1e-5, 1e-5, 1e-3)):
        gap = float((a - b).abs().max())
        assert gap <= tol, gap
    assert torch.equal(two.edge_inliers, ref.edge_inliers)
    with pytest.raises(ValueError, match="solver"):
        tba.bundle_adjust(*args, cam, solver="sparse")


def test_accept_counts_the_same_edges():
    """A local BA window recorded from the port's endurance run (7
    cameras, the last one, map keyframe 0, the fixed gauge; 428 points,
    1826 edges;
    tests/data/ba_behind_camera.npz).  One fixed camera leaves the scale
    to the damping, and in phase 2 a float32 step along it took the points
    behind their cameras: the old accept test summed only the edges in
    front of their camera after the step, so the step lowered the cost by
    dropping edges, and the port ended at cost 10558 with 3 inliers where
    JAX ends at 385.5 with 1796.  Both costs now sum the edges in front
    before the step, as g2o's edges count wherever the point goes.  Held
    to JAX: final cost within 0.1% (measured 385.52 vs 385.50), inliers
    within 1% (1799 vs 1796), no point behind a camera it is an inlier
    of, and camera centres within 5e-5 of JAX's after a similarity
    alignment (the free scale; measured 1.4e-6)."""
    from orb_slam_tpu_torch.dataio.trajectory import umeyama_alignment
    d = np.load(os.path.join(os.path.dirname(__file__), "data",
                             "ba_behind_camera.npz"))
    cfg_t, cfg_j = tc.SolverConfig(), jc.SolverConfig()
    tres = tba.bundle_adjust(
        t_of(d["Rs"]), t_of(d["ts"]), t_of(d["Xs"]), t_of(d["fixed"]),
        tba.BAEdges(t_of(d["cam_idx"]).long(), t_of(d["pt_idx"]).long(),
                    t_of(d["uv"]), t_of(d["inv_sigma2"]), t_of(d["valid"])),
        tcam(tc.CameraConfig(**CAM), device="cpu"), cfg_t, two_phase=True)
    jres = jba.bundle_adjust(
        jnp.asarray(d["Rs"]), jnp.asarray(d["ts"]), jnp.asarray(d["Xs"]),
        jnp.asarray(d["fixed"]),
        jba.BAEdges(*(jnp.asarray(d[k]) for k in (
            "cam_idx", "pt_idx", "uv", "inv_sigma2", "valid"))),
        jcam(jc.CameraConfig(**CAM)), cfg_j, two_phase=True)
    tc_, jc_ = float(tres.cost), float(jres.cost)
    assert abs(tc_ - jc_) <= 1e-3 * jc_, (tc_, jc_)
    n_t, n_j = int(tres.edge_inliers.sum()), int(np.sum(jres.edge_inliers))
    assert abs(n_t - n_j) <= 0.01 * n_j, (n_t, n_j)
    R, t, X = np_of(tres.R), np_of(tres.t), np_of(tres.points)
    inl = np_of(tres.edge_inliers)
    ci, pi = d["cam_idx"][inl], d["pt_idx"][inl]
    z = np.einsum("oij,oj->oi", R[ci], X[pi])[:, 2] + t[ci, 2]
    assert (z > 0).all()
    c_t = -np.einsum("kji,kj->ki", R, t)
    Rj, tj = np.asarray(jres.R), np.asarray(jres.t)
    c_j = -np.einsum("kji,kj->ki", Rj, tj)
    s, Ra, ta = umeyama_alignment(c_t.astype(np.float64),
                                  c_j.astype(np.float64))
    gap = np.abs(c_t @ (s * Ra).T + ta - c_j).max()
    assert gap <= 5e-5, gap
