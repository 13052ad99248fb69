"""GRID-layout bundle adjustment, both placements of its half-matrix and
the PCG reduced solve: the port against the JAX package on the CPU.

The solver-level cases use `test_torch_bundle_adjust.py`'s window (7
cameras, the first 2 fixed, 150 landmarks, 0.5 px noise, 5% gross
outliers, a perturbed start; from a seed with numpy), re-expressed as the
camera-major [K, N] table (N = the largest per-camera edge count).  Both
packages get the same table.

Tolerances:
- dense, either layout, and CG: final cost within rtol 1e-3, pose entries
  within 1e-5, points within 1e-3, equal inlier masks (the flat dense
  test's bounds; float32 sums in another order drift a few ulps per
  iteration).  On this window (30 free unknowns) 48 PCG steps converge
  fully, so CG needs no looser bound.  Measured here (cost relative,
  poses, points): grid dense against JAX 1.1e-6 / 9.5e-7 / 7.6e-5, grid
  CG against JAX 2.6e-7 / 9.3e-7 / 3.0e-5, flat CG against JAX 2.5e-6 /
  6.3e-7 / 3.9e-5, port grid against port flat 1.9e-6 / 8.0e-7 /
  1.7e-5.
- scatter against onehot: the same G to the bit (each (camera, point)
  pair holds one block), and the same solve.
- the mapper case: one local BA through both packages' LocalMapper on a
  6-keyframe map (a 4-keyframe window, 2 fixed): the same observations
  erased, poses within 1e-5 (measured 3.8e-6), points kept by >= 3
  observations within 1e-4 (measured 3.2e-5), every point within 5e-3.
  The loose bound is for point 1: the gate erases three of its five
  observations and leaves it on two rays, where float32 sums in another
  order move it by 2.2e-3 (measured;
  the flat layout's port-vs-JAX gap on the same point is 5.3e-4, and
  port flat vs port grid 2.7e-3).  JAX pads the problem to pow2 rows
  (identity fixed cameras, unobserved points) and its write-back drops
  them, so the map tables compare directly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import orb_slam_tpu.config as jc
import orb_slam_tpu_torch.config as tc
from orb_slam_tpu.geometry.camera import make_camera as jcam
from orb_slam_tpu.mapping import mapstore as jms
from orb_slam_tpu.pipeline.local_mapper import LocalMapper as JLM
from orb_slam_tpu.solvers import bundle_adjust as jba
from orb_slam_tpu_torch.geometry.camera import make_camera as tcam
from orb_slam_tpu_torch.mapping import mapstore as tms
from orb_slam_tpu_torch.pipeline.local_mapper import LocalMapper as TLM
from orb_slam_tpu_torch.solvers import bundle_adjust as tba
from smoke_world import rotmat
from test_torch_bundle_adjust import CAM, FIXED, NK, PAD, _problem
from torch_port_util import np_of, t_of


def _grid_np(pr):
    """The window's edges as the [K, N] table, each camera's edges in
    their flat order."""
    cam = pr["cam"]
    counts = np.bincount(cam, minlength=NK)
    N = int(counts.max())
    order = np.argsort(cam, kind="stable")
    slot = np.arange(len(cam)) - np.concatenate(
        [[0], np.cumsum(counts)[:-1]])[cam[order]]
    k = cam[order]
    g = dict(pt=np.zeros((NK, N), np.int32),
             uv=np.zeros((NK, N, 2), np.float32),
             inv_s2=np.ones((NK, N), np.float32),
             valid=np.zeros((NK, N), bool))
    g["pt"][k, slot] = pr["pt"][order]
    g["uv"][k, slot] = pr["uv"][order]
    g["inv_s2"][k, slot] = pr["inv_s2"][order]
    g["valid"][k, slot] = True
    return g, (k, slot, order)


def _flat_edges_j(pr):
    O = len(pr["cam"])
    return jba.BAEdges(
        cam_idx=jnp.asarray(np.concatenate([pr["cam"], np.zeros(PAD)])
                            .astype(np.int32)),
        pt_idx=jnp.asarray(np.concatenate([pr["pt"], np.zeros(PAD)])
                           .astype(np.int32)),
        uv=jnp.asarray(np.concatenate([pr["uv"],
                                       np.zeros((PAD, 2), np.float32)])),
        inv_sigma2=jnp.asarray(np.concatenate([pr["inv_s2"],
                                               np.ones(PAD, np.float32)])),
        valid=jnp.asarray(np.arange(O + PAD) < O))


def _flat_edges_t(pr):
    return tba.BAEdges(
        cam_idx=t_of(pr["cam"]).long(), pt_idx=t_of(pr["pt"]).long(),
        uv=t_of(pr["uv"]), inv_sigma2=t_of(pr["inv_s2"]),
        valid=torch.ones(len(pr["cam"]), dtype=torch.bool))


def _grid_edges_t(g):
    return tba.BAEdges(cam_idx=None, pt_idx=t_of(g["pt"]).long(),
                       uv=t_of(g["uv"]), inv_sigma2=t_of(g["inv_s2"]),
                       valid=t_of(g["valid"]))


def _jax(pr, edges, **kw):
    return jba.bundle_adjust(
        jnp.asarray(pr["R"]), jnp.asarray(pr["t"]), jnp.asarray(pr["X"]),
        jnp.asarray(pr["fixed"]), edges, jcam(jc.CameraConfig(**CAM)),
        jc.SolverConfig(), **kw)


def _port(pr, edges, cfg=tc.SolverConfig(), **kw):
    return tba.bundle_adjust(
        t_of(pr["R"]), t_of(pr["t"]), t_of(pr["X"]), t_of(pr["fixed"]),
        edges, tcam(tc.CameraConfig(**CAM), device="cpu"), cfg, **kw)


def _assert_same_solution(tr, ref, tin, rin, pt_tol=1e-3):
    assert float(tr.cost) == pytest.approx(float(ref.cost), rel=1e-3)
    np.testing.assert_array_equal(tin, rin)
    assert 0.90 < tin.mean() < 0.97            # the outliers are gated
    np.testing.assert_allclose(np_of(tr.R), np_of(ref.R), atol=1e-5)
    np.testing.assert_allclose(np_of(tr.t), np_of(ref.t), atol=1e-5)
    np.testing.assert_allclose(np_of(tr.points), np_of(ref.points),
                               atol=pt_tol)


@pytest.fixture(scope="module")
def window():
    pr = _problem()
    g, (k, slot, order) = _grid_np(pr)
    # flat edge o sits at grid slot (k[o], slot[o]) of the ordered edges
    return pr, g, (k, slot, order)


@pytest.mark.parametrize("solver,two_phase", [
    ("dense", True), ("cg", True), ("dense", False)],
    ids=["dense-local", "cg-local", "dense-global"])
def test_grid_matches_jax(window, solver, two_phase):
    pr, g, (k, slot, _) = window
    jr = _jax(pr, jba.BAEdges(
        cam_idx=None, pt_idx=jnp.asarray(g["pt"]), uv=jnp.asarray(g["uv"]),
        inv_sigma2=jnp.asarray(g["inv_s2"]), valid=jnp.asarray(g["valid"])),
        two_phase=two_phase, solver=solver)
    tr = _port(pr, _grid_edges_t(g), two_phase=two_phase, solver=solver)
    assert tr.edge_inliers.shape == g["valid"].shape
    tin, jin = np_of(tr.edge_inliers), np.asarray(jr.edge_inliers)
    _assert_same_solution(tr, jr, tin[k, slot], jin[k, slot])
    assert not tin[~g["valid"]].any()          # masked slots are no edges
    np.testing.assert_array_equal(np_of(tr.R)[:FIXED], pr["R"][:FIXED])


def test_flat_cg_matches_jax(window):
    pr = window[0]
    O = len(pr["cam"])
    jr = _jax(pr, _flat_edges_j(pr), solver="cg")
    tr = _port(pr, _flat_edges_t(pr), solver="cg")
    _assert_same_solution(tr, jr, np_of(tr.edge_inliers),
                          np.asarray(jr.edge_inliers)[:O])


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_grid_matches_flat(window, solver):
    """The same window in both layouts, inside the port; the grid's
    inlier mask read at each flat edge's slot."""
    pr, g, (k, slot, order) = window
    tf = _port(pr, _flat_edges_t(pr), solver=solver)
    tg = _port(pr, _grid_edges_t(g), solver=solver)
    _assert_same_solution(tg, tf, np_of(tg.edge_inliers)[k, slot],
                          np_of(tf.edge_inliers)[order])


def test_grid_normalized_world_matches_flat(window):
    """ba_normalize_world counts the points the grid's valid slots see."""
    pr, g, (k, slot, order) = window
    cfg = tc.SolverConfig(ba_normalize_world=True)
    tf = _port(pr, _flat_edges_t(pr), cfg)
    tg = _port(pr, _grid_edges_t(g), cfg)
    _assert_same_solution(tg, tf, np_of(tg.edge_inliers)[k, slot],
                          np_of(tf.edge_inliers)[order])


def test_placements_agree(window):
    """scatter and onehot: the same G to the bit on random blocks (JAX's
    scatter placement too), then the same solve."""
    pr, g = window[:2]
    rng = np.random.default_rng(3)
    K, N, P = 5, 12, 40
    pt = np.stack([rng.permutation(P)[:N] for _ in range(K)])
    blk = rng.normal(0, 1, (K, N, 6, 3)).astype(np.float32)
    blk[:, -2:] = 0.0                    # masked slots carry zero blocks
    pt[:, -2:] = 0
    gs = tba._place_grid(t_of(blk), t_of(pt).long(), P, "scatter")
    go = tba._place_grid(t_of(blk), t_of(pt).long(), P, "onehot")
    gj = jba._place_grid(jnp.asarray(blk), jnp.asarray(pt.astype(np.int32)),
                         P, "scatter")
    assert gs.shape == (6 * K, 3 * P)
    np.testing.assert_array_equal(np_of(gs), np_of(go))
    np.testing.assert_array_equal(np_of(gs), np.asarray(gj))
    # block (k, n) lands at rows 6k.., columns 3 pt[k, n]..
    np.testing.assert_array_equal(
        np_of(gs)[6:12, 3 * pt[1, 4]:3 * pt[1, 4] + 3], blk[1, 4])

    r_sc = _port(pr, _grid_edges_t(g), placement="scatter")
    r_oh = _port(pr, _grid_edges_t(g), placement="onehot")
    for a, b in zip(r_sc[:5], r_oh[:5]):
        np.testing.assert_array_equal(np_of(a), np_of(b))


def test_grid_blob_roundtrip(window):
    """host_blob packs (R, t, points, the [K, N] inliers flattened)."""
    pr, g = window[:2]
    res = _port(pr, _grid_edges_t(g))
    hb = np_of(res.host_blob)
    P = res.points.shape[0]
    o = 9 * NK
    np.testing.assert_array_equal(hb[:o].reshape(NK, 3, 3), np_of(res.R))
    np.testing.assert_array_equal(hb[o:o + 3 * NK].reshape(NK, 3),
                                  np_of(res.t))
    o += 3 * NK
    np.testing.assert_array_equal(hb[o:o + 3 * P].reshape(P, 3),
                                  np_of(res.points))
    o += 3 * P
    np.testing.assert_array_equal((hb[o:] != 0).reshape(g["valid"].shape),
                                  np_of(res.edge_inliers))


def test_half_matrix_guard_raises_like_jax():
    """G [6K, 3P] float32 over 8 GiB raises before any allocation: K=512,
    P=300k is 10.3 GiB; the inputs are expanded views of a few bytes."""
    K, P = 512, 300_000
    edges = tba.BAEdges(cam_idx=None,
                        pt_idx=torch.zeros(1, 1, dtype=torch.int64),
                        uv=torch.zeros(1, 1, 2), inv_sigma2=torch.ones(1, 1),
                        valid=torch.ones(1, 1, dtype=torch.bool))
    Rs = torch.eye(3).expand(K, 3, 3)
    ts = torch.zeros(1, 3).expand(K, 3)
    Xs = torch.zeros(1, 3).expand(P, 3)
    fixed = torch.ones(1, dtype=torch.bool).expand(K)
    for solver in ("dense", "cg"):
        with pytest.raises(ValueError, match="10.3 GiB"):
            tba.bundle_adjust(Rs, ts, Xs, fixed, edges, None, solver=solver)
    with pytest.raises(ValueError, match="10.3 GiB"):
        jba.bundle_adjust(jnp.zeros((K, 3, 3)), jnp.zeros((K, 3)),
                          jnp.zeros((P, 3)), jnp.zeros(K, bool),
                          jba.BAEdges(None, *(jnp.zeros((1, 1)),) * 4), None)


# ---------------------------------------------------------------------------
# mapper level: one local BA through both packages' LocalMapper

MK, MN, MP = 6, 64, 60        # keyframes, slots per keyframe, points


def _mapper_world():
    """6 keyframes on 60 points: keyframe k sees each point with
    probability 0.8 in a random slot (0.5 px noise, 4 gross outliers per
    keyframe), levels 0-2; a few valid slots observe nothing.  Poses past
    keyframe 0 and every point start perturbed."""
    rng = np.random.default_rng(17)
    X = np.stack([rng.uniform(-3, 3, MP), rng.uniform(-2, 2, MP),
                  rng.uniform(5, 9, MP)], 1)
    kfs = []
    for k in range(MK):
        R = rotmat([0.1, 1, 0], 0.03 * k)
        t = np.array([-0.6 * k, 0.01 * k, 0.02 * k])
        seen = np.flatnonzero(rng.random(MP) < 0.8)
        slots = rng.permutation(MN)[:len(seen)]
        xc = X[seen] @ R.T + t
        uv = xc[:, :2] / xc[:, 2:] * 500 + [320, 240]
        uv += rng.normal(0, 0.5, uv.shape)
        uv[rng.permutation(len(seen))[:4]] += rng.uniform(-40, 40, (4, 2))
        xy = rng.uniform(0, 600, (MN, 2))
        xy[slots] = uv
        obs = np.full(MN, -1, np.int32)
        obs[slots] = seen
        kp_valid = rng.random(MN) < 0.5
        kp_valid[slots] = True
        if k:
            R = rotmat(rng.normal(0, 1, 3), 0.004) @ R
            t = t + rng.normal(0, 0.02, 3)
        kfs.append(dict(
            R=R.astype(np.float32), t=t.astype(np.float32),
            xy=xy.astype(np.float32),
            level=rng.integers(0, 3, MN).astype(np.int32),
            angle=rng.uniform(0, 6, MN).astype(np.float32),
            desc=rng.integers(0, 2**32, (MN, 8), dtype=np.uint64).astype(
                np.uint32),
            kp_valid=kp_valid, obs=obs))
    Xn = (X + rng.normal(0, 0.05, X.shape)).astype(np.float32)
    return kfs, Xn


def _mapper_local_ba(port: bool):
    kfs, X = _mapper_world()
    cfgm = tc if port else jc
    # a 4-keyframe window: two keyframes stay fixed, which pins the
    # monocular gauge's scale (one fixed camera leaves it free)
    mcfg = cfgm.MapConfig(max_keyframes=8, max_points=128,
                          local_ba_max_kfs=4)
    cam_cfg = cfgm.CameraConfig(**CAM)
    cfg = cfgm.SystemConfig(map=mcfg, camera=cam_cfg,
                            solver=cfgm.SolverConfig(ba_layout="grid"))
    if port:
        smap = tms.SlamMap.create(mcfg, MN, device="cpu")
        lm = TLM(cfg=cfg, cam=tcam(cam_cfg, device="cpu"))
    else:
        smap = jms.SlamMap.create(mcfg, MN)
        lm = JLM(cfg=cfg, cam=jcam(cam_cfg))

    def arr(x):
        return torch.from_numpy(np.array(x)) if port else jnp.asarray(x)

    for k, a in enumerate(kfs):
        desc = a["desc"].view(np.int32) if port else a["desc"]
        smap.add_keyframe(a["R"], a["t"], a["xy"], a["level"], a["angle"],
                          desc, a["kp_valid"], np.full(MN, -1, np.int32),
                          k, k / 30.0, parent=k - 1)
    pdesc = np.random.default_rng(5).integers(
        0, 2**32, (MP, 8), dtype=np.uint64).astype(np.uint32)
    ids = smap.add_points(
        arr(X), arr(pdesc.view(np.int32) if port else pdesc),
        arr(np.zeros((MP, 3), np.float32)), arr(np.zeros(MP, np.float32)),
        arr(np.full(MP, 20.0, np.float32)), 0, np.ones(MP, bool),
        pos_np=X)
    assert np.array_equal(ids, np.arange(MP))
    for k, a in enumerate(kfs):
        slots = np.flatnonzero(a["obs"] >= 0)
        smap.set_observations(k, slots, a["obs"][slots])
    obs0 = smap.obs_np.copy()
    lm.local_ba(smap, MK - 1)
    return smap, obs0


def test_local_mapper_grid_matches_jax():
    jm, jobs0 = _mapper_local_ba(port=False)
    tm, tobs0 = _mapper_local_ba(port=True)
    np.testing.assert_array_equal(tobs0, jobs0)
    st, sj = tm.state, jm.state
    np.testing.assert_allclose(np_of(st.kf_R)[:MK], np.asarray(sj.kf_R)[:MK],
                               atol=1e-5)
    np.testing.assert_allclose(np_of(st.kf_t)[:MK], np.asarray(sj.kf_t)[:MK],
                               atol=1e-5)
    # a point left with two observations after the gate is weakly held:
    # see the module docstring
    n_obs = np.bincount(tm.obs_np[tm.obs_np >= 0], minlength=MP)[:MP]
    d_pt = np.abs(np_of(st.mp_pos)[:MP] - np.asarray(sj.mp_pos)[:MP]).max(1)
    assert d_pt[n_obs >= 3].max() <= 1e-4, d_pt[n_obs >= 3].max()
    assert d_pt.max() <= 5e-3, d_pt.max()
    erased = (tobs0 >= 0) & (np_of(st.kf_obs) < 0)
    np.testing.assert_array_equal(np_of(st.kf_obs), np.asarray(sj.kf_obs))
    assert 10 <= erased.sum() <= 40            # the outliers are erased
    # the window moved, keyframe 0 (the gauge) did not
    kfs, _ = _mapper_world()
    assert np.abs(np_of(st.kf_t)[1:MK] - np.stack(
        [a["t"] for a in kfs[1:]])).max() > 1e-3
    np.testing.assert_array_equal(np_of(st.kf_R)[0], kfs[0]["R"])
    # host mirrors: the port's write-back patched them with the values
    np.testing.assert_array_equal(tm.obs_np, np_of(st.kf_obs))
    np.testing.assert_array_equal(tm.host["kf_t"], np_of(st.kf_t))
    np.testing.assert_array_equal(tm.host["mp_pos"], np_of(st.mp_pos))
