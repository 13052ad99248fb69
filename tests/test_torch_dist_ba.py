"""The landmark-sharded BA (``orb_slam_tpu_torch/parallel/dist_ba.py``) and
the host mesh: the port against the JAX package on the CPU.

The problem is the JAX package's own (``tests/test_bundle_adjust.py::
build_problem``, seed 21: 6 cameras on an arc, camera 0 fixed, 256
landmarks, 0.3 px noise, perturbed start).  JAX's sharded solvers run on
the 8 virtual CPU devices of ``tests/conftest.py``; the port's on 8
virtual CPU devices declared with ``hostmesh.virtual_devices`` (one
process owning every shard), one torch thread, as JAX's shards run one
per core.

The partition is host numpy and must be equal to JAX's array for array.
The solves sum their shards in another order than JAX's psum, and one
fixed camera leaves the monocular scale to the damping, so poses are held
after a similarity alignment of the camera centres (known issue 6):

  - port sharded vs JAX sharded, D = 4, two-phase: rotations within
    ROT_TOL, aligned centres within CENTRE_TOL, aligned points within
    PT_TOL, reprojection RMSE within RMSE_RTOL, edge inliers equal
    (measured: dense 1.2e-7 / 4.6e-7 / 3.6e-4, cg 2.7e-7 / 4.4e-7 /
    2.0e-3; unaligned, the translations part by up to 4.9e-4 along the
    scale);
  - port sharded (dense and cg) vs the port's single-device dense solve:
    the same tolerances (measured: dense 6e-8 / 4.2e-7 / 4.4e-4, cg
    1.8e-7 / 5.7e-7 / 1.8e-3).
The cg points sit furthest apart: 48 CG steps on a 30-unknown system run
past convergence, where float32 noise steers the steps, and the
landmarks seen by two cameras follow in depth (JAX's own cg lands 2.5e-4
from the dense solve, the port's 1.8e-3, both at the same RMSE to 1e-6);
  - spatial vs index strategy: the same optimum in the caller's landmark
    and edge order, within the same tolerances.
"""
import numpy as np
import pytest
import torch

import orb_slam_tpu.config as jc
import orb_slam_tpu_torch.config as tc
from orb_slam_tpu.parallel import dist_ba as jdist
from orb_slam_tpu_torch.dataio.trajectory import umeyama_alignment
from orb_slam_tpu_torch.geometry.camera import make_camera as tcam
from orb_slam_tpu_torch.parallel import dist_ba as tdist
from orb_slam_tpu_torch.parallel import hostmesh
from orb_slam_tpu_torch.pipeline import local_mapper as tlm_mod
from orb_slam_tpu_torch.solvers import bundle_adjust as tba
from test_bundle_adjust import build_problem, make_cam, reproj_rmse
from test_torch_ba_grid import MK, MN, MP, _mapper_world
from torch_port_util import np_of, t_of

D = 4
ROT_TOL, CENTRE_TOL, PT_TOL, RMSE_RTOL = 2e-6, 5e-6, 5e-3, 1e-5
CAM = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, k1=0.0, k2=0.0, p1=0.0,
           p2=0.0, k3=0.0, width=640, height=480)


@pytest.fixture(scope="module", autouse=True)
def virtual_cpu_mesh():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with hostmesh.virtual_devices("cpu", 8):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problem():
    p = build_problem(np.random.default_rng(21), n_kf=6, n_pts=256,
                      noise=0.3)
    e = p["edges"]
    p["t_edges"] = tba.BAEdges(
        cam_idx=t_of(e.cam_idx, torch.int64),
        pt_idx=t_of(e.pt_idx, torch.int64), uv=t_of(e.uv),
        inv_sigma2=t_of(e.inv_sigma2), valid=t_of(e.valid))
    p["t"] = dict(Rs=t_of(p["Rs0"]), ts=t_of(p["ts0"]), X=t_of(p["X0"]),
                  fixed=t_of(p["fixed"]))
    p["t_cam"] = tcam(tc.CameraConfig(**CAM), device="cpu")
    return p


def _port_sharded(p, solver, mesh=None, prob=None, **kw):
    mesh = mesh or tdist.make_mesh(D, device="cpu")
    prob = prob or tdist.partition_problem(np_of(p["X0"]), p["t_edges"],
                                           mesh.size)
    t = p["t"]
    return tdist.bundle_adjust_sharded(
        mesh, t["Rs"], t["ts"], prob, t["fixed"], p["t_cam"],
        tc.SolverConfig(), solver=solver, **kw)


@pytest.fixture(scope="module")
def runs(problem):
    """JAX's and the port's sharded two-phase solves at D = 4, dense and
    cg, and the port's single-device dense solve."""
    p = problem
    jmesh = jdist.make_mesh(D)
    jprob = jdist.partition_problem(np.asarray(p["X0"]), p["edges"], D)
    out = {}
    for solver in ("dense", "cg"):
        out["jax", solver] = [np_of(x) for x in jdist.bundle_adjust_sharded(
            jmesh, p["Rs0"], p["ts0"], jprob, p["fixed"], make_cam(),
            jc.SolverConfig(), two_phase=True, solver=solver)]
        out["port", solver] = [np_of(x) for x in _port_sharded(
            p, solver, two_phase=True)]
    t = p["t"]
    res = tba.bundle_adjust(t["Rs"], t["ts"], t["X"], t["fixed"],
                            p["t_edges"], p["t_cam"], tc.SolverConfig(),
                            two_phase=True, solver="dense")
    out["single"] = [np_of(res.R), np_of(res.t), np_of(res.points),
                     np_of(res.edge_inliers)]
    return out


def _flat_points(X, n):
    return np.asarray(X).reshape(-1, 3)[:n]


def _assert_same_solution(a, b, n_pts, edges=None):
    """(R, t, X) of two solves: rotations, and the camera centres and
    points after the similarity that aligns b's centres onto a's; with
    the JAX problem's edges, the reprojection RMSE."""
    Ra, ta, Xa = a
    Rb, tb, Xb = b
    if edges is not None:
        ra = reproj_rmse(Ra, ta, _flat_points(Xa, n_pts), edges, None)[0]
        rb = reproj_rmse(Rb, tb, _flat_points(Xb, n_pts), edges, None)[0]
        assert abs(ra - rb) <= RMSE_RTOL * ra, (ra, rb)
    assert np.abs(Ra - Rb).max() <= ROT_TOL, np.abs(Ra - Rb).max()
    ca = -np.einsum("kji,kj->ki", Ra, ta)
    cb = -np.einsum("kji,kj->ki", Rb, tb)
    s, R, t = umeyama_alignment(cb.astype(np.float64), ca.astype(np.float64))
    gap_c = np.abs(cb @ (s * R).T + t - ca).max()
    assert gap_c <= CENTRE_TOL, gap_c
    Xa, Xb = _flat_points(Xa, n_pts), _flat_points(Xb, n_pts)
    gap_x = np.abs(Xb @ (s * R).T + t - Xa).max()
    assert gap_x <= PT_TOL, gap_x


@pytest.mark.parametrize("strategy,o_shard", [
    ("index", None), ("spatial", None), ("index", 1024)])
def test_partition_problem_matches_jax(problem, strategy, o_shard):
    """Equal to the JAX package's partition array for array: the packed
    shards, the padding (power of two, or o_shard), src_idx and perm."""
    p = problem
    for n_shards in (3, 8):
        ref = jdist.partition_problem(np.asarray(p["X0"]), p["edges"],
                                      n_shards, o_shard=o_shard,
                                      strategy=strategy)
        got = tdist.partition_problem(p["t"]["X"], p["t_edges"], n_shards,
                                      o_shard=o_shard, strategy=strategy)
        assert got.n_points == ref.n_points
        for f in ("Xs", "cam_idx", "pt_idx", "uv", "inv_sigma2", "valid",
                  "src_idx", "perm"):
            r, g = getattr(ref, f), getattr(got, f)
            if r is None:
                assert g is None, f
                continue
            r = np.asarray(r)
            assert g.dtype == r.dtype and np.array_equal(g, r), f
    assert (got.perm is None) == (strategy == "index")


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_sharded_matches_jax(runs, problem, solver):
    jR, jt, jX, jinl = runs["jax", solver]
    tR, tt, tX, tinl = runs["port", solver]
    assert tX.shape == jX.shape and tinl.shape == jinl.shape
    _assert_same_solution((jR, jt, jX), (tR, tt, tX), problem["X0"].shape[0],
                          problem["edges"])
    np.testing.assert_array_equal(tinl, jinl)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_sharded_matches_single_device(runs, problem, solver):
    sR, st, sX, sinl = runs["single"]
    tR, tt, tX, tinl = runs["port", solver]
    n = problem["X0"].shape[0]
    _assert_same_solution((sR, st, sX), (tR, tt, tX), n, problem["edges"])
    # the shards' inliers, back in the caller's edge order
    prob = tdist.partition_problem(problem["t"]["X"], problem["t_edges"], D)
    back = np.zeros(len(sinl), bool)
    ok = prob.src_idx >= 0
    back[prob.src_idx[ok]] = tinl[ok]
    np.testing.assert_array_equal(back, sinl)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_fixed_camera_untouched(runs, problem, solver):
    tR, tt, _, _ = runs["port", solver]
    np.testing.assert_array_equal(tR[0], np.asarray(problem["Rs0"])[0])
    np.testing.assert_array_equal(tt[0], np.asarray(problem["ts0"])[0])


def test_spatial_matches_index(problem):
    """Morton map-block sharding reaches the index strategy's optimum, with
    points and edge inliers back in the caller's order; cost is 0 as the
    JAX package returns it, and "auto" picks dense at this size."""
    p, t = problem, problem["t"]
    res = {}
    for strategy in ("index", "spatial"):
        res[strategy] = tdist.bundle_adjust_dist(
            t["Rs"], t["ts"], t["X"], t["fixed"], p["t_edges"], p["t_cam"],
            tc.SolverConfig(), two_phase=True, n_shards=D, solver="auto",
            strategy=strategy)
    a, b = res["index"], res["spatial"]
    _assert_same_solution((np_of(a.R), np_of(a.t), np_of(a.points)),
                          (np_of(b.R), np_of(b.t), np_of(b.points)),
                          p["X0"].shape[0], p["edges"])
    np.testing.assert_array_equal(np_of(a.edge_inliers),
                                  np_of(b.edge_inliers))
    assert float(a.cost) == 0.0
    n = p["X0"].shape[0]
    blob = np_of(b.host_blob)
    np.testing.assert_array_equal(blob[54 + 18:54 + 18 + 3 * n],
                                  np_of(b.points).reshape(-1))


def test_host_mesh_layout(problem):
    """make_host_mesh: 2D (model x data) over the virtual devices, the data
    axis enumerating adjacent global devices; too large a mesh raises as
    in the JAX package; the sharded BA runs on one data row."""
    mesh = hostmesh.make_host_mesh(data_parallel=4, model_parallel=2,
                                   device="cpu")
    assert mesh.shape == {"model": 2, "data": 4}
    devs = hostmesh.global_devices("cpu")
    assert list(mesh.devices[0]) == devs[:4]
    assert list(mesh.devices[1]) == devs[4:8]
    assert hostmesh.make_host_mesh(device="cpu").shape == {
        "model": 1, "data": 8}
    with pytest.raises(ValueError, match="needs 12 devices, have 8"):
        hostmesh.make_host_mesh(data_parallel=4, model_parallel=3,
                                device="cpu")
    with hostmesh.virtual_devices("cpu", None):
        assert hostmesh.device_count("cpu") == 1
    p = problem
    row = hostmesh.Mesh(mesh.devices[0], ("data",))
    Rs, ts, _, _ = _port_sharded(p, "dense", mesh=row, n_iters=3)
    assert np.all(np.isfinite(np_of(ts)))
    with pytest.raises(ValueError, match="1D mesh"):
        _port_sharded(p, "dense", mesh=mesh, n_iters=1)


def _mapper_ba(data_parallel: int):
    """One local BA of the scripted 6-keyframe map through the port's
    LocalMapper (configured for the grid layout)."""
    from orb_slam_tpu_torch.mapping import mapstore as tms
    kfs, X = _mapper_world()
    mcfg = tc.MapConfig(max_keyframes=8, max_points=128, local_ba_max_kfs=4)
    cfg = tc.SystemConfig(map=mcfg, camera=tc.CameraConfig(**CAM),
                          solver=tc.SolverConfig(ba_layout="grid"),
                          mesh=tc.MeshConfig(data_parallel=data_parallel))
    smap = tms.SlamMap.create(mcfg, MN, device="cpu")
    lm = tlm_mod.LocalMapper(cfg=cfg, cam=tcam(cfg.camera, device="cpu"))
    for k, a in enumerate(kfs):
        smap.add_keyframe(a["R"], a["t"], a["xy"], a["level"], a["angle"],
                          a["desc"].view(np.int32), a["kp_valid"],
                          np.full(MN, -1, np.int32), k, k / 30.0,
                          parent=k - 1)
    pdesc = np.random.default_rng(5).integers(
        0, 2**32, (MP, 8), dtype=np.uint64).astype(np.uint32)
    smap.add_points(t_of(X), t_of(pdesc.view(np.int32)),
                    torch.zeros((MP, 3)), torch.zeros(MP),
                    torch.full((MP,), 20.0), 0, np.ones(MP, bool), pos_np=X)
    for k, a in enumerate(kfs):
        slots = np.flatnonzero(a["obs"] >= 0)
        smap.set_observations(k, slots, a["obs"][slots])
    lm.local_ba(smap, MK - 1)
    return smap


def test_local_mapper_runs_the_sharded_ba(monkeypatch):
    """mesh.data_parallel = 4 with 8 devices: the LocalMapper's local BA
    goes through bundle_adjust_dist on the FLAT layout (the configured
    grid is overridden) and writes back the map a single-device (grid)
    BA writes, within the module's tolerances; the same outliers are
    erased."""
    calls = []
    orig = tdist.bundle_adjust_dist

    def spy(*a, **kw):
        calls.append((a[4].cam_idx is not None, kw.get("n_shards")))
        return orig(*a, **kw)

    monkeypatch.setattr(tdist, "bundle_adjust_dist", spy)
    sharded = _mapper_ba(4)
    assert calls == [(True, 4)]
    single = _mapper_ba(1)
    assert len(calls) == 1
    a, b = single.state, sharded.state
    _assert_same_solution(
        (np_of(a.kf_R)[:MK], np_of(a.kf_t)[:MK], np_of(a.mp_pos)[:MP]),
        (np_of(b.kf_R)[:MK], np_of(b.kf_t)[:MK], np_of(b.mp_pos)[:MP]), MP)
    np.testing.assert_array_equal(sharded.obs_np, single.obs_np)
    np.testing.assert_array_equal(sharded.host["kf_t"], np_of(b.kf_t))
    np.testing.assert_array_equal(sharded.host["mp_pos"], np_of(b.mp_pos))
