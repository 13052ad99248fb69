"""The keyframe-block-sharded essential graph
(``orb_slam_tpu_torch/parallel/dist_pose_graph.py``) on the CPU: the port
against the JAX package and against its own single-device graph.

The graph is the JAX multi-process test's drifted 12-keyframe ring
(``tests/multiprocess_worker.py::ring_pose_graph``: 11 odometry edges with
ground-truth measurements and one loop edge, keyframe 0 fixed), handed to
both packages.  JAX's sharded graph runs on the 8 virtual CPU devices of
``tests/conftest.py``; the port's on 8 virtual CPU devices declared with
``hostmesh.virtual_devices``, one torch thread.

``partition_edges`` is host numpy and must be equal to JAX's array for
array.  The solves sum (H, b) over their shards, in another order than a
single system's scatter, so after N_ITERS iterations the final poses are
held to POSE_TOL on s, R and t.  Measured: against JAX's sharded graph at
D = 2, 2.7e-7 (JAX's own sharded and single-device graphs part by
1.2e-7); against the port's single-device graph at D = 2 and 4, 0 on
this CPU (each block of H here sums its few edges in the same order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import orb_slam_tpu_torch.config as tc
from orb_slam_tpu.parallel import dist_ba as jdist_ba
from orb_slam_tpu.parallel import dist_pose_graph as jdpg
from orb_slam_tpu_torch.geometry.camera import make_camera as tcam
from orb_slam_tpu_torch.parallel import dist_pose_graph as tdpg
from orb_slam_tpu_torch.parallel import hostmesh
from orb_slam_tpu_torch.pipeline import loop_closer as tlc_mod
from orb_slam_tpu_torch.solvers import pose_graph as tpg
from multiprocess_worker import ring_pose_graph
from torch_port_util import np_of, t_of

N_ITERS = 8
POSE_TOL = 2e-6


@pytest.fixture(scope="module", autouse=True)
def virtual_cpu_mesh():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with hostmesh.virtual_devices("cpu", 8):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ring():
    s0, R0, t0, fixed, edges = ring_pose_graph()
    port = dict(
        s=t_of(s0, torch.float32), R=t_of(R0, torch.float32),
        t=t_of(t0, torch.float32), fixed=t_of(fixed),
        edges=tpg.Sim3Edges(
            i=t_of(edges.i, torch.int64), j=t_of(edges.j, torch.int64),
            s_meas=t_of(edges.s_meas, torch.float32),
            R_meas=t_of(edges.R_meas, torch.float32),
            t_meas=t_of(edges.t_meas, torch.float32),
            valid=t_of(edges.valid)))
    return dict(jax=(s0, R0, t0, fixed, edges), port=port)


def _port_sharded(port, n_shards, n_iters=N_ITERS):
    mesh = tdpg.make_mesh(n_shards, device="cpu")
    part = tdpg.partition_edges(port["edges"], port["s"].shape[0], n_shards)
    return [np_of(x) for x in tdpg.optimize_essential_graph_sharded(
        mesh, port["s"], port["R"], port["t"], port["fixed"], part,
        n_iters=n_iters)]


def _assert_poses(a, b):
    for x, y, name in zip(a, b, "sRt"):
        gap = np.abs(np.asarray(x, np.float32) - np.asarray(y)).max()
        assert gap <= POSE_TOL, (name, gap)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 5])
@pytest.mark.parametrize("with_invalid", [False, True])
def test_partition_edges_matches_jax(ring, n_shards, with_invalid):
    """Equal to the JAX package's keyframe-block partition, padding and
    dtypes included; invalid edges are dropped as JAX drops them."""
    _, _, _, _, je = ring["jax"]
    te = ring["port"]["edges"]
    if with_invalid:
        v = np.ones(len(np.asarray(je.valid)), bool)
        v[[2, 7, 11]] = False
        je = je._replace(valid=jnp.asarray(v))
        te = te._replace(valid=torch.from_numpy(v))
    ref = jdpg.partition_edges(je, 12, n_shards)
    got = tdpg.partition_edges(te, 12, n_shards)
    for f in tpg.Sim3Edges._fields:
        r, g = np.asarray(getattr(ref, f)), getattr(got, f)
        assert g.dtype == r.dtype and np.array_equal(g, r), f


@pytest.fixture(scope="module")
def solves(ring):
    """JAX's sharded graph at D = 2, the port's at D = 2 and 4, and the
    port's single-device graph."""
    s0, R0, t0, fixed, edges = ring["jax"]
    p = ring["port"]
    part = jdpg.partition_edges(edges, 12, 2)
    out = {("jax", 2): [np.asarray(x) for x in
                        jdpg.optimize_essential_graph_sharded(
                            jdist_ba.make_mesh(2), s0, R0, t0, fixed, part,
                            n_iters=N_ITERS)]}
    for d in (2, 4):
        out["port", d] = _port_sharded(p, d)
    out["single"] = [np_of(x) for x in tpg.optimize_essential_graph(
        p["s"], p["R"], p["t"], p["fixed"], p["edges"], n_iters=N_ITERS)[:3]]
    return out


def test_sharded_graph_matches_jax(solves):
    _assert_poses(solves["port", 2], solves["jax", 2])


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_graph_matches_single_device(ring, solves, n_shards):
    sharded = solves["port", n_shards]
    _assert_poses(sharded, solves["single"])
    # the fixed keyframe stays where it was
    p = ring["port"]
    for x, x0 in zip(sharded, (p["s"], p["R"], p["t"])):
        np.testing.assert_array_equal(x[0], np_of(x0)[0])


def test_dist_cuts_the_shard_count(ring, monkeypatch):
    """optimize_essential_graph_dist shards a 12-edge graph over one shard
    (at most E // 512), whatever it is asked for, as the JAX package does;
    with a mesh given, it shards over the mesh."""
    p = ring["port"]
    sizes = []
    orig = tdpg.optimize_essential_graph_sharded

    def spy(mesh, *a, **kw):
        sizes.append(mesh.size)
        return orig(mesh, *a, **kw)

    monkeypatch.setattr(tdpg, "optimize_essential_graph_sharded", spy)
    args = (p["s"], p["R"], p["t"], p["fixed"], p["edges"])
    out = tdpg.optimize_essential_graph_dist(*args, n_iters=2, n_shards=4)
    assert out[3] is None
    tdpg.optimize_essential_graph_dist(
        *args, n_iters=2, mesh=tdpg.make_mesh(3, device="cpu"))
    assert sizes == [1, 3]


def test_solve_graph_model_parallel(ring, monkeypatch):
    """LoopCloser._solve_graph with mesh.model_parallel = 2 shards the
    graph over the model axis when there are 2 devices (here 8 virtual
    ones) and solves on one device with fewer, to the same poses."""
    p = ring["port"]
    cfg = tc.SystemConfig(mesh=tc.MeshConfig(model_parallel=2),
                          solver=tc.SolverConfig(essential_graph_iters=3))
    lc = tlc_mod.LoopCloser(cfg=cfg, cam=tcam(cfg.camera, device="cpu"))
    calls = []
    orig = tdpg.optimize_essential_graph_dist

    def spy(*a, **kw):
        calls.append((kw["n_shards"], kw["axis"]))
        return orig(*a, **kw)

    monkeypatch.setattr(tdpg, "MIN_EDGES_PER_SHARD", 1)
    monkeypatch.setattr(tdpg, "optimize_essential_graph_dist", spy)
    corr = (p["s"], p["R"], p["t"])
    sharded = [np_of(x) for x in lc._solve_graph(corr, p["edges"], 0)]
    assert calls == [(2, "model")]
    with hostmesh.virtual_devices("cpu", None):
        single = [np_of(x) for x in lc._solve_graph(corr, p["edges"], 0)]
    assert len(calls) == 1
    _assert_poses(sharded, single)
