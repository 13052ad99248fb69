"""One process of a torch.distributed group on the CPU (gloo), run by
tests/test_torch_multiprocess.py, N processes x M virtual CPU shards each.
It exercises, across real process boundaries:

  * ``parallel.hostmesh.maybe_init_distributed`` (the environment contract
    ORB_SLAM_TPU_COORDINATOR / _NUM_PROCS / _PROC_ID) and the host mesh's
    (process x local shard) layout with a psum over it;
  * the landmark-sharded BA (``parallel/dist_ba.py``), dense and cg, over
    every global shard, against the single-device solve computed here;
  * the keyframe-block-sharded essential graph
    (``parallel/dist_pose_graph.py``) against the single-device graph.

The port only: nothing here imports JAX.  Each process writes its results
to $ORB_SLAM_TPU_TEST_OUT.<rank> as JSON (replicated outputs in full), so
the launcher can check that every rank computed the same values.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from orb_slam_tpu_torch.config import CameraConfig, SolverConfig  # noqa: E402
from orb_slam_tpu_torch.geometry import sim3  # noqa: E402
from orb_slam_tpu_torch.geometry.camera import make_camera  # noqa: E402
from orb_slam_tpu_torch.parallel import dist_ba  # noqa: E402
from orb_slam_tpu_torch.parallel import dist_pose_graph  # noqa: E402
from orb_slam_tpu_torch.parallel import hostmesh  # noqa: E402
from orb_slam_tpu_torch.solvers import bundle_adjust as ba  # noqa: E402
from orb_slam_tpu_torch.solvers import pose_graph  # noqa: E402


def _rotmat(axis, ang):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K


def ba_problem(seed=21, n_kf=6, n_pts=256, noise=0.3):
    """Cameras on an arc observing a cloud (the shape of the JAX tests'
    build_problem), camera 0 fixed, perturbed start; torch CPU tensors."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                  rng.uniform(5, 10, n_pts)], 1)
    Rs = np.stack([_rotmat([0, 1, 0], np.radians(3.0 * k))
                   for k in range(n_kf)])
    ts = np.stack([[-0.4 * k, 0.02 * k, 0.01 * k] for k in range(n_kf)])
    cams, pts, uvs = [], [], []
    for k in range(n_kf):
        xc = X @ Rs[k].T + ts[k]
        uv = xc[:, :2] / xc[:, 2:] * 500 + [320, 240]
        vis = np.flatnonzero((xc[:, 2] > 0.5) & (uv[:, 0] > 0)
                             & (uv[:, 0] < 640) & (uv[:, 1] > 0)
                             & (uv[:, 1] < 480))
        cams.append(np.full(len(vis), k))
        pts.append(vis)
        uvs.append(uv[vis] + rng.normal(0, noise, (len(vis), 2)))
    R0, t0 = Rs.copy(), ts.copy()
    for k in range(1, n_kf):
        w = rng.normal(0, 0.02, 3)
        R0[k] = _rotmat(w, np.linalg.norm(w)) @ Rs[k]
        t0[k] = ts[k] + rng.normal(0, 0.02, 3)
    X0 = X + rng.normal(0, 0.05, X.shape)
    O = sum(len(c) for c in cams)
    f32 = torch.float32
    edges = ba.BAEdges(
        cam_idx=torch.from_numpy(np.concatenate(cams)).long(),
        pt_idx=torch.from_numpy(np.concatenate(pts)).long(),
        uv=torch.from_numpy(np.concatenate(uvs)).to(f32),
        inv_sigma2=torch.ones(O), valid=torch.ones(O, dtype=torch.bool))
    return (torch.from_numpy(R0).to(f32), torch.from_numpy(t0).to(f32),
            torch.from_numpy(X0).to(f32), torch.arange(n_kf) == 0, edges)


def ring_graph(n=12, seed=3):
    """A drifted ring of n keyframes with ground-truth odometry and one
    loop edge (the JAX multi-process test's ring_pose_graph)."""
    f32 = torch.float32
    zeta = torch.tensor([0.3, 0.0, 0.02, 0.0, 2 * np.pi / n, 0.0, 0.0],
                        dtype=f32)
    rel = sim3.exp(zeta)
    gt = [(torch.ones((), dtype=f32), torch.eye(3), torch.zeros(3))]
    for _ in range(1, n):
        gt.append(sim3.compose(*rel, *gt[-1]))
    rng = np.random.default_rng(seed)
    drift = [gt[0]]
    for _ in range(1, n):
        noise = sim3.exp(torch.from_numpy(rng.normal(0, 0.02, 7)).to(f32))
        drift.append(sim3.compose(*sim3.compose(*noise, *rel), *drift[-1]))
    s0, R0, t0 = (torch.stack(x) for x in zip(*drift))
    pairs = [(k, k - 1) for k in range(1, n)] + [(n - 1, 0)]
    meas = [sim3.compose(*gt[i], *sim3.inverse(*gt[j])) for i, j in pairs]
    sm, Rm, tm = (torch.stack(x) for x in zip(*meas))
    ij = torch.tensor(pairs)
    edges = pose_graph.Sim3Edges(i=ij[:, 0], j=ij[:, 1], s_meas=sm,
                                 R_meas=Rm, t_meas=tm,
                                 valid=torch.ones(n, dtype=torch.bool))
    return s0, R0, t0, torch.arange(n) == 0, edges


def _l(x):
    return x.detach().cpu().numpy().astype(np.float64).ravel().tolist()


def _gap(a, b):
    return float((a - b).abs().max())


def main():
    torch.set_num_threads(1)
    hostmesh.declare_virtual_devices(
        "cpu", int(os.environ["ORB_SLAM_TPU_TEST_LOCAL_SHARDS"]))
    assert hostmesh.maybe_init_distributed("cpu"), \
        "ORB_SLAM_TPU_COORDINATOR/NUM_PROCS/PROC_ID must be set"
    rank = hostmesh.process_index()
    D = hostmesh.device_count("cpu")
    out = dict(rank=rank, process_count=hostmesh.process_count(),
               local_devices=hostmesh.local_device_count("cpu"),
               global_devices=D)

    mesh2d = hostmesh.make_host_mesh(device="cpu")
    out["mesh_shape"] = list(mesh2d.devices.shape)
    own = mesh2d.own_shards()
    out["own_shards"] = [d for d, _ in own]
    tot, = mesh2d.psum([[torch.tensor(float(d))] for d, _ in own],
                       torch.device("cpu"))
    out["mesh_psum"] = float(tot)

    Rs, ts, X, fixed, edges = ba_problem()
    cam = make_camera(CameraConfig(
        fx=500.0, fy=500.0, cx=320.0, cy=240.0, k1=0.0, k2=0.0, p1=0.0,
        p2=0.0, k3=0.0, width=640, height=480), device="cpu")
    single = ba.bundle_adjust(Rs, ts, X, fixed, edges, cam, SolverConfig(),
                              two_phase=True, solver="dense")
    for solver in ("dense", "cg"):
        res = dist_ba.bundle_adjust_dist(
            Rs, ts, X, fixed, edges, cam, SolverConfig(), two_phase=True,
            n_shards=D, solver=solver)
        out[f"ba_{solver}"] = dict(
            R=_l(res.R), t=_l(res.t), X=_l(res.points),
            inliers=res.edge_inliers.int().tolist(),
            dR=_gap(res.R, single.R), dt=_gap(res.t, single.t),
            dX=_gap(res.points, single.points),
            inliers_equal=bool(torch.equal(res.edge_inliers,
                                           single.edge_inliers)))

    s0, R0, t0, gfixed, gedges = ring_graph()
    mesh1d = dist_ba.make_mesh(D, device="cpu")
    sd, Rd, td, _ = dist_pose_graph.optimize_essential_graph_dist(
        s0, R0, t0, gfixed, gedges, n_iters=8, mesh=mesh1d)
    ss, Rs1, ts1, _ = pose_graph.optimize_essential_graph(
        s0, R0, t0, gfixed, gedges, n_iters=8)
    out["graph"] = dict(s=_l(sd), R=_l(Rd), t=_l(td), ds=_gap(sd, ss),
                        dR=_gap(Rd, Rs1), dt=_gap(td, ts1))

    with open(os.environ["ORB_SLAM_TPU_TEST_OUT"] + f".{rank}", "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main()
