"""Distributed essential-graph optimization: keyframe-block-sharded edges
over the device mesh (port of ``orb_slam_tpu.parallel.dist_pose_graph``).

The Sim3 pose graph (Optimizer::OptimizeEssentialGraph,
src/Optimizer.cc:540-789) has K keyframe vertices and E edges; the
per-iteration cost is the E residual and Jacobian evaluations, the system
H [7K, 7K] is small.  So the layout mirrors dist_ba:

  * poses are REPLICATED;
  * edges are SHARDED, grouped by the keyframe block of their `j` vertex
    so each shard owns a contiguous slice of the graph;
  * each shard assembles its partial (H, b) with the single-device
    solver's ``_edge_system``; ONE psum per Gauss-Newton iteration yields
    the full system, and the gauge and the dense solve run replicated.

Communication per iteration: one psum of [7K, 7K] + [7K], independent of
the edge count.  The iterations run in true float32, as the single-device
graph does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import true_fp32
from ..geometry import sim3
from ..solvers.pose_graph import Sim3Edges, _edge_system, _gauge
from .hostmesh import Mesh, device_count, make_mesh

# below this many edges per shard the psum costs more than the edge work
# saves (the JAX package measured a 100x slowdown at 60 edges per shard)
MIN_EDGES_PER_SHARD = 512


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def partition_edges(edges: Sim3Edges, n_kf: int, n_shards: int) -> Sim3Edges:
    """Group edges into n_shards by the keyframe block of vertex j
    (contiguous blocks of ceil(K / n_shards) keyframes), padded to a
    uniform power-of-two per-shard count.  Returns host numpy Sim3Edges
    with a leading shard axis, equal to the JAX package's."""
    kf_block = -(-n_kf // n_shards)
    i_all, j = _np(edges.i), _np(edges.j)
    ev = _np(edges.valid)
    owner = np.clip(j // kf_block, 0, n_shards - 1)

    per_shard = [np.where((owner == d) & ev)[0] for d in range(n_shards)]
    E_raw = max(1, max(len(sl) for sl in per_shard))
    E_shard = 1 << (E_raw - 1).bit_length()

    D = n_shards
    sm_all, Rm_all, tm_all = (_np(edges.s_meas), _np(edges.R_meas),
                              _np(edges.t_meas))
    ii = np.zeros((D, E_shard), np.int32)
    jj = np.zeros((D, E_shard), np.int32)
    sm = np.ones((D, E_shard), np.float32)
    Rm = np.tile(np.eye(3, dtype=np.float32), (D, E_shard, 1, 1))
    tm = np.zeros((D, E_shard, 3), np.float32)
    vv = np.zeros((D, E_shard), bool)
    for d, sl in enumerate(per_shard):
        n = len(sl)
        ii[d, :n] = i_all[sl]
        jj[d, :n] = j[sl]
        sm[d, :n] = sm_all[sl]
        Rm[d, :n] = Rm_all[sl]
        tm[d, :n] = tm_all[sl]
        vv[d, :n] = True
    return Sim3Edges(i=ii, j=jj, s_meas=sm, R_meas=Rm, t_meas=tm, valid=vv)


def _put_edge_shards(mesh: Mesh, e: Sim3Edges, dtype):
    """This process's edge shards on their devices."""
    out = []
    for d, dev in mesh.own_shards():
        def up(a, dt=None):
            return torch.from_numpy(np.ascontiguousarray(a[d])).to(
                device=dev, dtype=dt)
        out.append((dev, Sim3Edges(
            i=up(e.i, torch.int64), j=up(e.j, torch.int64),
            s_meas=up(e.s_meas, dtype), R_meas=up(e.R_meas, dtype),
            t_meas=up(e.t_meas, dtype), valid=up(e.valid))))
    return out


def optimize_essential_graph_sharded(
    mesh: Mesh, s: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
    fixed: torch.Tensor, sharded_edges: Sim3Edges, n_iters: int = 20,
    axis: str = "data",
):
    """Distributed twin of solvers.pose_graph.optimize_essential_graph:
    the same math, the edge work sharded, one psum of (H, b) per
    iteration.  Returns (s, R, t) on s's device."""
    if axis not in mesh.axis_names or len(mesh.axis_names) != 1:
        raise ValueError(f"the sharded graph takes a 1D mesh over {axis!r}, "
                         f"got {mesh}")
    with true_fp32():
        home, K = s.device, s.shape[0]
        shards = _put_edge_shards(mesh, sharded_edges, s.dtype)
        for _ in range(n_iters):
            parts = []
            for dev, e in shards:
                H, b, _ = _edge_system(s.to(dev), R.to(dev), t.to(dev), e)
                parts.append([H, b])
            # ---- the collective: psum of the reduced pose system ----
            H, b = mesh.psum(parts, home)
            H, b = _gauge(H, b, fixed)
            dx = -torch.linalg.solve_ex(H, b, check_errors=False).result
            s1, R1, t1 = sim3.retract(s, R, t, dx.reshape(K, 7))
            ok = torch.all(torch.isfinite(dx))
            s = torch.where(ok, s1, s)
            R = torch.where(ok, R1, R)
            t = torch.where(ok, t1, t)
        return s, R, t


def optimize_essential_graph_dist(
    s, R, t, fixed, edges: Sim3Edges, n_iters: int = 20,
    n_shards: Optional[int] = None, mesh: Optional[Mesh] = None,
    axis: str = "data",
):
    """Drop-in twin of pose_graph.optimize_essential_graph over a mesh;
    returns (s, R, t, None).

    Without a mesh, the shard count is cut to at most E // 512 (and at
    least 1): sharding a few hundred edges is all collective overhead.
    Keyframe-block sharding pays off when per-shard edge counts amortize
    the psum, i.e. at city scale."""
    E = int(_np(edges.valid).sum())
    if mesh is None:
        want = n_shards or device_count(s.device.type)
        want = max(1, min(want, E // MIN_EDGES_PER_SHARD or 1))
        mesh = make_mesh(want, axis=axis, device=s.device)
    else:
        axis = mesh.axis_names[0]
    sharded = partition_edges(edges, s.shape[0], mesh.size)
    s1, R1, t1 = optimize_essential_graph_sharded(
        mesh, s, R, t, fixed, sharded, n_iters=n_iters, axis=axis)
    return s1, R1, t1, None
