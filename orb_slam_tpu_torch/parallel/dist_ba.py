"""Distributed bundle adjustment: landmark-sharded Schur reduction over a
device mesh (port of ``orb_slam_tpu.parallel.dist_ba``).

Layout:
  * cameras (keyframe poses) are REPLICATED: the reduced camera system is
    small (6K x 6K) and every process needs it;
  * landmarks and their observations are SHARDED over the mesh: every
    edge lives on the shard that owns its landmark, so the per-landmark
    3x3 Schur elimination is local to the shard;
  * each shard assembles its partial reduced camera system
    S_sub = W Hpp^-1 W^T over its landmarks, and one psum over the mesh
    (``hostmesh.Mesh.psum``: a sum over the process's own shards, then one
    ``all_reduce`` across processes) yields the full reduced system;
  * the dense solve runs replicated (identical on every process, no
    broadcast), landmark back-substitution is local again.

Communication per LM iteration: one psum of [K, 6, K, 6] + [K, 6, 6] +
2 x [K, 6], and one of the costs and the non-finite count, independent of
the landmark count.  The ``cg`` solver never forms S: every CG matvec
costs one [K, 6] psum.

Every process holds the full problem (SLAM state is deterministic per
process) and uploads only the shards it owns (``_put_shards``); the
sharded outputs come back whole through ``Mesh.gather``.  The partition is
host numpy, equal to the JAX package's array for array; the solve runs in
true float32 (``device.true_fp32``, the counterpart of the JAX package's
``ba_matmul_precision``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import SolverConfig
from ..device import true_fp32
from ..geometry import se3
from ..geometry.camera import CameraParams
from ..solvers.bundle_adjust import (BAEdges, BAResult, _edge_terms,
                                     _pcg_solve, _robust_cost, _scatter_rows)
from ..solvers.pose_opt import _huber_weight
from .hostmesh import Mesh, make_mesh

class ShardedBAProblem(NamedTuple):
    """Host-partitioned BA problem (numpy): leading axis = shard."""

    Xs: np.ndarray           # [D, P_shard, 3] float32 landmarks
    cam_idx: np.ndarray      # [D, O_shard] int32
    pt_idx: np.ndarray       # [D, O_shard] int32, LOCAL landmark index
    uv: np.ndarray           # [D, O_shard, 2] float32
    inv_sigma2: np.ndarray   # [D, O_shard] float32
    valid: np.ndarray        # [D, O_shard] bool
    src_idx: Optional[np.ndarray] = None  # [D, O_shard] int64 original
    #                                       edge index (-1 padding)
    n_points: int = 0        # true (unpadded) landmark count
    perm: Optional[np.ndarray] = None  # [P_total] original -> packed rank
    #                                    (spatial strategy), else None


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length()


def _morton3(q: np.ndarray) -> np.ndarray:
    """[P, 3] uint32 (10-bit) -> interleaved 30-bit Morton codes."""
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x30000FF)
        v = (v | (v << 8)) & np.uint64(0x300F00F)
        v = (v | (v << 4)) & np.uint64(0x30C30C3)
        v = (v | (v << 2)) & np.uint64(0x9249249)
        return v
    return (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))


def partition_problem(Xs, edges: BAEdges, n_shards: int,
                      o_shard: Optional[int] = None,
                      strategy: str = "index") -> ShardedBAProblem:
    """Partition landmarks across shards and route each edge to its
    landmark's shard (host-side, keyframe-rate).  FLAT edges only.

    strategy="index" keeps allocation order (SLAM allocation is roughly
    temporal, so contiguous blocks are already map-local for exploration);
    strategy="spatial" is map-block sharding: landmarks are Morton-ordered
    so each shard owns a compact spatial block, which keeps each shard's
    edges on few keyframes under revisits.

    Per-shard edge capacity is padded to `o_shard` if given, else to the
    next power of two, as in the JAX package (whose compile buckets it
    keeps; padded edges carry valid=False and weigh nothing)."""
    if edges.cam_idx is None:
        raise ValueError("the sharded BA takes the FLAT edge layout")
    Xs = _np(Xs)
    P_total = Xs.shape[0]
    P_shard = -(-P_total // n_shards)
    pt = _np(edges.pt_idx)

    perm = None
    if strategy == "spatial" and P_total > 0:
        lo = Xs.min(axis=0)
        span = np.maximum(Xs.max(axis=0) - lo, 1e-9)
        q = np.clip(((Xs - lo) / span * 1023), 0, 1023).astype(np.uint32)
        order = np.argsort(_morton3(q), kind="stable")  # packed -> orig
        perm = np.empty(P_total, np.int64)              # orig -> packed
        perm[order] = np.arange(P_total)
        Xs = Xs[order]
        pt = perm[pt]
    elif strategy not in ("index", "spatial"):
        raise ValueError(f"unknown strategy {strategy!r}")

    owner = np.clip(pt // P_shard, 0, n_shards - 1)
    local_pt = pt - owner * P_shard

    ev = _np(edges.valid)
    per_shard = [np.where((owner == d) & ev)[0] for d in range(n_shards)]
    O_raw = max([len(sel) for sel in per_shard] + [0])
    O_shard = o_shard if o_shard is not None else _next_pow2(max(O_raw, 1))

    D = n_shards
    cam_all, uv_all = _np(edges.cam_idx), _np(edges.uv)
    isig_all = _np(edges.inv_sigma2)
    cam_idx = np.zeros((D, O_shard), np.int32)
    pt_idx = np.zeros((D, O_shard), np.int32)
    uv = np.zeros((D, O_shard, 2), np.float32)
    isig = np.ones((D, O_shard), np.float32)
    val = np.zeros((D, O_shard), bool)
    src = np.full((D, O_shard), -1, np.int64)
    for d, sel in enumerate(per_shard):
        n = len(sel)
        cam_idx[d, :n] = cam_all[sel]
        pt_idx[d, :n] = local_pt[sel]
        uv[d, :n] = uv_all[sel]
        isig[d, :n] = isig_all[sel]
        val[d, :n] = True
        src[d, :n] = sel

    X_pad = np.zeros((D * P_shard, 3), np.float32)
    X_pad[:P_total] = Xs
    return ShardedBAProblem(
        Xs=X_pad.reshape(D, P_shard, 3), cam_idx=cam_idx, pt_idx=pt_idx,
        uv=uv, inv_sigma2=isig, valid=val, src_idx=src, n_points=P_total,
        perm=perm)


class _Shard(NamedTuple):
    index: int
    device: torch.device
    edges: BAEdges           # cam_idx / pt_idx int64
    Xs: torch.Tensor         # [P_shard, 3]


def _put_shards(mesh: Mesh, prob: ShardedBAProblem):
    """The shards this process owns, on their devices (the counterpart of
    the JAX package's ``_put_global``: every process holds the same full
    problem and gives the slices it owns)."""
    out = []
    for d, dev in mesh.own_shards():
        def up(a, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(a[d]))
            return t.to(device=dev, dtype=dtype)
        out.append(_Shard(d, dev, BAEdges(
            cam_idx=up(prob.cam_idx, torch.int64),
            pt_idx=up(prob.pt_idx, torch.int64), uv=up(prob.uv),
            inv_sigma2=up(prob.inv_sigma2), valid=up(prob.valid)),
            up(prob.Xs)))
    return out


def _fetch_global(mesh: Mesh, parts: dict, home: torch.device):
    """Full [D, ...] copy of a sharded output ({shard: tensor}, alike in
    shape), on `home`."""
    x = next(iter(parts.values()))
    return mesh.gather(parts, x.shape, x.dtype, home)


def _cam_on(cam: CameraParams, dev: torch.device) -> CameraParams:
    return cam._replace(**{f: v.to(dev) for f, v in cam._asdict().items()
                           if isinstance(v, torch.Tensor)})


def bundle_adjust_sharded(
    mesh: Mesh, Rs: torch.Tensor, ts: torch.Tensor,
    prob: ShardedBAProblem, fixed: torch.Tensor, cam: CameraParams,
    cfg: SolverConfig = SolverConfig(), n_iters: int = 15,
    axis: str = "data", two_phase: bool = False, solver: str = "dense",
    phase2: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distributed LM.  two_phase=True runs the reference local-BA schedule
    (cfg.local_ba_iters1 robust its, the chi2 outlier gate, then
    cfg.local_ba_iters2 plain its, Optimizer.cc:450-494; the gate is per
    edge, so gating each shard locally is the global gate); phase2=False
    stops after the gate (the interrupted schedule).  Otherwise n_iters
    robust its.  `axis` names the mesh axis the landmarks shard over; the
    mesh is 1D.  Returns (Rs, ts, Xs [D, P_shard, 3], edge_inliers
    [D, O_shard]) on Rs's device."""
    if solver not in ("dense", "cg"):
        raise ValueError(f"unknown solver {solver!r}")
    if axis not in mesh.axis_names or len(mesh.axis_names) != 1:
        raise ValueError(f"the sharded BA takes a 1D mesh over {axis!r}, "
                         f"got {mesh}")
    with true_fp32():
        return _bundle_adjust_sharded(mesh, Rs, ts, prob, fixed, cam, cfg,
                                      n_iters, two_phase, solver, phase2)


def _bundle_adjust_sharded(mesh, Rs, ts, prob, fixed, cam, cfg, n_iters,
                           two_phase, solver, phase2):
    home, dt = Rs.device, Rs.dtype
    K = Rs.shape[0]
    delta2 = cfg.huber_delta2
    shards = _put_shards(mesh, prob)
    cams = {s.device: _cam_on(cam, s.device) for s in shards}
    free = (~fixed.to(home)).to(dt)
    eye6 = torch.eye(6, dtype=dt, device=home)
    kk = torch.arange(K, device=home)
    Xl = [s.Xs for s in shards]

    def edge_terms(s, Rs_s, ts_s, X):
        return _edge_terms(Rs_s, ts_s, X, s.edges, cams[s.device])

    def replicate(x):
        """A replicated value on each shard's device."""
        return [x.to(s.device) for s in shards]

    def step(Rs, ts, Xl, lam, active, use_robust):
        Rr, tr = replicate(Rs), replicate(ts)
        lam_s = replicate(lam)
        loc = []                     # per-shard state for the back-solve
        first = []                   # per-shard partials of the first psum
        for s, X, R_s, t_s, a, lm in zip(shards, Xl, Rr, tr, active, lam_s):
            e = s.edges
            P_s = X.shape[0]
            r, Jc, Jp, z = edge_terms(s, R_s, t_s, X)
            c2 = torch.sum(r * r, dim=1) * e.inv_sigma2
            w = (_huber_weight(c2, delta2) if use_robust
                 else torch.ones_like(c2))
            w = w * e.inv_sigma2 * a * (z > 0)
            JcTJc = torch.einsum("oia,o,oib->oab", Jc, w, Jc)
            JpTJp = torch.einsum("oia,o,oib->oab", Jp, w, Jp)
            JcTJp = torch.einsum("oia,o,oib->oab", Jc, w, Jp)
            gc_o = torch.einsum("oia,o,oi->oa", Jc, w, r)
            gp_o = torch.einsum("oia,o,oi->oa", Jp, w, r)
            Hcc = _scatter_rows(K, e.cam_idx, JcTJc)
            Hpp = _scatter_rows(P_s, e.pt_idx, JpTJp)
            gc = _scatter_rows(K, e.cam_idx, gc_o)
            gp = _scatter_rows(P_s, e.pt_idx, gp_o)
            eye3 = torch.eye(3, dtype=dt, device=s.device)
            Hpp_d = (Hpp + lm * torch.diag_embed(torch.diagonal(
                Hpp, dim1=-2, dim2=-1)) + 1e-8 * eye3)
            Hpp_inv = torch.linalg.inv_ex(Hpp_d).inverse
            st = dict(r=r, z=z, gp=gp, A=JcTJp, Hpp_inv=Hpp_inv)
            if solver == "cg":
                # matrix-free: never build [P_shard, K, 6, 3]
                ci, pi = e.cam_idx, e.pt_idx
                y = torch.einsum("pab,pb->pa", Hpp_inv, gp)
                g_sub = _scatter_rows(K, ci, torch.einsum(
                    "oab,ob->oa", JcTJp, y[pi]))
                AH = torch.einsum("oab,obc->oac", JcTJp, Hpp_inv[pi])
                diag_sub = _scatter_rows(K, ci, torch.einsum(
                    "oac,obc->oab", AH, JcTJp))
                first.append([Hcc, gc, g_sub, diag_sub])
            else:
                U = torch.zeros((P_s, K, 6, 3), dtype=dt, device=s.device)
                U.index_put_((e.pt_idx, e.cam_idx), JcTJp, accumulate=True)
                M = torch.einsum("pkab,pbc->pkac", U, Hpp_inv)
                Mm = M.permute(1, 2, 0, 3).reshape(6 * K, 3 * P_s)
                Um = U.permute(1, 2, 0, 3).reshape(6 * K, 3 * P_s)
                S_sub = (Mm @ Um.T).reshape(K, 6, K, 6)
                g_sub = (Mm @ gp.reshape(-1)).reshape(K, 6)
                st["U"] = U
                # ---- the partials of the psum of reduced camera systems
                first.append([Hcc, gc, g_sub, S_sub])
            loc.append(st)

        Hcc, gc, g_sub, S_or_diag = mesh.psum(first, home)
        Hcc_d = (Hcc + lam * torch.diag_embed(torch.diagonal(
            Hcc, dim1=-2, dim2=-1)) + 1e-8 * eye6)

        if solver == "cg":
            g_red = (gc - g_sub) * free[:, None]
            S_diag = Hcc_d - S_or_diag
            S_diag = (S_diag * free[:, None, None]
                      + eye6 * (1.0 - free)[:, None, None] + 1e-8 * eye6)
            P_inv = torch.linalg.inv_ex(S_diag).inverse

            def matvec(v):
                vk = v.reshape(K, 6) * free[:, None]
                subs = []
                for s, st, vs in zip(shards, loc, replicate(vk)):
                    e = s.edges
                    yp = _scatter_rows(st["gp"].shape[0], e.pt_idx,
                                       torch.einsum("oab,oa->ob", st["A"],
                                                    vs[e.cam_idx]))
                    zp = torch.einsum("pab,pb->pa", st["Hpp_inv"], yp)
                    subs.append([_scatter_rows(K, e.cam_idx, torch.einsum(
                        "oab,ob->oa", st["A"], zp[e.pt_idx]))])
                sub, = mesh.psum(subs, home)
                out = torch.einsum("kab,kb->ka", Hcc_d, vk) - sub
                # as the JAX package: vk is already masked, so the fixed
                # rows come out zero
                out = out * free[:, None] + vk * (1.0 - free)[:, None]
                return out.reshape(-1)

            def precond(r):
                return torch.einsum("kab,kb->ka", P_inv,
                                    r.reshape(K, 6)).reshape(-1)

            dxc = -_pcg_solve(matvec, precond, g_red.reshape(-1), 48)
            dxc = dxc.reshape(K, 6) * free[:, None]
        else:
            S = -S_or_diag
            S[kk, :, kk, :] += Hcc_d
            g_red = gc - g_sub
            S = S * free[:, None, None, None] * free[None, None, :, None]
            S[kk, :, kk, :] += (1.0 - free)[:, None, None] * eye6
            g_red = g_red * free[:, None]
            dxc = -torch.linalg.solve_ex(
                S.reshape(6 * K, 6 * K), g_red.reshape(-1)).result
            dxc = dxc.reshape(K, 6)

        Rs1, ts1 = se3.retract(Rs, ts, dxc)
        R1r, t1r, dxr = replicate(Rs1), replicate(ts1), replicate(dxc)
        second, Xl1 = [], []
        for s, st, X, R_s, t_s, d_s, a in zip(shards, loc, Xl, R1r, t1r,
                                               dxr, active):
            e = s.edges
            if solver == "cg":
                up = _scatter_rows(X.shape[0], e.pt_idx, torch.einsum(
                    "oab,oa->ob", st["A"], d_s[e.cam_idx]))
            else:
                up = torch.einsum("pkac,ka->pc", st["U"], d_s)
            dxp = -torch.einsum("pab,pb->pa", st["Hpp_inv"], st["gp"] + up)
            X1 = X + dxp
            r1, _, _, _ = edge_terms(s, R_s, t_s, X1)
            # both costs sum the edges in front of their camera before the
            # step, as the single-device solver's accept test does
            second.append([
                _robust_cost(st["r"], st["z"], e.inv_sigma2, a, delta2),
                _robust_cost(r1, st["z"], e.inv_sigma2, a, delta2),
                torch.sum(~torch.isfinite(dxp)).to(dt)])
            Xl1.append(X1)
        cost_old, cost_new, bad_p = mesh.psum(second, home)
        accept = ((cost_new < cost_old) & torch.all(torch.isfinite(dxc))
                  & (bad_p == 0))
        Rs = torch.where(accept, Rs1, Rs)
        ts = torch.where(accept, ts1, ts)
        Xl = [torch.where(acc, X1, X)
              for acc, X1, X in zip(replicate(accept), Xl1, Xl)]
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        return Rs, ts, Xl, lam

    def run(Rs, ts, Xl, lam, active, n, use_robust):
        for _ in range(n):
            Rs, ts, Xl, lam = step(Rs, ts, Xl, lam, active, use_robust)
        return Rs, ts, Xl, lam

    def chi2_inliers(Rs, ts, Xl):
        out = []
        for s, X, R_s, t_s in zip(shards, Xl, replicate(Rs), replicate(ts)):
            e = s.edges
            r, _, _, z = edge_terms(s, R_s, t_s, X)
            c2 = torch.sum(r * r, dim=1) * e.inv_sigma2
            out.append(e.valid & (c2 <= cfg.local_ba_chi2) & (z > 0))
        return out

    lam = torch.full((), cfg.lm_lambda_init, dtype=dt, device=home)
    active = [s.edges.valid.to(dt) for s in shards]
    if two_phase:
        Rs, ts, Xl, lam = run(Rs, ts, Xl, lam, active,
                              cfg.local_ba_iters1, True)
        if phase2:
            active = [a.to(dt) for a in chi2_inliers(Rs, ts, Xl)]
            Rs, ts, Xl, lam = run(Rs, ts, Xl, lam, active,
                                  cfg.local_ba_iters2, False)
    else:
        Rs, ts, Xl, lam = run(Rs, ts, Xl, lam, active, n_iters, True)
    inl = chi2_inliers(Rs, ts, Xl)
    Xs = _fetch_global(mesh, {s.index: X for s, X in zip(shards, Xl)}, home)
    inl = _fetch_global(mesh, {s.index: i.to(torch.uint8)
                               for s, i in zip(shards, inl)}, home)
    return Rs, ts, Xs, inl.bool()


def bundle_adjust_dist(
    Rs, ts, Xs, fixed, edges: BAEdges, cam: CameraParams,
    cfg: SolverConfig = SolverConfig(), two_phase: bool = True,
    n_shards: Optional[int] = None, mesh: Optional[Mesh] = None,
    solver: str = "auto", strategy: str = "index", axis: str = "data",
    phase2: bool = True,
) -> BAResult:
    """Drop-in replacement for solvers.bundle_adjust.bundle_adjust over a
    device mesh: landmark-sharded Schur + psum of reduced camera systems.
    The LocalMapper's BA when cfg.mesh.data_parallel > 1 and the mesh has
    that many devices.  solver="auto" is "cg" when the per-shard dense
    block grid [P_shard, K, 6, 3] passes 256 MB, else "dense".  The
    result's points and edge inliers are in the caller's order (the
    spatial strategy's permutation undone); cost is 0, as the JAX
    package returns it."""
    if mesh is None:
        mesh = make_mesh(n_shards, axis=axis, device=Rs.device)
    else:
        axis = mesh.axis_names[0]
    D = mesh.size
    prob = partition_problem(Xs, edges, D, strategy=strategy)
    if solver == "auto":
        grid_mb = prob.Xs.shape[1] * Rs.shape[0] * 18 * 4 / 1e6
        solver = "cg" if grid_mb > 256.0 else "dense"
    home = Rs.device
    Rs1, ts1, Xsh, inl_sh = bundle_adjust_sharded(
        mesh, Rs, ts, prob, fixed, cam, cfg, axis=axis,
        n_iters=cfg.global_ba_iters, two_phase=two_phase, solver=solver,
        phase2=phase2)
    X_full = Xsh.reshape(-1, 3)[: prob.n_points]
    if prob.perm is not None:         # spatial strategy: allocation order
        X_full = X_full[torch.from_numpy(prob.perm).to(home)]
    # per-shard edge inliers back to the caller's edge order
    src = torch.from_numpy(prob.src_idx.reshape(-1)).to(home)
    ok = src >= 0
    inl = torch.zeros(int(edges.cam_idx.shape[0]), dtype=torch.bool,
                      device=home)
    inl[src[ok]] = inl_sh.reshape(-1)[ok]
    blob = torch.cat([Rs1.reshape(-1), ts1.reshape(-1), X_full.reshape(-1),
                      inl.to(torch.float32)])
    return BAResult(R=Rs1, t=ts1, points=X_full, edge_inliers=inl,
                    cost=torch.zeros((), dtype=Rs.dtype, device=home),
                    host_blob=blob)
