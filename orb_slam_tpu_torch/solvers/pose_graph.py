"""Essential-graph optimization: Gauss-Newton over Sim(3) keyframe poses
(port of ``orb_slam_tpu.solvers.pose_graph``).

Replaces Optimizer::OptimizeEssentialGraph (src/Optimizer.cc:540-789):
g2o's VertexSim3Expmap/EdgeSim3 graph becomes one batched residual
evaluation (the Sim3 log of each edge's relative-pose error) with
forward-mode Jacobians (``torch.func.jacfwd``), scatter-added into a dense
7K x 7K system and solved densely (K keyframes is a few hundred; the reference's 20 LM iterations
with lambda_init=1e-16, i.e. effectively Gauss-Newton, are kept).

Edges (Optimizer.cc:566-729): spanning tree + existing loop edges + strong
covisibility (weight >= 100) + the new loop connections; all with identity
7x7 information.  Residual for edge (i, j) with measurement Shat_ij:
    r = log_sim3( Shat_ij^-1 o S_i o S_j^-1 )  in R^7
After convergence the caller re-maps landmarks via their reference keyframe
(correct_points) and converts Sim3 back to SE3 by folding scale into
translation (Optimizer.cc:731-789).

The iterations run in true float32 (TF32 off) and make no host sync: the
dense solve skips torch's error check and the all-finite guard selects
with ``torch.where``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import true_fp32
from ..geometry import sim3

_EPS = 1e-9


def _safe_so3_log(R):
    """R[..., 3, 3] -> omega[..., 3], differentiable at the identity."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    wnorm = torch.sqrt(torch.sum(w * w, dim=-1) + _EPS)  # differentiable at 0
    theta = torch.atan2(wnorm, tr - 1.0)
    scale = torch.where(wnorm < 1e-6, 0.5 + theta * theta / 12.0,
                        theta / torch.clamp(2.0 * 0.5 * wnorm, min=_EPS))
    return scale[..., None] * w


def _sim3_log(s, R, t):
    """Differentiation-safe Sim3 log (r7 = [ups, omega, sigma]); V is
    damped by 1e-9 I, unlike ``sim3.log``."""
    sigma = torch.log(torch.clamp(s, min=1e-12))
    omega = _safe_so3_log(R)
    V = sim3._v_matrix(omega, sigma)
    eye = torch.eye(3, dtype=V.dtype, device=V.device)
    ups = torch.linalg.solve_ex(V + _EPS * eye, t[..., None],
                                check_errors=False).result[..., 0]
    return torch.cat([ups, omega, sigma[..., None]], dim=-1)


class Sim3Edges(NamedTuple):
    i: torch.Tensor        # [E] int64
    j: torch.Tensor        # [E] int64
    s_meas: torch.Tensor   # [E]
    R_meas: torch.Tensor   # [E, 3, 3]
    t_meas: torch.Tensor   # [E, 3]
    valid: torch.Tensor    # [E] bool


def _edge_residual(si, Ri, ti, sj, Rj, tj, sm, Rm, tm):
    """r = log( Shat_ij^-1 o S_i o S_j^-1 )."""
    sji, Rji, tji = sim3.inverse(sj, Rj, tj)
    s_ij, R_ij, t_ij = sim3.compose(si, Ri, ti, sji, Rji, tji)
    smi, Rmi, tmi = sim3.inverse(sm, Rm, tm)
    se_, Re_, te_ = sim3.compose(smi, Rmi, tmi, s_ij, R_ij, t_ij)
    return _sim3_log(se_, Re_, te_)


def _edge_residual_tangent(xi_i, xi_j, si, Ri, ti, sj, Rj, tj, sm, Rm, tm):
    """Residual after left-multiplicative tangent updates (for autodiff)."""
    dsi, dRi, dti = sim3.exp(xi_i)
    dsj, dRj, dtj = sim3.exp(xi_j)
    si2, Ri2, ti2 = sim3.compose(dsi, dRi, dti, si, Ri, ti)
    sj2, Rj2, tj2 = sim3.compose(dsj, dRj, dtj, sj, Rj, tj)
    return _edge_residual(si2, Ri2, ti2, sj2, Rj2, tj2, sm, Rm, tm)


def _residual_and_jacobians(si, Ri, ti, sj, Rj, tj, sm, Rm, tm):
    """Per edge: r [E, 7] and its Jacobians [E, 7, 7] in the two tangents
    at zero.  Edge e's residual depends on no other edge's tangent, so the
    derivative along one 7-vector broadcast to every edge is each edge's
    own Jacobian, the JAX package's per-edge jacfwd.  Taking it that way,
    and not as a vmap over the edges, keeps every tangent-carrying value at
    least 1-d: torch.func's forward mode turns the tangent of a 0-d tensor
    times a Python float into float64."""
    E = si.shape[0]

    def f(xi_i, xi_j):
        r = _edge_residual_tangent(xi_i.expand(E, 7), xi_j.expand(E, 7),
                                   si, Ri, ti, sj, Rj, tj, sm, Rm, tm)
        return r, r

    z = torch.zeros(7, dtype=si.dtype, device=si.device)
    (Ji, Jj), r = torch.func.jacfwd(f, argnums=(0, 1), has_aux=True)(z, z)
    return r, Ji, Jj


def optimize_essential_graph(
    s: torch.Tensor,       # [K]
    R: torch.Tensor,       # [K, 3, 3]
    t: torch.Tensor,       # [K, 3]
    fixed: torch.Tensor,   # [K] bool (the loop keyframe, Optimizer.cc:576)
    edges: Sim3Edges,
    n_iters: int = 20,
):
    """Returns (s, R, t, costs): the optimized poses and the cost of each
    iteration [n_iters], taken before its update."""
    with true_fp32():
        return _optimize_essential_graph(s, R, t, fixed, edges, n_iters)


def _optimize_essential_graph(s, R, t, fixed, edges, n_iters):
    K = s.shape[0]
    costs = []
    for _ in range(n_iters):
        H, b, cost = _normal_equations(s, R, t, fixed, edges)
        dx = -torch.linalg.solve_ex(H, b, check_errors=False).result
        s1, R1, t1 = sim3.retract(s, R, t, dx.reshape(K, 7))
        ok = torch.all(torch.isfinite(dx))
        s = torch.where(ok, s1, s)
        R = torch.where(ok, R1, R)
        t = torch.where(ok, t1, t)
        costs.append(cost)
    return s, R, t, torch.stack(costs)


def _normal_equations(s, R, t, fixed, edges: Sim3Edges):
    """One Gauss-Newton system at the poses (s, R, t): H [7K, 7K] and b
    [7K] with the fixed vertices' rows and columns cleared and
    (1 - free + 1e-6) I added to every diagonal block, and the weighted
    cost sum(w r^2) at these poses."""
    H, b, cost = _edge_system(s, R, t, edges)
    H, b = _gauge(H, b, fixed)
    return H, b, cost


def _edge_system(s, R, t, edges: Sim3Edges):
    """The edges' sums: H [7K, 7K], b [7K] and the cost sum(w r^2), before
    the gauge (a sharded solve sums these over its shards)."""
    K = s.shape[0]
    dev, dt = s.device, s.dtype
    ei = edges.i.to(device=dev, dtype=torch.int64)
    ej = edges.j.to(device=dev, dtype=torch.int64)
    w = edges.valid.to(dt)
    r, Ji, Jj = _residual_and_jacobians(
        s[ei], R[ei], t[ei], s[ej], R[ej], t[ej],
        edges.s_meas, edges.R_meas, edges.t_meas)
    Hii = torch.einsum("eab,e,eac->ebc", Ji, w, Ji)
    Hjj = torch.einsum("eab,e,eac->ebc", Jj, w, Jj)
    Hij = torch.einsum("eab,e,eac->ebc", Ji, w, Jj)
    bi = torch.einsum("eab,e,ea->eb", Ji, w, r)
    bj = torch.einsum("eab,e,ea->eb", Jj, w, r)

    # flat positions of the four 7x7 blocks of each edge in H; repeated
    # (i, j) pairs accumulate, as .at[].add
    a = torch.arange(7, device=dev)

    def block_idx(p, q):
        rows = (p[:, None, None] * 7 + a[None, :, None]) * (7 * K)
        return (rows + q[:, None, None] * 7 + a[None, None, :]).reshape(-1)

    H = torch.zeros(7 * K * 7 * K, dtype=dt, device=dev)
    H.index_add_(0, torch.cat([block_idx(ei, ei), block_idx(ej, ej),
                               block_idx(ei, ej), block_idx(ej, ei)]),
                 torch.cat([Hii, Hjj, Hij, Hij.transpose(1, 2)]).reshape(-1))
    b = torch.zeros(7 * K, dtype=dt, device=dev)
    b.index_add_(0, torch.cat([(ei[:, None] * 7 + a).reshape(-1),
                               (ej[:, None] * 7 + a).reshape(-1)]),
                 torch.cat([bi, bj]).reshape(-1))

    return H.reshape(7 * K, 7 * K), b, torch.sum(r * r * w[:, None])


def _gauge(H, b, fixed):
    """Clear the fixed vertices' rows and columns of (H, b) and add
    (1 - free + 1e-6) I to every diagonal block."""
    free = (~fixed.to(H.device)).to(H.dtype).repeat_interleave(7)  # [7K]
    H = H * free[:, None] * free[None, :]
    H.diagonal().add_(1.0 - free + 1e-6)
    return H, b * free


def correct_points(
    mp_pos: torch.Tensor,      # [P, 3] world positions
    ref_kf: torch.Tensor,      # [P] reference keyframe per point
    s_old, R_old, t_old,       # pre-optimization keyframe Sim3 (world->cam)
    s_new, R_new, t_new,       # post-optimization
):
    """Re-map landmarks through their reference keyframe
    (Optimizer.cc:746-779): X' = S_new_ref^-1 ( S_old_ref (X) )."""
    with true_fp32():
        ref = torch.clamp(ref_kf.long(), 0, s_old.shape[0] - 1)
        Xc = sim3.transform(s_old[ref], R_old[ref], t_old[ref], mp_pos)
        sni, Rni, tni = sim3.inverse(s_new[ref], R_new[ref], t_new[ref])
        return sim3.transform(sni, Rni, tni, Xc)
