"""Bundle adjustment: batched Levenberg-Marquardt with Schur reduction of
the landmark blocks (port of ``orb_slam_tpu.solvers.bundle_adjust``, its
live default: the FLAT edge layout and the dense reduced solve).

Replaces g2o's BlockSolver + OptimizationAlgorithmLevenberg as used by
Optimizer::LocalBundleAdjustment / GlobalBundleAdjustemnt
(src/Optimizer.cc:38-152, :287-536).  Per LM iteration:
  1. residuals and analytic Jacobians of every edge at once,
  2. scatter-add of the 6x6 / 3x3 / 6x3 normal-equation blocks,
  3. closed-form 3x3 Cholesky of each landmark block,
  4. the Schur half-matrix G [6K, 3P] with S = Hcc - G G^T, one matmul,
  5. a dense solve of the reduced [6K, 6K] camera system (LU, as the JAX
     package's ``jnp.linalg.solve``; ``solve_ex`` so the host never waits),
  6. landmark back-substitution and the LM accept/reject by ``torch.where``.
The reference's two-phase schedule stays: 5 robust iterations, drop edges
with chi2 > 5.991 or negative depth, 10 more (Optimizer.cc:450-494); the
returned edge mask says which observations to erase (:496-521).  Problems
are sized exactly (the JAX package's pow2 padding was a compile
workaround).  Everything runs in true float32 (TF32 off), the reference's
``ba_matmul_precision="float32"`` contract.

The GRID layout and the PCG solver come with a later slice:
``ba_layout="grid"`` and ``solver="cg"`` raise NotImplementedError.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SolverConfig
from ..device import true_fp32
from ..geometry import se3
from ..geometry.camera import CameraParams
from .pose_opt import _huber_weight


class BAEdges(NamedTuple):
    """Observation edges, FLAT layout: a compacted edge list."""

    cam_idx: torch.Tensor     # [O] int64
    pt_idx: torch.Tensor      # [O] int64
    uv: torch.Tensor          # [O, 2] float32 undistorted pixels
    inv_sigma2: torch.Tensor  # [O] float32
    valid: torch.Tensor       # [O] bool


class BAResult(NamedTuple):
    R: torch.Tensor             # [K, 3, 3]
    t: torch.Tensor             # [K, 3]
    points: torch.Tensor        # [P, 3]
    edge_inliers: torch.Tensor  # [O] bool (valid & chi2 below gate & z>0)
    cost: torch.Tensor          # final robust cost
    # float32 [9K + 3K + 3P + O] packed (R, t, points, inliers): the
    # caller's write-back fetches once
    host_blob: Optional[torch.Tensor] = None


def _edge_terms(Rs, ts, Xs, edges: BAEdges, cam: CameraParams):
    """Residuals and Jacobians of every edge: r [O,2], Jc [O,2,6],
    Jp [O,2,3], z [O]."""
    Rk = Rs[edges.cam_idx]
    tk = ts[edges.cam_idx]
    Xp = Xs[edges.pt_idx]
    xc = torch.einsum("oij,oj->oi", Rk, Xp) + tk
    x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
    zi = 1.0 / torch.clamp(z, min=1e-6)
    u = x * zi * cam.fx + cam.cx
    v = y * zi * cam.fy + cam.cy
    r = torch.stack([u, v], dim=1) - edges.uv

    fx, fy = cam.fx, cam.fy
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    Jpi = torch.stack([
        torch.stack([fx * zi, zero, -fx * x * zi2], dim=1),
        torch.stack([zero, fy * zi, -fy * y * zi2], dim=1)], dim=1)
    eye = torch.eye(3, dtype=Xs.dtype, device=Xs.device).expand(
        xc.shape[0], 3, 3)
    dxc = torch.cat([eye, -se3.hat(xc)], dim=2)        # [O, 3, 6]
    return r, Jpi @ dxc, Jpi @ Rk, z


def _robust_cost(r, z, inv_sigma2, active, delta2):
    c2 = torch.sum(r * r, dim=-1) * inv_sigma2
    d = float(np.sqrt(np.float32(delta2)))     # float32 sqrt, as jnp.sqrt
    rho = torch.where(c2 <= delta2, c2,
                      2.0 * d * torch.sqrt(torch.clamp(c2, min=1e-12))
                      - delta2)
    return torch.sum(rho * active * (z > 0))


def _chol3(A):
    """Closed-form batched 3x3 lower Cholesky."""
    a00 = torch.sqrt(torch.clamp(A[..., 0, 0], min=1e-20))
    l10 = A[..., 1, 0] / a00
    l20 = A[..., 2, 0] / a00
    a11 = torch.sqrt(torch.clamp(A[..., 1, 1] - l10 * l10, min=1e-20))
    l21 = (A[..., 2, 1] - l20 * l10) / a11
    a22 = torch.sqrt(torch.clamp(A[..., 2, 2] - l20 * l20 - l21 * l21,
                                 min=1e-20))
    z = torch.zeros_like(a00)
    return torch.stack([torch.stack([a00, z, z], -1),
                        torch.stack([l10, a11, z], -1),
                        torch.stack([l20, l21, a22], -1)], -2)


def _inv_lower3(L):
    """Closed-form inverse of a batched lower-triangular 3x3."""
    i00 = 1.0 / L[..., 0, 0]
    i11 = 1.0 / L[..., 1, 1]
    i22 = 1.0 / L[..., 2, 2]
    i10 = -L[..., 1, 0] * i00 * i11
    i20 = ((L[..., 1, 0] * L[..., 2, 1] - L[..., 2, 0] * L[..., 1, 1])
           * i00 * i11 * i22)
    i21 = -L[..., 2, 1] * i11 * i22
    z = torch.zeros_like(i00)
    return torch.stack([torch.stack([i00, z, z], -1),
                        torch.stack([i10, i11, z], -1),
                        torch.stack([i20, i21, i22], -1)], -2)


def _half_schur(L, A, edges: BAEdges, K: int):
    """The Schur half-matrix Gd [6K, 3P] with S = Hcc_d - Gd Gd^T: the
    per-edge blocks U_o L_{p(o)} placed once per iteration (L L^T =
    Hpp_d^-1).  Returns (Gd, Gblk [O, 6, 3])."""
    Gblk = torch.einsum("oab,obc->oac", A, L[edges.pt_idx])
    P = L.shape[0]
    G4 = torch.zeros((K, P, 6, 3), dtype=Gblk.dtype, device=Gblk.device)
    G4.index_put_((edges.cam_idx, edges.pt_idx), Gblk, accumulate=True)
    return G4.permute(0, 2, 1, 3).reshape(6 * K, 3 * P), Gblk


def _scatter_rows(n: int, idx, vals):
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, idx, vals)


def _lm_phase(Rs, ts, Xs, fixed, edges: BAEdges, cam: CameraParams, lam,
              active, n_iters: int, use_robust: bool, delta2: float):
    K = Rs.shape[0]
    P = Xs.shape[0]
    dt, dev = Rs.dtype, Rs.device
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    free = (~fixed).to(dt)
    kk = torch.arange(K, device=dev)
    cost_new = torch.zeros((), dtype=dt, device=dev)
    for _ in range(n_iters):
        r, Jc, Jp, z = _edge_terms(Rs, ts, Xs, edges, cam)
        c2 = torch.sum(r * r, dim=-1) * edges.inv_sigma2
        w = _huber_weight(c2, delta2) if use_robust else torch.ones_like(c2)
        w = w * edges.inv_sigma2 * active * (z > 0)

        JcTJc = torch.einsum("oia,o,oib->oab", Jc, w, Jc)
        JpTJp = torch.einsum("oia,o,oib->oab", Jp, w, Jp)
        JcTJp = torch.einsum("oia,o,oib->oab", Jc, w, Jp)
        gc_o = torch.einsum("oia,o,oi->oa", Jc, w, r)
        gp_o = torch.einsum("oia,o,oi->oa", Jp, w, r)
        Hcc = _scatter_rows(K, edges.cam_idx, JcTJc)
        Hpp = _scatter_rows(P, edges.pt_idx, JpTJp)
        gc = _scatter_rows(K, edges.cam_idx, gc_o)
        gp = _scatter_rows(P, edges.pt_idx, gp_o)

        # LM damping (multiplicative on the block diagonals)
        Hcc_d = (Hcc + lam * torch.diag_embed(torch.diagonal(
            Hcc, dim1=-2, dim2=-1)) + 1e-8 * eye6)
        Hpp_d = (Hpp + lam * torch.diag_embed(torch.diagonal(
            Hpp, dim1=-2, dim2=-1)) + 1e-8 * eye3)

        # C C^T = Hpp_d, L = C^-T, Hpp_inv = L L^T = Ci^T Ci
        Ci = _inv_lower3(_chol3(Hpp_d))
        Hpp_inv = torch.einsum("pba,pbc->pac", Ci, Ci)
        y = torch.einsum("pab,pb->pa", Hpp_inv, gp)

        Gd, _ = _half_schur(Ci.transpose(1, 2), JcTJp, edges, K)
        g_red = gc - _scatter_rows(K, edges.cam_idx, torch.einsum(
            "oab,ob->oa", JcTJp, y[edges.pt_idx]))
        g_red = g_red * free[:, None]

        S = -(Gd @ Gd.T).reshape(K, 6, K, 6)
        S[kk, :, kk, :] += Hcc_d
        # gauge: fixed cameras get identity rows/cols, zero gradient
        S = S * free[:, None, None, None] * free[None, None, :, None]
        S[kk, :, kk, :] += (1.0 - free)[:, None, None] * eye6
        dxc = -torch.linalg.solve_ex(
            S.reshape(6 * K, 6 * K), g_red.reshape(-1)).result
        dxc = dxc.reshape(K, 6)

        up = _scatter_rows(P, edges.pt_idx, torch.einsum(
            "oab,oa->ob", JcTJp, dxc[edges.cam_idx]))
        dxp = -torch.einsum("pab,pb->pa", Hpp_inv, gp + up)

        Rs1, ts1 = se3.retract(Rs, ts, dxc)
        Xs1 = Xs + dxp

        r1, _, _, z1 = _edge_terms(Rs1, ts1, Xs1, edges, cam)
        cost_old = _robust_cost(r, z, edges.inv_sigma2, active, delta2)
        cost_new = _robust_cost(r1, z1, edges.inv_sigma2, active, delta2)
        accept = ((cost_new < cost_old) & torch.all(torch.isfinite(dxc))
                  & torch.all(torch.isfinite(dxp)))
        Rs = torch.where(accept, Rs1, Rs)
        ts = torch.where(accept, ts1, ts)
        Xs = torch.where(accept, Xs1, Xs)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
    return Rs, ts, Xs, lam, cost_new


def bundle_adjust(Rs, ts, Xs, fixed, edges: BAEdges, cam: CameraParams,
                  cfg: SolverConfig = SolverConfig(), two_phase: bool = True,
                  solver: str = "auto", phase2: bool = True,
                  layout: str = "flat") -> BAResult:
    """Local/global BA.  fixed: [K] bool gauge mask (at least one True).

    two_phase=True is the reference local-BA schedule (5 its, outlier
    removal at chi2 > 5.991 or z <= 0, 10 more); two_phase=False runs
    cfg.global_ba_iters robust iterations (init/global BA).  phase2=False
    is the aborted schedule (phase 1 and the outlier gate only)."""
    if layout != "flat":
        raise NotImplementedError(
            f"ba_layout={layout!r}: the GRID layout and its placement come "
            "with a later slice of the port; only 'flat' is ported")
    if solver not in ("auto", "dense"):
        raise NotImplementedError(
            f"solver={solver!r}: the PCG reduced solve comes with a later "
            "slice of the port; only the dense solve is ported")
    with true_fp32():
        return _bundle_adjust(Rs, ts, Xs, fixed, edges, cam, cfg, two_phase,
                              phase2)


def _bundle_adjust(Rs, ts, Xs, fixed, edges, cam, cfg, two_phase, phase2):
    delta2 = cfg.huber_delta2
    lam = torch.full((), cfg.lm_lambda_init, dtype=Rs.dtype,
                     device=Rs.device)
    active = edges.valid.to(Rs.dtype)

    if cfg.ba_normalize_world:
        # similarity-normalize the world for float32 conditioning:
        # X' = s(X - c), t' = s(t + R c); projections are invariant
        P_n = Xs.shape[0]
        hits = torch.zeros(P_n + 1, dtype=torch.int32,
                           device=Xs.device).index_add_(
            0, torch.where(edges.valid, edges.pt_idx,
                           torch.full_like(edges.pt_idx, P_n)),
            torch.ones_like(edges.pt_idx, dtype=torch.int32))[:P_n]
        seen_f = (hits > 0).to(Xs.dtype)
        n_seen = torch.clamp(seen_f.sum(), min=1.0)
        c = torch.sum(Xs * seen_f[:, None], dim=0) / n_seen
        rad = torch.linalg.vector_norm(Xs - c, dim=1)
        scale = 1.0 / torch.clamp(torch.sum(rad * seen_f) / n_seen, min=1e-6)
        Xs = (Xs - c) * scale
        ts = (ts + torch.einsum("kij,j->ki", Rs, c)) * scale

    def gate(Rs, ts, Xs):
        r, _, _, z = _edge_terms(Rs, ts, Xs, edges, cam)
        c2 = torch.sum(r * r, dim=-1) * edges.inv_sigma2
        return c2, edges.valid & (c2 <= cfg.local_ba_chi2) & (z > 0)

    if two_phase:
        Rs, ts, Xs, lam, _ = _lm_phase(
            Rs, ts, Xs, fixed, edges, cam, lam, active,
            n_iters=cfg.local_ba_iters1, use_robust=True, delta2=delta2)
        c2, inl = gate(Rs, ts, Xs)
        if phase2:
            Rs, ts, Xs, lam, cost = _lm_phase(
                Rs, ts, Xs, fixed, edges, cam, lam, inl.to(Rs.dtype),
                n_iters=cfg.local_ba_iters2, use_robust=False,
                delta2=delta2)
        else:
            cost = torch.sum(torch.where(inl, c2, torch.zeros_like(c2)))
    else:
        Rs, ts, Xs, lam, cost = _lm_phase(
            Rs, ts, Xs, fixed, edges, cam, lam, active,
            n_iters=cfg.global_ba_iters, use_robust=True, delta2=delta2)

    _, inl = gate(Rs, ts, Xs)
    if cfg.ba_normalize_world:
        Xs = Xs / scale + c
        ts = ts / scale - torch.einsum("kij,j->ki", Rs, c)

    blob = torch.cat([Rs.reshape(-1), ts.reshape(-1), Xs.reshape(-1),
                      inl.to(torch.float32).reshape(-1)])
    return BAResult(R=Rs, t=ts, points=Xs, edge_inliers=inl, cost=cost,
                    host_blob=blob)
