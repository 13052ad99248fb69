"""Bundle adjustment: batched Levenberg-Marquardt with Schur reduction of
the landmark blocks (port of ``orb_slam_tpu.solvers.bundle_adjust``: both
edge layouts, both placements of the grid's half-matrix, the dense and the
PCG reduced solve).

Replaces g2o's BlockSolver + OptimizationAlgorithmLevenberg as used by
Optimizer::LocalBundleAdjustment / GlobalBundleAdjustemnt
(src/Optimizer.cc:38-152, :287-536).  Per LM iteration:
  1. residuals and analytic Jacobians of every edge at once,
  2. the 6x6 / 3x3 / 6x3 normal-equation blocks: scatter-adds over the
     FLAT edge list, or per-row reductions over the GRID's camera rows
     (only the point-indexed blocks scatter),
  3. closed-form 3x3 Cholesky of each landmark block,
  4. the Schur half-matrix G [6K, 3P] with S = Hcc - G G^T,
  5. the reduced [6K, 6K] camera system: "dense" forms S with one matmul
     and solves it (LU, as the JAX package's ``jnp.linalg.solve``;
     ``solve_ex`` so the host never waits); "cg" never forms S and runs
     warm-started two-level PCG whose matvecs are two G products,
  6. landmark back-substitution and the LM accept/reject by ``torch.where``.
The reference's two-phase schedule stays: 5 robust iterations, drop edges
with chi2 > 5.991 or negative depth, 10 more (Optimizer.cc:450-494); the
returned edge mask says which observations to erase (:496-521).  Problems
are sized exactly (the JAX package's pow2 padding was a compile
workaround).  Everything runs in true float32 (TF32 off), the reference's
``ba_matmul_precision="float32"`` contract, and nothing in an LM or CG
iteration makes the host wait for the card.
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

# both solvers hold G [6K, 3P] float32; past this the landmark-sharded
# solver is the tool (the JAX package's single-chip threshold)
G_BYTES_MAX = 8 << 30


class BAEdges(NamedTuple):
    """Observation edges, in one of two layouts:

    FLAT (cam_idx is an [O] tensor): a compacted edge list.

    GRID (cam_idx is None, the other fields lead with [K, N]): the
    camera-major observation table, row k holding keyframe k's N slots
    verbatim (invalid slots masked).  It is how the map stores
    observations (kf_obs [K, N]); Hcc, gc and the reduced gradient become
    per-row reductions and G's placement a single-index scatter."""

    cam_idx: Optional[torch.Tensor]  # [O] int64, or None for GRID
    pt_idx: torch.Tensor      # [O] / [K, N] int64
    uv: torch.Tensor          # [O, 2] / [K, N, 2] float32 undistorted pixels
    inv_sigma2: torch.Tensor  # [O] / [K, N] float32
    valid: torch.Tensor       # [O] / [K, N] bool


class BAResult(NamedTuple):
    R: torch.Tensor             # [K, 3, 3]
    t: torch.Tensor             # [K, 3]
    points: torch.Tensor        # [P, 3]
    edge_inliers: torch.Tensor  # [O] / [K, N] bool (valid & chi2 & z>0)
    cost: torch.Tensor          # final robust cost
    # float32 [9K + 3K + 3P + O] packed (R, t, points, inliers flattened):
    # the caller's write-back fetches once
    host_blob: Optional[torch.Tensor] = None


def _project_terms(xc, R, uv, cam: CameraParams):
    """Residuals and Jacobians from camera-frame points xc [..., 3]; R
    broadcasts against the edges' [..., 3, 3] rotations."""
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    zi = 1.0 / torch.clamp(z, min=1e-6)
    u = x * zi * cam.fx + cam.cx
    v = y * zi * cam.fy + cam.cy
    r = torch.stack([u, v], dim=-1) - uv

    fx, fy = cam.fx, cam.fy
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    Jpi = torch.stack([
        torch.stack([fx * zi, zero, -fx * x * zi2], dim=-1),
        torch.stack([zero, fy * zi, -fy * y * zi2], dim=-1)], dim=-2)
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(
        xc.shape + (3,))
    dxc = torch.cat([eye, -se3.hat(xc)], dim=-1)       # [..., 3, 6]
    return r, Jpi @ dxc, Jpi @ R, z


def _edge_terms(Rs, ts, Xs, edges: BAEdges, cam: CameraParams):
    """FLAT edges: r [O,2], Jc [O,2,6], Jp [O,2,3], z [O]."""
    Rk = Rs[edges.cam_idx]
    xc = (torch.einsum("oij,oj->oi", Rk, Xs[edges.pt_idx])
          + ts[edges.cam_idx])
    return _project_terms(xc, Rk, edges.uv, cam)


def _edge_terms_grid(Rs, ts, Xs, pt, uv, cam: CameraParams):
    """GRID edges (pt, uv lead with [K, N]; camera k owns row k, so there
    is no camera gather): r [K,N,2], Jc [K,N,2,6], Jp [K,N,2,3], z [K,N]."""
    xc = torch.einsum("kij,knj->kni", Rs, Xs[pt]) + ts[:, None, :]
    return _project_terms(xc, Rs[:, None], uv, cam)


def _terms_any(Rs, ts, Xs, edges: BAEdges, cam: CameraParams):
    """_edge_terms for either layout; outputs are edge-major ([O, ...]
    flat, [K, N, ...] grid)."""
    if edges.cam_idx is None:
        return _edge_terms_grid(Rs, ts, Xs, edges.pt_idx, edges.uv, cam)
    return _edge_terms(Rs, ts, Xs, edges, cam)


def _robust_cost(r, z, inv_sigma2, active, delta2):
    c2 = torch.sum(r * r, dim=-1) * inv_sigma2
    d = float(np.sqrt(np.float32(delta2)))     # float32 sqrt, as jnp.sqrt
    rho = torch.where(c2 <= delta2, c2,
                      2.0 * d * torch.sqrt(torch.clamp(c2, min=1e-12))
                      - delta2)
    return torch.sum(rho * active * (z > 0))


def _pcg_solve(matvec, precond, b, n_iters: int, x0=None):
    """Fixed-budget preconditioned conjugate gradient on the reduced camera
    system.  The guards are ``torch.where`` on device scalars, so the
    n_iters steps queue without a host wait.  x0: an optional warm start
    (the previous accepted LM step)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    for _ in range(n_iters):
        Ap = matvec(p)
        denom = torch.dot(p, Ap)
        alpha = torch.where(torch.abs(denom) > 1e-20, rz / denom, zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        beta = torch.where(torch.abs(rz) > 1e-20, rz_new / rz, zero)
        p = z + beta * p
        rz = rz_new
    return x


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
    """FLAT layout: the Schur half-matrix Gd [6K, 3P] with S = Hcc_d -
    Gd Gd^T, the per-edge blocks U_o L_{p(o)} placed once per iteration
    (L L^T = Hpp_d^-1).  Returns (Gd, Gblk [O, 6, 3])."""
    Gblk = torch.einsum("oab,obc->oac", A, L[edges.pt_idx])
    return _place_flat(Gblk, edges.cam_idx, edges.pt_idx, K,
                       L.shape[0]), Gblk


def _place_flat(Gblk, cam_idx, pt_idx, K: int, P: int):
    """FLAT layout: the blocks Gblk [O, 6, 3] accumulated at (cam, pt) of a
    [K, P, 6, 3] buffer, then one transpose-copy to Gd [6K, 3P]."""
    G4 = torch.zeros((K, P, 6, 3), dtype=Gblk.dtype, device=Gblk.device)
    G4.index_put_((cam_idx, pt_idx), Gblk, accumulate=True)
    return G4.permute(0, 2, 1, 3).reshape(6 * K, 3 * P)


def _place_grid(Gblk, pt, P: int, placement: str):
    """GRID layout: camera k's per-slot [6, 3] blocks Gblk [K, N, 6, 3] go
    to columns pt [K, N] of row-slab k, giving Gd [6K, 3P].

      scatter: one single-index ``index_add_`` over the flattened k*P + pt
        rows of a [K*P, 6, 3] buffer, then one transpose-copy to the
        [6K, 3P] layout.
      onehot:  per camera, an [18, N] x [N, P] product with a 0/1 matrix,
        written straight into the [6, 3P] slab.  It needs true float32
        (the caller's scope): a reduced-precision product truncates the
        payload.  The [N, P] matrix is built one camera at a time.

    Where each (camera, point) pair holds at most one live block the two
    placements give the same G to the bit."""
    K, N = pt.shape
    if placement == "onehot":
        cols = torch.arange(P, device=pt.device)
        G = torch.empty((K, 6, P, 3), dtype=Gblk.dtype, device=Gblk.device)
        for k in range(K):
            oh = (pt[k][:, None] == cols[None, :]).to(Gblk.dtype)  # [N, P]
            slab = Gblk[k].reshape(N, 18).T @ oh                    # [18, P]
            G[k] = slab.reshape(6, 3, P).transpose(1, 2)
        return G.reshape(6 * K, 3 * P)
    if placement != "scatter":
        raise ValueError(f"unknown ba_placement {placement!r}")
    rows = (torch.arange(K, device=pt.device)[:, None] * P + pt).reshape(-1)
    G4 = torch.zeros((K * P, 6, 3), dtype=Gblk.dtype, device=Gblk.device)
    G4.index_add_(0, rows, Gblk.reshape(-1, 6, 3))
    return G4.reshape(K, P, 6, 3).permute(0, 2, 1, 3).reshape(6 * K, 3 * P)


def _solve_reduced_cg(Hcc_d, g_red, diag_sub, Gd, free, K: int,
                      cg_iters: int, x0=None):
    """Matrix-free Schur solve, never forming the [6K, 6K] matrix:
    S v = Hcc_d v - G (G^T v).  g_red [K, 6] is the gauge-masked reduced
    gradient, diag_sub [K, 6, 6] the block diagonal of G G^T.

    Preconditioner: two-level additive Schwarz, the exact 6x6 block
    diagonal of S inverted per camera plus a coarse correction over at
    most 16 groups of consecutive cameras (Sc = P S P^T, a [6g, 6g]
    inverse): block-Jacobi alone cannot damp the long-wavelength error of
    a camera chain within a fixed budget.  Both parts are SPD, so their
    sum is a valid PCG preconditioner.  The inverses are ``inv_ex``: no
    info check, no host wait."""
    dt, dev = Gd.dtype, Gd.device
    freeC = free[:, None]
    P3 = Gd.shape[1]
    eye6 = torch.eye(6, dtype=dt, device=dev)

    S_diag = Hcc_d - diag_sub
    S_diag = (S_diag * free[:, None, None]
              + eye6 * (1.0 - free)[:, None, None] + 1e-8 * eye6)
    P_inv = torch.linalg.inv_ex(S_diag).inverse               # [K, 6, 6]

    # coarse level: free cameras in <= 16 groups of consecutive cameras
    ngroups = min(16, K)
    gsz = -(-K // ngroups)
    gid = torch.arange(K, device=dev) // gsz                  # [K]
    Gslab = Gd.reshape(K, 6, P3)
    PG = torch.zeros((ngroups, 6, P3), dtype=dt, device=dev).index_add_(
        0, gid, Gslab * freeC[:, :, None])                    # [g, 6, 3P]
    Hg = torch.zeros((ngroups, 6, 6), dtype=dt, device=dev).index_add_(
        0, gid, Hcc_d * freeC[:, :, None])                    # row sums
    PGm = PG.reshape(ngroups * 6, P3)
    # Hcc_d is block-diagonal in k, so its part of Sc is group-diagonal
    Sc = -(PGm @ PGm.T).reshape(ngroups, 6, ngroups, 6)
    gg = torch.arange(ngroups, device=dev)
    Sc[gg, :, gg, :] += Hg
    Sc = (Sc.reshape(ngroups * 6, ngroups * 6)
          + 1e-6 * torch.eye(ngroups * 6, dtype=dt, device=dev))
    Sc_inv = torch.linalg.inv_ex(Sc).inverse

    def matvec(v):
        vm = v.reshape(K, 6) * freeC
        out = torch.einsum("kab,kb->ka", Hcc_d, vm).reshape(-1) \
            - Gd @ (Gd.T @ vm.reshape(-1))
        return (out.reshape(K, 6) * freeC
                + v.reshape(K, 6) * (1.0 - freeC)).reshape(-1)

    def precond(r):
        rk = r.reshape(K, 6)
        fine = torch.einsum("kab,kb->ka", P_inv, rk)
        rc = torch.zeros((ngroups, 6), dtype=dt, device=dev).index_add_(
            0, gid, rk * freeC).reshape(-1)
        coarse = (Sc_inv @ rc).reshape(ngroups, 6)[gid] * freeC  # prolong
        return (fine + coarse).reshape(-1)

    x0v = None if x0 is None else (x0 * freeC).reshape(-1)
    dxc = -_pcg_solve(matvec, precond, g_red.reshape(-1), cg_iters, x0=x0v)
    return dxc.reshape(K, 6) * freeC


def _scatter_rows(n: int, idx, vals):
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, idx, vals)


def _lm_phase(Rs, ts, Xs, fixed, edges: BAEdges, cam: CameraParams, lam,
              active, n_iters: int, use_robust: bool, delta2: float,
              solver: str = "dense", cg_iters: int = 48,
              placement: str = "scatter"):
    K = Rs.shape[0]
    P = Xs.shape[0]
    dt, dev = Rs.dtype, Rs.device
    grid = edges.cam_idx is None
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    free = (~fixed).to(dt)
    kk = torch.arange(K, device=dev)
    pt = edges.pt_idx
    ptf = pt.reshape(-1)
    cost_new = torch.zeros((), dtype=dt, device=dev)
    dxc_prev = torch.zeros((K, 6), dtype=dt, device=dev)
    for _ in range(n_iters):
        r, Jc, Jp, z = _terms_any(Rs, ts, Xs, edges, cam)
        c2 = torch.sum(r * r, dim=-1) * edges.inv_sigma2
        w = _huber_weight(c2, delta2) if use_robust else torch.ones_like(c2)
        w = w * edges.inv_sigma2 * active * (z > 0)

        if grid:
            # camera-major rows: Hcc and gc are per-row reductions; only
            # the point-indexed blocks scatter, over the flat [K*N] slots
            Jcw = Jc * w[..., None, None]
            Hcc = torch.einsum("knia,knib->kab", Jcw, Jc)
            JcTJp = torch.einsum("knia,knib->knab", Jcw, Jp)
            gc = torch.einsum("knia,kni->ka", Jcw, r)
            Jpw = Jp * w[..., None, None]
            Hpp = _scatter_rows(P, ptf, torch.einsum(
                "knia,knib->knab", Jpw, Jp).reshape(-1, 3, 3))
            gp = _scatter_rows(P, ptf, torch.einsum(
                "knia,kni->kna", Jpw, r).reshape(-1, 3))
        else:
            JcTJc = torch.einsum("oia,o,oib->oab", Jc, w, Jc)
            JpTJp = torch.einsum("oia,o,oib->oab", Jp, w, Jp)
            JcTJp = torch.einsum("oia,o,oib->oab", Jc, w, Jp)
            gc_o = torch.einsum("oia,o,oi->oa", Jc, w, r)
            gp_o = torch.einsum("oia,o,oi->oa", Jp, w, r)
            Hcc = _scatter_rows(K, edges.cam_idx, JcTJc)
            Hpp = _scatter_rows(P, pt, JpTJp)
            gc = _scatter_rows(K, edges.cam_idx, gc_o)
            gp = _scatter_rows(P, pt, gp_o)

        # LM damping (multiplicative on the block diagonals)
        Hcc_d = (Hcc + lam * torch.diag_embed(torch.diagonal(
            Hcc, dim1=-2, dim2=-1)) + 1e-8 * eye6)
        Hpp_d = (Hpp + lam * torch.diag_embed(torch.diagonal(
            Hpp, dim1=-2, dim2=-1)) + 1e-8 * eye3)

        # C C^T = Hpp_d, L = C^-T, Hpp_inv = L L^T = Ci^T Ci
        Ci = _inv_lower3(_chol3(Hpp_d))
        Hpp_inv = torch.einsum("pba,pbc->pac", Ci, Ci)
        y = torch.einsum("pab,pb->pa", Hpp_inv, gp)
        L = Ci.transpose(-1, -2)

        if grid:
            Gblk = torch.einsum("knab,knbc->knac", JcTJp, L[pt])
            Gd = _place_grid(Gblk, pt, P, placement)
            g_red = gc - torch.einsum("knab,knb->ka", JcTJp, y[pt])
        else:
            Gd, Gblk = _half_schur(L, JcTJp, edges, K)
            g_red = gc - _scatter_rows(K, edges.cam_idx, torch.einsum(
                "oab,ob->oa", JcTJp, y[pt]))
        g_red = g_red * free[:, None]

        if solver == "cg":
            # the exact block diagonal of G G^T, for the preconditioner
            if grid:
                diag_sub = torch.einsum("knac,knbc->kab", Gblk, Gblk)
            else:
                diag_sub = _scatter_rows(K, edges.cam_idx, torch.einsum(
                    "oac,obc->oab", Gblk, Gblk))
            dxc = _solve_reduced_cg(Hcc_d, g_red, diag_sub, Gd, free, K,
                                    cg_iters, x0=-dxc_prev)
        else:
            S = -(Gd @ Gd.T).reshape(K, 6, K, 6)
            S[kk, :, kk, :] += Hcc_d
            # gauge: fixed cameras get identity rows/cols, zero gradient
            S = S * free[:, None, None, None] * free[None, None, :, None]
            S[kk, :, kk, :] += (1.0 - free)[:, None, None] * eye6
            dxc = -torch.linalg.solve_ex(
                S.reshape(6 * K, 6 * K), g_red.reshape(-1)).result
            dxc = dxc.reshape(K, 6)

        # landmark back-substitution (one point-indexed scatter)
        if grid:
            up = _scatter_rows(P, ptf, torch.einsum(
                "knab,ka->knb", JcTJp, dxc).reshape(-1, 3))
        else:
            up = _scatter_rows(P, pt, torch.einsum(
                "oab,oa->ob", JcTJp, dxc[edges.cam_idx]))
        dxp = -torch.einsum("pab,pb->pa", Hpp_inv, gp + up)

        Rs1, ts1 = se3.retract(Rs, ts, dxc)
        Xs1 = Xs + dxp

        r1, _, _, _ = _terms_any(Rs1, ts1, Xs1, edges, cam)
        # both costs sum the same edges, those in front of their camera
        # before the step: an edge the step takes behind its camera keeps
        # its (clamped-depth) residual, as g2o's edges do, so no step
        # lowers the cost by hiding edges
        cost_old = _robust_cost(r, z, edges.inv_sigma2, active, delta2)
        cost_new = _robust_cost(r1, z, edges.inv_sigma2, active, delta2)
        accept = ((cost_new < cost_old) & torch.all(torch.isfinite(dxc))
                  & torch.all(torch.isfinite(dxp)))
        Rs = torch.where(accept, Rs1, Rs)
        ts = torch.where(accept, ts1, ts)
        Xs = torch.where(accept, Xs1, Xs)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        if solver == "cg":
            # warm-start the next CG solve from an ACCEPTED step only: a
            # rejected step solved a system the damping then repudiated
            # (seeding from it cost the JAX package 2x in final cost)
            dxc_prev = torch.where(accept, dxc, torch.zeros_like(dxc))
    return Rs, ts, Xs, lam, cost_new


def bundle_adjust(Rs, ts, Xs, fixed, edges: BAEdges, cam: CameraParams,
                  cfg: SolverConfig = SolverConfig(), two_phase: bool = True,
                  solver: str = "auto", cg_iters: int = 48,
                  placement: str = "scatter",
                  phase2: bool = True) -> BAResult:
    """Local/global BA.  fixed: [K] bool gauge mask (at least one True).
    An ``edges.cam_idx`` of None selects the GRID layout.

    two_phase=True is the reference local-BA schedule (5 its, outlier
    removal at chi2 > 5.991 or z <= 0, 10 more); two_phase=False runs
    cfg.global_ba_iters robust iterations (init/global BA).  phase2=False
    is the aborted schedule (phase 1 and the outlier gate only).

    solver: "dense" forms S = Hcc - G G^T with one matmul and solves the
    reduced system exactly; "cg" runs cg_iters steps of warm-started
    two-level PCG on it; "auto" is dense, as in the JAX package.
    placement ("scatter" | "onehot") places the GRID layout's G."""
    if solver == "auto":
        solver = "dense"
    if solver not in ("dense", "cg"):
        raise ValueError(f"unknown solver {solver!r}")
    # fail before any allocation when the half-matrix cannot fit the
    # single-device budget: both solvers hold G [6K, 3P] float32
    g_bytes = 6 * int(Rs.shape[0]) * 3 * int(Xs.shape[0]) * 4
    if g_bytes > G_BYTES_MAX:
        raise ValueError(
            f"single-device BA half-matrix G would be {g_bytes / 2**30:.1f} "
            f"GiB (K={Rs.shape[0]}, P={Xs.shape[0]}) — beyond the "
            "single-device budget; use the landmark-sharded solver "
            "(parallel.dist_ba.bundle_adjust_dist, whose per-device slab "
            "is G/n_shards)")
    with true_fp32():
        return _bundle_adjust(Rs, ts, Xs, fixed, edges, cam, cfg, two_phase,
                              phase2, solver, cg_iters, placement)


def _bundle_adjust(Rs, ts, Xs, fixed, edges, cam, cfg, two_phase, phase2,
                   solver, cg_iters, placement):
    delta2 = cfg.huber_delta2
    lam = torch.full((), cfg.lm_lambda_init, dtype=Rs.dtype,
                     device=Rs.device)
    active = edges.valid.to(Rs.dtype)
    lm = dict(delta2=delta2, solver=solver, cg_iters=cg_iters,
              placement=placement)

    if cfg.ba_normalize_world:
        # similarity-normalize the world for float32 conditioning:
        # X' = s(X - c), t' = s(t + R c); projections are invariant
        P_n = Xs.shape[0]
        seen_idx = torch.where(edges.valid, edges.pt_idx,
                               torch.full_like(edges.pt_idx, P_n)).reshape(-1)
        hits = torch.zeros(P_n + 1, dtype=torch.int32,
                           device=Xs.device).index_add_(
            0, seen_idx, torch.ones_like(seen_idx, dtype=torch.int32))[:P_n]
        seen_f = (hits > 0).to(Xs.dtype)
        n_seen = torch.clamp(seen_f.sum(), min=1.0)
        c = torch.sum(Xs * seen_f[:, None], dim=0) / n_seen
        rad = torch.linalg.vector_norm(Xs - c, dim=1)
        scale = 1.0 / torch.clamp(torch.sum(rad * seen_f) / n_seen, min=1e-6)
        Xs = (Xs - c) * scale
        ts = (ts + torch.einsum("kij,j->ki", Rs, c)) * scale

    def gate(Rs, ts, Xs):
        r, _, _, z = _terms_any(Rs, ts, Xs, edges, cam)
        c2 = torch.sum(r * r, dim=-1) * edges.inv_sigma2
        return c2, edges.valid & (c2 <= cfg.local_ba_chi2) & (z > 0)

    if two_phase:
        Rs, ts, Xs, lam, _ = _lm_phase(
            Rs, ts, Xs, fixed, edges, cam, lam, active,
            n_iters=cfg.local_ba_iters1, use_robust=True, **lm)
        c2, inl = gate(Rs, ts, Xs)
        if phase2:
            Rs, ts, Xs, lam, cost = _lm_phase(
                Rs, ts, Xs, fixed, edges, cam, lam, inl.to(Rs.dtype),
                n_iters=cfg.local_ba_iters2, use_robust=False, **lm)
        else:
            cost = torch.sum(torch.where(inl, c2, torch.zeros_like(c2)))
    else:
        Rs, ts, Xs, lam, cost = _lm_phase(
            Rs, ts, Xs, fixed, edges, cam, lam, active,
            n_iters=cfg.global_ba_iters, use_robust=True, **lm)

    _, inl = gate(Rs, ts, Xs)
    if cfg.ba_normalize_world:
        Xs = Xs / scale + c
        ts = ts / scale - torch.einsum("kij,j->ki", Rs, c)

    blob = torch.cat([Rs.reshape(-1), ts.reshape(-1), Xs.reshape(-1),
                      inl.to(torch.float32).reshape(-1)])
    return BAResult(R=Rs, t=ts, points=Xs, edge_inliers=inl, cost=cost,
                    host_blob=blob)
