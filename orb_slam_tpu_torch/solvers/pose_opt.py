"""Motion-only pose optimization: LM on SE(3) (port of
``orb_slam_tpu.solvers.pose_opt``).

Replaces Optimizer::PoseOptimization (src/Optimizer.cc:154-285).  The
reference's schedule is kept: 4 rounds of {10,10,7,5} LM iterations with
chi-squared outlier gates {9.21,7.38,5.991,5.991}, the Huber kernel on the
first two rounds, outliers re-classified against all observations after
each round.  The accept test (``cost_new < cost_old``) and the unrolled 6x6
Cholesky are the JAX package's, so both packages take the same steps; the
normal equations run in true float32 (TF32 off).  Everything stays on the
device: the accept test selects with ``torch.where``, never on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SolverConfig
from ..device import true_fp32
from ..geometry import se3
from ..geometry.camera import CameraParams


class PoseOptResult(NamedTuple):
    R: torch.Tensor          # [3, 3]
    t: torch.Tensor          # [3]
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # 0-d int64


def _residual_jacobian(R, t, X, uv, cam: CameraParams):
    """r = pi(R X + t) - uv and J = dr/dxi for xi = (ups, omega), as
    EdgeSE3ProjectXYZ::linearizeOplus.  Returns r [N,2], J [N,2,6], z [N]."""
    xc = se3.transform(R, t, X)
    x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
    zi = 1.0 / torch.clamp(z, min=1e-6)
    u = x * zi * cam.fx + cam.cx
    v = y * zi * cam.fy + cam.cy
    r = torch.stack([u, v], dim=1) - uv

    fx, fy = cam.fx, cam.fy
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    Jpi = torch.stack(
        [
            torch.stack([fx * zi, zero, -fx * x * zi2], dim=1),
            torch.stack([zero, fy * zi, -fy * y * zi2], dim=1),
        ],
        dim=1,
    )  # [N, 2, 3]
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(X.shape[0], 3, 3)
    dxc = torch.cat([eye, -se3.hat(xc)], dim=2)  # [N, 3, 6]
    return r, Jpi @ dxc, z


def _huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """w = min(1, delta / e) on the residual norm e."""
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    d = float(np.sqrt(np.float32(delta2)))     # float32 sqrt, as jnp.sqrt
    return torch.clamp(d / e, max=1.0)


def _chol_solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unrolled 6x6 SPD Cholesky solve in scalar ops: the same LL^T
    factorization, 1e-20 pivot floor and order of operations as the JAX
    package's, so both take the same LM steps."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-20))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def optimize_pose(R0: torch.Tensor, t0: torch.Tensor, X: torch.Tensor,
                  uv: torch.Tensor, inv_sigma2: torch.Tensor,
                  valid: torch.Tensor, cam: CameraParams,
                  cfg: SolverConfig = SolverConfig()) -> PoseOptResult:
    """X: [N,3] world points, uv: [N,2] undistorted observations,
    inv_sigma2: [N] information (1/sigma^2 of the level), valid: [N]
    association mask."""
    with true_fp32():
        return _optimize_pose(R0, t0, X, uv, inv_sigma2, valid, cam, cfg)


def _optimize_pose(R0, t0, X, uv, inv_sigma2, valid, cam, cfg):
    delta2 = cfg.huber_delta2
    eye6 = 1e-9 * torch.eye(6, dtype=X.dtype, device=X.device)

    def chi2_of(R, t):
        r, _, z = _residual_jacobian(R, t, X, uv, cam)
        return torch.sum(r * r, dim=1) * inv_sigma2, z

    def lm_round(R, t, active, lam, n_iters, use_robust):
        for _ in range(n_iters):
            r, J, z = _residual_jacobian(R, t, X, uv, cam)
            c2 = torch.sum(r * r, dim=1) * inv_sigma2
            w = _huber_weight(c2, delta2) if use_robust else 1.0
            w = w * inv_sigma2 * active * (z > 0)
            H = torch.einsum("nia,n,nib->ab", J, w, J)
            b = torch.einsum("nia,n,ni->a", J, w, r)
            Hd = H + lam * torch.diag(torch.diag(H)) + eye6
            dx = -_chol_solve6(Hd, b)
            R1, t1 = se3.retract(R, t, dx)
            # accept if the total weighted chi2 decreased (LM-style)
            c2_new, z1 = chi2_of(R1, t1)
            cost_old = torch.sum(c2 * active * (z > 0))
            cost_new = torch.sum(c2_new * active * (z1 > 0))
            accept = cost_new < cost_old
            R = torch.where(accept, R1, R)
            t = torch.where(accept, t1, t)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
        return R, t, lam

    active = valid.to(torch.float32)
    R, t = R0, t0
    lam = torch.full((), cfg.lm_lambda_init, dtype=torch.float32,
                     device=X.device)
    inl = valid
    for rnd, (iters, gate) in enumerate(zip(cfg.pose_rounds, cfg.pose_chi2)):
        # Huber on the first two rounds, plain quadratic cost after
        R, t, lam = lm_round(R, t, active, lam, iters, rnd < 2)
        c2, z = chi2_of(R, t)
        inl = valid & (c2 <= gate) & (z > 0)
        active = inl.to(torch.float32)
    return PoseOptResult(R=R, t=t, inliers=inl, n_inliers=torch.sum(inl))
