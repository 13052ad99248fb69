"""Sim3 refinement with bidirectional reprojection edges (port of
``orb_slam_tpu.solvers.sim3_opt``).

Replaces Optimizer::OptimizeSim3 (src/Optimizer.cc:791-987): given matched
landmark pairs between two keyframes and an initial relative Sim3 g12, run
Gauss-Newton on the 7-dof tangent minimizing reprojection of each landmark
into the *other* image (EdgeSim3ProjectXYZ / EdgeInverseSim3ProjectXYZ),
with Huber weighting and a chi2 inlier gate (th2 = 10) between passes
(5 + 10 iterations, matching the reference's schedule).

As in the JAX package, the Jacobian is the forward-mode derivative of the
residual at the zero tangent (``torch.func.jacfwd``), the normal equations
carry a 1e-8 I damping, and a step is kept only if it lowers the cost and
is finite.  The accept test selects with ``torch.where`` and the 7x7 solve
skips torch's error check, so the iterations make no host sync; they run
in true float32 (TF32 off).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import true_fp32
from ..geometry import sim3
from .pose_opt import _huber_weight


class Sim3OptResult(NamedTuple):
    s: torch.Tensor           # 0-d
    R: torch.Tensor           # [3, 3]
    t: torch.Tensor           # [3]
    inliers: torch.Tensor     # [N] bool
    n_inliers: torch.Tensor   # 0-d int64


def _reproj_residuals(s, R, t, X1, X2, uv1, uv2, fx, fy, cx, cy):
    """r12: project X2 through g12 into image 1; r21: project X1 through
    g12^-1 into image 2.  Returns ([N,2], [N,2], z1, z2)."""
    X2in1 = sim3.transform(s, R, t, X2)
    si, Ri, ti = sim3.inverse(s, R, t)
    X1in2 = sim3.transform(si, Ri, ti, X1)

    def proj(Xc):
        z = torch.clamp(Xc[..., 2], min=1e-6)
        return torch.stack([Xc[..., 0] / z * fx + cx,
                            Xc[..., 1] / z * fy + cy], dim=-1)

    return (proj(X2in1) - uv1, proj(X1in2) - uv2,
            X2in1[..., 2], X1in2[..., 2])


def optimize_sim3(
    s0: torch.Tensor, R0: torch.Tensor, t0: torch.Tensor,
    X1: torch.Tensor,       # [N, 3] landmarks in KF1 camera frame
    X2: torch.Tensor,       # [N, 3] matched landmarks in KF2 camera frame
    uv1: torch.Tensor,      # [N, 2] pixels in KF1
    uv2: torch.Tensor,      # [N, 2] pixels in KF2
    inv_sigma2_1: torch.Tensor,
    inv_sigma2_2: torch.Tensor,
    valid: torch.Tensor,    # [N] bool
    K: torch.Tensor,        # [3, 3]
    chi2_th: float = 10.0,
    iters1: int = 5,
    iters2: int = 10,
    fix_scale: bool = False,
) -> Sim3OptResult:
    with true_fp32():
        return _optimize_sim3(s0, R0, t0, X1, X2, uv1, uv2, inv_sigma2_1,
                              inv_sigma2_2, valid, K, chi2_th, iters1,
                              iters2, fix_scale)


def _optimize_sim3(s0, R0, t0, X1, X2, uv1, uv2, inv_sigma2_1, inv_sigma2_2,
                   valid, K, chi2_th, iters1, iters2, fix_scale):
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    info = torch.cat([inv_sigma2_1, inv_sigma2_2])
    eye7 = 1e-8 * torch.eye(7, dtype=X1.dtype, device=X1.device)
    z0 = torch.zeros(7, dtype=X1.dtype, device=X1.device)

    def chi2_of(s, R, t):
        r12, r21, z1, z2 = _reproj_residuals(s, R, t, X1, X2, uv1, uv2,
                                             fx, fy, cx, cy)
        c12 = torch.sum(r12 * r12, dim=1) * inv_sigma2_1
        c21 = torch.sum(r21 * r21, dim=1) * inv_sigma2_2
        return c12, c21, (z1 > 0) & (z2 > 0)

    def gn_rounds(s, R, t, active, n_iters):
        active2 = torch.cat([active, active])
        for _ in range(n_iters):
            def resid_flat(zeta):
                # zeta[None] keeps the tangent-carrying scale 1-d: torch.func's
                # forward mode turns the tangent of a 0-d tensor times a
                # Python float into float64
                s2, R2, t2 = sim3.retract(s, R, t, zeta[None])
                r12, r21, _, _ = _reproj_residuals(
                    s2, R2, t2, X1, X2, uv1, uv2, fx, fy, cx, cy)
                r = torch.cat([r12, r21], dim=0)             # [2N, 2]
                return r, r

            J, r = torch.func.jacfwd(resid_flat, has_aux=True)(z0)
            c2 = torch.sum(r * r, dim=1) * info              # J: [2N, 2, 7]
            w = _huber_weight(c2, chi2_th) * info * active2
            if fix_scale:
                J[..., 6] = 0.0
            H = torch.einsum("nia,n,nib->ab", J, w, J) + eye7
            b = torch.einsum("nia,n,ni->a", J, w, r)
            dz = -torch.linalg.solve_ex(H, b, check_errors=False).result
            s2, R2, t2 = sim3.retract(s, R, t, dz)
            # accept on cost decrease
            c12a, c21a, za = chi2_of(s, R, t)
            c12b, c21b, zb = chi2_of(s2, R2, t2)
            ca = torch.sum((c12a + c21a) * active * za)
            cb = torch.sum((c12b + c21b) * active * zb)
            good = (cb < ca) & torch.all(torch.isfinite(dz))
            s = torch.where(good, s2, s)
            R = torch.where(good, R2, R)
            t = torch.where(good, t2, t)
        return s, R, t

    active = valid.to(X1.dtype)
    s, R, t = gn_rounds(s0, R0, t0, active, iters1)
    c12, c21, zok = chi2_of(s, R, t)
    inl = valid & (c12 <= chi2_th) & (c21 <= chi2_th) & zok
    s, R, t = gn_rounds(s, R, t, inl.to(X1.dtype), iters2)
    c12, c21, zok = chi2_of(s, R, t)
    inl = valid & (c12 <= chi2_th) & (c21 <= chi2_th) & zok
    return Sim3OptResult(s=s, R=R, t=t, inliers=inl, n_inliers=inl.sum())
