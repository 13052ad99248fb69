"""Relative Sim(3) between two keyframes from 3D-3D matches: batched
closed-form absolute orientation inside RANSAC (port of
``orb_slam_tpu.solvers.sim3_solver``).

Replaces Sim3Solver (src/Sim3Solver.cc): the reference iterates Horn's 1987
quaternion method over 3-point minimal sets with round-robin `iterate(5)`
(:137-231); here all samples run in one batch.  The closed form used is the
SVD similarity (Umeyama), algebraically equivalent to Horn's quaternion
eigenvector construction, and the inlier test is the reference's:
symmetric reprojection error in both images against 9.210 * sigma^2 of
each keypoint's octave (Sim3Solver.cc:87-88, 335-360).

Randomness: as ``pnp.pnp_ransac``, the minimal sets are drawn from an
explicit CPU ``torch.Generator`` (``pnp.draw_samples`` with min_set=3) or
handed in as ``samples``, so the card, the CPU and a test holding the JAX
package's draws score the same hypotheses.  The best hypothesis is the
first of maximal inlier count, as ``jnp.argmax``.

A sample whose covariance is not finite is zeroed before the batched SVD
(torch's SVD raises on NaN where JAX returns NaN) and its hypothesis is
set to NaN, so it counts no inliers.  Everything runs in true float32
(TF32 off).  On the card the two SVD calls wait for it (torch's CUDA SVD
checks its solver's status on the host); nothing else reads the card, and
the caller reads ``ok`` once.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import true_fp32
from .epnp import _finite, _nan_where_not
from .pnp import draw_samples


class Sim3Result(NamedTuple):
    ok: torch.Tensor          # 0-d bool
    s: torch.Tensor           # 0-d: scale of g12 (maps frame-2 coords to 1)
    R: torch.Tensor           # [3, 3]
    t: torch.Tensor           # [3]
    inliers: torch.Tensor     # [N] bool
    n_inliers: torch.Tensor   # 0-d int64


def _fit(cov, var2, mu1, mu2, fix_scale=False):
    """(s, R, t) from the cross-covariance cov [S, 3, 3] of the centred
    points, the variance var2 [S] of the frame-2 side and both means
    [S, 3]; s = 1 with `fix_scale`.  Non-finite samples come out NaN."""
    cov, ok = _finite(cov)
    U, D, Vt = _nan_where_not(ok, *torch.linalg.svd(cov))
    sgn = torch.sign(torch.linalg.det(U @ Vt))
    Sd = torch.cat([torch.ones_like(D[:, :2]), sgn[:, None]], dim=1)
    R = (U * Sd[:, None, :]) @ Vt
    s = torch.sum(D * Sd, dim=1) / torch.clamp(var2, min=1e-12)
    if fix_scale:
        s = torch.ones_like(s)
    t = mu1 - s[:, None] * (R @ mu2[:, :, None])[:, :, 0]
    return s, R, t


def umeyama_sim3(P2: torch.Tensor, P1: torch.Tensor):
    """Least-squares (s, R, t) with P1 ~ s R P2 + t.  P*: [n, 3], or
    [S, n, 3] for a batch of S fits."""
    with true_fp32():
        batch = P1.dim() == 3
        P1, P2 = (P1, P2) if batch else (P1[None], P2[None])
        n = P1.shape[1]
        mu1, mu2 = P1.mean(dim=1), P2.mean(dim=1)
        x1, x2 = P1 - mu1[:, None], P2 - mu2[:, None]
        cov = x1.transpose(1, 2) @ x2 / n
        var2 = torch.sum(x2 * x2, dim=(1, 2)) / n
        s, R, t = _fit(cov, var2, mu1, mu2)
        return (s, R, t) if batch else (s[0], R[0], t[0])


def sim3_ransac(
    X1: torch.Tensor,        # [N, 3] matched points in KF1 camera frame
    X2: torch.Tensor,        # [N, 3] same landmarks in KF2 camera frame
    uv1: torch.Tensor,       # [N, 2] their pixels in KF1
    uv2: torch.Tensor,       # [N, 2] their pixels in KF2
    max_err1: torch.Tensor,  # [N] 9.21 * sigma2(level in KF1)
    max_err2: torch.Tensor,  # [N]
    valid: torch.Tensor,     # [N] bool
    K: torch.Tensor,         # [3, 3]
    n_samples: int = 256,
    min_inliers: int = 20,
    fix_scale: bool = False,
    generator: Optional[torch.Generator] = None,
    samples: Optional[torch.Tensor] = None,
) -> Sim3Result:
    """samples: [n_samples, 3] row indices of the minimal sets; drawn from
    `generator` (``pnp.draw_samples``) when None."""
    if samples is None:
        samples = draw_samples(generator, valid, n_samples, 3)
    with true_fp32():
        return _sim3_ransac(X1, X2, uv1, uv2, max_err1, max_err2, valid, K,
                            samples.to(device=X1.device, dtype=torch.int64),
                            min_inliers, fix_scale)


def _sim3_ransac(X1, X2, uv1, uv2, max_err1, max_err2, valid, K, samples,
                 min_inliers, fix_scale):
    ss, Rs, ts = umeyama_sim3(X2[samples], X1[samples])
    if fix_scale:
        # as the JAX package: the samples' t keeps the fitted scale
        ss = torch.ones_like(ss)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def project(Xc):
        z = torch.clamp(Xc[..., 2], min=1e-6)
        return torch.stack([Xc[..., 0] / z * fx + cx,
                            Xc[..., 1] / z * fy + cy], dim=-1)

    def count(s, R, t):
        """Inliers of hypotheses s [S], R [S, 3, 3], t [S, 3]: [S, N]."""
        # g12: X2 -> frame 1;  g21 = g12^-1
        X2in1 = s[:, None, None] * (X2 @ R.transpose(1, 2)) + t[:, None]
        X1in2 = ((X1 - t[:, None]) / torch.clamp(s, min=1e-12)[:, None, None]
                 ) @ R
        e1 = torch.sum((project(X2in1) - uv1) ** 2, dim=-1)
        e2 = torch.sum((project(X1in2) - uv2) ** 2, dim=-1)
        inl = (valid & (e1 < max_err1) & (e2 < max_err2)
               & (X2in1[..., 2] > 0) & (X1in2[..., 2] > 0))
        return inl, inl.sum(dim=1)

    inls, counts = count(ss, Rs, ts)
    # the first maximum, as jnp.argmax; picked with index_select, since
    # indexing by a 0-d CUDA tensor reads it to the host
    best = torch.argmax(counts)[None]

    def pick(x):
        return x.index_select(0, best)[0]

    ok = pick(counts) >= min_inliers

    # polish: re-fit on the best inlier set.  The JAX package's weighted
    # closed form, term by term: the covariance and the variance weight
    # one side only
    inl = pick(inls)
    wts = inl.to(X1.dtype)[:, None]
    nw = torch.clamp(torch.sum(wts), min=3.0)
    mu1 = torch.sum(X1 * wts, dim=0) / nw
    mu2 = torch.sum(X2 * wts, dim=0) / nw
    x1 = (X1 - mu1) * wts
    x2 = (X2 - mu2) * wts
    cov = x1.T @ (X2 - mu2) / nw
    var2 = torch.sum(x2 * (X2 - mu2)) / nw
    sp, Rp, tp = _fit(cov[None], var2[None], mu1[None], mu2[None],
                      fix_scale)
    inl2, n2 = count(sp, Rp, tp)
    better = n2[0] >= pick(counts)
    return Sim3Result(
        ok=ok,
        s=torch.where(better, sp[0], pick(ss)),
        R=torch.where(better, Rp[0], pick(Rs)),
        t=torch.where(better, tp[0], pick(ts)),
        inliers=torch.where(better, inl2[0], inl),
        n_inliers=torch.where(better, n2[0], pick(counts)),
    )
