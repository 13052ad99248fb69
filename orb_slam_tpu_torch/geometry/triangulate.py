"""Batched two-view triangulation and related geometry (port of
``orb_slam_tpu.geometry.triangulate``).

Replaces Initializer::Triangulate (src/Initializer.cc:732-752) and the
per-match SVD triangulation of LocalMapping::CreateNewMapPoints
(src/LocalMapping.cc:284-367) with one batched SVD.  The point is taken
from the last right singular vector divided by its fourth entry, so the
sign a LAPACK or cuSOLVER SVD gives that vector does not matter.
"""
from __future__ import annotations

import math

import torch


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, xy1: torch.Tensor,
                    xy2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation.  P1, P2: [3, 4] projection matrices (or [..., 3,
    4] batched like xy's leading axes); xy1, xy2: [..., N, 2] pixel coords
    consistent with the P's.  Returns [..., N, 3] (w-normalized)."""
    P1 = P1.unsqueeze(-3)
    P2 = P2.unsqueeze(-3)
    A = torch.stack([
        xy1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        xy1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
        xy2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
        xy2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
    ], dim=-2)                                         # [..., N, 4, 4]
    X = torch.linalg.svd(A).Vh[..., -1, :]
    w = torch.where(torch.abs(X[..., 3]) < 1e-12,
                    torch.full_like(X[..., 3], 1e-12), X[..., 3])
    return X[..., :3] / w[..., None]


def projection_matrix(K: torch.Tensor, R: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
    """K [3,3], R [..., 3,3], t [..., 3] -> P = K [R|t], [..., 3, 4]."""
    return K @ torch.cat([R, t[..., :, None]], dim=-1)


def parallax_cos(X: torch.Tensor, c1: torch.Tensor,
                 c2: torch.Tensor) -> torch.Tensor:
    """Cosine of the ray angle at X [..., N, 3] between camera centres c1,
    c2 ([..., 3]).  [..., N]."""
    r1 = X - c1[..., None, :]
    r2 = X - c2[..., None, :]
    n1 = torch.linalg.vector_norm(r1, dim=-1)
    n2 = torch.linalg.vector_norm(r2, dim=-1)
    return torch.sum(r1 * r2, dim=-1) / torch.clamp(n1 * n2, min=1e-12)


def check_rt(R: torch.Tensor, t: torch.Tensor, xy1: torch.Tensor,
             xy2: torch.Tensor, valid: torch.Tensor, K: torch.Tensor,
             sigma2: float = 1.0, reproj_th: float = 4.0):
    """Evaluate motion hypotheses (reference CheckRT, Initializer.cc:796-927)
    — R [H, 3, 3], t [H, 3], batched over H (a single [3, 3] / [3] works
    too).

    Triangulates valid matches under (R, t), gates on finite coords,
    positive depth in both views (where the parallax is real),
    reprojection chi2 < reproj_th * sigma2 in both views.  Returns (n_good,
    X [..., N, 3], good [..., N], parallax_deg) with parallax_deg the
    reference's "50th-smallest" robust parallax."""
    dt = R.dtype
    eye = torch.eye(3, dtype=dt, device=R.device).expand(R.shape)
    P1 = projection_matrix(K, eye, torch.zeros_like(t))
    P2 = projection_matrix(K, R, t)
    X = triangulate_dlt(P1, P2, xy1, xy2)

    finite = torch.all(torch.isfinite(X), dim=-1)
    Xs = torch.where(finite[..., None], X, torch.zeros_like(X))

    c1 = torch.zeros_like(t)
    c2 = -torch.einsum("...ji,...j->...i", R, t)
    cosp = parallax_cos(Xs, c1, c2)

    z1 = Xs[..., 2]
    X2 = Xs @ R.transpose(-1, -2) + t[..., None, :]
    z2 = X2[..., 2]

    def reproj_err(P, Xw, xy):
        Xh = torch.cat([Xw, torch.ones_like(Xw[..., :1])], dim=-1)
        p = Xh @ P.transpose(-1, -2)
        uv = p[..., :2] / torch.clamp(p[..., 2:3], min=1e-12)
        return torch.sum((uv - xy) ** 2, dim=-1)

    e1 = reproj_err(P1, Xs, xy1)
    e2 = reproj_err(P2, Xs, xy2)

    has_parallax = cosp < 0.99998
    depth_ok = ((z1 > 0) | ~has_parallax) & ((z2 > 0) | ~has_parallax)
    counted = (valid & finite & depth_ok & (e1 < reproj_th * sigma2)
               & (e2 < reproj_th * sigma2))
    n_good = torch.sum(counted, dim=-1)
    good = counted & has_parallax

    # robust parallax: sort cos ascending over the counted points, take
    # idx = min(50, n-1)
    cos_masked = torch.where(counted, cosp, torch.full_like(cosp, 2.0))
    sorted_cos = torch.sort(cos_masked, dim=-1).values
    idx = torch.clamp(n_good - 1, min=0).clamp(max=50)
    cos_at = torch.gather(sorted_cos, -1, idx[..., None])[..., 0]
    parallax_deg = torch.arccos(torch.clamp(cos_at, -1.0, 1.0)) \
        * (180.0 / math.pi)
    parallax_deg = torch.where(n_good > 0, parallax_deg,
                               torch.zeros_like(parallax_deg))
    return n_good, X, good, parallax_deg
