"""Batched PnP RANSAC for relocalisation (port of
``orb_slam_tpu.solvers.pnp``).

Replaces PnPsolver (src/PnPsolver.cc): the reference runs EPnP on 4-point
minimal sets in an adaptive RANSAC, round-robin across candidate keyframes
(Tracking.cc:922-1006).  As in the JAX package, every hypothesis of a
candidate is solved and scored in one batch, with a fixed budget in place
of the sequential early exit; the minimal solver is EPnP (solver="epnp",
min_set >= 4) or the 6-point DLT (solver="p6p").

Randomness: the JAX package draws its minimal sets with ``jax.random``;
the port draws them from an explicit CPU ``torch.Generator``
(``draw_samples``: ``torch.multinomial`` without replacement, weighted by
the valid mask) and moves them to the device, so the card and the CPU pick
the same hypotheses.  ``pnp_ransac`` takes the samples as an argument,
which lets a test hand in the JAX package's draws.

Nothing here reads the card: the result stays on the device and the caller
reads ``ok`` once.  The best hypothesis is the first of maximal inlier
count, as ``jnp.argmax``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import true_fp32
from ..geometry import se3
from .epnp import _finite, _nan_where_not, epnp


class PnPResult(NamedTuple):
    ok: torch.Tensor          # 0-d bool
    R: torch.Tensor           # [3, 3]
    t: torch.Tensor           # [3]
    inliers: torch.Tensor     # [N] bool
    n_inliers: torch.Tensor   # 0-d int64


def draw_samples(generator: torch.Generator, valid, n_samples: int,
                 min_set: int) -> torch.Tensor:
    """[n_samples, min_set] int64 CPU indices: per sample, min_set distinct
    valid rows drawn uniformly from a CPU generator (the distribution of
    the JAX package's ``jax.random.choice(..., replace=False,
    p=valid/sum)``).  valid: [N] bool numpy array or tensor."""
    v = torch.as_tensor(np.asarray(valid.cpu() if isinstance(
        valid, torch.Tensor) else valid, bool))
    w = v.to(torch.float32)[None, :].expand(n_samples, -1)
    return torch.multinomial(w, min_set, replacement=False,
                             generator=generator)


def _project_so3(M):
    """The closest rotation to each M [S, 3, 3] (SVD, det +1), as the JAX
    package's se3.orthonormalize."""
    M, ok = _finite(M)
    u, _, vt = _nan_where_not(ok, *torch.linalg.svd(M))
    d = torch.linalg.det(u @ vt)
    fix = torch.cat([torch.ones_like(u[:, 0, :2]), d[:, None]], dim=1)
    return (u * fix[:, None, :]) @ vt


def _dlt_p6p(X: torch.Tensor, uv_n: torch.Tensor):
    """DLT poses from >= 6 points per sample; uv_n are normalized image
    coordinates (K^-1 u).  X [S, n, 3], uv_n [S, n, 2] -> (R, t).  The 2n x
    12 system for P = [R|t] up to scale; its 3x3 block is projected onto
    SO(3) after fixing scale and sign."""
    S, n = X.shape[:2]
    zeros = torch.zeros(S, n, 4, dtype=X.dtype, device=X.device)
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=2)    # [S, n, 4]
    u, v = uv_n[..., 0:1], uv_n[..., 1:2]
    r1 = torch.cat([Xh, zeros, -u * Xh], dim=2)
    r2 = torch.cat([zeros, Xh, -v * Xh], dim=2)
    A, ok = _finite(torch.cat([r1, r2], dim=1))                # [S, 2n, 12]
    vt, = _nan_where_not(ok, torch.linalg.svd(A, full_matrices=True)[2])
    P = vt[:, -1].reshape(S, 3, 4)
    M = P[:, :, :3]
    s = torch.linalg.det(M)
    sign = torch.sign(s)
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    M = M * sign[:, None, None]
    t = P[:, :, 3] * sign[:, None]
    scale = torch.pow(torch.clamp(torch.abs(s), min=1e-12), 1.0 / 3.0)
    R = _project_so3(M / scale[:, None, None])
    return R, t / scale[:, None]


def pnp_ransac(
    X: torch.Tensor,
    uv: torch.Tensor,
    inv_sigma2: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    n_samples: int = 512,
    min_set: int = 6,
    chi2_th: float = 5.991,
    min_inliers: int = 10,
    solver: str = "epnp",
    generator: Optional[torch.Generator] = None,
    samples: Optional[torch.Tensor] = None,
) -> PnPResult:
    """X: [N, 3] world points, uv: [N, 2] undistorted pixels (padded, with
    the valid mask).  samples: [n_samples, min_set] row indices of the
    minimal sets; drawn from `generator` (``draw_samples``) when None.

    solver="epnp" is the reference's EPnP minimal solver (min_set >= 4,
    PnPsolver.cc:347-830); solver="p6p" the 6-point DLT."""
    if samples is None:
        samples = draw_samples(generator, valid, n_samples, min_set)
    with true_fp32():
        return _pnp_ransac(X, uv, inv_sigma2, valid, K,
                           samples.to(device=X.device, dtype=torch.int64),
                           chi2_th, min_inliers, solver)


def _pnp_ransac(X, uv, inv_sigma2, valid, K, samples, chi2_th, min_inliers,
                solver):
    n = X.shape[0]
    if solver == "epnp":
        Rs, ts = epnp(X[samples], uv[samples], K)
    elif solver == "p6p":
        Ki = torch.linalg.inv_ex(K, check_errors=False).inverse
        uv_n = (torch.cat([uv, torch.ones(n, 1, dtype=uv.dtype,
                                          device=uv.device)], dim=1)
                @ Ki.T)[:, :2]
        Rs, ts = _dlt_p6p(X[samples], uv_n[samples])
    else:
        raise ValueError(f"unknown PnP solver {solver!r}")

    # every hypothesis scored against every correspondence: [S, N]
    xc = se3.transform(Rs[:, None], ts[:, None], X[None])
    z = xc[..., 2]
    zi = 1.0 / torch.clamp(z, min=1e-6)
    u = xc[..., 0] * zi * K[0, 0] + K[0, 2]
    v = xc[..., 1] * zi * K[1, 1] + K[1, 2]
    c2 = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) * inv_sigma2
    inls = valid[None] & (z > 0) & (c2 <= chi2_th)
    counts = inls.sum(dim=1)
    # the first maximum, as jnp.argmax; picked with index_select, since
    # indexing by a 0-d CUDA tensor reads it to the host
    best = torch.argmax(counts)[None]

    def pick(x):
        return x.index_select(0, best)[0]

    n_best = pick(counts)
    return PnPResult(ok=n_best >= min_inliers, R=pick(Rs), t=pick(ts),
                     inliers=pick(inls), n_inliers=n_best)
