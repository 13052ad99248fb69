"""Two-view map bootstrap: batched 8-point homography/fundamental RANSAC
(port of ``orb_slam_tpu.solvers.initializer``).

Both model families are fitted and scored for every RANSAC sample in one
batch; model selection (RH = SH/(SH+SF) > 0.40, Initializer.cc:110-116),
ReconstructF (essential-matrix decomposition, :468-568) and ReconstructH
(Faugeras' 8 motions, :570-730) keep the reference's gates, and all 12
motion hypotheses go through one batched CheckRT.

Randomness: the JAX package draws its samples with ``jax.random``; the port
draws them from an explicit CPU ``torch.Generator`` (``draw_samples``) and
moves them to the device, so the card and the CPU path pick the same
hypotheses.  ``initialize`` takes the samples as an argument, which lets a
test hand in the JAX package's own draws.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import InitializerConfig
from ..geometry import triangulate


class InitResult(NamedTuple):
    ok: torch.Tensor               # 0-d bool
    used_homography: torch.Tensor  # 0-d bool (diagnostic)
    R: torch.Tensor                # [3, 3] world(frame1)->frame2
    t: torch.Tensor                # [3] unit-norm translation
    points: torch.Tensor           # [N, 3] triangulated in frame1
    good: torch.Tensor             # [N] bool triangulation inliers
    n_good: torch.Tensor           # 0-d int


def draw_samples(generator: torch.Generator, valid: torch.Tensor,
                 n_samples: int, sample_size: int) -> torch.Tensor:
    """[n_samples, sample_size] int64 indices, each row `sample_size`
    distinct valid rows drawn uniformly (Initializer.cc:77-85), from a CPU
    generator: the Gumbel top-k of uniform weights over the valid rows (the
    distribution of the JAX package's ``jax.random.choice(..., replace=
    False, p=valid/sum)``)."""
    v = valid.detach().cpu()
    u = torch.rand((n_samples, v.shape[0]), generator=generator)
    keys = torch.where(v[None, :], u, torch.full_like(u, 2.0))
    return torch.sort(keys, dim=1, stable=True).indices[:, :sample_size]


def _normalize(xy: torch.Tensor, valid: torch.Tensor):
    w = valid.to(xy.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(xy * w[:, None], dim=0) / n
    dev = torch.sum(torch.abs(xy - mean) * w[:, None], dim=0) / n
    s = 1.0 / torch.clamp(dev, min=1e-8)
    xn = (xy - mean) * s
    zero = torch.zeros((), dtype=xy.dtype, device=xy.device)
    one = torch.ones((), dtype=xy.dtype, device=xy.device)
    T = torch.stack([
        torch.stack([s[0], zero, -mean[0] * s[0]]),
        torch.stack([zero, s[1], -mean[1] * s[1]]),
        torch.stack([zero, zero, one])])
    return xn, T


def _h_from_8(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Homographies from [S, 8, 2] correspondences (normalized), [S,3,3]."""
    x, y = x1[..., 0], x1[..., 1]
    u, v = x2[..., 0], x2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], dim=-1)
    r2 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    A = torch.stack([r1, r2], dim=-2).reshape(x.shape[0], -1, 9)
    vt = torch.linalg.svd(A, full_matrices=True).Vh
    return vt[:, -1].reshape(-1, 3, 3)


def _f_from_8(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Fundamental matrices (rank 2 enforced) from [S, 8, 2] pairs."""
    x, y = x1[..., 0], x1[..., 1]
    u, v = x2[..., 0], x2[..., 1]
    o = torch.ones_like(x)
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, o], dim=-1)
    vt = torch.linalg.svd(A, full_matrices=True).Vh
    F = vt[:, -1].reshape(-1, 3, 3)
    U, s, Vt2 = torch.linalg.svd(F)
    s = torch.cat([s[:, :2], torch.zeros_like(s[:, 2:])], dim=1)
    return U @ torch.diag_embed(s) @ Vt2


_CHI2_H = 5.991
_CHI2_F = 3.841
_SCORE_TH = 5.991


def _score_h(H, xy1, xy2, valid, inv_sigma2):
    """CheckHomography (:303-380) for [S, 3, 3] models."""
    Hi = torch.linalg.inv_ex(H).inverse

    def transfer(M, a, b):
        ah = torch.cat([a, torch.ones_like(a[:, :1])], dim=1)
        p = ah[None] @ M.transpose(1, 2)                  # [S, N, 3]
        uv = (p[..., :2] / torch.clamp(torch.abs(p[..., 2:3]), min=1e-12)
              * torch.sign(p[..., 2:3]))
        return torch.sum((uv - b[None]) ** 2, dim=-1) * inv_sigma2

    c12 = transfer(H, xy1, xy2)
    c21 = transfer(Hi, xy2, xy1)
    in12 = c12 < _CHI2_H
    in21 = c21 < _CHI2_H
    zero = torch.zeros_like(c12)
    score = torch.sum(torch.where(valid & in12, _SCORE_TH - c12, zero)
                      + torch.where(valid & in21, _SCORE_TH - c21, zero),
                      dim=1)
    return score, valid & in12 & in21


def _score_f(F, xy1, xy2, valid, inv_sigma2):
    """CheckFundamental (:382-466) for [S, 3, 3] models."""
    def epi_chi2(Fm, a, b):
        ah = torch.cat([a, torch.ones_like(a[:, :1])], dim=1)
        ln = ah[None] @ Fm.transpose(1, 2)                # [S, N, 3]
        num = ln[..., 0] * b[None, :, 0] + ln[..., 1] * b[None, :, 1] \
            + ln[..., 2]
        den = ln[..., 0] ** 2 + ln[..., 1] ** 2
        return num * num / torch.clamp(den, min=1e-12) * inv_sigma2

    c12 = epi_chi2(F, xy1, xy2)
    c21 = epi_chi2(F.transpose(1, 2), xy2, xy1)
    in12 = c12 < _CHI2_F
    in21 = c21 < _CHI2_F
    zero = torch.zeros_like(c12)
    score = torch.sum(torch.where(valid & in12, _SCORE_TH - c12, zero)
                      + torch.where(valid & in21, _SCORE_TH - c21, zero),
                      dim=1)
    return score, valid & in12 & in21


def _decompose_e(E: torch.Tensor):
    """E -> 4 hypotheses (R, t) (DecomposeE)."""
    u, _, vt = torch.linalg.svd(E)
    t = u[:, 2]
    t = t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_h(H: torch.Tensor, K: torch.Tensor):
    """Faugeras SVD decomposition of a homography into 8 motion hypotheses
    (ReconstructH)."""
    A = torch.linalg.inv_ex(K).inverse @ H @ K
    U, d, Vt = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    dt, dev = H.dtype, H.device

    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2)
                                  / (d1 * d1 - d3 * d3), min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3)
                                  / (d1 * d1 - d3 * d3), min=0.0))
    sgn1 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=dt, device=dev)
    sgn3 = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=dt, device=dev)
    sgns = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=dt, device=dev)
    x1s, x3s = aux1 * sgn1, aux3 * sgn3
    zero = torch.zeros(4, dtype=dt, device=dev)
    one = torch.ones(4, dtype=dt, device=dev)

    def hyps(c, sn, Rrow1, tp):
        # Rp rows for the four sign cases, then R = s U Rp Vt, t = U tp
        Rp = torch.stack(Rrow1(c, sn), dim=1).reshape(4, 3, 3)
        R = s * (U @ Rp @ Vt)
        t = tp @ U.T
        return R, t / torch.clamp(torch.linalg.vector_norm(t, dim=1,
                                                           keepdim=True),
                                  min=1e-12)

    # case d' = +d2
    aux_st = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2)
                                    * (d2 * d2 - d3 * d3), min=0.0)) \
        / ((d1 + d3) * d2)
    ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2)
    sts = aux_st * sgns
    Rp, tp = hyps(ct * one, sts, lambda c, sn: (
        c, zero, -sn, zero, one, zero, sn, zero, c),
        (d1 - d3) * torch.stack([x1s, zero, -x3s], dim=1))
    # case d' = -d2
    aux_sp = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2)
                                    * (d2 * d2 - d3 * d3), min=0.0)) \
        / ((d1 - d3) * d2)
    cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2)
    sps = aux_sp * sgns
    Rn, tn = hyps(cp * one, sps, lambda c, sn: (
        c, zero, sn, zero, -one, zero, sn, zero, -c),
        (d1 + d3) * torch.stack([x1s, zero, x3s], dim=1))
    return torch.cat([Rp, Rn]), torch.cat([tp, tn])


def initialize(samples: torch.Tensor, xy1: torch.Tensor, xy2: torch.Tensor,
               valid: torch.Tensor, K: torch.Tensor,
               cfg: InitializerConfig = InitializerConfig()) -> InitResult:
    """Two-view bootstrap on [N] padded matches (valid mask).

    samples: [S, sample_size] row indices of the RANSAC sets
    (``draw_samples``, or the JAX package's draws in a test).  xy1/xy2 are
    undistorted pixel coords of the same landmark in frames 1 and 2.
    Returns the pose of frame 2 w.r.t. frame 1 and triangulated points."""
    inv_sigma2 = 1.0 / (cfg.sigma * cfg.sigma)
    samples = samples.to(xy1.device)

    xn1, T1 = _normalize(xy1, valid)
    xn2, T2 = _normalize(xy2, valid)
    T2i = torch.linalg.inv_ex(T2).inverse

    s1 = xn1[samples]                                   # [S, 8, 2]
    s2 = xn2[samples]
    H = T2i @ _h_from_8(s1, s2) @ T1
    F = T2.T @ _f_from_8(s1, s2) @ T1

    h_scores, h_inl = _score_h(H, xy1, xy2, valid, inv_sigma2)
    f_scores, f_inl = _score_f(F, xy1, xy2, valid, inv_sigma2)

    hi = torch.argmax(h_scores)
    fi = torch.argmax(f_scores)
    SH, SF = h_scores[hi], f_scores[fi]
    RH = SH / torch.clamp(SH + SF, min=1e-12)
    use_h = RH > cfg.rh_threshold

    E = K.T @ F[fi] @ K
    Rf, tf = _decompose_e(E)
    Rh, th = _decompose_h(H[hi], K)
    Rs = torch.cat([Rf, Rh])                            # [12, 3, 3]
    ts = torch.cat([tf, th])

    inl = torch.where(use_h, h_inl[hi], f_inl[fi])
    n_good, X, good, par = triangulate.check_rt(
        Rs, ts, xy1[None], xy2[None], inl[None], K,
        sigma2=cfg.sigma * cfg.sigma)

    f_good = n_good[:4]
    h_good = n_good[4:]
    n_inliers = torch.sum(inl)

    # ReconstructF acceptance (Initializer.cc:515-566)
    f_best = torch.argmax(f_good)
    f_max = f_good[f_best]
    min_good = torch.clamp((0.9 * n_inliers.to(torch.float32)).to(
        torch.int64), min=cfg.min_triangulated)
    f_similar = torch.sum(f_good > 0.7 * f_max.to(torch.float32))
    f_ok = ((f_max >= min_good) & (f_similar == 1)
            & (par[f_best] > cfg.min_parallax_deg))

    # ReconstructH acceptance (Initializer.cc:695-730)
    h_sorted = torch.sort(h_good, descending=True).values
    h_best = torch.argmax(h_good)
    h_max, h_second = h_sorted[0], h_sorted[1]
    h_ok = ((h_second.to(torch.float32)
             < cfg.h_second_best_ratio * h_max.to(torch.float32))
            & (h_max >= min_good)
            & (par[4 + h_best] > cfg.min_parallax_deg))

    sel = torch.where(use_h, 4 + h_best, f_best)
    ok = torch.where(use_h, h_ok, f_ok)
    return InitResult(ok=ok, used_homography=use_h, R=Rs[sel], t=ts[sel],
                      points=X[sel], good=good[sel], n_good=n_good[sel])
