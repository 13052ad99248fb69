"""EPnP: Efficient Perspective-n-Point pose, batched over RANSAC samples
(port of ``orb_slam_tpu.solvers.epnp``).

The reference's PnPsolver core (src/PnPsolver.cc:347-830, the
Lepetit/Moreno-Noguer/Fua 2009 algorithm): 4 control points from the PCA of
the world points, barycentric coordinates, the 2n x 12 projection system,
the beta cases N=1/2/3 over the null-space basis with the 6 inter-control
distance constraints, Gauss-Newton refinement of the betas, and absolute
orientation (Horn/Umeyama) for (R, t).  The JAX package vmaps one problem;
here every function takes a leading sample axis [S, ...] and broadcasts.

What differs from the JAX package, and why:
  * the 6x3 and 6x5 least-squares solves are a pseudo-inverse through the
    SVD with the JAX package's cutoff (singular values below
    eps * max(m, n) * s_max dropped), on both devices: torch's CUDA lstsq
    has only the full-rank `gels` driver, which disagrees with the
    minimum-norm answer on a degenerate sample;
  * the 3x3 inverse and the 4x4 Gauss-Newton solves use ``inv_ex`` /
    ``solve_ex`` without error checks: no host wait, and a singular sample
    gives inf/NaN as in JAX (such a hypothesis scores no inlier);
  * torch's eigh and SVD raise on a non-finite matrix where JAX returns
    NaN, so each decomposition takes a sample with a non-finite input as
    zeros and its results are set to NaN after it (``_finite``): a
    degenerate sample still ends with JAX's outcome, identity and zero
    when every beta case is NaN, and the rest of the batch is untouched;
  * the 5 Gauss-Newton iterations are an unrolled loop;
  * everything runs in true float32 (TF32 off), as the other solvers.

Eigenvectors come out of the batched eigh with arbitrary signs (Jacobi on
the card, LAPACK on the CPU); the pose does not depend on them, so tests
compare poses, never intermediate vectors.
"""
from __future__ import annotations

import torch

from ..device import true_fp32
from ..geometry import se3

_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
_GN_ITERS = 5


def _finite(A):
    """(A with its non-finite samples zeroed, [S] finite mask): the input
    of a decomposition that must not raise on one bad sample."""
    ok = torch.isfinite(A).flatten(1).all(dim=1)
    return torch.where(ok[:, None, None], A, torch.zeros_like(A)), ok


def _nan_where_not(ok, *xs):
    nan = torch.full((), float("nan"), dtype=xs[0].dtype,
                     device=xs[0].device)
    return tuple(torch.where(ok.reshape((-1,) + (1,) * (x.dim() - 1)), x,
                             nan) for x in xs)


def _control_points(X):
    """World control points [S, 4, 3]: centroid + principal axes
    (choose_control_points)."""
    c0 = X.mean(dim=1)                                     # [S, 3]
    Xc = X - c0[:, None]
    cov, ok = _finite(Xc.transpose(1, 2) @ Xc / X.shape[1])
    w, v = torch.linalg.eigh(cov)                          # ascending
    w, v = _nan_where_not(ok, w, v)
    s = torch.sqrt(torch.clamp(w, min=1e-10))
    return torch.stack([
        c0,
        c0 + s[:, 2:3] * v[:, :, 2],
        c0 + s[:, 1:2] * v[:, :, 1],
        c0 + s[:, 0:1] * v[:, :, 0],
    ], dim=1)


def _barycentric(X, cw):
    """alphas [S, n, 4] with X = sum_i alpha_i cw_i, sum alpha = 1."""
    A = (cw[:, 1:] - cw[:, :1]).transpose(1, 2)            # [S, 3, 3]
    eye = torch.eye(3, dtype=X.dtype, device=X.device)
    Ainv = torch.linalg.inv_ex(A + 1e-12 * eye, check_errors=False).inverse
    a123 = (X - cw[:, :1]) @ Ainv.transpose(1, 2)          # [S, n, 3]
    a0 = 1.0 - torch.sum(a123, dim=2, keepdim=True)
    return torch.cat([a0, a123], dim=2)


def _build_M(alphas, uv, fx, fy, cx, cy):
    """[S, 2n, 12] system (fill_M)."""
    u, v = uv[..., 0], uv[..., 1]
    zero = torch.zeros_like(u)
    ru = torch.cat([
        torch.stack([alphas[..., i] * fx, zero, alphas[..., i] * (cx - u)],
                    dim=-1) for i in range(4)], dim=-1)    # [S, n, 12]
    rv = torch.cat([
        torch.stack([zero, alphas[..., i] * fy, alphas[..., i] * (cy - v)],
                    dim=-1) for i in range(4)], dim=-1)
    return torch.cat([ru, rv], dim=1)


def _rho(cw):
    """Squared inter-control distances of the world control points [S, 6]."""
    return torch.stack([torch.sum((cw[:, a] - cw[:, b]) ** 2, dim=-1)
                        for a, b in _PAIRS], dim=-1)


def _dv_terms(V):
    """V: [S, 12, 4] null-space basis (columns).  Returns dv [S, 4, 6, 3]:
    for basis k, the 6 pairwise control-point difference vectors."""
    ctrl = V.transpose(1, 2).reshape(V.shape[0], 4, 4, 3)  # [S, k, ctrl, 3]
    return torch.stack([ctrl[:, :, a] - ctrl[:, :, b] for a, b in _PAIRS],
                       dim=2)


def _lstsq(L, rho):
    """Minimum-norm least squares of L [S, m, n] x = rho [S, m] through the
    SVD, with jnp.linalg.lstsq's cutoff (singular values below
    eps * max(m, n) * s_max dropped)."""
    m, n = L.shape[-2:]
    L, ok = _finite(L)
    u, s, vt = _nan_where_not(ok, *torch.linalg.svd(L, full_matrices=False))
    rcond = torch.finfo(L.dtype).eps * max(m, n)
    mask = (s > 0) & (s >= rcond * s[:, :1])
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    uTb = (u.transpose(1, 2) @ rho[..., None])[..., 0]
    return (vt.transpose(1, 2) @ (s_inv * uTb)[..., None])[..., 0]


def _betas_case1(dv, rho):
    """N=1: beta * v, closed-form least squares on distances."""
    d = dv[:, 0]                                           # [S, 6, 3]
    dd = torch.sum(d * d, dim=2)                           # [S, 6]
    beta = torch.sum(torch.sqrt(dd * torch.clamp(rho, min=0.0)), dim=1) \
        / torch.clamp(torch.sum(dd, dim=1), min=1e-12)
    z = torch.zeros_like(beta)
    return torch.stack([beta, z, z, z], dim=1)


def _betas_case2(dv, rho):
    """N=2: unknowns [b11, b12, b22], a 6x3 least squares
    (betas_approx_2)."""
    d1, d2 = dv[:, 0], dv[:, 1]
    L = torch.stack([
        torch.sum(d1 * d1, dim=2),
        2.0 * torch.sum(d1 * d2, dim=2),
        torch.sum(d2 * d2, dim=2),
    ], dim=2)                                              # [S, 6, 3]
    sol = _lstsq(L, rho)
    b11, b12, b22 = sol[:, 0], sol[:, 1], sol[:, 2]
    b1 = torch.sqrt(torch.clamp(b11, min=0.0))
    b2 = torch.sqrt(torch.clamp(b22, min=0.0)) * torch.sign(b12) * torch.sign(
        torch.where(b11 >= 0, torch.ones_like(b11), -torch.ones_like(b11)))
    b1 = torch.where(b11 < 0, torch.zeros_like(b1), b1)
    z = torch.zeros_like(b1)
    return torch.stack([b1, b2, z, z], dim=1)


def _betas_case3(dv, rho):
    """N=3: unknowns [b11, b12, b22, b13, b23], a 6x5 least squares
    (betas_approx_3)."""
    d1, d2, d3 = dv[:, 0], dv[:, 1], dv[:, 2]
    L = torch.stack([
        torch.sum(d1 * d1, dim=2),
        2.0 * torch.sum(d1 * d2, dim=2),
        torch.sum(d2 * d2, dim=2),
        2.0 * torch.sum(d1 * d3, dim=2),
        2.0 * torch.sum(d2 * d3, dim=2),
    ], dim=2)                                              # [S, 6, 5]
    sol = _lstsq(L, rho)
    b11, b12, b13 = sol[:, 0], sol[:, 1], sol[:, 3]
    b1 = torch.sqrt(torch.clamp(b11, min=0.0))
    big = b1 > 1e-9
    safe = torch.clamp(b1, min=1e-9)
    z = torch.zeros_like(b1)
    b2 = torch.where(big, b12 / safe, z)
    b3 = torch.where(big, b13 / safe, z)
    return torch.stack([b1, b2, b3, z], dim=1)


def _gauss_newton_betas(betas, dv, rho):
    """Refine the betas on the 6 distance residuals (gauss_newton,
    PnPsolver.cc:736-800), _GN_ITERS unrolled steps."""
    eye4 = 1e-9 * torch.eye(4, dtype=betas.dtype, device=betas.device)
    b = betas
    for _ in range(_GN_ITERS):
        dcc = torch.einsum("sk,skpc->spc", b, dv)          # [S, 6, 3]
        f = torch.sum(dcc * dcc, dim=2) - rho              # [S, 6]
        J = 2.0 * torch.einsum("spc,skpc->spk", dcc, dv)   # [S, 6, 4]
        JtJ = J.transpose(1, 2) @ J + eye4
        rhs = (J.transpose(1, 2) @ f[..., None])
        db = -torch.linalg.solve_ex(JtJ, rhs, check_errors=False).result
        b = b + db[..., 0]
    return b


def _pose_from_betas(betas, V, alphas, X):
    """Camera control points from the betas -> per-point camera coords ->
    Horn alignment (compute_ccs / compute_pcs / estimate_R_and_t)."""
    S = V.shape[0]
    cc = torch.einsum("sk,skic->sic", betas,
                      V.transpose(1, 2).reshape(S, 4, 4, 3))   # [S, 4, 3]
    pc = alphas @ cc                                           # [S, n, 3]
    # depth sign (solve_for_sign): most depths must be positive
    sign = torch.sign(torch.sum(torch.sign(pc[..., 2]), dim=1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    pc = pc * sign[:, None, None]

    # absolute orientation world -> camera (EPnP is metric: no scale)
    mu_w = X.mean(dim=1)
    mu_c = pc.mean(dim=1)
    cov, ok = _finite((pc - mu_c[:, None]).transpose(1, 2)
                      @ (X - mu_w[:, None]))
    U, _, Vt = _nan_where_not(ok, *torch.linalg.svd(cov))
    sgn = torch.sign(torch.linalg.det(U @ Vt))
    fix = torch.ones(S, 3, dtype=X.dtype, device=X.device)
    fix = torch.cat([fix[:, :2], sgn[:, None]], dim=1)
    R = (U * fix[:, None, :]) @ Vt
    t = mu_c - (R @ mu_w[..., None])[..., 0]
    return R, t


def epnp(X: torch.Tensor, uv: torch.Tensor, K: torch.Tensor):
    """EPnP poses from n >= 4 correspondences per sample.

    X: [S, n, 3] world points; uv: [S, n, 2] undistorted pixels; K [3, 3].
    Returns (R [S, 3, 3], t [S, 3]), per sample the beta case of least
    reprojection error."""
    with true_fp32():
        return _epnp(X, uv, K)


def _epnp(X, uv, K):
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    cw = _control_points(X)
    alphas = _barycentric(X, cw)
    M = _build_M(alphas, uv, fx, fy, cx, cy)
    MtM, ok = _finite(M.transpose(1, 2) @ M)
    vecs, = _nan_where_not(ok, torch.linalg.eigh(MtM)[1])
    V = vecs[:, :, :4]                    # the 4 smallest eigenvectors
    rho = _rho(cw)
    dv = _dv_terms(V)

    def err_of(R, t):
        xc = se3.transform(R[:, None], t[:, None], X)
        z = torch.clamp(xc[..., 2], min=1e-6)
        u = xc[..., 0] / z * fx + cx
        v = xc[..., 1] / z * fy + cy
        return torch.sum((u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2,
                         dim=1)

    S = X.shape[0]
    best_R = torch.eye(3, dtype=X.dtype, device=X.device).expand(S, 3, 3)
    best_t = torch.zeros(S, 3, dtype=X.dtype, device=X.device)
    best_e = torch.full((S,), float("inf"), dtype=X.dtype, device=X.device)
    for case_fn in (_betas_case1, _betas_case2, _betas_case3):
        b = _gauss_newton_betas(case_fn(dv, rho), dv, rho)
        R, t = _pose_from_betas(b, V, alphas, X)
        e = err_of(R, t)
        better = e < best_e
        best_R = torch.where(better[:, None, None], R, best_R)
        best_t = torch.where(better[:, None], t, best_t)
        best_e = torch.where(better, e, best_e)
    return best_R, best_t
