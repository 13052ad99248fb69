"""SE(3) Lie-group algebra on tensors (port of ``orb_slam_tpu.geometry.se3``).

Convention: a pose is a world->camera transform Tcw stored as (R, t) with
R: [..., 3, 3], t: [..., 3].  Tangent vectors xi = (upsilon, omega) with the
translation part first, matching g2o's SE3Quat::exp ordering.  The
small-angle Taylor branches are kept, so zero tangent vectors stay exact.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of w[..., 3] -> [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues: omega[..., 3] -> R[..., 3, 3]. Taylor-safe near zero."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    W = hat(omega)
    W2 = W @ W
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """R[..., 3, 3] -> omega[..., 3], via atan2(|w|/2, (tr-1)/2)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    wnorm = torch.linalg.vector_norm(w, dim=-1)  # = 2 sin(theta)
    theta = torch.atan2(wnorm, tr - 1.0)
    sin_t = 0.5 * wnorm
    small = sin_t < _EPS
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / torch.clamp(2.0 * sin_t, min=_EPS))
    return scale[..., None] * w


def _left_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l(omega): V matrix of SE(3) exp."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    W = hat(omega)
    W2 = W @ W
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * W2


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", A, x)


def exp(xi: torch.Tensor):
    """SE(3) exponential. xi[..., 6] = (upsilon, omega) -> (R, t)."""
    ups, omega = xi[..., :3], xi[..., 3:]
    return so3_exp(omega), _matvec(_left_jacobian(omega), ups)


def log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """SE(3) log: (R, t) -> xi[..., 6] = (upsilon, omega)."""
    omega = so3_log(R)
    ups = torch.linalg.solve(_left_jacobian(omega), t[..., None])[..., 0]
    return torch.cat([ups, omega], dim=-1)


def compose(Ra, ta, Rb, tb):
    """(Ra,ta) o (Rb,tb): x -> Ra (Rb x + tb) + ta."""
    return Ra @ Rb, _matvec(Ra, tb) + ta


def inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_matvec(Rt, t)


def transform(R, t, x):
    """Apply to points x[..., 3]."""
    return _matvec(R, x) + t


def retract(R, t, xi):
    """Left-multiplicative update exp(xi) o (R, t), as g2o's
    VertexSE3Expmap::oplusImpl."""
    dR, dt = exp(xi)
    return compose(dR, dt, R, t)


_POLAR_ITERS = 5


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation R[..., 3, 3] onto SO(3): the closest rotation
    in Frobenius norm, the U V^T of its SVD as in the JAX package.

    Computed as the orthogonal polar factor by Newton's iteration
    R <- (R + R^-T) / 2 (_POLAR_ITERS steps), with R^-T as the cofactor
    matrix over the determinant, because torch's CUDA SVD and inverse make
    the host wait for the card.  The iteration converges quadratically
    from the ~1e-6 off-manifold drift of a float32 pose chain; for
    det(R) > 0 the polar factor is the SVD projection.  Call at per-frame
    update boundaries: float32 pose chains compound off-manifold error
    geometrically."""
    for _ in range(_POLAR_ITERS):
        r0, r1, r2 = R[..., 0, :], R[..., 1, :], R[..., 2, :]
        cof = torch.stack([torch.linalg.cross(r1, r2),
                           torch.linalg.cross(r2, r0),
                           torch.linalg.cross(r0, r1)], dim=-2)
        det = torch.sum(r0 * cof[..., 0, :], dim=-1)
        R = 0.5 * (R + cof / det[..., None, None])
    return R


def to_matrix(R, t):
    bot = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                       device=R.device).expand(R.shape[:-2] + (1, 4))
    top = torch.cat([R, t[..., None]], dim=-1)
    return torch.cat([top, bot], dim=-2)


def from_matrix(T):
    return T[..., :3, :3], T[..., :3, 3]


def to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """R[..., 3, 3] -> unit quaternion (qx, qy, qz, qw), TUM trajectory order
    (Shepperd's method via the max-trace component)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def s_of(q2):
        return torch.sqrt(torch.clamp(q2, min=_EPS)) * 2.0

    s = s_of(qw2)
    from_w = torch.stack([(m21 - m12) / s, (m02 - m20) / s,
                          (m10 - m01) / s, s / 4.0], -1)
    s = s_of(qx2)
    from_x = torch.stack([s / 4.0, (m01 + m10) / s, (m02 + m20) / s,
                          (m21 - m12) / s], -1)
    s = s_of(qy2)
    from_y = torch.stack([(m01 + m10) / s, s / 4.0, (m12 + m21) / s,
                          (m02 - m20) / s], -1)
    s = s_of(qz2)
    from_z = torch.stack([(m02 + m20) / s, (m12 + m21) / s, s / 4.0,
                          (m10 - m01) / s], -1)
    cands = torch.stack([from_w, from_x, from_y, from_z], dim=-2)
    idx = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    q = torch.take_along_dim(cands, idx[..., None, None].expand(
        idx.shape + (1, 4)), dim=-2)[..., 0, :]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """(qx, qy, qz, qw) -> R[..., 3, 3]."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > _EPS, 2.0 / n, torch.zeros_like(n))
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return torch.stack(
        [
            torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1),
            torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1),
            torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1),
        ],
        dim=-2,
    )
