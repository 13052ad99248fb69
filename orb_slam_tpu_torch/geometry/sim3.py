"""Sim(3) algebra (scale + rotation + translation) on tensors (port of
``orb_slam_tpu.geometry.sim3``).

Replaces g2o's Sim3 group (reference: Thirdparty/g2o/g2o/types/sim3/sim3.h)
used for loop-closure alignment and essential-graph optimization.

A Sim3 element g = (s, R, t) acts on points as  x -> s * R x + t, with
s: [...], R: [..., 3, 3], t: [..., 3].  Tangent: zeta[..., 7] = (upsilon,
omega, sigma) with sigma = log-scale.  Every function broadcasts over
leading dims and runs on the device of its inputs.  ``log`` builds exp's V
matrix directly, where the JAX package evaluates exp on the three unit
upsilon vectors to get its columns: the same matrix.
"""
from __future__ import annotations

import torch

from . import se3

_EPS = 1e-8


def identity(dtype=torch.float32, device=None):
    return (torch.ones((), dtype=dtype, device=device),
            torch.eye(3, dtype=dtype, device=device),
            torch.zeros(3, dtype=dtype, device=device))


def transform(s, R, t, x):
    return s[..., None] * se3._matvec(R, x) + t


def compose(sa, Ra, ta, sb, Rb, tb):
    """g_a o g_b: x -> sa Ra (sb Rb x + tb) + ta."""
    return sa * sb, Ra @ Rb, sa[..., None] * se3._matvec(Ra, tb) + ta


def inverse(s, R, t):
    si = 1.0 / s
    Rt = R.transpose(-1, -2)
    return si, Rt, -si[..., None] * se3._matvec(Rt, t)


def _v_matrix(omega, sigma):
    """V[..., 3, 3] of the Sim3 exponential, t = V ups: A*I + B*W + C*W^2
    with the coefficients picked among the general case and its sigma ~ 0,
    theta ~ 0 and joint limits (sim3.h).  Every branch is evaluated behind
    safe denominators, so an unselected branch is finite and neither its
    value nor its forward-mode tangent reaches the output."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = se3.hat(omega)
    W2 = W @ W
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(
        W.shape)

    sig_small = torch.abs(sigma) < 1e-5
    th_small = theta2 < 1e-10
    one = torch.ones_like(sigma)

    es = torch.exp(sigma)
    sig = torch.where(sig_small, one, sigma)
    th = torch.where(th_small, torch.ones_like(theta), theta)
    # general case (sigma != 0, theta != 0)
    a_gen = (es - 1.0) / sig
    denom = sig * sig + th * th
    b_gen = ((es * torch.sin(th) * sig + (1.0 - es * torch.cos(th)) * th)
             / (th * denom))
    c_gen = ((es - 1.0) / sig
             - ((es * torch.cos(th) - 1.0) * sig + es * torch.sin(th) * th)
             / denom) / (th * th)
    # sigma ~ 0 limits
    a_s0 = one
    b_s0 = (1.0 - torch.cos(th)) / (th * th)
    c_s0 = (th - torch.sin(th)) / (th * th * th)
    # theta ~ 0 limits
    a_t0 = a_gen
    b_t0 = torch.where(sig_small, 0.5 * one,
                       ((sig - 1.0) * es + 1.0) / denom)
    c_t0 = torch.where(sig_small, one / 6.0,
                       (es * 0.5 * sig * sig + es - 1.0 - sig * es)
                       / (sig * sig * sig))
    # both small
    a_00, b_00, c_00 = one, 0.5 * one, one / 6.0

    def pick(c00, ct0, cs0, cgen):
        return torch.where(th_small, torch.where(sig_small, c00, ct0),
                           torch.where(sig_small, cs0, cgen))

    A = pick(a_00, a_t0, a_s0, a_gen)
    B = pick(b_00, b_t0, b_s0, b_gen)
    C = pick(c_00, c_t0, c_s0, c_gen)
    return (A[..., None, None] * eye + B[..., None, None] * W
            + C[..., None, None] * W2)


def exp(zeta: torch.Tensor):
    """Sim(3) exponential map: zeta[..., 7] -> (s, R, t), the closed-form
    W matrix of g2o's sim3.h ctor from a 7-vector."""
    ups, omega, sigma = zeta[..., :3], zeta[..., 3:6], zeta[..., 6]
    return (torch.exp(sigma), se3.so3_exp(omega),
            se3._matvec(_v_matrix(omega, sigma), ups))


def log(s, R, t) -> torch.Tensor:
    """Inverse of exp: solves V ups = t (V is 3x3, undamped)."""
    sigma = torch.log(s)
    omega = se3.so3_log(R)
    V = _v_matrix(omega, sigma)
    ups = torch.linalg.solve_ex(V, t[..., None],
                                check_errors=False).result[..., 0]
    return torch.cat([ups, omega, sigma[..., None]], dim=-1)


def retract(s, R, t, zeta):
    """Left-multiplicative update exp(zeta) o g, as
    VertexSim3Expmap::oplusImpl."""
    ds, dR, dt = exp(zeta)
    return compose(ds, dR, dt, s, R, t)


def from_se3(R, t):
    return torch.ones(R.shape[:-2], dtype=R.dtype, device=R.device), R, t


def to_se3(s, R, t):
    """Project to SE3 by folding scale into translation (keyframe poses
    after loop closure: [R, t/s], LoopClosing.cc:480-486)."""
    return R, t / s[..., None]
