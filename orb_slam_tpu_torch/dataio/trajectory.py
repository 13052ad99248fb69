"""Trajectory export/import in TUM RGB-D format and ATE evaluation (the
port's own copy of ``orb_slam_tpu.dataio.trajectory``; pure numpy).

Replaces the reference's shutdown trajectory dump (src/main.cc:160-185,
format `timestamp tx ty tz qx qy qz qw`) and the external TUM evaluation
tooling (SURVEY.md §4) with built-ins.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def save_tum(path: str, rows: Sequence[Tuple[float, np.ndarray, np.ndarray]]):
    """rows: (timestamp, t_wc [3], q_xyzw [4])."""
    with open(path, "w") as f:
        for ts, t, q in rows:
            f.write(
                f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def load_tum(path: str) -> np.ndarray:
    """Returns [N, 8] array: ts, tx, ty, tz, qx, qy, qz, qw."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(x) for x in line.split()[:8]])
    return np.asarray(rows)


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst ([N,3] each).

    Returns (s, R, t) with dst ~ s R src + t.  Monocular trajectories are
    defined up to scale, so ATE is computed after Sim(3) alignment (the
    standard TUM protocol for monocular SLAM)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / max(var_s, 1e-12)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after (Sim3) alignment.

    est, gt: [N, 3] associated positions (same timestamps)."""
    s, R, t = umeyama_alignment(est, gt, with_scale)
    aligned = est @ (s * R).T + t
    err = np.linalg.norm(aligned - gt, axis=1)
    return float(np.sqrt((err**2).mean()))


def associate_by_time(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02):
    """Greedy nearest-timestamp association (TUM associate.py semantics).

    Returns (idx_a, idx_b) index arrays."""
    ia, ib = [], []
    used = np.zeros(len(ts_b), bool)
    for i, ta in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - ta)))
        if not used[j] and abs(ts_b[j] - ta) <= max_dt:
            ia.append(i)
            ib.append(j)
            used[j] = True
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)
