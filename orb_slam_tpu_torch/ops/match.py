"""Batched descriptor matching (port of ``orb_slam_tpu.ops.match``).

One dense skeleton replaces the reference's hand-specialized matchers
(src/ORBmatcher.cc): a Hamming matrix, gating masks, a nearest-neighbour
argmin with ratio test, duplicate resolution and the 30-bin rotation
histogram (src/ORBmatcher.cc:40-42, :1748-1792, :1794-1810).

The Hamming distance is XOR plus popcount.  PyTorch has no popcount, so
``_popcount32`` is a SWAR count on int32; descriptors are int32 words
(bit-identical to the JAX package's uint32), and every right shift is
masked because ``>>`` on int32 is arithmetic.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

INF_DIST = 1 << 20
TWO_PI = 6.283185307179586


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int32 word (SWAR; every intermediate stays >= 0
    after its mask, so nothing overflows)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distance of packed descriptors: d1 [..., N, 8]
    int32, d2 [..., M, 8] int32 -> [..., N, M] int32 (leading axes
    broadcast).  One word at a time, so no [N, M, 8] intermediate is
    formed."""
    dist = None
    for w in range(d1.shape[-1]):
        pc = _popcount32(d1[..., :, w, None] ^ d2[..., None, :, w])
        dist = pc if dist is None else dist + pc
    return dist.to(torch.int32)


class Matches(NamedTuple):
    idx: torch.Tensor    # [N] int64: matched column per row (-1 invalid)
    dist: torch.Tensor   # [N] int32: best distance
    valid: torch.Tensor  # [N] bool


def match_nn(dist: torch.Tensor, max_dist: int, ratio: float = 1.0,
             mutual: bool = False) -> Matches:
    """Row-wise nearest neighbour with best/second-best ratio test.

    dist: [..., N, M] with INF_DIST at gated-out pairs (leading axes are
    independent problems).  ratio < 1 enforces
    best < ratio * second-best (mfNNratio, src/ORBmatcher.cc:231-257);
    mutual=True also requires row i to be its column's argmin."""
    best_idx = torch.argmin(dist, dim=-1)
    best = torch.gather(dist, -1, best_idx[..., None])[..., 0]
    # second best by a masked re-min
    cols = torch.arange(dist.shape[-1], device=dist.device)
    second = torch.amin(torch.where(cols == best_idx[..., None],
                                    torch.full_like(dist, INF_DIST), dist),
                        dim=-1)
    ok = best <= max_dist
    if ratio < 1.0:
        ok = ok & (best.to(torch.float32) < ratio * second.to(torch.float32))
    if mutual:
        col_best_row = torch.argmin(dist, dim=-2)
        rows = torch.arange(dist.shape[-2], device=dist.device)
        ok = ok & (torch.gather(col_best_row, -1, best_idx) == rows)
    idx = torch.where(ok, best_idx, torch.full_like(best_idx, -1))
    return Matches(idx=idx, dist=best, valid=ok)


def resolve_duplicates(m: Matches, n_cols: int) -> Matches:
    """Keep only the lowest-distance row per matched column, the first row
    on ties (the reference erases the previous match when a better one
    lands on the same feature, src/ORBmatcher.cc:598-713)."""
    lead, n = m.idx.shape[:-1], m.idx.shape[-1]
    dev = m.idx.device
    col = torch.where(m.valid, m.idx, torch.full_like(m.idx, n_cols))
    dist = torch.where(m.valid, m.dist.to(torch.int64),
                       torch.full_like(m.idx, INF_DIST))
    best_per_col = torch.full(lead + (n_cols + 1,), INF_DIST,
                              dtype=torch.int64, device=dev).scatter_reduce(
        -1, col, dist, reduce="amin", include_self=True)
    keep = m.valid & (m.dist <= torch.gather(best_per_col, -1, col))
    rows = torch.arange(n, device=dev).expand_as(col)
    first_row = torch.full(lead + (n_cols + 1,), 1 << 30, dtype=torch.int64,
                           device=dev).scatter_reduce(
        -1, col, torch.where(keep, rows, torch.full_like(rows, 1 << 30)),
        reduce="amin", include_self=True)
    keep = keep & (rows == torch.gather(first_row, -1, col))
    return Matches(idx=torch.where(keep, m.idx, torch.full_like(m.idx, -1)),
                   dist=m.dist, valid=keep)


_KEEP_BINS = 3


def rotation_consistency(angle1: torch.Tensor, angle2: torch.Tensor,
                         m: Matches, histo_length: int = 30) -> torch.Tensor:
    """Keep matches whose orientation delta falls in the top 3 bins of
    a `histo_length`-bin histogram, dropping bins below 10% of the top one
    (ComputeThreeMaxima, src/ORBmatcher.cc:1748-1792).  Returns the
    filtered validity mask."""
    angle1 = angle1.expand(m.idx.shape)
    a2 = torch.where(m.valid, torch.gather(
        angle2.expand(m.idx.shape[:-1] + angle2.shape[-1:]), -1,
        torch.clamp(m.idx, min=0)), torch.zeros_like(angle1))
    rot = torch.remainder(angle1 - a2, TWO_PI)
    bins = torch.clamp((rot / TWO_PI * histo_length).to(torch.int64),
                       0, histo_length - 1)
    hist = torch.zeros(m.idx.shape[:-1] + (histo_length,), dtype=torch.int32,
                       device=angle1.device).scatter_add_(
        -1, bins, m.valid.to(torch.int32))
    top = torch.topk(hist, _KEEP_BINS, dim=-1).values   # values: ties harmless
    cutoff = torch.maximum(
        top[..., _KEEP_BINS - 1],
        (0.1 * top[..., 0].to(torch.float32)).to(torch.int32))
    good_bin = hist >= torch.clamp(cutoff, min=1)[..., None]
    return m.valid & torch.gather(good_bin, -1, bins)


# ---------------------------------------------------------------------------
# Gating masks (composable with &). All return [N, M] bool.
# ---------------------------------------------------------------------------

def window_mask(xy1: torch.Tensor, xy2: torch.Tensor, radius) -> torch.Tensor:
    """|xy2[j] - xy1[i]|_inf within radius (scalar or per-row [N])."""
    dx = torch.abs(xy1[..., :, None, 0] - xy2[..., None, :, 0])
    dy = torch.abs(xy1[..., :, None, 1] - xy2[..., None, :, 1])
    r = radius
    if isinstance(r, torch.Tensor) and r.dim() >= 1:
        r = r[..., None]
    return (dx <= r) & (dy <= r)


def level_mask(level1: torch.Tensor, level2: torch.Tensor, lo: int = 0,
               hi: int = 0) -> torch.Tensor:
    """level2[j] within [level1[i]-lo, level1[i]+hi] (ORBmatcher.cc:90-96)."""
    d = level2[..., None, :] - level1[..., :, None]
    return (d >= -lo) & (d <= hi)


def valid_mask(valid1: torch.Tensor, valid2: torch.Tensor) -> torch.Tensor:
    return valid1[..., :, None] & valid2[..., None, :]


def epipolar_mask(xy1: torch.Tensor, xy2: torch.Tensor, F12: torch.Tensor,
                  sigma2_level2: torch.Tensor,
                  chi2: float = 3.84) -> torch.Tensor:
    """Point-to-epipolar-line distance gate (CheckDistEpipolarLine,
    src/ORBmatcher.cc:136-153)."""
    lines = (torch.cat([xy1, torch.ones_like(xy1[..., :1])], dim=-1)
             @ F12.transpose(-1, -2))
    a, b, c = lines[..., 0:1], lines[..., 1:2], lines[..., 2:3]
    val = a * xy2[..., None, :, 0] + b * xy2[..., None, :, 1] + c
    dsq = (val * val) / torch.clamp(a * a + b * b, min=1e-12)
    return dsq < chi2 * sigma2_level2[..., None, :]


def apply_masks(dist: torch.Tensor, *masks: torch.Tensor) -> torch.Tensor:
    m = masks[0]
    for extra in masks[1:]:
        m = m & extra
    return torch.where(m, dist, torch.full_like(dist, INF_DIST))
