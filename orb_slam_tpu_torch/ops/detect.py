"""Keypoint selection: per-cell top-k then global top-k (port of
``orb_slam_tpu.ops.detect``), batched over any leading dims.

Replaces the reference's per-cell quota distribution and retainBest
(src/ORBextractor.cc:522-707).  FAST scores of integer images are integers,
so ties are everywhere; the JAX package's ``argmax`` and ``lax.top_k``
both prefer the lowest index among equals.  ``torch.argmax`` returns the
first maximum too, but ``torch.topk`` may pick a different *set* among
ties, so every top-k here is a stable descending sort (``top_k_stable``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set for one pyramid level (or a batch)."""

    xy: torch.Tensor        # [..., N, 2] float32 (x, y) in level coordinates
    response: torch.Tensor  # [..., N] float32
    valid: torch.Tensor     # [..., N] bool


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim; among equal
    values the lower index comes first, as ``jax.lax.top_k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_keypoints(score: torch.Tensor, n_total: int, cells_y: int,
                     cells_x: int, per_cell: int) -> Keypoints:
    """score: [..., H, W] NMS'd score map -> top keypoints with spatial
    spread: at most `per_cell` per grid cell, then the global top
    `n_total`, scores descending."""
    h, w = score.shape[-2:]
    lead = score.shape[:-2]
    ch = -(-h // cells_y)
    cw = -(-w // cells_x)
    padded = F.pad(score, (0, cw * cells_x - w, 0, ch * cells_y - h))
    cells = padded.reshape(lead + (cells_y, ch, cells_x, cw))
    cells = cells.transpose(-3, -2).reshape(lead + (cells_y * cells_x,
                                                    ch * cw))

    # k argmax sweeps: exact, first maximum on ties (as jnp.argmax)
    k = min(per_cell, ch * cw)
    col = torch.arange(ch * cw, device=score.device)
    neg = torch.full((), float("-inf"), device=score.device)
    cells_i = cells
    sc, ix = [], []
    for _ in range(k):
        i = torch.argmax(cells_i, dim=-1)
        # exhausted cells clamp to 0.0 (score map >= 0): invalid downstream
        sc.append(torch.clamp(torch.amax(cells_i, dim=-1), min=0.0))
        ix.append(i)
        cells_i = torch.where(col == i[..., None], neg, cells_i)
    cell_scores = torch.stack(sc, dim=-1)             # [..., n_cells, k]
    cell_idx = torch.stack(ix, dim=-1)

    cell_ids = torch.arange(cells_y * cells_x, device=score.device)
    cy = (cell_ids // cells_x)[:, None]
    cx = (cell_ids % cells_x)[:, None]
    gy = cy * ch + cell_idx // cw
    gx = cx * cw + cell_idx % cw

    flat_scores = cell_scores.reshape(lead + (-1,))
    flat_y = gy.reshape(lead + (-1,))
    flat_x = gx.reshape(lead + (-1,))
    m = min(n_total, flat_scores.shape[-1])
    top_scores, top_i = top_k_stable(flat_scores, m)
    ys = torch.gather(flat_y, -1, top_i)
    xs = torch.gather(flat_x, -1, top_i)
    valid = top_scores > 0.0
    xy = torch.stack([xs, ys], dim=-1).to(torch.float32)
    if m < n_total:
        pad = n_total - m
        xy = F.pad(xy, (0, 0, 0, pad))
        top_scores = F.pad(top_scores, (0, pad))
        valid = F.pad(valid, (0, pad))
    return Keypoints(xy=xy, response=top_scores, valid=valid)


def two_threshold_gate(score: torch.Tensor, hi_threshold: float,
                       cells_y: int, cells_x: int) -> torch.Tensor:
    """Per-cell two-threshold FAST fallback (src/ORBextractor.cc:607-614):
    on a score map computed at the LOW threshold, zero every corner at or
    below `hi_threshold` in cells that hold at least one corner above it."""
    h, w = score.shape[-2:]
    ch = -(-h // cells_y)
    cw = -(-w // cells_x)
    padded = F.pad(score, (0, cw * cells_x - w, 0, ch * cells_y - h))
    cells = padded.reshape(score.shape[:-2] + (cells_y, ch, cells_x, cw))
    has_hi = torch.amax(cells, dim=(-3, -1)) > hi_threshold
    full = has_hi.repeat_interleave(ch, dim=-2).repeat_interleave(cw, dim=-1)
    full = full[..., :h, :w]
    return torch.where(full & (score <= hi_threshold),
                       torch.zeros_like(score), score)
