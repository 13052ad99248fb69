"""Multi-scale ORB extraction level by level: pyramid -> FAST -> NMS ->
spread-select -> orientation -> blur -> steered BRIEF (port of
``orb_slam_tpu.frontend.extractor``), with the feature record and the
static pyramid layout that the batched extractor shares.

The per-level extractor (``extract``, ``extract_default``) is the
reference path of ORBextractor (src/ORBextractor.cc:718-779 operator(),
:781-822 ComputePyramid, :522-707 ComputeKeyPoints), as the JAX package
writes it: a Python loop over the levels of plain tensor ops.  Its JAX
version reaches no Pallas kernel, so it launches no hand kernel here; the
tracker runs the batched extractor (``extractor_batched.py``), whose two
stages are the hand kernels.  The two differ by design: the batched one
rounds its blur to integers and steers BRIEF by m10/|m|, this one keeps
the float blur and steers by the IC angle.  Its pyramid resize and blur
are chains of fused multiply-adds taken exactly in float64
(``resize.resize_bilinear_fused``, ``patches.gaussian_blur7_fused``) and
its IC moments are float64 sums, so the card and the CPU build the same
levels, blur and moments, and the CPU matches the JAX package's compiled
extractor.

Keypoint coordinates are level-0 pixels (x * 1.2^level) with the level kept
for scale-aware matching, like the reference's cv::KeyPoint.octave; the
per-level results live in fixed-size slots with a validity mask.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..config import ExtractorConfig
from ..device import resolve_device
from ..ops import brief, detect, fast, patches, resize


class FrameFeatures(NamedTuple):
    """Fixed-capacity ORB features for one frame (SoA)."""

    xy: torch.Tensor        # [N, 2] float32, level-0 (raw/distorted) pixels
    response: torch.Tensor  # [N] float32
    angle: torch.Tensor     # [N] float32 radians
    level: torch.Tensor     # [N] int64 pyramid level
    desc: torch.Tensor      # [N, 8] int32 packed 256-bit descriptors
    valid: torch.Tensor     # [N] bool

    @property
    def n(self) -> int:
        return self.xy.shape[0]


def level_shapes(cfg: ExtractorConfig, height: int,
                 width: int) -> Tuple[Tuple[int, int], ...]:
    """Static per-level image shapes, mirroring ComputePyramid's rounding."""
    shapes = []
    for lv in range(cfg.n_levels):
        s = 1.0 / (cfg.scale_factor ** lv)
        shapes.append((int(round(height * s)), int(round(width * s))))
    return tuple(shapes)


def level_quotas(cfg: ExtractorConfig, n_features: int) -> Tuple[int, ...]:
    """Geometric per-level feature quotas (ORBextractor ctor :457-511)."""
    inv = 1.0 / cfg.scale_factor
    total = (1.0 - inv ** cfg.n_levels) / (1.0 - inv)
    base = n_features / total
    quotas = [int(round(base * inv ** lv)) for lv in range(cfg.n_levels - 1)]
    quotas.append(max(n_features - sum(quotas), 0))
    return tuple(quotas)


def _extract_impl(img: torch.Tensor, cfg: ExtractorConfig, n_features: int,
                  max_keypoints: int) -> FrameFeatures:
    """ORB features of a float32 [H, W] frame on its device, level by
    level (the JAX package's ``_extract_impl``)."""
    dev = img.device
    h, w = img.shape
    shapes = level_shapes(cfg, h, w)
    quotas = level_quotas(cfg, n_features)

    per_xy, per_resp, per_angle, per_level, per_desc, per_valid = (
        [], [], [], [], [], [])
    img_l = img
    for lv, (lh, lw) in enumerate(shapes):
        if lv > 0:
            # integer intensities mirror the reference's 8-bit pyramid
            # (cv::resize, ORBextractor.cc:781-822)
            img_l = torch.round(resize.resize_bilinear_fused(img, lh, lw))
        score = fast.fast_score(img_l, float(cfg.fast_threshold_min))
        if cfg.score_harris:
            # FAST corners re-scored by the Harris response (nScoreType=0,
            # ORBextractor.cc:616-620)
            harris = fast.harris_score(img_l)
            score = torch.where(score > 0,
                                harris - torch.amin(harris) + 1e-3,
                                torch.zeros_like(score))
        score = fast.nms3x3(score)

        # clear of the borders by edge_threshold: the IC patch and the
        # steered BRIEF taps (reference EDGE_THRESHOLD, ORBextractor.h)
        b = cfg.edge_threshold
        row = torch.arange(lh, device=dev)[:, None]
        col = torch.arange(lw, device=dev)[None, :]
        interior = (row >= b) & (row < lh - b) & (col >= b) & (col < lw - b)
        score = torch.where(interior, score, torch.zeros_like(score))

        # two-threshold fallback per cell (ORBextractor.cc:607-614)
        if cfg.fast_threshold > cfg.fast_threshold_min:
            score = detect.two_threshold_gate(
                score, float(cfg.fast_threshold), cfg.cells_y, cfg.cells_x)

        kp = detect.select_keypoints(
            score, quotas[lv], cfg.cells_y, cfg.cells_x,
            per_cell=max(4, 4 * quotas[lv] // (cfg.cells_x * cfg.cells_y)))
        ang = patches.ic_angle(img_l, kp.xy)
        blurred = patches.gaussian_blur7_fused(img_l)
        desc = brief.brief_descriptors(blurred, kp.xy, ang)

        per_xy.append(kp.xy * float(cfg.scale_factor ** lv))
        per_resp.append(kp.response)
        per_angle.append(ang)
        per_level.append(torch.full((kp.xy.shape[0],), lv, dtype=torch.int64,
                                    device=dev))
        per_desc.append(desc)
        per_valid.append(kp.valid)

    xy = torch.cat(per_xy, dim=0)
    resp = torch.cat(per_resp, dim=0)
    ang = torch.cat(per_angle, dim=0)
    lev = torch.cat(per_level, dim=0)
    desc = torch.cat(per_desc, dim=0)
    valid = torch.cat(per_valid, dim=0)

    n = xy.shape[0]
    if n < max_keypoints:
        pad = max_keypoints - n
        xy = F.pad(xy, (0, 0, 0, pad))
        resp = F.pad(resp, (0, pad))
        ang = F.pad(ang, (0, pad))
        lev = F.pad(lev, (0, pad))
        desc = F.pad(desc, (0, 0, 0, pad))
        valid = F.pad(valid, (0, pad))
    elif n > max_keypoints:
        # keep the strongest overall (retainBest, ORBextractor.cc:683,699)
        resp_m = torch.where(valid, resp, torch.full_like(resp, -1.0))
        _, idx = detect.top_k_stable(resp_m, max_keypoints)
        xy, resp, ang = xy[idx], resp[idx], ang[idx]
        lev, desc, valid = lev[idx], desc[idx], valid[idx]
    return FrameFeatures(xy=xy, response=resp, angle=ang, level=lev,
                         desc=desc, valid=valid)


def extract(image, cfg: ExtractorConfig, n_features: int,
            max_keypoints: int, device=None) -> FrameFeatures:
    """ORB features of one [H, W] grayscale frame (0..255, any numeric
    dtype; numpy or tensor), level by level.  Runs on `device`: cuda
    unless the caller asks for the CPU."""
    if cfg.patch_size != 2 * patches.HALF_PATCH + 1:
        raise ValueError(
            f"patch_size={cfg.patch_size}: the IC-angle mask and BRIEF "
            f"pattern are generated for {2 * patches.HALF_PATCH + 1}")
    dev = resolve_device(device)
    img = torch.as_tensor(image).to(device=dev, dtype=torch.float32)
    return _extract_impl(img, cfg, n_features, max_keypoints)


def extract_default(image, cfg: ExtractorConfig, device=None) -> FrameFeatures:
    """``extract`` at the configuration's feature count and slot count."""
    return extract(image, cfg, cfg.n_features, cfg.max_keypoints, device)
