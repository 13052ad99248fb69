"""Level-batched ORB extraction: the whole pyramid as one [L, H, W] stack
(port of ``orb_slam_tpu.frontend.extractor_batched``).

    resize (two batched matmuls)   -> [L, H0, W0] stack, levels >= 1 rounded
    FAST + NMS + border + blur     kernel 1 (ops/fast_cuda.py)
    two-threshold gate, per-cell/global top-k      (ops/detect.py)
    IC moments + steered BRIEF     kernel 2 (ops/describe_cuda.py)
    level-0 scaling, global top-k to max_keypoints

On a CUDA tensor the two kernel wrappers launch the hand-written kernels;
on a CPU tensor they run their plain PyTorch versions.  With
``score_harris`` the detection stage takes the plain Harris route on every
device, as the JAX package does.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..config import ExtractorConfig
from ..device import resolve_device, true_fp32
from ..ops import detect, fast, patches, resize
from ..ops.describe_cuda import orient_describe
from ..ops.fast_cuda import fast_nms_blur_stack
from .extractor import FrameFeatures, level_quotas, level_shapes


_PAD_ROWS, _PAD_COLS = 48, 128


def _pad_shape(h, w):
    """The padded canvas of the JAX package's stack (rows to a multiple of
    48, columns of 128), kept so both packages select on the same grid."""
    return (-(-h // _PAD_ROWS) * _PAD_ROWS, -(-w // _PAD_COLS) * _PAD_COLS)


class _Statics(NamedTuple):
    Ay: torch.Tensor      # [L, H0, H] row resize matrices, zero-padded
    Ax: torch.Tensor      # [L, W0, W] column resize matrices, zero-padded
    dims: torch.Tensor    # [L, 2] int32 true (h, w) per level
    quotas: torch.Tensor  # [L] int64 per-level feature quotas
    scale: torch.Tensor   # [L] float32 level -> level-0 scale


@lru_cache(maxsize=16)
def _statics(shapes, quotas, scale_factor, device) -> _Statics:
    """Per-(pyramid, device) constants, uploaded once: the hot path makes
    no host-to-device copy for them."""
    H, W = shapes[0]
    H0, W0 = _pad_shape(H, W)
    L = len(shapes)
    Ay = np.zeros((L, H0, H), np.float32)
    Ax = np.zeros((L, W0, W), np.float32)
    for li, (lh, lw) in enumerate(shapes):
        Ay[li, :lh] = resize.resize_matrix(H, lh)
        Ax[li, :lw] = resize.resize_matrix(W, lw)
    scale = scale_factor ** np.arange(L, dtype=np.float32)
    return _Statics(
        Ay=torch.from_numpy(Ay).to(device),
        Ax=torch.from_numpy(Ax).to(device),
        dims=torch.tensor(shapes, dtype=torch.int32).to(device),
        quotas=torch.tensor(quotas, dtype=torch.int64).to(device),
        scale=torch.from_numpy(np.asarray(scale, np.float32)).to(device))


def _build_stack(img: torch.Tensor, st: _Statics) -> torch.Tensor:
    """[L, H0, W0] stack: each level resized then zero-padded, in true
    float32.  Levels >= 1 are rounded to integers (half to even, as
    jnp.round), mirroring the reference's 8-bit pyramid; level 0 is the
    input image (an identity product, exact)."""
    with true_fp32():
        stack = torch.matmul(torch.matmul(st.Ay, img), st.Ax.transpose(1, 2))
    return torch.cat([stack[:1], torch.round(stack[1:])], dim=0)


def to_device_image(image, device: torch.device) -> torch.Tensor:
    """A frame on `device` as float32 [H, W].  A host frame goes through
    pinned memory with a non-blocking copy, so the upload does not wait for
    the work already queued on the card."""
    t = torch.as_tensor(image)
    if t.device != device and device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory().to(device, non_blocking=True)
    return t.to(device=device, dtype=torch.float32)


class Detections(NamedTuple):
    """The pyramid and its keypoints before description (the inputs of
    kernel 2)."""

    stack: torch.Tensor    # [L, H0, W0] float32 pyramid
    blurred: torch.Tensor  # [L, H0, W0] float32 blur, rounded to integers
    kp: detect.Keypoints   # fields [L, slot_cap, ...], level-local pixels
    valid: torch.Tensor    # [L, slot_cap] bool, a prefix of each level
    dims: torch.Tensor     # [L, 2] int32 true (h, w)
    scale: torch.Tensor    # [L] float32 level -> level-0 scale


def detect_pyramid(img: torch.Tensor, cfg: ExtractorConfig,
                   n_features: int) -> Detections:
    """Pyramid, FAST + NMS + blur (kernel 1), the two-threshold gate and the
    per-level keypoint selection of a float32 [H, W] frame on its device."""
    dev = img.device
    h, w = img.shape
    shapes = level_shapes(cfg, h, w)
    quotas = level_quotas(cfg, n_features)
    st = _statics(shapes, quotas, cfg.scale_factor, dev)

    stack = _build_stack(img, st)                        # [L, H0, W0]
    H0, W0 = stack.shape[1:]

    if not cfg.score_harris:
        score, blurred = fast_nms_blur_stack(
            stack, st.dims, float(cfg.fast_threshold_min), cfg.edge_threshold)
    else:
        score = fast.fast_score(stack, float(cfg.fast_threshold_min))
        harris = fast.harris_score(stack)
        hmin = torch.amin(harris, dim=(1, 2), keepdim=True)
        score = torch.where(score > 0, harris - hmin + 1e-3,
                            torch.zeros_like(score))
        score = fast.nms3x3(score)
        b = cfg.edge_threshold
        row = torch.arange(H0, device=dev)[None, :, None]
        col = torch.arange(W0, device=dev)[None, None, :]
        lh = st.dims[:, 0, None, None]
        lw = st.dims[:, 1, None, None]
        interior = ((row >= b) & (row < lh - b) & (col >= b) & (col < lw - b))
        score = torch.where(interior, score, torch.zeros_like(score))
        blurred = patches.gaussian_blur7(stack)

    # two-threshold fallback per cell (ORBextractor.cc:607-614) on each
    # level's TRUE extent; outside it the score is already 0
    if cfg.fast_threshold > cfg.fast_threshold_min:
        gated = torch.zeros_like(score)
        for li, (h_l, w_l) in enumerate(shapes):
            gated[li, :h_l, :w_l] = detect.two_threshold_gate(
                score[li, :h_l, :w_l], float(cfg.fast_threshold),
                cfg.cells_y, cfg.cells_x)
        score = gated

    # per-level selection with a uniform slot count, then per-level quota
    # by rank (select_keypoints returns scores sorted descending)
    slot_cap = max(quotas)
    kp = detect.select_keypoints(
        score, slot_cap, cfg.cells_y, cfg.cells_x,
        per_cell=max(4, 4 * slot_cap // (cfg.cells_x * cfg.cells_y)))
    rank = torch.arange(slot_cap, device=dev)[None, :]
    valid = kp.valid & (rank < st.quotas[:, None])       # [L, slot_cap]

    # integer-quantized like the reference's 8-bit GaussianBlur output
    # (ORBextractor.cc:137)
    blurred = torch.round(blurred)
    return Detections(stack=stack, blurred=blurred, kp=kp, valid=valid,
                      dims=st.dims, scale=st.scale)


def extract_batched(image, cfg: ExtractorConfig, n_features: int = None,
                    max_keypoints: int = None, device=None) -> FrameFeatures:
    """ORB features of one [H, W] grayscale frame (0..255, any numeric
    dtype; numpy or tensor).  Runs on `device`: cuda unless the caller asks
    for the CPU."""
    if cfg.patch_size != 2 * patches.HALF_PATCH + 1:
        raise ValueError(
            f"patch_size={cfg.patch_size}: the IC-angle mask and BRIEF "
            f"pattern are generated for {2 * patches.HALF_PATCH + 1}")
    dev = resolve_device(device)
    n_features = cfg.n_features if n_features is None else n_features
    max_keypoints = (cfg.max_keypoints if max_keypoints is None
                     else max_keypoints)
    det = detect_pyramid(to_device_image(image, dev), cfg, n_features)
    kp, valid = det.kp, det.valid
    L, slot_cap = valid.shape

    # valid slots are a rank-ordered prefix of each level: the kernel
    # describes only the first counts[l] slots
    counts = valid.sum(dim=1).to(torch.int32)
    m01, m10, desc = orient_describe(det.stack, det.blurred,
                                     kp.xy.contiguous(), det.dims, counts)
    angle = torch.atan2(m01.reshape(-1), m10.reshape(-1))
    desc = desc.reshape(L * slot_cap, 8)

    # level-0 coordinates and the fixed-capacity output
    lvl_of = torch.arange(L, device=dev).repeat_interleave(slot_cap)
    xy0 = kp.xy.reshape(L * slot_cap, 2) * det.scale[lvl_of, None]
    resp = kp.response.reshape(-1)
    vflat = valid.reshape(-1)
    n = xy0.shape[0]
    if n < max_keypoints:
        pad = max_keypoints - n
        xy0 = torch.nn.functional.pad(xy0, (0, 0, 0, pad))
        resp = torch.nn.functional.pad(resp, (0, pad))
        angle = torch.nn.functional.pad(angle, (0, pad))
        lvl_of = torch.nn.functional.pad(lvl_of, (0, pad))
        desc = torch.nn.functional.pad(desc, (0, 0, 0, pad))
        vflat = torch.nn.functional.pad(vflat, (0, pad))
    elif n > max_keypoints:
        resp_m = torch.where(vflat, resp, torch.full_like(resp, -1.0))
        _, idx = detect.top_k_stable(resp_m, max_keypoints)
        xy0, resp, angle = xy0[idx], resp[idx], angle[idx]
        lvl_of, desc, vflat = lvl_of[idx], desc[idx], vflat[idx]
    return FrameFeatures(xy=xy0, response=resp, angle=angle, level=lvl_of,
                         desc=desc, valid=vflat)


def extract_batched_default(image, cfg: ExtractorConfig,
                            device=None) -> FrameFeatures:
    """``extract_batched`` at the configuration's feature and slot counts.
    The JAX version's ``use_pallas`` switch has no counterpart: on the card
    the port always runs its two kernels."""
    return extract_batched(image, cfg, cfg.n_features, cfg.max_keypoints,
                           device)
