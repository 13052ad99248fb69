"""The pyramid stack builder and kernel 1's plain version
(ops/fast_cuda.fast_nms_blur_plain) vs the JAX package.

Tolerances:
  * stack: integer-equal on levels >= 1 (level 0 exact); a pixel may differ
    only where the unrounded value sits within 1e-3 of .5, where the two
    matmul summation orders may round apart — such pixels are counted;
  * plain vs the JAX XLA path: score exact, blur 1e-5 (same taps, same
    order; XLA may fuse the sums differently);
  * plain vs the Pallas kernel in interpret mode: score exact on the
    interior, blur atol 1e-3 away from the 8-px canvas border (the Pallas
    kernel clamps at the canvas edge where the plain version reflects).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam_tpu.config import ExtractorConfig as JExt
from orb_slam_tpu.frontend import extractor as jextractor
from orb_slam_tpu.frontend import extractor_batched as jeb
from orb_slam_tpu.ops import fast as jfast, patches as jpatches
from orb_slam_tpu.ops.fast_pallas import fast_nms_blur_stack as j_pallas
from orb_slam_tpu_torch.config import ExtractorConfig
from orb_slam_tpu_torch.frontend import extractor_batched as teb
from orb_slam_tpu_torch.frontend.extractor import level_quotas, level_shapes
from orb_slam_tpu_torch.ops import fast as tfast, patches as tpatches
from orb_slam_tpu_torch.ops.fast_cuda import (fast_nms_blur_plain,
                                              fast_nms_blur_stack)
import chip_smoke
from smoke_world import SceneRenderer, pose_at
from test_extractor import synthetic_corners_image
from torch_port_util import np_of, t_of


@pytest.fixture(scope="module")
def frame():
    K = np.array([[250, 0, 160], [0, 250, 120], [0, 0, 1]], np.float32)
    return SceneRenderer(np.random.default_rng(1), K, 320, 240).render(
        *pose_at(3))


def test_level_layout_equal():
    for kw in (dict(), dict(n_levels=4), dict(scale_factor=1.5)):
        j, t = JExt(**kw), ExtractorConfig(**kw)
        for h, w in ((480, 640), (240, 320), (97, 131)):
            assert level_shapes(t, h, w) == jextractor.level_shapes(j, h, w)
        assert level_quotas(t, 1000) == jextractor.level_quotas(j, 1000)


@pytest.mark.parametrize("size", [(240, 320, 4), (480, 640, 8)])
def test_stack_builder(size, rng):
    h, w, L = size
    img = rng.integers(0, 256, (h, w)).astype(np.float32)
    cfg = ExtractorConfig(n_levels=L)
    shapes = level_shapes(cfg, h, w)
    st = teb._statics(shapes, level_quotas(cfg, 100), cfg.scale_factor,
                      torch.device("cpu"))
    got = np_of(teb._build_stack(t_of(img), st))
    ref = np_of(jeb._build_stack(jnp.asarray(img), shapes))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[0, :h, :w], img)
    # the unrounded levels, to tell a .5 case from an error
    Ay, Ax = jeb._resize_mats(shapes)
    pre = (np.asarray(Ay, np.float64) @ img.astype(np.float64)
           @ np.asarray(Ax, np.float64).transpose(0, 2, 1))
    diff = got[1:] != ref[1:]
    frac = np.abs(pre[1:] - np.floor(pre[1:]) - 0.5)
    assert (frac[diff] < 1e-3).all(), "a non-.5 pixel rounds differently"
    assert diff.sum() <= 1e-4 * diff.size, int(diff.sum())


@pytest.mark.parametrize("size", [(240, 320, 4), (480, 640, 8)])
def test_stack_zero_outside_dims(size, rng):
    """The precondition kernel 1 skips padding tiles on: each level of the
    stack is exactly zero outside its true (h, w), even for a frame with no
    zero pixel."""
    h, w, L = size
    img = rng.integers(1, 256, (h, w)).astype(np.float32)
    cfg = ExtractorConfig(n_levels=L)
    shapes = level_shapes(cfg, h, w)
    st = teb._statics(shapes, level_quotas(cfg, 100), cfg.scale_factor,
                      torch.device("cpu"))
    stack = np_of(teb._build_stack(t_of(img), st))
    for li, (lh, lw) in enumerate(shapes):
        assert (stack[li, :lh, :lw] > 0).all()
        assert not stack[li, lh:].any() and not stack[li, :, lw:].any()


def test_tile_classes_main_path():
    """Kernel 1's tiles at the main path's [8, 480, 640] canvas, as
    chip_smoke.tile_classes sorts them (the kernel's rule): 1402 of 2400
    tiles hold only padding."""
    cfg = ExtractorConfig()
    shapes = level_shapes(cfg, 480, 640)
    assert chip_smoke.tile_classes(shapes, 480, 640) == (1402, 193, 805)
    # the ragged 4-level canvas: W % 4 == 0, rows not a multiple of 32
    small = level_shapes(ExtractorConfig(n_levels=4), 240, 320)
    zero, edge, inner = chip_smoke.tile_classes(small, 240, 384)
    assert zero + edge + inner == 4 * 8 * 12 and zero > 0 and inner > 0


@functools.partial(jax.jit, static_argnums=(2, 3))
def _xla_score(s, dims, threshold, border):
    """The JAX package's use_pallas=False detection (extractor_batched.py
    lines 102-119)."""
    score = jax.vmap(lambda im: jfast.fast_score(im, threshold))(s)
    score = jax.vmap(jfast.nms3x3)(score)
    H0, W0 = s.shape[1:]
    row = jnp.arange(H0)[None, :, None]
    col = jnp.arange(W0)[None, None, :]
    lh = dims[:, 0][:, None, None]
    lw = dims[:, 1][:, None, None]
    inside = ((row >= border) & (row < lh - border)
              & (col >= border) & (col < lw - border))
    return jnp.where(inside, score, 0.0)


def test_plain_matches_xla_path(frame):
    cfg = ExtractorConfig(n_levels=4)
    h, w = frame.shape
    shapes = level_shapes(cfg, h, w)
    st = teb._statics(shapes, level_quotas(cfg, 100), cfg.scale_factor,
                      torch.device("cpu"))
    stack = teb._build_stack(t_of(frame, torch.float32), st)
    dims = np.asarray(shapes, np.int32)
    score, blur = fast_nms_blur_stack(stack, t_of(dims), 7.0, 16)
    s = jnp.asarray(np_of(stack))
    ref_score = np_of(_xla_score(s, jnp.asarray(dims), 7.0, 16))
    # the blur of line 147, before rounding, op by op as XLA runs it there
    ref_blur = np_of(jax.vmap(jpatches.gaussian_blur7)(s))
    np.testing.assert_array_equal(np_of(score), ref_score)
    np.testing.assert_allclose(np_of(blur), ref_blur, atol=1e-5)
    assert (np_of(score) > 0).sum() > 100


def test_plain_matches_pallas_interpret(rng):
    img, _ = synthetic_corners_image(h=120, w=160, rng=rng, n_squares=12)
    img2 = rng.integers(0, 256, (100, 130)).astype(np.float32)
    dims = np.array([[120, 160], [100, 130]], np.int32)
    stack = np.zeros((2, 128, 256), np.float32)
    stack[0, :120, :160] = img
    stack[1, :100, :130] = img2
    ps, pb = j_pallas(jnp.asarray(stack), jnp.asarray(dims), 7.0, 16,
                      tile_rows=64, interpret=True)
    ts, tb = fast_nms_blur_plain(t_of(stack), t_of(dims), 7.0, 16)
    ps, pb, ts, tb = map(np_of, (ps, pb, ts, tb))
    for li, (h, w) in enumerate(dims):
        np.testing.assert_array_equal(ts[li, 16:h - 16, 16:w - 16],
                                      ps[li, 16:h - 16, 16:w - 16])
        assert ts[li, h:].max(initial=0) == 0 and ts[li, :, w:].max() == 0
    np.testing.assert_allclose(tb[:, 8:-8, 8:-8], pb[:, 8:-8, 8:-8],
                               atol=1e-3)


def test_fast_nms_harris_blur_pieces(rng):
    img = rng.integers(0, 256, (2, 40, 56)).astype(np.float32)
    # planted plateau: equal scores, so the NMS tie rule decides
    img[0, 10:14, 10:14] = 255.0
    j_fast = jax.jit(jfast.fast_score, static_argnums=1)
    j_nms, j_harris = jax.jit(jfast.nms3x3), jax.jit(jfast.harris_score)
    for i in range(2):
        j_s = j_fast(jnp.asarray(img[i]), 7.0)
        t_s = tfast.fast_score(t_of(img), 7.0)[i]
        np.testing.assert_array_equal(np_of(t_s), np_of(j_s))
        np.testing.assert_array_equal(np_of(tfast.nms3x3(t_s)),
                                      np_of(j_nms(j_s)))
        np.testing.assert_allclose(
            np_of(tfast.harris_score(t_of(img[i]))),
            np_of(j_harris(jnp.asarray(img[i]))),
            rtol=1e-5,
            atol=1e-2)
        np.testing.assert_allclose(
            np_of(tpatches.gaussian_blur7(t_of(img[i]))),
            np_of(jpatches.gaussian_blur7(jnp.asarray(img[i]))), atol=1e-5)
    np.testing.assert_array_equal(tpatches._IC_MASK, jpatches._IC_MASK)
    np.testing.assert_array_equal(tpatches._IC_DX, jpatches._IC_DX)


def test_wrapper_rejects_bad_inputs():
    stack = torch.zeros((2, 32, 32))
    dims = torch.tensor([[32, 32], [20, 20]], dtype=torch.int32)
    with pytest.raises(ValueError):
        fast_nms_blur_stack(stack.double(), dims, 7.0, 4)
    with pytest.raises(ValueError):
        fast_nms_blur_stack(stack, dims.long(), 7.0, 4)
    with pytest.raises(ValueError):
        fast_nms_blur_stack(stack.transpose(1, 2), dims, 7.0, 4)
    with pytest.raises(ValueError):
        fast_nms_blur_stack(stack[:, :4, :4].contiguous(), dims, 7.0, 4)
