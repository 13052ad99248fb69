"""The port's per-level reference extractor and its helpers on the CPU,
against the JAX package (``frontend/extractor.py::extract_default``,
``ops/patches.py::{gather_patches, ic_angle}``,
``ops/brief.py::brief_descriptors``), with the thin names of the same
slice (``extract_batched_default``, ``CameraParams.inv_fx / inv_fy``,
``load_system``).

Tolerances, and why:
  - ``gather_patches``: exact (integer taps of the same image);
  - ``ic_angle``: within 1e-5 rad of JAX on integer images (both take
    atan2 of moments that are exact in float32 there; measured 2.4e-7)
    and of the literal numpy golden on JAX's float image (measured
    5.4e-7); on that float image the moments cancel, JAX's own angles lie
    1.05e-5 from the golden, and the port is held to JAX's at JAX's own
    golden bound, 1e-4;
  - ``brief_descriptors``: bit-equal given the same blurred image,
    keypoints and angles;
  - the per-level blur: bit-equal to JAX's compiled blur; the per-level
    pyramid: rounded levels equal to the matrix products' on the CPU;
  - ``extract_default`` (240x320, 4 levels): valid, level, xy and response
    equal, angles within 1e-5 rad, descriptors <= 2 bits per keypoint and
    equal on >= 99% (measured: all equal; the port's per-level blur keeps
    the fused multiply-add order of JAX's compiled blur,
    ``patches.gaussian_blur7_fused``).  With ``score_harris`` the
    responses are Harris values, which XLA's CPU fusion contracts into
    fused multiply-adds and the port does not: they are held within a
    relative 1e-6 (measured 1.3e-7, one float32 ulp), every other field
    as above;
  - per-level against batched in the port: JAX's own bounds
    (``tests/test_extractor_batched.py``): keypoint overlap >= 90% of the
    smaller set, <= 8 bits on common keypoints, > 30 of them checked.
"""
import dataclasses
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tpu.config import ExtractorConfig as JExt
from orb_slam_tpu.dataio import settings as jset
from orb_slam_tpu.frontend import extractor as jex
from orb_slam_tpu.geometry import camera as jcam
from orb_slam_tpu.ops import brief as jbrief
from orb_slam_tpu.ops import patches as jpatches
import orb_slam_tpu_torch
from orb_slam_tpu_torch.config import CameraConfig, ExtractorConfig
from orb_slam_tpu_torch.dataio import settings as tset
from orb_slam_tpu_torch.frontend import extractor as tex
from orb_slam_tpu_torch.frontend import extractor_batched as teb
from orb_slam_tpu_torch.geometry import camera as tcam
from orb_slam_tpu_torch.ops import brief as tbrief
from orb_slam_tpu_torch.ops import patches as tpatches
from orb_slam_tpu_torch.ops import resize as tresize
from test_extractor import synthetic_corners_image
from torch_port_util import desc_bits, np_of

ANGLE_TOL = 1e-5
GOLDEN_TOL = 1e-4
HARRIS_RTOL = 1e-6
CASES = {
    "pad": dict(n_features=200, max_keypoints=256, n_levels=4),
    "retain_best": dict(n_features=200, max_keypoints=128, n_levels=4),
    "harris": dict(n_features=200, max_keypoints=256, n_levels=4,
                   score_harris=True),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's ops on one thread: under the suite's parallel workers a
    full intra-op pool per worker oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corners():
    img, _ = synthetic_corners_image(h=240, w=320,
                                     rng=np.random.default_rng(42),
                                     n_squares=30)
    return img


def _random_keypoints(rng, n, h, w, margin):
    """Keypoints anywhere from `margin` outside the image to inside it,
    fractional, so that rounding and border clamping are both hit."""
    return np.stack([rng.uniform(-margin, w - 1 + margin, n),
                     rng.uniform(-margin, h - 1 + margin, n)],
                    1).astype(np.float32)


# ---------------------------------------------------------------------------
# patches and BRIEF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [7, 31])
def test_gather_patches_equal_jax(size):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (40, 56)).astype(np.float32)
    xy = _random_keypoints(rng, 64, 40, 56, 4.0)
    xy[:4] = [[0, 0], [55, 39], [-3.4, 20], [60.2, -2.6]]
    j = jpatches.gather_patches(jnp.asarray(img), jnp.asarray(xy), size)
    t = tpatches.gather_patches(torch.from_numpy(img),
                                torch.from_numpy(xy), size)
    assert tuple(t.shape) == (64, size, size)
    np.testing.assert_array_equal(np_of(t), np_of(j))


def test_ic_angle_half_planes():
    """JAX's cases: a bright half to the right points along +x, a bright
    half below along +y (y down)."""
    for rows, cols, want in ((slice(None), slice(32, None), 0.0),
                             (slice(32, None), slice(None), np.pi / 2)):
        img = np.zeros((64, 64), np.float32)
        img[rows, cols] = 200.0
        xy = np.asarray([[32.0, 32.0]], np.float32)
        a = float(tpatches.ic_angle(torch.from_numpy(img),
                                    torch.from_numpy(xy))[0])
        j = float(jpatches.ic_angle(jnp.asarray(img), jnp.asarray(xy))[0])
        assert abs(a - want) < 0.1
        assert abs(a - j) <= ANGLE_TOL


def test_ic_angle_numpy_golden():
    """The literal per-keypoint moments of IC_Angle (JAX's golden test,
    summed in float64)."""
    rng = np.random.default_rng(42)
    img = rng.uniform(0, 255, (96, 128)).astype(np.float32)
    xy = np.stack([rng.uniform(20, 108, 12), rng.uniform(20, 76, 12)],
                  1).astype(np.float32)
    ours = np_of(tpatches.ic_angle(torch.from_numpy(img),
                                   torch.from_numpy(xy)))
    jax_ang = np_of(jpatches.ic_angle(jnp.asarray(img), jnp.asarray(xy)))
    # a float image: the moments cancel, so float32 sums in another order
    # move the angle; JAX's own gap to the golden here is 1.05e-5
    np.testing.assert_allclose(ours, jax_ang, rtol=0, atol=GOLDEN_TOL)
    r = tpatches.HALF_PATCH
    for n in range(len(xy)):
        cx, cy = int(round(xy[n, 0])), int(round(xy[n, 1]))
        m10 = m01 = 0.0
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                if dx * dx + dy * dy <= r * r:
                    v = float(img[cy + dy, cx + dx])    # float64 sums
                    m10 += dx * v
                    m01 += dy * v
        ang = np.arctan2(m01, m10)
        assert abs(np.angle(np.exp(1j * (ang - ours[n])))) < ANGLE_TOL, n


def test_ic_angle_near_the_border():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (60, 80)).astype(np.float32)
    xy = _random_keypoints(rng, 200, 60, 80, 2.0)
    j = jpatches.ic_angle(jnp.asarray(img), jnp.asarray(xy))
    t = tpatches.ic_angle(torch.from_numpy(img), torch.from_numpy(xy))
    np.testing.assert_allclose(np_of(t), np_of(j), rtol=0, atol=ANGLE_TOL)


def test_brief_bit_equal_jax():
    """Same blurred image, keypoints and angles: the same words, with
    angles at and near +-pi and keypoints whose steered taps clamp."""
    rng = np.random.default_rng(4)
    img = np.array(jpatches.gaussian_blur7(jnp.asarray(
        rng.integers(0, 256, (72, 96)).astype(np.float32))))
    xy = _random_keypoints(rng, 300, 72, 96, 3.0)
    ang = rng.uniform(-np.pi, np.pi, 300).astype(np.float32)
    ang[:6] = [np.pi, -np.pi, np.float32(np.pi) - 1e-6, 0.0, np.pi / 2,
               -np.pi / 2]
    j = jbrief.brief_descriptors(jnp.asarray(img), jnp.asarray(xy),
                                 jnp.asarray(ang))
    t = tbrief.brief_descriptors(torch.from_numpy(img), torch.from_numpy(xy),
                                 torch.from_numpy(ang))
    assert t.dtype == torch.int32 and tuple(t.shape) == (300, 8)
    np.testing.assert_array_equal(np_of(t).view(np.uint32), np_of(j))


def test_brief_steering_follows_a_rotation():
    """JAX's steering case: a patch and its copy rotated by 90 degrees
    describe alike when the angle is supplied, and worse without it."""
    img, _ = synthetic_corners_image(rng=np.random.default_rng(42))
    blurred = tpatches.gaussian_blur7(torch.from_numpy(img))
    xy = torch.tensor([[80.0, 60.0]])
    d0 = tbrief.brief_descriptors(blurred, xy, torch.tensor([0.0]))
    rot = torch.from_numpy(np.rot90(np_of(blurred), k=-1).copy())
    xy_r = torch.tensor([[img.shape[0] - 1 - 60.0, 80.0]])
    d1 = tbrief.brief_descriptors(rot, xy_r, torch.tensor([np.pi / 2]))
    d1u = tbrief.brief_descriptors(rot, xy_r, torch.tensor([0.0]))
    steered = int(desc_bits(np_of(d0), np_of(d1))[0])
    unsteered = int(desc_bits(np_of(d0), np_of(d1u))[0])
    assert steered < 80 and steered < unsteered, (steered, unsteered)


# ---------------------------------------------------------------------------
# the per-level pyramid and blur
# ---------------------------------------------------------------------------

def test_fused_blur_equals_jax_compiled_blur(corners):
    """The per-level blur is JAX's jitted blur to the bit (XLA's CPU fusion
    contracts each pass into fused multiply-adds; the eager blur differs
    from it on 6.5% of the corners image's pixels)."""
    rng = np.random.default_rng(6)
    for img in (corners, rng.uniform(0, 255, (97, 131)).astype(np.float32)):
        j = jax.jit(jpatches.gaussian_blur7)(jnp.asarray(img))
        t = tpatches.gaussian_blur7_fused(torch.from_numpy(img))
        np.testing.assert_array_equal(np_of(t), np_of(j))


def test_fused_resize_rounds_like_the_matrix_product():
    """The per-level pyramid's fused multiply-add chains round to the same
    integer levels as the matrix products on the CPU, on a rendered
    640x480 frame at 8 levels of 1.2."""
    import smoke_world as syn
    K = np.array([[500, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    img = torch.from_numpy(syn.SceneRenderer(
        np.random.default_rng(11), K).render(*syn.pose_at(13)).astype(
            np.float32))
    for lh, lw in tex.level_shapes(ExtractorConfig(), 480, 640)[1:]:
        a = torch.round(tresize.resize_bilinear_fused(img, lh, lw))
        b = torch.round(tresize.resize_bilinear(img, lh, lw))
        assert torch.equal(a, b), (lh, lw)


# ---------------------------------------------------------------------------
# the per-level extractor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_extract_default_matches_jax(corners, case):
    kw = CASES[case]
    j = jex.extract_default(jnp.asarray(corners), JExt(**kw))
    t = tex.extract_default(corners, ExtractorConfig(**kw), device="cpu")
    assert t.xy.shape == (kw["max_keypoints"], 2)
    assert t.desc.dtype == torch.int32 and t.level.dtype == torch.int64
    v = np_of(j.valid)
    n_slots = sum(tex.level_quotas(ExtractorConfig(**kw), 200))
    assert (kw["max_keypoints"] > n_slots) == (case != "retain_best")
    np.testing.assert_array_equal(np_of(t.valid), v)
    np.testing.assert_array_equal(np_of(t.level), np_of(j.level))
    np.testing.assert_array_equal(np_of(t.xy), np_of(j.xy))
    if kw.get("score_harris"):
        np.testing.assert_allclose(np_of(t.response), np_of(j.response),
                                   rtol=HARRIS_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(np_of(t.response), np_of(j.response))
    np.testing.assert_allclose(np_of(t.angle)[v], np_of(j.angle)[v],
                               rtol=0, atol=ANGLE_TOL)
    bits = desc_bits(np_of(t.desc)[v], np_of(j.desc)[v])
    assert bits.max() <= 2, bits.max()
    assert (bits == 0).mean() >= 0.99, (bits == 0).mean()
    assert v.sum() > 40


def _keypoint_set(feats):
    v = np_of(feats.valid)
    return {(round(float(x), 1), round(float(y), 1), int(lv)): d
            for (x, y), lv, d in zip(np_of(feats.xy)[v],
                                     np_of(feats.level)[v],
                                     np_of(feats.desc)[v])}


def test_per_level_against_batched(corners):
    cfg = ExtractorConfig(**CASES["pad"])
    a = _keypoint_set(tex.extract_default(corners, cfg, device="cpu"))
    b = _keypoint_set(teb.extract_batched(corners, cfg, device="cpu"))
    common = a.keys() & b.keys()
    assert len(common) >= 0.9 * min(len(a), len(b)), (len(a), len(b),
                                                      len(common))
    ham = [int(desc_bits(a[k][None], b[k][None])[0]) for k in common]
    assert max(ham) <= 8, max(ham)
    assert len(ham) > 30


def test_extract_batched_default_equals_extract_batched(corners):
    cfg = ExtractorConfig(**CASES["pad"])
    a = teb.extract_batched_default(corners, cfg, device="cpu")
    b = teb.extract_batched(corners, cfg, cfg.n_features, cfg.max_keypoints,
                            device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="asserts the raise of a box without a card")
def test_extract_default_without_a_card_raises(corners):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tex.extract_default(corners, ExtractorConfig(**CASES["pad"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teb.extract_batched_default(corners, ExtractorConfig(**CASES["pad"]))


# ---------------------------------------------------------------------------
# thin names
# ---------------------------------------------------------------------------

def test_inverse_focal_lengths():
    cfg = CameraConfig(fx=517.3, fy=516.5, width=640, height=480)
    params = tcam.make_camera(cfg, device="cpu")
    j = jcam.make_camera(jax_config(cfg))
    assert float(params.inv_fx) == float(np.float32(1.0) / np.float32(517.3))
    assert float(params.inv_fx) == float(j.inv_fx)
    assert float(params.inv_fy) == float(j.inv_fy)
    assert params.inv_fx.dtype == torch.float32


def jax_config(cfg):
    from orb_slam_tpu.config import CameraConfig as JCam
    return JCam(**dataclasses.asdict(cfg))


SETTINGS = """\
    %YAML:1.0
    Camera.fx: 535.4
    Camera.fy: 539.2
    Camera.cx: 320.1
    Camera.cy: 247.6
    Camera.k1: 0.0
    Camera.k2: 0.0
    Camera.p1: 0.0
    Camera.p2: 0.0
    Camera.fps: 30.0
    Camera.RGB: 1
    ORBextractor.nFeatures: 800
    ORBextractor.scaleFactor: 1.2
    ORBextractor.nLevels: 6
    ORBextractor.iniThFAST: 20
    ORBextractor.minThFAST: 7
"""


def test_load_system(tmp_path):
    p = tmp_path / "Settings.yaml"
    p.write_text(textwrap.dedent(SETTINGS))
    system = orb_slam_tpu_torch.load_system(str(p), width=320, height=240,
                                            device="cpu")
    want = tset.config_from_settings(str(p), 320, 240)
    assert dataclasses.asdict(system.cfg) == dataclasses.asdict(want)
    assert dataclasses.asdict(system.cfg) == dataclasses.asdict(
        jset.config_from_settings(str(p), 320, 240))
    assert system.cfg.extractor.n_features == 800
    assert system.tracker.device == torch.device("cpu")
