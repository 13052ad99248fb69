"""extract_batched of the port (plain path, CPU) vs the JAX package's
use_pallas=False path, on rendered frames.

Tolerances: valid, level, xy and response identical; angle within 1e-5 on
valid slots (both take atan2 of the same integer-valued moments);
descriptors <= 2 bits per keypoint and >= 99% of valid keypoints
bit-identical (the JAX path steers with cos/sin of the angle, the port with
m10/|m|, m01/|m| like the Pallas kernel).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam_tpu.config import ExtractorConfig as JExt
from orb_slam_tpu.frontend import extractor_batched as jeb
from orb_slam_tpu_torch.config import ExtractorConfig
from orb_slam_tpu_torch.frontend.extractor_batched import extract_batched
from smoke_world import SceneRenderer, pose_at
from torch_port_util import desc_bits, np_of


def _compare(j, t):
    v = np_of(j.valid)
    np.testing.assert_array_equal(np_of(t.valid), v)
    np.testing.assert_array_equal(np_of(t.level), np_of(j.level))
    np.testing.assert_array_equal(np_of(t.xy), np_of(j.xy))
    np.testing.assert_array_equal(np_of(t.response), np_of(j.response))
    np.testing.assert_allclose(np_of(t.angle)[v], np_of(j.angle)[v],
                               atol=1e-5)
    bits = desc_bits(np_of(t.desc)[v], np_of(j.desc)[v])
    assert bits.max() <= 2, bits.max()
    assert (bits == 0).mean() >= 0.99, (bits == 0).mean()
    return int(v.sum())


@pytest.mark.parametrize("size,kw", [
    ((320, 240), dict(n_features=500, max_keypoints=512, n_levels=4)),
    ((640, 480), dict()),
])
def test_extract_matches_jax(size, kw):
    w, h = size
    f = w / 640 * 500
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    img = SceneRenderer(np.random.default_rng(2), K, w, h).render(
        *pose_at(17))
    jcfg, tcfg = JExt(**kw), ExtractorConfig(**kw)
    j = jeb.extract_batched(jnp.asarray(img), jcfg, jcfg.n_features,
                            jcfg.max_keypoints, False)
    t = extract_batched(img, tcfg, device="cpu")
    assert t.desc.dtype == torch.int32 and t.level.dtype == torch.int64
    n = _compare(j, t)
    assert n >= 0.9 * tcfg.n_features


def test_extract_harris_and_fewer_slots(rng):
    """The plain Harris route, and a slot budget above L * slot_cap
    (the pad branch)."""
    img = rng.integers(0, 256, (120, 160)).astype(np.uint8)
    kw = dict(n_features=100, max_keypoints=256, n_levels=3,
              score_harris=True)
    jcfg, tcfg = JExt(**kw), ExtractorConfig(**kw)
    j = jeb.extract_batched(jnp.asarray(img, jnp.float32), jcfg, 100, 256,
                            False)
    t = extract_batched(img, tcfg, device="cpu")
    assert t.xy.shape == (256, 2)
    v = np_of(j.valid)
    np.testing.assert_array_equal(np_of(t.valid), v)
    np.testing.assert_allclose(np_of(t.xy), np_of(j.xy), atol=1e-4)
    bits = desc_bits(np_of(t.desc)[v], np_of(j.desc)[v])
    assert bits.max() <= 2
