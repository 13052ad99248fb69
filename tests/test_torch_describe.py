"""Kernel 2's plain version (ops/describe_cuda.orient_describe_plain) vs the
JAX package's Pallas kernel in interpret mode and its XLA gather path.

Tolerances (the Pallas kernel's own contract, tests/test_describe_pallas.py):
moments within rtol 3e-4, atol 2.0 (integer-valued sums, exact in practice);
<= 2 differing descriptor bits per keypoint, since the XLA path steers with
cos/sin of atan2 where the kernels divide by |m|, and a sample on a .5
rounding boundary may move.  Slots at or past counts are exact zeros.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from orb_slam_tpu.ops.describe_pallas import orient_describe as j_pallas
from orb_slam_tpu_torch.ops import brief
from orb_slam_tpu_torch.ops.describe_cuda import (_consts, orient_describe,
                                                  orient_describe_plain)
from test_describe_pallas import make_case, xla_reference
from torch_port_util import desc_bits, np_of, t_of


def _port(stack, blurred, xy, dims, counts=None):
    L, cap = np.asarray(xy).shape[:2]
    if counts is None:
        counts = np.full(L, cap, np.int32)
    return orient_describe(t_of(stack), t_of(blurred), t_of(xy), t_of(dims),
                           t_of(np.asarray(counts, np.int32)))


def _check(got, ref_m01, ref_m10, ref_desc):
    m01, m10, desc = map(np_of, got)
    np.testing.assert_allclose(m01.ravel(), np_of(ref_m01).ravel(),
                               rtol=3e-4, atol=2.0)
    np.testing.assert_allclose(m10.ravel(), np_of(ref_m10).ravel(),
                               rtol=3e-4, atol=2.0)
    bits = desc_bits(desc.reshape(-1, 8), np_of(ref_desc).reshape(-1, 8))
    assert bits.max() <= 2, bits.max()
    return bits


def test_matches_pallas_interpret_and_xla(rng):
    stack, blurred, xy, dims = make_case(rng)
    got = _port(stack, blurred, xy, dims)
    bits = _check(got, *j_pallas(stack, blurred, xy, dims, interpret=True))
    # the Pallas kernel steers as the port does: identical descriptors
    assert (bits == 0).all()
    bits = _check(got, *xla_reference(stack, blurred, xy, dims))
    assert (bits == 0).mean() >= 0.95


def test_edge_keypoints(rng):
    stack, blurred, xy, dims = make_case(rng)
    xy = np.array(xy)
    for li in range(xy.shape[0]):
        h, w = np.asarray(dims)[li]
        xy[li, 0] = (16.0, 16.0)
        xy[li, 1] = (w - 17.0, h - 17.0)
        xy[li, 2] = (16.0, h - 17.0)
        xy[li, 3] = (w - 17.0, 16.0)
    xy = jnp.asarray(xy)
    got = _port(stack, blurred, xy, dims)
    _check(got, *j_pallas(stack, blurred, xy, dims, interpret=True))
    _check(got, *xla_reference(stack, blurred, xy, dims))


def test_counts_prefix_and_zeros(rng):
    stack, blurred, xy, dims = make_case(rng, cap=17)
    counts = np.array([5, 17, 0], np.int32)
    m01c, m10c, descc = map(np_of, _port(stack, blurred, xy, dims, counts))
    m01f, m10f, descf = map(np_of, _port(stack, blurred, xy, dims))
    pm01, pm10, pdesc = map(np_of, j_pallas(stack, blurred, xy, dims,
                                            counts=jnp.asarray(counts),
                                            interpret=True))
    for li, c in enumerate(counts):
        np.testing.assert_array_equal(m01c[li, :c], m01f[li, :c])
        np.testing.assert_array_equal(m10c[li, :c], m10f[li, :c])
        np.testing.assert_array_equal(descc[li, :c], descf[li, :c])
        for a in (m01c, m10c, descc):
            assert not a[li, c:].any()
        np.testing.assert_array_equal(descc[li].view(np.uint32), pdesc[li])


def test_angle_of_zero_moments_is_zero():
    """A flat patch has m = 0: the kernel steers with (1, 0) and the angle
    comes out 0, like the Pallas kernel's zero-initialized slots."""
    stack = np.full((1, 64, 64), 7.0, np.float32)
    xy = np.array([[[32.0, 32.0]]], np.float32)
    dims = np.array([[64, 64]], np.int32)
    m01, m10, desc = map(np_of, _port(stack, stack, xy, dims))
    assert m01[0, 0] == 0 and m10[0, 0] == 0 and not desc.any()


def test_wrapper_rejects_bad_inputs(rng):
    stack, blurred, xy, dims = (t_of(a) for a in make_case(rng, cap=4))
    counts = torch.full((3,), 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        orient_describe(stack, blurred, xy, dims, counts.long())
    with pytest.raises(ValueError):
        orient_describe(stack, blurred[:, :10], xy, dims, counts)
    with pytest.raises(ValueError):
        orient_describe(stack, blurred, xy.transpose(0, 1), dims, counts)
    # the wrapper's CPU path is the plain version
    a = orient_describe(stack, blurred, xy, dims, counts)
    b = orient_describe_plain(stack, blurred, xy, dims, counts)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_pattern_tensor_is_brief_points_by_pair():
    """The end points the kernel reads: [2, 256, 2], the p point of every
    pair then its q point, in pair order, float32 and contiguous."""
    pattern = _consts(torch.device("cpu"))[2]
    assert pattern.dtype == torch.float32 and pattern.is_contiguous()
    assert tuple(pattern.shape) == (2, 256, 2)
    np.testing.assert_array_equal(np_of(pattern[0]), brief._POINTS[0::2])
    np.testing.assert_array_equal(np_of(pattern[1]), brief._POINTS[1::2])
    np.testing.assert_array_equal(
        np_of(pattern).transpose(1, 0, 2).reshape(256, 4), brief._PATTERN)


def test_chip_smoke_edge_case_matches_xla():
    """The card's edge case of chip_smoke.py (no live slot, every slot live,
    keypoints at level and canvas edges, a flat patch) through the port's
    CPU path against the JAX XLA path, live slots only."""
    stack, blurred, xy, dims, counts = chip_smoke.describe_edge_case("cpu")
    got = orient_describe(stack, blurred, xy, dims, counts)
    ref = xla_reference(*(jnp.asarray(np_of(a))
                          for a in (stack, blurred, xy, dims)))
    live = np.arange(xy.shape[1])[None, :] < np_of(counts)[:, None]
    m01, m10, desc = map(np_of, got)
    flat = live.ravel()          # the XLA path returns [L * cap] rows
    np.testing.assert_allclose(m01[live], np_of(ref[0])[flat],
                               rtol=3e-4, atol=2.0)
    np.testing.assert_allclose(m10[live], np_of(ref[1])[flat],
                               rtol=3e-4, atol=2.0)
    bits = desc_bits(desc[live], np_of(ref[2])[flat])
    assert bits.max() <= 2, bits.max()
    assert m01[0, 0] == 0 and m10[0, 0] == 0
    assert not desc[~live].any() and not m01[~live].any()
