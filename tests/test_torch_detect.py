"""Keypoint selection and the two-threshold gate vs the JAX package, with
planted ties: FAST scores of integer images are integers, so ties decide
which keypoints survive.  Index sets and their order must be exactly equal.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from orb_slam_tpu.ops import detect as jdetect
from orb_slam_tpu_torch.ops import detect as tdetect
from torch_port_util import np_of, t_of


def test_top_k_stable_matches_lax_top_k():
    x = np.array([3, 5, 5, 1, 5, 0, 3], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    tv, ti = tdetect.top_k_stable(t_of(x), 4)
    np.testing.assert_array_equal(np_of(ti), [1, 2, 4, 0])
    np.testing.assert_array_equal(np_of(ti), np_of(ji))
    np.testing.assert_array_equal(np_of(tv), np_of(jv))


def _tied_scores(rng, h, w, levels=(0.0, 0.0, 8.0, 9.0, 20.0, 21.0, 30.0)):
    """A sparse score map drawn from a handful of values: many exact ties
    inside and across cells."""
    s = rng.choice(np.asarray(levels, np.float32), size=(h, w))
    s[rng.uniform(size=(h, w)) < 0.6] = 0.0
    return s.astype(np.float32)


@pytest.mark.parametrize("shape,n_total,per_cell", [
    ((60, 80), 50, 4), ((48, 128), 217, 5), ((37, 53), 500, 6)])
def test_select_keypoints_ties(rng, shape, n_total, per_cell):
    s = _tied_scores(rng, *shape)
    j = jdetect.select_keypoints(jnp.asarray(s), n_total, 10, 16, per_cell)
    t = tdetect.select_keypoints(t_of(s), n_total, 10, 16, per_cell)
    np.testing.assert_array_equal(np_of(t.xy), np_of(j.xy))
    np.testing.assert_array_equal(np_of(t.response), np_of(j.response))
    np.testing.assert_array_equal(np_of(t.valid), np_of(j.valid))


def test_select_keypoints_batched_levels(rng):
    """The port batches the levels where the JAX package vmaps them."""
    s = np.stack([_tied_scores(rng, 48, 64) for _ in range(3)])
    j = jax.vmap(lambda x: jdetect.select_keypoints(x, 40, 4, 4, 5))(
        jnp.asarray(s))
    t = tdetect.select_keypoints(t_of(s), 40, 4, 4, 5)
    np.testing.assert_array_equal(np_of(t.xy), np_of(j.xy))
    np.testing.assert_array_equal(np_of(t.valid), np_of(j.valid))


@pytest.mark.parametrize("shape", [(60, 80), (37, 53)])
def test_two_threshold_gate(rng, shape):
    s = _tied_scores(rng, *shape)
    j = jdetect.two_threshold_gate(jnp.asarray(s), 20.0, 10, 16)
    t = tdetect.two_threshold_gate(t_of(s), 20.0, 10, 16)
    np.testing.assert_array_equal(np_of(t), np_of(j))
    assert (np_of(t) != s).any()          # the gate removed something
