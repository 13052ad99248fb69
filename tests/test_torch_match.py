"""The matcher skeleton of the port vs the JAX package: every integer output
(distances, indices, masks) must be exactly equal."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam_tpu.ops import match as jm, scatter as jscatter
from orb_slam_tpu_torch.ops import match as tm
from orb_slam_tpu_torch.ops.scatter import invert_matches
from torch_port_util import np_of, t_of


def _desc(rng, n):
    d = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    d[0] = 0
    d[1] = 0xFFFFFFFF                  # all bits set: sign bit of int32
    d[2] = 0x80000001
    return d


def test_popcount_edge_words():
    w = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x55555555, 0xAAAAAAAA,
                  0x7FFFFFFF, 0x0F0F0F0F], np.uint32)
    got = np_of(tm._popcount32(t_of(w.view(np.int32))))
    np.testing.assert_array_equal(
        got, [bin(int(v)).count("1") for v in w])


def test_hamming_matrix(rng):
    d1, d2 = _desc(rng, 70), _desc(rng, 90)
    d2[5] = d1[7]
    j = np_of(jm.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    t = tm.hamming_matrix(t_of(d1.view(np.int32)), t_of(d2.view(np.int32)))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(np_of(t), j)
    np.testing.assert_array_equal(
        j, np_of(jm.hamming_matrix_xla(jnp.asarray(d1), jnp.asarray(d2))))
    assert np_of(t)[7, 5] == 0


def _dist(rng, n, m, ties=True):
    d = rng.integers(0, 120, (n, m)).astype(np.int32)
    if ties:                           # equal best distances in many rows
        d[::3, 4] = d[::3].min(axis=1)
        d[::3, 9] = d[::3, 4]
    d[rng.uniform(size=(n, m)) < 0.5] = jm.INF_DIST
    return d


@pytest.mark.parametrize("ratio,mutual", [(1.0, False), (0.9, False),
                                          (0.8, True)])
def test_match_nn(rng, ratio, mutual):
    d = _dist(rng, 80, 60)
    j = jm.match_nn(jnp.asarray(d), 100, ratio=ratio, mutual=mutual)
    t = tm.match_nn(t_of(d), 100, ratio=ratio, mutual=mutual)
    np.testing.assert_array_equal(np_of(t.idx), np_of(j.idx))
    np.testing.assert_array_equal(np_of(t.dist), np_of(j.dist))
    np.testing.assert_array_equal(np_of(t.valid), np_of(j.valid))


def test_resolve_duplicates_with_tied_distances(rng):
    n, m = 120, 40
    idx = rng.integers(0, m, n)
    dist = rng.integers(10, 14, n).astype(np.int32)   # many equal distances
    valid = rng.uniform(size=n) < 0.8
    idx = np.where(valid, idx, -1)
    jmm = jm.Matches(idx=jnp.asarray(idx, jnp.int32),
                     dist=jnp.asarray(dist), valid=jnp.asarray(valid))
    tmm = tm.Matches(idx=t_of(idx, torch.int64), dist=t_of(dist),
                     valid=t_of(valid))
    j = jm.resolve_duplicates(jmm, m)
    t = tm.resolve_duplicates(tmm, m)
    np.testing.assert_array_equal(np_of(t.idx), np_of(j.idx))
    np.testing.assert_array_equal(np_of(t.valid), np_of(j.valid))
    kept = np_of(t.idx)[np_of(t.valid)]
    assert len(kept) == len(set(kept.tolist()))
    # unique columns now: the inverse table equals the JAX package's
    np.testing.assert_array_equal(
        np_of(invert_matches(t.idx, t.valid, m)),
        np_of(jscatter.invert_matches(j.idx, j.valid, m)))


def test_rotation_consistency(rng):
    n = 200
    a1 = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    # a dominant rotation of ~0.3 rad plus outliers
    a2 = (a1 - 0.3 + rng.normal(0, 0.05, n)).astype(np.float32)
    a2[:40] = rng.uniform(-np.pi, np.pi, 40)
    idx = np.arange(n)
    valid = rng.uniform(size=n) < 0.9
    jmm = jm.Matches(idx=jnp.asarray(np.where(valid, idx, -1), jnp.int32),
                     dist=jnp.zeros(n, jnp.int32), valid=jnp.asarray(valid))
    tmm = tm.Matches(idx=t_of(np.where(valid, idx, -1), torch.int64),
                     dist=torch.zeros(n, dtype=torch.int32),
                     valid=t_of(valid))
    j = np_of(jm.rotation_consistency(jnp.asarray(a1), jnp.asarray(a2), jmm))
    t = np_of(tm.rotation_consistency(t_of(a1), t_of(a2), tmm))
    np.testing.assert_array_equal(t, j)
    assert 0 < t.sum() < valid.sum()


def test_masks(rng):
    xy1 = rng.uniform(0, 100, (30, 2)).astype(np.float32)
    xy2 = rng.uniform(0, 100, (40, 2)).astype(np.float32)
    r = rng.uniform(5, 30, 30).astype(np.float32)
    l1, l2 = rng.integers(0, 8, 30), rng.integers(0, 8, 40)
    v1, v2 = rng.uniform(size=30) < 0.8, rng.uniform(size=40) < 0.8
    for rad in (r, np.float32(12.5)):
        np.testing.assert_array_equal(
            np_of(tm.window_mask(t_of(xy1), t_of(xy2), t_of(rad)
                                 if rad.ndim else float(rad))),
            np_of(jm.window_mask(jnp.asarray(xy1), jnp.asarray(xy2),
                                 jnp.asarray(rad))))
    np.testing.assert_array_equal(
        np_of(tm.level_mask(t_of(l1), t_of(l2), lo=1, hi=0)),
        np_of(jm.level_mask(jnp.asarray(l1), jnp.asarray(l2), lo=1, hi=0)))
    vm = np_of(tm.valid_mask(t_of(v1), t_of(v2)))
    np.testing.assert_array_equal(
        vm, np_of(jm.valid_mask(jnp.asarray(v1), jnp.asarray(v2))))
    F = rng.normal(0, 1e-3, (3, 3)).astype(np.float32)
    s2 = np.full(40, 1.44, np.float32)
    np.testing.assert_array_equal(
        np_of(tm.epipolar_mask(t_of(xy1), t_of(xy2), t_of(F), t_of(s2))),
        np_of(jm.epipolar_mask(jnp.asarray(xy1), jnp.asarray(xy2),
                               jnp.asarray(F), jnp.asarray(s2))))
    d = rng.integers(0, 256, (30, 40)).astype(np.int32)
    np.testing.assert_array_equal(
        np_of(tm.apply_masks(t_of(d), t_of(vm))),
        np_of(jm.apply_masks(jnp.asarray(d), jnp.asarray(vm))))
