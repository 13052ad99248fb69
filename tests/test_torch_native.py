"""The port's host graph ops against the JAX package's numpy versions.

The port builds its own byte-equal copy of ``graphops.cpp`` (g++, into
``orb_slam_tpu_torch/_build/``).  Each function — the compiled one where
g++ builds it here, and the numpy one — must equal the JAX package's numpy
fallback exactly (integer outputs; tolerance 0).
"""
import os

import numpy as np
import pytest

import orb_slam_tpu.native as jnative
from orb_slam_tpu_torch import _build, native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_graphops_copy_is_byte_equal():
    with open(os.path.join(ROOT, "orb_slam_tpu", "native", "graphops.cpp"),
              "rb") as f:
        ref = f.read()
    with open(os.path.join(_build.CSRC, "graphops.cpp"), "rb") as f:
        assert f.read() == ref


def test_build_goes_to_the_ports_build_dir():
    path = _build.host_extension_path("graphops")
    assert path.startswith(os.path.join(ROOT, "orb_slam_tpu_torch",
                                        "_build"))


@pytest.fixture
def jax_numpy(monkeypatch):
    """The JAX package's functions on their numpy fallbacks."""
    monkeypatch.setattr(jnative, "_graphops", None)
    return jnative


def _obs(rng, K=7, N=40, P=60, dup=True):
    """Observation rows of distinct ids (the map's invariant), some -1."""
    obs = np.stack([rng.choice(P, N, replace=False)
                    for _ in range(K)]).astype(np.int32)
    obs[rng.random((K, N)) < 0.3] = -1
    if dup:
        obs[1, 5] = obs[1, 6] = 3      # a duplicate id inside a row
    return obs


IMPLS = ["compiled", "numpy"]


def _impl(name, which):
    if which == "compiled":
        if native.backend() != "compiled":
            pytest.skip("g++ could not build the extension here")
        return getattr(native, name)
    return getattr(native, name + "_plain")


@pytest.mark.parametrize("which", IMPLS)
def test_pack_ba_edges(rng, jax_numpy, which):
    obs = _obs(rng)
    kpv = rng.random(obs.shape) < 0.8
    lut = np.full(61, -1, np.int32)
    pts = rng.choice(60, 25, replace=False)
    lut[pts] = np.arange(25, dtype=np.int32)
    got = _impl("pack_ba_edges", which)(obs, kpv, lut)
    ref = jax_numpy.pack_ba_edges(obs, kpv, lut)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


@pytest.mark.parametrize("which", IMPLS)
def test_remap_observations(rng, jax_numpy, which):
    obs = _obs(rng)
    lut = np.arange(61, dtype=np.int32)
    lut[[3, 10, 11]] = [7, 12, 12]          # merges -> per-row duplicates
    a, b = obs.copy(), obs.copy()
    n_got = _impl("remap_observations", which)(a, lut)
    n_ref = jax_numpy.remap_observations(b, lut)
    assert n_got == n_ref
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", IMPLS)
def test_covisibility_counts(rng, jax_numpy, which):
    obs = _obs(rng, dup=False)
    kfv = np.ones(obs.shape[0], bool)
    kfv[2] = False
    np.testing.assert_array_equal(
        _impl("covisibility_counts", which)(obs, kfv, 60),
        jax_numpy.covisibility_counts(obs, kfv, 60))


@pytest.mark.parametrize("which", IMPLS)
def test_vote_keyframes(rng, jax_numpy, which):
    obs = _obs(rng)
    seed = rng.random(61) < 0.3
    np.testing.assert_array_equal(
        _impl("vote_keyframes", which)(obs, seed),
        jax_numpy.vote_keyframes(obs, seed))


def test_backend_is_explicit():
    assert native.backend() in ("compiled", "numpy")
    if native.backend() == "compiled":
        native.require_compiled()
    else:
        with pytest.raises(RuntimeError):
            native.require_compiled()
