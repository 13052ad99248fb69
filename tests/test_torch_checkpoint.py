"""Map checkpoints on the CPU: the ``.npz`` of either package loads in the
other.

A JAX SlamMap with live keyframes (one culled) and points, random tables
(descriptors over the whole uint32 range), a spanning tree and a loop
edge, with host mirrors equal to its tables:
  1. JAX ``save_map`` -> the port's ``load_map(device="cpu")`` equals
     ``SlamMap.from_numpy`` of the same map: every table, counter and
     mirror, and the MapConfig;
  2. the port's ``save_map`` -> JAX ``load_map`` gives the JAX map back:
     every array with its dtype, counter and mirror;
  3. both files hold the same keys, shapes and dtypes (descriptors uint32).
Each runs on the map as made and on its pool grown to twice the keyframes
(``grow_keyframes``) and loaded with the configured capacity: the arrays
decide ``max_keyframes`` in both packages.  Everything is exact
(tolerance 0).  Without a card, ``load_map`` with no device raises: its
default is the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import orb_slam_tpu.config as jc
import orb_slam_tpu_torch.config as tc
from orb_slam_tpu.mapping import checkpoint as jckpt
from orb_slam_tpu.mapping import mapstore as jms
from orb_slam_tpu_torch.mapping import checkpoint as tckpt
from orb_slam_tpu_torch.mapping import mapstore as tms

K, N, P = 8, 32, 128


def _rotations(rng, n):
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q *= np.sign(np.linalg.det(q))[:, None, None]
    return q.astype(np.float32)


def jax_map(rng, n_kf=6, n_mp=90):
    """A JAX SlamMap with random contents and consistent host mirrors."""
    jm = jms.SlamMap.create(jc.MapConfig(max_keyframes=K, max_points=P), N)
    kf_valid = np.arange(K) < n_kf
    kf_valid[2] = False                               # a culled keyframe
    mp_valid = np.arange(P) < n_mp
    mp_valid[rng.choice(n_mp, 10, replace=False)] = False
    obs = np.where(rng.uniform(size=(K, N)) < 0.6,
                   rng.integers(0, n_mp, (K, N)), -1).astype(np.int32)
    obs[~kf_valid] = -1
    u32 = np.iinfo(np.uint32).max
    a = dict(
        kf_valid=kf_valid, kf_R=_rotations(rng, K),
        kf_t=rng.normal(size=(K, 3)).astype(np.float32),
        kf_xy=rng.uniform(0, 640, (K, N, 2)).astype(np.float32),
        kf_level=rng.integers(0, 8, (K, N)).astype(np.int32),
        kf_angle=rng.uniform(0, 360, (K, N)).astype(np.float32),
        kf_desc=rng.integers(0, u32, (K, N, 8), dtype=np.uint32,
                             endpoint=True),
        kf_kp_valid=rng.uniform(size=(K, N)) < 0.9, kf_obs=obs,
        mp_valid=mp_valid, mp_pos=rng.normal(size=(P, 3)).astype(np.float32),
        mp_desc=rng.integers(0, u32, (P, 8), dtype=np.uint32, endpoint=True),
        mp_normal=rng.normal(size=(P, 3)).astype(np.float32),
        mp_min_dist=rng.uniform(0.1, 1, P).astype(np.float32),
        mp_max_dist=rng.uniform(1, 9, P).astype(np.float32),
        mp_ref_kf=rng.integers(-1, n_kf, P).astype(np.int32),
        mp_first_kf=rng.integers(-1, n_kf, P).astype(np.int32),
        mp_found=rng.integers(0, 50, P).astype(np.int32),
        mp_visible=rng.integers(50, 99, P).astype(np.int32))
    jm.state = jms.MapState(**{k: jnp.asarray(v) for k, v in a.items()})
    jm.n_kf, jm.n_mp = n_kf, n_mp
    jm.parent = np.asarray([-1] + list(range(K - 1)), np.int64)
    jm.loop_edges = [(0, n_kf - 1)]
    jm.kf_frame_id = np.where(np.arange(K) < n_kf, 7 * np.arange(K), -1)
    jm.kf_timestamp = np.where(np.arange(K) < n_kf, np.arange(K) / 30, 0.0)
    jm.obs_np, jm.kf_valid_np, jm.mp_valid_np = (
        obs.copy(), kf_valid.copy(), mp_valid.copy())
    jm.host = {n: a[n].copy() for n in jm.host}
    return jm


def port_map_of(jm, device="cpu"):
    """SlamMap.from_numpy of a JAX SlamMap (its arrays, mirrors and host
    fields)."""
    counters = {f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)
                if f.name not in ("state", "host")}
    return tms.SlamMap.from_numpy(
        {n: np.asarray(getattr(jm.state, n)) for n in jms.MapState._fields},
        jm.host, counters, device=device)


def _maps(rng, grown):
    jm = jax_map(rng)
    if grown:
        jm.grow_keyframes()
        assert jm.cfg.max_keyframes == 2 * K
    return jm


def _same_port_maps(a, b):
    for n in tms.MapState._fields:
        x, y = getattr(a.state, n), getattr(b.state, n)
        assert x.dtype == y.dtype and torch.equal(x, y), n
    assert (a.n_kf, a.n_mp) == (b.n_kf, b.n_mp)
    assert a.loop_edges == b.loop_edges
    for n in ("parent", "kf_frame_id", "kf_timestamp", "obs_np",
              "kf_valid_np", "mp_valid_np"):
        x, y = getattr(a, n), getattr(b, n)
        assert x.dtype == y.dtype and np.array_equal(x, y), n
    assert sorted(a.host) == sorted(b.host)
    for n in a.host:
        assert a.host[n].dtype == b.host[n].dtype
        np.testing.assert_array_equal(a.host[n], b.host[n], err_msg=n)
    assert dataclasses.asdict(a.cfg) == dataclasses.asdict(b.cfg)


@pytest.mark.parametrize("grown", [False, True], ids=["as_made", "grown"])
def test_jax_file_loads_in_the_port(tmp_path, rng, grown):
    jm = _maps(rng, grown)
    p = str(tmp_path / "jax.npz")
    jckpt.save_map(p, jm)
    tm = tckpt.load_map(p, tc.MapConfig(max_keyframes=K, max_points=P),
                        device="cpu")
    assert tm.device.type == "cpu"
    assert tm.cfg.max_keyframes == jm.cfg.max_keyframes
    _same_port_maps(tm, port_map_of(jm))
    assert tm.state.kf_desc.dtype == torch.int32
    np.testing.assert_array_equal(tm.state.kf_desc.numpy().view(np.uint32),
                                  np.asarray(jm.state.kf_desc))


@pytest.mark.parametrize("grown", [False, True], ids=["as_made", "grown"])
def test_port_file_loads_in_jax(tmp_path, rng, grown):
    jm = _maps(rng, grown)
    p = str(tmp_path / "port.npz")
    tckpt.save_map(p, port_map_of(jm))
    jm2 = jckpt.load_map(p, jc.MapConfig(max_keyframes=K, max_points=P))
    assert jm2.cfg.max_keyframes == jm.cfg.max_keyframes
    for n in jms.MapState._fields:
        x, y = np.asarray(getattr(jm2.state, n)), np.asarray(
            getattr(jm.state, n))
        assert x.dtype == y.dtype, n
        np.testing.assert_array_equal(x, y, err_msg=n)
    assert (jm2.n_kf, jm2.n_mp) == (jm.n_kf, jm.n_mp)
    assert jm2.loop_edges == jm.loop_edges
    for n in ("parent", "kf_frame_id", "kf_timestamp", "obs_np",
              "kf_valid_np", "mp_valid_np"):
        np.testing.assert_array_equal(getattr(jm2, n), getattr(jm, n))
    for n in jm.host:
        assert jm2.host[n].dtype == jm.host[n].dtype, n
        np.testing.assert_array_equal(jm2.host[n], jm.host[n], err_msg=n)


@pytest.mark.parametrize("grown", [False, True], ids=["as_made", "grown"])
def test_same_keys_shapes_and_dtypes(tmp_path, rng, grown):
    jm = _maps(rng, grown)
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_map(pj, jm)
    tckpt.save_map(pt, port_map_of(jm))
    with np.load(pj) as fj, np.load(pt) as ft:
        assert sorted(fj.files) == sorted(ft.files)
        for k in fj.files:
            assert fj[k].dtype == ft[k].dtype and \
                fj[k].shape == ft[k].shape, k
            np.testing.assert_array_equal(fj[k], ft[k], err_msg=k)
        assert ft["state_kf_desc"].dtype == ft["state_mp_desc"].dtype \
            == np.uint32


def test_load_defaults_to_the_card(tmp_path, rng):
    p = str(tmp_path / "jax.npz")
    jckpt.save_map(p, jax_map(rng))
    cfg = tc.MapConfig(max_keyframes=K, max_points=P)
    if torch.cuda.is_available():
        assert tckpt.load_map(p, cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tckpt.load_map(p, cfg)
