"""The port's map store against the JAX package's, on one scripted sequence.

The same numpy inputs (from a seed) drive both packages' SlamMap through
keyframe and point insertion, observation writes, point culling, a point
compaction, a pose write, triangulation-style insertion, a keyframe
erasure (the local mapper's), a keyframe compaction at insertion and a
pool growth.  Tolerance: every MapState field exactly equal (descriptors
compared as the same 32-bit words), every host counter equal, and every
host mirror of the port bitwise equal to its device table.
``SlamMap.from_numpy`` must rebuild the JAX map exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import orb_slam_tpu.config as jc
import orb_slam_tpu_torch.config as tc
from orb_slam_tpu.geometry.camera import make_camera as jcam
from orb_slam_tpu.mapping import mapstore as jms
from orb_slam_tpu.pipeline.local_mapper import LocalMapper as JLM
from orb_slam_tpu_torch.geometry.camera import make_camera as tcam
from orb_slam_tpu_torch.mapping import mapstore as tms
from orb_slam_tpu_torch.pipeline.local_mapper import LocalMapper as TLM
from smoke_world import rotmat

N, K0, P0 = 16, 4, 48


def _kf_inputs(rng, k):
    R = rotmat([0, 1, 0.2], 0.05 * k)
    t = rng.normal(0, 1, 3).astype(np.float32)
    return dict(
        R=R, t=t, xy=rng.uniform(0, 600, (N, 2)).astype(np.float32),
        level=rng.integers(0, 4, N).astype(np.int32),
        angle=rng.uniform(0, 6, N).astype(np.float32),
        desc=rng.integers(0, 2**32, (N, 8), dtype=np.uint64).astype(
            np.uint32),
        kp_valid=rng.random(N) < 0.9, obs=np.full(N, -1, np.int32))


def _add_kf(smap, a, frame_id, parent, port):
    desc = a["desc"].view(np.int32) if port else a["desc"]
    return smap.add_keyframe(a["R"], a["t"], a["xy"], a["level"],
                             a["angle"], desc, a["kp_valid"], a["obs"],
                             frame_id, frame_id / 30.0, parent=parent)


def _script(port: bool):
    rng = np.random.default_rng(21)
    mod, cfgm = (tms, tc) if port else (jms, jc)
    mcfg = cfgm.MapConfig(max_keyframes=K0, max_points=P0)
    smap = (tms.SlamMap.create(mcfg, N, device="cpu") if port
            else jms.SlamMap.create(mcfg, N))
    cam_cfg = cfgm.CameraConfig(fx=500, fy=500, cx=320, cy=240, k1=0, k2=0,
                                p1=0, p2=0, k3=0, width=640, height=480)
    lm = (TLM(cfg=cfgm.SystemConfig(map=mcfg, camera=cam_cfg),
              cam=tcam(cam_cfg, device="cpu")) if port else
          JLM(cfg=cfgm.SystemConfig(map=mcfg, camera=cam_cfg),
              cam=jcam(cam_cfg)))

    def arr(x, dt=None):
        return torch.from_numpy(np.array(x, dt)) if port else jnp.asarray(
            np.array(x, dt))

    for k in range(3):
        _add_kf(smap, _kf_inputs(rng, k), 10 * k, k - 1, port)
    M = 20
    pos = rng.normal(0, 3, (M, 3)).astype(np.float32)
    desc = rng.integers(0, 2**32, (M, 8), dtype=np.uint64).astype(np.uint32)
    m = rng.random(M) < 0.85
    ids = smap.add_points(
        arr(pos), arr(desc.view(np.int32) if port else desc),
        arr(rng.normal(0, 1, (M, 3)), np.float32),
        arr(rng.uniform(0, 1, M), np.float32),
        arr(rng.uniform(2, 9, M), np.float32), 1, m)
    live = ids[ids >= 0]
    smap.set_observations(0, np.arange(len(live[:10])), live[:10])
    smap.set_observations(1, np.arange(3, 13), live[5:15])
    smap.set_observations_multi(np.array([2, 2, 2]), np.array([0, 4, 9]),
                                live[[1, 2, 3]])
    # point culling (the local mapper's working-copy commit)
    bad = np.zeros(P0, bool)
    bad[live[[0, 4, 7]]] = True
    obs = smap.obs_np.copy()
    obs[bad[np.clip(obs, 0, P0 - 1)] & (obs >= 0)] = -1
    smap.set_kf_obs(obs)
    smap.set_mp_valid(smap.mp_valid_np & ~bad)
    assert smap.compact_points() == 3
    smap.set_pose(1, rotmat([1, 0, 0], 0.1), np.array([0.5, -0.2, 1.0],
                                                      np.float32))
    # triangulation-style insertion (descriptors from keyframe 2's slots)
    pos2 = rng.normal(0, 3, (N, 3)).astype(np.float32)
    m2 = rng.random(N) < 0.5
    smap.add_points_from_kf(arr(pos2), 2, m2, pos_np=pos2)
    # erase keyframe 1 (its child 2 is re-parented), then fill and overflow
    lm._erase_keyframe(smap, 1)
    _add_kf(smap, _kf_inputs(rng, 3), 30, 2, port)
    _add_kf(smap, _kf_inputs(rng, 4), 40, 3, port)    # compacts keyframes
    _add_kf(smap, _kf_inputs(rng, 5), 50, 3, port)
    _add_kf(smap, _kf_inputs(rng, 6), 60, 4, port)    # grows the pool
    assert smap.kf_compactions == 1 and smap.cfg.max_keyframes == 2 * K0
    return smap


@pytest.fixture(scope="module")
def maps():
    return _script(port=False), _script(port=True)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b, name):
    a, b = _np(a), _np(b)
    if "desc" in name:
        a, b = a.view(np.uint32), b.view(np.uint32)
    assert a.shape == b.shape, name
    np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("field", jms.MapState._fields)
def test_state_fields_equal(maps, field):
    jm, tm = maps
    _same(getattr(tm.state, field), getattr(jm.state, field), field)


def test_host_counters_equal(maps):
    jm, tm = maps
    assert (tm.n_kf, tm.n_mp) == (jm.n_kf, jm.n_mp)
    assert tm.cfg.max_keyframes == jm.cfg.max_keyframes
    for name in ("parent", "kf_frame_id", "kf_timestamp", "obs_np",
                 "kf_valid_np", "mp_valid_np", "last_compaction_lut",
                 "last_kf_compaction_lut"):
        _same(getattr(tm, name), getattr(jm, name), name)
    assert tm.loop_edges == jm.loop_edges
    for name, a in jm.host.items():
        _same(tm.host[name], a, "host." + name)


def test_port_mirrors_equal_tables(maps):
    _, tm = maps
    _same(tm.state.kf_obs, tm.obs_np, "kf_obs")
    _same(tm.state.kf_valid, tm.kf_valid_np, "kf_valid")
    _same(tm.state.mp_valid, tm.mp_valid_np, "mp_valid")
    for name, a in tm.host.items():
        if name in ("mp_found", "mp_visible"):
            continue     # insert-time snapshots by design
        _same(getattr(tm.state, name), a, name)


def test_derived_structure(maps):
    jm, tm = maps
    P = jm.cfg.max_points
    for k in range(jm.n_kf):
        _same(tms.covisibility_row(tm.state, k, P),
              jms.covisibility_row(jm.state, k, P), f"covis row {k}")
    _same(tms.covisibility_matrix(tm.state, P),
          jms.covisibility_matrix(jm.state, P), "covis matrix")
    _same(tms.point_observation_counts(tm.state),
          jms.point_observation_counts(jm.state), "obs counts")
    _same(tms.point_observation_counts_by_level(tm.state, 4),
          jms.point_observation_counts_by_level(jm.state, 4), "by level")
    W = np.asarray(jms.covisibility_matrix(jm.state, P))
    _same(tms.connected_weights(W, 3), jms.connected_weights(W, 3), "conn")


def test_from_numpy_rebuilds_the_jax_map(maps):
    jm, _ = maps
    counters = {f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)
                if f.name not in ("state", "host")}
    tm = tms.SlamMap.from_numpy(
        {n: np.asarray(getattr(jm.state, n)) for n in jms.MapState._fields},
        jm.host, counters, device="cpu")
    for field in jms.MapState._fields:
        _same(getattr(tm.state, field), getattr(jm.state, field), field)
    for name, a in jm.host.items():
        _same(tm.host[name], a, "host." + name)
    assert (tm.n_kf, tm.n_mp) == (jm.n_kf, jm.n_mp)
    assert tm.cfg.max_keyframes == jm.cfg.max_keyframes
    _same(tm.obs_np, jm.obs_np, "obs_np")
    _same(tm.parent, jm.parent, "parent")
