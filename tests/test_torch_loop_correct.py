"""The loop correction (CorrectLoop) on the CPU: the port's
``LoopCloser._correct``, ``_search_and_fuse``, ``SlamMap.refresh_host``, the
correction's wiring in ``process_keyframe`` and the tracker's re-anchoring,
against the JAX package's, on the scripted revisit map of
tests/test_torch_loop_check.py (``smoke_world.revisit_map``: 14 keyframes,
keyframes 10-13 re-observing scene A of keyframes 0-3 through a drift Sim3
of scale 1.3 and 3.4 degrees; no tracker runs).

The port runs ``process_keyframe`` over the keyframes in order, with
``_compute_sim3`` replaced by one that verifies keyframe 3 for keyframe 13
at the scripted g12 (the drift); the JAX loop closer's ``_correct`` runs
on the same map at that g12, so both correct with the same g12 and the
RANSAC draws do not matter.  The check itself is held against
JAX in tests/test_torch_loop_check.py (JAX's verified g12 is within 0.02%,
0.031 degree and 0.0045 units of the scripted one); running it here too
cost this file ~60 s of JAX compiles under the suite's parallel load.  The configuration lowers
``covisibility_weight_strong`` from 100 to 40, so that the essential graph
holds every kind of edge: spanning tree, strong covisibility, the
LoopConnections the fusion makes (7 here) and the loop edge; at 100 this
map has only the tree and the loop edge.

Tolerances, and the gaps measured on this CPU:
  - the edge list (i, j), the LoopConnections, kf_obs, mp_valid, every
    mirror of the observation and validity tables and loop_edges: exactly
    equal;
  - the propagated poses that seed the graph: SEED_TOL 1e-6 (measured 0 in
    s, 6.0e-8 in R, 1.2e-7 in t); the edge measurements the same (0,
    1.2e-7, 2.4e-7);
  - the corrected keyframe poses, compared directly (the loop keyframe is
    fixed, so the graph has no gauge freedom): R_TOL 5e-6 (measured
    6.0e-7) and T_TOL 1e-5 (measured 1.1e-6); the 20 float32 Gauss-Newton
    steps of each package round differently;
  - the essential graph sharded in two (mesh.model_parallel = 2) against
    the single-device graph: MP_TOL 1e-6 (measured 6.0e-8 in s and R,
    2.4e-7 in t);
  - every valid landmark's position: POS_TOL 5e-5 (measured 3.8e-6, on
    positions up to 11.2 units);
  - against the truth, keyframes 10-13: camera centres 0.59-0.79 units off
    before the correction, at most CENTRE_AFTER 0.06 after (measured
    0.007-0.037); keyframe 13's rotation error 3.44 degrees before, below
    ROT13_AFTER 0.5 degree after (measured 0.24).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import orb_slam_tpu.config as jc
import orb_slam_tpu_torch.config as tc
import smoke_world as sw
from orb_slam_tpu.geometry import se3 as jse3
from orb_slam_tpu.geometry.camera import make_camera as jcam
from orb_slam_tpu.mapping import mapstore as jms
from orb_slam_tpu.pipeline.loop_closer import LoopCloser as JLoopCloser
from orb_slam_tpu.solvers import pose_graph as jpg
from orb_slam_tpu_torch.frontend.extractor import FrameFeatures
from orb_slam_tpu_torch.geometry.camera import make_camera as tcam
from orb_slam_tpu_torch.mapping import mapstore as tms
from orb_slam_tpu_torch.pipeline import frame as tframe
from orb_slam_tpu_torch.pipeline import loop_closer as tlc_mod
from orb_slam_tpu_torch.pipeline.async_mapper import MappingResult
from orb_slam_tpu_torch.pipeline.local_mapper import LocalMapper
from orb_slam_tpu_torch.pipeline.tracker import Tracker
from orb_slam_tpu_torch.solvers import pose_graph as tpg
from torch_port_util import np_of

N, N_A, N_B = 192, 96, 150
Q, MATCH = sw.REVISIT_QUERY, sw.REVISIT_MATCH
STRONG = 40
SEED_TOL = 1e-6
R_TOL = 5e-6
T_TOL = 1e-5
POS_TOL = 5e-5
MP_TOL = 1e-6
CENTRE_AFTER = 0.06
ROT13_AFTER = 0.5
CAM = dict(fx=500, fy=500, cx=320, cy=240, k1=0, k2=0, p1=0, p2=0, k3=0,
           width=640, height=480)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small problems: torch's intra-op threads only add overhead under
    the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(cfgm, **mesh):
    cfg = cfgm.SystemConfig(
        camera=cfgm.CameraConfig(**CAM),
        extractor=cfgm.ExtractorConfig(max_keypoints=N),
        map=cfgm.MapConfig(max_keyframes=16, max_points=1024,
                           local_ba_max_points=128))
    cfg = cfg.replace(loop=dataclasses.replace(
        cfg.loop, covisibility_weight_strong=STRONG))
    if mesh:
        cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, **mesh))
    return cfg


@pytest.fixture(scope="module")
def world():
    return sw.revisit_map(np.random.default_rng(5), N, N_A, N_B,
                          _cfg(tc).camera.K)


def _add_keyframe(smap, world, k, port, row=None):
    a = world["kfs"][k if row is None else row]
    desc = a["desc"].view(np.int32) if port else a["desc"]
    return smap.add_keyframe(a["R"], a["t"], a["xy"], a["level"], a["angle"],
                             desc, a["kp_valid"], a["obs"], k, k / 30.0,
                             parent=k - 1)


def _empty_map(world, port):
    cfg = _cfg(tc if port else jc)
    smap = (tms.SlamMap.create(cfg.map, N, device="cpu") if port
            else jms.SlamMap.create(cfg.map, N))
    p = world["points"]
    m = len(p["pos"])
    smap.add_points(p["pos"], p["desc"].view(np.int32) if port else p["desc"],
                    np.zeros((m, 3), np.float32), np.zeros(m, np.float32),
                    np.full(m, np.inf, np.float32), 0, np.ones(m, bool))
    return smap


def _full_map(world, port):
    smap = _empty_map(world, port)
    for k in range(len(world["kfs"])):
        _add_keyframe(smap, world, k, port)
    return smap


def _loop_closer(port, **mesh):
    cfg = _cfg(tc if port else jc, **mesh)
    if port:
        return tlc_mod.LoopCloser(cfg=cfg, cam=tcam(cfg.camera, device="cpu"))
    return JLoopCloser(cfg=cfg, cam=jcam(cfg.camera))


def _numpy_map(smap):
    """A SlamMap of either package as (arrays, host, counters) numpy."""
    arrays = {n: np.array(np_of(getattr(smap.state, n)))
              for n in tms.MapState._fields}
    host = {n: np.array(v) for n, v in smap.host.items()}
    counters = {f.name: getattr(smap, f.name)
                for f in dataclasses.fields(smap)
                if f.name not in ("state", "host", "cfg")}
    counters = {k: (np.array(v) if isinstance(v, np.ndarray) else
                    list(v) if isinstance(v, list) else v)
                for k, v in counters.items()}
    return arrays, host, counters


def _run(world, port):
    """The port: process_keyframe over keyframes 0-13, then keyframe 14 (a
    copy of 13's row, one keyframe after the loop), with the check
    returning the scripted g12 for keyframe 3.  The JAX package: _correct
    of keyframe 13 against keyframe 3 at that g12 on the same 14-keyframe
    map (its process_keyframe reaches the same call; its detection is
    held against the port's in tests/test_torch_loop_check.py).  Records
    the g12 each correction used, the map before and after the loop
    fusion, the graph the optimizer got and its seed, and the check's
    calls."""
    smap = _empty_map(world, port)
    lc = _loop_closer(port)
    rec = dict(checks=[], fuse=[])
    pg = tpg if port else jpg
    solve, fuse, correct = (pg.optimize_essential_graph,
                            lc._search_and_fuse, lc._correct)

    def rec_solve(s, R, t, fixed, edges, **kw):
        rec["seed"] = tuple(np.array(np_of(x)) for x in (s, R, t))
        rec["edges"] = edges
        rec["fixed"] = np.array(np_of(fixed))
        return solve(s, R, t, fixed, edges, **kw)

    def rec_fuse(smap_, kf, loop_kf):
        rec["fuse"].append((kf, loop_kf, _numpy_map(smap_)))
        fuse(smap_, kf, loop_kf)
        rec["after_fuse"] = (smap_.obs_np.copy(), smap_.mp_valid_np.copy(),
                             np.array(np_of(smap_.state.kf_obs)),
                             np.array(np_of(smap_.state.mp_valid)))

    def rec_correct(smap_, kf, loop_kf, g):
        rec["g12"] = tuple(np.array(np_of(x)) for x in g)
        rec["before"] = _numpy_map(smap_)
        correct(smap_, kf, loop_kf, g)

    conv = ((lambda x: torch.from_numpy(np.array(x))) if port
            else (lambda x: jnp.asarray(x)))

    def scripted_check(smap_, kf, cands):
        rec["checks"].append((kf, [int(c) for c in cands]))
        if MATCH in cands:
            return MATCH, tuple(conv(x) for x in world["g12"])
        return None

    lc._compute_sim3 = scripted_check
    lc._search_and_fuse, lc._correct = rec_fuse, rec_correct
    metrics = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pg, "optimize_essential_graph", rec_solve)
        if not port:
            for k in range(len(world["kfs"])):
                _add_keyframe(smap, world, k, port)
            lc._correct(smap, Q, MATCH, scripted_check(smap, Q, [MATCH])[1])
            return dict(smap=smap, lc=lc, metrics=metrics, **rec)
        lc.ensure_vocabulary(None)
        for k in range(len(world["kfs"])):
            _add_keyframe(smap, world, k, port)
            metrics.append(lc.process_keyframe(smap, k))
        _add_keyframe(smap, world, Q + 1, port, row=Q)
        metrics.append(lc.process_keyframe(smap, Q + 1))
    return dict(smap=smap, lc=lc, metrics=metrics, **rec)


@pytest.fixture(scope="module")
def runs(world):
    return dict(jax=_run(world, False), port=_run(world, True))


def _gap(a, b):
    return float(np.abs(np.asarray(np_of(a), np.float64)
                        - np.asarray(np_of(b), np.float64)).max())


def _edge_pairs(edges):
    return list(zip(np_of(edges.i).tolist(), np_of(edges.j).tolist()))


def test_correct_against_jax(runs):
    """The whole correction of keyframe 13 against keyframe 3 with JAX's
    g12: the same propagated seed and edge measurements within SEED_TOL,
    the same edge list (LoopConnections included) and fixed vertex, then
    the corrected poses within R_TOL / T_TOL, every valid landmark within
    POS_TOL, and kf_obs, mp_valid, their mirrors and loop_edges exactly
    equal."""
    j, t = runs["jax"], runs["port"]
    for a, b in zip(t["seed"], j["seed"]):
        assert _gap(a, b) <= SEED_TOL
    assert _edge_pairs(t["edges"]) == _edge_pairs(j["edges"])
    for name in ("s_meas", "R_meas", "t_meas"):
        assert _gap(getattr(t["edges"], name),
                    getattr(j["edges"], name)) <= SEED_TOL, name
    np.testing.assert_array_equal(t["fixed"], np.arange(Q + 1) == MATCH)
    np.testing.assert_array_equal(t["fixed"], j["fixed"])

    jm, tm = j["smap"], t["smap"]
    n = Q + 1
    assert _gap(tm.state.kf_R[:n], jm.state.kf_R[:n]) <= R_TOL
    assert _gap(tm.state.kf_t[:n], jm.state.kf_t[:n]) <= T_TOL
    valid = np_of(jm.state.mp_valid)
    np.testing.assert_array_equal(np_of(tm.state.mp_valid), valid)
    assert _gap(np_of(tm.state.mp_pos)[valid],
                np_of(jm.state.mp_pos)[valid]) <= POS_TOL
    # the port's map holds keyframe 14 too, added after the correction
    np.testing.assert_array_equal(np_of(tm.state.kf_obs)[:n],
                                  np_of(jm.state.kf_obs)[:n])
    np.testing.assert_array_equal(tm.obs_np[:n], jm.obs_np[:n])
    np.testing.assert_array_equal(tm.mp_valid_np, jm.mp_valid_np)
    assert tm.loop_edges == jm.loop_edges == [(Q, MATCH)]


def test_loop_connections(runs):
    """The LoopConnections: the port's set is the JAX graph's edges after
    the sorted tree / strong-covisibility / old-loop block and before the
    loop edge; each links a member of keyframe 13's group to a keyframe
    outside it, at covisibility_weight_strong or above."""
    j, t = runs["jax"], runs["port"]
    lc = t["lc"]
    arrays, host, counters = t["fuse"][0][2]
    before = tms.SlamMap.from_numpy(arrays, host, {**counters,
                                                   "cfg": lc.cfg.map},
                                    device="cpu")
    n = Q + 1
    covis = lc._covis_np(before)[:n, :n]
    group = [Q] + [int(g) for g in np.where(covis[Q] > 0)[0] if g != Q]
    conn = lc._loop_connections(t["smap"], covis, group)
    edges = _edge_pairs(j["edges"])
    assert edges[-1] == (Q, MATCH)
    assert edges[-1 - len(conn):-1] == sorted(conn)
    assert len(conn) == 7
    after = lc._covis_np(t["smap"])
    for a, b in conn:
        assert a in group and b not in group and covis[a, b] == 0
        assert after[a, b] >= STRONG


def test_search_and_fuse_alone(runs):
    """_search_and_fuse alone, on the JAX map as it stood after the
    propagation (carried over by SlamMap.from_numpy): the port's
    observation table and validity mask, tables and mirrors, exactly equal
    to JAX's after its own fusion."""
    j = runs["jax"]
    kf, loop_kf, (arrays, host, counters) = j["fuse"][0]
    assert (kf, loop_kf) == (Q, MATCH)
    smap = tms.SlamMap.from_numpy(arrays, host, counters, device="cpu")
    _loop_closer(True)._search_and_fuse(smap, kf, loop_kf)
    obs, valid, obs_t, valid_t = j["after_fuse"]
    assert (obs != counters["obs_np"]).any()      # the fusion merged
    np.testing.assert_array_equal(smap.obs_np, obs)
    np.testing.assert_array_equal(smap.mp_valid_np, valid)
    np.testing.assert_array_equal(np_of(smap.state.kf_obs), obs_t)
    np.testing.assert_array_equal(np_of(smap.state.mp_valid), valid_t)


def _pose_error(R, t, true):
    """(rotation error in degrees, camera centre error) of a world->camera
    pose against the true one."""
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    Rt, tt = true
    cos = (np.trace(R @ Rt.T) - 1) / 2
    return (float(np.degrees(np.arccos(np.clip(cos, -1, 1)))),
            float(np.linalg.norm(R.T @ t - Rt.T @ tt)))


def test_revisit_moves_toward_the_truth(runs, world):
    """Keyframes 10-13 leave the drift: their camera centres come within
    CENTRE_AFTER of the truth, and keyframe 13's rotation within
    ROT13_AFTER degree; the loop keyframe 3 stays where it was."""
    before = runs["port"]["before"][1]
    st = runs["port"]["smap"].state
    for k in range(10, Q + 1):
        rot0, c0 = _pose_error(before["kf_R"][k], before["kf_t"][k],
                               world["true"][k])
        rot1, c1 = _pose_error(np_of(st.kf_R[k]), np_of(st.kf_t[k]),
                               world["true"][k])
        assert rot0 > 3.4 and c0 > 0.5
        assert c1 < CENTRE_AFTER, (k, c1)
        if k == Q:
            assert rot1 < ROT13_AFTER, rot1
    assert _gap(st.kf_R[MATCH], before["kf_R"][MATCH]) == 0
    assert _gap(st.kf_t[MATCH], before["kf_t"][MATCH]) == 0


def test_process_keyframe_closes_the_loop(runs):
    """The port's process_keyframe: the check runs at every keyframe with
    consistent candidates, loop_with and loop_closed come at keyframe 13
    only, last_loop_kf is 13 and one loop is closed; keyframe 14, one
    after the loop, is not checked again (no detection, no check)."""
    r = runs["port"]
    m = r["metrics"]
    assert [k for k, x in enumerate(m) if x.get("loop_closed")] == [Q]
    assert m[Q]["loop_with"] == MATCH
    assert [k for k, _ in r["checks"]] == [
        k for k, x in enumerate(m) if x.get("loop_candidates")]
    assert r["checks"][-1][0] == Q and MATCH in r["checks"][-1][1]
    assert "loop_candidates" not in m[Q + 1]
    assert r["lc"].last_loop_kf == Q and r["lc"].n_loops_closed == 1


def test_model_parallel_rule(runs, monkeypatch):
    """mesh.model_parallel = 2: with fewer devices than shards (a map on
    the CPU counts one device, as JAX's default CPU backend has one) the
    graph is solved on one device, as the JAX loop closer does, to the
    same poses; with as many devices as shards (two declared virtual CPU
    devices) it is solved keyframe-block sharded over the model axis
    (parallel/dist_pose_graph.py; the cut to E // 512 shards is lowered so
    that this small graph splits in two), to the single-device poses within
    MP_TOL (measured: 6.0e-8 in s and R, 2.4e-7 in t)."""
    from orb_slam_tpu_torch.parallel import dist_pose_graph as tdpg
    from orb_slam_tpu_torch.parallel import hostmesh
    t = runs["port"]
    seed = tuple(torch.from_numpy(x) for x in t["seed"])
    lc1, lc2 = _loop_closer(True), _loop_closer(True, model_parallel=2)
    for lc in (lc1, lc2):       # two iterations suffice here
        lc.cfg = lc.cfg.replace(solver=dataclasses.replace(
            lc.cfg.solver, essential_graph_iters=2))
    one = lc1._solve_graph(seed, t["edges"], MATCH)
    two = lc2._solve_graph(seed, t["edges"], MATCH)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    meshes = []
    orig = tdpg.optimize_essential_graph_sharded

    def spy(mesh, *a, **kw):
        meshes.append((mesh.size, kw["axis"]))
        return orig(mesh, *a, **kw)

    monkeypatch.setattr(tdpg, "optimize_essential_graph_sharded", spy)
    monkeypatch.setattr(tdpg, "MIN_EDGES_PER_SHARD", 1)
    with hostmesh.virtual_devices("cpu", 2):
        sharded = lc2._solve_graph(seed, t["edges"], MATCH)
    assert meshes == [(2, "model")]
    for a, b in zip(sharded, one):
        assert _gap(a, b) <= MP_TOL


def test_refresh_host(world):
    """refresh_host re-reads the named mirrors only, all of them with no
    name; each mirror equals its table, stays writable and shares no
    memory with it; a name without a mirror raises."""
    smap = _full_map(world, True)
    st = smap.state
    st.kf_t.add_(1.0)
    st.mp_pos.mul_(2.0)
    st.mp_found.add_(3)
    smap.refresh_host("kf_t")
    np.testing.assert_array_equal(smap.host["kf_t"], np_of(st.kf_t))
    assert not np.array_equal(smap.host["mp_pos"], np_of(st.mp_pos))
    smap.refresh_host()
    for name in tms._HOST:
        table = np_of(getattr(st, name))
        np.testing.assert_array_equal(smap.host[name], table)
        assert smap.host[name].dtype == table.dtype
        assert smap.host[name].flags.writeable
        assert not np.shares_memory(smap.host[name], table)
    with pytest.raises(KeyError):
        smap.refresh_host("kf_obs")


def _tracker(world, async_mapping):
    cfg = _cfg(tc)
    cfg = cfg.replace(tracker=dataclasses.replace(
        cfg.tracker, async_mapping=async_mapping, frame_batch=1))
    tr = Tracker.create(cfg, device="cpu")
    tr.slam_map = _full_map(world, True)
    return tr


def test_commit_reanchors_after_a_loop(runs, world):
    """_commit_mapping of a hand-built MappingResult that closed a loop at
    keyframe 13: the last pose carries keyframe 13's world correction,
    G^-1 = Twc_old o Tcw_new, with the old pose from the tracker's map and
    the new from the result's (JAX's formula, tracker.py:306-320, computed
    here with the JAX package's orthonormalize), the motion model is reset
    and the landmark statistics are refreshed on the adopted map."""
    tr = _tracker(world, async_mapping=True)
    try:
        new = runs["port"]["smap"]
        arrays, host, counters = _numpy_map(new)
        new = tms.SlamMap.from_numpy(arrays, host,
                                     {**counters, "cfg": new.cfg},
                                     device="cpu")
        # the result's map was built with one keyframe more (14)
        tr.slam_map = _full_map(world, True)
        _add_keyframe(tr.slam_map, world, Q + 1, True, row=Q)
        rng = np.random.default_rng(3)
        R_last = sw.rotmat(rng.normal(size=3), 0.4).astype(np.float32)
        t_last = rng.normal(size=3).astype(np.float32)
        tr.last_R, tr.last_t = R_last.copy(), t_last.copy()
        tr.vel_R, tr.vel_t = np.eye(3, dtype=np.float32), np.ones(3,
                                                                  np.float32)
        R_old = tr.slam_map.host["kf_R"][Q].astype(np.float32)
        t_old = tr.slam_map.host["kf_t"][Q].astype(np.float32)
        st = new.state
        res = MappingResult(
            smap=new, kf=Q, metrics={"loop_with": MATCH,
                                     "loop_closed": True},
            snap_visible=st.mp_visible.clone(),
            snap_found=st.mp_found.clone(), remap_lut=None, culled_kfs=[])
        metrics = {}
        tr._commit_mapping(res, metrics)
    finally:
        tr.shutdown()
    R_new, t_new = new.host["kf_R"][Q], new.host["kf_t"][Q]
    R_g = R_old.T @ R_new
    t_g = R_old.T @ (t_new - t_old)
    want_R = np.asarray(jse3.orthonormalize(jnp.asarray(R_last @ R_g)))
    want_t = R_last @ t_g + t_last
    assert _gap(tr.last_R, want_R) <= 1e-6
    assert _gap(tr.last_t, want_t) <= 1e-6
    assert _gap(want_t, t_last) > 0.1
    assert tr.vel_R is None and tr.vel_t is None
    assert metrics["mapping"]["loop_closed"]
    ref = tms.SlamMap.from_numpy(*_numpy_map(new)[:2],
                                 {**_numpy_map(new)[2], "cfg": new.cfg},
                                 device="cpu")
    LocalMapper(cfg=tr.cfg, cam=tr.cam).refresh_point_stats(ref)
    for name in ("mp_normal", "mp_min_dist", "mp_max_dist"):
        assert torch.equal(getattr(tr.slam_map.state, name),
                           getattr(ref.state, name)), name


def test_synchronous_path_after_a_loop(world, monkeypatch):
    """The synchronous keyframe path: when the loop closer reports a closed
    loop, the tracker refreshes the landmark statistics and resets the
    motion model (tracker.py:1605-1611 of the JAX package); without one
    it keeps the motion model."""
    for closed in (True, False):
        tr = _tracker(world, async_mapping=False)
        smap = tr.slam_map
        calls = []
        monkeypatch.setattr(tr.local_mapper, "process_keyframe",
                            lambda smap_, kf: {})
        monkeypatch.setattr(tr.local_mapper, "refresh_point_stats",
                            lambda smap_: calls.append(smap_))
        monkeypatch.setattr(tr.loop_closer, "voc", object())
        monkeypatch.setattr(tr.loop_closer, "db", None)
        monkeypatch.setattr(tr.loop_closer, "process_keyframe",
                            lambda smap_, kf: ({"loop_closed": True}
                                               if closed else {}))
        a = world["kfs"][Q]
        fd = tframe.FrameData(
            feats=FrameFeatures(
                xy=torch.from_numpy(a["xy"]),
                response=torch.zeros(N),
                angle=torch.from_numpy(a["angle"]),
                level=torch.from_numpy(a["level"]),
                desc=torch.from_numpy(a["desc"].view(np.int32)),
                valid=torch.from_numpy(a["kp_valid"])),
            xy_und=torch.from_numpy(a["xy"]),
            inv_sigma2=torch.ones(N), sigma2=torch.ones(N))
        tr.last_R, tr.last_t = a["R"].copy(), a["t"].copy()
        tr.vel_R, tr.vel_t = np.eye(3, dtype=np.float32), np.zeros(
            3, np.float32)
        metrics = {}
        tr._create_keyframe(fd, 1.0, a["obs"], metrics, frame_id=20)
        assert metrics.get("loop_closed", False) == closed
        assert (tr.vel_R is None) == closed
        assert calls == ([smap] if closed else [])
