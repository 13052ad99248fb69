"""The loop closer's geometric check (ComputeSim3) on the CPU: the port's
``LoopCloser._compute_sim3``, ``_count_guided_matches`` and the check's
wiring in ``process_keyframe`` against the JAX package's, on one scripted
revisit map (``smoke_world.revisit_map``: 14 keyframes of 192 slots, ~500
points, written into each package's SlamMap with ``add_points`` and
``add_keyframe``; no tracker runs).  The port's RANSAC draws are the JAX
loop closer's: its key chain (PRNGKey(7), split once per candidate that
reaches RANSAC) is replayed through the port's ``sim3_sampler`` hook.

Candidates: keyframe 3, which keyframe 13 re-observes through a drift Sim3
(scale 1.3), and one decoy per gate: 4 (too few descriptor matches), 5
(RANSAC finds no Sim3), 6 (RANSAC accepts 22 pairs, the refinement keeps
19 < min_sim3_inliers) and 7 (28 exact pairs, fewer guided matches than
min_total_matches).

Tolerances, and the gaps measured on this CPU:
  - gate outcomes, RANSAC's ok, every inlier mask and count, the guided
    match count, the budgets and the accepted candidate: exactly equal;
  - s / R / t of every accepted RANSAC result, and R / t of the refinement
    of the candidates that pass it: FIT_TOL 1e-5 absolute, as
    tests/test_torch_sim3.py (measured <= 2.8e-7 on R, <= 2.0e-6 on t,
    <= 1.2e-7 on RANSAC's s; the pairs are float32 products of each
    package's own gather and transform, an ulp apart);
  - the refined scale of those candidates: REFINED_SCALE_TOL 5e-5
    (measured 7.7e-6 on the verified candidate, 7.7e-7 on the guided
    decoy).  Scale is the refinement's flattest direction: on identical
    inputs the port accepts a second Gauss-Newton step on the guided decoy
    that JAX's float32 cost test rejects, 1.6e-6 apart in s, while the
    float64 refinement moves 1.4e-7;
  - the refine decoy's refined pose is not compared, only its mask and
    count: its pairs are inconsistent by construction and its refinement
    walks a flat valley (s moves by 0.01 between steps, and float32 ends
    2.0e-4 from float64 on the same inputs); the two packages end 1.7e-4
    apart in s;
  - the accepted g12 against the scripted drift: scale within 1%, rotation
    within 0.5 degree, translation within 0.03 units (measured 0.020%,
    0.031 degree, 0.0045 units; 0.3 px pixel noise on 36 inliers).
"""
import contextlib

import numpy as np
import pytest
import torch

import jax

import orb_slam_tpu.config as jc
import orb_slam_tpu_torch.config as tc
import smoke_world as sw
from orb_slam_tpu.geometry.camera import make_camera as jcam
from orb_slam_tpu.mapping import mapstore as jms
from orb_slam_tpu.pipeline.loop_closer import LoopCloser as JLoopCloser
from orb_slam_tpu.solvers import sim3_opt as jopt
from orb_slam_tpu.solvers import sim3_solver as jsolver
from orb_slam_tpu_torch.geometry.camera import make_camera as tcam
from orb_slam_tpu_torch.mapping import mapstore as tms
from orb_slam_tpu_torch.pipeline import loop_closer as tlc_mod
from orb_slam_tpu_torch.solvers import sim3_opt as topt
from orb_slam_tpu_torch.solvers import sim3_solver as tsolver
from torch_port_util import jax_draws, np_of

N, N_A, N_B = 192, 96, 150
Q, MATCH = sw.REVISIT_QUERY, sw.REVISIT_MATCH
GATES = dict(matches=[], ransac=["ransac"], refine=["ransac", "refine"],
             guided=["ransac", "refine", "guided"],
             verified=["ransac", "refine", "guided"])
CANDS = {**sw.REVISIT_DECOYS, "verified": MATCH}
ORDER = ["matches", "ransac", "refine", "guided", "verified"]
FIT_TOL = 1e-5
REFINED_SCALE_TOL = 5e-5
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


CAP = 128       # local_ba_max_points: cuts the decoys' neighbourhoods


def _cfg(cfgm, local_ba_max_points=CAP):
    return cfgm.SystemConfig(
        camera=cfgm.CameraConfig(**CAM),
        extractor=cfgm.ExtractorConfig(max_keypoints=N),
        map=cfgm.MapConfig(max_keyframes=16, max_points=1024,
                           local_ba_max_points=local_ba_max_points))


@pytest.fixture(scope="module")
def world():
    return sw.revisit_map(np.random.default_rng(5), N, N_A, N_B,
                          _cfg(tc).camera.K)


def _keyframes(world, port: bool):
    """The scripted map in one package, yielded after each keyframe's
    insertion as (smap, keyframe id); every point exists from the start."""
    cfg = _cfg(tc if port else jc)
    smap = (tms.SlamMap.create(cfg.map, N, device="cpu") if port
            else jms.SlamMap.create(cfg.map, N))
    p = world["points"]
    m = len(p["pos"])
    smap.add_points(p["pos"], p["desc"].view(np.int32) if port else p["desc"],
                    np.zeros((m, 3), np.float32), np.zeros(m, np.float32),
                    np.full(m, np.inf, np.float32), 0, np.ones(m, bool))
    for k, a in enumerate(world["kfs"]):
        desc = a["desc"].view(np.int32) if port else a["desc"]
        smap.add_keyframe(a["R"], a["t"], a["xy"], a["level"], a["angle"],
                          desc, a["kp_valid"], a["obs"], k, k / 30.0,
                          parent=k - 1)
        yield smap, k


def _full_map(world, port):
    for smap, _ in _keyframes(world, port):
        pass
    return smap


def _loop_closer(port: bool, **cfg_kw):
    cfgm = tc if port else jc
    cfg = _cfg(cfgm, **cfg_kw)
    if port:
        return tlc_mod.LoopCloser(cfg=cfg, cam=tcam(cfg.camera, device="cpu"))
    return JLoopCloser(cfg=cfg, cam=jcam(cfg.camera))


def _jax_key_chain():
    """The port's sim3_sampler replaying a fresh JAX loop closer's key
    chain; returns (sampler, state) with state["key"] the chain's head and
    state["n_samples"] each call's budget."""
    state = {"key": jax.random.PRNGKey(7), "n_samples": []}

    def sampler(valid, n_samples):
        state["key"], sub = jax.random.split(state["key"])
        state["n_samples"].append(n_samples)
        return jax_draws(sub, valid, n_samples)

    return sampler, state


@contextlib.contextmanager
def _recorded(port: bool, lc, log):
    """Record every RANSAC, refinement and guided count the check makes,
    in order, as (stage, result) in `log`."""
    solver, opt = (tsolver, topt) if port else (jsolver, jopt)
    ransac, refine = solver.sim3_ransac, opt.optimize_sim3
    guided = lc._count_guided_matches

    def rec_ransac(*a, **kw):
        res = ransac(*a, **kw)
        n = kw.get("n_samples") if not port else len(kw["samples"])
        log.append(("ransac", res, n))
        return res

    def rec_refine(*a, **kw):
        res = refine(*a, **kw)
        log.append(("refine", res, None))
        return res

    def rec_guided(*a):
        n = guided(*a)
        log.append(("guided", n, None))
        return n

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(solver, "sim3_ransac", rec_ransac)
        mp.setattr(opt, "optimize_sim3", rec_refine)
        mp.setattr(lc, "_count_guided_matches", rec_guided)
        yield


@pytest.fixture(scope="module")
def checks(world):
    """_compute_sim3 of keyframe 13 in both packages: each candidate alone
    (its gate log), then the whole list in ORDER (the returned hit)."""
    out = {}
    for port in (False, True):
        smap = _full_map(world, port)
        lc = _loop_closer(port)
        if port:
            lc.sim3_sampler, chain = _jax_key_chain()
        logs, hits = {}, {}
        for name in ORDER:
            logs[name] = []
            with _recorded(port, lc, logs[name]):
                hits[name] = lc._compute_sim3(smap, Q, [CANDS[name]])
        hit = lc._compute_sim3(smap, Q, [CANDS[n] for n in ORDER])
        out["port" if port else "jax"] = dict(
            smap=smap, lc=lc, logs=logs, hits=hits, hit=hit,
            chain=chain if port else None)
    return out


def _close(a, b, what, tol=FIT_TOL):
    gap = np.abs(np_of(a).astype(np.float64)
                 - np_of(b).astype(np.float64)).max()
    assert gap <= tol, f"{what}: port vs JAX {gap:.2e} > {tol}"


def _same_pose(t, j, what, s_tol=FIT_TOL):
    _close(t.s, j.s, f"{what} s", s_tol)
    _close(t.R, j.R, f"{what} R")
    _close(t.t, j.t, f"{what} t")


@pytest.mark.parametrize("name", ORDER)
def test_each_gate_against_jax(checks, name):
    """Each candidate alone: both packages stop at the same gate, with the
    same RANSAC ok, inlier masks and counts, the same refined inliers and
    guided match count, s / R / t within FIT_TOL (the refined scale within
    REFINED_SCALE_TOL; the refine decoy's refined pose is not compared),
    and accept only the verified candidate."""
    lj, lt = checks["jax"]["logs"][name], checks["port"]["logs"][name]
    assert [s for s, _, _ in lt] == [s for s, _, _ in lj] == GATES[name]
    for (stage, rt, nt), (_, rj, nj) in zip(lt, lj):
        if stage == "guided":
            assert rt == rj
            continue
        if stage == "ransac":
            assert nt == nj
            assert bool(rt.ok) == bool(rj.ok) == (name != "ransac")
        np.testing.assert_array_equal(np_of(rt.inliers), np_of(rj.inliers))
        assert int(rt.n_inliers) == int(rj.n_inliers)
        if (stage == "refine" and name != "refine") or (
                stage == "ransac" and bool(rj.ok)):
            _same_pose(rt, rj, f"{name} {stage}", s_tol=(
                REFINED_SCALE_TOL if stage == "refine" else FIT_TOL))
    if name == "refine":
        assert int(lt[0][1].n_inliers) >= 20 > int(lt[1][1].n_inliers)
    if name == "guided":
        assert 20 <= lt[-1][1] < 40
    ht, hj = checks["port"]["hits"][name], checks["jax"]["hits"][name]
    assert (ht is None) == (hj is None) == (name != "verified")


def test_check_returns_the_verified_candidate(checks, world):
    """The whole list, decoys first: both return keyframe 3 with the same
    g12 (R, t within FIT_TOL, s within REFINED_SCALE_TOL), near the
    scripted drift; the replayed key chain
    ends where the JAX loop closer's does (one split per candidate that
    reached RANSAC)."""
    ht, hj = checks["port"]["hit"], checks["jax"]["hit"]
    assert ht[0] == hj[0] == MATCH
    for a, b, what in zip(ht[1], hj[1], "sRt"):
        _close(a, b, f"g12 {what}",
               REFINED_SCALE_TOL if what == "s" else FIT_TOL)
    s, R, t = (np_of(x).astype(np.float64) for x in ht[1])
    s0, R0, t0 = world["g12"]
    assert abs(s / s0 - 1) < 0.01
    ang = np.degrees(np.arccos(np.clip((np.trace(R @ R0.T) - 1) / 2, -1, 1)))
    assert ang < 0.5
    assert np.linalg.norm(t - t0) < 0.03
    np.testing.assert_array_equal(np.asarray(checks["port"]["chain"]["key"]),
                                  np.asarray(checks["jax"]["lc"].rng_key))


def test_ransac_budget_is_rounded_up(checks):
    """The budget the port asks its sampler for is the adaptive count
    rounded up to a power of two, as the JAX loop closer's
    (pipeline/loop_closer.py:284): the verified pair set's count is not a
    power of two before the rounding, the decoys' sit at the floor of 32;
    and the JAX package's RANSAC ran the same budgets."""
    scfg = tc.SolverConfig()
    port = checks["port"]
    names = [n for n in ORDER if GATES[n]]
    n_pairs = [int(port["lc"]._loop_pairs(port["smap"], Q, CANDS[n])
                   .valid_np.sum()) for n in names]
    eps = scfg.sim3_min_inliers / n_pairs[-1]
    raw = int(np.ceil(np.log(1 - scfg.sim3_prob) / np.log(1 - eps ** 3)))
    assert raw & (raw - 1) and 32 < raw < scfg.sim3_max_iters
    want = [tlc_mod.ransac_budget(scfg, n) for n in n_pairs]
    assert want == [32, 32, 32, 1 << raw.bit_length()]
    # each candidate alone, then the whole list
    assert port["chain"]["n_samples"] == want + want
    assert [checks["jax"]["logs"][n][0][2] for n in names] == want


@pytest.mark.parametrize("case", ["truth", "rolled", "capped"])
def test_guided_count_alone(world, case):
    """_count_guided_matches of keyframe 13 at a given g12, in both
    packages: the same count.  Cases: candidate 3 at the scripted drift
    (all 63 pairs); the drift rolled by 4 degrees about the optical axis
    (projections moved by 7% of their distance from the image centre, 2 of
    63 out of the 12 px window); and the guided decoy 7 at its scripted
    Sim3, whose neighbourhood (7 and its 5 chain neighbours) is cut to its
    first local_ba_max_points ids, which keep the decoy's 28 landmarks."""
    cand, (s, R, t) = ((sw.REVISIT_DECOYS["guided"], world["guided_g12"])
                       if case == "capped" else (MATCH, world["g12"]))
    if case == "rolled":
        R = sw.rotmat([0, 0, 1], np.radians(4.0)) @ R
    counts = []
    for port in (False, True):
        smap = _full_map(world, port)
        lc = _loop_closer(port)
        conv = ((lambda x: torch.from_numpy(np.asarray(x, np.float32)))
                if port else (lambda x: jax.numpy.asarray(x, np.float32)))
        counts.append(lc._count_guided_matches(
            smap, Q, cand, (conv(s), conv(R), conv(t))))
    assert counts[0] == counts[1]
    assert isinstance(counts[1], int)
    if case == "truth":
        assert counts[1] == world["pairs"]
    elif case == "rolled":
        assert 0 < counts[1] < world["pairs"]
    else:
        w = lc._covis_np(smap)[cand]
        group = [cand] + [int(k) for k in np.argsort(-w)[:5] if w[k] > 0]
        obs = smap.obs_np[group]
        assert len(np.unique(obs[obs >= 0])) > CAP
        assert counts[1] == 28


def test_process_keyframe_reports_the_verified_loop(world):
    """process_keyframe over the keyframes in order: the port reports
    loop_with at the keyframe and candidate where the JAX loop closer's
    _detect + _compute_sim3, run by hand in its process_keyframe's order,
    first verify a loop, with the same loop_candidates at every keyframe;
    and it closes that loop (loop_closed there only, last_loop_kf and
    n_loops_closed set; the correction itself is held against JAX in
    tests/test_torch_loop_correct.py)."""
    jlc = _loop_closer(False)
    jlc.ensure_vocabulary(None)
    jfirst, jcands = None, []
    for smap, k in _keyframes(world, False):
        jlc.add_keyframe(smap, k)
        if k - jlc.last_loop_kf < jlc.cfg.loop.min_kfs_between_loops \
                or smap.n_kf < jlc.cfg.loop.min_kfs_between_loops:
            jcands.append(None)
            continue
        cand = jlc._detect(smap, k)
        jcands.append(len(cand))
        if len(cand) and jfirst is None:
            hit = jlc._compute_sim3(smap, k, cand)
            if hit is not None:
                jfirst = (k, hit[0])

    tlc = _loop_closer(True)
    tlc.ensure_vocabulary(None)
    tlc.sim3_sampler, _ = _jax_key_chain()
    tfirst, metrics = None, []
    for smap, k in _keyframes(world, True):
        m = tlc.process_keyframe(smap, k)
        metrics.append(m)
        if "loop_with" in m and tfirst is None:
            tfirst = (k, m["loop_with"])
    assert [m.get("loop_candidates") for m in metrics] == jcands
    assert tfirst == jfirst == (Q, MATCH)
    assert [k for k, m in enumerate(metrics) if m.get("loop_closed")] \
        == [Q]
    assert not any("loop_unchecked" in m for m in metrics)
    assert tlc.last_loop_kf == Q and tlc.n_loops_closed == 1


def test_generator_draws_without_a_sampler(world):
    """With no sampler, the draws come from the LoopCloser's CPU generator,
    seeded SIM3_SEED (the JAX key's 7): two fresh loop closers verify the
    same loop with the same g12, and the generator advanced."""
    smap = _full_map(world, True)
    hits, states = [], []
    for _ in range(2):
        lc = _loop_closer(True)
        before = lc.generator.get_state().clone()
        hits.append(lc._compute_sim3(smap, Q, [MATCH]))
        states.append(not torch.equal(before, lc.generator.get_state()))
    assert hits[0][0] == hits[1][0] == MATCH and all(states)
    for a, b in zip(hits[0][1], hits[1][1]):
        assert torch.equal(a, b)
    fresh = torch.Generator().manual_seed(tlc_mod.SIM3_SEED)
    assert torch.equal(fresh.get_state(),
                       _loop_closer(True).generator.get_state())
