"""The async half of the tracker on the CPU: the port's AsyncMapper, the
local mapper's keyframe-pressure valves, the commit helper, and the
batched async System against the JAX package's.

The System comparison runs a rendered sweep of the bench's world
(``smoke_world``, 640x480, 4 levels, 600 features) through both Systems
with async mapping, frame_batch=4 and the mapper's service interval pinned
to 4 polls (mapper_service_polls), no loop closer on the JAX side.  The
port replays the JAX run's RANSAC draws and its keyframe decisions (every
NeedNewKeyFrame answer, recorded from the JAX tracker, becomes the port's
kf_schedule), so the integer decisions do not turn ulp-level differences
into different maps, and JAX's commit: the port moves the last tracked
pose with its reference keyframe when a job's local BA moved it (the
reference's Tracking::UpdateLastFrame), JAX after a closed loop only, so
the port runs with reanchor_after_ba=False here (held on its own in
tests/test_torch_kf_cadence.py).  Tolerances: events, commit frames,
keyframes and tracked flags equal; camera centres within CENTRE_TOL map
units; both ATEs under 2% of the path span; the port's host mirrors
bitwise equal to its tables.  CENTRE_TOL is twice test_torch_system.py's:
while the first new keyframe waits out the batch lag (frames 6-10, 59-95
inliers on the initial map) the first motion-only pose LM is
ill-conditioned, and from
identical inputs and inlier sets the two packages' float32 solves land
5e-4 apart; one local-map match then differs and the frame's centre
differs by up to 1.2e-3 (measured; every other frame within 1.2e-4).
This sweep (every 3rd pose, service interval 4) is the one tried where
the JAX run meets no stale commit (the third issue below); at every 2nd
pose, and at other sweep offsets, it does.

Reference issues met here (ROADMAP Queue 3), and the port's choice:
  - the stale cull list of a pass skipped for a queued keyframe
    (orb_slam_tpu/pipeline/local_mapper.py:107-109): FIXED, the port
    resets the list on entry (test_skipped_pass_reports_no_stale_culls);
  - the uncaught queue.Empty of flush(timeout=300)
    (orb_slam_tpu/pipeline/async_mapper.py:136): FIXED, the port raises
    TimeoutError and keeps the job in flight (test_flush_timeout);
  - a keyframe decided while the pipeline drains for a commit is inserted
    into the map the commit then replaces (orb_slam_tpu/pipeline/
    tracker.py:227-232 with :710-724): FIXED, the port inserts it into the
    adopted map right after the commit, and refuses a stale result
    (test_keyframes_due_during_a_commit_reach_the_adopted_map).
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import orb_slam_tpu.config as jc
import orb_slam_tpu_torch.config as tc
from orb_slam_tpu.mapping import mapstore as jms
from orb_slam_tpu.pipeline import tracker as jtr
from orb_slam_tpu.pipeline.system import System as JaxSystem
from orb_slam_tpu_torch.mapping import mapstore as tms
from orb_slam_tpu_torch.pipeline import async_mapper as am_mod
from orb_slam_tpu_torch.pipeline import tracker as ttr
from orb_slam_tpu_torch.pipeline.system import System
from orb_slam_tpu_torch.pipeline.tracker import TrackState
from test_torch_system import (JaxSampler, _assert_mirrors, _ate_fraction,
                               _centres, _cfg, _copy_jax_map, _frames, _run)
from torch_port_util import np_of, t_of

N_FRAMES, STEP = 25, 3
CENTRE_TOL = 2e-3
ASYNC = dict(async_mapping=True, frame_batch=4, mapper_service_polls=4)


def _async_cfg(mod, width=640, height=480, n_feat=600, cap=640, **kw):
    cfg = _cfg(mod, width, height, n_feat, cap)
    return cfg.replace(tracker=dataclasses.replace(cfg.tracker,
                                                   **{**ASYNC, **kw}))


@pytest.fixture(scope="module")
def runs():
    jcfg = _async_cfg(jc)
    frames = _frames(jcfg, N_FRAMES, STEP)
    js = JaxSystem.create(jcfg)
    # Tracker.create hands the mapper its own loop-closer reference
    js.tracker.loop_closer = None
    js.tracker.async_mapper.loop_closer = None
    needs, orig = set(), jtr.Tracker._need_kf

    def need_kf(self, fid, n_inl):
        need = orig(self, fid, n_inl)
        if need:
            needs.add(fid)
        return need

    jtr.Tracker._need_kf = need_kf
    try:
        jlogs = _run(js, frames)
        js.tracker.finish()
    finally:
        jtr.Tracker._need_kf = orig

    ts = System.create(_async_cfg(tc), device="cpu")
    ts.tracker.init_sampler = JaxSampler(jcfg.seed, jcfg.initializer)
    ts.tracker.kf_schedule = needs
    ts.tracker.reanchor_after_ba = False
    tlogs = _run(ts, frames)
    ts.tracker.finish()
    yield dict(js=js, jlogs=jlogs, ts=ts, tlogs=tlogs, needs=needs)
    js.shutdown()
    ts.shutdown()


def test_async_system_same_events_keyframes_and_flags(runs):
    jev = [l.get("event") for l in runs["jlogs"]]
    tev = [l.get("event") for l in runs["tlogs"]]
    assert "map_initialized" in jev and tev == jev
    assert jev.count("keyframe_inserted") >= 3
    # mapping results were committed at the same frames
    assert ([l["frame_id"] for l in runs["tlogs"] if "mapping" in l]
            == [l["frame_id"] for l in runs["jlogs"] if "mapping" in l])
    jt, tt = runs["js"].tracker, runs["ts"].tracker
    assert tt.slam_map.n_kf == jt.slam_map.n_kf
    assert ([(r.frame_id, r.tracked) for r in tt.trajectory]
            == [(r.frame_id, r.tracked) for r in jt.trajectory])


def test_async_system_centres_and_ate(runs):
    jt, tt = runs["js"].tracker, runs["ts"].tracker
    jc_, tc_ = _centres(jt), _centres(tt)
    assert jc_.keys() == tc_.keys()
    worst = max(float(np.linalg.norm(jc_[f] - tc_[f])) for f in jc_)
    assert worst <= CENTRE_TOL, worst
    for key in ("js", "ts"):
        assert _ate_fraction(runs[key].tracker, STEP) < 0.02, key
    _assert_mirrors(tt.slam_map)


# ---------------------------------------------------------------------------
# the commit helper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_lut", [False, True])
def test_commit_stats_matches_jax(with_lut, rng):
    """commit_stats against the JAX package's _commit_stats_jit: exact."""
    P, N = 64, 16
    c = lambda: rng.integers(1, 9, P).astype(np.int32)     # noqa: E731
    nvis, nfnd, snap_vis, snap_fnd = c(), c(), c(), c()
    cur_vis = snap_vis + rng.integers(0, 4, P).astype(np.int32)
    cur_fnd = snap_fnd + rng.integers(0, 3, P).astype(np.int32)
    mp_pos = rng.normal(0, 1, (P, 3)).astype(np.float32)
    pid = rng.integers(-1, P, N).astype(np.int32)
    if with_lut:    # a compaction: 3/4 of the points kept, packed in order
        keep = rng.random(P) < 0.75
        lut = np.full(P, -1, np.int32)
        lut[keep] = np.arange(keep.sum(), dtype=np.int32)
    else:
        lut = np.zeros(0, np.int32)
    jout = jtr._commit_stats_jit(
        *map(jnp.asarray, (nvis, nfnd, cur_vis, cur_fnd, snap_vis, snap_fnd,
                           lut, mp_pos, pid)), has_lut=with_lut)
    tout = ttr.commit_stats(
        *map(t_of, (nvis, nfnd, cur_vis, cur_fnd, snap_vis, snap_fnd)),
        t_of(lut, torch.int64) if with_lut else None, t_of(mp_pos),
        t_of(pid, torch.int64))
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(np_of(a), np_of(b))


# ---------------------------------------------------------------------------
# AsyncMapper
# ---------------------------------------------------------------------------

class _FakeMapper:
    """A local mapper that returns at once (or after `delay`, or raises)."""
    last_culled_kfs = []

    def __init__(self, delay=0.0, error=None):
        self.delay, self.error = delay, error

    def process_keyframe(self, smap, kf, **kw):
        time.sleep(self.delay)
        if self.error is not None:
            raise self.error
        return {"ok": True}


def _small_map():
    return tms.SlamMap.create(tc.MapConfig(max_keyframes=4, max_points=16),
                              8, device="cpu")


def test_pinned_service_interval():
    """service_polls pins the worker's visible service interval: the result
    surfaces at exactly the N-th poll after submit however fast the thread
    ran (mirrors tests/test_async_mapping.py:99-128)."""
    am = am_mod.AsyncMapper(_FakeMapper(), service_polls=4)
    am.submit(_small_map(), 0)
    time.sleep(0.2)       # let the instant job actually finish
    for _ in range(3):
        assert am.poll() is None and am.busy
    res = am.poll()
    assert res is not None and res.metrics.get("ok") and not am.busy
    am.shutdown()
    assert not am._thread.is_alive()


def test_worker_error_raised_at_poll():
    """A worker exception surfaces at the next poll, once; nothing retries
    the job."""
    am = am_mod.AsyncMapper(_FakeMapper(error=ValueError("boom")))
    am.submit(_small_map(), 0)
    deadline = time.monotonic() + 10
    with pytest.raises(ValueError, match="boom"):
        while time.monotonic() < deadline:
            am.poll()
            time.sleep(0.01)
    assert not am.busy and am.poll() is None
    am.shutdown()


def test_events_cleared_on_submit():
    am = am_mod.AsyncMapper(_FakeMapper())
    am.interrupt_ba.set()
    am.kf_queued.set()
    am.submit(_small_map(), 0)
    assert not am.interrupt_ba.is_set() and not am.kf_queued.is_set()
    with pytest.raises(RuntimeError, match="busy"):
        am.submit(_small_map(), 0)
    assert am.flush(timeout=10).metrics == {"ok": True}
    am.shutdown()


def test_flush_timeout():
    """Reference issue: the JAX flush lets queue.Empty escape after its
    timeout.  FIXED here: TimeoutError, with the job still in flight and
    collected by a later flush."""
    am = am_mod.AsyncMapper(_FakeMapper(delay=0.5))
    am.submit(_small_map(), 0)
    with pytest.raises(TimeoutError):
        am.flush(timeout=0.01)
    assert am.busy
    assert am.flush(timeout=10).metrics == {"ok": True}
    am.shutdown()


def test_snapshot_isolation_both_ways():
    """The port writes its tables in place, so the snapshot must share no
    tensor or host array with the map: writes on either side stay there."""
    smap = _small_map()
    smap.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                      np.ones((8, 2), np.float32), np.zeros(8, np.int32),
                      np.zeros(8, np.float32), np.ones((8, 8), np.int32),
                      np.ones(8, bool), np.full(8, -1, np.int32), 0, 0.0)
    snap = am_mod.snapshot_map(smap)
    before = {n: t.clone() for n, t in zip(smap.state._fields, smap.state)}
    host_before = {k: v.copy() for k, v in smap.host.items()}
    for a, b in zip(smap.state, snap.state):
        assert a.data_ptr() != b.data_ptr()
        assert torch.equal(a, b)

    # the worker's side writes its snapshot
    snap.state.kf_t[0] = 5.0
    snap.state.kf_obs[0, :3] = 7
    snap.set_observations(0, [4], [3])
    snap.host["kf_t"][0] = 5.0
    snap.parent[0] = 9
    snap.loop_edges.append((0, 1))
    for n, t in zip(smap.state._fields, smap.state):
        assert torch.equal(t, before[n]), n
    for k, v in smap.host.items():
        np.testing.assert_array_equal(v, host_before[k], err_msg=k)
    assert smap.parent[0] == -1 and smap.loop_edges == []
    assert smap.obs_np[0, 4] == -1

    # the tracker's side writes its map
    snap_before = {n: t.clone() for n, t in zip(snap.state._fields,
                                                  snap.state)}
    smap.state.mp_pos[:] = 3.0
    smap.state.kf_R[0].fill_(2.0)
    smap.host["mp_pos"][:] = 3.0
    smap.kf_valid_np[0] = False
    for n, t in zip(snap.state._fields, snap.state):
        assert torch.equal(t, snap_before[n]), n
    assert not snap.host["mp_pos"].any() and snap.kf_valid_np[0]


# ---------------------------------------------------------------------------
# the local mapper's valves, on the JAX run's map
# ---------------------------------------------------------------------------

def _carried_map(jm):
    counters = {f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)
                if f.name not in ("state", "host")}
    return tms.SlamMap.from_numpy(
        {n: np.asarray(getattr(jm.state, n)) for n in jms.MapState._fields},
        jm.host, counters, device="cpu")


def test_keyframe_pressure_valves(runs):
    """The two release valves on the JAX run's map carried over by
    SlamMap.from_numpy, against the JAX local mapper on the same map
    (tests/test_async_mapping.py:64-97): a queued keyframe skips fuse, BA
    and culling after triangulation; InterruptBA cuts only the BA; the
    same stage keys and counts from both packages."""
    jm = runs["js"].tracker.slam_map
    jlm = runs["js"].tracker.local_mapper
    tlm = runs["ts"].tracker.local_mapper
    kf = int(np.where(jm.kf_valid_np[:jm.n_kf])[0][-1])
    for kw in (dict(kf_queued=lambda: True), dict(interrupt_ba=lambda: True),
               {}):
        jmet = jlm.process_keyframe(_copy_jax_map(jm), kf, **kw)
        tm = _carried_map(jm)
        tmet = tlm.process_keyframe(tm, kf, **kw)
        assert tmet == jmet, kw
        _assert_mirrors(tm)
        if "kf_queued" in kw:
            assert tmet.get("skipped_for_queued_kf")
            assert "fused" not in tmet and "culled_kfs" not in tmet
        elif "interrupt_ba" in kw:
            assert tmet.get("ba_interrupted")
            assert "fused" in tmet and "culled_kfs" in tmet
        else:
            assert "ba_interrupted" not in tmet and "culled_kfs" in tmet


def test_skipped_pass_reports_no_stale_culls(runs):
    """Reference issue: a JAX pass skipped for a queued keyframe returns
    before its culled-keyframe list is reset, so the worker replays the
    previous pass's culls.  FIXED here: the list is reset on entry."""
    jm = runs["js"].tracker.slam_map
    kf = int(np.where(jm.kf_valid_np[:jm.n_kf])[0][-1])
    jlm = dataclasses.replace(runs["js"].tracker.local_mapper,
                              last_culled_kfs=[5])
    tlm = dataclasses.replace(runs["ts"].tracker.local_mapper,
                              last_culled_kfs=[5])
    jlm.process_keyframe(_copy_jax_map(jm), kf,
                         kf_queued=lambda: True)
    tlm.process_keyframe(_carried_map(jm), kf, kf_queued=lambda: True)
    assert jlm.last_culled_kfs == [5]          # the reference's stale list
    assert tlm.last_culled_kfs == []


def test_keyframes_due_during_a_commit_reach_the_adopted_map():
    """Reference issue: the JAX tracker drains its pipeline for a commit
    after the worker is marked idle, so a keyframe due in the drained
    frames is inserted into the map the commit replaces, and one of the
    two mapping results is lost.  FIXED here: that keyframe is inserted
    into the adopted map right after the commit, and _commit_mapping
    refuses a result whose snapshot is not the tracker's map.  A keyframe
    is due at every frame, so drains meet one at every commit."""
    cfg = _async_cfg(tc, 320, 240, 500, 512)
    system = System.create(cfg, device="cpu")
    system.tracker.kf_schedule = set(range(100))
    commits, deferred = [], []
    orig_commit, orig_bp = (ttr.Tracker._commit_mapping,
                            ttr.Tracker._backpressure)

    def commit(self, res, metrics):
        commits.append((res.smap.n_kf, self.slam_map.n_kf))
        return orig_commit(self, res, metrics)

    def backpressure(self, n_inl):
        deferred.append(self._adopting)
        return orig_bp(self, n_inl)

    ttr.Tracker._commit_mapping = commit
    ttr.Tracker._backpressure = backpressure
    try:
        logs = _run(system, _frames(cfg, 16, 2))
        system.shutdown()
    finally:
        ttr.Tracker._commit_mapping = orig_commit
        ttr.Tracker._backpressure = orig_bp
    tr = system.tracker
    assert any(deferred), "no keyframe came due during a commit's drain"
    assert len(commits) >= 2 and all(a == b for a, b in commits)
    assert sum(l.get("event") == "keyframe_inserted" for l in logs) >= 2
    assert tr.state == TrackState.WORKING
    assert all(r.tracked for r in tr.trajectory)
    _assert_mirrors(tr.slam_map)


def test_stale_commit_is_refused():
    cfg = _async_cfg(tc, 320, 240, 500, 512)
    tr = ttr.Tracker.create(cfg, device="cpu")
    snap = am_mod.snapshot_map(tr.slam_map)
    tr.slam_map.n_kf += 1           # a keyframe inserted after the snapshot
    res = am_mod.MappingResult(smap=snap, kf=0, metrics={},
                               snap_visible=snap.state.mp_visible,
                               snap_found=snap.state.mp_found,
                               remap_lut=None, culled_kfs=[])
    with pytest.raises(RuntimeError, match="stale"):
        tr._commit_mapping(res, {})
    tr.shutdown()
