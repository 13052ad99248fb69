"""The keyframe cadence at a mapping commit (the port only, on the CPU).

The JAX tracker commits a finished mapping job from ``process_image``
(orb_slam_tpu/pipeline/tracker.py:225-232)::

    if self.async_mapper is not None:
        res = self.async_mapper.poll()
        if res is not None:
            with _timer.stage("tracking", "commitMapping"):
                self._drain_pipe()
                self._commit_mapping(res, metrics)

and decides keyframes as the drain retires its frames (:710-724)::

    need = self._need_kf(fid, n_inl)
    if need:
        am = self.async_mapper
        if am is not None and am.busy:
            ...
            if n_inl < 2 * tcfg.kf_min_tracked:
                self._force_kf = True
            ...
        else:
            self._create_keyframe(None, timestamp, pid_global, ...)

So at a commit the first frame of the drain that falls due is inserted
(the worker is idle: poll took its result), every later due frame meets
the worker busy with it, and a starving one forces a second insertion
after the worker is flushed: the newest retired frame (``_starved_keyframe``).
JAX makes the first insertion into the map the commit then replaces, and
the worker's next result loses the committed job (known issue 7).  The
port makes the same insertions from the same frames, the first one into
the adopted map right after the commit.

The System runs a rendered 320x240 sweep (``smoke_world``) with async
mapping, frame_batch 4 and the worker's service interval pinned to 4
polls.  The keyframe decision is scripted: frame 3 falls due (the first
job), and after it every frame that a commit's drain retires, and only
those; every due frame starves (``kf_min_tracked`` above any inlier
count).  So each commit's drain holds several due frames, and each forced
flush submits the job whose commit makes the next drain.
"""
import dataclasses

import numpy as np
import pytest
import torch

import orb_slam_tpu_torch.config as tc
import smoke_world as syn
from orb_slam_tpu_torch.pipeline import tracker as ttr
from orb_slam_tpu_torch.pipeline.system import System
from orb_slam_tpu_torch.pipeline.tracker import TrackState

N_FRAMES, STEP, SEED = 16, 2, 11


def _cfg():
    w, h = 320, 240
    f = 500.0 * w / 640
    cfg = tc.SystemConfig(
        camera=tc.CameraConfig(fx=f, fy=f, cx=w / 2, cy=h / 2, k1=0, k2=0,
                               p1=0, p2=0, k3=0, width=w, height=h),
        extractor=tc.ExtractorConfig(n_features=500, max_keypoints=512,
                                     n_levels=4),
        matcher=tc.MatcherConfig(window_init=120 * w // 640),
        map=tc.MapConfig(max_keyframes=32, max_points=4096,
                         local_ba_max_kfs=8, local_ba_max_fixed=8,
                         local_ba_max_points=2048))
    return cfg.replace(tracker=dataclasses.replace(
        cfg.tracker, async_mapping=True, frame_batch=4,
        mapper_service_polls=4, kf_min_tracked=10**6))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: under the suite's parallel workers more threads
    only contend (the tracker and the mapping worker share them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run():
    """The events of the run, in order: ("decide", fid, need, adopting),
    ("commit", job keyframe, its map, fresh, from_flush), ("insert",
    fid, the tracker's map), ("starved",); and the tracker."""
    cfg = _cfg()
    rend = syn.SceneRenderer(np.random.default_rng(SEED), cfg.camera.K,
                             cfg.camera.width, cfg.camera.height)
    frames = [rend.render(*syn.pose_at(STEP * i)) for i in range(N_FRAMES)]
    system = System.create(cfg, device="cpu")
    tr = system.tracker
    tr.kf_schedule = {3}
    events = []
    T = ttr.Tracker
    orig = dict(need=T._need_kf, commit=T._commit_mapping,
                create=T._create_keyframe, starved=T._starved_keyframe)
    flushing = [False]

    def need(self, fid, n_inl):
        out = orig["need"](self, fid, n_inl) or self._adopting
        events.append(("decide", fid, out, self._adopting))
        return out

    def commit(self, res, metrics):
        events.append(("commit", res.kf, res.smap,
                       res.smap.n_kf == self.slam_map.n_kf, flushing[0]))
        return orig["commit"](self, res, metrics)

    def create(self, fd, timestamp, pid_global, metrics, frame_id=None,
               **kw):
        events.append(("insert", frame_id, self.slam_map))
        return orig["create"](self, fd, timestamp, pid_global, metrics,
                              frame_id=frame_id, **kw)

    def starved(self, metrics):
        events.append(("starved",))
        flushing[0] = True
        try:
            return orig["starved"](self, metrics)
        finally:
            flushing[0] = False

    T._need_kf, T._commit_mapping = need, commit
    T._create_keyframe, T._starved_keyframe = create, starved
    try:
        for i, img in enumerate(frames):
            system.process_image(img, i / 30.0)
        system.shutdown()
    finally:
        T._need_kf, T._commit_mapping = orig["need"], orig["commit"]
        T._create_keyframe, T._starved_keyframe = (orig["create"],
                                                   orig["starved"])
    return events, tr


def _drain_commits(events):
    """Each commit polled at a frame boundary: (its index in events, the
    fids due during its drain, the last fid the drain retired)."""
    out = []
    for i, e in enumerate(events):
        if e[0] != "commit" or e[4]:
            continue
        drained = []
        for prev in reversed(events[:i]):
            if prev[0] != "decide" or not prev[3]:
                break
            drained.insert(0, prev)
        due = [d[1] for d in drained if d[2]]
        out.append((i, due, drained[-1][1] if drained else None))
    return out


def test_drains_meet_due_keyframes(run):
    events, _ = run
    commits = _drain_commits(events)
    assert any(len(due) >= 2 for _, due, _ in commits), commits


def test_keyframes_come_from_jax_frames(run):
    """After a commit whose drain had due frames: the first due frame is
    inserted into the adopted map; a second due frame (starving) forces a
    flush, whose commit is followed by the insertion of the drain's last
    retired frame, unless that frame was the first insertion."""
    events, _ = run
    checked = 0
    for i, due, last in _drain_commits(events):
        if not due:
            continue
        adopted = events[i][2]
        nxt = events[i + 1]
        assert nxt[0] == "insert" and nxt[1] == due[0], (due, nxt)
        assert nxt[2] is adopted            # into the adopted map
        if len(due) >= 2 and last != due[0]:
            rest = [e[0] for e in events[i + 2:i + 5]]
            assert rest == ["starved", "commit", "insert"], rest
            assert events[i + 3][4]         # the flush's commit
            assert events[i + 4][1] == last
        checked += 1
    assert checked >= 1


def test_every_commit_is_adopted(run):
    """No finished job is lost (known issue 7): every commit's snapshot
    is the tracker's map (fresh), and each insertion goes into the map of
    the commit before it."""
    events, tr = run
    commits = [e for e in events if e[0] == "commit"]
    assert len(commits) >= 3 and all(e[3] for e in commits)
    last_map = None
    for e in events:
        if e[0] == "commit":
            last_map = e[2]
        elif e[0] == "insert" and last_map is not None:
            assert e[2] is last_map
    assert tr.state == TrackState.WORKING
    assert all(r.tracked for r in tr.trajectory)
    assert len(tr.trajectory) == N_FRAMES - 1     # the init frame has none


def _rot(axis, ang):
    a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return (np.eye(3) + np.sin(ang) * K
            + (1 - np.cos(ang)) * K @ K).astype(np.float32)


@pytest.mark.parametrize("reanchor", [True, False])
def test_commit_moves_the_last_pose_with_its_keyframe(reanchor):
    """A job whose local BA moved the tracker's reference keyframe: the
    commit carries the move onto the last tracked pose, so its pose
    relative to the keyframe is kept (the reference re-anchors the last
    frame on its reference keyframe, Tracking::UpdateLastFrame); with
    reanchor_after_ba=False, the JAX tracker's commit, it stays put.
    Float32 poses: within 1e-5."""
    from orb_slam_tpu_torch.pipeline import async_mapper as am_mod
    cfg = _cfg()
    tr = ttr.Tracker.create(cfg, device="cpu")
    tr.reanchor_after_ba = reanchor
    n = cfg.extractor.max_keypoints
    rng = np.random.default_rng(3)
    R0, t0 = _rot([0, 1, 0], 0.1), np.array([0.2, 0.0, -0.1], np.float32)
    tr.slam_map.add_keyframe(
        R0, t0, rng.uniform(0, 300, (n, 2)).astype(np.float32),
        np.zeros(n, np.int32), np.zeros(n, np.float32),
        rng.integers(0, 2**31, (n, 8)).astype(np.int32),
        np.ones(n, bool), np.full(n, -1, np.int32), 0, 0.0, parent=-1)
    tr.ref_kf = 0
    R_last, t_last = _rot([1, 2, 0], 0.2), np.array([0.3, 0.1, 0.4],
                                                    np.float32)
    tr.last_R, tr.last_t = R_last, t_last
    snap = am_mod.snapshot_map(tr.slam_map)
    R1, t1 = _rot([0, 1, 1], 0.05) @ R0, t0 + np.float32([0.05, -0.02, 0.1])
    snap.set_pose(0, R1, t1)
    res = am_mod.MappingResult(
        smap=snap, kf=0, metrics={}, snap_visible=snap.state.mp_visible,
        snap_found=snap.state.mp_found, remap_lut=None, culled_kfs=[])
    tr._commit_mapping(res, {})
    if not reanchor:
        np.testing.assert_array_equal(tr.last_R, R_last)
        np.testing.assert_array_equal(tr.last_t, t_last)
    else:
        # T_last T_kf^-1 before the commit equals it after
        rel_R0, rel_R1 = R_last @ R0.T, tr.last_R @ R1.T
        np.testing.assert_allclose(rel_R1, rel_R0, atol=1e-5)
        np.testing.assert_allclose(tr.last_t - rel_R1 @ t1,
                                   t_last - rel_R0 @ t0, atol=1e-5)
    tr.shutdown()
