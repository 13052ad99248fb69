"""The whole slice on the CPU: the port's System against the JAX System.

A rendered sweep of the bench's two-wall world (``smoke_world``, 640x480,
4 levels, 600 features) goes through the JAX System (no loop closer, the
XLA extraction path of the CPU) and through the port's System on
device="cpu".  The port draws its RANSAC samples as the JAX tracker does
(``jax.random`` with the same key chain, handed in through
``Tracker.init_sampler``) and inserts keyframes at the frames where the JAX
run inserted (``kf_schedule``): the keyframe policy's integer decisions
otherwise turn ulp-level differences into structurally different maps.

Tolerances, and why:
  - init frame, event per frame, keyframe count, tracked flag per frame:
    equal (the schedule is pinned; the decisions are integers);
  - initial map points within 2%: descriptors may differ by <= 2 bits
    (BRIEF steering, ROADMAP Queue 3), which moves a few matches;
  - camera centres within CENTRE_TOL of each other (map units: the init
    baseline is normalized to median depth 1), for the same reason plus
    float32 solver differences;
  - map points within 5%;
  - both ATEs (Sim3-aligned) under 2% of the path span, as
    tests/test_pipeline.py;
  - every host mirror of the port's map bitwise equal to its table.

More cases: the port alone, unpinned, at 320x240 (it initializes, tracks
to the end and inserts >= 3 keyframes); the staged Tracker.process path on
feature-level input; one local-mapping pass of both packages on the JAX
run's map carried over by SlamMap.from_numpy; build_frame and the
trajectory tools; the modes this slice does not port raise.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import orb_slam_tpu.config as jc
import orb_slam_tpu_torch.config as tc
import smoke_world as syn
from orb_slam_tpu.pipeline.system import System as JaxSystem
from orb_slam_tpu_torch.dataio import trajectory as traj
from orb_slam_tpu_torch.pipeline.system import System
from orb_slam_tpu_torch.pipeline.tracker import TrackState

N_FRAMES, STEP = 19, 3        # frames of the sweep, every STEP-th pose
CENTRE_TOL = 1e-3             # map units (median init depth = 1)
SEED = 11


def _cfg(mod, width, height, n_feat, cap):
    f = 500.0 * width / 640
    return mod.SystemConfig(
        camera=mod.CameraConfig(fx=f, fy=f, cx=width / 2, cy=height / 2,
                                k1=0, k2=0, p1=0, p2=0, k3=0, width=width,
                                height=height),
        extractor=mod.ExtractorConfig(n_features=n_feat, max_keypoints=cap,
                                      n_levels=4),
        matcher=mod.MatcherConfig(window_init=120 * width // 640),
        map=mod.MapConfig(max_keyframes=32, max_points=4096,
                          local_ba_max_kfs=8, local_ba_max_fixed=8,
                          local_ba_max_points=2048))


def _frames(cfg, n, step):
    rend = syn.SceneRenderer(np.random.default_rng(SEED), cfg.camera.K,
                             cfg.camera.width, cfg.camera.height)
    return [rend.render(*syn.pose_at(step * i)) for i in range(n)]


class JaxSampler:
    """The JAX tracker's RANSAC draws: split the tracker key once per
    initialize() call, then initializer.py's per-sample choice."""

    def __init__(self, seed, icfg):
        self.key = jax.random.PRNGKey(seed)
        self.icfg = icfg

    def __call__(self, valid):
        self.key, sub = jax.random.split(self.key)
        v = jnp.asarray(valid.cpu().numpy())
        w = v.astype(jnp.float32)
        p = w / jnp.maximum(jnp.sum(w), 1.0)
        n = v.shape[0]
        keys = jax.random.split(sub, self.icfg.ransac_iterations)
        s = jax.vmap(lambda k: jax.random.choice(
            k, n, shape=(self.icfg.sample_size,), replace=False, p=p))(keys)
        return np.array(s)


def _run(system, frames):
    return [system.process_image(img, i / 30.0)
            for i, img in enumerate(frames)]


def _centres(tracker):
    return {r.frame_id: -r.R.T @ r.t for r in tracker.trajectory
            if r.tracked}


def _ate_fraction(tracker, step):
    tr = [r for r in tracker.trajectory if r.tracked]
    est = np.array([-r.R.T @ r.t for r in tr])
    gt = np.array([syn.camera_center(*syn.pose_at(step * r.frame_id))
                   for r in tr])
    span = np.linalg.norm(gt.max(0) - gt.min(0))
    return traj.ate_rmse(est, gt, with_scale=True) / span


@pytest.fixture(scope="module")
def runs():
    jcfg = _cfg(jc, 640, 480, 600, 640)
    frames = _frames(jcfg, N_FRAMES, STEP)
    js = JaxSystem.create(jcfg)
    js.tracker.loop_closer = None
    jlogs = _run(js, frames)
    schedule = {l["frame_id"] for l in jlogs
                if l.get("event") == "keyframe_inserted"}

    ts = System.create(_cfg(tc, 640, 480, 600, 640), device="cpu")
    ts.tracker.init_sampler = JaxSampler(jcfg.seed, jcfg.initializer)
    ts.tracker.kf_schedule = schedule
    tlogs = _run(ts, frames)
    return dict(js=js, jlogs=jlogs, ts=ts, tlogs=tlogs, schedule=schedule)


def test_same_events_and_init(runs):
    jev = [l.get("event") for l in runs["jlogs"]]
    tev = [l.get("event") for l in runs["tlogs"]]
    assert "map_initialized" in jev
    assert tev == jev
    ji = [l for l in runs["jlogs"] if l.get("event") == "map_initialized"][0]
    ti = [l for l in runs["tlogs"] if l.get("event") == "map_initialized"][0]
    assert ti["frame_id"] == ji["frame_id"]
    assert abs(ti["n_init_points"] - ji["n_init_points"]) \
        <= 0.02 * ji["n_init_points"]


def test_same_keyframes_and_tracked_flags(runs):
    jt, tt = runs["js"].tracker, runs["ts"].tracker
    assert len(runs["schedule"]) >= 3
    assert tt.slam_map.n_kf == jt.slam_map.n_kf
    assert ([(r.frame_id, r.tracked) for r in tt.trajectory]
            == [(r.frame_id, r.tracked) for r in jt.trajectory])


def test_camera_centres_and_points_agree(runs):
    jt, tt = runs["js"].tracker, runs["ts"].tracker
    jc_, tc_ = _centres(jt), _centres(tt)
    assert jc_.keys() == tc_.keys()
    worst = max(float(np.linalg.norm(jc_[f] - tc_[f])) for f in jc_)
    assert worst <= CENTRE_TOL, worst
    n_j = int(np.asarray(jt.slam_map.state.mp_valid).sum())
    n_t = int(tt.slam_map.mp_valid_np.sum())
    assert abs(n_t - n_j) <= 0.05 * n_j, (n_t, n_j)


def test_both_ate_under_two_percent_of_span(runs):
    for key in ("js", "ts"):
        frac = _ate_fraction(runs[key].tracker, STEP)
        assert frac < 0.02, (key, frac)


def _assert_mirrors(smap):
    st = smap.state
    np.testing.assert_array_equal(st.kf_obs.numpy(), smap.obs_np)
    np.testing.assert_array_equal(st.kf_valid.numpy(), smap.kf_valid_np)
    np.testing.assert_array_equal(st.mp_valid.numpy(), smap.mp_valid_np)
    for name, arr in smap.host.items():
        if name in ("mp_found", "mp_visible"):
            continue   # insert-time snapshots by design
        np.testing.assert_array_equal(getattr(st, name).numpy(), arr,
                                      err_msg=name)


def test_port_host_mirrors_after_run(runs):
    _assert_mirrors(runs["ts"].tracker.slam_map)


def test_port_alone_unpinned_tracks_to_end():
    cfg = _cfg(tc, 320, 240, 500, 512)
    system = System.create(cfg, device="cpu")
    logs = _run(system, _frames(cfg, 18, 2))
    tracker = system.tracker
    assert "map_initialized" in [l.get("event") for l in logs]
    assert tracker.state == TrackState.WORKING
    assert sum(r.tracked for r in tracker.trajectory) >= 16
    assert tracker.slam_map.n_kf >= 3
    _assert_mirrors(tracker.slam_map)
    rows = tracker.keyframe_trajectory()
    assert len(rows) == int(tracker.slam_map.kf_valid_np.sum())
    assert all(np.isfinite(r[1]).all() and np.isfinite(r[2]).all()
               for r in rows)


def test_unported_modes_raise():
    for tcfg in (tc.TrackerConfig(async_mapping=True),
                 tc.TrackerConfig(frame_batch=2)):
        with pytest.raises(NotImplementedError):
            System.create(tc.SystemConfig(tracker=tcfg), device="cpu")
    with pytest.raises(NotImplementedError):
        System.create(tc.SystemConfig(solver=tc.SolverConfig(
            ba_layout="grid")), device="cpu")
    if not torch.cuda.is_available():    # the default device is the card
        with pytest.raises(RuntimeError):
            System.create(tc.SystemConfig())


def _port_feats(f):
    """The port's FrameFeatures from a JAX FrameFeatures (synthetic)."""
    from orb_slam_tpu_torch.frontend.extractor import FrameFeatures
    return FrameFeatures(
        xy=torch.from_numpy(np.array(f.xy, np.float32)),
        response=torch.from_numpy(np.array(f.response, np.float32)),
        angle=torch.from_numpy(np.array(f.angle, np.float32)),
        level=torch.from_numpy(np.array(f.level, np.int64)),
        desc=torch.from_numpy(np.array(f.desc).view(np.int32)),
        valid=torch.from_numpy(np.array(f.valid, bool)))


def test_port_staged_path_on_features():
    """Tracker.process (pre-extracted features: the staged WORKING path,
    tracking_megastep) on the feature-level sequence of
    tests/test_pipeline.py: it initializes, tracks every later frame,
    inserts >= 3 keyframes, and its ATE is under 2% of the path span."""
    from synthetic_sequence import (circular_trajectory, make_world,
                                    render_frame)
    from orb_slam_tpu_torch.pipeline.tracker import Tracker
    rng = np.random.default_rng(11)
    base = _cfg(tc, 640, 480, 512, 512)
    cfg = base.replace(extractor=tc.ExtractorConfig(n_features=512,
                                                    max_keypoints=512),
                       matcher=tc.MatcherConfig(window_init=200))
    X, desc = make_world(rng, n_points=900)
    poses = circular_trajectory(20)
    tracker = Tracker.create(cfg, device="cpu")
    logs = []
    for i, (R, t) in enumerate(poses):
        feats, _ = render_frame(rng, X, desc, R, t, cfg.camera.K)
        logs.append(tracker.process(_port_feats(feats), timestamp=i / 30.0))
    assert "map_initialized" in [l.get("event") for l in logs]
    assert tracker.state == TrackState.WORKING
    tracked = [r for r in tracker.trajectory if r.tracked]
    assert len(tracked) >= 17
    assert tracker.slam_map.n_kf >= 3
    est = np.array([-r.R.T @ r.t for r in tracked])
    gt = np.array([-poses[r.frame_id][0].T @ poses[r.frame_id][1]
                   for r in tracked])
    span = np.linalg.norm(gt.max(0) - gt.min(0))
    assert traj.ate_rmse(est, gt, with_scale=True) < 0.02 * span
    _assert_mirrors(tracker.slam_map)


def _copy_jax_map(jm):
    """An independent copy of a JAX SlamMap (its state is immutable; the
    host fields are copied)."""
    import copy
    return dataclasses.replace(
        jm, parent=jm.parent.copy(), loop_edges=list(jm.loop_edges),
        kf_frame_id=jm.kf_frame_id.copy(),
        kf_timestamp=jm.kf_timestamp.copy(), obs_np=jm.obs_np.copy(),
        kf_valid_np=jm.kf_valid_np.copy(), mp_valid_np=jm.mp_valid_np.copy(),
        host=copy.deepcopy(jm.host))


def test_local_mapper_on_the_jax_map(runs):
    """One keyframe's synchronous mapping pass of both packages on the
    same map: the JAX run's final map, carried into the port by
    SlamMap.from_numpy, with its newest keyframe processed again.  The
    stage counts (culled, new, fused points, culled keyframes) exact and
    the observation tables equal on >= 99.9% of slots (a float32 SVD could
    flip a borderline triangulation gate; measured: all equal); keyframe
    poses after local BA within 1e-4 map units (measured 5.6e-6)."""
    from orb_slam_tpu.mapping import mapstore as jms
    from orb_slam_tpu_torch.mapping import mapstore as tms
    jm = _copy_jax_map(runs["js"].tracker.slam_map)
    counters = {f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)
                if f.name not in ("state", "host")}
    tm = tms.SlamMap.from_numpy(
        {n: np.asarray(getattr(jm.state, n)) for n in jms.MapState._fields},
        jm.host, counters, device="cpu")
    kf = int(np.where(jm.kf_valid_np[:jm.n_kf])[0][-1])
    jmet = runs["js"].tracker.local_mapper.process_keyframe(jm, kf)
    tmet = runs["ts"].tracker.local_mapper.process_keyframe(tm, kf)
    assert tmet == jmet
    assert jmet["new_points"] > 0 and jmet["fused"] > 0
    assert (tm.obs_np == jm.obs_np).mean() >= 0.999
    live = np.where(jm.kf_valid_np[:jm.n_kf])[0]
    np.testing.assert_allclose(tm.host["kf_t"][live], jm.host["kf_t"][live],
                               atol=1e-4)
    np.testing.assert_allclose(tm.host["kf_R"][live], jm.host["kf_R"][live],
                               atol=1e-4)
    _assert_mirrors(tm)


def test_build_frame_and_trajectory_tools_match_jax(rng):
    """frame.build_frame (exact levels/sigma2, undistortion within 1e-3 px
    with the fr1 distortion) and the trajectory tools (equal within float
    rounding) against the JAX package's."""
    from orb_slam_tpu.dataio import trajectory as jtraj
    from orb_slam_tpu.frontend.extractor import FrameFeatures as JF
    from orb_slam_tpu.geometry.camera import make_camera as jcam
    from orb_slam_tpu.pipeline.frame import build_frame as jbuild
    from orb_slam_tpu_torch.geometry.camera import make_camera as tcam
    from orb_slam_tpu_torch.pipeline.frame import build_frame as tbuild
    jcfg, tcfg = jc.tum_freiburg1_config(), tc.tum_freiburg1_config()
    n = 64
    f = dict(xy=rng.uniform(0, 640, (n, 2)).astype(np.float32),
             response=rng.random(n).astype(np.float32),
             angle=rng.uniform(0, 6, n).astype(np.float32),
             level=rng.integers(0, 8, n),
             desc=rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(
                 np.uint32), valid=rng.random(n) < 0.9)
    jf = jbuild(JF(**{k: jnp.asarray(v) for k, v in f.items()}),
                jcam(jcfg.camera), jcfg.extractor)
    tf = tbuild(_port_feats(JF(**f)), tcam(tcfg.camera, device="cpu"),
                tcfg.extractor)
    np.testing.assert_allclose(tf.xy_und.numpy(), np.asarray(jf.xy_und),
                               atol=1e-3)
    np.testing.assert_array_equal(tf.sigma2.numpy(), np.asarray(jf.sigma2))
    np.testing.assert_array_equal(tf.inv_sigma2.numpy(),
                                  np.asarray(jf.inv_sigma2))

    est = rng.normal(0, 1, (30, 3))
    gt = 2.0 * est @ rotmat_np(rng).T + 0.3 + rng.normal(0, 0.01, (30, 3))
    for a, b in zip(traj.umeyama_alignment(est, gt),
                    jtraj.umeyama_alignment(est, gt)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    assert traj.ate_rmse(est, gt) == pytest.approx(jtraj.ate_rmse(est, gt),
                                                   rel=1e-12)
    ta = np.sort(rng.uniform(0, 10, 40))
    tb = np.sort(ta + rng.normal(0, 0.01, 40))
    for a, b in zip(traj.associate_by_time(ta, tb),
                    jtraj.associate_by_time(ta, tb)):
        np.testing.assert_array_equal(a, b)


def rotmat_np(rng):
    q, _ = np.linalg.qr(rng.normal(0, 1, (3, 3)))
    return q * np.sign(np.linalg.det(q))
