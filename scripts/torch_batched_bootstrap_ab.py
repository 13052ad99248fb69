#!/usr/bin/env python3
"""The JAX System and the port's on the CPU, at the bench configuration,
over the same frames of the bench sweep: does the batched path's
bootstrap error come from the reference or from the port?

    python3 scripts/torch_batched_bootstrap_ab.py [--frames 200]
        [--prefixes 90,200] [--blackout START LEN] [--out DIR]

Both Systems run bench.py's configuration (640x480, 8 levels, 1000
features in 1024 slots, window_init 120, the default MapConfig, async
mapping, frame_batch 16) on the rendered sweep of ``smoke_world`` (seed
11) from frame 0.  The port replays the JAX run's random draws (the JAX
tracker's one key chain, split per two-view initialization and per PnP
RANSAC) and its keyframe decisions (every NeedNewKeyFrame answer becomes
the port's ``kf_schedule``), as tests/test_torch_async_mapping.py does, and
both pin the mapping worker's service interval to --service-polls polls
(bench.py uses live timing, which makes the commit frames depend on the
machine's speed).  Without --blackout the loop closers are off in both
(place recognition cannot change tracking here; the JAX package's loop
correction, not ported, could).

Prints, for each System, the Sim3-aligned ATE over each prefix as a share
of that prefix's path span, the init frame and the keyframe frames, the
first frame whose event differs, and the JAX run's stale commits: commits
whose job snapshot holds fewer keyframes than the tracker's map (a keyframe
inserted while the commit drained the pipeline, lost when the commit
replaces the map; ROADMAP Queue 3 known issue 7, which the port fixes, so
the runs part there by design); with
--blackout START LEN, frames START..START+LEN-1 are black (zero images) and
each System's relocalized frame is printed too.  This needs JAX and runs on
the CPU only: the port runs with device="cpu", the JAX package on its CPU
backend.  Expect tens of minutes for 200 frames.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def bench_cfg(mod, service_polls):
    return mod.SystemConfig(
        camera=mod.CameraConfig(fx=500, fy=500, cx=320, cy=240, k1=0, k2=0,
                                p1=0, p2=0, k3=0, width=640, height=480),
        extractor=mod.ExtractorConfig(n_features=1000, max_keypoints=1024,
                                      n_levels=8),
        matcher=mod.MatcherConfig(window_init=120),
        tracker=mod.TrackerConfig(async_mapping=True, frame_batch=16,
                                  mapper_service_polls=service_polls))


class JaxDraws:
    """The JAX tracker's key chain (tracker.py:953 and :1362): split once
    per initialize() and per pnp_ransac() call, then each solver's
    per-sample choice."""

    def __init__(self, seed, icfg):
        import jax
        self.jax = jax
        self.key = jax.random.PRNGKey(seed)
        self.icfg = icfg

    def _choice(self, valid, n_samples, size):
        jax, jnp = self.jax, self.jax.numpy
        self.key, sub = jax.random.split(self.key)
        v = jnp.asarray(np.asarray(valid))
        w = v.astype(jnp.float32)
        p = w / jnp.maximum(jnp.sum(w), 1.0)
        keys = jax.random.split(sub, n_samples)
        return np.array(jax.vmap(lambda k: jax.random.choice(
            k, v.shape[0], shape=(size,), replace=False, p=p))(keys))

    def init(self, valid):
        return self._choice(valid.cpu().numpy(), self.icfg.ransac_iterations,
                            self.icfg.sample_size)

    def pnp(self, valid, n_samples, min_set):
        return self._choice(valid, n_samples, min_set)


def summary(tracker, logs, prefixes, step_pose):
    import smoke_world as syn
    from orb_slam_tpu_torch.dataio import trajectory as traj
    rec = [r for r in tracker.trajectory if r.tracked]
    est = np.array([-np.asarray(r.R).T @ np.asarray(r.t) for r in rec])
    gt = np.array([syn.camera_center(*step_pose(r.frame_id)) for r in rec])
    fid = np.array([r.frame_id for r in rec])
    ate = {}
    for n in prefixes:
        sel = fid < n
        span = np.linalg.norm(gt[sel].max(0) - gt[sel].min(0))
        ate[n] = float(traj.ate_rmse(est[sel], gt[sel], with_scale=True)
                       / span)
    ev = [m.get("event") for m in logs]
    return dict(
        ate_span_fraction=ate,
        init_frame=ev.index("map_initialized") if "map_initialized" in ev
        else None,
        keyframe_frames=[i for i, e in enumerate(ev)
                         if e == "keyframe_inserted"],
        lost_frames=[i for i, e in enumerate(ev) if e == "tracking_lost"],
        relocalized_frames=[i for i, e in enumerate(ev)
                            if e == "relocalized"],
        loop_closed=[i for i, m in enumerate(logs)
                     if m.get("mapping", {}).get("loop_closed")],
        tracked=int(sum(r.tracked for r in tracker.trajectory)),
        records=len(tracker.trajectory))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--prefixes", default="90,200")
    ap.add_argument("--blackout", type=int, nargs=2, default=None,
                    metavar=("START", "LEN"))
    ap.add_argument("--service-polls", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import smoke_world as syn
    import orb_slam_tpu.config as jc
    import orb_slam_tpu_torch.config as tc
    from orb_slam_tpu.pipeline import tracker as jtr
    from orb_slam_tpu.pipeline.system import System as JaxSystem
    from orb_slam_tpu_torch.pipeline.system import System

    prefixes = [min(int(p), args.frames) for p in args.prefixes.split(",")]
    jcfg = bench_cfg(jc, args.service_polls)
    rend = syn.SceneRenderer(np.random.default_rng(11), jcfg.camera.K)
    frames = [rend.render(*syn.pose_at(i)) for i in range(args.frames)]
    if args.blackout:
        start, length = args.blackout
        for i in range(start, min(start + length, args.frames)):
            frames[i] = np.zeros_like(frames[i])

    t0 = time.perf_counter()
    js = JaxSystem.create(jcfg)
    if not args.blackout:
        js.tracker.loop_closer = None
        js.tracker.async_mapper.loop_closer = None
    needs, orig = set(), jtr.Tracker._need_kf

    def need_kf(self, fid, n_inl):
        need = orig(self, fid, n_inl)
        if need:
            needs.add(fid)
        return need

    stale, commit = [], jtr.Tracker._commit_mapping

    def noted_commit(self, res, metrics):
        if res.smap.n_kf != self.slam_map.n_kf:
            stale.append(self.frame_id)
        return commit(self, res, metrics)

    jtr.Tracker._need_kf = need_kf
    jtr.Tracker._commit_mapping = noted_commit
    try:
        jlogs = []
        for i, img in enumerate(frames):
            jlogs.append(js.process_image(img, i / 30.0))
            if i % 20 == 0:
                print(f"# jax frame {i} ({time.perf_counter() - t0:.0f} s)",
                      flush=True)
        js.tracker.finish()
    finally:
        jtr.Tracker._need_kf = orig
        jtr.Tracker._commit_mapping = commit
    jax_s = time.perf_counter() - t0
    jsum = summary(js.tracker, jlogs, prefixes, syn.pose_at)
    jsum["stale_commits_at_frames"] = stale
    js.shutdown()
    print("# jax", json.dumps(jsum), flush=True)

    t0 = time.perf_counter()
    ts = System.create(bench_cfg(tc, args.service_polls), device="cpu")
    if not args.blackout:
        ts.tracker.loop_closer = None
        ts.tracker.async_mapper.loop_closer = None
    draws = JaxDraws(jcfg.seed, jcfg.initializer)
    ts.tracker.init_sampler, ts.tracker.pnp_sampler = draws.init, draws.pnp
    ts.tracker.kf_schedule = needs
    tlogs = []
    for i, img in enumerate(frames):
        tlogs.append(ts.process_image(img, i / 30.0))
        if i % 20 == 0:
            print(f"# port frame {i} ({time.perf_counter() - t0:.0f} s)",
                  flush=True)
    ts.tracker.finish()
    port_s = time.perf_counter() - t0
    tsum = summary(ts.tracker, tlogs, prefixes, syn.pose_at)
    ts.shutdown()
    print("# port", json.dumps(tsum), flush=True)

    jev = [m.get("event") for m in jlogs]
    tev = [m.get("event") for m in tlogs]
    differ = [i for i, (a, b) in enumerate(zip(jev, tev)) if a != b]
    result = dict(frames=args.frames, blackout=args.blackout,
                  service_polls=args.service_polls, jax=jsum, port=tsum,
                  jax_s=jax_s, port_s=port_s, same_events=not differ,
                  first_event_difference=(
                      dict(frame=differ[0], jax=jev[differ[0]],
                           port=tev[differ[0]]) if differ else None))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "torch_batched_bootstrap_ab.json"),
                  "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
