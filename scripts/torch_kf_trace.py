#!/usr/bin/env python3
"""Trace the keyframe decisions of the endurance run, in either package,
and compare two traces frame by frame.

    python3 scripts/torch_kf_trace.py --package torch --frames 240 \\
        [--device cuda] --out torch.json
    python3 scripts/torch_kf_trace.py --package jax --frames 240 \\
        --out jax.json
    python3 scripts/torch_kf_trace.py --compare jax.json torch.json \\
        [--from-frame 120]

Both runs use the endurance world, drive and configuration
(``scripts/endurance_run.py`` for the JAX package,
``scripts/torch_endurance_run.py`` for the port: 640x480, 600 features in
640 slots, a 48-keyframe pool, async mapping, frame_batch 4) and the
shipped 10^5-word vocabulary.  The tracker is instrumented from here by
wrapping its methods on the instance; neither package changes.  Each
trace holds, per image: the event, the inlier count, the state after it,
the map's keyframe and landmark counts and the scalar metrics of a mapping
job committed there; per keyframe decision (``_need_kf``): the frame,
n_inl, n_ref_tracked, last_kf_frame_id, the answer, whether the worker
was busy, whether the port's tracker was adopting a finished job
(``_adopting``, the port only), and ``_force_kf``; every insertion's
frame, every forced insertion, every commit of a mapping job (its
keyframe, its scalar metrics, and whether its snapshot held fewer
keyframes than the tracker's map: a stale commit); and for the port, every answer of
``_backpressure``.

``--service-polls N`` pins the worker's visible service interval to N
frames in both packages (``mapper_service_polls``; 0, the endurance
runs' setting, is live timing); ``--max-points N`` sets the port's
landmark pool (8192 in the endurance configuration); ``--no-reanchor``
keeps the port's pose at a local BA's commit, as JAX's tracker does
(``Tracker.reanchor_after_ba`` off), so that the two traces part only
where a unit computes otherwise.  ``--shadow-cpu`` runs every mapping job
of the port's run a second time on the CPU, from a CPU copy of the same
snapshot with the same pressure valves, and records per job both jobs'
counts and how far the two maps lie apart (``shadow``): on the card it
holds the local mapper's units (culling, triangulation, fusion, local
BA, keyframe culling) against the CPU job by job.  ``--jax-draws`` hands
the port's two-view initialization JAX's RANSAC samples (the port draws
its own by design), so that a JAX and a port trace start from the same
initial map up to float noise.  The JAX run needs
JAX and runs on the CPU; the port runs on ``--device`` (``cpu`` by
default, ``cuda`` for the card), so a card run and a CPU run at the same
pin line up frame by frame.  Each frame's record then also holds the
local-map match count and the mapping job's new and culled points, and
``--compare`` names the first frame where two traces part and what parted
there.  240 frames take a few minutes per package on the CPU.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
VOCAB = os.path.join(ROOT, "orb_slam_tpu", "data", "vocab100k.npz")
SEED = 7


def _system(package: str, service_polls: int, max_points: int = 0,
            device: str = "cpu", reanchor: bool = True,
            jax_draws: bool = False):
    if package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        import endurance_run as er
        from orb_slam_tpu.pipeline.system import System
        cfg = er.endurance_config(48, 4, VOCAB, service_polls=service_polls)
        return er, System.create(cfg)
    import dataclasses
    import torch_endurance_run as er
    from orb_slam_tpu_torch.pipeline.system import System
    cfg = er.endurance_config(vocab_path=VOCAB)
    cfg = cfg.replace(tracker=dataclasses.replace(
        cfg.tracker, mapper_service_polls=service_polls))
    if max_points:
        cfg = cfg.replace(map=dataclasses.replace(cfg.map,
                                                  max_points=max_points))
    system = System.create(cfg, device=device)
    system.tracker.reanchor_after_ba = reanchor
    if jax_draws:
        system.tracker.init_sampler = JaxInitDraws(cfg)
    return er, system


def instrument(tracker, trace: dict, frame: list):
    """Wrap the tracker's keyframe decision, insertions, forced insertions,
    commits and (port) backpressure on the instance; append to `trace`.
    frame[0] is the index of the image being processed."""
    need, create = tracker._need_kf, tracker._create_keyframe
    starved, commit = tracker._starved_keyframe, tracker._commit_mapping

    def rec_need(fid, n_inl):
        out = need(fid, n_inl)
        am = tracker.async_mapper
        trace["decisions"].append(dict(
            image=frame[0], fid=int(fid), n_inl=int(n_inl),
            n_ref_tracked=int(tracker.n_ref_tracked),
            last_kf_frame_id=int(tracker.last_kf_frame_id),
            frames_since=int(fid - tracker.last_kf_frame_id),
            need=bool(out), busy=bool(am is not None and am.busy),
            adopting=bool(getattr(tracker, "_adopting", False)),
            force_kf=bool(tracker._force_kf)))
        return out

    def rec_create(fd, timestamp, pid_global, metrics, frame_id=None,
                   **kw):
        fid = tracker.frame_id if frame_id is None else frame_id
        trace["inserted"].append(dict(image=frame[0], fid=int(fid)))
        return create(fd, timestamp, pid_global, metrics,
                      frame_id=frame_id, **kw)

    def rec_starved(metrics):
        trace["forced"].append(dict(
            image=frame[0], last_fid=int(tracker.trajectory[-1].frame_id)
            if tracker.trajectory else -1))
        return starved(metrics)

    def rec_commit(res, metrics):
        trace["commits"].append(dict(
            image=frame[0], kf=int(res.kf),
            stale=bool(res.smap.n_kf != tracker.slam_map.n_kf),
            job={k: v for k, v in res.metrics.items()
                 if isinstance(v, (bool, int, float))}))
        return commit(res, metrics)

    tracker._need_kf, tracker._create_keyframe = rec_need, rec_create
    tracker._starved_keyframe, tracker._commit_mapping = (rec_starved,
                                                          rec_commit)
    if hasattr(tracker, "_backpressure"):
        bp = tracker._backpressure

        def rec_bp(n_inl, *a):
            out = bp(n_inl, *a)
            trace["backpressure"].append(dict(
                image=frame[0], n_inl=int(n_inl), skipped=bool(out),
                adopting=bool(tracker._adopting),
                force_kf=bool(tracker._force_kf)))
            return out
        tracker._backpressure = rec_bp


class JaxInitDraws:
    """The JAX tracker's two-view RANSAC draws, handed to the port's
    ``Tracker.init_sampler``: the tracker key split once per initialize()
    call, then the initializer's per-sample choice (as
    ``tests/test_torch_system.py``).  Imports JAX."""

    def __init__(self, cfg):
        import jax
        jax.config.update("jax_platforms", "cpu")
        self.key = jax.random.PRNGKey(cfg.seed)
        self.icfg = cfg.initializer

    def __call__(self, valid):
        import jax
        import jax.numpy as jnp
        self.key, sub = jax.random.split(self.key)
        v = jnp.asarray(valid.cpu().numpy())
        w = v.astype(jnp.float32)
        p = w / jnp.maximum(jnp.sum(w), 1.0)
        keys = jax.random.split(sub, self.icfg.ransac_iterations)
        s = jax.vmap(lambda k: jax.random.choice(
            k, v.shape[0], shape=(self.icfg.sample_size,), replace=False,
            p=p))(keys)
        return np.array(s)


def _to_cpu(smap):
    """A copy of a port's SlamMap on the CPU, sharing nothing with it."""
    import dataclasses
    from orb_slam_tpu_torch.mapping import mapstore
    from orb_slam_tpu_torch.pipeline.async_mapper import snapshot_map
    return snapshot_map(dataclasses.replace(smap, state=mapstore.MapState(
        *(t.detach().to("cpu") for t in smap.state))))


def _job_gap(card, cpu) -> dict:
    """How far a mapping job's map on the card lies from the same job's map
    on the CPU: keyframe centres and landmarks valid in both (max abs),
    and the keyframes and landmarks valid in only one."""
    a, b = card.state, cpu.state
    kv_a, kv_b = a.kf_valid.cpu(), b.kf_valid
    mv_a, mv_b = a.mp_valid.cpu(), b.mp_valid
    kv, mv = kv_a & kv_b, mv_a & mv_b

    def centres(st, keep):
        R, t = st.kf_R.cpu()[keep], st.kf_t.cpu()[keep]
        return -(R.transpose(1, 2) @ t[..., None])[..., 0]
    dc = (centres(a, kv) - centres(b, kv)).abs()
    dx = (a.mp_pos.cpu()[mv] - b.mp_pos[mv]).abs()
    return dict(
        kf_centre_max=float(dc.max()) if dc.numel() else 0.0,
        point_max=float(dx.max()) if dx.numel() else 0.0,
        point_p99=float(dx.amax(dim=1).quantile(0.99)) if dx.numel()
        else 0.0,
        kf_only_one=int((kv_a ^ kv_b).sum()),
        points_only_one=int((mv_a ^ mv_b).sum()))


def shadow_on_cpu(tracker, trace: dict, frame: list):
    """Run every mapping job of a card run a second time on the CPU, on a
    CPU copy of the job's snapshot, with the pressure valves the card's
    job met, and record per job the counts of both and `_job_gap`.  The
    CPU job runs the local mapper only: a card job that closed a loop
    (``loop_closed`` in its record) also holds the correction.  The
    copy is taken at submission (a sync of the card), the CPU job runs at
    the card job's commit, on the tracker's thread; a pinned service
    interval keeps the commit frames."""
    import torch
    from orb_slam_tpu_torch.geometry.camera import CameraParams
    from orb_slam_tpu_torch.pipeline.local_mapper import LocalMapper
    am = tracker.async_mapper
    lm = am.local_mapper
    cam = CameraParams(*(x.cpu() if torch.is_tensor(x) else x
                         for x in lm.cam))
    cpu_lm = LocalMapper(cfg=lm.cfg, cam=cam)
    pending = {}
    submit, commit = am.submit, tracker._commit_mapping

    def rec_submit(smap, kf):
        pending[kf] = (frame[0], _to_cpu(smap))
        return submit(smap, kf)

    def rec_commit(res, metrics):
        sub_frame, snap = pending.pop(res.kf)
        m = res.metrics
        cpu_m = cpu_lm.process_keyframe(
            snap, res.kf,
            interrupt_ba=lambda: bool(m.get("ba_interrupted")),
            kf_queued=lambda: bool(m.get("skipped_for_queued_kf")))
        keys = ("culled_points", "new_points", "fused", "culled_kfs",
                "ba_interrupted", "skipped_for_queued_kf", "loop_with",
                "loop_closed")
        trace["shadow"].append(dict(
            image=frame[0], submitted=sub_frame, kf=int(res.kf),
            card={k: m[k] for k in keys if k in m},
            cpu={k: cpu_m[k] for k in keys if k in cpu_m},
            **_job_gap(res.smap, snap)))
        return commit(res, metrics)

    am.submit, tracker._commit_mapping = rec_submit, rec_commit


def run(package: str, n_frames: int, service_polls: int,
        max_points: int = 0, device: str = "cpu",
        reanchor: bool = True, shadow: bool = False,
        jax_draws: bool = False) -> dict:
    er, system = _system(package, service_polls, max_points, device,
                         reanchor, jax_draws)
    rng = np.random.default_rng(SEED)
    X, patches = er.build_world(rng)
    poses, _ = er.lap_poses(n_frames, 400, rng)
    K = system.tracker.cfg.camera.K
    trace = dict(package=package, n_frames=n_frames, device=device,
                 service_polls=service_polls, reanchor=reanchor,
                 jax_draws=jax_draws,
                 frames=[], decisions=[],
                 inserted=[], forced=[], commits=[], backpressure=[],
                 shadow=[])
    frame = [0]
    instrument(system.tracker, trace, frame)
    if shadow:
        # after instrument: the shadow wraps its commit wrapper
        shadow_on_cpu(system.tracker, trace, frame)
    t0 = time.perf_counter()
    logs = []
    for i, (R, t) in enumerate(poses):
        frame[0] = i
        logs.append(system.process_image(
            er.render_image(X, patches, R, t, K), timestamp=i / 30.0))
        if i % 40 == 39:
            print(f"{package}: frame {i + 1}/{n_frames} "
                  f"{time.perf_counter() - t0:.0f} s "
                  f"kf={system.tracker.slam_map.n_kf}", flush=True)
    system.shutdown()
    # read after the run: a pipelined frame's counts land in its metrics
    # when it retires, after process_image has returned them
    for i, m in enumerate(logs):
        trace["frames"].append(dict(
            image=i, event=m.get("event"), inliers=m.get("inliers"),
            localmap_matches=m.get("localmap_matches"),
            state=m.get("state_after"), kf_id=m.get("kf_id"),
            n_keyframes=m.get("n_keyframes"),
            n_map_points=m.get("n_map_points"),
            mapping={k: v for k, v in m.get("mapping", {}).items()
                     if isinstance(v, (bool, int, float))}))
    trace["tracked"] = sum(1 for r in system.tracker.trajectory
                           if r.tracked)
    trace["wall_s"] = time.perf_counter() - t0
    return trace


FRAME_KEYS = ("state", "inliers", "localmap_matches", "n_map_points",
              "n_keyframes", "mapping")


def first_parting(a: dict, b: dict):
    """The first image where two traces differ, and what differs there:
    a frame's state, inlier or local-map match count, the map's landmark
    or keyframe count, the scalar metrics of a job committed there (new,
    culled and fused points, culled keyframes), or a keyframe decision."""
    need = [{d["fid"]: d["need"] for d in t["decisions"]} for t in (a, b)]
    for fa, fb in zip(a["frames"], b["frames"]):
        i = fa["image"]
        if need[0].get(i) != need[1].get(i):
            return dict(image=i, what="keyframe decision",
                        a=need[0].get(i), b=need[1].get(i))
        for k in FRAME_KEYS:
            if fa.get(k) != fb.get(k):
                return dict(image=i, what=k, a=fa.get(k), b=fb.get(k))
    return None


def compare(a: dict, b: dict, first: int) -> dict:
    """Side by side from frame `first` on: each package's insertion
    frames, lost frames, forced insertions and skipped decisions, and
    the keyframes inserted and mapping jobs committed over the run."""
    def summary(t):
        lost = [f["image"] for f in t["frames"] if f["state"] == "LOST"]
        return dict(
            tracked=t["tracked"], lost=lost,
            n_inserted=len(t["inserted"]), n_committed=len(t["commits"]),
            inserted=[x["fid"] for x in t["inserted"] if x["fid"] >= first],
            forced=[x["image"] for x in t["forced"] if x["image"] >= first],
            stale_commits=[x["image"] for x in t["commits"] if x["stale"]],
            skipped=[(d["fid"], d["n_inl"], d["busy"], d["adopting"])
                     for d in t["decisions"]
                     if d["need"] and d["fid"] >= first
                     and d["fid"] not in {x["fid"] for x in t["inserted"]}],
            adopting_skips=sum(1 for x in t["backpressure"]
                               if x["skipped"] and x["adopting"]),
            busy_skips=sum(1 for x in t["backpressure"]
                           if x["skipped"] and not x["adopting"]))
    def name(t):
        return f'{t["package"]}@{t.get("device", "cpu")}'
    out = {name(a): summary(a)}
    out[name(b) if name(b) != name(a) else name(b) + "'"] = summary(b)
    out["first_parting"] = first_parting(a, b)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"))
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--service-polls", type=int, default=0)
    ap.add_argument("--max-points", type=int, default=0,
                    help="the port's landmark pool (0: the endurance "
                         "configuration's 8192)")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                    help="the port's device (the JAX run is on the CPU)")
    ap.add_argument("--no-reanchor", action="store_true",
                    help="the port's tracker keeps its pose at a local "
                         "BA's commit, as JAX's does "
                         "(Tracker.reanchor_after_ba off)")
    ap.add_argument("--jax-draws", action="store_true",
                    help="the port's two-view initialization draws JAX's "
                         "RANSAC samples (imports JAX)")
    ap.add_argument("--shadow-cpu", action="store_true",
                    help="run every mapping job of the port's run again "
                         "on the CPU from the same snapshot and record "
                         "how far the two maps lie apart")
    ap.add_argument("--out", default="kf_trace.json")
    ap.add_argument("--compare", nargs=2, metavar="TRACE")
    ap.add_argument("--from-frame", type=int, default=120)
    args = ap.parse_args(argv)
    if args.compare:
        traces = []
        for p in args.compare:
            with open(p) as f:
                traces.append(json.load(f))
        print(json.dumps(compare(*traces, args.from_frame), indent=1))
        return 0
    if args.package is None:
        ap.error("--package or --compare is required")
    if args.package != "torch" and (args.max_points or args.no_reanchor
                                    or args.shadow_cpu or args.jax_draws
                                    or args.device != "cpu"):
        ap.error("--max-points, --no-reanchor, --shadow-cpu, --jax-draws "
                 "and --device apply to the port only")
    trace = run(args.package, args.frames, args.service_polls,
                args.max_points, args.device, not args.no_reanchor,
                args.shadow_cpu, args.jax_draws)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(trace, f)
    summary = next(iter(compare(trace, trace, 0).values()))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
