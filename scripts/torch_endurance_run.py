#!/usr/bin/env python3
"""The loop-closing run of the PyTorch/CUDA port: the twin of
``scripts/endurance_run.py`` for ``orb_slam_tpu_torch``, through the
normal entry point, ``System.process_image``.

    python3 scripts/torch_endurance_run.py [--frames 480] \\
        [--out torch_endurance.json] [--service-polls N] [--trace]

The same world and drive as the JAX script (copies of its ``build_world``,
``lap_poses``, ``render_image`` and ``endurance_config``: 1500
patch-textured landmarks around a 6 m driving circle, 400 frames per lap,
seed 7, 640x480, 600 features in 640 slots at 4 levels, a 48-keyframe
pool, async mapping, frame_batch 4) and the shipped 10^5-word vocabulary,
read by path from ``orb_slam_tpu/data/vocab100k.npz``.  The JAX package's
CPU runs closed their loop at frames 407 (RESULTS_r03.json) and 405
(RESULTS_r05_cpu.json), so ~480 frames reach the first revisit.

The script logs every check the mapping worker makes: the candidates, the
gate each one stopped at (descriptor matches, RANSAC, refined inliers,
guided matches) with its counts, and the check's host-clock ms; and every
loop correction: its keyframes, its ms by stage (host clock between
synchronizations of the card: propagation, fuse, LoopConnections, the
graph's edges and solve, the re-map, refresh_host) and the Sim3-aligned
ATE of the live keyframes just before and just after it.  Reading the
counts adds a few host syncs to the worker; the package itself reports
only ``loop_candidates``, ``loop_with`` and ``loop_closed``.

``--service-polls N`` pins the mapping worker's visible service interval
to N frames (``mapper_service_polls``; 0, the JAX script's setting, is
live timing).  ``--trace`` records every keyframe decision, insertion,
forced insertion and commit (``scripts/torch_kf_trace.py``'s wrappers)
and each mapping job's frames from submission to commit and host-clock
ms on the worker.

Writes one JSON file: the first frame whose metrics carry
``loop_candidates``, the first with ``loop_with`` and every frame with
``loop_closed`` (frames are those at which the worker's result was
committed), the checks, the corrections, the StageTimer's
``loopclosing/*`` ms, the tracked fraction, fps, the Sim3-aligned
keyframe ATE at the end (``ate_corrected``: a loop was closed before it)
and the card's name and power limit.  Runs on the card (``--device cpu``:
the plain PyTorch path on the CPU) and fails without one.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
VOCAB = os.path.join(ROOT, "orb_slam_tpu", "data", "vocab100k.npz")
SEED = 7                    # endurance_run.run_endurance's


def build_world(rng, n_points=1500, center=(3.0, 0.0, 0.0), r_lo=2.0,
                r_hi=6.0, y_half=2.5, patch=9):
    """Annulus of patch-textured landmarks around the driving circle."""
    th = rng.uniform(0, 2 * np.pi, n_points)
    r = np.sqrt(rng.uniform(r_lo**2, r_hi**2, n_points))
    X = np.stack([
        center[0] + r * np.sin(th),
        rng.uniform(-y_half, y_half, n_points),
        center[2] + r * np.cos(th),
    ], axis=1).astype(np.float32)
    patches = rng.uniform(0, 255, (n_points, patch, patch)).astype(np.float32)
    return X, patches


def lap_poses(n_frames, frames_per_lap, rng, radius=3.0, inward=0.8):
    """Multi-lap circular drive; the camera faces partway between the
    tangent and the ring centre (parallax for the monocular initializer),
    with a smooth per-lap wobble so revisited frames are similar but not
    pixel-identical."""
    wob = rng.normal(0, 1.0, (n_frames + 64, 3)).astype(np.float32)
    k = np.hanning(33).astype(np.float32)
    k /= k.sum()
    wob = np.stack([np.convolve(wob[:, j], k, "same") for j in range(3)], 1)
    center = np.array([radius, 0.0, 0.0], np.float32)
    poses, gt_centers = [], []
    for i in range(n_frames):
        th = 2 * np.pi * i / frames_per_lap
        C = np.array([radius * (1 - np.cos(th)), 0.0, radius * np.sin(th)],
                     np.float32)
        C = C + 0.03 * wob[i]
        tangent = np.array([np.sin(th), 0.0, np.cos(th)], np.float32)
        to_center = center - C
        to_center /= max(np.linalg.norm(to_center), 1e-6)
        f = tangent + inward * to_center
        f /= np.linalg.norm(f)
        d = np.array([0.0, 1.0, 0.0], np.float32)
        r = np.cross(d, f)
        Rc2w = np.stack([r / np.linalg.norm(r), d, f], axis=1).astype(
            np.float32)
        R = Rc2w.T
        t = -R @ C
        poses.append((R, t.astype(np.float32)))
        gt_centers.append(C)
    return poses, np.asarray(gt_centers)


def render_image(X, patches, R, t, K, width=640, height=480):
    img = np.full((height, width), 90.0, np.float32)
    xc = X @ R.T + t
    z = xc[:, 2]
    uv = np.stack([K[0, 0] * xc[:, 0] / np.maximum(z, 1e-6) + K[0, 2],
                   K[1, 1] * xc[:, 1] / np.maximum(z, 1e-6) + K[1, 2]], 1)
    p = patches.shape[1]
    rr = p // 2
    ui = np.round(uv[:, 0]).astype(int)
    vi = np.round(uv[:, 1]).astype(int)
    vis = ((z > 0.8) & (ui >= rr) & (ui < width - rr)
           & (vi >= rr) & (vi < height - rr))
    idx = np.where(vis)[0]
    idx = idx[np.argsort(-z[idx])]          # painter: far first
    for i in idx:
        u, v = ui[i], vi[i]
        img[v - rr:v + rr + 1, u - rr:u + rr + 1] = patches[i]
    return img


def endurance_config(max_keyframes=48, frame_batch=4, vocab_path=""):
    """The JAX script's configuration in the port's config classes."""
    import dataclasses
    from orb_slam_tpu_torch.config import (CameraConfig, ExtractorConfig,
                                           MapConfig, MatcherConfig,
                                           SystemConfig)
    cfg = SystemConfig(
        camera=CameraConfig(fx=500, fy=500, cx=320, cy=240, k1=0, k2=0,
                            p1=0, p2=0, k3=0, width=640, height=480),
        extractor=ExtractorConfig(n_features=600, max_keypoints=640,
                                  n_levels=4),
        matcher=MatcherConfig(window_init=200),
        map=MapConfig(max_keyframes=max_keyframes, max_points=8192,
                      local_ba_max_kfs=8, local_ba_max_fixed=8,
                      local_ba_max_points=2048),
    )
    if vocab_path:
        cfg = cfg.replace(loop=dataclasses.replace(
            cfg.loop, vocab_path=vocab_path))
    return cfg.replace(tracker=dataclasses.replace(
        cfg.tracker, async_mapping=True, frame_batch=frame_batch,
        mapper_service_polls=0))


def log_checks(lc, checks):
    """Wrap the loop closer's check so that every call appends {kf, frame,
    candidates: [{kf, frame, gate, pairs, ransac_inliers, refined_inliers,
    n_total}], ms, loop_with} to `checks` (on the mapping worker; frame:
    the keyframe's source frame)."""
    from orb_slam_tpu_torch.solvers import sim3_opt, sim3_solver
    compute, pairs_of = lc._compute_sim3, lc._loop_pairs
    guided = lc._count_guided_matches
    ransac, refine = sim3_solver.sim3_ransac, sim3_opt.optimize_sim3
    cur = []

    def stage(gate, **kw):
        cur[-1].update(gate=gate, **kw)

    def rec_pairs(smap, kf, cand):
        out = pairs_of(smap, kf, cand)
        cur.append(dict(kf=int(cand), frame=int(smap.kf_frame_id[cand]),
                        gate="matches", pairs=None if out is None
                        else int(out.valid_np.sum())))
        return out

    def rec_ransac(*a, **kw):
        res = ransac(*a, **kw)
        stage("ransac", ransac_ok=bool(res.ok),
              ransac_inliers=int(res.n_inliers))
        return res

    def rec_refine(*a, **kw):
        res = refine(*a, **kw)
        stage("refine", refined_inliers=int(res.n_inliers))
        return res

    def rec_guided(*a):
        n = guided(*a)
        stage("guided", n_total=n)
        return n

    def rec_compute(smap, kf, cands):
        cur.clear()
        t0 = time.perf_counter()
        hit = compute(smap, kf, cands)
        checks.append(dict(kf=int(kf), frame=int(smap.kf_frame_id[kf]),
                           candidates=list(cur),
                           ms=(time.perf_counter() - t0) * 1e3,
                           loop_with=None if hit is None else int(hit[0])))
        return hit

    lc._compute_sim3, lc._loop_pairs = rec_compute, rec_pairs
    lc._count_guided_matches = rec_guided
    sim3_solver.sim3_ransac, sim3_opt.optimize_sim3 = rec_ransac, rec_refine


def log_corrections(lc, corrections, gt_of):
    """Wrap the loop closer's correction so that every call appends {kf,
    loop_kf, frame, loop_frame, ms: {stage: ms}, ms_total, ate_before,
    ate_after} to `corrections` (on the mapping worker; the stages timed
    by chip_smoke.timed_correct; ate_*: the Sim3-aligned ATE of the live
    keyframes' centres against gt_of(timestamps), None below 3
    keyframes)."""
    from chip_smoke import timed_correct
    from orb_slam_tpu_torch.dataio import trajectory as traj
    correct = lc._correct

    def ate(smap):
        live = np.where(smap.kf_valid_np[:smap.n_kf])[0]
        if len(live) < 3:
            return None
        R, t = smap.host["kf_R"][live], smap.host["kf_t"][live]
        centres = -np.einsum("kji,kj->ki", R, t)
        return float(traj.ate_rmse(centres, gt_of(smap.kf_timestamp[live]),
                                   with_scale=True))

    def rec_correct(smap, kf, loop_kf, g12):
        before = ate(smap)
        ms, total, _, _ = timed_correct(lc, smap, correct, kf, loop_kf, g12)
        corrections.append(dict(
            kf=int(kf), loop_kf=int(loop_kf),
            frame=int(smap.kf_frame_id[kf]),
            loop_frame=int(smap.kf_frame_id[loop_kf]), ms=ms,
            ms_total=total, ate_before=before, ate_after=ate(smap)))

    lc._correct = rec_correct


def trace_jobs(am, jobs, frame):
    """Wrap the mapping worker's job so that every job appends {kf,
    submitted (frame index), ms (host clock on the worker)} to `jobs`;
    frame[0] is the index of the image being processed."""
    run_job, submit = am._job, am.submit

    def rec_submit(smap, kf):
        jobs.append(dict(kf=int(kf), submitted=frame[0]))
        return submit(smap, kf)

    def rec_job(*a):
        t0 = time.perf_counter()
        out = run_job(*a)
        ms = (time.perf_counter() - t0) * 1e3
        for j in reversed(jobs):
            if j["kf"] == out.kf and "ms" not in j:
                j["ms"] = ms
                break
        return out

    am.submit, am._job = rec_submit, rec_job


def _spread(x):
    return dict(median=float(np.median(x)), p90=float(np.percentile(x, 90)),
                max=float(max(x)), n=len(x)) if len(x) else None


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=480)
    ap.add_argument("--frames-per-lap", type=int, default=400)
    ap.add_argument("--out", default="torch_endurance.json")
    ap.add_argument("--device", default="cuda",
                    help="cpu runs the plain PyTorch path (a rehearsal)")
    ap.add_argument("--service-polls", type=int, default=0,
                    help="pin the mapping worker's service interval to N "
                         "frames (0: live timing)")
    ap.add_argument("--trace", action="store_true",
                    help="record keyframe decisions and mapping jobs")
    args = ap.parse_args(argv)

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_endurance_run: no CUDA device", file=sys.stderr)
        return 1
    from orb_slam_tpu_torch.pipeline.system import System
    from orb_slam_tpu_torch.utils.timing import GLOBAL_TIMER

    card = gpu_line() if args.device == "cuda" else "cpu"
    print(f"# card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    rng = np.random.default_rng(SEED)
    cfg = endurance_config(vocab_path=VOCAB)
    cfg = cfg.replace(tracker=dataclasses.replace(
        cfg.tracker, mapper_service_polls=args.service_polls))
    X, patches = build_world(rng)
    poses, gt_centers = lap_poses(args.frames, args.frames_per_lap, rng)
    K = cfg.camera.K

    def gt_of(ts):
        return gt_centers[np.clip(np.round(np.asarray(ts) * 30.0)
                                  .astype(int), 0, len(gt_centers) - 1)]

    system = System.create(cfg, device=args.device)
    tracker = system.tracker
    checks, corrections, jobs = [], [], []
    log_checks(tracker.loop_closer, checks)
    log_corrections(tracker.loop_closer, corrections, gt_of)
    frame = [0]
    trace = None
    if args.trace:
        from torch_kf_trace import instrument
        trace = dict(decisions=[], inserted=[], forced=[], commits=[],
                     backpressure=[])
        instrument(tracker, trace, frame)
        trace_jobs(tracker.async_mapper, jobs, frame)
    GLOBAL_TIMER.reset()
    events, first_cands, first_loop, closed = {}, None, None, []
    t0 = time.perf_counter()
    for i, (R, t) in enumerate(poses):
        frame[0] = i
        m = system.process_image(render_image(X, patches, R, t, K),
                                 timestamp=i / 30.0)
        ev = m.get("event")
        if ev:
            events.setdefault(ev, []).append(i)
        for part in (m, m.get("mapping", {})):
            if part.get("loop_candidates") and first_cands is None:
                first_cands = i
            if "loop_with" in part and first_loop is None:
                first_loop = (i, int(part["loop_with"]))
            if part.get("loop_closed"):
                closed.append(i)
        if i % 100 == 99:
            el = time.perf_counter() - t0
            print(f"frame {i + 1}/{args.frames}  {el:.0f} s "
                  f"({(i + 1) / el:.2f} fps)  kf={tracker.slam_map.n_kf} "
                  f"mp={tracker.slam_map.n_mp} checks={len(checks)}",
                  flush=True)
    system.shutdown()
    wall = time.perf_counter() - t0
    if trace is not None:
        # each job's commit: the first commit of its keyframe after it
        commits = list(trace["commits"])
        for j in jobs:
            c = next((c for c in commits if c["kf"] == j["kf"]
                      and c["image"] >= j["submitted"]), None)
            if c is not None:
                commits.remove(c)
                j["committed"] = c["image"]
                j["service_frames"] = c["image"] - j["submitted"]

    n = args.frames
    tracked = sum(1 for r in tracker.trajectory if r.tracked)
    gt = np.zeros((n, 8), np.float64)
    gt[:, 0] = np.arange(n) / 30.0
    gt[:, 1:4] = gt_centers
    ate = system.evaluate_ate(gt)
    summary = GLOBAL_TIMER.summary()
    results = dict(
        run="endurance_multilap_rendered", n_frames=n,
        frames_per_lap=args.frames_per_lap, frame_batch=4,
        async_mapping=True, max_keyframes_pool=cfg.map.max_keyframes,
        vocab_path=os.path.relpath(VOCAB, ROOT),
        vocab_n_words=int(tracker.loop_closer.voc.n_words),
        tracked_frac=tracked / n, fps=n / wall, wall_s=wall,
        ate_rmse_sim3_m=None if ate is None else float(ate),
        ate_corrected=bool(closed), trajectory_extent_m=6.0,
        service_polls=args.service_polls,
        n_keyframes_final=int(tracker.slam_map.n_kf),
        live_keyframe_frames=sorted(
            int(f) for f in tracker.slam_map.kf_frame_id[
                tracker.slam_map.kf_valid_np]),
        kf_pool_compactions=int(tracker.slam_map.kf_compactions),
        first_loop_candidates_frame=first_cands,
        first_loop_with=None if first_loop is None else dict(
            frame=first_loop[0], kf=first_loop[1]),
        loop_closed_frames=closed,
        loops_closed=int(tracker.loop_closer.n_loops_closed),
        corrections=corrections,
        ate_before_first_correction_m=(corrections[0]["ate_before"]
                                       if corrections else None),
        checks=checks,
        compute_sim3=summary.get("loopclosing/computeSim3"),
        loop_closing_stages={k: v for k, v in summary.items()
                             if k.startswith("loopclosing/")},
        event_counts={k: len(v) for k, v in events.items()},
        events=events,
        jobs=jobs, trace=trace,
        job_service_frames=_spread([j["service_frames"] for j in jobs
                                    if "service_frames" in j]),
        job_ms=_spread([j["ms"] for j in jobs if "ms" in j]),
        card=card)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({k: v for k, v in results.items()
                      if k not in ("checks", "events", "jobs", "trace")}),
          flush=True)
    print(f"# {len(checks)} checks; written to {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
