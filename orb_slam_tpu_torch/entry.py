"""The port's twin of ``__graft_entry__.entry()``: the per-frame tracking
core (``track_kernels.tracking_megastep``: frame-to-frame and local-map
projection matching with the motion-only pose LM) at that function's
shapes, 512 keypoints against 2048 landmarks, from the same seeded numpy
inputs.

    fn, args = entry()            # on the card; entry(device="cpu") on the CPU
    R, t, n_inliers = fn(*args)
"""
from __future__ import annotations

import numpy as np
import torch

from .config import CameraConfig, SystemConfig
from .device import resolve_device
from .geometry import camera as cam_mod
from .pipeline import track_kernels as tk


def example_tracking_arrays(n_kp: int = 512, n_pts: int = 2048,
                            seed: int = 0) -> dict:
    """The numpy inputs of ``__graft_entry__._example_tracking_args``:
    landmarks in front of an identity camera, and a frame whose keypoints
    are the visible landmarks' projections (0.4 px noise) carrying their
    descriptors.  Descriptors are uint32."""
    rng = np.random.default_rng(seed)
    mp_pos = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                       rng.uniform(2, 8, n_pts)], 1).astype(np.float32)
    mp_desc = rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint32)
    uv = np.stack([500 * mp_pos[:, 0] / mp_pos[:, 2] + 320,
                   500 * mp_pos[:, 1] / mp_pos[:, 2] + 240], 1)
    vis = ((uv[:, 0] > 8) & (uv[:, 0] < 632) & (uv[:, 1] > 8)
           & (uv[:, 1] < 472))
    sel = np.where(vis)[0][:n_kp]
    cur_xy = np.full((n_kp, 2), 320.0, np.float32)
    cur_desc = rng.integers(0, 2**32, (n_kp, 8), dtype=np.uint32)
    cur_xy[: len(sel)] = uv[sel] + rng.normal(0, 0.4, (len(sel), 2))
    cur_desc[: len(sel)] = mp_desc[sel]
    # the scale band as point_stats computes it: the predicted level is 0
    d = np.linalg.norm(mp_pos, axis=1)
    return dict(
        cur_xy=cur_xy, cur_desc=cur_desc, cur_level=np.zeros(n_kp, np.int64),
        cur_angle=np.zeros(n_kp, np.float32), cur_valid=np.ones(n_kp, bool),
        mp_pos=mp_pos, mp_desc=mp_desc,
        mp_normal=np.tile(np.array([0.0, 0.0, 1.0], np.float32), (n_pts, 1)),
        mp_min=(d * 1.05 / 1.2**7).astype(np.float32),
        mp_max=(d * 1.05).astype(np.float32), mp_valid=np.ones(n_pts, bool),
        R=np.eye(3, dtype=np.float32), t=np.zeros(3, np.float32),
        inv_sigma2=np.ones(n_kp, np.float32))


def entry(device=None):
    """(fn, args): fn(*args) -> (R, t, n_inliers) of tracking_megastep,
    with the last frame modelled by the first n_kp landmarks and the
    current frame's own features, as ``__graft_entry__.entry`` does."""
    dev = resolve_device(device)
    a = example_tracking_arrays()
    cfg = SystemConfig(camera=CameraConfig(
        fx=500.0, fy=500.0, cx=320.0, cy=240.0, k1=0.0, k2=0.0, p1=0.0,
        p2=0.0, k3=0.0, width=640, height=480))
    cam = cam_mod.make_camera(cfg.camera, device=dev)

    def put(x):
        x = np.ascontiguousarray(x)
        if x.dtype == np.uint32:      # descriptors: int32 views of the words
            x = x.view(np.int32)
        return torch.from_numpy(x).to(dev)

    n_kp = a["cur_xy"].shape[0]
    cur = [put(a[k]) for k in ("cur_xy", "cur_desc", "cur_level",
                               "cur_angle", "cur_valid", "inv_sigma2")]
    last = [put(a["mp_pos"][:n_kp]), cur[1], cur[2], cur[3], cur[4]]
    mp = [put(a[k]) for k in ("mp_pos", "mp_desc", "mp_normal", "mp_min",
                              "mp_max", "mp_valid", "R", "t")]

    def tracking_step(cur_xy, cur_desc, cur_level, cur_angle, cur_valid,
                      inv_sigma2, last_pos, last_desc, last_level,
                      last_angle, last_valid, mp_pos, mp_desc, mp_normal,
                      mp_min, mp_max, mp_valid, R, t):
        R2, t2, _, _, _, stats = tk.tracking_megastep(
            cur_xy, cur_desc, cur_level, cur_angle, cur_valid, inv_sigma2,
            last_pos, last_desc, last_level, last_angle, last_valid,
            mp_pos, mp_desc, mp_normal, mp_min, mp_max, mp_valid,
            R, t, cam, cfg.solver)
        return R2, t2, stats["n_inliers"]

    return tracking_step, tuple(cur + last + mp)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The twin of ``__graft_entry__.dryrun_multichip``: the two-phase
    landmark-sharded BA, the CG solver with spatial (Morton) sharding, and
    the keyframe-block-sharded essential graph, over a mesh of n_devices
    shards, on small seeded problems.

    With the environment of ``parallel.hostmesh.maybe_init_distributed``
    the process joins a torch.distributed group first and the shards
    spread over the processes.  Where the processes hold fewer devices
    than n_devices, the missing ones are virtual shards on the devices
    there are (``hostmesh.virtual_devices``).  Returns the checks and the
    timing rows it prints."""
    import math
    import time

    from .config import SolverConfig
    from .parallel import dist_ba, dist_pose_graph, hostmesh
    from .solvers import bundle_adjust as ba
    from .solvers import pose_graph as pg

    dev = resolve_device(device)
    if hostmesh.maybe_init_distributed(dev):
        print(f"dryrun_multichip: torch.distributed process "
              f"{hostmesh.process_index()}/{hostmesh.process_count()}")
        dev = torch.device(dev.type, torch.cuda.current_device()) \
            if dev.type == "cuda" else dev
    n_local = max(hostmesh.local_device_count(dev.type),
                  math.ceil(n_devices / hostmesh.process_count()))
    out = {}
    with hostmesh.virtual_devices(dev.type, n_local):
        rng = np.random.default_rng(0)
        cam = cam_mod.make_camera(CameraConfig(
            fx=500.0, fy=500.0, cx=320.0, cy=240.0, k1=0.0, k2=0.0, p1=0.0,
            p2=0.0, k3=0.0, width=640, height=480), device=dev)
        # 4 cameras, landmarks sharded over the mesh
        K, P_total = 4, 16 * n_devices
        X = np.stack([rng.uniform(-2, 2, P_total), rng.uniform(-1, 1, P_total),
                      rng.uniform(3, 6, P_total)], 1).astype(np.float32)
        ts_np = np.stack([[-0.2 * k, 0.0, 0.0] for k in range(K)]).astype(
            np.float32)
        cam_idx, pt_idx, uvs = [], [], []
        for k in range(K):
            xc = X + ts_np[k]
            uv = np.stack([500 * xc[:, 0] / xc[:, 2] + 320,
                           500 * xc[:, 1] / xc[:, 2] + 240], 1)
            cam_idx.append(np.full(P_total, k))
            pt_idx.append(np.arange(P_total))
            uvs.append(uv + rng.normal(0, 0.3, uv.shape))

        def up(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

        edges = ba.BAEdges(
            cam_idx=up(np.concatenate(cam_idx), torch.int64),
            pt_idx=up(np.concatenate(pt_idx), torch.int64),
            uv=up(np.concatenate(uvs), torch.float32),
            inv_sigma2=torch.ones(K * P_total, device=dev),
            valid=torch.ones(K * P_total, dtype=torch.bool, device=dev))
        Rs = torch.eye(3, device=dev).repeat(K, 1, 1)
        ts = up(ts_np, torch.float32)
        fixed = torch.arange(K, device=dev) == 0

        def run_ba(n_dev):
            mesh = dist_ba.make_mesh(n_dev, device=dev)
            prob = dist_ba.partition_problem(X, edges, n_dev)
            Rs1, _, _, _ = dist_ba.bundle_adjust_sharded(
                mesh, Rs, ts, prob, fixed, cam, SolverConfig(),
                two_phase=True)
            return Rs1, prob

        Rs1, prob = run_ba(n_devices)
        out["ba_finite"] = bool(torch.isfinite(Rs1).all())
        print(f"dryrun_multichip({n_devices}): distributed two-phase BA "
              f"{'OK' if out['ba_finite'] else 'NOT FINITE'}, "
              f"landmarks/shard={prob.Xs.shape[1]}")

        # matrix-free CG Schur + map-block (Morton) landmark sharding: the
        # city-scale configuration (one [K,6] psum per CG matvec)
        res_cg = dist_ba.bundle_adjust_dist(
            Rs, ts, up(X, torch.float32), fixed, edges, cam, SolverConfig(),
            two_phase=True, mesh=dist_ba.make_mesh(n_devices, device=dev),
            solver="cg", strategy="spatial")
        out["cg_finite"] = bool(torch.isfinite(res_cg.t).all())
        print(f"dryrun_multichip({n_devices}): CG + spatial-sharded BA "
              f"{'OK' if out['cg_finite'] else 'NOT FINITE'}")

        # keyframe-block-sharded essential graph (edge sharding + psum)
        n_pg = 8
        t0 = up(rng.normal(0, 0.1, (n_pg, 3)), torch.float32)
        pe = pg.Sim3Edges(
            i=torch.arange(1, n_pg, device=dev),
            j=torch.arange(n_pg - 1, device=dev),
            s_meas=torch.ones(n_pg - 1, device=dev),
            R_meas=torch.eye(3, device=dev).repeat(n_pg - 1, 1, 1),
            t_meas=torch.zeros((n_pg - 1, 3), device=dev),
            valid=torch.ones(n_pg - 1, dtype=torch.bool, device=dev))
        _, _, t1, _ = dist_pose_graph.optimize_essential_graph_dist(
            torch.ones(n_pg, device=dev),
            torch.eye(3, device=dev).repeat(n_pg, 1, 1), t0,
            torch.arange(n_pg, device=dev) == 0, pe, n_iters=2,
            n_shards=n_devices)
        out["graph_finite"] = bool(torch.isfinite(t1).all())
        print(f"dryrun_multichip({n_devices}): sharded essential graph "
              f"{'OK' if out['graph_finite'] else 'NOT FINITE'}")

        # BA iterations per second at 1 and n_devices shards: virtual
        # shards share their device, so this checks the sharded program
        # at both mesh sizes, not scaling
        n_it = SolverConfig().local_ba_iters1 + SolverConfig().local_ba_iters2
        rows = []
        for d in sorted({1, n_devices}):
            run_ba(d)                                     # warm
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t_start = time.perf_counter()
            Rs_d, _ = run_ba(d)
            Rs_d.cpu()
            rows.append((d, n_it / (time.perf_counter() - t_start)))
        base = rows[0][1]
        table = "  ".join(f"{d}dev={r:.1f}it/s({r / base * 100:.0f}% of "
                          f"1dev)" for d, r in rows)
        print(f"dryrun_multichip collective-program check: {table} "
              "[virtual shards share one device: this checks that the "
              "sharded program runs at both mesh sizes, NOT hardware "
              "scaling, which needs >= 2 real devices]")
        out["it_per_s"] = dict(rows)
    return out
