"""Bundle adjustment at scale on the card: the PyTorch twin of
scripts/ba_city_bench.py.

Times ms per LM iteration of `orb_slam_tpu_torch.solvers.bundle_adjust`
at local-BA scale (64 KF x 8192 points) and city scale (256 KF x 16384,
512 KF x 24576) in each combination of edge layout (flat | grid), grid
placement (scatter | onehot) and reduced solve (dense | cg), beside the
card's bound per iteration, the per-call floor, the final cost and the
peak device memory.  The problem is the JAX script's ring world:
keyframes on a radius-3 circle looking into an annulus of landmarks, 6
observations per point, 0.5 px pixel noise and 0.02 noise on points and
camera centres, so the LM iterations do real work.

ms/iter is the difference of two warmed calls of 4 and 14 iterations over
10, which cancels the per-call cost; `torch.cuda.synchronize()` and the
points' read-back end each timed call.  A case that fails (out of memory,
say) is recorded with its error, not skipped.

    python3 scripts/torch_ba_city_bench.py --out DIR            (card)
    python3 scripts/torch_ba_city_bench.py --trace --out DIR
    python3 scripts/torch_ba_city_bench.py --device cpu --cases 64 --out DIR
                                   (the method at 64 KF, no times of the
                                    card)

On the card it also times G's placement (flat, grid scatter, grid
onehot at 64 KF) apart from the G G^T product, on each size's own
structure.  Writes <out>/torch_ba_city_bench.json; with --trace also a
device trace (utils/profiling) of the largest case, dense, in each
layout and of the 256 KF grid CG case, and their top 15 device ops.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 rate and float32 outside
# the tensor cores (the solver runs with TF32 off)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
I_LO, I_HI = 4, 14
CG_ITERS = 48
CASES = {64: 8192, 256: 16384, 512: 24576}
# (K, solver, layout, placement) per case size: all five at local-BA
# scale; flat and grid-scatter at 256 KF; dense at 512 KF, where the
# TPU's flat layout failed to lower
VARIANTS = {
    64: (("dense", "flat", "scatter"), ("cg", "flat", "scatter"),
         ("dense", "grid", "scatter"), ("dense", "grid", "onehot"),
         ("cg", "grid", "scatter")),
    256: (("dense", "flat", "scatter"), ("cg", "flat", "scatter"),
          ("dense", "grid", "scatter"), ("cg", "grid", "scatter")),
    512: (("dense", "flat", "scatter"), ("dense", "grid", "scatter")),
}


def ring_world(rng, K, P, obs_per_pt=6, noise=0.02):
    """The ring world as numpy arrays (the JAX script's make_problem): the
    true rotations, the noisy camera translations and points, and the
    flat observation list (cam, pt, uv, valid)."""
    center = np.array([3.0, 0.0, 0.0], np.float32)
    th_k = np.linspace(0, 2 * np.pi, K, endpoint=False)
    C = np.stack([3 * (1 - np.cos(th_k)), np.zeros(K), 3 * np.sin(th_k)],
                 1).astype(np.float32)
    Rs, ts = [], []
    for k in range(K):
        tangent = np.array([np.sin(th_k[k]), 0, np.cos(th_k[k])],
                           np.float32)
        to_c = center - C[k]
        to_c = to_c / max(np.linalg.norm(to_c), 1e-6)
        f = tangent + 0.8 * to_c
        f /= np.linalg.norm(f)
        d = np.array([0.0, 1.0, 0.0], np.float32)
        r = np.cross(d, f)
        r /= np.linalg.norm(r)
        R = np.stack([r, d, f], 1).astype(np.float32).T
        Rs.append(R)
        ts.append(-R @ C[k])
    Rs, ts = np.stack(Rs), np.stack(ts)

    th_p = rng.uniform(0, 2 * np.pi, P)
    r_p = np.sqrt(rng.uniform(4.0, 36.0, P))
    X = np.stack([center[0] + r_p * np.sin(th_p), rng.uniform(-2, 2, P),
                  center[2] + r_p * np.cos(th_p)], 1).astype(np.float32)

    # for each point, the obs_per_pt keyframes where its projection lands
    # in the image with positive depth (visible ones ranked first)
    fx = fy = 500.0
    cx, cy = 320.0, 240.0
    xc_all = np.einsum("kij,pj->pki", Rs, X) + ts[None, :, :]   # [P, K, 3]
    z_all = xc_all[:, :, 2]
    u_all = fx * xc_all[:, :, 0] / np.maximum(z_all, 1e-6) + cx
    v_all = fy * xc_all[:, :, 1] / np.maximum(z_all, 1e-6) + cy
    vis = ((z_all > 0.5) & (u_all > 0) & (u_all < 640)
           & (v_all > 0) & (v_all < 480))
    order = np.argsort(~vis, axis=1, kind="stable")[:, :obs_per_pt]
    rowsel = np.arange(P)[:, None]
    cam = order.reshape(-1)
    pt = np.repeat(np.arange(P), obs_per_pt)
    valid = vis[rowsel, order].reshape(-1)
    uv = np.stack([u_all[rowsel, order].reshape(-1),
                   v_all[rowsel, order].reshape(-1)], 1)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    Xn = X + rng.normal(0, noise, X.shape).astype(np.float32)
    tn = ts + rng.normal(0, noise, ts.shape).astype(np.float32)
    return dict(R=Rs, t=tn, X=Xn, cam=cam, pt=pt, uv=uv, valid=valid)


def to_grid(w, K):
    """The valid observations as the camera-major [K, N] table (N = pow2
    of the largest per-camera count, at least 4), each camera's in flat
    order."""
    cam, pt, uv = w["cam"][w["valid"]], w["pt"][w["valid"]], w["uv"][
        w["valid"]]
    counts = np.bincount(cam, minlength=K)
    N = 1 << int(np.ceil(np.log2(max(int(counts.max()), 4))))
    order = np.argsort(cam, kind="stable")
    k = cam[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(k)) - starts[k]
    pt_g = np.zeros((K, N), np.int64)
    uv_g = np.zeros((K, N, 2), np.float32)
    val_g = np.zeros((K, N), bool)
    pt_g[k, slot] = pt[order]
    uv_g[k, slot] = uv[order]
    val_g[k, slot] = True
    return pt_g, uv_g, val_g


def make_problem(rng, K, P, device, layout="flat"):
    """The ring world's BA problem as tensors on `device`: (Rs, ts, Xs,
    fixed, edges, cam, n_obs); keyframe 0 is the gauge."""
    import torch
    from orb_slam_tpu_torch.config import CameraConfig
    from orb_slam_tpu_torch.geometry.camera import make_camera
    from orb_slam_tpu_torch.solvers.bundle_adjust import BAEdges
    w = ring_world(rng, K, P)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if layout == "grid":
        pt_g, uv_g, val_g = to_grid(w, K)
        edges = BAEdges(cam_idx=None, pt_idx=dev(pt_g), uv=dev(uv_g),
                        inv_sigma2=dev(np.ones(val_g.shape, np.float32)),
                        valid=dev(val_g))
    else:
        edges = BAEdges(cam_idx=dev(w["cam"].astype(np.int64)),
                        pt_idx=dev(w["pt"].astype(np.int64)),
                        uv=dev(w["uv"]),
                        inv_sigma2=dev(np.ones(len(w["cam"]), np.float32)),
                        valid=dev(w["valid"]))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    cam = make_camera(CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                                   k1=0, k2=0, p1=0, p2=0, k3=0, width=640,
                                   height=480), device=device)
    return (dev(w["R"]), dev(w["t"]), dev(w["X"]), dev(fixed), edges, cam,
            int(w["valid"].sum()))


def solve(problem, solver, placement, iters, cg_iters=CG_ITERS):
    """One global-BA call (two_phase=False) of `iters` robust iterations."""
    from orb_slam_tpu_torch.config import SolverConfig
    from orb_slam_tpu_torch.solvers import bundle_adjust as ba
    Rs, ts, Xs, fixed, edges, cam, _ = problem
    return ba.bundle_adjust(Rs, ts, Xs, fixed, edges, cam,
                            cfg=SolverConfig(global_ba_iters=iters),
                            two_phase=False, solver=solver,
                            cg_iters=cg_iters, placement=placement)


def speed_of_light(K, P, solver, cg_iters=CG_ITERS):
    """The card's least ms per LM iteration for the half-matrix
    formulation (S = Hcc - G G^T, G [6K, 3P] float32) and what bounds it.
    dense: the G G^T product and the [6K, 6K] factorization in float32
    against three passes over G (placement, two reads); cg: two passes
    over G per CG step."""
    g_bytes = (6 * K) * (3 * P) * 4.0
    if solver == "dense":
        t_ops = (2.0 * (3 * P) * (6 * K) ** 2 + (6 * K) ** 3 / 3.0) \
            / FP32_OPS_PER_S
        t_bytes = 3 * g_bytes / HBM_BYTES_PER_S
    else:
        t_ops = 0.0
        t_bytes = cg_iters * 2 * g_bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_case(K, P, solver, layout, placement, device, reps=3, seed=0,
              i_lo=I_LO, i_hi=I_HI):
    """ms per LM iteration from two warmed iteration counts: (t_hi -
    t_lo) / (i_hi - i_lo) cancels the per-call cost (upload excluded,
    points' read-back included), reported as the floor.  Each call gets a
    fresh draw of the world's noise from one seeded generator, so every
    variant at one size solves the same sequence of problems."""
    import torch
    rng = np.random.default_rng(seed)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def run(iters):
        problem = make_problem(rng, K, P, device, layout=layout)
        sync()
        t0 = time.perf_counter()
        res = solve(problem, solver, placement, iters)
        sync()
        res.points.cpu()
        return time.perf_counter() - t0, res, problem[-1]

    run(i_lo)
    run(i_hi)                                    # warm both counts
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    lo = [run(i_lo) for _ in range(reps)]
    hi = [run(i_hi) for _ in range(reps)]
    t_lo = min(r[0] for r in lo)
    t_hi = min(r[0] for r in hi)
    res, n_obs = hi[-1][1], hi[-1][2]
    ms_per_iter = (t_hi - t_lo) / (i_hi - i_lo) * 1e3
    sol, bound_by = speed_of_light(K, P, solver)
    return dict(
        K=K, P=P, n_obs=n_obs, solver=solver, layout=layout,
        placement=placement if layout == "grid" else None,
        iters=[i_lo, i_hi], reps=reps, wall_lo_s=t_lo, wall_hi_s=t_hi,
        ms_per_iter=ms_per_iter, valid=bool(ms_per_iter > 0),
        per_call_floor_s=t_lo, final_cost=float(res.cost),
        peak_mem_bytes=(int(torch.cuda.max_memory_allocated()) if cuda
                        else None),
        speed_of_light_ms=sol, bound_by=bound_by,
        # the card's bound over a time of the card only
        share_of_bound=(sol / ms_per_iter if cuda and ms_per_iter > 0
                        else None),
        device=device)


def run_case(K, solver, layout, placement, device, reps):
    """time_case, with a failure recorded in place of the numbers."""
    import torch
    try:
        return time_case(K, CASES[K], solver, layout, placement, device,
                         reps=reps)
    except (RuntimeError, ValueError) as e:   # OOM is a RuntimeError
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        sol, bound_by = speed_of_light(K, CASES[K], solver)
        return dict(K=K, P=CASES[K], solver=solver, layout=layout,
                    placement=placement if layout == "grid" else None,
                    valid=False, error=repr(e)[:400], speed_of_light_ms=sol,
                    bound_by=bound_by, device=device)


def trace_case(K, solver, layout, placement, device, iters=10):
    """A device trace of one warmed call and its top 15 device ops.  The
    trace itself (tens of MB) goes to a temporary directory and is
    dropped once summed."""
    import tempfile
    import torch
    from orb_slam_tpu_torch.utils.profiling import device_trace, top_ops
    rng = np.random.default_rng(7)
    problem = make_problem(rng, K, CASES[K], device, layout=layout)
    solve(problem, solver, placement, iters).points.cpu()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as log_dir:
        with device_trace(log_dir, device=device):
            solve(problem, solver, placement, iters).points.cpu()
        ops = top_ops(log_dir)
    return dict(K=K, P=CASES[K], solver=solver, layout=layout,
                placement=placement, iters=iters,
                device_ms_total=sum(d for d, _ in ops),
                top_ops_ms=[[d, n[:160]] for d, n in ops[:15]])


def event_ms(fn, reps=10):
    """Device ms per call of fn: CUDA events around `reps` calls after two
    warm-up calls."""
    import torch
    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def placement_case(K, device):
    """The half-matrix's two costs apart, on the case's own (camera,
    point) structure with random blocks: G's placement in each layout and
    placement, and the G G^T product of the dense solve (device ms per
    call, CUDA events, TF32 off), with the grid's slot occupancy."""
    import torch
    from orb_slam_tpu_torch.device import true_fp32
    from orb_slam_tpu_torch.solvers import bundle_adjust as ba
    P = CASES[K]
    w = ring_world(np.random.default_rng(3), K, P)
    pt_g, _, val_g = to_grid(w, K)
    gen = torch.Generator(device=device).manual_seed(3)
    pt = torch.from_numpy(pt_g).to(device)
    valid = torch.from_numpy(val_g).to(device)
    blk_g = torch.randn(pt.shape + (6, 3), generator=gen, device=device) \
        * valid[..., None, None]
    live = w["valid"]
    cam_f = torch.from_numpy(w["cam"][live].astype(np.int64)).to(device)
    pt_f = torch.from_numpy(w["pt"][live].astype(np.int64)).to(device)
    blk_f = torch.randn((len(cam_f), 6, 3), generator=gen, device=device)
    out = dict(K=K, P=P, grid_slots=int(val_g.size),
               grid_occupancy=float(val_g.mean()), edges=int(live.sum()),
               g_bytes=6 * K * 3 * P * 4)
    with true_fp32():
        out["flat_place_ms"] = event_ms(
            lambda: ba._place_flat(blk_f, cam_f, pt_f, K, P))
        out["grid_scatter_place_ms"] = event_ms(
            lambda: ba._place_grid(blk_g, pt, P, "scatter"))
        if K <= 64:
            out["grid_onehot_place_ms"] = event_ms(
                lambda: ba._place_grid(blk_g, pt, P, "onehot"))
        G = ba._place_grid(blk_g, pt, P, "scatter")
        out["g_gt_product_ms"] = event_ms(lambda: G @ G.T)
    return out


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    import torch
    from orb_slam_tpu_torch.device import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: a CPU run checks the "
                         "method and measures nothing of the card")
    ap.add_argument("--cases", default="64,256,512",
                    help="comma-separated keyframe counts of CASES")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--out", required=True,
                    help="directory for torch_ba_city_bench.json")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    cuda = dev.type == "cuda"
    card = gpu_line() if cuda else None
    results = dict(
        device=dict(type=dev.type, name=(torch.cuda.get_device_name(dev)
                                         if cuda else "cpu"),
                    nvidia_smi=card),
        torch=torch.__version__, cuda=torch.version.cuda,
        method=dict(iters=[I_LO, I_HI], reps=args.reps, cg_iters=CG_ITERS,
                    hbm_bytes_per_s=HBM_BYTES_PER_S,
                    fp32_ops_per_s=FP32_OPS_PER_S, tf32=False),
        cases=[])
    print(f"# {card or 'cpu: no time of the card'}", flush=True)
    for K in (int(k) for k in args.cases.split(",")):
        for solver, layout, placement in VARIANTS[K]:
            r = run_case(K, solver, layout, placement, str(dev), args.reps)
            results["cases"].append(r)
            print(json.dumps(r), flush=True)
    if cuda:
        results["placement"] = [placement_case(int(k), str(dev))
                                for k in args.cases.split(",")]
        for r in results["placement"]:
            print(json.dumps(r), flush=True)
    if args.trace and cuda:
        largest = max(int(k) for k in args.cases.split(","))
        results["traces"] = [
            trace_case(largest, "dense", layout, "scatter", str(dev))
            for layout in ("flat", "grid")]
        results["traces"].append(
            trace_case(256, "cg", "grid", "scatter", str(dev)))
        for t in results["traces"]:
            log = [f"{d:10.3f} ms  {n}" for d, n in t["top_ops_ms"]]
            print(f"# trace {t['K']} KF {t['layout']}/{t['solver']}: "
                  f"{t['device_ms_total']:.3f} ms of device work\n"
                  + "\n".join(log), flush=True)
    path = os.path.join(args.out, "torch_ba_city_bench.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"# wrote {path}", flush=True)
    if card:
        print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
