#!/usr/bin/env python3
"""Where kernel 1's time goes (csrc/fast_nms_blur.cu), on one GPU, by
ablation.

    python3 scripts/torch_fast_breakdown.py [--out DIR]

Builds the shipped source and two copies cut down by text substitution:
  * no_fast:  the FAST score of each ring pixel replaced by the staged
              pixel itself, so staging, both blur passes, the NMS and the
              stores remain;
  * zero_all: every tile takes the all-padding path, so only the stores
              of the two [8, 480, 640] outputs remain.
The cut-down builds compute wrong outputs on purpose; they exist only to be
timed.  Each is timed with chip_smoke.time_ms on the main path's first
frame, in turns (shipped, no_fast, zero_all, zero_all, no_fast, shipped).
Differences estimate the cost of FAST (shipped - no_fast) and of staging,
blur and NMS (no_fast - zero_all).  Prints a summary and, with --out DIR,
writes DIR/torch_fast_breakdown.json.
"""
import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

CUTS = {
    "no_fast": {"s = fast9(&img[r + HALO - 1][c + HALO - 1], threshold);":
                "s = img[r + HALO - 1][c + HALO - 1];"},
    "zero_all": {"if (min_reflected(y0 - HALO, y0 + TH + HALO - 1, H) "
                 ">= lh ||": "if (true ||"},
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_fast_breakdown: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from torch_kernel_ab import build_all, variant_sources
    from orb_slam_tpu_torch import _build
    from orb_slam_tpu_torch.device import resolve_device
    from orb_slam_tpu_torch.ops import patches

    card = chip_smoke.gpu_line()
    print(f"# {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    dev = resolve_device("cuda")
    src = os.path.join(_build.CSRC, "fast_nms_blur.cu")
    out_dir = os.path.join(_build.BUILD_DIR, "breakdown")
    jobs = {"shipped": src, **variant_sources(src, CUTS, out_dir)}
    libs = build_all(jobs, out_dir)

    _, det = chip_smoke.first_frame(dev)
    _, kw = chip_smoke.bench_configs()
    ext = kw["ext_cfg"]
    stack, dims = det.stack, det.dims
    L, H, W = stack.shape
    taps = patches.gaussian_taps_on(dev)
    score, blur = torch.empty_like(stack), torch.empty_like(stack)
    p, i = ctypes.c_void_p, ctypes.c_int
    runs = {}
    for tag, (lib, _) in libs.items():
        fn = lib.fast_nms_blur_launch
        fn.argtypes = [p, p, p, p, p, i, i, i, ctypes.c_float, i, p]
        fn.restype = i
        runs[tag] = (lambda fn=fn: fn(
            stack.data_ptr(), dims.data_ptr(), taps.data_ptr(),
            score.data_ptr(), blur.data_ptr(), L, H, W,
            float(ext.fast_threshold_min), ext.edge_threshold,
            torch.cuda.current_stream().cuda_stream))
    order = list(runs) + list(reversed(runs))
    ms = {}
    for tag in order:
        ms.setdefault(tag, []).append(chip_smoke.time_ms(runs[tag]))
    for tag in runs:
        print(f"{tag}: ms {' '.join(f'{t:.5f}' for t in ms[tag])}; "
              f"{libs[tag][1]}", flush=True)
    mean = {t: sum(v) / len(v) for t, v in ms.items()}
    print(f"FAST {mean['shipped'] - mean['no_fast']:.5f} ms; staging, blur "
          f"and NMS {mean['no_fast'] - mean['zero_all']:.5f} ms; stores "
          f"alone {mean['zero_all']:.5f} ms")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "torch_fast_breakdown.json"),
                  "w") as f:
            json.dump({"card": card, "ms": ms,
                       "ptxas": {t: v[1] for t, v in libs.items()}}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
