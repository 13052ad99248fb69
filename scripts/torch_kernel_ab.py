#!/usr/bin/env python3
"""Time the port's two CUDA kernels against other builds of them, in turns,
on one GPU.

    python3 scripts/torch_kernel_ab.py [--old DIR] [--out DIR]

Builds, one nvcc each and all at once, with the package's own flags:
  * csrc/fast_nms_blur.cu as shipped and copies of it with other tile
    shapes or CTAs per SM (VARIANTS: the constants rewritten in the text);
  * csrc/orient_describe.cu as shipped;
  * with --old DIR, both kernels from DIR/orb_slam_tpu_torch/csrc (another
    checkout of the repo, e.g. the parent commit unpacked by git archive),
    called through that version's C interface.
Prints each build's register, shared-memory and spill lines.

On the inputs of chip_smoke.py's phases 3 and 4 (the main path's first
640x480 frame: an [8, 480, 640] stack and its [8, 217] keypoint slots),
every build is first held against the plain PyTorch version (kernel 1 bit
for bit, kernel 2's moments bit for bit and descriptors equal), then timed
with chip_smoke.time_ms (a replayed CUDA graph of 20 calls) in turns:
plain, old, new..., new... reversed, old.  Warm times leave the inputs in
the 50 MB L2 between calls; the cold time of each build flushes L2 with a
64 MB write before every call and subtracts the flush's own time.

Prints a summary and, with --out DIR, writes DIR/torch_kernel_ab.json.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# tag -> {shipped line: its replacement} in csrc/fast_nms_blur.cu
VARIANTS = {
    "fnb_64x32": {"constexpr int TW = 32;": "constexpr int TW = 64;"},
    "fnb_32x64": {"constexpr int TH = 32;": "constexpr int TH = 64;"},
    "fnb_6ctas": {"constexpr int MIN_CTAS = 4;":
                  "constexpr int MIN_CTAS = 6;"},
}
FLUSH_BYTES = 64 << 20


def variant_sources(src, variants, out_dir):
    """Write a copy of `src` per variant, each {line: replacement} applied
    to its text, into out_dir.  Returns {tag: path}."""
    with open(src) as f:
        text = f.read()
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for tag, subs in variants.items():
        body = text
        for old, new in subs.items():
            if body.count(old) != 1:
                raise RuntimeError(f"{tag}: {old!r} is not once in {src}")
            body = body.replace(old, new)
        paths[tag] = os.path.join(out_dir, f"{tag}.cu")
        with open(paths[tag], "w") as f:
            f.write(body)
    return paths


def build_all(jobs, build_dir):
    """jobs: {tag: source path} -> {tag: (CDLL, ptxas)}, one nvcc each
    with the package's flags, all started together."""
    from orb_slam_tpu_torch import _build
    os.makedirs(build_dir, exist_ok=True)
    procs = {}
    for tag, src in jobs.items():
        out = os.path.join(build_dir, f"{tag}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, src]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      out)
    libs = {}
    for tag, (p, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {tag} failed:\n{log}")
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"# {tag}: " + " | ".join(lines), flush=True)
        libs[tag] = (ctypes.CDLL(out), _build.parse_ptxas(log))
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", default=None,
                    help="root of another checkout whose kernels to time")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from orb_slam_tpu_torch import _build
    from orb_slam_tpu_torch.device import resolve_device
    from orb_slam_tpu_torch.ops import describe_cuda, fast_cuda, patches

    card = chip_smoke.gpu_line()
    print(f"# {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    dev = resolve_device("cuda")
    build_dir = os.path.join(_build.BUILD_DIR, "ab")
    jobs = {"fnb_new": os.path.join(_build.CSRC, "fast_nms_blur.cu")}
    jobs.update(variant_sources(jobs["fnb_new"], VARIANTS, build_dir))
    jobs["od_new"] = os.path.join(_build.CSRC, "orient_describe.cu")
    if args.old:
        old = os.path.join(args.old, "orb_slam_tpu_torch", "csrc")
        jobs["fnb_old"] = os.path.join(old, "fast_nms_blur.cu")
        jobs["od_old"] = os.path.join(old, "orient_describe.cu")
    libs = build_all(jobs, build_dir)

    _, det = chip_smoke.first_frame(dev)
    _, kw = chip_smoke.bench_configs()
    ext = kw["ext_cfg"]
    stack, dims = det.stack, det.dims
    L, H, W = stack.shape
    thr, border = float(ext.fast_threshold_min), ext.edge_threshold
    taps = patches.gaussian_taps_on(dev)
    kp_xy = det.kp.xy.contiguous()
    counts = det.valid.sum(dim=1).to(torch.int32)
    cap = kp_xy.shape[1]
    pattern = describe_cuda._consts(dev)[2]
    p, i = ctypes.c_void_p, ctypes.c_int

    def stream():
        return torch.cuda.current_stream().cuda_stream

    # kernel 1: every build has the same C interface
    score = torch.empty_like(stack)
    blur = torch.empty_like(stack)
    k1 = {}
    for tag, (lib, _) in libs.items():
        if not tag.startswith("fnb_"):
            continue
        fn = lib.fast_nms_blur_launch
        fn.argtypes = [p, p, p, p, p, i, i, i, ctypes.c_float, i, p]
        fn.restype = i
        k1[tag] = (lambda fn=fn: fn(
            stack.data_ptr(), dims.data_ptr(), taps.data_ptr(),
            score.data_ptr(), blur.data_ptr(), L, H, W, thr, border,
            stream()))

    # kernel 2: the new interface takes the pattern tensor, the old one a
    # __constant__ copy set once
    m01 = torch.empty((L, cap), dtype=torch.float32, device=dev)
    m10 = torch.empty_like(m01)
    desc = torch.empty((L, cap, 8), dtype=torch.int32, device=dev)
    common = (stack, det.blurred, kp_xy, dims, counts)
    k2 = {}
    fn = libs["od_new"][0].orient_describe_launch
    fn.argtypes = [p] * 9 + [i] * 4 + [p]
    fn.restype = i
    k2["od_new"] = (lambda fn=fn: fn(
        *(t.data_ptr() for t in common), pattern.data_ptr(), m01.data_ptr(),
        m10.data_ptr(), desc.data_ptr(), L, H, W, cap, stream()))
    if "od_old" in libs:
        lib = libs["od_old"][0]
        pts = np.ascontiguousarray(describe_cuda.brief._POINTS, np.float32)
        lib.orient_describe_set_pattern.argtypes = [p]
        if lib.orient_describe_set_pattern(pts.ctypes.data_as(p)) != 0:
            raise RuntimeError("old orient_describe_set_pattern failed")
        fn = lib.orient_describe_launch
        fn.argtypes = [p] * 8 + [i] * 4 + [p]
        fn.restype = i
        k2["od_old"] = (lambda fn=fn: fn(
            *(t.data_ptr() for t in common), m01.data_ptr(), m10.data_ptr(),
            desc.data_ptr(), L, H, W, cap, stream()))

    # every build against the plain version first
    ref1 = fast_cuda.fast_nms_blur_plain(stack, dims, thr, border)
    for tag, run in k1.items():
        assert run() == 0, tag
        torch.cuda.synchronize()
        if not (torch.equal(score, ref1[0]) and torch.equal(blur, ref1[1])):
            raise AssertionError(f"{tag} differs from the plain version")
    ref2 = describe_cuda.orient_describe_plain(*common)
    for tag, run in k2.items():
        assert run() == 0, tag
        torch.cuda.synchronize()
        if not (torch.equal(m01, ref2[0]) and torch.equal(m10, ref2[1])
                and torch.equal(desc, ref2[2])):
            raise AssertionError(f"{tag} differs from the plain version")
    print("# every build equals its plain version", flush=True)

    flush_buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def flush():
        flush_buf.fill_(1.0)

    def turns(named):
        """Warm ms of each (tag, fn) timed in the order given."""
        out = {}
        for tag, fn in named:
            out.setdefault(tag, []).append(chip_smoke.time_ms(fn))
        return out

    plain1 = lambda: fast_cuda.fast_nms_blur_plain(stack, dims, thr, border)
    plain2 = lambda: describe_cuda.orient_describe_plain(*common)
    order1 = ["fnb_old"] * ("fnb_old" in k1) + ["fnb_new", *VARIANTS]
    seq1 = ([("plain", plain1)] + [(t, k1[t]) for t in order1]
            + [(t, k1[t]) for t in reversed(order1)])
    order2 = ["od_old"] * ("od_old" in k2) + ["od_new"]
    seq2 = ([("plain", plain2)] + [(t, k2[t]) for t in order2]
            + [(t, k2[t]) for t in reversed(order2)])
    warm1, warm2 = turns(seq1), turns(seq2)
    flush_ms = chip_smoke.time_ms(flush)
    cold = {}
    for tag, fn in list(k1.items()) + list(k2.items()):
        cold[tag] = (chip_smoke.time_ms(lambda fn=fn: (flush(), fn()))
                     - flush_ms)

    result = {"card": card, "flush_ms": flush_ms, "kernels": {}}
    for tag in list(k1) + list(k2):
        warm = (warm1 if tag in k1 else warm2)[tag]
        result["kernels"][tag] = dict(warm_ms=warm, cold_ms=cold[tag],
                                      **libs[tag][1])
        print(f"{tag}: warm ms {' '.join(f'{t:.5f}' for t in warm)}; cold "
              f"{cold[tag]:.5f} ms; {libs[tag][1]}", flush=True)
    result["plain_ms"] = {"fast_nms_blur": warm1["plain"],
                          "orient_describe": warm2["plain"]}
    print(f"plain: fast_nms_blur {warm1['plain'][0]:.4f} ms, orient_describe "
          f"{warm2['plain'][0]:.4f} ms; L2 flush {flush_ms:.5f} ms")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "torch_kernel_ab.json"), "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
