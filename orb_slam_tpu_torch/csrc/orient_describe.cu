// Intensity-centroid orientation + steered BRIEF for every live keypoint of
// the pyramid, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel orb_slam_tpu/ops/describe_pallas.py
// (orient_describe, body _kernel), and computes the plain function of
// orb_slam_tpu_torch/ops/describe_cuda.py::orient_describe_plain.  The TPU
// kernel turned every gather into one-hot MXU matmuls over VMEM-resident
// levels; on Hopper a warp gathers directly from device memory and L2.
//
// Design.  One warp per (level, slot); a block holds 4 warps, the grid is
// ceil(cap / 4) x L, a single wave on the H100 at the main path's
// [8, 217] slots.  The time is therefore one warp's chain of dependent
// waits, and the kernel is laid out to keep that chain at three memory
// round trips:
//   1. the slot's inputs (count, keypoint, level size) and this lane's 8
//      BRIEF pairs, all issued together; the pattern is a device tensor,
//      [2, 256, 2] (p points, then q points), read with coalesced 8-byte
//      loads (lane b of word w takes pair 32w+b);
//   2. the moments: lane dx takes one column of the 31x31 window and walks
//      its 31 rows, fully unrolled, each load predicated on the radius-15
//      circle (|dx| <= umax(dy)) and clamped to the level's true extent;
//      all 31 loads are issued before the first sum.  A shuffle reduction
//      sums the lanes, so every lane steers with the same cos/sin =
//      m10/|m|, m01/|m| ((1, 0) when |m| is 0);
//   3. the 16 BRIEF samples of this lane: every steered, rounded (rintf:
//      half to even, like torch.round) and clamped address first, then the
//      16 loads from the blurred level, then 8 ballots; bit b of word w
//      holds pair 32w+b, and lane w stores word w.
// Slots at or past counts[level] write exact zeros and return after step 1.
//
// Bound on the H100.  The work depends on the data: per live keypoint 709
// raw taps and up to 512 blurred samples, ~1000 live keypoints on the
// main path touching ~2.9 MB of distinct pixels (0.9 us at 3.35 TB/s), and
// ~5 MFLOP.  No single-wave kernel gets near that: three dependent round
// trips to L2 / device memory per warp (~1 us each) plus the launch set
// what it can reach, ~3-6 us.
//
// Rounding.  The moments are sums of integer-valued products below 2^24
// (the pyramid is quantized to integers), exact in float32 in any order.
// The steered coordinates px*ca - py*sa + fx are written with __fmul_rn /
// __fsub_rn / __fadd_rn and the file is built with --fmad=false, because a
// contracted FMA moves .5 rounding cases; the kernel then takes the same
// roundings as the plain version and matches it bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int HALF = 15;
constexpr int PAIRS = 256;

__device__ __forceinline__ size_t steered(float2 pt, float ca, float sa,
                                          float fx, float fy, int lw, int lh,
                                          int W) {
  const float gx = rintf(__fadd_rn(
      __fsub_rn(__fmul_rn(pt.x, ca), __fmul_rn(pt.y, sa)), fx));
  const float gy = rintf(__fadd_rn(
      __fadd_rn(__fmul_rn(pt.x, sa), __fmul_rn(pt.y, ca)), fy));
  const int x = min(max(static_cast<int>(gx), 0), lw - 1);
  const int y = min(max(static_cast<int>(gy), 0), lh - 1);
  return static_cast<size_t>(y) * W + x;
}

__global__ void __launch_bounds__(32 * WARPS)
orient_describe_kernel(const float* __restrict__ stack,
                       const float* __restrict__ blurred,
                       const float* __restrict__ kp_xy,
                       const int* __restrict__ dims,
                       const int* __restrict__ counts,
                       const float2* __restrict__ pattern,
                       float* __restrict__ m01_out,
                       float* __restrict__ m10_out,
                       int* __restrict__ desc_out, int H, int W, int cap) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lvl = blockIdx.y;
  if (slot >= cap) return;
  const size_t o = static_cast<size_t>(lvl) * cap + slot;

  // 1. the slot's inputs and this lane's pattern pairs, issued together
  const int count = __ldg(counts + lvl);
  const float fx = __ldg(kp_xy + 2 * o);
  const float fy = __ldg(kp_xy + 2 * o + 1);
  const int lh = __ldg(dims + 2 * lvl);
  const int lw = __ldg(dims + 2 * lvl + 1);
  float2 pp[8], qq[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    pp[w] = __ldg(pattern + 32 * w + lane);
    qq[w] = __ldg(pattern + PAIRS + 32 * w + lane);
  }
  if (slot >= count) {
    if (lane == 0) {
      m01_out[o] = 0.0f;
      m10_out[o] = 0.0f;
    }
    if (lane < 8) desc_out[o * 8 + lane] = 0;
    return;
  }

  const size_t plane = static_cast<size_t>(H) * W;
  const float* raw = stack + lvl * plane;
  const float* blr = blurred + lvl * plane;
  const int cx = static_cast<int>(rintf(fx));
  const int cy = static_cast<int>(rintf(fy));

  // 2. moments: lane dx owns column cx + dx of the window (lane 31 none)
  const int dx = lane - HALF;
  const int x = min(max(cx + dx, 0), lw - 1);
  float v[2 * HALF + 1];
#pragma unroll
  for (int r = 0; r < 2 * HALF + 1; ++r) {
    const int dy = r - HALF;
    const int y = min(max(cy + dy, 0), lh - 1);
    v[r] = dx * dx <= HALF * HALF - dy * dy
               ? __ldg(raw + static_cast<size_t>(y) * W + x) : 0.0f;
  }
  float col = 0.0f;
  float m01 = 0.0f;
#pragma unroll
  for (int r = 0; r < 2 * HALF + 1; ++r) {
    col = __fadd_rn(col, v[r]);
    m01 = __fadd_rn(m01, __fmul_rn(static_cast<float>(r - HALF), v[r]));
  }
  float m10 = __fmul_rn(static_cast<float>(dx), col);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 = __fadd_rn(m10, __shfl_xor_sync(full, m10, off));
    m01 = __fadd_rn(m01, __shfl_xor_sync(full, m01, off));
  }

  const float hyp =
      __fsqrt_rn(__fadd_rn(__fmul_rn(m10, m10), __fmul_rn(m01, m01)));
  const float ca = hyp > 0.0f ? __fdiv_rn(m10, hyp) : 1.0f;
  const float sa = hyp > 0.0f ? __fdiv_rn(m01, hyp) : 0.0f;

  // 3. steered BRIEF: all 16 addresses, then all 16 loads, then 8 ballots
  size_t ap[8], aq[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    ap[w] = steered(pp[w], ca, sa, fx, fy, lw, lh, W);
    aq[w] = steered(qq[w], ca, sa, fx, fy, lw, lh, W);
  }
  float sp[8], sq[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    sp[w] = __ldg(blr + ap[w]);
    sq[w] = __ldg(blr + aq[w]);
  }
  unsigned mine = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const unsigned word = __ballot_sync(full, sp[w] < sq[w]);
    if (lane == w) mine = word;
  }
  if (lane < 8) desc_out[o * 8 + lane] = static_cast<int>(mine);
  if (lane == 0) {
    m01_out[o] = m01;
    m10_out[o] = m10;
  }
}

}  // namespace

// stack, blurred: [L, H, W] float32; kp_xy: [L, cap, 2] float32 level-local
// pixels; dims: [L, 2] int32 true (h, w); counts: [L] int32 live slots per
// level (a prefix); pattern: [2, 256, 2] float32 BRIEF end points (p of
// every pair, then q), 8-byte aligned.  Outputs m01, m10: [L, cap] float32;
// desc: [L, cap, 8] int32.  Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int orient_describe_launch(const float* stack,
                                      const float* blurred,
                                      const float* kp_xy, const int* dims,
                                      const int* counts, const float* pattern,
                                      float* m01, float* m10, int* desc,
                                      int L, int H, int W, int cap,
                                      void* stream) {
  if (L == 0 || cap == 0) return 0;
  const dim3 grid((cap + WARPS - 1) / WARPS, L);
  orient_describe_kernel<<<grid, 32 * WARPS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      stack, blurred, kp_xy, dims, counts,
      reinterpret_cast<const float2*>(pattern), m01, m10, desc, H, W, cap);
  return static_cast<int>(cudaGetLastError());
}
