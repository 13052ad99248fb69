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
// ceil(cap / 4) x L.  Slots at or past counts[level] write exact zeros and
// return.  Otherwise the 32 lanes stride over the 31x31 window of the raw
// level, adding the taps inside the radius-15 circle (clamped to the
// level's true extent) to the moments m10 = sum x I and m01 = sum y I; a
// shuffle reduction sums the lanes and lane 0's sum is broadcast, so every
// lane steers with the same cos/sin = m10/|m|, m01/|m| ((1, 0) when |m| is
// 0).  For word w, lane b takes BRIEF pair 32w+b: it rotates both end
// points, rounds them half to even (rintf, like torch.round), clamps them
// to [0, lw-1] x [0, lh-1], loads both samples from the blurred level and
// votes p < q; __ballot_sync packs the 32 votes into word w, so bit b of
// word w holds pair 32w+b.  The pattern lives in __constant__ memory.
//
// Bound on the H100.  The work depends on the data: per live keypoint 709
// raw taps and up to 512 blurred samples (~4.9 KB of gathers, mostly L2
// hits since neighbouring keypoints overlap), and ~5k float operations.  At
// ~1000 live keypoints that is ~5 MB of gathers, ~1.5 us at 3.35 TB/s, and
// 5 MFLOP: memory-latency bound, which 4 warps per block and ~450 blocks
// in flight hide.
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
constexpr int SIDE = 2 * HALF + 1;

// BRIEF end points: p of pair i at 2i, q at 2i+1 (x, y)
__constant__ float2 c_pattern[512];

__device__ __forceinline__ float sample(const float* __restrict__ blr,
                                        float2 pt, float ca, float sa,
                                        float fx, float fy, int lw, int lh,
                                        int W) {
  const float gx = rintf(__fadd_rn(
      __fsub_rn(__fmul_rn(pt.x, ca), __fmul_rn(pt.y, sa)), fx));
  const float gy = rintf(__fadd_rn(
      __fadd_rn(__fmul_rn(pt.x, sa), __fmul_rn(pt.y, ca)), fy));
  const int x = min(max(static_cast<int>(gx), 0), lw - 1);
  const int y = min(max(static_cast<int>(gy), 0), lh - 1);
  return blr[static_cast<size_t>(y) * W + x];
}

__global__ void __launch_bounds__(32 * WARPS)
orient_describe_kernel(const float* __restrict__ stack,
                       const float* __restrict__ blurred,
                       const float* __restrict__ kp_xy,
                       const int* __restrict__ dims,
                       const int* __restrict__ counts,
                       float* __restrict__ m01_out,
                       float* __restrict__ m10_out,
                       int* __restrict__ desc_out, int H, int W, int cap) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lvl = blockIdx.y;
  if (slot >= cap) return;
  const size_t o = static_cast<size_t>(lvl) * cap + slot;
  if (slot >= counts[lvl]) {
    if (lane == 0) {
      m01_out[o] = 0.0f;
      m10_out[o] = 0.0f;
    }
    if (lane < 8) desc_out[o * 8 + lane] = 0;
    return;
  }

  const int lh = dims[2 * lvl];
  const int lw = dims[2 * lvl + 1];
  const float fx = kp_xy[2 * o];
  const float fy = kp_xy[2 * o + 1];
  const int cx = static_cast<int>(rintf(fx));
  const int cy = static_cast<int>(rintf(fy));
  const size_t plane = static_cast<size_t>(H) * W;
  const float* raw = stack + lvl * plane;
  const float* blr = blurred + lvl * plane;

  float m10 = 0.0f;
  float m01 = 0.0f;
  for (int k = lane; k < SIDE * SIDE; k += 32) {
    const int dy = k / SIDE - HALF;
    const int dx = k % SIDE - HALF;
    if (dx * dx + dy * dy > HALF * HALF) continue;
    const int y = min(max(cy + dy, 0), lh - 1);
    const int x = min(max(cx + dx, 0), lw - 1);
    const float v = raw[static_cast<size_t>(y) * W + x];
    m10 = __fadd_rn(m10, __fmul_rn(static_cast<float>(dx), v));
    m01 = __fadd_rn(m01, __fmul_rn(static_cast<float>(dy), v));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 = __fadd_rn(m10, __shfl_xor_sync(full, m10, off));
    m01 = __fadd_rn(m01, __shfl_xor_sync(full, m01, off));
  }
  m10 = __shfl_sync(full, m10, 0);
  m01 = __shfl_sync(full, m01, 0);

  const float hyp =
      __fsqrt_rn(__fadd_rn(__fmul_rn(m10, m10), __fmul_rn(m01, m01)));
  const float ca = hyp > 0.0f ? __fdiv_rn(m10, hyp) : 1.0f;
  const float sa = hyp > 0.0f ? __fdiv_rn(m01, hyp) : 0.0f;

#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const int pair = 32 * w + lane;
    const float sp = sample(blr, c_pattern[2 * pair], ca, sa, fx, fy, lw, lh, W);
    const float sq =
        sample(blr, c_pattern[2 * pair + 1], ca, sa, fx, fy, lw, lh, W);
    const unsigned word = __ballot_sync(full, sp < sq);
    if (lane == 0) desc_out[o * 8 + w] = static_cast<int>(word);
  }
  if (lane == 0) {
    m01_out[o] = m01;
    m10_out[o] = m10;
  }
}

}  // namespace

// xy: [512, 2] float32 on the host, the BRIEF end points (p, q per pair).
extern "C" int orient_describe_set_pattern(const float* xy) {
  return static_cast<int>(
      cudaMemcpyToSymbol(c_pattern, xy, sizeof(float2) * 512));
}

// stack, blurred: [L, H, W] float32; kp_xy: [L, cap, 2] float32 level-local
// pixels; dims: [L, 2] int32 true (h, w); counts: [L] int32 live slots per
// level (a prefix).  Outputs m01, m10: [L, cap] float32; desc: [L, cap, 8]
// int32.  Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int orient_describe_launch(const float* stack,
                                      const float* blurred,
                                      const float* kp_xy, const int* dims,
                                      const int* counts, float* m01,
                                      float* m10, int* desc, int L, int H,
                                      int W, int cap, void* stream) {
  if (L == 0 || cap == 0) return 0;
  const dim3 grid((cap + WARPS - 1) / WARPS, L);
  orient_describe_kernel<<<grid, 32 * WARPS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      stack, blurred, kp_xy, dims, counts, m01, m10, desc, H, W, cap);
  return static_cast<int>(cudaGetLastError());
}
