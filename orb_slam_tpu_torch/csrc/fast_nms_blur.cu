// FAST-9 score + 3x3 NMS + border mask + 7x7 Gaussian blur over a padded
// pyramid stack, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel orb_slam_tpu/ops/fast_pallas.py
// (fast_nms_blur_stack, body _detect_tile).  It computes the plain function
// of orb_slam_tpu_torch/ops/fast_cuda.py::fast_nms_blur_plain, which is the
// JAX package's XLA path (fast.fast_score -> fast.nms3x3 -> interior mask,
// patches.gaussian_blur7): unlike the Pallas kernel, the blur reflects
// (reflect-101) at the edges of the padded canvas instead of clamping at
// tile seams, so kernel and plain version agree to the last bit.
//
// Design.  One CTA per (level, 32x32 output tile): 8 x 15 x 20 = 2400 CTAs
// at 640x480 x 8 levels.  The CTA stages its tile plus a 4-px halo (3 for
// the FAST circle and the blur taps, 1 for the NMS ring) in shared memory,
// 40x40 floats, reflecting rows and columns that fall off the canvas.  It
// scores the tile plus a 1-px ring, so the NMS reads only shared memory,
// then runs both blur passes from the same staged tile.  Every input byte
// is read from device memory once (plus the halo) and every output byte
// written once.
//
// Bound on the H100.  At [8, 480, 640] f32 the kernel reads 9.8 MB and
// writes 19.7 MB: 8.8 us at 3.35 TB/s.  The arithmetic is ~210 float32
// operations per pixel (16 differences, a log-step window-9 min and max
// chain over the 16 circle starts, 8 NMS compares, 26 blur operations),
// 0.52 GOP, 7.7 us at 67 TFLOP/s: the two bounds are close.  Only 39% of
// the padded stack is true pyramid (sum of 1.2^-2l over 8 levels is 3.10
// level-0 areas out of 8); skipping all-padding tiles is left for later.
//
// Built with --fmad=false and written with __fmul_rn/__fadd_rn: the blur
// sums its 7 taps left to right, vertical pass then horizontal, as the
// plain version does, with no fused multiply-adds.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 4;
constexpr int SPAN = TILE + 2 * HALO;  // 40: staged tile with halo
constexpr int RING = TILE + 2;         // 34: scores on the tile + 1-px ring
constexpr int BCOLS = TILE + 6;        // 38: columns of the vertical pass

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

// FAST-9 score of the staged pixel (r, c): the max over the 16 arc starts of
// the min margin over 9 contiguous circle pixels, bright (p - c) or dark
// (c - p); 0 unless above threshold.
__device__ __forceinline__ float fast9(const float (*img)[SPAN + 1], int r,
                                       int c, float threshold) {
  // OpenCV's Bresenham circle of radius 3, clockwise from 12 o'clock
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const float center = img[r][c];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = img[r + kDy[k]][c + kDx[k]] - center;
  // window minima (bright) and maxima (dark: min of -d is -max of d)
  float lo[16], hi[16], lo2[16], hi2[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo[i] = fminf(d[i], d[(i + 1) & 15]);
    hi[i] = fmaxf(d[i], d[(i + 1) & 15]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo2[i] = fminf(lo[i], lo[(i + 2) & 15]);
    hi2[i] = fmaxf(hi[i], hi[(i + 2) & 15]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo[i] = fminf(lo2[i], lo2[(i + 4) & 15]);
    hi[i] = fmaxf(hi2[i], hi2[(i + 4) & 15]);
  }
  float bright = -INFINITY, dark_neg = INFINITY;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    bright = fmaxf(bright, fminf(lo[i], d[(i + 8) & 15]));
    dark_neg = fminf(dark_neg, fmaxf(hi[i], d[(i + 8) & 15]));
  }
  const float score = fmaxf(bright, -dark_neg);
  return score > threshold ? score : 0.0f;
}

__global__ void __launch_bounds__(TILE * TILE)
fast_nms_blur_kernel(const float* __restrict__ stack,
                     const int* __restrict__ dims,
                     const float* __restrict__ taps,
                     float* __restrict__ score_out,
                     float* __restrict__ blur_out, int H, int W,
                     float threshold, int border) {
  __shared__ float img[SPAN][SPAN + 1];
  __shared__ float sc[RING][RING + 1];
  __shared__ float vb[TILE][BCOLS + 1];

  const int lvl = blockIdx.z;
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TILE + tx;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* im = stack + lvl * plane;

  // stage tile + halo; rows/columns off the canvas are reflected (blur)
  for (int i = tid; i < SPAN * SPAN; i += TILE * TILE) {
    const int r = i / SPAN;
    const int c = i % SPAN;
    const int gy = reflect101(y0 - HALO + r, H);
    const int gx = reflect101(x0 - HALO + c, W);
    img[r][c] = im[static_cast<size_t>(gy) * W + gx];
  }
  __syncthreads();

  // FAST on the tile + 1-px ring: 0 within 3 px of the canvas edge (the
  // plain version's roll wraps there), -inf off the canvas (NMS padding)
  for (int i = tid; i < RING * RING; i += TILE * TILE) {
    const int r = i / RING;
    const int c = i % RING;
    const int gy = y0 - 1 + r;
    const int gx = x0 - 1 + c;
    float s;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
      s = -INFINITY;
    } else if (gy < 3 || gy >= H - 3 || gx < 3 || gx >= W - 3) {
      s = 0.0f;
    } else {
      s = fast9(img, r + HALO - 1, c + HALO - 1, threshold);
    }
    sc[r][c] = s;
  }

  float k[7];
#pragma unroll
  for (int j = 0; j < 7; ++j) k[j] = taps[j];

  // vertical blur pass: the tile's rows, columns x0-3 .. x0+TILE+2
  for (int i = tid; i < TILE * BCOLS; i += TILE * TILE) {
    const int r = i / BCOLS;
    const int c = i % BCOLS;
    float acc = __fmul_rn(k[0], img[r + HALO - 3][c + 1]);
#pragma unroll
    for (int j = 1; j < 7; ++j)
      acc = __fadd_rn(acc, __fmul_rn(k[j], img[r + HALO - 3 + j][c + 1]));
    vb[r][c] = acc;
  }
  __syncthreads();

  const int gy = y0 + ty;
  const int gx = x0 + tx;
  if (gy >= H || gx >= W) return;
  const size_t o = lvl * plane + static_cast<size_t>(gy) * W + gx;

  // 3x3 NMS: strict against earlier raster neighbours, >= against later
  const float s = sc[ty + 1][tx + 1];
  bool is_max = true;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const float n = sc[ty + 1 + dy][tx + 1 + dx];
      const bool earlier = dy < 0 || (dy == 0 && dx < 0);
      is_max = is_max && (earlier ? (s > n) : (s >= n));
    }
  }
  const int lh = dims[2 * lvl];
  const int lw = dims[2 * lvl + 1];
  const bool inside = gy >= border && gy < lh - border && gx >= border &&
                      gx < lw - border;
  score_out[o] = (is_max && inside) ? s : 0.0f;

  // horizontal blur pass
  float acc = __fmul_rn(k[0], vb[ty][tx]);
#pragma unroll
  for (int j = 1; j < 7; ++j) acc = __fadd_rn(acc, __fmul_rn(k[j], vb[ty][tx + j]));
  blur_out[o] = acc;
}

}  // namespace

// stack, score, blur: [L, H, W] float32; dims: [L, 2] int32 true (h, w);
// taps: [7] float32 Gaussian taps.  Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int fast_nms_blur_launch(const float* stack, const int* dims,
                                    const float* taps, float* score,
                                    float* blur, int L, int H, int W,
                                    float threshold, int border,
                                    void* stream) {
  const dim3 block(TILE, TILE);
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, L);
  fast_nms_blur_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      stack, dims, taps, score, blur, H, W, threshold, border);
  return static_cast<int>(cudaGetLastError());
}
