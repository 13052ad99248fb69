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
// Precondition: the stack is zero outside each level's true (h, w) = dims.
// The pyramid builder guarantees it (extractor_batched._build_stack: the
// resize matrices' rows past h and w are zero), and it is what lets the
// kernel skip the padding below.
//
// Design.  One CTA of 256 threads per (level, 32 x 32 output tile),
// level-major, so the large levels' costly tiles start first and the small
// levels' cheap ones fill the last wave (interleaving the levels measured
// slower); three kinds of tile, decided from dims and the canvas alone:
//   * all padding: every row (or every column) the tile would stage, after
//     reflection at the canvas edge, lies at or past the level's true h (w).
//     By the precondition its score and blur are exact zeros: the CTA
//     writes them (16-byte stores) and returns before touching shared
//     memory.  At 640x480 x 8 levels this is 1402 of the 2400 32x32 tiles.
//   * interior: tile + 4-px halo inside the canvas.  It stages the halo
//     with 16-byte loads (x0 - 4 is a multiple of 4 floats; requires
//     W % 4 == 0 and 16-byte aligned pointers, else the edge path runs).
//   * edge: stages with scalar loads, reflecting rows and columns that fall
//     off the canvas.
// A staged tile is scored on the tile plus a 1-px ring (so the NMS reads
// only shared memory), but only at pixels the interior mask can keep: the
// NMS of an output in [border, h-border) reads scores in [border-1,
// h-border], the rest of the ring stays 0.  Both blur passes run from the
// same staged tile; each thread then finishes 4 neighbouring pixels of a
// row (NMS, border mask, horizontal pass) and stores them as one float4.
// 256-thread CTAs under __launch_bounds__(256, 4) put 4 CTAs on an SM, so
// one CTA's barrier or load wait is covered by another's arithmetic.  The
// tile shape and the CTAs per SM are the fastest of the builds that
// scripts/torch_kernel_ab.py times (32 x 32 against 64 x 32 and 32 x 64
// tiles, 4 against 6 CTAs per SM).
//
// Bound on the H100.  The work the output needs: the true pyramid read
// once (950,532 px, 3.8 MB at 640x480 x 8 levels) and both full outputs
// written once (19.7 MB): 23.5 MB, 7.0 us at 3.35 TB/s.  The arithmetic
// is ~146 float32 operations per true pixel (fast9 below: 16 differences,
// 94 min/max, 2 compares; 8 NMS compares, 26 blur operations), 2.1 us at
// the FMA-counted 67 TFLOP/s; but min and max issue at one per lane per
// clock, half the FMA-counted rate, so the arithmetic alone needs ~4 us.
// A time near 0.007 ms is the floor, not a target.
//
// Built with --fmad=false and written with __fmul_rn/__fadd_rn: the blur
// sums its 7 taps left to right, vertical pass then horizontal, as the
// plain version does, with no fused multiply-adds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;                // output tile width
constexpr int TH = 32;                // output tile height
constexpr int NT = 256;               // threads per CTA
constexpr int MIN_CTAS = 4;           // CTAs per SM the registers allow
constexpr int HALO = 4;               // 3 for the FAST circle and blur, 1 NMS
constexpr int SW = TW + 2 * HALO;     // staged tile with halo
constexpr int SH = TH + 2 * HALO;
constexpr int RW = TW + 2;            // scores on the tile + 1-px ring
constexpr int RH = TH + 2;
constexpr int BW = TW + 6;            // columns of the vertical blur pass
constexpr int QW = TW / 4;            // float4 groups per output row
static_assert(TW % 4 == 0, "tile width must be a multiple of 4");
static_assert((TH * QW) % NT == 0, "output groups must fill whole passes");

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

// The least index that the span [a, b] (a < n) reads after reflect101.
__device__ __forceinline__ int min_reflected(int a, int b, int n) {
  if (a <= 0) return 0;
  return b >= n ? max(min(a, 2 * n - 2 - b), 0) : a;
}

// FAST-9 score of the staged pixel at p (row stride SW): the max over the
// 16 arc starts of the min margin over 9 contiguous circle pixels, bright
// (p - c) or dark (c - p); 0 unless above threshold.
//
// Arcs i and i+1 (i even) share d[i+1..i+8], so the better of the two is
// min(min d[i+1..i+8], max(d[i], d[i+9])): only the 8 window-8 minima at
// odd starts are needed, by log-step doubling.  That takes 47 min/max a
// side where the 16 window-9 minima take 79; min and max are exact, so the
// score is the plain version's to the bit.
__device__ __forceinline__ float fast9(const float* p, float threshold) {
  // OpenCV's Bresenham circle of radius 3, clockwise from 12 o'clock
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const float center = p[0];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = p[kDy[k] * SW + kDx[k]] - center;
  // lo[j]/hi[j]: min/max of d over the window starting at 2j+1, of width
  // 2, then 4, then 8 (dark: min of -d is -max of d)
  float lo[8], hi[8], lo2[8], hi2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    lo[j] = fminf(d[2 * j + 1], d[(2 * j + 2) & 15]);
    hi[j] = fmaxf(d[2 * j + 1], d[(2 * j + 2) & 15]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    lo2[j] = fminf(lo[j], lo[(j + 1) & 7]);
    hi2[j] = fmaxf(hi[j], hi[(j + 1) & 7]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    lo[j] = fminf(lo2[j], lo2[(j + 2) & 7]);
    hi[j] = fmaxf(hi2[j], hi2[(j + 2) & 7]);
  }
  float bright = fminf(lo[0], fmaxf(d[0], d[9]));
  float dark_neg = fmaxf(hi[0], fminf(d[0], d[9]));
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    const float a = d[2 * j];
    const float b = d[(2 * j + 9) & 15];
    bright = fmaxf(bright, fminf(lo[j], fmaxf(a, b)));
    dark_neg = fminf(dark_neg, fmaxf(hi[j], fminf(a, b)));
  }
  const float score = fmaxf(bright, -dark_neg);
  return score > threshold ? score : 0.0f;
}

// Four outputs of one row at (gy, gx..gx+3): one float4 store when `vec`
// (then W % 4 == 0 and gx + 3 < W), else scalar stores inside the canvas.
__device__ __forceinline__ void store4(float* out, size_t o, float4 v,
                                       int gx, int W, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(out + o) = v;
    return;
  }
  const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (gx + j < W) out[o + j] = a[j];
}

__global__ void __launch_bounds__(NT, MIN_CTAS)
fast_nms_blur_kernel(const float* __restrict__ stack,
                     const int* __restrict__ dims,
                     const float* __restrict__ taps,
                     float* __restrict__ score_out,
                     float* __restrict__ blur_out, int H, int W,
                     float threshold, int border, int vec) {
  __shared__ __align__(16) float img[SH][SW];
  __shared__ float sc[RH][RW + 1];
  __shared__ float vb[TH][BW + 1];

  const int lvl = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* im = stack + lvl * plane;
  float* so = score_out + lvl * plane;
  float* bo = blur_out + lvl * plane;
  const int lh = dims[2 * lvl];
  const int lw = dims[2 * lvl + 1];

  if (min_reflected(y0 - HALO, y0 + TH + HALO - 1, H) >= lh ||
      min_reflected(x0 - HALO, x0 + TW + HALO - 1, W) >= lw) {
    // all padding: score and blur are exact zeros
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = tid; i < TH * QW; i += NT) {
      const int gy = y0 + i / QW;
      const int gx = x0 + 4 * (i % QW);
      if (gy >= H || gx >= W) continue;
      const size_t o = static_cast<size_t>(gy) * W + gx;
      store4(so, o, z, gx, W, vec);
      store4(bo, o, z, gx, W, vec);
    }
    return;
  }

  // stage tile + halo
  if (vec && y0 >= HALO && y0 + TH + HALO <= H && x0 >= HALO &&
      x0 + TW + HALO <= W) {
    const float* src = im + static_cast<size_t>(y0 - HALO) * W + (x0 - HALO);
    for (int i = tid; i < SH * (SW / 4); i += NT) {
      const int r = i / (SW / 4);
      const int q = i % (SW / 4);
      const float4* row =
          reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * W);
      *reinterpret_cast<float4*>(&img[r][4 * q]) = __ldg(row + q);
    }
  } else {
    for (int i = tid; i < SH * SW; i += NT) {
      const int r = i / SW;
      const int c = i % SW;
      const int gy = reflect101(y0 - HALO + r, H);
      const int gx = reflect101(x0 - HALO + c, W);
      img[r][c] = __ldg(im + static_cast<size_t>(gy) * W + gx);
    }
  }
  float k[7];
#pragma unroll
  for (int j = 0; j < 7; ++j) k[j] = __ldg(taps + j);
  __syncthreads();

  // FAST on the tile + 1-px ring, where the NMS of a kept output reads it:
  // -inf off the canvas (NMS padding), 0 within 3 px of the canvas edge
  // (the plain version's roll wraps there)
  for (int i = tid; i < RH * RW; i += NT) {
    const int r = i / RW;
    const int c = i % RW;
    const int gy = y0 - 1 + r;
    const int gx = x0 - 1 + c;
    float s = 0.0f;
    if (gy >= border - 1 && gy <= lh - border && gx >= border - 1 &&
        gx <= lw - border) {
      if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
        s = -INFINITY;
      } else if (gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3) {
        s = fast9(&img[r + HALO - 1][c + HALO - 1], threshold);
      }
    }
    sc[r][c] = s;
  }

  // vertical blur pass: the tile's rows, columns x0-3 .. x0+TW+2
  for (int i = tid; i < TH * BW; i += NT) {
    const int r = i / BW;
    const int c = i % BW;
    const float* p = &img[r + HALO - 3][c + 1];
    float acc = __fmul_rn(k[0], p[0]);
#pragma unroll
    for (int j = 1; j < 7; ++j)
      acc = __fadd_rn(acc, __fmul_rn(k[j], p[j * SW]));
    vb[r][c] = acc;
  }
  __syncthreads();

  // 3x3 NMS (strict against earlier raster neighbours, >= against later),
  // border mask and horizontal blur pass for 4 pixels of a row
  for (int i = tid; i < TH * QW; i += NT) {
    const int r = i / QW;
    const int c = 4 * (i % QW);
    const int gy = y0 + r;
    const int gx = x0 + c;
    if (gy >= H || gx >= W) continue;
    float n[3][6];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 6; ++dx) n[dy][dx] = sc[r + dy][c + dx];
    float v[10];
#pragma unroll
    for (int j = 0; j < 10; ++j) v[j] = vb[r][c + j];
    const bool row_in = gy >= border && gy < lh - border;
    float s4[4], b4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float s = n[1][j + 1];
      const bool is_max = s > n[0][j] && s > n[0][j + 1] && s > n[0][j + 2] &&
                          s > n[1][j] && s >= n[1][j + 2] && s >= n[2][j] &&
                          s >= n[2][j + 1] && s >= n[2][j + 2];
      const bool inside = row_in && gx + j >= border && gx + j < lw - border;
      s4[j] = (is_max && inside) ? s : 0.0f;
      float acc = __fmul_rn(k[0], v[j]);
#pragma unroll
      for (int t = 1; t < 7; ++t)
        acc = __fadd_rn(acc, __fmul_rn(k[t], v[j + t]));
      b4[j] = acc;
    }
    const size_t o = static_cast<size_t>(gy) * W + gx;
    store4(so, o, make_float4(s4[0], s4[1], s4[2], s4[3]), gx, W, vec);
    store4(bo, o, make_float4(b4[0], b4[1], b4[2], b4[3]), gx, W, vec);
  }
}

}  // namespace

// stack, score, blur: [L, H, W] float32, the stack zero outside each
// level's true (h, w); dims: [L, 2] int32 true (h, w); taps: [7] float32
// Gaussian taps.  Launches on `stream`; returns cudaGetLastError() after
// the launch.
extern "C" int fast_nms_blur_launch(const float* stack, const int* dims,
                                    const float* taps, float* score,
                                    float* blur, int L, int H, int W,
                                    float threshold, int border,
                                    void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = W % 4 == 0 && aligned(stack) && aligned(score) &&
                  aligned(blur);
  if (L == 0) return 0;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, L);
  fast_nms_blur_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      stack, dims, taps, score, blur, H, W, threshold, border, vec);
  return static_cast<int>(cudaGetLastError());
}
