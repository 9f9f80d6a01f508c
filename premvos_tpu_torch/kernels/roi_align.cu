// Aligned RoIAlign on FPN levels, batched over images: the multilevel
// forward (inference), the single-level forward and its backward (training).
//
// Replaces
//   premvos_tpu/ops/pallas/multilevel_roi_align_pallas.py::
//     multilevel_roi_align_pallas (_kernel)          → premvos_multilevel_roi_align
//   premvos_tpu/ops/pallas/roi_align_pallas.py::roi_align_pallas (_roi_kernel)
//                                                    → premvos_roi_align
//   the autodiff of premvos_tpu/ops/roi_align.py::roi_align_matmul (the JAX
//   package has no backward kernel)                  → premvos_roi_align_backward
//
// Contract (ops/roi_align.py): features [B, H, W, C] (channels innermost),
// float32 or bfloat16; boxes [B, N, 4] xyxy image coordinates (float32),
// scaled by the level's spatial scale; aligned coordinates (shift -0.5),
// P x P bins of s x s bilinear samples averaged; samples outside (-1, size)
// are zero, the rest clamp to the edge. Forward output [B, N, P, P, C] in
// the features' dtype, accumulated in float32.
//
// Design: one thread block per (RoI, image). The block first computes the
// RoI's P*s row and column sample positions and weights into shared memory,
// then its threads run over (bin, channel) with the channel fastest, so a
// warp touches 32 consecutive channels of one feature pixel (coalesced).
// The TPU kernels built iota-matmul interpolation matrices; on the card the
// same sampling law is a gather (forward) and its adjoint a scatter-add
// (backward).
//   * multilevel: each block reads its RoI's level (2..5) and samples that
//     level only; no level sort (the TPU kernel sorted RoIs by level).
//   * single level with an optional level filter: with `levels` given, a
//     block whose RoI is on another level exits at once. Training launches
//     it once per level P2..P5 into one output, so every RoI is sampled once
//     (the JAX training path computes all four levels and selects).
//   * backward: gradient with respect to the features only (boxes are
//     constants on the training path). Each sample's four taps get
//     g * w_y * w_x / s^2 by float32 atomicAdd into a zeroed float32
//     [B, H, W, C] gradient; where a tap clamps to the last row or column
//     (i1 == i0) both taps add to the same pixel, and zero-weight taps (a
//     sample outside the image, or an exact integer coordinate) add nothing.
//
// What bounds them: reading (forward) or read-modify-writing (backward) the
// sampled feature pixels, 4 taps x s^2 x P^2 x C per RoI, mostly in L2
// (neighbouring bins share pixels); the arithmetic is a few flops per tap.
// The backward's atomics serialise where many samples of a small RoI land
// on the same pixels.

#include <cuda_bf16.h>

#include "premvos_kernels.h"

namespace {

constexpr int kMaxSamples = 64;  // P * s per axis
constexpr int kThreads = 256;

struct Level {
  const void* data;
  int h, w;
  float scale;
};

struct Levels {
  Level l[4];
};

// Sample positions of one RoI along both axes.
struct Samples {
  int y0[kMaxSamples], y1[kMaxSamples], x0[kMaxSamples], x1[kMaxSamples];
  float wy0[kMaxSamples], wy1[kMaxSamples], wx0[kMaxSamples], wx1[kMaxSamples];
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// ops/roi_align.py::_bilinear_1d for one coordinate.
__device__ __forceinline__ void bilinear_1d(float coord, int size, int* i0,
                                            int* i1, float* w0, float* w1) {
  const bool inside = coord > -1.f && coord < (float)size;
  const float c = fminf(fmaxf(coord, 0.f), (float)(size - 1));
  const float f = floorf(c);
  *i0 = (int)f;
  *i1 = min(*i0 + 1, size - 1);
  const float frac = c - f;
  *w1 = inside ? frac : 0.f;
  *w0 = inside ? 1.f - frac : 0.f;
}

// One box edge in sampling coordinates, rounded as the plain version's
// separate multiply and subtract are (no FMA contraction).
__device__ __forceinline__ float edge(float v, float scale) {
  return __fsub_rn(__fmul_rn(v, scale), 0.5f);
}

// The block's sample tables for the box `bx` on a level h x w at `scale`;
// ends with a barrier. Sample coordinates are rounded step by step as in
// the plain version (no FMA contraction, a correctly rounded division): at
// a coordinate of 200 one float32 ulp is 1.5e-5 px, and an ulp there moved
// float32 outputs on unit features by up to 7e-5.
__device__ void sample_tables(Samples& t, const float* bx, float scale, int h,
                              int w, int ps) {
  const float x1 = edge(bx[0], scale);
  const float y1 = edge(bx[1], scale);
  const float x2 = edge(bx[2], scale);
  const float y2 = edge(bx[3], scale);
  const float bw = fmaxf(__fsub_rn(x2, x1), 1e-6f);
  const float bh = fmaxf(__fsub_rn(y2, y1), 1e-6f);
  for (int k = threadIdx.x; k < ps; k += blockDim.x) {
    const float g = __fdiv_rn((float)k + 0.5f, (float)ps);
    bilinear_1d(__fadd_rn(y1, __fmul_rn(g, bh)), h, &t.y0[k], &t.y1[k], &t.wy0[k],
                &t.wy1[k]);
    bilinear_1d(__fadd_rn(x1, __fmul_rn(g, bw)), w, &t.x0[k], &t.x1[k], &t.wx0[k],
                &t.wx1[k]);
  }
  __syncthreads();
}

// One RoI's [P, P, C] output from the level `feat` ([H, W, C] of one image).
template <typename T>
__device__ void pool_roi(const Samples& t, const T* __restrict__ feat, int w,
                         int c, int p, int s, T* __restrict__ o) {
  const float inv = 1.f / (float)(s * s);
  for (int e = threadIdx.x; e < p * p * c; e += blockDim.x) {
    const int ch = e % c;
    const int bin = e / c;
    const int py = bin / p;
    const int px = bin % p;
    float acc = 0.f;
    for (int iy = 0; iy < s; ++iy) {
      const int ky = py * s + iy;
      const T* r0 = feat + (size_t)t.y0[ky] * w * c + ch;
      const T* r1 = feat + (size_t)t.y1[ky] * w * c + ch;
      for (int ix = 0; ix < s; ++ix) {
        const int kx = px * s + ix;
        const size_t c0 = (size_t)t.x0[kx] * c;
        const size_t c1 = (size_t)t.x1[kx] * c;
        const float top = load(r0 + c0) * t.wx0[kx] + load(r0 + c1) * t.wx1[kx];
        const float bot = load(r1 + c0) * t.wx0[kx] + load(r1 + c1) * t.wx1[kx];
        acc += top * t.wy0[ky] + bot * t.wy1[ky];
      }
    }
    store(o + e, acc * inv);
  }
}

__device__ __forceinline__ int clamp_level(int l) { return min(max(l, 2), 5); }

template <typename T>
__global__ void multilevel_kernel(Levels levels_desc, int c,
                                  const float* __restrict__ boxes,
                                  const int* __restrict__ levels, int n, int p,
                                  int s, T* __restrict__ out) {
  const size_t roi = (size_t)blockIdx.y * n + blockIdx.x;
  const Level lv = levels_desc.l[clamp_level(levels[roi]) - 2];
  __shared__ Samples t;
  sample_tables(t, boxes + roi * 4, lv.scale, lv.h, lv.w, p * s);
  const T* feat = static_cast<const T*>(lv.data) + (size_t)blockIdx.y * lv.h * lv.w * c;
  pool_roi(t, feat, lv.w, c, p, s, out + roi * p * p * c);
}

template <typename T>
__global__ void single_kernel(Level lv, int c, const float* __restrict__ boxes,
                              const int* __restrict__ levels, int level, int n,
                              int p, int s, T* __restrict__ out) {
  const size_t roi = (size_t)blockIdx.y * n + blockIdx.x;
  if (levels != nullptr && clamp_level(levels[roi]) != level) return;
  __shared__ Samples t;
  sample_tables(t, boxes + roi * 4, lv.scale, lv.h, lv.w, p * s);
  const T* feat = static_cast<const T*>(lv.data) + (size_t)blockIdx.y * lv.h * lv.w * c;
  pool_roi(t, feat, lv.w, c, p, s, out + roi * p * p * c);
}

__global__ void backward_kernel(int h, int w, int c, float scale,
                                const float* __restrict__ boxes,
                                const int* __restrict__ levels, int level,
                                int n, int p, int s,
                                const float* __restrict__ grad_out,
                                float* __restrict__ grad) {
  const size_t roi = (size_t)blockIdx.y * n + blockIdx.x;
  if (levels != nullptr && clamp_level(levels[roi]) != level) return;
  __shared__ Samples t;
  sample_tables(t, boxes + roi * 4, scale, h, w, p * s);
  float* g = grad + (size_t)blockIdx.y * h * w * c;
  const float* go = grad_out + roi * p * p * c;
  const float inv = 1.f / (float)(s * s);
  for (int e = threadIdx.x; e < p * p * c; e += blockDim.x) {
    const float ge = go[e] * inv;
    if (ge == 0.f) continue;
    const int ch = e % c;
    const int bin = e / c;
    const int py = bin / p;
    const int px = bin % p;
    for (int iy = 0; iy < s; ++iy) {
      const int ky = py * s + iy;
      const float gy0 = ge * t.wy0[ky];
      const float gy1 = ge * t.wy1[ky];
      float* r0 = g + (size_t)t.y0[ky] * w * c + ch;
      float* r1 = g + (size_t)t.y1[ky] * w * c + ch;
      for (int ix = 0; ix < s; ++ix) {
        const int kx = px * s + ix;
        const size_t c0 = (size_t)t.x0[kx] * c;
        const size_t c1 = (size_t)t.x1[kx] * c;
        const float wx0 = t.wx0[kx], wx1 = t.wx1[kx];
        if (gy0 * wx0 != 0.f) atomicAdd(r0 + c0, gy0 * wx0);
        if (gy0 * wx1 != 0.f) atomicAdd(r0 + c1, gy0 * wx1);
        if (gy1 * wx0 != 0.f) atomicAdd(r1 + c0, gy1 * wx0);
        if (gy1 * wx1 != 0.f) atomicAdd(r1 + c1, gy1 * wx1);
      }
    }
  }
}

}  // namespace

extern "C" int premvos_multilevel_roi_align(
    const void* p2, const void* p3, const void* p4, const void* p5, int h2,
    int w2, int h3, int w3, int h4, int w4, int h5, int w5, int c,
    int is_bf16, const float* boxes, const int* levels, int batch, int n,
    int p, int s, void* out, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (p * s > kMaxSamples) return (int)cudaErrorInvalidValue;
  Levels desc;
  desc.l[0] = {p2, h2, w2, 1.f / 4.f};
  desc.l[1] = {p3, h3, w3, 1.f / 8.f};
  desc.l[2] = {p4, h4, w4, 1.f / 16.f};
  desc.l[3] = {p5, h5, w5, 1.f / 32.f};
  const dim3 grid(n, batch);
  if (is_bf16) {
    multilevel_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        desc, c, boxes, levels, n, p, s, static_cast<__nv_bfloat16*>(out));
  } else {
    multilevel_kernel<float><<<grid, kThreads, 0, stream>>>(
        desc, c, boxes, levels, n, p, s, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

extern "C" int premvos_roi_align(const void* features, int h, int w, int c,
                                 int is_bf16, float spatial_scale,
                                 const float* boxes, const int* levels,
                                 int level, int batch, int n, int p, int s,
                                 void* out, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (p * s > kMaxSamples) return (int)cudaErrorInvalidValue;
  const Level lv = {features, h, w, spatial_scale};
  const dim3 grid(n, batch);
  if (is_bf16) {
    single_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        lv, c, boxes, levels, level, n, p, s, static_cast<__nv_bfloat16*>(out));
  } else {
    single_kernel<float><<<grid, kThreads, 0, stream>>>(
        lv, c, boxes, levels, level, n, p, s, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

extern "C" int premvos_roi_align_backward(const float* grad_out, int h, int w,
                                          int c, float spatial_scale,
                                          const float* boxes, const int* levels,
                                          int level, int batch, int n, int p,
                                          int s, float* grad_features,
                                          cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (p * s > kMaxSamples) return (int)cudaErrorInvalidValue;
  const dim3 grid(n, batch);
  backward_kernel<<<grid, kThreads, 0, stream>>>(h, w, c, spatial_scale, boxes,
                                                 levels, level, n, p, s,
                                                 grad_out, grad_features);
  return (int)cudaGetLastError();
}
