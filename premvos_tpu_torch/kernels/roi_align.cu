// Multilevel (FPN) RoIAlign, batched over images.
//
// Replaces premvos_tpu/ops/pallas/multilevel_roi_align_pallas.py::
// multilevel_roi_align_pallas (_kernel). Contract (ops/roi_align.py):
// features P2..P5 as [B, H_l, W_l, C] (channels innermost), float32 or
// bfloat16; boxes [B, N, 4] xyxy image coordinates (float32); levels
// [B, N] int32 in 2..5 (models/maskrcnn.py::roi_levels). Each RoI is
// sampled ONLY on its level (stride 4/8/16/32): aligned coordinates
// (shift -0.5), P x P bins of s x s bilinear samples averaged; samples
// outside (-1, size) are zero, the rest clamp to the edge. Output
// [B, N, P, P, C] in the features' dtype, accumulated in float32.
//
// Design: one thread block per (RoI, image). The block first computes the
// RoI's P*s row and column sample positions and weights into shared memory,
// then its threads run over (bin, channel) with the channel fastest, so a
// warp reads 32 consecutive channels of one feature pixel (coalesced). No
// level sort (the TPU kernel sorted RoIs so each block was one level): a
// block reads its RoI's level and samples that level only.
//
// What bounds it: reading the sampled feature pixels, 4 taps x s^2 x P^2 x C
// per RoI, mostly from L2 (neighbouring bins share pixels); the arithmetic
// is a few flops per tap.

#include <cuda_bf16.h>

#include "premvos_kernels.h"

namespace {

constexpr int kMaxSamples = 64;  // P * s per axis

struct Level {
  const void* data;
  int h, w;
  float scale;
};

struct Levels {
  Level l[4];
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

template <typename T>
__global__ void roi_align_kernel(Levels levels_desc, int c,
                                 const float* __restrict__ boxes,
                                 const int* __restrict__ levels, int n, int p,
                                 int s, T* __restrict__ out) {
  const int r = blockIdx.x;
  const int b = blockIdx.y;
  const size_t roi = (size_t)b * n + r;
  const int li = min(max(levels[roi] - 2, 0), 3);
  const Level lv = levels_desc.l[li];
  const T* feat = static_cast<const T*>(lv.data) + (size_t)b * lv.h * lv.w * c;
  const int ps = p * s;

  __shared__ int ys0[kMaxSamples], ys1[kMaxSamples];
  __shared__ int xs0[kMaxSamples], xs1[kMaxSamples];
  __shared__ float wy0[kMaxSamples], wy1[kMaxSamples];
  __shared__ float wx0[kMaxSamples], wx1[kMaxSamples];

  const float* bx = boxes + roi * 4;
  const float x1 = bx[0] * lv.scale - 0.5f;
  const float y1 = bx[1] * lv.scale - 0.5f;
  const float x2 = bx[2] * lv.scale - 0.5f;
  const float y2 = bx[3] * lv.scale - 0.5f;
  const float bw = fmaxf(x2 - x1, 1e-6f);
  const float bh = fmaxf(y2 - y1, 1e-6f);
  for (int k = threadIdx.x; k < ps; k += blockDim.x) {
    const float g = ((float)k + 0.5f) / (float)ps;
    bilinear_1d(y1 + g * bh, lv.h, &ys0[k], &ys1[k], &wy0[k], &wy1[k]);
    bilinear_1d(x1 + g * bw, lv.w, &xs0[k], &xs1[k], &wx0[k], &wx1[k]);
  }
  __syncthreads();

  const float inv = 1.f / (float)(s * s);
  T* o = out + roi * p * p * c;
  for (int e = threadIdx.x; e < p * p * c; e += blockDim.x) {
    const int ch = e % c;
    const int bin = e / c;
    const int py = bin / p;
    const int px = bin % p;
    float acc = 0.f;
    for (int iy = 0; iy < s; ++iy) {
      const int ky = py * s + iy;
      const T* r0 = feat + (size_t)ys0[ky] * lv.w * c + ch;
      const T* r1 = feat + (size_t)ys1[ky] * lv.w * c + ch;
      for (int ix = 0; ix < s; ++ix) {
        const int kx = px * s + ix;
        const size_t c0 = (size_t)xs0[kx] * c;
        const size_t c1 = (size_t)xs1[kx] * c;
        const float top = load(r0 + c0) * wx0[kx] + load(r0 + c1) * wx1[kx];
        const float bot = load(r1 + c0) * wx0[kx] + load(r1 + c1) * wx1[kx];
        acc += top * wy0[ky] + bot * wy1[ky];
      }
    }
    store(o + e, acc * inv);
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
  const int threads = 256;
  if (is_bf16) {
    roi_align_kernel<__nv_bfloat16><<<grid, threads, 0, stream>>>(
        desc, c, boxes, levels, n, p, s, static_cast<__nv_bfloat16*>(out));
  } else {
    roi_align_kernel<float><<<grid, threads, 0, stream>>>(
        desc, c, boxes, levels, n, p, s, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
