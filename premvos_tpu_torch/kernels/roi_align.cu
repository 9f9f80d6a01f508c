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
// All three share the sample tables: a block first computes its RoI's P*s
// row and column sample positions and weights into shared memory
// (sample_tables, rounded exactly as the plain version). The TPU kernels
// built iota-matmul interpolation matrices; on the card the same sampling
// law is a gather (forward) and its adjoint a scatter-add (backward).
//
// What bounds them on the H100: bytes, the sampled feature pixels (read
// once) and the output (at the box head's 8 x 256 RoIs, P = 7, bf16 C = 256:
// 0.045 ms at 3.35 TB/s, against 0.015 ms of float32 arithmetic). Each
// output element needs 4 taps x s^2 loads, mostly L1 and L2 hits
// (neighbouring bins share pixels), so a design that spends instructions
// per element is bound by issue and latency long before bytes.
//
//   * multilevel (inference): a block per (chunk of bins, RoI, image), the
//     RoI on its own level (2..5; no level sort, which the TPU kernel did).
//     A warp owns one output bin at a time and its lanes run over 16-byte
//     channel vectors (8 bf16 or 4 float32 channels): at C = 256 bf16 each
//     tap is one warp-wide 512-byte load, with all s^2 x 4 taps of a vector
//     issued before any is used (s = 2 is compiled in), float32 sums in
//     registers, and one 16-byte store. Bin coordinates come from the
//     warp's bin index, with no division in the tap loop. The host splits a
//     RoI's bins over blocks until the grid is about 8 blocks per SM (the
//     mask head's 8 x 32 RoIs at P = 14 get 7 blocks each), and keeps a
//     RoI's neighbouring bins in one block, so taps they share hit in L1.
//     Where C * sizeof(T) is not a multiple of 16 or a base pointer is not
//     16-byte aligned, the same kernel's lanes take one channel each.
//   * single level with an optional level filter (training): one block per
//     (RoI, image), threads over (bin, channel), channel fastest. With
//     `levels` given, a block whose RoI is on another level exits at once.
//     Training launches it once per level P2..P5 into one output, so every
//     RoI is sampled once (the JAX training path computes all four levels
//     and selects).
//   * backward: gradient with respect to the features only (boxes are
//     constants on the training path), one block per (RoI, image). Each
//     sample's four taps get g * w_y * w_x / s^2 by float32 atomicAdd into
//     a zeroed float32 [B, H, W, C] gradient; where a tap clamps to the last
//     row or column (i1 == i0) both taps add to the same pixel, and
//     zero-weight taps (a sample outside the image, or an exact integer
//     coordinate) add nothing. Its atomics serialise where many samples of a
//     small RoI land on the same pixels.
// The single-level forward and the backward keep one element per thread
// (pool_roi): with its runtime divisions and 2-byte loads that design is
// issue-bound at 14-34x its bound (PERF.md); the multilevel design is the
// model for theirs.

#include <cuda_bf16.h>

#include "premvos_kernels.h"

namespace {

constexpr int kMaxSamples = 64;  // P * s per axis
constexpr int kThreads = 256;
constexpr int kMlThreads = 256;  // multilevel: 8 warps, one output bin each

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

// 16 bytes of features as floats: 4 float32 or 8 bf16 channels.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void unpack(const int4& v, float* f) {
    f[0] = __int_as_float(v.x);
    f[1] = __int_as_float(v.y);
    f[2] = __int_as_float(v.z);
    f[3] = __int_as_float(v.w);
  }
  static __device__ __forceinline__ int4 pack(const float* f) {
    return make_int4(__float_as_int(f[0]), __float_as_int(f[1]), __float_as_int(f[2]),
                     __float_as_int(f[3]));
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void unpack(const int4& v, float* f) {
    const unsigned w[4] = {(unsigned)v.x, (unsigned)v.y, (unsigned)v.z, (unsigned)v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ int4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
      w[k] = *reinterpret_cast<const unsigned*>(&h);
    }
    return make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
  }
};

// One output bin (its samples' rows ky0.., columns kx0..) of one RoI, by
// one warp, into `o` ([C]). Vector path: lane v takes 16-byte channel
// vectors v, v+32, ...; with kS > 0 all kS*kS*4 taps of a vector are
// loaded before any is used. Scalar path: lane ch takes channels ch,
// ch+32, ... one element at a time (C * sizeof(T) not a multiple of 16, or
// a base pointer not 16-byte aligned). Same sums as pool_roi.
template <typename T, bool kVec, int kS>
__device__ __forceinline__ void pool_bin(const Samples& t, const T* __restrict__ feat,
                                         int w, int c, int ky0, int kx0, int s_rt,
                                         float inv, T* __restrict__ o) {
  const int s = kS > 0 ? kS : s_rt;
  const int lane = threadIdx.x & 31;
  if constexpr (kVec) {
    using V = Vec16<T>;
    const int vecs = c / V::kN;  // 16-byte vectors per feature pixel
    const int4* f = reinterpret_cast<const int4*>(feat);
    for (int v = lane; v < vecs; v += 32) {
      float acc[V::kN];
#pragma unroll
      for (int k = 0; k < V::kN; ++k) acc[k] = 0.f;
      if constexpr (kS > 0) {
        int4 tap[kS][kS][4];
#pragma unroll
        for (int iy = 0; iy < kS; ++iy) {
          const int r0 = t.y0[ky0 + iy] * w, r1 = t.y1[ky0 + iy] * w;
#pragma unroll
          for (int ix = 0; ix < kS; ++ix) {
            const int x0 = t.x0[kx0 + ix], x1 = t.x1[kx0 + ix];
            tap[iy][ix][0] = __ldg(f + (r0 + x0) * vecs + v);
            tap[iy][ix][1] = __ldg(f + (r0 + x1) * vecs + v);
            tap[iy][ix][2] = __ldg(f + (r1 + x0) * vecs + v);
            tap[iy][ix][3] = __ldg(f + (r1 + x1) * vecs + v);
          }
        }
#pragma unroll
        for (int iy = 0; iy < kS; ++iy) {
          const float wy0 = t.wy0[ky0 + iy], wy1 = t.wy1[ky0 + iy];
#pragma unroll
          for (int ix = 0; ix < kS; ++ix) {
            const float wx0 = t.wx0[kx0 + ix], wx1 = t.wx1[kx0 + ix];
            float v00[V::kN], v01[V::kN], v10[V::kN], v11[V::kN];
            V::unpack(tap[iy][ix][0], v00);
            V::unpack(tap[iy][ix][1], v01);
            V::unpack(tap[iy][ix][2], v10);
            V::unpack(tap[iy][ix][3], v11);
#pragma unroll
            for (int k = 0; k < V::kN; ++k) {
              const float top = v00[k] * wx0 + v01[k] * wx1;
              const float bot = v10[k] * wx0 + v11[k] * wx1;
              acc[k] += top * wy0 + bot * wy1;
            }
          }
        }
      } else {
        for (int iy = 0; iy < s; ++iy) {
          const int r0 = t.y0[ky0 + iy] * w, r1 = t.y1[ky0 + iy] * w;
          const float wy0 = t.wy0[ky0 + iy], wy1 = t.wy1[ky0 + iy];
          for (int ix = 0; ix < s; ++ix) {
            const int x0 = t.x0[kx0 + ix], x1 = t.x1[kx0 + ix];
            const float wx0 = t.wx0[kx0 + ix], wx1 = t.wx1[kx0 + ix];
            float v00[V::kN], v01[V::kN], v10[V::kN], v11[V::kN];
            V::unpack(__ldg(f + (r0 + x0) * vecs + v), v00);
            V::unpack(__ldg(f + (r0 + x1) * vecs + v), v01);
            V::unpack(__ldg(f + (r1 + x0) * vecs + v), v10);
            V::unpack(__ldg(f + (r1 + x1) * vecs + v), v11);
#pragma unroll
            for (int k = 0; k < V::kN; ++k) {
              const float top = v00[k] * wx0 + v01[k] * wx1;
              const float bot = v10[k] * wx0 + v11[k] * wx1;
              acc[k] += top * wy0 + bot * wy1;
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < V::kN; ++k) acc[k] *= inv;
      reinterpret_cast<int4*>(o)[v] = V::pack(acc);
    }
  } else {
    for (int ch = lane; ch < c; ch += 32) {
      float acc = 0.f;
      for (int iy = 0; iy < s; ++iy) {
        const T* r0 = feat + t.y0[ky0 + iy] * w * c + ch;
        const T* r1 = feat + t.y1[ky0 + iy] * w * c + ch;
        const float wy0 = t.wy0[ky0 + iy], wy1 = t.wy1[ky0 + iy];
        for (int ix = 0; ix < s; ++ix) {
          const int c0 = t.x0[kx0 + ix] * c, c1 = t.x1[kx0 + ix] * c;
          const float wx0 = t.wx0[kx0 + ix], wx1 = t.wx1[kx0 + ix];
          const float top = load(r0 + c0) * wx0 + load(r0 + c1) * wx1;
          const float bot = load(r1 + c0) * wx0 + load(r1 + c1) * wx1;
          acc += top * wy0 + bot * wy1;
        }
      }
      store(o + ch, acc * inv);
    }
  }
}

// Block (chunk, RoI, image): the RoI's sample tables, then bins
// chunk * bins_per_block .. of its P x P, one warp per bin at a time.
template <typename T, bool kVec, int kS>
__global__ void __launch_bounds__(kMlThreads)
multilevel_kernel(Levels levels_desc, int c, const float* __restrict__ boxes,
                  const int* __restrict__ levels, int n, int p, int s_rt,
                  int bins_per_block, T* __restrict__ out) {
  const int s = kS > 0 ? kS : s_rt;
  const size_t roi = (size_t)blockIdx.z * n + blockIdx.y;
  // Selected, not indexed: an indexed kernel parameter goes to local memory.
  const int li = clamp_level(levels[roi]);
  const Level lv = li == 2   ? levels_desc.l[0]
                   : li == 3 ? levels_desc.l[1]
                   : li == 4 ? levels_desc.l[2]
                             : levels_desc.l[3];
  __shared__ Samples t;
  sample_tables(t, boxes + roi * 4, lv.scale, lv.h, lv.w, p * s);
  const T* feat = static_cast<const T*>(lv.data) + (size_t)blockIdx.z * lv.h * lv.w * c;
  const int bins = p * p;
  const int first = blockIdx.x * bins_per_block;
  const int last = min(first + bins_per_block, bins);
  const float inv = 1.f / (float)(s * s);
  for (int bin = first + (threadIdx.x >> 5); bin < last; bin += kMlThreads / 32) {
    const int py = bin / p;
    const int px = bin - py * p;
    pool_bin<T, kVec, kS>(t, feat, lv.w, c, py * s, px * s, s, inv,
                          out + (roi * bins + bin) * c);
  }
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

namespace {

template <typename T, bool kVec>
void launch_multilevel(const Levels& desc, int c, const float* boxes, const int* levels,
                       int batch, int n, int p, int s, int bins_per_block, T* out,
                       cudaStream_t stream) {
  const dim3 grid((p * p + bins_per_block - 1) / bins_per_block, n, batch);
  if (s == 2) {
    multilevel_kernel<T, kVec, 2><<<grid, kMlThreads, 0, stream>>>(
        desc, c, boxes, levels, n, p, s, bins_per_block, out);
  } else {
    multilevel_kernel<T, kVec, 0><<<grid, kMlThreads, 0, stream>>>(
        desc, c, boxes, levels, n, p, s, bins_per_block, out);
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" int premvos_multilevel_roi_align(
    const void* p2, const void* p3, const void* p4, const void* p5, int h2,
    int w2, int h3, int w3, int h4, int w4, int h5, int w5, int c,
    int is_bf16, const float* boxes, const int* levels, int batch, int n,
    int p, int s, void* out, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (p * s > kMaxSamples || n > 65535 || batch > 65535) return (int)cudaErrorInvalidValue;
  Levels desc;
  desc.l[0] = {p2, h2, w2, 1.f / 4.f};
  desc.l[1] = {p3, h3, w3, 1.f / 8.f};
  desc.l[2] = {p4, h4, w4, 1.f / 16.f};
  desc.l[3] = {p5, h5, w5, 1.f / 32.f};
  const int esize = is_bf16 ? 2 : 4;
  bool vec = (c * esize) % 16 == 0 && aligned16(out);
  for (const Level& lv : desc.l) {
    // In-image offsets are 32-bit.
    if ((long long)lv.h * lv.w * c >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    vec = vec && aligned16(lv.data);
  }
  // Split each RoI's bins over blocks (a whole number of bins per warp)
  // until the grid is about 8 blocks per SM.
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int warps = kMlThreads / 32;
  const int bins = p * p;
  int per_warp = (bins + warps - 1) / warps;
  while (per_warp > 1 &&
         (long long)batch * n * ((bins + per_warp * warps - 1) / (per_warp * warps)) < 8LL * sms)
    per_warp = (per_warp + 1) / 2;
  const int per_block = per_warp * warps;
  if (is_bf16) {
    using B = __nv_bfloat16;
    if (vec)
      launch_multilevel<B, true>(desc, c, boxes, levels, batch, n, p, s, per_block,
                                 static_cast<B*>(out), stream);
    else
      launch_multilevel<B, false>(desc, c, boxes, levels, batch, n, p, s, per_block,
                                  static_cast<B*>(out), stream);
  } else if (vec) {
    launch_multilevel<float, true>(desc, c, boxes, levels, batch, n, p, s, per_block,
                                   static_cast<float*>(out), stream);
  } else {
    launch_multilevel<float, false>(desc, c, boxes, levels, batch, n, p, s, per_block,
                                    static_cast<float*>(out), stream);
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
