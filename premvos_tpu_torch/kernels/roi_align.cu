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
// law is a gather (forward) and its adjoint a gather over the footprint and
// vector atomics (backward).
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
//   * single level with an optional level filter (training): the same
//     warp-per-bin body (pool_bin, s = 2 compiled in). Training launches it
//     once per level P2..P5 into one output, so every RoI is sampled once
//     (the JAX training path computes all four levels and selects). A block
//     first compacts the indices of its image's RoIs on `level` into shared
//     memory (ballot and popc prefix over the `levels` row, as the TPU
//     kernel's level sort orders RoIs by level), then walks the items (RoI
//     of that list, chunk of bins) striding by the grid. The grid is about
//     8 blocks per SM over (blocks per image, image), sized from n on the
//     host: no count is read back, so a training step gains no
//     synchronisation, and no block is spent on a RoI of another level.
//     Each RoI's row is written at its original index.
//   * backward: gradient with respect to the features only (boxes are
//     constants on the training path), into a zeroed float32 [B, H, W, C]
//     gradient. Same compacted list and strided grid; an item is (RoI,
//     quarter of its footprint). The footprint is the rectangle of level
//     pixels the RoI's taps span, and over it the gradient is
//     separable: grad[y][x] = sum_py sum_px Ay[py][y] Ax[px][x] g[py][px] /
//     s^2, with Ay[py] the summed weights of the distinct rows bin row py's
//     samples touch (at most 2s, often 2 or 3 where a RoI is small on its
//     level) and Ax the same for columns: the TPU's two interpolation
//     matmuls, as banded sums. The block builds Ay and Ax densely in shared
//     memory with each pixel's run of bins; then, as the forward's mirror
//     image, a warp owns one footprint pixel at a time, its lanes run over
//     16-byte channel vectors of g (through L1), and each vector of the
//     pixel goes to the gradient with one 16-byte vector atomic (float4
//     atomicAdd, compute capability 9.x), zero vectors skipped: one vector
//     atomic per footprint pixel and 4 channels, against 4 s^2 scalar
//     atomics per element before. There are no shared-memory atomics (a
//     float32 one is a compare-and-swap loop on this card) and no barrier
//     in the pixel loop: designs that accumulated the footprint in shared
//     memory, slice by slice, were bound by those atomics and barriers
//     (PERF.md). A footprint too large for the tables (P times a side above
//     kWRows, or a side above kMaxSpan: a large RoI in an unfiltered call;
//     on the training path a RoI's level bounds it, to under 28^2 px of
//     area on P2..P4 and all of P5's 15 x 27 px at 480 x 864) takes the
//     second path in the same kernel: each thread takes (bin, 4 channels)
//     and adds the bin's merged taps straight into the gradient with vector
//     atomics. Where C is not a multiple of 4 or a base pointer is not
//     16-byte aligned, both paths go one channel at a time.
// With a level filter, n is at most kMaxRois (the compacted list lives in
// shared memory); a larger n is refused. In-image offsets of the forward
// are 32-bit and checked at the entry points.

#include <cuda_bf16.h>

#include <algorithm>

#include "premvos_kernels.h"

namespace {

constexpr int kMaxSamples = 64;  // P * s per axis
constexpr int kFwThreads = 256;  // forward: 8 warps, one output bin each
constexpr int kMaxRois = 4096;   // n with a level filter: the compacted list
// Backward: blocks of 256 threads; an item is a kChunks-th of a RoI's
// footprint. A footprint takes the first path while P times its longer
// side is at most kWRows (the weight tables) and each side at most
// kMaxSpan.
constexpr int kBwThreads = 256;
constexpr int kChunks = 4;
constexpr int kWRows = 2048;
constexpr int kMaxSpan = 512;

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
// a base pointer not 16-byte aligned). Same sums as the plain version, in
// another order.
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
__global__ void __launch_bounds__(kFwThreads)
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
  for (int bin = first + (threadIdx.x >> 5); bin < last; bin += kFwThreads / 32) {
    const int py = bin / p;
    const int px = bin - py * p;
    pool_bin<T, kVec, kS>(t, feat, lv.w, c, py * s, px * s, s, inv,
                          out + (roi * bins + bin) * c);
  }
}

// Bring the box of a block's next item into L1 while the current one runs.
__device__ __forceinline__ void prefetch_box(const float* bx) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(bx));
}

// a / b for 0 <= a < 2^21 and b > 0, by b's float reciprocal: (a + 0.5) / b
// lies at least 0.5 / b from an integer, and the product's rounding error,
// under (a / b) 2^-22, stays below that at this range.
__device__ __forceinline__ int small_div(int a, float inv_b) {
  return (int)(((float)a + 0.5f) * inv_b);
}

// The indices (in order) of the RoIs of one image whose level, clamped to
// 2..5, is `level`, into `list`; returns their count. With `levels` NULL
// every RoI is on the list, which is then not written (item j is RoI j).
// Warps ballot over blocks of the `levels` row and each RoI's place is the
// popc of the RoIs before it. Ends with a barrier.
__device__ int compact_rois(const int* __restrict__ levels, int level, int n,
                            unsigned short* list) {
  if (levels == nullptr) return n;
  __shared__ int warp_counts[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int count = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool on = i < n && clamp_level(levels[i]) == level;
    const unsigned mask = __ballot_sync(0xffffffffu, on);
    if (lane == 0) warp_counts[warp] = __popc(mask);
    __syncthreads();
    int offset = count;
    for (int k = 0; k < warps; ++k) {
      const int v = warp_counts[k];
      offset += k < warp ? v : 0;
      count += v;
    }
    if (on) list[offset + __popc(mask & ((1u << lane) - 1u))] = (unsigned short)i;
    __syncthreads();  // warp_counts is rewritten by the next round
  }
  return count;
}

// Block (block of the image, image): the image's RoIs on `level`, then the
// items (RoI of the list, chunk of bins_per_block bins) striding by the
// grid, each its RoI's sample tables and a warp per bin.
template <typename T, bool kVec, int kS>
__global__ void __launch_bounds__(kFwThreads)
single_kernel(Level lv, int c, const float* __restrict__ boxes,
              const int* __restrict__ levels, int level, int n, int p, int s_rt,
              int bins_per_block, T* __restrict__ out) {
  const int s = kS > 0 ? kS : s_rt;
  const int img = blockIdx.y;
  __shared__ unsigned short list[kMaxRois];
  __shared__ Samples t;
  const int count = compact_rois(levels == nullptr ? nullptr : levels + (size_t)img * n,
                                 level, n, list);
  const T* feat = static_cast<const T*>(lv.data) + (size_t)img * lv.h * lv.w * c;
  const int bins = p * p;
  const int chunks = (bins + bins_per_block - 1) / bins_per_block;
  const float inv = 1.f / (float)(s * s);
  for (int item = blockIdx.x; item < count * chunks; item += gridDim.x) {
    const int j = item / chunks;
    const int first = (item - j * chunks) * bins_per_block;
    const int last = min(first + bins_per_block, bins);
    const size_t roi = (size_t)img * n + (levels == nullptr ? j : list[j]);
    if (threadIdx.x == 0 && item + gridDim.x < count * chunks) {
      const int jn = (item + gridDim.x) / chunks;
      prefetch_box(boxes + ((size_t)img * n + (levels == nullptr ? jn : list[jn])) * 4);
    }
    sample_tables(t, boxes + roi * 4, lv.scale, lv.h, lv.w, p * s);
    for (int bin = first + (threadIdx.x >> 5); bin < last; bin += kFwThreads / 32) {
      const int py = bin / p;
      const int px = bin - py * p;
      pool_bin<T, kVec, kS>(t, feat, lv.w, c, py * s, px * s, s, inv,
                            out + (roi * bins + bin) * c);
    }
    __syncthreads();  // the next item's tables overwrite these
  }
}

// Per output bin along one axis: the distinct level pixels its s samples'
// taps touch with a nonzero weight and their summed weights (bin b's at
// [2 s b, 2 s b + n[b])).
struct Taps {
  int pix[2 * kMaxSamples];
  float w[2 * kMaxSamples];
  int n[kMaxSamples];
};

// Merge bin b's taps along one axis (i0, i1, w0, w1: the sample tables of
// that axis) into `m`.
__device__ void merge_taps(const int* i0, const int* i1, const float* w0,
                           const float* w1, int s, int b, Taps& m) {
  const int base = 2 * s * b;
  int cnt = 0;
  for (int k = b * s; k < b * s + s; ++k) {
    for (int tap = 0; tap < 2; ++tap) {
      const int pix = tap ? i1[k] : i0[k];
      const float wt = tap ? w1[k] : w0[k];
      if (wt == 0.f) continue;
      int q = 0;
      while (q < cnt && m.pix[base + q] != pix) ++q;
      if (q == cnt) {
        m.pix[base + cnt] = pix;
        m.w[base + cnt] = wt;
        ++cnt;
      } else {
        m.w[base + q] += wt;
      }
    }
  }
  m.n[b] = cnt;
}

// The weight bin k's s samples give pixel `pix` along one axis (i0, i1,
// w0, w1: that axis' sample tables): its taps at that pixel, summed.
__device__ __forceinline__ float bin_weight(const int* i0, const int* i1, const float* w0,
                                            const float* w1, int s, int k, int pix) {
  float wt = 0.f;
  for (int j = k * s; j < k * s + s; ++j) {
    if (i0[j] == pix) wt += w0[j];
    if (i1[j] == pix) wt += w1[j];
  }
  return wt;
}

// The run of bins whose taps can reach pixel `pix` along one axis (bin k
// spans i0[k s] .. i1[k s + s - 1], and both ends grow with k), as
// band[0] .. band[1].
__device__ __forceinline__ void bin_band(const int* i0, const int* i1, int p, int s, int pix,
                                         short* band) {
  int first = p, last = -1;
  for (int k = 0; k < p; ++k) {
    if (i0[k * s] <= pix && pix <= i1[k * s + s - 1]) {
      first = min(first, k);
      last = k;
    }
  }
  band[0] = (short)first;
  band[1] = (short)last;
}

// Add 4 float32 channels `v` at `dst` (left: channels from dst to the end
// of the pixel): one 16-byte vector atomic, or scalar atomics for the
// nonzero ones where the gradient cannot take vectors.
__device__ __forceinline__ void add4(float* dst, float4 v, int left, bool vec) {
  if (vec) {
    atomicAdd(reinterpret_cast<float4*>(dst), v);
    return;
  }
  if (v.x != 0.f) atomicAdd(dst, v.x);
  if (left > 1 && v.y != 0.f) atomicAdd(dst + 1, v.y);
  if (left > 2 && v.z != 0.f) atomicAdd(dst + 2, v.z);
  if (left > 3 && v.w != 0.f) atomicAdd(dst + 3, v.w);
}

// Block (block of the image, image): the image's RoIs on `level`, then the
// items (RoI of the list, kChunks-th of its footprint) striding by the
// grid. `vec`: C is a multiple of 4 and both grad_out and the gradient are
// 16-byte aligned.
//
// The adjoint of the forward, gathered: a RoI's gradient is separable over
// its footprint (the fh x fw level pixels its taps span),
// grad[y][x] = sum over the bins (py, px) whose taps touch (y, x) of
// Wy[py][y] Wx[px][x] g[py][px], with Wy and Wx the merged tap weights of
// each bin row and column (dense tables in shared memory, 1/s^2 folded
// into Wy) and each pixel's run of bins along each axis. A warp owns one
// footprint pixel at a time and its lanes run over 16-byte channel vectors
// (two at a time), reading g through L1 and adding the pixel's vectors to
// the gradient with one 16-byte vector atomic each: no shared-memory
// atomics (on this card a float32 shared atomic add is a compare-and-swap
// loop) and no barrier inside the pixel loop.
__global__ void __launch_bounds__(kBwThreads)
backward_kernel(int h, int w, int c, float scale, const float* __restrict__ boxes,
                const int* __restrict__ levels, int level, int n, int p, int s,
                const float* __restrict__ grad_out, float* __restrict__ grad, int vec) {
  __shared__ float wy_buf[kWRows], wx_buf[kWRows];
  __shared__ unsigned short list[kMaxRois];
  __shared__ Samples t;
  __shared__ Taps ty, tx;
  __shared__ short band_y[kMaxSpan][2], band_x[kMaxSpan][2];
  const int img = blockIdx.y;
  const int count = compact_rois(levels == nullptr ? nullptr : levels + (size_t)img * n,
                                 level, n, list);
  float* g = grad + (size_t)img * h * w * c;
  const int bins = p * p;
  const float inv = 1.f / (float)(s * s);
  const float inv_p = 1.f / (float)p;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kBwThreads / 32;
  for (int item = blockIdx.x; item < count * kChunks; item += gridDim.x) {
    const int j = item / kChunks;
    const int chunk = item - j * kChunks;
    const size_t roi = (size_t)img * n + (levels == nullptr ? j : list[j]);
    const float* go = grad_out + roi * bins * c;
    if (threadIdx.x == 0 && item + gridDim.x < count * kChunks) {
      const int jn = (item + gridDim.x) / kChunks;
      prefetch_box(boxes + ((size_t)img * n + (levels == nullptr ? jn : list[jn])) * 4);
    }
    sample_tables(t, boxes + roi * 4, scale, h, w, p * s);
    // The footprint: the pixels the taps span (sample positions grow with
    // their index, and taps of zero weight add nothing).
    const int ps = p * s;
    const int ylo = t.y0[0], xlo = t.x0[0];
    const int fh = t.y1[ps - 1] - ylo + 1, fw = t.x1[ps - 1] - xlo + 1;
    if (max(fh, fw) <= kMaxSpan && p * max(fh, fw) <= kWRows) {
      for (int i = threadIdx.x; i < p * (fh + fw); i += kBwThreads) {
        if (i < p * fh)
          wy_buf[i] = bin_weight(t.y0, t.y1, t.wy0, t.wy1, s, i / fh, ylo + i % fh) * inv;
        else
          wx_buf[i - p * fh] =
              bin_weight(t.x0, t.x1, t.wx0, t.wx1, s, (i - p * fh) / fw, xlo + (i - p * fh) % fw);
      }
      for (int i = threadIdx.x; i < fh + fw; i += kBwThreads) {
        if (i < fh)
          bin_band(t.y0, t.y1, p, s, ylo + i, band_y[i]);
        else
          bin_band(t.x0, t.x1, p, s, xlo + i - fh, band_x[i - fh]);
      }
      __syncthreads();
      const int pixels = fh * fw;
      const int first = (int)((long long)pixels * chunk / kChunks);
      const int last = (int)((long long)pixels * (chunk + 1) / kChunks);
      const float inv_fw = 1.f / (float)fw;
      for (int pix = first + warp; pix < last; pix += kWarps) {
        const int yi = small_div(pix, inv_fw);
        const int xi = pix - yi * fw;
        const int py0 = band_y[yi][0], py1 = band_y[yi][1];
        const int px0 = band_x[xi][0], px1 = band_x[xi][1];
        float* dst = g + ((size_t)(ylo + yi) * w + xlo + xi) * c;
        if (vec) {
          // Lane v takes vectors v and v + 32 together (two chains of loads).
          const int vecs = c / 4;
          const float4* g4 = reinterpret_cast<const float4*>(go);
          for (int v = lane; v < vecs; v += 64) {
            const bool two = v + 32 < vecs;
            float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
            for (int py = py0; py <= py1; ++py) {
              const float wy = wy_buf[py * fh + yi];
              if (wy == 0.f) continue;
              float4 ra = make_float4(0.f, 0.f, 0.f, 0.f), rb = ra;
              for (int px = px0; px <= px1; ++px) {
                const float wx = wx_buf[px * fw + xi];
                if (wx == 0.f) continue;
                const float4* src = g4 + (size_t)(py * p + px) * vecs + v;
                const float4 u = __ldg(src);
                const float4 u2 = two ? __ldg(src + 32) : make_float4(0.f, 0.f, 0.f, 0.f);
                ra.x += wx * u.x;
                ra.y += wx * u.y;
                ra.z += wx * u.z;
                ra.w += wx * u.w;
                rb.x += wx * u2.x;
                rb.y += wx * u2.y;
                rb.z += wx * u2.z;
                rb.w += wx * u2.w;
              }
              a.x += wy * ra.x;
              a.y += wy * ra.y;
              a.z += wy * ra.z;
              a.w += wy * ra.w;
              b.x += wy * rb.x;
              b.y += wy * rb.y;
              b.z += wy * rb.z;
              b.w += wy * rb.w;
            }
            if (a.x != 0.f || a.y != 0.f || a.z != 0.f || a.w != 0.f)
              atomicAdd(reinterpret_cast<float4*>(dst) + v, a);
            if (two && (b.x != 0.f || b.y != 0.f || b.z != 0.f || b.w != 0.f))
              atomicAdd(reinterpret_cast<float4*>(dst) + v + 32, b);
          }
        } else {
          for (int ch = lane; ch < c; ch += 32) {
            float a = 0.f;
            for (int py = py0; py <= py1; ++py) {
              const float wy = wy_buf[py * fh + yi];
              if (wy == 0.f) continue;
              float r = 0.f;
              for (int px = px0; px <= px1; ++px) {
                const float wx = wx_buf[px * fw + xi];
                if (wx != 0.f) r += wx * __ldg(go + (size_t)(py * p + px) * c + ch);
              }
              a += wy * r;
            }
            if (a != 0.f) atomicAdd(dst + ch, a);
          }
        }
      }
    } else {
      // A footprint too large for the tables: (bin, 4 channels) a thread,
      // this item's share of the bins, their merged taps straight into the
      // gradient.
      for (int k = threadIdx.x; k < 2 * p; k += kBwThreads) {
        if (k < p)
          merge_taps(t.y0, t.y1, t.wy0, t.wy1, s, k, ty);
        else
          merge_taps(t.x0, t.x1, t.wx0, t.wx1, s, k - p, tx);
      }
      __syncthreads();
      const int vecs = (c + 3) / 4;
      const int first = (int)((long long)bins * chunk / kChunks);
      const int last = (int)((long long)bins * (chunk + 1) / kChunks);
      for (int e = first * vecs + threadIdx.x; e < last * vecs; e += kBwThreads) {
        const int bin = e / vecs;
        const int ch0 = (e - bin * vecs) * 4;
        const int left = c - ch0;
        const float* src = go + (size_t)bin * c + ch0;
        const float4 ge = make_float4(src[0] * inv, left > 1 ? src[1] * inv : 0.f,
                                      left > 2 ? src[2] * inv : 0.f,
                                      left > 3 ? src[3] * inv : 0.f);
        if (ge.x == 0.f && ge.y == 0.f && ge.z == 0.f && ge.w == 0.f) continue;
        const int py = small_div(bin, inv_p);
        const int px = bin - py * p;
        const int by = 2 * s * py, bx = 2 * s * px;
        for (int a = 0; a < ty.n[py]; ++a) {
          const float wy = ty.w[by + a];
          const float gy[4] = {ge.x * wy, ge.y * wy, ge.z * wy, ge.w * wy};
          float* row = g + (size_t)ty.pix[by + a] * w * c + ch0;
          for (int b = 0; b < tx.n[px]; ++b) {
            const float wx = tx.w[bx + b];
            add4(row + (size_t)tx.pix[bx + b] * c,
                 make_float4(gy[0] * wx, gy[1] * wx, gy[2] * wx, gy[3] * wx), left, vec);
          }
        }
      }
    }
    __syncthreads();  // the next item's tables overwrite these
  }
}

}  // namespace

namespace {

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// The current device and its SM count, read once per device.
cudaError_t sm_count(int* dev, int* sms) {
  static int cached[64];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev >= 64) return cudaErrorInvalidDevice;
  if (cached[*dev] == 0)
    err = cudaDeviceGetAttribute(&cached[*dev], cudaDevAttrMultiProcessorCount, *dev);
  *sms = cached[*dev];
  return err;
}

// Bins per block of the forward kernels: a whole number of bins per warp,
// halved until `rois` RoIs split that way give about 8 blocks per SM.
int bins_per_block(long long rois, int p, int sms) {
  const int warps = kFwThreads / 32;
  const int bins = p * p;
  int per_warp = (bins + warps - 1) / warps;
  while (per_warp > 1 &&
         rois * ((bins + per_warp * warps - 1) / (per_warp * warps)) < 8LL * sms)
    per_warp = (per_warp + 1) / 2;
  return per_warp * warps;
}

template <typename T, bool kVec>
void launch_multilevel(const Levels& desc, int c, const float* boxes, const int* levels,
                       int batch, int n, int p, int s, int bins_per_block, T* out,
                       cudaStream_t stream) {
  const dim3 grid((p * p + bins_per_block - 1) / bins_per_block, n, batch);
  if (s == 2) {
    multilevel_kernel<T, kVec, 2><<<grid, kFwThreads, 0, stream>>>(
        desc, c, boxes, levels, n, p, s, bins_per_block, out);
  } else {
    multilevel_kernel<T, kVec, 0><<<grid, kFwThreads, 0, stream>>>(
        desc, c, boxes, levels, n, p, s, bins_per_block, out);
  }
}

template <typename T, bool kVec>
void launch_single(dim3 grid, const Level& lv, int c, const float* boxes, const int* levels,
                   int level, int n, int p, int s, int bins_per_block, T* out,
                   cudaStream_t stream) {
  if (s == 2) {
    single_kernel<T, kVec, 2><<<grid, kFwThreads, 0, stream>>>(
        lv, c, boxes, levels, level, n, p, s, bins_per_block, out);
  } else {
    single_kernel<T, kVec, 0><<<grid, kFwThreads, 0, stream>>>(
        lv, c, boxes, levels, level, n, p, s, bins_per_block, out);
  }
}

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
  int dev = 0, sms = 0;
  cudaError_t err = sm_count(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  const int per_block = bins_per_block((long long)batch * n, p, sms);
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
  if (p * s > kMaxSamples || batch > 65535 || (levels != nullptr && n > kMaxRois) ||
      (long long)h * w * c >= (1LL << 31))  // in-image offsets are 32-bit
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = sm_count(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  const Level lv = {features, h, w, spatial_scale};
  const int per_block = bins_per_block((long long)batch * n, p, sms);
  const long long items = (long long)n * ((p * p + per_block - 1) / per_block);
  const dim3 grid((unsigned)std::min<long long>(items, (8LL * sms + batch - 1) / batch), batch);
  const bool vec = (c * (is_bf16 ? 2 : 4)) % 16 == 0 && aligned16(features) && aligned16(out);
  if (is_bf16) {
    using B = __nv_bfloat16;
    if (vec)
      launch_single<B, true>(grid, lv, c, boxes, levels, level, n, p, s, per_block,
                             static_cast<B*>(out), stream);
    else
      launch_single<B, false>(grid, lv, c, boxes, levels, level, n, p, s, per_block,
                              static_cast<B*>(out), stream);
  } else if (vec) {
    launch_single<float, true>(grid, lv, c, boxes, levels, level, n, p, s, per_block,
                               static_cast<float*>(out), stream);
  } else {
    launch_single<float, false>(grid, lv, c, boxes, levels, level, n, p, s, per_block,
                                static_cast<float*>(out), stream);
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
  if (p * s > kMaxSamples || batch > 65535 || (levels != nullptr && n > kMaxRois))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = sm_count(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  // About 8 blocks per SM over (blocks per image, image).
  const long long items = (long long)n * kChunks;
  const dim3 grid((unsigned)std::min(items, (8LL * sms + batch - 1) / batch), batch);
  const int vec = c % 4 == 0 && aligned16(grad_out) && aligned16(grad_features);
  backward_kernel<<<grid, kBwThreads, 0, stream>>>(h, w, c, spatial_scale, boxes, levels,
                                                   level, n, p, s, grad_out, grad_features,
                                                   vec);
  return (int)cudaGetLastError();
}
