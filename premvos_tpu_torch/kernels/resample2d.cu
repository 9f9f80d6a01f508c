// Backward bilinear warp (resample2d), batched.
//
// Replaces premvos_tpu/ops/pallas/resample2d_pallas.py::
// resample2d_block_pallas (_warp_kernel). Contract (ops/resample2d.py):
//   out[b, c, y, x] = bilinear(src[b, c], y + flow[b, 1, y, x],
//                                         x + flow[b, 0, y, x])
// with the sample point clamped into the image (edge clamp), exactly
// premvos_tpu/ops/resample2d.py::resample2d_reference for any flow. The TPU
// kernel is exact only inside an envelope (|flow| <= 64 and a per-block
// residual <= 4) and clamps to its window outside it; this kernel has no
// envelope. src is NCHW float32 or bfloat16, flow [B, 2, H, W] float32, the
// output NCHW float32 (the promoted type of src and flow).
//
// What bounds it on the H100: bytes. B*H*W*(C src + 2 flow + C out)
// elements move once, against eight flops per output; the four taps of a
// pixel are gathers, so what the card needs is many loads in flight.
//
// Design: a 3-D grid (column tile, row tile, image x channel group) of
// 16x16-thread blocks, so no thread divides a 64-bit index. Two shapes sit
// on the main path and the launch picks the split for each:
//   - C small, B*H*W large (FlowNet2: 3 bf16 channels over 3 M pixels):
//     each thread takes P = 2 neighbouring pixels of a row, so the flow
//     reads and the output writes are float2 and coalesce, and computes its
//     taps and weights once for all channels (2 measured a little faster
//     than 1 or 4 pixels at both path shapes);
//   - B*H*W small against C (the merge warp: 8 channels over 103,680
//     pixels): the channels are split into groups across threads, each
//     thread doing one group for its pixels, so the card holds about one
//     thread per channel per 2 pixels instead of one per 2 pixels, and that
//     many more gathers are in flight.
// Rows of an odd width take P = 1.

#include <cuda_bf16.h>

#include "premvos_kernels.h"

namespace {

constexpr int kBlockX = 16;  // threads along a row (each P pixels)
constexpr int kBlockY = 16;  // rows
constexpr int kTargetThreads = 132 * 2048;  // one full wave of the card

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T, int P>
__global__ void __launch_bounds__(kBlockX * kBlockY)
resample_kernel(const T* __restrict__ src, const float* __restrict__ flow,
                int c, int h, int w, int groups, int group_size,
                float* __restrict__ out) {
  const int x = (blockIdx.x * kBlockX + threadIdx.x) * P;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int b = blockIdx.z / groups;
  const int g = blockIdx.z - b * groups;
  const size_t hw = (size_t)h * w;
  const int pix = y * w + x;  // h * w < 2^31 (checked by the launch)

  float u[P], v[P];
  const float* fl = flow + (size_t)b * 2 * hw + pix;
  if constexpr (P == 2) {
    const float2 fu = __ldg(reinterpret_cast<const float2*>(fl));
    const float2 fv = __ldg(reinterpret_cast<const float2*>(fl + hw));
    u[0] = fu.x; u[1] = fu.y;
    v[0] = fv.x; v[1] = fv.y;
  } else {
    u[0] = __ldg(fl);
    v[0] = __ldg(fl + hw);
  }

  // Taps and weights, once per pixel for the whole channel group.
  int i00[P], i01[P], i10[P], i11[P];
  float wx[P], wy[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float sx = fminf(fmaxf((float)(x + p) + u[p], 0.f), (float)(w - 1));
    const float sy = fminf(fmaxf((float)y + v[p], 0.f), (float)(h - 1));
    const int x0 = (int)floorf(sx);
    const int y0 = (int)floorf(sy);
    const int x1 = min(x0 + 1, w - 1);
    const int y1 = min(y0 + 1, h - 1);
    wx[p] = sx - (float)x0;
    wy[p] = sy - (float)y0;
    i00[p] = y0 * w + x0;
    i01[p] = y0 * w + x1;
    i10[p] = y1 * w + x0;
    i11[p] = y1 * w + x1;
  }

  const int c0 = g * group_size;
  const int c1 = min(c, c0 + group_size);
  for (int ch = c0; ch < c1; ++ch) {
    const T* s = src + ((size_t)b * c + ch) * hw;
    float r[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float top = load(s + i00[p]) * (1.f - wx[p]) + load(s + i01[p]) * wx[p];
      const float bot = load(s + i10[p]) * (1.f - wx[p]) + load(s + i11[p]) * wx[p];
      r[p] = top * (1.f - wy[p]) + bot * wy[p];
    }
    float* o = out + ((size_t)b * c + ch) * hw + pix;
    if constexpr (P == 2) {
      *reinterpret_cast<float2*>(o) = make_float2(r[0], r[1]);
    } else {
      o[0] = r[0];
    }
  }
}

template <typename T, int P>
cudaError_t launch(const void* src, const float* flow, int b, int c, int h,
                   int w, float* out, cudaStream_t stream) {
  const int cols = (w + P - 1) / P;
  // Split the channels into as many groups as it takes to fill the card
  // (at most one group per channel).
  const long long pixel_threads = (long long)b * h * cols;
  int groups = (int)((kTargetThreads + pixel_threads - 1) / pixel_threads);
  groups = max(1, min(groups, c));
  const int group_size = (c + groups - 1) / groups;
  groups = (c + group_size - 1) / group_size;
  if ((long long)b * groups > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((cols + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY,
                  b * groups);
  resample_kernel<T, P><<<grid, dim3(kBlockX, kBlockY), 0, stream>>>(
      static_cast<const T*>(src), flow, c, h, w, groups, group_size, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int premvos_resample2d(const void* src, int is_bf16,
                                  const float* flow, int b, int c, int h,
                                  int w, float* out, cudaStream_t stream) {
  if (b <= 0 || c <= 0 || h <= 0 || w <= 0) return 0;
  if ((long long)h * w >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  // float2 flow reads and output writes need rows of an even width and an
  // 8-byte aligned flow (the output is a fresh tensor).
  const bool wide = w % 2 == 0 && (reinterpret_cast<uintptr_t>(flow) & 7) == 0;
  cudaError_t err;
  if (is_bf16) {
    err = wide ? launch<__nv_bfloat16, 2>(src, flow, b, c, h, w, out, stream)
               : launch<__nv_bfloat16, 1>(src, flow, b, c, h, w, out, stream);
  } else {
    err = wide ? launch<float, 2>(src, flow, b, c, h, w, out, stream)
               : launch<float, 1>(src, flow, b, c, h, w, out, stream);
  }
  return (int)err;
}
