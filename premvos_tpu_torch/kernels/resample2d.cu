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
// Design (the flownet2 resample2d_kernel.cu design): one thread per output
// pixel computes its four clamped taps and weights once and loops over the
// C channels. Consecutive threads are consecutive pixels of a row, so the
// flow loads, the output stores and (for smooth flow) the taps coalesce.
//
// What bounds it: memory — B*H*W*(C*4 taps + 2 flow + C out) elements, four
// flops per tap.

#include <cuda_bf16.h>

#include "premvos_kernels.h"

namespace {

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void resample_kernel(const T* __restrict__ src,
                                const float* __restrict__ flow, int b, int c,
                                int h, int w, float* __restrict__ out) {
  const size_t hw = (size_t)h * w;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)b * hw) return;
  const size_t bi = idx / hw;
  const size_t pix = idx % hw;
  const int y = (int)(pix / w);
  const int x = (int)(pix % w);
  const float* fl = flow + bi * 2 * hw;
  const float sx = fminf(fmaxf((float)x + fl[pix], 0.f), (float)(w - 1));
  const float sy = fminf(fmaxf((float)y + fl[hw + pix], 0.f), (float)(h - 1));
  const int x0 = (int)floorf(sx);
  const int y0 = (int)floorf(sy);
  const int x1 = min(x0 + 1, w - 1);
  const int y1 = min(y0 + 1, h - 1);
  const float wx = sx - (float)x0;
  const float wy = sy - (float)y0;
  const size_t i00 = (size_t)y0 * w + x0, i01 = (size_t)y0 * w + x1;
  const size_t i10 = (size_t)y1 * w + x0, i11 = (size_t)y1 * w + x1;
  const T* s = src + bi * c * hw;
  float* o = out + bi * c * hw + pix;
  for (int ch = 0; ch < c; ++ch) {
    const T* p = s + (size_t)ch * hw;
    const float top = load(p + i00) * (1.f - wx) + load(p + i01) * wx;
    const float bot = load(p + i10) * (1.f - wx) + load(p + i11) * wx;
    o[(size_t)ch * hw] = top * (1.f - wy) + bot * wy;
  }
}

}  // namespace

extern "C" int premvos_resample2d(const void* src, int is_bf16,
                                  const float* flow, int b, int c, int h,
                                  int w, float* out, cudaStream_t stream) {
  const size_t total = (size_t)b * h * w;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (is_bf16) {
    resample_kernel<__nv_bfloat16><<<blocks, threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(src), flow, b, c, h, w, out);
  } else {
    resample_kernel<float><<<blocks, threads, 0, stream>>>(
        static_cast<const float*>(src), flow, b, c, h, w, out);
  }
  return (int)cudaGetLastError();
}
