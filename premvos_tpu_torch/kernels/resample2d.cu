// Backward bilinear warps (resample2d), batched: two kernels, one for each
// of the JAX package's `warp_impl`s (ops/resample2d.py has both contracts
// and their plain versions). src is NCHW float32 or bfloat16, flow
// [B, 2, H, W] float32, the output NCHW float32 (the promoted type of src
// and flow).
//
// premvos_resample2d_block ("block", the default) replaces
// premvos_tpu/ops/pallas/resample2d_pallas.py::resample2d_block_pallas
// (_warp_kernel with _block_prep): each (by, bx) block of pixels samples a
// window of 2r + 2 rows and columns around its rounded mean displacement,
// and a pixel whose own displacement leaves the window is clamped to its
// edge. It is bound by bytes, the same bytes as the exact warp. The TPU
// kernel DMAs each block's window into VMEM and sums win x win shifted
// FMAs there; on the H100 the two-tap sum needs no staging: one thread
// block a block of pixels, each thread keeps its pixels' clipped source
// coordinates in registers, the block sums the displacements (float64,
// warp shuffles, then shared memory) to its window start, and each thread
// reads its pixels' two rows and two columns of the window (clamped into
// the image, JAX's edge padding) for every channel; neighbouring threads
// take neighbouring columns, so the reads and the writes coalesce. The
// products and sums are rounded one by one (__fmul_rn, __fadd_rn, no
// contraction), in the plain version's order, so the two agree to the bit.
//
// premvos_resample2d ("gather") is the exact bilinear warp:
//   out[b, c, y, x] = bilinear(src[b, c], y + flow[b, 1, y, x],
//                                         x + flow[b, 0, y, x])
// with the sample point clamped into the image (edge clamp), exactly
// premvos_tpu/ops/resample2d.py::resample2d_reference (the JAX package's
// XLA gather warp, which has no TPU kernel) for any flow.
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

// ---------------------------------------------------------------- block warp

constexpr int kBlockThreads = 256;  // at most; a small block takes fewer

// One thread block per (by, bx) block of pixels of one image; thread t
// takes the block's pixels t, t + threads, ... (K of them at most).
template <typename T, int K>
__global__ void __launch_bounds__(kBlockThreads)
resample_block_kernel(const T* __restrict__ src, const float* __restrict__ flow,
                      int c, int h, int w, int by, int bx, int r, float lf,
                      float* __restrict__ out) {
  const int b = blockIdx.z;
  const int oy = blockIdx.y * by;
  const int ox = blockIdx.x * bx;
  const int npix = by * bx;
  const size_t hw = (size_t)h * w;
  const float* fu = flow + (size_t)b * 2 * hw;
  const float* fv = fu + hw;

  // Clipped source coordinates and the block's displacement sums.
  float sy[K], sx[K];
  double sum_y = 0.0, sum_x = 0.0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = threadIdx.x + k * blockDim.x;
    const int y = oy + q / bx;
    const int x = ox + q % bx;
    sy[k] = sx[k] = 0.f;
    if (q < npix && y < h && x < w) {
      const int pix = y * w + x;
      const float yf = (float)y, xf = (float)x;
      sy[k] = fminf(fmaxf(__fadd_rn(yf, __ldg(fv + pix)), -lf), (float)(h - 1) + lf);
      sx[k] = fminf(fmaxf(__fadd_rn(xf, __ldg(fu + pix)), -lf), (float)(w - 1) + lf);
      sum_y += (double)__fsub_rn(sy[k], yf);
      sum_x += (double)__fsub_rn(sx[k], xf);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum_y += __shfl_down_sync(0xffffffffu, sum_y, off);
    sum_x += __shfl_down_sync(0xffffffffu, sum_x, off);
  }
  __shared__ double warp_sums[kBlockThreads / 32][2];
  __shared__ int start[2];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    warp_sums[wid][0] = sum_y;
    warp_sums[wid][1] = sum_x;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double ty = 0.0, tx = 0.0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
      ty += warp_sums[i][0];
      tx += warp_sums[i][1];
    }
    // The mean over the pixels inside the image, a float32 division
    // rounded half to even (jnp.round).
    const float n = (float)(min(by, h - oy) * min(bx, w - ox));
    start[0] = oy + (int)rintf(__fdiv_rn((float)ty, n)) - r;
    start[1] = ox + (int)rintf(__fdiv_rn((float)tx, n)) - r;
  }
  __syncthreads();
  const int ws_y = start[0], ws_x = start[1];
  const float ws_yf = (float)ws_y, ws_xf = (float)ws_x;
  const float top = (float)(2 * r + 1);  // win - 1

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = threadIdx.x + k * blockDim.x;
    const int ry = q / bx, rx = q % bx;
    const int y = oy + ry, x = ox + rx;
    if (q >= npix || y >= h || x >= w) continue;
    // Local coordinates in the window, and the two taps a side.
    const float ty = fminf(fmaxf(__fsub_rn(__fsub_rn(sy[k], ws_yf), (float)ry), 0.f), top);
    const float tx = fminf(fmaxf(__fsub_rn(__fsub_rn(sx[k], ws_xf), (float)rx), 0.f), top);
    const float dy = floorf(ty), dx = floorf(tx);
    const float wy0 = fmaxf(0.f, 1.f - fabsf(ty - dy));
    const float wy1 = fmaxf(0.f, 1.f - fabsf(ty - (dy + 1.f)));
    const float wx0 = fmaxf(0.f, 1.f - fabsf(tx - dx));
    const float wx1 = fmaxf(0.f, 1.f - fabsf(tx - (dx + 1.f)));
    const int y0 = ws_y + ry + (int)dy, x0 = ws_x + rx + (int)dx;
    const int r0 = min(max(y0, 0), h - 1) * w, r1 = min(max(y0 + 1, 0), h - 1) * w;
    const int c0 = min(max(x0, 0), w - 1), c1 = min(max(x0 + 1, 0), w - 1);
    const T* s = src + (size_t)b * c * hw;
    float* o = out + (size_t)b * c * hw + y * w + x;
    for (int ch = 0; ch < c; ++ch, s += hw, o += hw) {
      const float a = __fadd_rn(__fmul_rn(wx0, load(s + r0 + c0)), __fmul_rn(wx1, load(s + r0 + c1)));
      const float d = __fadd_rn(__fmul_rn(wx0, load(s + r1 + c0)), __fmul_rn(wx1, load(s + r1 + c1)));
      *o = __fadd_rn(__fmul_rn(wy0, a), __fmul_rn(wy1, d));
    }
  }
}

template <typename T, int K>
cudaError_t launch_block_k(const void* src, const float* flow, int b, int c, int h, int w,
                           int by, int bx, int r, int max_flow, int threads, float* out,
                         cudaStream_t stream) {
  const dim3 grid((w + bx - 1) / bx, (h + by - 1) / by, b);
  resample_block_kernel<T, K><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(src), flow, c, h, w, by, bx, r, (float)max_flow, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_block(const void* src, const float* flow, int b, int c, int h, int w,
                         int by, int bx, int r, int max_flow, float* out,
                         cudaStream_t stream) {
  // Threads: the block's pixels rounded up to whole warps, 256 at most;
  // pixels a thread: the next power of two that covers the rest.
  const int npix = by * bx;
  const int threads = min(kBlockThreads, (npix + 31) / 32 * 32);
  const int per = (npix + threads - 1) / threads;
#define PREMVOS_BLOCK_K(K)                                                           \
  if (per <= K)                                                                      \
    return launch_block_k<T, K>(src, flow, b, c, h, w, by, bx, r, max_flow, threads, out, \
                                stream);
  PREMVOS_BLOCK_K(1)
  PREMVOS_BLOCK_K(2)
  PREMVOS_BLOCK_K(4)
  PREMVOS_BLOCK_K(8)
  PREMVOS_BLOCK_K(16)
#undef PREMVOS_BLOCK_K
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int premvos_resample2d_block(const void* src, int is_bf16, const float* flow,
                                        int b, int c, int h, int w, int by, int bx,
                                        int residual, int max_flow, float* out,
                                        cudaStream_t stream) {
  if (b <= 0 || c <= 0 || h <= 0 || w <= 0) return 0;
  if ((long long)h * w >= (1LL << 31) || by < 1 || bx < 1 || by * bx > 16 * kBlockThreads ||
      residual < 0 || max_flow < 0 || b > 65535 || (h + by - 1) / by > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      is_bf16 ? launch_block<__nv_bfloat16>(src, flow, b, c, h, w, by, bx, residual, max_flow,
                                            out, stream)
              : launch_block<float>(src, flow, b, c, h, w, by, bx, residual, max_flow, out,
                                    stream);
  return (int)err;
}

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
