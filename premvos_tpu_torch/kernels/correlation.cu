// FlowNetC cost volume (forward), float32.
//
// Replaces premvos_tpu/ops/pallas/correlation_pallas.py::correlation_pallas
// (_corr_kernel). Contract (ops/correlation.py):
//   out[b, i*D + j, y, x] = (1/C) * sum_c f1[b, y, x, c] *
//                           f2[b, y + i*stride - md, x + j*stride - md, c]
// with D = 2*(md/stride) + 1 and f2 zero outside the image. Inputs are
// [B, H, W, C] (channels innermost); the output is NCHW [B, D*D, H, W], the
// layout the next convolution (conv3_1) reads.
//
// Design: one block per (32-column tile, row, image). The f1 tile
// [32][C] stays in shared memory for the whole block. For each of the D row
// displacements the block streams the f2 row segment the tile can reach
// ([32 + (D-1)*stride] columns) through shared memory in chunks of 32
// channels; each thread owns up to kAcc (column, column displacement)
// outputs and accumulates them in registers in float32. Consecutive threads
// own consecutive columns, so shared-memory reads are conflict-free (rows
// padded by one word) and the output stores coalesce. The sum is divided by
// the true C at the end.
//
// What bounds it: the 2*B*H*W*D^2*C flops in float32 on the CUDA cores (no
// tensor cores); each thread reads two shared-memory words per multiply-add.

#include "premvos_kernels.h"

namespace {

constexpr int kTile = 32;     // output columns per block
constexpr int kChunk = 32;    // f2 channels per shared-memory chunk
constexpr int kThreads = 256;
constexpr int kAcc = 4;       // outputs per thread per row displacement

__global__ void __launch_bounds__(kThreads)
corr_kernel(const float* __restrict__ f1, const float* __restrict__ f2, int h,
            int w, int c, int md, int stride, int d, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int x0 = blockIdx.x * kTile;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int span = kTile + (d - 1) * stride;
  const int ld1 = c + 1;
  const int ld2 = kChunk + 1;
  float* s1 = smem;               // [kTile][c + 1]
  float* s2 = smem + kTile * ld1;  // [span][kChunk + 1]

  const float* row1 = f1 + ((size_t)b * h + y) * w * c;
  for (int e = threadIdx.x; e < kTile * c; e += kThreads) {
    const int t = e / c, ch = e % c;
    const int x = x0 + t;
    s1[t * ld1 + ch] = x < w ? row1[(size_t)x * c + ch] : 0.f;
  }

  const int nout = kTile * d;  // (column, column displacement) pairs
  for (int i = 0; i < d; ++i) {
    const int y2 = y + i * stride - md;
    float acc[kAcc];
    for (int q = 0; q < kAcc; ++q) acc[q] = 0.f;
    if (y2 >= 0 && y2 < h) {  // uniform across the block
      const float* row2 = f2 + ((size_t)b * h + y2) * w * c;
      for (int c0 = 0; c0 < c; c0 += kChunk) {
        const int cn = min(kChunk, c - c0);
        __syncthreads();
        for (int e = threadIdx.x; e < span * kChunk; e += kThreads) {
          const int t = e / kChunk, k = e % kChunk;
          const int x2 = x0 - md + t;
          s2[t * ld2 + k] = (k < cn && x2 >= 0 && x2 < w)
                                ? row2[(size_t)x2 * c + c0 + k]
                                : 0.f;
        }
        __syncthreads();
        for (int q = 0; q < kAcc; ++q) {
          const int o = threadIdx.x + q * kThreads;
          if (o < nout) {
            const int t = o % kTile, j = o / kTile;
            const float* a = s1 + t * ld1 + c0;
            const float* v = s2 + (t + j * stride) * ld2;
            float sum = 0.f;
            for (int k = 0; k < cn; ++k) sum += a[k] * v[k];
            acc[q] += sum;
          }
        }
      }
    }
    for (int q = 0; q < kAcc; ++q) {
      const int o = threadIdx.x + q * kThreads;
      const int t = o % kTile, j = o / kTile;
      const int x = x0 + t;
      if (o < nout && x < w) {
        out[(((size_t)b * d * d + i * d + j) * h + y) * w + x] = acc[q] / (float)c;
      }
    }
  }
}

}  // namespace

extern "C" int premvos_correlation(const float* f1, const float* f2, int b,
                                   int h, int w, int c, int md, int stride,
                                   float* out, cudaStream_t stream) {
  if (b <= 0 || h <= 0 || w <= 0) return 0;
  const int d = 2 * (md / stride) + 1;
  if (kTile * d > kAcc * kThreads) return (int)cudaErrorInvalidValue;
  const int span = kTile + (d - 1) * stride;
  const size_t smem = sizeof(float) * ((size_t)kTile * (c + 1) +
                                       (size_t)span * (kChunk + 1));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        corr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((w + kTile - 1) / kTile, h, b);
  corr_kernel<<<grid, kThreads, smem, stream>>>(f1, f2, h, w, c, md, stride, d,
                                                out);
  return (int)cudaGetLastError();
}
