// Greedy NMS over score-sorted boxes, batched over images.
//
// Replaces premvos_tpu/ops/pallas/nms_pallas.py::nms_pallas (_nms_kernel).
// Contract (ops/nms.py): boxes [B, N, 4] xyxy float32, already sorted by
// descending score; alive [B, N] (score above the threshold). Box j is
// suppressed by an earlier kept box i when IoU(i, j) > iou_threshold. Output
// keep [B, N] (uint8, zero-initialised by the caller). The sort and the
// compaction of kept indices stay in PyTorch.
//
// Two kernels:
//   1. nms_mask_kernel: one 64-thread block per (row block, column block,
//      image). Thread r sets bit c of a 64-bit word when box c (later in
//      score order) overlaps box r above the threshold. O(N^2) IoUs, fully
//      parallel; the [B, N, ceil(N/64)] mask is the only scratch.
//   2. nms_sweep_kernel: one warp per image walks the boxes in order,
//      keeping a bitmask of removed boxes in shared memory and OR-ing in the
//      mask row of every kept box. It stops once max_outputs boxes are kept:
//      the compaction uses only the first max_outputs kept indices.
//
// What bounds it: the sweep is a sequential chain (one step per box, latency
// bound); the mask pass is N^2/2 IoUs of a few flops each, far below the
// card's rate. Exactness: IoU is computed in the same operation order as
// ops/boxes.py::box_iou with IEEE-rounded intrinsics (never contracted into
// FMAs) and IEEE division, and max/min propagate NaN as torch.maximum does,
// so every comparison equals the plain PyTorch version's. Do not build with
// --use_fast_math.

#include "premvos_kernels.h"

namespace {

constexpr int kBits = 64;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float area(const float* b) {
  return __fmul_rn(nan_max(__fsub_rn(b[2], b[0]), 0.f),
                   nan_max(__fsub_rn(b[3], b[1]), 0.f));
}

__device__ __forceinline__ float iou(const float* a, const float* b) {
  const float ww = nan_max(__fsub_rn(nan_min(a[2], b[2]), nan_max(a[0], b[0])), 0.f);
  const float hh = nan_max(__fsub_rn(nan_min(a[3], b[3]), nan_max(a[1], b[1])), 0.f);
  const float inter = __fmul_rn(ww, hh);
  const float uni = __fsub_rn(__fadd_rn(area(a), area(b)), inter);
  return uni > 0.f ? __fdiv_rn(inter, nan_max(uni, 1e-12f)) : 0.f;
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes, int n,
                                int words, float thr,
                                unsigned long long* __restrict__ mask) {
  const int b = blockIdx.z;
  const int row_start = blockIdx.y * kBits;
  const int col_start = blockIdx.x * kBits;
  const int row_n = min(n - row_start, kBits);
  const int col_n = min(n - col_start, kBits);
  const float* bb = boxes + (size_t)b * n * 4;

  __shared__ float cols[kBits * 4];
  if (threadIdx.x < col_n) {
    for (int k = 0; k < 4; ++k)
      cols[threadIdx.x * 4 + k] = bb[(col_start + threadIdx.x) * 4 + k];
  }
  __syncthreads();
  if (threadIdx.x >= row_n) return;

  const int i = row_start + threadIdx.x;
  float a[4];
  for (int k = 0; k < 4; ++k) a[k] = bb[i * 4 + k];
  unsigned long long bits = 0ULL;
  if (col_start + col_n - 1 > i) {
    for (int j = 0; j < col_n; ++j) {
      if (col_start + j > i && iou(a, cols + j * 4) > thr) bits |= 1ULL << j;
    }
  }
  mask[((size_t)b * n + i) * words + blockIdx.x] = bits;
}

__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                                 const uint8_t* __restrict__ alive, int n,
                                 int words, int max_outputs,
                                 uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x;
  const unsigned long long* m = mask + (size_t)b * n * words;
  const uint8_t* al = alive + (size_t)b * n;
  uint8_t* kp = keep + (size_t)b * n;
  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0ULL;
  __syncwarp();

  int kept = 0;
  for (int i = 0; i < n && kept < max_outputs; ++i) {
    const bool k = al[i] && !((removed[i / kBits] >> (i % kBits)) & 1ULL);
    __syncwarp();
    if (k) {
      for (int w = i / kBits + threadIdx.x; w < words; w += blockDim.x)
        removed[w] |= m[(size_t)i * words + w];
      if (threadIdx.x == 0) kp[i] = 1;
      ++kept;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int premvos_nms(const float* boxes, const uint8_t* alive,
                           int batch, int n, float iou_threshold,
                           int max_outputs, unsigned long long* mask_scratch,
                           uint8_t* keep, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int words = (n + kBits - 1) / kBits;
  nms_mask_kernel<<<dim3(words, words, batch), kBits, 0, stream>>>(
      boxes, n, words, iou_threshold, mask_scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_sweep_kernel<<<batch, 32, words * sizeof(unsigned long long), stream>>>(
      mask_scratch, alive, n, words, max_outputs, keep);
  return (int)cudaGetLastError();
}
