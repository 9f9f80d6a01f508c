// Backward bilinear warps (resample2d), batched: two kernels, one for each
// of the JAX package's `warp_impl`s (ops/resample2d.py has both contracts
// and their plain versions). src is NCHW float32 or bfloat16, flow
// [B, 2, H, W] float32, the output NCHW float32 (the promoted type of src
// and flow).
//
// premvos_resample2d_block ("block", the default) replaces
// premvos_tpu/ops/pallas/resample2d_pallas.py::resample2d_block_pallas
// (_warp_kernel with _block_prep): each (by, bx) block of pixels samples a
// window of win = 2r + 2 rows and columns around its rounded mean
// displacement, and a pixel whose own displacement leaves the window is
// clamped to its edge. The TPU kernel DMAs each block's window into VMEM
// and sums win x win shifted FMAs there.
//
// What bounds it on the H100: bytes, B*H*W*(C*src + 8 + 4*C) (source,
// flow and output once, the exact warp's), against eight flops an output.
// Reading every tap from the image (the direct path below) ran at 2.2-2.4x
// that bound at FlowNet2's shape; instructions and serial phases (flow,
// sum, taps) more than DRAM set its time.
//
// Design: two paths, chosen by shape and alignment (never after a failure):
//   - staged, only at the main path's shape: (8, 128) blocks at residual 4
//     (FlowNet2's warps), on an image a tile large (h >= 18, w >= 138, w a
//     multiple of 16 bytes, a 16-byte aligned source) with at least two
//     image blocks an SM. One thread block a (block, channel group), 256
//     threads of four pixels (t, t + 256, ...), the geometry compiled in.
//     The thread block sums the displacements (block_window), copies each
//     channel's 18-row window tile into shared memory with 16-byte
//     cp.async pieces (the tile's origin clamped into the image, so JAX's
//     edge padding costs nothing, and its columns rounded down to 16 bytes:
//     18 x 152 bf16 or 18 x 144 float32 a channel), and reads each pixel's
//     four taps from there, neighbouring threads on neighbouring columns.
//   - direct, every other shape: each thread reads its pixels' four taps
//     of each channel from the image (clamped into it), one channel after
//     another. It takes the lucid warps' (16, 16) and (8, 8) blocks, whose
//     tiles would hold 3.25x and 9.6x their pixels, and the merge's 120
//     (8, 128) image blocks at [1, 8, 240, 432]: on fewer image blocks than
//     two an SM the channels split into as many groups as give every SM a
//     thread block (2 there).
// Both paths share the block's float64 sum (in order within a thread, warp
// shuffles, then warp 0 over the warps' sums), the tap arithmetic and the
// bilinear sum; every product and sum is rounded one by one (__fmul_rn,
// __fadd_rn, no contraction), in the plain version's order, so the kernel
// and the plain version agree to the bit.
//
// ptxas (-Xptxas=-v, sm_90a): staged 32 registers, bf16 and float32;
// direct K = 1, 2, 4, 8, 16 pixels a thread: 32, 40, 48, 64-80, 118-128
// registers. No spills. Each uses 144 bytes of static shared memory (the
// sum's exchange), and the staged path its tiles: the channels of a group
// times 5,472 bytes (bf16) or 10,368 (float32), 44 KB at most.

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
// The staged path's one shape: the TPU kernel's (8, 128) blocks at residual
// 4 (FlowNet2's warps), four pixels a thread, a window tile of kStageRows
// rows a channel.
constexpr int kStageBy = 8, kStageBx = 128, kStageR = 4;
constexpr int kStageWin = 2 * kStageR + 2;
constexpr int kStageRows = kStageBy + kStageWin;
constexpr int kStageK = kStageBy * kStageBx / kBlockThreads;
// The shared memory a staged thread block may take for its tiles (under the
// 48 KB that a launch takes without opting in to more).
constexpr int kStageBytes = 44 * 1024;

// Elements of a 16-byte piece, and the columns of a tile row: kStageBx +
// kStageWin from any origin rounded down to a piece.
template <typename T>
constexpr int kPiece = 16 / (int)sizeof(T);
template <typename T>
constexpr int kTileW = (kStageBx + kStageWin + 2 * kPiece<T> - 2) / kPiece<T> * kPiece<T>;

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// The clipped source coordinates of this thread's pixels of the (by, bx)
// block with origin (oy, ox) (thread t takes the block's pixels t, t +
// blockDim.x, ..., K of them at most) and the block's window start (ws_y,
// ws_x): the displacements summed in float64, by each thread in order, then
// by warp shuffles within each warp and across the warps' sums (warp 0), so
// the order is fixed; then the mean over the block's pixels inside the
// image, a float32 division rounded half to even (jnp.round).
template <int K>
__device__ __forceinline__ void block_window(const float* __restrict__ fu,
                                             const float* __restrict__ fv, int h, int w,
                                             int oy, int ox, int by, int bx, int r, float lf,
                                             float (&sy)[K], float (&sx)[K], int& ws_y,
                                             int& ws_x) {
  double sum_y = 0.0, sum_x = 0.0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = threadIdx.x + k * blockDim.x;
    const int y = oy + q / bx, x = ox + q % bx;
    sy[k] = sx[k] = 0.f;
    if (q < by * bx && y < h && x < w) {
      const int pix = y * w + x;
      const float yf = (float)y, xf = (float)x;
      sy[k] = fminf(fmaxf(__fadd_rn(yf, __ldg(fv + pix)), -lf), (float)(h - 1) + lf);
      sx[k] = fminf(fmaxf(__fadd_rn(xf, __ldg(fu + pix)), -lf), (float)(w - 1) + lf);
      sum_y += (double)__fsub_rn(sy[k], yf);
      sum_x += (double)__fsub_rn(sx[k], xf);
    }
  }
  __shared__ double warp_sums[kBlockThreads / 32][2];
  __shared__ int start[2];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum_y += __shfl_down_sync(0xffffffffu, sum_y, off);
    sum_x += __shfl_down_sync(0xffffffffu, sum_x, off);
  }
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    warp_sums[threadIdx.x >> 5][0] = sum_y;
    warp_sums[threadIdx.x >> 5][1] = sum_x;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const bool on = lane < (int)(blockDim.x >> 5);
    double ty = on ? warp_sums[lane][0] : 0.0, tx = on ? warp_sums[lane][1] : 0.0;
#pragma unroll
    for (int off = kBlockThreads / 64; off > 0; off >>= 1) {
      ty += __shfl_down_sync(0xffffffffu, ty, off);
      tx += __shfl_down_sync(0xffffffffu, tx, off);
    }
    if (lane == 0) {
      const float n = (float)(min(by, h - oy) * min(bx, w - ox));
      start[0] = oy + (int)rintf(__fdiv_rn((float)ty, n)) - r;
      start[1] = ox + (int)rintf(__fdiv_rn((float)tx, n)) - r;
    }
  }
  __syncthreads();
  ws_y = start[0];
  ws_x = start[1];
}

// One pixel's two taps a side in the window: the clamped rows y0, y1 and
// columns x0, x1 of the image, and their weights; the plain version's
// float32 operations, one by one.
struct Taps {
  int y0, y1, x0, x1;
  float wy0, wy1, wx0, wx1;
};

__device__ __forceinline__ Taps taps(float sy, float sx, int ws_y, int ws_x, int ry, int rx,
                                     int h, int w, float top) {
  const float ty = fminf(fmaxf(__fsub_rn(__fsub_rn(sy, (float)ws_y), (float)ry), 0.f), top);
  const float tx = fminf(fmaxf(__fsub_rn(__fsub_rn(sx, (float)ws_x), (float)rx), 0.f), top);
  const float dy = floorf(ty), dx = floorf(tx);
  Taps t;
  t.wy0 = fmaxf(0.f, 1.f - fabsf(ty - dy));
  t.wy1 = fmaxf(0.f, 1.f - fabsf(ty - (dy + 1.f)));
  t.wx0 = fmaxf(0.f, 1.f - fabsf(tx - dx));
  t.wx1 = fmaxf(0.f, 1.f - fabsf(tx - (dx + 1.f)));
  const int y0 = ws_y + ry + (int)dy, x0 = ws_x + rx + (int)dx;
  t.y0 = min(max(y0, 0), h - 1);
  t.y1 = min(max(y0 + 1, 0), h - 1);
  t.x0 = min(max(x0, 0), w - 1);
  t.x1 = min(max(x0 + 1, 0), w - 1);
  return t;
}

__device__ __forceinline__ float bilinear(const Taps& t, float a00, float a01, float a10,
                                          float a11) {
  const float a = __fadd_rn(__fmul_rn(t.wx0, a00), __fmul_rn(t.wx1, a01));
  const float d = __fadd_rn(__fmul_rn(t.wx0, a10), __fmul_rn(t.wx1, a11));
  return __fadd_rn(__fmul_rn(t.wy0, a), __fmul_rn(t.wy1, d));
}

// The staged path, at (kStageBy, kStageBx) blocks and residual kStageR on an
// image at least a tile large (h >= kStageRows, w >= kStageBx + kStageWin,
// w a multiple of kPiece<T>, a 16-byte aligned source): one thread block a
// (block of pixels, group of channels). After the window start, the thread
// block copies its window tile of each channel of its group into shared
// memory in 16-byte cp.async pieces: rows o_y .. o_y + kStageRows - 1, o_y =
// clamp(ws_y, 0, h - kStageRows), and kTileW<T> columns from a_x, the column
// origin clamped the same way and rounded down to a piece (those columns
// inside the image). Every clamped tap of the block lies in it: a pixel's
// taps lie in rows ws_y .. ws_y + kStageBy - 1 + win before the clamp, and
// kTileW covers the rounding (tests/test_torch_block_warp.py holds the rule
// against the plain version's taps). So the taps are shared-memory reads,
// neighbouring threads on neighbouring columns.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
resample_block_staged(const T* __restrict__ src, const float* __restrict__ flow, int c, int h,
                      int w, float lf, int groups, int group_size, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  constexpr int A = kPiece<T>, TW = kTileW<T>, K = kStageK;
  const int b = blockIdx.z / groups;
  const int ch0 = (blockIdx.z - b * groups) * group_size;
  const int nch = min(c, ch0 + group_size) - ch0;
  const int oy = blockIdx.y * kStageBy, ox = blockIdx.x * kStageBx;
  const size_t hw = (size_t)h * w;
  const float* fu = flow + (size_t)b * 2 * hw;

  float sy[K], sx[K];
  int ws_y, ws_x;
  block_window<K>(fu, fu + hw, h, w, oy, ox, kStageBy, kStageBx, kStageR, lf, sy, sx, ws_y,
                  ws_x);

  const int o_y = min(max(ws_y, 0), h - kStageRows);
  const int o_x = min(max(ws_x, 0), w - (kStageBx + kStageWin));
  const int a_x = o_x - o_x % A;
  // The copy: thread t takes piece t, t + kBlockThreads, ... of the tile's
  // rows of `pieces` pieces, channel after channel, (row, piece) stepped
  // without a division.
  constexpr int pieces = TW / A;
  constexpr int step_row = kBlockThreads / pieces, step_piece = kBlockThreads % pieces;
  int row = threadIdx.x / pieces, piece = threadIdx.x % pieces;
  const T* s = src + ((size_t)b * c + ch0) * hw + (size_t)o_y * w + a_x;
  T* dst = tile;
  for (int ch = 0; ch < nch; ++ch, s += hw, dst += kStageRows * TW) {
    for (; row < kStageRows; row += step_row) {
      const int col = piece * A;
      if (a_x + col < w)  // w % A == 0, so a piece is whole
        cp_async16(dst + row * TW + col, s + (size_t)row * w + col);
      piece += step_piece;
      if (piece >= pieces) {
        piece -= pieces;
        ++row;
      }
    }
    row -= kStageRows;
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
  __syncthreads();

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = threadIdx.x + k * kBlockThreads;
    const int ry = q / kStageBx, rx = q % kStageBx;
    const int y = oy + ry, x = ox + rx;
    if (y >= h || x >= w) continue;
    const Taps t = taps(sy[k], sx[k], ws_y, ws_x, ry, rx, h, w, (float)(kStageWin - 1));
    const int i00 = (t.y0 - o_y) * TW + t.x0 - a_x, i01 = i00 + t.x1 - t.x0;
    const int i10 = (t.y1 - o_y) * TW + t.x0 - a_x, i11 = i10 + t.x1 - t.x0;
    const T* tc = tile;
    float* o = out + ((size_t)b * c + ch0) * hw + (size_t)y * w + x;
    for (int ch = 0; ch < nch; ++ch, tc += kStageRows * TW, o += hw) {
      *o = bilinear(t, as_float(tc[i00]), as_float(tc[i01]), as_float(tc[i10]),
                    as_float(tc[i11]));
    }
  }
}

// The direct path: one thread block a block of pixels (and, for kGroups, a
// group of channels); thread t takes the block's pixels t, t + threads,
// ... (K of them at most), and reads its pixels' four taps of each channel
// from the image (clamped into it, JAX's edge padding).
template <typename T, int K, bool kGroups>
__global__ void __launch_bounds__(kBlockThreads)
resample_block_direct(const T* __restrict__ src, const float* __restrict__ flow,
                      int c, int h, int w, int by, int bx, int r, float lf, int groups,
                      int group_size, float* __restrict__ out) {
  const int b = kGroups ? blockIdx.z / groups : blockIdx.z;
  const int ch0 = kGroups ? (blockIdx.z - b * groups) * group_size : 0;
  const int ch1 = kGroups ? min(c, ch0 + group_size) : c;
  const int oy = blockIdx.y * by, ox = blockIdx.x * bx;
  const size_t hw = (size_t)h * w;
  const float* fu = flow + (size_t)b * 2 * hw;

  float sy[K], sx[K];
  int ws_y, ws_x;
  block_window<K>(fu, fu + hw, h, w, oy, ox, by, bx, r, lf, sy, sx, ws_y, ws_x);

  const float top = (float)(2 * r + 1);  // win - 1
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = threadIdx.x + k * blockDim.x;
    const int ry = q / bx, rx = q % bx;
    const int y = oy + ry, x = ox + rx;
    if (q >= by * bx || y >= h || x >= w) continue;
    const Taps t = taps(sy[k], sx[k], ws_y, ws_x, ry, rx, h, w, top);
    const int i00 = t.y0 * w + t.x0, i01 = t.y0 * w + t.x1;
    const int i10 = t.y1 * w + t.x0, i11 = t.y1 * w + t.x1;
    const T* s = src + ((size_t)b * c + ch0) * hw;
    float* o = out + ((size_t)b * c + ch0) * hw + y * w + x;
    for (int ch = ch0; ch < ch1; ++ch, s += hw, o += hw)
      *o = bilinear(t, load(s + i00), load(s + i01), load(s + i10), load(s + i11));
  }
}

template <typename T, int K>
cudaError_t run_direct(dim3 grid, int threads, const T* src, const float* flow, int c, int h,
                       int w, int by, int bx, int r, float lf, int groups, int group_size,
                       float* out, cudaStream_t stream) {
  if (groups > 1)
    resample_block_direct<T, K, true><<<grid, threads, 0, stream>>>(
        src, flow, c, h, w, by, bx, r, lf, groups, group_size, out);
  else
    resample_block_direct<T, K, false><<<grid, threads, 0, stream>>>(
        src, flow, c, h, w, by, bx, r, lf, 1, c, out);
  return cudaGetLastError();
}

// The current device's SM count, read once per device.
cudaError_t sm_count(int* sms) {
  static int cached[64];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev] == 0)
    err = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  *sms = cached[dev];
  return err;
}

// Splits c channels into groups of group_size, as near `want` groups as
// keeps them even; the grid's z then counts b * groups thread blocks.
cudaError_t channel_groups(int b, int c, int want, dim3* grid, int* groups, int* group_size) {
  want = max(1, min(want, c));
  *group_size = (c + want - 1) / want;
  *groups = (c + *group_size - 1) / *group_size;
  if ((long long)b * *groups > 65535) return cudaErrorInvalidValue;
  grid->z = b * *groups;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_block(const void* src_v, const float* flow, int b, int c, int h, int w,
                         int by, int bx, int r, int max_flow, float* out,
                         cudaStream_t stream) {
  const T* src = static_cast<const T*>(src_v);
  const float lf = (float)max_flow;
  dim3 grid((w + bx - 1) / bx, (h + by - 1) / by, b);
  const long long blocks = (long long)grid.x * grid.y * b;
  int sms, groups, group_size;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  // The path, by shape and alignment: staged at the main path's shape on at
  // least two image blocks an SM (FlowNet2's 3136), direct everywhere else.
  const bool staged = by == kStageBy && bx == kStageBx && r == kStageR && h >= kStageRows &&
                      w >= kStageBx + kStageWin && w % kPiece<T> == 0 &&
                      (reinterpret_cast<uintptr_t>(src) & 15) == 0 && blocks >= 2LL * sms;
  if (staged) {
    // Channel groups: as few as keep a thread block's tiles within
    // kStageBytes (each group repeats the block's flow reads, sum and tap
    // arithmetic).
    constexpr int tile_bytes = kStageRows * kTileW<T> * (int)sizeof(T);
    constexpr int most = kStageBytes / tile_bytes;  // channels a thread block
    err = channel_groups(b, c, (c + most - 1) / most, &grid, &groups, &group_size);
    if (err != cudaSuccess) return err;
    resample_block_staged<T><<<grid, kBlockThreads, group_size * tile_bytes, stream>>>(
        src, flow, c, h, w, lf, groups, group_size, out);
    return cudaGetLastError();
  }
  // Direct: on fewer image blocks than two an SM (the merge's 120), the
  // channels split into as many groups as give every SM a thread block.
  err = channel_groups(b, c, blocks < 2LL * sms ? (int)((sms + blocks - 1) / blocks) : 1, &grid,
                       &groups, &group_size);
  if (err != cudaSuccess) return err;
  const int npix = by * bx;
  const int threads = min(kBlockThreads, (npix + 31) / 32 * 32);
  const int per = (npix + threads - 1) / threads;  // pixels a thread, at most 16
  if (per <= 1)
    return run_direct<T, 1>(grid, threads, src, flow, c, h, w, by, bx, r, lf, groups,
                            group_size, out, stream);
  if (per <= 2)
    return run_direct<T, 2>(grid, threads, src, flow, c, h, w, by, bx, r, lf, groups,
                            group_size, out, stream);
  if (per <= 4)
    return run_direct<T, 4>(grid, threads, src, flow, c, h, w, by, bx, r, lf, groups,
                            group_size, out, stream);
  if (per <= 8)
    return run_direct<T, 8>(grid, threads, src, flow, c, h, w, by, bx, r, lf, groups,
                            group_size, out, stream);
  return run_direct<T, 16>(grid, threads, src, flow, c, h, w, by, bx, r, lf, groups, group_size,
                           out, stream);
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
