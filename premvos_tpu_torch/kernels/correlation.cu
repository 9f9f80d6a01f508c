// FlowNetC cost volume (forward) on the tensor cores.
//
// Replaces premvos_tpu/ops/pallas/correlation_pallas.py::correlation_pallas
// (_corr_kernel). Contract (ops/correlation.py):
//   out[b, i*D + j, y, x] = (1/C) * sum_c f1[b, y, x, c] *
//                           f2[b, y + i*s - md, x + j*s - md, c]
// with D = 2*(md/s) + 1 and f2 zero outside the image. Inputs are
// channels-last [B, H, W, C], bfloat16 or float32, any C, D and stride; the
// output is float32 NCHW [B, D*D, H, W], the layout conv3_1 reads.
//
// What bounds it on the H100: with bf16 inputs, bytes (at FlowNetC's
// [8, 256, 56, 104] the inputs and the output are 129.9 MB, 0.039 ms at
// 3.35 TB/s, against 10.5 GFLOP, 0.011 ms on the tensor cores).
//
// Design: the cost volume is a banded matrix product. For an output row y,
// a row displacement i and 16 output columns x = x0 + s*t (t < 16) of one
// residue class mod s, f2 column x - md + s*j is x0 - md + s*u with
// u = t + j, so the outputs are the band P[t, t + j] of
// P = F1[y, x(t), :] . F2[y2, col(u), :]^T, u < D + 15: a 16 x 8n product
// (n = ceil((D + 15) / 8) tiles of 8), about half of it in the band at
// D = 21, which one warp computes with mma.sync.
//   - A block covers those 16 columns in 8 output rows y, y+s, ... (one
//     warp per row). A warp holds its 16 f1 pixels' channels in registers as
//     A fragments (256 bf16 or 128 float32 channels at a time; later
//     channel blocks add to the output), so f1 takes no shared memory.
//   - The block's f2 rows y2 = y_start - md + s*q are staged once each, in
//     512-byte channel chunks (all of a 256-channel bf16 row, so one
//     barrier per staged row), through a 4-deep ring filled with cp.async
//     (16-byte pieces, zero-filled off the image); each staged row serves
//     every row of the block it pairs with (up to 8), and rows are swizzled
//     (16-byte chunk ^ row mod 8) so ldmatrix reads them without bank
//     conflicts.
//   - bf16 inputs: m16n8k16 in bf16 with float32 sums (each product is
//     exact). float32 inputs: 3xTF32 (x = big + small, each tf32;
//     small*big + big*small + big*big in m16n8k8), within about 2^-21 of
//     each float32 product, where bf16 pieces would keep only 2^-16.
//   - Each warp puts its band through its own part of a shared-memory
//     tile [row][j][t] and writes it out as rows of 16 columns, once per
//     staged f2 row, with no block barrier; outputs whose f2 row is off the
//     image are written as zeros first. f2 columns past u = D + 14 meet no
//     output of the band and are not staged.
//   - Any D: the u range is cut into groups of 5 n-tiles (20 accumulators
//     per thread) and the block's rows shrink until the tiles fit.
// What holds it (PERF.md, section 6): the staged f2 bytes (each f2 row goes
// through L2 to about 3.5 blocks), the tensor-core work spent off the band
// with mma.sync, and the barrier per staged row that keeps a block's 8
// warps in step, at two blocks per SM (128 registers a thread).

#include <cuda_bf16.h>

#include <type_traits>

#include "premvos_kernels.h"

namespace {

constexpr int kM = 16;       // output columns per residue class per warp
constexpr int kRowBytes = 512;  // bytes of a staged f2 column chunk
constexpr int kNG = 5;       // n-tiles (8 f2 columns each) per group
constexpr int kStages = 4;   // depth of the f2 ring
constexpr int kWarps = 8;
constexpr int kSmemMax = 227 * 1024;

struct Params {
  const void* f1;
  const void* f2;
  float* out;
  int h, w, c, md, s, d;
  int rows;     // R: output rows per block, all of one residue mod s
  int groups;   // row groups per residue: ceil(ceil(H / s) / R)
  int tiles;    // column tiles of 16 * s columns: ceil(W / (16 * s))
  int nt;       // n-tiles per (row, displacement): ceil((D + 15) / 8)
  int ng;       // n-tile groups: ceil(nt / kNG)
  int ngw;      // n-tiles of a full group: min(nt, kNG)
  int async16;  // rows of whole 16-byte pieces, 16-byte aligned: cp.async
};

// Shared memory: the f2 ring, then the output tile.
__host__ __device__ inline int stage_bytes(const Params& p) {
  return p.ngw * 8 * kRowBytes;
}
__host__ __device__ inline int out_bytes(const Params& p) {
  return p.rows * p.d * kM * 4;
}

// Offset of byte `byte` of row `row` in a tile of `chunks` 16-byte chunks per
// row (a multiple of 8), the chunk index swizzled by the row, so that eight
// rows read at one chunk hit eight different bank groups.
__device__ __forceinline__ int swz(int row, int byte, int chunks) {
  const int ch = byte >> 4;
  return (row * chunks + (((ch ^ row) & 7) | (ch & ~7))) * 16 + (byte & 15);
}

__device__ __forceinline__ void cp_async16(char* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix4(unsigned (&r)[4], const char* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a . b on the tensor cores: m16n8k16 in bf16, m16n8k8 in tf32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = big + small, each rounded to tf32 (11 significant bits each).
__device__ __forceinline__ void split_tf32(unsigned x, unsigned& big, unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(__uint_as_float(x)));
  const float rest = __uint_as_float(x) - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

__device__ __forceinline__ unsigned bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned short bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// One 16-byte piece (16 / sizeof(In) channels from channel ch0) of an input
// row into shared memory; zeros where `row` is null or past C.
template <typename In>
__device__ __forceinline__ void load_piece(char* dst, const In* row, int ch0,
                                           int c, bool async, const void* any) {
  constexpr int V = 16 / sizeof(In);
  if (async) {
    const bool ok = row != nullptr && ch0 < c;
    cp_async16(dst, ok ? static_cast<const void*>(row + ch0) : any, ok);
  } else {
    __align__(16) In v[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      v[e] = (row != nullptr && ch0 + e < c) ? row[ch0 + e] : In(0.f);
    }
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}

// A fragment register (32 bits) of the f1 tile: channels ch, ch + 1 of a
// bf16 pixel row, or channel ch of a float32 one; zeros off the tile.
__device__ __forceinline__ unsigned a_word(const __nv_bfloat16* px, int ch, int c) {
  const unsigned lo = (px != nullptr && ch < c) ? bits(px[ch]) : 0u;
  const unsigned hi = (px != nullptr && ch + 1 < c) ? bits(px[ch + 1]) : 0u;
  return lo | (hi << 16);
}
__device__ __forceinline__ unsigned a_word(const float* px, int ch, int c) {
  return (px != nullptr && ch < c) ? bits(px[ch]) : 0u;
}

template <typename In>
__global__ void __launch_bounds__(32 * kWarps, 2)
corr_kernel(const Params p) {
  constexpr bool kF32 = std::is_same<In, float>::value;
  constexpr int E = sizeof(In);
  constexpr int kKC = kRowBytes / E;      // channels per staged chunk
  constexpr int kStep = kF32 ? 8 : 16;    // channels per MMA k-step
  constexpr int kSC = kF32 ? 128 : 256;   // f1 channels held in registers
  constexpr int kKS = kSC / kStep;        // k-steps in registers (16)
  constexpr int kMaxKC = kSC / kKC;       // staged chunks per register load
  constexpr int kKSPerKC = kKC / kStep;   // k-steps per staged chunk
  constexpr int kPieces = kRowBytes / 16; // 16-byte pieces per staged row
  extern __shared__ __align__(128) char smem[];

  const int s = p.s, d = p.d, rows = p.rows;
  // Block (column tile, column residue r, row group): output columns
  // x0 + s*t (t < 16, x0 = 16*s*tile + r) of rows y_start + s*k (k < R).
  const int tile = blockIdx.x / s, r = blockIdx.x - tile * s;
  const int x0 = tile * s * kM + r;
  const int residue = blockIdx.y / p.groups;
  const int y_start = residue + s * rows * (blockIdx.y - residue * p.groups);
  const int b = blockIdx.z;
  if (y_start >= p.h) return;  // uniform: this group has no rows

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tig = lane & 3;
  const int task_k = warp;  // one output row per warp
  const int task_y = y_start + s * task_k;
  const bool task_on = task_y < p.h;

  const int sbytes = stage_bytes(p);
  char* ring = smem;
  float* outs = reinterpret_cast<float*>(smem + kStages * sbytes);
  const In* f1 = static_cast<const In*>(p.f1);
  const In* f2 = static_cast<const In*>(p.f2);
  const size_t img = (size_t)b * p.h;
  const size_t plane = (size_t)p.h * p.w;
  const bool async = p.async16 != 0;
  const float inv_c = 1.f / (float)p.c;

  // Staged f2 rows: those on the image, q in [q_lo, q_hi].
  const int q_lo = p.md > y_start ? (p.md - y_start + s - 1) / s : 0;
  const int q_hi = min(rows + d - 2, (p.h - 1 - y_start + p.md) / s);

  // The warp's output row, displacement row i (every j), to global memory,
  // half a warp per j and a lane per column: its part of the output tile
  // stored (mode 0) or added (mode 1, after the first channel block), or
  // zeros (mode 2). Each warp writes only its own row, so no other warp
  // waits for it.
  const int wt = lane & 15;
  const bool w_on = task_on && x0 + s * wt < p.w;
  const float* t_row = outs + task_k * d * kM + wt;
  auto write_row = [&](int i, int mode) {
    float* o = p.out + (((size_t)b * d + i) * d * plane) + (size_t)task_y * p.w + x0 + s * wt;
    for (int j = lane >> 4; j < d && w_on; j += 2) {
      float* oj = o + j * plane;
      *oj = mode == 2 ? 0.f : mode == 1 ? *oj + t_row[j * kM] : t_row[j * kM];
    }
  };

  // Outputs whose f2 row lies off the image are zero.
  for (int i = 0; i < d; ++i) {
    const int y2 = task_y + s * i - p.md;
    if (y2 < 0 || y2 >= p.h) write_row(i, 2);
  }
  if (q_hi < q_lo) return;

  // This lane's f1 pixels: A rows t = lane/4 and lane/4 + 8 of its task.
  const In* px[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = x0 + s * ((lane >> 2) + 8 * h);
    px[h] = (task_on && x < p.w) ? f1 + ((img + task_y) * p.w + x) * p.c : nullptr;
  }
  // Its staged pieces: chunk q16 of rows ul0, ul0 + step, ... (row ul
  // holds f2 column x0 - md + s * (u0 + ul)).
  const int q16 = tid % kPieces, ul0 = tid / kPieces, ul_step = nthreads / kPieces;
  // Its ldmatrix rows: lanes 8m..8m+7 give the rows of 8x8 matrix m (row
  // 8n + lane % 8 of n-tile n, whose swizzle is that of lane % 8).
  const int b_off = (lane & 7) * kRowBytes;
  // Its place in the output tile [k][j][t], for rows t and t + 8.
  float* ob = outs + task_k * d * kM + (lane >> 2);

  // The channels go in blocks of kSC, each held in registers as A fragments
  // while every f2 row streams past; blocks after the first add to the
  // output.
  for (int c0 = 0; c0 < p.c; c0 += kSC) {
    const int nkc = min(kMaxKC, (p.c - c0 + kKC - 1) / kKC);
    const int n_stages = (q_hi - q_lo + 1) * p.ng * nkc;

    unsigned a[kKS][4];
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const int ch = c0 + ks * kStep + (kF32 ? tig : 2 * tig);
      const int hi = kStep / 2;  // the second half of the k-step
      a[ks][0] = a_word(px[0], ch, p.c);
      a[ks][1] = a_word(px[1], ch, p.c);
      a[ks][2] = a_word(px[0], ch + hi, p.c);
      a[ks][3] = a_word(px[1], ch + hi, p.c);
    }

    // The producer's next stage (q, n-group, chunk) and its ring slot.
    int pq = q_lo, pg = 0, pkc = 0, pst = 0;
    auto issue = [&]() {
      if (pst < n_stages) {
        // Rows past u = D + 14 meet no output of the band: they stay
        // unloaded, and the products that read them are never extracted.
        const int ntg8 = min(min(kNG, p.nt - pg * kNG) * 8, d + kM - 1 - pg * kNG * 8);
        char* buf = ring + (pst % kStages) * sbytes;
        const In* row2 = f2 + (img + y_start - p.md + s * pq) * p.w * p.c;
        const int ch = c0 + pkc * kKC + q16 * (16 / E);
        const int xg = x0 - p.md + s * pg * kNG * 8;
        for (int ul = ul0; ul < ntg8; ul += ul_step) {
          const int xc = xg + s * ul;
          const In* src = (xc >= 0 && xc < p.w) ? row2 + (size_t)xc * p.c : nullptr;
          load_piece<In>(buf + swz(ul, q16 * 16, kPieces), src, ch, p.c, async, f2);
        }
        if (++pkc == nkc) {
          pkc = 0;
          if (++pg == p.ng) {
            pg = 0;
            ++pq;
          }
        }
      }
      ++pst;
      cp_async_commit();
    };

    __syncthreads();  // the ring and the output tile are free
    for (int k = 0; k < kStages - 1; ++k) issue();
    int st = 0;
    for (int q = q_lo; q <= q_hi; ++q) {
      const int i = q - task_k;
      const bool active = task_on && i >= 0 && i < d;
      for (int g = 0; g < p.ng; ++g) {
        const int ntg = min(kNG, p.nt - g * kNG);
        float acc[kNG][4];
#pragma unroll
        for (int n = 0; n < kNG; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
        for (int kc = 0; kc < kMaxKC; ++kc) {
          if (kc < nkc) {
            cp_async_wait<kStages - 2>();
            __syncthreads();
            issue();
            if (active) {
              const char* bq = ring + (st % kStages) * sbytes + b_off;
#pragma unroll
              for (int k64 = 0; k64 < kRowBytes / 64; ++k64) {
                // Two k-steps (16 channels each in bf16, 8 in float32),
                // 16-byte chunk k64 * 4 + lane / 8 of the B rows, swizzled.
                const int cb = k64 * 4 + (lane >> 3);
                const char* bk = bq + ((((cb ^ lane) & 7) | (cb & ~7)) << 4);
                const int ks = kc * kKSPerKC + 2 * k64;
                if constexpr (!kF32) {
#pragma unroll
                  for (int n = 0; n < kNG; ++n) {
                    if (n < ntg) {
                      unsigned bm[4];
                      ldmatrix4(bm, bk + n * 8 * kRowBytes);
                      mma_bf16(acc[n], a[ks], bm[0], bm[1]);
                      mma_bf16(acc[n], a[ks + 1], bm[2], bm[3]);
                    }
                  }
                } else {
                  // 3xTF32: small*big + big*small + big*big.
                  unsigned ab[2][4], as[2][4];
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) split_tf32(a[ks + h][e], ab[h][e], as[h][e]);
                  }
#pragma unroll
                  for (int n = 0; n < kNG; ++n) {
                    if (n < ntg) {
                      unsigned bm[4], bb[4], bs[4];
                      ldmatrix4(bm, bk + n * 8 * kRowBytes);
#pragma unroll
                      for (int e = 0; e < 4; ++e) split_tf32(bm[e], bb[e], bs[e]);
#pragma unroll
                      for (int h = 0; h < 2; ++h) {
                        mma_tf32(acc[n], as[h], bb[2 * h], bb[2 * h + 1]);
                        mma_tf32(acc[n], ab[h], bs[2 * h], bs[2 * h + 1]);
                        mma_tf32(acc[n], ab[h], bb[2 * h], bb[2 * h + 1]);
                      }
                    }
                  }
                }
              }
            }
            ++st;
          }
        }
        // The band of this n-group into the output tile: the lane holds
        // P[t, u] at t = lane/4 (+8 for e >= 2), u = 8n + 2*(lane%4) (+1).
        if (active) {
#pragma unroll
          for (int n = 0; n < kNG; ++n) {
            if (n < ntg) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int j = g * kNG * 8 + n * 8 + tig * 2 + (e & 1) - (lane >> 2) - (e >> 1) * 8;
                if (j >= 0 && j < d) ob[j * kM + (e >> 1) * 8] = acc[n][e] * inv_c;
              }
            }
          }
        }
      }
      // The warp's row pairs with this f2 row at i = q - task_k.
      if (active) {
        __syncwarp();
        write_row(i, c0 > 0);
        __syncwarp();
      }
    }
    cp_async_wait<0>();
  }
}

template <typename In>
cudaError_t launch(Params p, int b, cudaStream_t stream) {
  // R output rows per block, one warp each; fewer rows while the tiles
  // overflow shared memory.
  p.rows = kWarps;
  auto smem = [&]() { return kStages * stage_bytes(p) + out_bytes(p); };
  while (p.rows > 1 && smem() > kSmemMax) --p.rows;
  if (smem() > kSmemMax) return cudaErrorInvalidValue;
  p.groups = ((p.h + p.s - 1) / p.s + p.rows - 1) / p.rows;
  p.tiles = (p.w + p.s * kM - 1) / (p.s * kM);
  if ((long long)p.tiles * p.s > 0x7fffffff || (long long)p.s * p.groups > 65535) {
    return cudaErrorInvalidValue;
  }
  const int bytes = smem();
  cudaError_t err = cudaFuncSetAttribute(
      corr_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  // All of the SM's unified memory as shared memory, so that two blocks
  // fit where their tiles allow it.
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(corr_kernel<In>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid(p.tiles * p.s, p.s * p.groups, b);
  corr_kernel<In><<<grid, 32 * p.rows, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int premvos_correlation(const void* f1, const void* f2, int is_bf16,
                                   int b, int h, int w, int c, int md,
                                   int stride, float* out,
                                   cudaStream_t stream) {
  if (b <= 0 || h <= 0 || w <= 0) return 0;
  if (c <= 0 || md < 0 || stride <= 0 || b > 65535) return (int)cudaErrorInvalidValue;
  Params p{};
  p.f1 = f1;
  p.f2 = f2;
  p.out = out;
  p.h = h;
  p.w = w;
  p.c = c;
  p.md = md;
  p.s = stride;
  p.d = 2 * (md / stride) + 1;
  p.nt = (p.d + kM - 1 + 7) / 8;
  p.ng = (p.nt + kNG - 1) / kNG;
  p.ngw = p.nt < kNG ? p.nt : kNG;
  p.async16 = c % (is_bf16 ? 8 : 4) == 0 &&
              (reinterpret_cast<uintptr_t>(f1) & 15) == 0 &&
              (reinterpret_cast<uintptr_t>(f2) & 15) == 0;
  const cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(p, b, stream)
                                  : launch<float>(p, b, stream);
  return (int)err;
}

// ---------------------------------------------------------------------------
// The cost volume's gradient (backward).
//
// Replaces the VJP of premvos_tpu/ops/correlation.py::correlation, the XLA
// scan premvos_tpu/ops/correlation.py::_correlation_grads (no Pallas
// kernel). Contract (ops/correlation.py::correlation_grads_reference), with
// g = dL/dout float32 [B, D*D, H, W] and (dy, dx) = (i*s - md, j*s - md):
//   df1[b, y, x, c] = (1/C) * sum_{i,j} g[b, iD+j, y, x] * f2[b, y+dy, x+dx, c]
//   df2[b, v, u, c] = (1/C) * sum_{i,j} g[b, iD+j, v-dy, u-dx] * f1[b, v-dy, u-dx, c]
// with f1, f2 float32 channels-last [B, H, W, C] and zero outside the
// image; df1 and df2 are float32 channels-last. df2 is written as a gather
// over its own pixels (terms whose source pixel is off the image are
// dropped), not as the reference's scatter: every output element is written
// once, with no atomics and a fixed order of summation, so two runs give the
// same bits.
//
// What bounds it on the H100: bytes. Only the (pixel, displacement) pairs
// whose displaced pixel lies on the image need work: 452 x 452 of 672 x 672
// per image at FlowNetC's training shape [8, 256, 32, 32], D = 21 (45 %).
// Each gradient is 2*B*pairs*C FLOP (0.84 G); as 3xTF32 on the tensor cores
// (three products each) both take 0.0101 ms at 495 TFLOP/s, against 40.1 MB
// of f1, f2, df1, df2 and the g entries at those pairs, 0.0120 ms at
// 3.35 TB/s. (As float32 FMAs, the first kernel's route, 0.025 ms.)
//
// Design: both gradients are banded matrix products. For an output row y, a
// row displacement i and 16 output columns x0 + s*q (q < 16) of one residue
// class mod s,
//   out[q, c] += sum_k W[q, k] * S[k, c],  k < K = D + 15,
// where S[k] is source column xs(k) = xbase + s*k of source row ys(i) (f2
// for df1, f1 for df2) and W holds g on the band u = k - q in [0, D): at
// j = u, g[iD + j, y, x0 + s*q] for df1; at j = D - 1 - u,
// g[iD + j, ys, xs(k)] for df2 (g read at the source pixel). Off the band,
// and where the source column is off the image, W is zero.
//   - One launch computes both: the grid's x holds (gradient, channel chunk,
//     column residue, column tile), so df1's and df2's blocks run together;
//     `needs` for one gradient launches only its half.
//   - A block takes 16 columns of one residue in R = 8 output rows y, y + s,
//     ... of one residue (a warp a row, two warpgroups of four rows) and one
//     chunk of 8 * NT channels (64, or 128 above C = 64). Output row t and
//     displacement row i read source row number t + i (df1) or
//     t + D - 1 - i (df2) from the block's first, so the block stages each
//     of its R + D - 1 source rows once, for every row it serves, in a
//     3-deep cp.async ring (16-byte pieces, zeros past C). Only the
//     on-image columns are staged, in k-steps of 8 from the first of them;
//     a stage holds at most the columns that the image or the band can
//     give (kg), in groups when D + 15 exceeds 64.
//   - Each warp stages its own band with 4-byte cp.async in the same ring
//     stage: g at the (u, q) whose source column is staged and on the
//     image, a half-warp a value of u, as [q][u] with a row stride of 8m + 5
//     floats, so that the A fragments (rows q, columns k, u = k - q) read it
//     without bank conflicts; the fragments mask what was not loaded.
//   - The product is wgmma m64n(8NT)k8 in 3xTF32: A = W of the warpgroup's
//     four rows (64 x 8, from registers), B = S (8 columns x 8NT channels)
//     from shared memory. x = big + small, big rounded to tf32 to nearest,
//     small truncated to tf32; small*big + big*small + big*big is within
//     about 2^-21 of each float32 product (plain TF32 keeps 2^-11). After a
//     stage lands, the block splits its source columns once into big and
//     small K-major tiles (two buffers), and each warpgroup keeps one batch
//     of products (two k-steps) in flight while the next stage is staged
//     and split. The sums stay in registers from the first stage to the
//     last, then go through shared memory so that each row of channels is
//     written with whole-line 16-byte stores.
// What holds it (PERF.md, section 6; scripts/corr_grad_breakdown.py):
// staging, not the tensor cores. The band of g is read from L2 once per
// channel chunk, 4 bytes a lane and half a sector at a time at stride 2;
// with the source rows, their split and the write-out, that takes about 37
// of the 49 us at the training shape, and the products add about 12.
// ---------------------------------------------------------------------------

namespace {

constexpr int kGQ = 16;      // output columns a warp (16 rows of the product)
constexpr int kGKGMax = 64;  // source columns a ring stage (a multiple of 8)
constexpr int kGRows = 8;    // output rows a block: two warpgroups of four warps
constexpr int kGStages = 3;  // depth of the ring
// The K-major B tiles of wgmma without swizzle: core matrices of 8 channels
// x 4 source columns (16 bytes a channel); kLBO bytes between the two core
// matrices of a k-step, kSBO bytes between groups of 8 channels.
constexpr int kLBO = 128;
constexpr int kSBO = 256;

struct GradParams {
  const float* f1;
  const float* f2;
  const float* g;  // [B, D*D, H, W]
  float* df1;
  float* df2;
  int h, w, c, md, s, d;
  int groups;   // row groups per residue: ceil(ceil(H / s) / kGRows)
  int tiles;    // column tiles of 16 * s columns: ceil(W / (16 * s))
  int chunks;   // channel chunks of 8 * NT
  int kg;       // source columns a stage, a multiple of 8 (launch_grad)
  int ldj;      // the band's row stride: 8m + 5 >= min(D, kg + 15)
  int first;    // the gradient of the grid's first half: 0 (df1) or 1 (df2)
  int vec16;    // C % 4 == 0 and every pointer 16-byte aligned: cp.async, float4
  float inv_c;
};

// Floats of a ring stage (the staged source columns, then each warp's band)
// and of all shared memory (the ring, then the split source columns; at the
// end it holds the warps' output tiles, rows of 8 * NT + 8 floats).
template <int NT>
__host__ __device__ inline int grad_stage_floats(const GradParams& p) {
  return p.kg * 8 * NT + kGRows * kGQ * p.ldj;
}
template <int NT>
__host__ __device__ inline int grad_smem_floats(const GradParams& p) {
  const int all = kGStages * grad_stage_floats<NT>(p) + 4 * p.kg * 8 * NT;
  const int tiles = kGRows * kGQ * (8 * NT + 8);
  return all > tiles ? all : tiles;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a), "l"(src),
               "r"(valid ? 4 : 0));
}

// x = big + small: big rounded to tf32 to nearest (ties away), small the
// rest truncated to tf32.
__device__ __forceinline__ void split3(float x, unsigned& big, unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Generic-proxy writes to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ unsigned long long kmajor_desc(const float* tile) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(tile));
  return (unsigned long long)((a & 0x3FFFF) >> 4) |
         ((unsigned long long)(kLBO >> 4) << 16) | ((unsigned long long)(kSBO >> 4) << 32);
}

// d (64 x 8NT, float32) += a (64 x 8, tf32, registers) . b (8 x 8NT, tf32,
// shared memory): one warpgroup; each warp holds 16 rows of a and d in the
// layout of mma.sync's m16n8k8 fragments.
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4], const unsigned (&a)[4],
                                           unsigned long long desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[16][4], const unsigned (&a)[4],
                                           unsigned long long desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int NT>
__global__ void __launch_bounds__(32 * kGRows, 2)
corr_grad_kernel(const GradParams p) {
  extern __shared__ __align__(128) float gsm[];
  constexpr int kCC = 8 * NT;      // channels a block
  constexpr int kPieces = 2 * NT;  // 16-byte pieces of a staged column
  const int s = p.s, d = p.d;
  // Block (gradient, channel chunk, column residue r, column tile): output
  // columns x0 + s*q (q < 16, x0 = 16*s*tile + r), channels c0..c0+kCC-1,
  // of rows y_start + s*t (t < 8).
  int bx = blockIdx.x;
  const int tile = bx % p.tiles;
  bx /= p.tiles;
  const int r = bx % s;
  bx /= s;
  const int chunk = bx % p.chunks;
  const bool df2 = p.first + bx / p.chunks == 1;
  const int x0 = tile * s * kGQ + r, c0 = chunk * kCC;
  const int residue = blockIdx.y / p.groups;
  const int y_start = residue + s * kGRows * (blockIdx.y - residue * p.groups);
  const int b = blockIdx.z;
  if (y_start >= p.h) return;  // uniform: this group has no rows

  // The warp index from lane 0, so that the compiler sees every branch on
  // it as uniform across the warp: wgmma needs its warpgroup converged.
  const int tid = threadIdx.x, lane = tid & 31, warp = __shfl_sync(0xffffffff, tid >> 5, 0);
  const int gq = lane >> 2, tig = lane & 3;
  const int y = y_start + s * warp;  // this warp's output row
  const bool row_on = y < p.h;
  const size_t plane = (size_t)p.h * p.w;
  const float* src = (df2 ? p.f1 : p.f2) + (size_t)b * plane * p.c;
  const float* gb = p.g + (size_t)b * d * d * plane;

  // Source columns xs(k) = xbase + s*k; those on the image are k_lo..k_hi.
  const int xbase = df2 ? x0 + p.md - s * (d - 1) : x0 - p.md;
  const int k_lo = xbase >= 0 ? 0 : (-xbase + s - 1) / s;
  const int k_hi = xbase > p.w - 1 ? -1 : min(d + kGQ - 2, (p.w - 1 - xbase) / s);
  // Source rows ys = ybase + s*qr; row t pairs with qr when u_i = qr - t is
  // in [0, D) (i = u_i for df1, D - 1 - u_i for df2). The staged rows are
  // those on the image that some row of the block pairs with.
  const int ybase = df2 ? y_start + p.md - s * (d - 1) : y_start - p.md;
  const int live = min(kGRows, (p.h - 1 - y_start) / s + 1);  // rows on the image
  const int q_lo = ybase >= 0 ? 0 : (-ybase + s - 1) / s;
  const int q_hi = ybase > p.h - 1 ? -1 : min(live + d - 2, (p.h - 1 - ybase) / s);
  // Stages: (staged row, column group), the groups of kg columns from k_lo.
  const int ksteps = k_hi >= k_lo ? (k_hi - k_lo + 8) / 8 : 0;
  const int ngk = (8 * ksteps + p.kg - 1) / p.kg;
  const int n_stages = q_hi >= q_lo ? (q_hi - q_lo + 1) * ngk : 0;
  const bool vec = p.vec16 != 0;
  const int stage_f = grad_stage_floats<NT>(p);
  float* split = gsm + kGStages * stage_f;  // two stages' source columns, split

  // Stage st into ring slot st % kGStages: the block's source columns, and
  // this warp's band when its row pairs with the staged row.
  auto issue = [&](int st) {
    if (st < n_stages) {
      const int qr = q_lo + st / ngk, gk = st - (st / ngk) * ngk;
      const int ka = k_lo + gk * p.kg, kn = min(p.kg, 8 * ksteps - gk * p.kg);
      float* stage = gsm + (st % kGStages) * stage_f;
      const int ys = ybase + s * qr;
      const float* srow = src + (size_t)ys * p.w * p.c;
      const int piece = tid % kPieces;
      for (int kl = tid / kPieces; kl < kn; kl += blockDim.x / kPieces) {
        const int k = ka + kl;
        const float* px = k <= k_hi ? srow + (size_t)(xbase + s * k) * p.c : nullptr;
        load_piece<float>(reinterpret_cast<char*>(stage + kl * kCC + 4 * piece), px,
                          c0 + 4 * piece, p.c, vec, src);
      }
      const int u_i = qr - warp, q = lane & (kGQ - 1);
      if (row_on && u_i >= 0 && u_i < d) {
        // The band, half a warp a value of u (16 columns q, each row's
        // loads together): g at the u in [0, D) whose source column
        // k = u + q is staged and on the image, at band[q][u - uw],
        // uw = max(0, ka - 15). Nothing else is loaded: the A fragments
        // read only these (for df1, rows q whose output column lies off the
        // image feed only outputs that are not written).
        const int i = df2 ? d - 1 - u_i : u_i;
        const int uw = max(0, ka - (kGQ - 1));
        const int u_lo = max(0, ka - q);
        const int u_hi = (df2 || x0 + s * q < p.w) ? min(d, min(ka + kn - 1, k_hi) + 1 - q) : 0;
        const int u_end = min(d, min(ka + kn - 1, k_hi) + 1);  // row 0's end, the last
        int u = uw + (lane >> 4);
        const float* gi = gb + (size_t)i * d * plane + (size_t)(df2 ? ys : y) * p.w;
        // g[iD + u, y, x0 + s*q] for df1, g[iD + D - 1 - u, ys, xs(u + q)] for df2.
        const float* at = df2 ? gi + (ptrdiff_t)(d - 1 - u) * (ptrdiff_t)plane + xbase + s * (u + q)
                              : gi + (size_t)u * plane + x0 + s * q;
        const ptrdiff_t step = 2 * (df2 ? (ptrdiff_t)s - (ptrdiff_t)plane : (ptrdiff_t)plane);
        float* band = stage + p.kg * kCC + warp * kGQ * p.ldj + q * p.ldj - uw;
        for (; u < u_end; u += 2, at += step) {
          if (u >= u_lo && u < u_hi) cp_async4(band + u, at, true);
        }
      }
    }
    cp_async_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // The warpgroup keeps one batch of products (a pair of k-steps) in
  // flight, and the split source columns alternate between two buffers,
  // so a batch runs on while the next stage is staged and split.
  int last_stage = -2;
  for (int k = 0; k < kGStages - 1; ++k) issue(k);
  for (int st = 0; st < n_stages; ++st) {
    // Stage st - 2's batches read the split buffer that this stage fills.
    if (last_stage == st - 1) {
      wg_wait<1>();
    } else {
      wg_wait<0>();
    }
    cp_async_wait<kGStages - 2>();
    __syncthreads();  // stage st has landed; every warp is done with stage st - 1's slot
    issue(st + kGStages - 1);
    const int qr = q_lo + st / ngk, gk = st - (st / ngk) * ngk;
    const int ka = k_lo + gk * p.kg, kn = min(p.kg, 8 * ksteps - gk * p.kg);
    const float* stage = gsm + (st % kGStages) * stage_f;
    float* big = split + (st & 1) * 2 * p.kg * kCC;
    float* small = big + p.kg * kCC;
    // The source columns into big and small tf32 pieces, as K-major tiles
    // [k / 8][c / 8][(k % 8) / 4][c % 8][k % 4]: a thread takes 4 source
    // columns of one channel (16 bytes of a tile).
    for (int qi = tid; qi < kn / 4 * kCC; qi += blockDim.x) {
      const int n = qi % kCC, kq = qi / kCC;
      unsigned hb[4], hs[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) split3(stage[(4 * kq + j) * kCC + n], hb[j], hs[j]);
      const int off = (kq >> 1) * 8 * kCC + (n >> 3) * 64 + (kq & 1) * 32 + (n & 7) * 4;
      *reinterpret_cast<uint4*>(big + off) = make_uint4(hb[0], hb[1], hb[2], hb[3]);
      *reinterpret_cast<uint4*>(small + off) = make_uint4(hs[0], hs[1], hs[2], hs[3]);
    }
    fence_async_shared();
    __syncthreads();  // the split tiles are complete
    // This warpgroup's rows t0..t0+3: their products with the staged row,
    // when one of them (on the image) pairs with it.
    const int t0 = 4 * (warp >> 2);
    if (max(t0, qr - d + 1) > min(min(t0 + 3, live - 1), qr)) continue;
    const int u_i = qr - warp;
    const bool mine = row_on && u_i >= 0 && u_i < d;
    const int uw = max(0, ka - (kGQ - 1));
    const float* band = stage + p.kg * kCC + warp * kGQ * p.ldj;
    for (int kk = 0; kk < kn / 8; kk += 2) {
      // A = W for k-steps kk and kk + 1: rows q = gq (+8), columns
      // k = ka + 8kk + tig (+4), read at band[q][u - uw] where u = k - q
      // lies on the band and k on the image; zeros elsewhere and for a row
      // that does not pair. At most one batch stays in flight: the
      // registers it reads are not reused before it ends.
      wg_wait<1>();
      unsigned ab[2][4], as[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = gq + 8 * (e & 1), k = ka + 8 * (kk + h) + tig + 4 * (e >> 1);
          const int u = k - q;
          const bool on = mine && (unsigned)u < (unsigned)d && k <= k_hi;
          split3(on ? band[q * p.ldj + u - uw] : 0.f, ab[h][e], as[h][e]);
        }
      }
      wg_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (kk + h < kn / 8) {
          const int t_off = (kk + h) * 8 * kCC;
          const unsigned long long db = kmajor_desc(big + t_off), ds = kmajor_desc(small + t_off);
          // 3xTF32: small*big + big*small + big*big.
          wgmma_tf32(acc, as[h], db);
          wgmma_tf32(acc, ab[h], ds);
          wgmma_tf32(acc, ab[h], db);
        }
      }
      wg_commit();
      last_stage = st;
    }
  }
  wg_wait<0>();
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it holds the output tiles now

  // The lane holds rows q = gq and gq + 8 (e >> 1), columns 2tig (+1) of
  // each n-tile n (e & 1): channels n * 8 + 2tig (+1). They go through the
  // warp's tile [16][8 * NT + 8] in shared memory (the 8 floats of padding
  // keep its 8-byte stores free of bank conflicts) and out as whole rows of
  // channels, 16 bytes a lane.
  constexpr int kLdo = kCC + 8;
  float* otile = gsm + warp * kGQ * kLdo;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int q = gq + 8 * hr;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<float2*>(otile + q * kLdo + 8 * n + 2 * tig) =
          make_float2(acc[n][2 * hr] * p.inv_c, acc[n][2 * hr + 1] * p.inv_c);
    }
  }
  __syncwarp();
  if (!row_on) return;
  float* out = (df2 ? p.df2 : p.df1) + ((size_t)b * plane + (size_t)y * p.w) * p.c;
#pragma unroll
  for (int it = 0; it < NT; ++it) {
    const int f = it * 32 + lane, q = f / (2 * NT), lc = f % (2 * NT);
    const int x = x0 + s * q, ch = c0 + 4 * lc;
    if (x >= p.w || ch >= p.c) continue;
    const float4 v = *reinterpret_cast<const float4*>(otile + q * kLdo + 4 * lc);
    float* o = out + (size_t)x * p.c + ch;
    if (vec && ch + 3 < p.c) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      o[0] = v.x;
      if (ch + 1 < p.c) o[1] = v.y;
      if (ch + 2 < p.c) o[2] = v.z;
      if (ch + 3 < p.c) o[3] = v.w;
    }
  }
}

// NT n-tiles of 8 channels a block: wgmma's N = 8 * NT.
// A stage holds up to kg source columns: the most that a block's k-steps
// can span (D + 15 columns, or the image's columns of one residue class),
// at most kGKGMax, halved while the shared memory overflows.
template <int NT>
cudaError_t launch_grad(GradParams p, int b, int ngrad, cudaStream_t stream) {
  const int k8 = (p.d + kGQ - 1 + 7) / 8 * 8, w8 = ((p.w + p.s - 1) / p.s + 7) / 8 * 8;
  p.kg = k8 < w8 ? k8 : w8;
  p.kg = p.kg < kGKGMax ? p.kg : kGKGMax;
  int bytes = 0;
  for (;;) {
    const int window = p.d < p.kg + kGQ - 1 ? p.d : p.kg + kGQ - 1;
    p.ldj = window <= 5 ? 5 : (window - 5 + 7) / 8 * 8 + 5;
    bytes = grad_smem_floats<NT>(p) * (int)sizeof(float);
    if (bytes <= kSmemMax) break;
    if (p.kg == 8) return cudaErrorInvalidValue;
    p.kg = (p.kg / 2 + 7) / 8 * 8;
  }
  p.groups = ((p.h + p.s - 1) / p.s + kGRows - 1) / kGRows;
  p.tiles = (p.w + p.s * kGQ - 1) / (p.s * kGQ);
  p.chunks = (p.c + 8 * NT - 1) / (8 * NT);
  const long long gx = (long long)p.tiles * p.s * p.chunks * ngrad;
  if (gx > 0x7fffffff || (long long)p.s * p.groups > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      corr_grad_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(corr_grad_kernel<NT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)gx, p.s * p.groups, b);
  corr_grad_kernel<NT><<<grid, 32 * kGRows, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int premvos_correlation_backward(const float* f1, const float* f2,
                                            const float* grad, int b, int h,
                                            int w, int c, int md, int stride,
                                            float* df1, float* df2,
                                            cudaStream_t stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || (df1 == nullptr && df2 == nullptr)) return 0;
  if (md < 0 || stride <= 0 || b > 65535) return (int)cudaErrorInvalidValue;
  GradParams p{};
  p.f1 = f1;
  p.f2 = f2;
  p.g = grad;
  p.df1 = df1;
  p.df2 = df2;
  p.h = h;
  p.w = w;
  p.c = c;
  p.md = md;
  p.s = stride;
  p.d = 2 * (md / stride) + 1;
  p.first = df1 != nullptr ? 0 : 1;
  const int ngrad = (df1 != nullptr) + (df2 != nullptr);
  auto aligned = [](const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; };
  p.vec16 = c % 4 == 0 && aligned(f1) && aligned(f2) && aligned(df1) && aligned(df2);
  p.inv_c = 1.f / (float)c;
  // 128 channels a block above 64 channels (half as many blocks read g),
  // else 64.
  const cudaError_t err = c > 64 ? launch_grad<16>(p, b, ngrad, stream)
                                 : launch_grad<8>(p, b, ngrad, stream);
  return (int)err;
}
