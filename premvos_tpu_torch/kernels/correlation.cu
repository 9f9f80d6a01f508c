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
