// Greedy NMS over score-sorted boxes, batched over images, with the
// compaction of the kept indices.
//
// Replaces premvos_tpu/ops/pallas/nms_pallas.py::nms_pallas (_nms_kernel
// and the compaction after it). Contract (ops/nms.py::nms_cuda): boxes
// [B, N, 4] xyxy float32 in their original order; `order` [B, N] int64, the
// stable ascending sort of -score (so descending score, NaN last, ties to
// the lower index) and `neg_sorted` [B, N] float32, the sorted -score
// itself, invalid rows already scored NEG_INF by the wrapper. A box is
// alive when its score is above score_threshold; box j is suppressed by an
// earlier kept box i when IoU(i, j) > iou_threshold.
// Outputs `indices` [B, max_outputs] int32, the original indices of the
// first max_outputs kept boxes in score order, -1 past the last, and
// `valid` [B, max_outputs] (uint8, 1 where an index was written). The sort
// stays in PyTorch.
//
// What bounds it on the H100: not bytes (at the RPN's 8 x 2384 boxes the
// inputs and outputs are 0.4 MB, 0.1 us at 3.35 TB/s) nor operations (the
// IoUs greedy NMS needs take about a microsecond at 67 TFLOP/s), but the
// greedy sweep's chain of dependent decisions, the latency of each tile's
// copy and barrier, and each launch's fixed cost.
//
// Two kernels:
//   1. nms_mask_kernel: one 64-thread block per (row block, column block,
//      image) on or above the diagonal (the sweep never reads a word left of
//      its row's block); the grid folds row block r with row block
//      words-1-r, so every launched block has work. Thread r sets bit c of a
//      64-bit word when box c (later in score order) overlaps box r above
//      the threshold; on the diagonal it also sets, in an extra word, the
//      earlier boxes of its tile that overlap it. Boxes are read through
//      `order`; rows of dead boxes are skipped (never read).
//   2. nms_sweep_kernel: one 256-thread block per image walks the sorted
//      boxes in tiles of 64:
//        - the alive and removed flags are 64-bit words in shared memory
//          (alive from __ballot_sync);
//        - each tile's mask rows (words t..words and the extra word; rows
//          padded to an even word count so that they go in 16-byte pieces)
//          and its boxes' original indices are copied into shared memory
//          with cp.async one tile ahead (double-buffered), skipping the
//          rows of boxes that are dead or already removed;
//        - a warp resolves the tile's 64 decisions in ballot rounds, lane l
//          holding boxes l and l+32 with their earlier in-tile neighbours:
//          a box is removed once an earlier kept box overlaps it and kept
//          once every earlier candidate that overlaps it is removed. A
//          round decides at least the lowest undecided box, and a tile
//          takes a few, where walking the kept boxes one by one took one
//          dependent shared-memory step each;
//        - the block ORs the kept rows into the removed words of the later
//          tiles (a thread per later word and quarter of the tile, 16
//          predicated loads, shared atomicOr);
//        - the kept boxes write their original index at their rank, so no
//          compaction pass follows; the sweep stops once max_outputs boxes
//          are kept and fills the slots past the last kept box with -1.
// What holds it (PERF.md, section 6): the wrapper's host path, most of it
// PyTorch's sort; on the card, the mask pass's instructions per box pair
// (22.7 M pairs at the RPN's shape) and the sweep's fixed cost per tile
// (barrier, staging, resolution), paid even where no box of the tile
// survives, so a sweep through all 38 tiles of 2384 boxes takes about
// twice one that stops after 5.
//
// Exactness: IoU is computed in the same operation order as
// ops/boxes.py::box_iou with IEEE-rounded intrinsics (never contracted into
// FMAs) and IEEE division, and max/min propagate NaN as torch.maximum does
// (max.NaN / min.NaN), so every comparison equals the plain PyTorch
// version's; for thresholds in [0, FLT_MAX) the rounded quotient's
// comparison is decided exactly without dividing (IouThreshold). Do not
// build with --use_fast_math.

#include <cfloat>
#include <cmath>
#include <cstring>

#include "premvos_kernels.h"

namespace {

using u64 = unsigned long long;

constexpr int kBits = 64;            // boxes per tile and per mask word
constexpr int kSweepThreads = 256;   // 8 warps; 4 threads per later word
constexpr int kStages = 2;           // the sweep's ring: tile t + 1 lands while t is resolved
constexpr int kMaxSweepSmem = 232448;  // bytes of shared memory a block can use

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float area(const float4& b) {
  return __fmul_rn(nan_max(__fsub_rn(b.z, b.x), 0.f),
                   nan_max(__fsub_rn(b.w, b.y), 0.f));
}

// The IoU threshold t. For 0 <= t < FLT_MAX the test RN(inter / u) > t is
// made without the division: rounding is monotonic, so it holds exactly
// when inter / u lies above mid = (t + next float above t) / 2, or on it
// when the tie rounds up (t's last significand bit is 1). inter > mid * u
// is exact in double (mid has 25 significant bits and u 24, so the product
// fits 53). Other thresholds divide, as the plain version does.
struct IouThreshold {
  float t;
  double mid;
  int mode;  // 0: divide; 1: inter > mid * u; 2: inter >= mid * u
};

IouThreshold make_threshold(float t) {
  IouThreshold th = {t, 0.0, 0};
  if (t >= 0.f && t < FLT_MAX) {
    th.mid = ((double)t + (double)nextafterf(t, INFINITY)) / 2.0;
    unsigned bits;
    memcpy(&bits, &t, sizeof(bits));
    th.mode = (bits & 1u) ? 2 : 1;
  }
  return th;
}

// IoU(a, b) > threshold, with the boxes' areas given: ops/boxes.py::box_iou's
// IoU is inter / max(union, 1e-12) where union > 0, else 0.
__device__ __forceinline__ bool overlaps(const float4& a, float area_a,
                                         const float4& b, float area_b,
                                         const IouThreshold& th) {
  const float ww = nan_max(__fsub_rn(nan_min(a.z, b.z), nan_max(a.x, b.x)), 0.f);
  const float hh = nan_max(__fsub_rn(nan_min(a.w, b.w), nan_max(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(ww, hh);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  if (!(uni > 0.f)) return 0.f > th.t;
  const float u = nan_max(uni, 1e-12f);
  if (th.mode == 0) return __fdiv_rn(inter, u) > th.t;
  const double p = __dmul_rn(th.mid, (double)u);
  return th.mode == 1 ? (double)inter > p : (double)inter >= p;
}

__device__ __forceinline__ float4 load_box(const float* boxes, long long i) {
  const float* p = boxes + i * 4;
  return make_float4(p[0], p[1], p[2], p[3]);
}

// Whether sorted box i is alive: scored above the threshold.
__device__ __forceinline__ bool is_alive(const float* ns, int i, float score_thr) {
  return -ns[i] > score_thr;
}

// Mask row layout: row i of image b is mask[(b * n + i) * stride + ...],
// stride = row_stride(words), even so that rows are 16-byte aligned; word w
// (w >= i / 64) holds bit j for box 64w + j > i overlapping box i, and word
// `words` holds the earlier boxes of i's own tile that overlap it (bit j
// for box 64 * (i / 64) + j < i), which the sweep resolves a tile from.
__host__ __device__ __forceinline__ int row_stride(int words) { return 2 * (words / 2 + 1); }

__global__ void __launch_bounds__(kBits)
nms_mask_kernel(const float* __restrict__ boxes, const long long* __restrict__ order,
                const float* __restrict__ neg_sorted, int n, int words,
                IouThreshold iou_thr, float score_thr,
                u64* __restrict__ mask) {
  // Block (j, r) is block j of the folded row pair (r, words-1-r): the first
  // words-r blocks are row block r's, the rest row block words-1-r's.
  const int r = blockIdx.y;
  int row_blk = r, col_blk = r + blockIdx.x;
  if ((int)blockIdx.x >= words - r) {
    row_blk = words - 1 - r;
    if (row_blk == r) return;  // the middle row block of an odd count
    col_blk = row_blk + (blockIdx.x - (words - r));
  }
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int i = row_blk * kBits + tid;
  const int col_n = min(n - col_blk * kBits, kBits);
  const float* bb = boxes + (size_t)b * n * 4;
  const long long* ord = order + (size_t)b * n;

  // The column box and this thread's row box, their loads issued together.
  __shared__ float4 cols[kBits];
  __shared__ float col_area[kBits];
  __shared__ u64 diag[kBits];
  const bool has_row = i < n && is_alive(neg_sorted + (size_t)b * n, i, score_thr);
  const float4 a = has_row ? load_box(bb, ord[i]) : make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < col_n) {
    const float4 c = load_box(bb, ord[col_blk * kBits + tid]);
    cols[tid] = c;
    col_area[tid] = area(c);
  }
  __syncthreads();
  const float area_a = area(a);
  u64 bits = 0ULL;
  if (has_row) {
    for (int j = col_blk == row_blk ? tid + 1 : 0; j < col_n; ++j) {
      if (overlaps(a, area_a, cols[j], col_area[j], iou_thr)) bits |= 1ULL << j;
    }
  }
  u64* row = mask + ((size_t)b * n + i) * row_stride(words);
  if (col_blk == row_blk) {
    // The tile's earlier boxes overlapping box i: bit i of their words
    // (IoU is symmetric), read back through shared memory.
    diag[tid] = bits;
    __syncthreads();
    u64 earlier = 0ULL;
    for (int j = 0; j < tid; ++j) earlier |= ((diag[j] >> tid) & 1ULL) << j;
    if (has_row) row[words] = earlier;
  }
  if (has_row) row[col_blk] = bits;
}

__device__ __forceinline__ void cp_async8(u64* dst, const u64* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(u64* dst, const u64* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy tile t's mask rows `rows` (a bit per row of the tile), words t..words
// (from the even word at or below t), into `dst` ([64][stride]) in 16-byte
// pieces, one warp per row, and the rows' original indices into dst_ord[64]
// (warp 0; 8-byte pieces, as an image's order need not be 16-byte aligned).
__device__ __forceinline__ void stage_tile(u64* dst, long long* dst_ord, const u64* m,
                                           const long long* ord, u64 rows, int t,
                                           int n, int words) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = row_stride(words);
  for (int row = warp; row < kBits; row += kSweepThreads / 32) {
    if (!((rows >> row) & 1ULL)) continue;
    const u64* src = m + (size_t)(t * kBits + row) * stride;
    for (int w = (t & ~1) + 2 * lane; w < stride; w += 64)
      cp_async16(dst + row * stride + w, src + w);
  }
  if (warp == 0) {
    for (int row = lane; row < kBits; row += 32) {
      if (t * kBits + row < n)
        cp_async8(reinterpret_cast<u64*>(dst_ord + row),
                  reinterpret_cast<const u64*>(ord + t * kBits + row));
    }
  }
}

// The greedy decisions of one tile: `cand` (alive, not removed by an earlier
// tile) and, for lane l, the earlier-in-tile neighbours of boxes l and
// l + 32 (their mask word `words`). Box i is removed once an earlier kept
// box overlaps it and kept once every earlier candidate overlapping it is
// removed; each ballot round decides at least the lowest undecided box, and
// a tile usually takes a few rounds. The same in every lane.
__device__ __forceinline__ u64 resolve_tile(u64 cand, const u64* rows, int stride,
                                            int words) {
  const int lane = threadIdx.x & 31;
  const bool c_lo = (cand >> lane) & 1ULL, c_hi = (cand >> (lane + 32)) & 1ULL;
  const u64 s_lo = c_lo ? rows[lane * stride + words] & cand : 0ULL;
  const u64 s_hi = c_hi ? rows[(lane + 32) * stride + words] & cand : 0ULL;
  u64 kept = 0ULL, und = cand;
  while (und != 0ULL) {
    const bool u_lo = (und >> lane) & 1ULL, u_hi = (und >> (lane + 32)) & 1ULL;
    const bool r_lo = u_lo && (s_lo & kept) != 0ULL;
    const bool r_hi = u_hi && (s_hi & kept) != 0ULL;
    const bool k_lo = u_lo && !r_lo && (s_lo & und) == 0ULL;
    const bool k_hi = u_hi && !r_hi && (s_hi & und) == 0ULL;
    const u64 nk = (u64)__ballot_sync(0xffffffffu, k_lo) |
                   ((u64)__ballot_sync(0xffffffffu, k_hi) << 32);
    const u64 nr = (u64)__ballot_sync(0xffffffffu, r_lo) |
                   ((u64)__ballot_sync(0xffffffffu, r_hi) << 32);
    kept |= nk;
    und &= ~(nk | nr);
  }
  return kept;
}

__global__ void __launch_bounds__(kSweepThreads)
nms_sweep_kernel(const u64* __restrict__ mask, const long long* __restrict__ order,
                 const float* __restrict__ neg_sorted, int n, int words,
                 float score_thr, int max_outputs,
                 int* __restrict__ indices, uint8_t* __restrict__ valid) {
  extern __shared__ u64 smem[];
  u64* removed = smem;               // [words]
  u64* alive = removed + words;      // [words]
  long long* stage_ord = reinterpret_cast<long long*>(alive + words);  // [kStages][64]
  u64* stage = alive + words + kStages * kBits;  // [kStages][64][stride], 16-byte aligned
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int stride = row_stride(words);
  const u64* m = mask + (size_t)b * n * stride;
  const float* ns = neg_sorted + (size_t)b * n;
  const long long* ord = order + (size_t)b * n;
  int* idx_out = indices + (size_t)b * max_outputs;
  uint8_t* val_out = valid + (size_t)b * max_outputs;

#pragma unroll 2
  for (int w = tid >> 5; w < words; w += kSweepThreads / 32) {
    const int i = w * kBits + lane;
    const bool a_lo = i < n && is_alive(ns, i, score_thr);
    const bool a_hi = i + 32 < n && is_alive(ns, i + 32, score_thr);
    const unsigned lo = __ballot_sync(0xffffffffu, a_lo);
    const unsigned hi = __ballot_sync(0xffffffffu, a_hi);
    if (lane == 0) {
      alive[w] = (u64)lo | ((u64)hi << 32);
      removed[w] = 0ULL;
    }
  }
  __syncthreads();
  stage_tile(stage, stage_ord, m, ord, alive[0], 0, n, words);
  cp_async_commit();

  int kept_total = 0;
  for (int t = 0; t < words && kept_total < max_outputs; ++t) {
    // Tile t's rows have landed and the earlier tiles' removed words are
    // written; tile t-1's buffer is free for tile t + 1, whose rows already
    // removed need no copy (a removed box is never kept).
    cp_async_wait<0>();
    __syncthreads();
    const int next = t + 1;
    if (next < words) {
      const u64 gone = *reinterpret_cast<volatile u64*>(&removed[next]);
      stage_tile(stage + (next % kStages) * kBits * stride, stage_ord + (next % kStages) * kBits,
                 m, ord, alive[next] & ~gone, next, n, words);
    }
    cp_async_commit();
    const u64* rows = stage + (t % kStages) * kBits * stride;

    const u64 cand = alive[t] & ~removed[t];
    u64 kept = cand == 0ULL ? 0ULL : resolve_tile(cand, rows, stride, words);
    while (__popcll(kept) > max_outputs - kept_total)
      kept &= ~(1ULL << (63 - __clzll((long long)kept)));

    // The kept rows' bits into the later tiles' removed words: thread
    // (quarter q, word) ORs the kept rows among rows 16q..16q+15.
    const int q = tid >> 6;
    const unsigned mine = (unsigned)(kept >> (16 * q)) & 0xFFFFu;
    if (mine != 0u) {
      for (int w = t + 1 + (tid & 63); w < words; w += 64) {
        u64 acc = 0ULL;
#pragma unroll
        for (int r = 0; r < 16; ++r)
          if ((mine >> r) & 1u) acc |= rows[(16 * q + r) * stride + w];
        if (acc != 0ULL) atomicOr(&removed[w], acc);
      }
    }
    if (tid < kBits && ((kept >> tid) & 1ULL)) {
      const int rank = kept_total + __popcll(kept & ((1ULL << tid) - 1ULL));
      idx_out[rank] = (int)stage_ord[(t % kStages) * kBits + tid];
      val_out[rank] = 1;
    }
    kept_total += __popcll(kept);
  }
  cp_async_wait<0>();
  for (int r = kept_total + tid; r < max_outputs; r += kSweepThreads) {
    idx_out[r] = -1;
    val_out[r] = 0;
  }
}

size_t sweep_smem(int words) {
  return (size_t)(2 * words + kStages * kBits * (row_stride(words) + 1)) * sizeof(u64);
}

}  // namespace

extern "C" int premvos_nms(const float* boxes, const int64_t* order,
                           const float* neg_sorted, int batch, int n,
                           float iou_threshold, float score_threshold,
                           int max_outputs, unsigned long long* mask_scratch,
                           int* indices, uint8_t* valid, cudaStream_t stream) {
  if (batch <= 0 || n <= 0 || max_outputs <= 0) return 0;
  const int words = (n + kBits - 1) / kBits;
  const size_t smem = sweep_smem(words);
  if (smem > (size_t)kMaxSweepSmem) return (int)cudaErrorInvalidValue;  // n above ~14,000
  const long long* ord = reinterpret_cast<const long long*>(order);
  nms_mask_kernel<<<dim3(words + 1, (words + 1) / 2, batch), kBits, 0, stream>>>(
      boxes, ord, neg_sorted, n, words, make_threshold(iou_threshold), score_threshold,
      mask_scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_sweep_kernel<<<batch, kSweepThreads, smem, stream>>>(
      mask_scratch, ord, neg_sorted, n, words, score_threshold, max_outputs, indices, valid);
  return (int)cudaGetLastError();
}
