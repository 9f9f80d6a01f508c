// The C interface of the port's CUDA kernels: pointers to device memory,
// sizes, and PyTorch's current CUDA stream last. Each function returns the
// cudaError_t of its launches (0 when every launch was accepted).
//
// Every source includes this header, so a definition that drifts from its
// declaration here does not compile. kernels/__init__.py reads the ctypes
// argument types from these declarations, so the Python side cannot drift
// either. Keep to one declaration per function, each parameter a pointer,
// `int`, `float` or `cudaStream_t`.
//
// The first section declares the host library zstd_decode.cc (no CUDA,
// built with g++ by kernels.build_host, which defines PREMVOS_HOST_ONLY
// there and bound in io_compat/zstd.py). Its functions return int64_t or
// uint32_t, so load() and signatures(), which take the `int premvos_*`
// declarations, never see them.
#pragma once

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// The sum of the content sizes that the zstd frames in src[0, n) state
// (skippable frames count 0); -2 if a frame states none; -1 on an error,
// with *kind (1 corrupt, 2 truncated, 3 dictionary) and a message in err.
int64_t premvos_zstd_content_size(const uint8_t* src, int64_t n, int* kind,
                                  char* err, int errlen);

// Decodes every frame of src[0, n) into dst, at most cap bytes; returns the
// bytes written, or -1 on an error (*kind as above, 4 for output past cap,
// 5 for a content checksum mismatch), and then dst holds nothing usable.
int64_t premvos_zstd_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                            int64_t cap, int* kind, char* err, int errlen);

// CRC-32C (Castagnoli) of src[0, n), as OCDBT's manifest and node footers.
uint32_t premvos_crc32c(const uint8_t* src, int64_t n);

#ifdef __cplusplus
}
#endif

#ifndef PREMVOS_HOST_ONLY

#include <cuda_runtime.h>

#ifdef __cplusplus
extern "C" {
#endif

// boxes [batch, n, 4] in their original order; order [batch, n] and
// neg_sorted [batch, n]: torch.sort(-scores, stable=True), invalid rows
// scored NEG_INF. Writes indices [batch, max_outputs] (-1 past the last
// kept box) and valid (uint8). With words = ceil(n / 64), mask_scratch
// holds batch * n * 2 * (words / 2 + 1) 64-bit words, 16-byte aligned.
int premvos_nms(const float* boxes, const int64_t* order,
                const float* neg_sorted, int batch, int n,
                float iou_threshold, float score_threshold, int max_outputs,
                unsigned long long* mask_scratch, int* indices,
                uint8_t* valid, cudaStream_t stream);

int premvos_multilevel_roi_align(const void* p2, const void* p3,
                                 const void* p4, const void* p5, int h2,
                                 int w2, int h3, int w3, int h4, int w4,
                                 int h5, int w5, int c, int is_bf16,
                                 const float* boxes, const int* levels,
                                 int batch, int n, int p, int s, void* out,
                                 cudaStream_t stream);

// Single-level RoIAlign; `levels` [batch, n] may be NULL. When it is given,
// only the RoIs whose level (clamped to 2..5) equals `level` are written:
// up to 4096 RoIs per image each block compacts its image's list of those
// RoIs in shared memory; above that it walks every RoI and skips those of
// other levels. Any n is taken.
int premvos_roi_align(const void* features, int h, int w, int c, int is_bf16,
                      float spatial_scale, const float* boxes,
                      const int* levels, int level, int batch, int n, int p,
                      int s, void* out, cudaStream_t stream);

// Its gradient with respect to the features, added into `grad_features`
// (float32 [batch, h, w, c], zeroed by the caller) with atomics; the same
// level filter, in the same two forms.
int premvos_roi_align_backward(const float* grad_out, int h, int w, int c,
                               float spatial_scale, const float* boxes,
                               const int* levels, int level, int batch, int n,
                               int p, int s, float* grad_features,
                               cudaStream_t stream);

// f1, f2 channels-last [b, h, w, c], bfloat16 (is_bf16) or float32; out
// float32 [b, D*D, h, w].
int premvos_correlation(const void* f1, const void* f2, int is_bf16, int b,
                        int h, int w, int c, int md, int stride, float* out,
                        cudaStream_t stream);

// Its gradient: grad float32 [b, D*D, h, w] (the forward's output layout);
// f1, f2, df1 and df2 float32 channels-last [b, h, w, c]. Each of df1 and
// df2 is written whole (no zero fill needed), and one that is NULL is not
// computed; one launch computes both.
int premvos_correlation_backward(const float* f1, const float* f2,
                                 const float* grad, int b, int h, int w,
                                 int c, int md, int stride, float* df1,
                                 float* df2, cudaStream_t stream);

int premvos_resample2d(const void* src, int is_bf16, const float* flow, int b,
                       int c, int h, int w, float* out, cudaStream_t stream);

// The block warp (warp_impl "block"): (by, bx) blocks of at most 4096
// pixels, each sampling a window of 2 * residual + 2 rows and columns
// around its rounded mean displacement; max_flow bounds how far outside the
// image a sample point may fall. Same layouts as premvos_resample2d.
int premvos_resample2d_block(const void* src, int is_bf16, const float* flow,
                             int b, int c, int h, int w, int by, int bx,
                             int residual, int max_flow, float* out,
                             cudaStream_t stream);

#ifdef __cplusplus
}
#endif

#endif  // PREMVOS_HOST_ONLY
