// The C interface of the port's CUDA kernels: pointers to device memory,
// sizes, and PyTorch's current CUDA stream last. Each function returns the
// cudaError_t of its launches (0 when every launch was accepted).
//
// Every source includes this header, so a definition that drifts from its
// declaration here does not compile. kernels/__init__.py reads the ctypes
// argument types from these declarations, so the Python side cannot drift
// either. Keep to one declaration per function, each parameter a pointer,
// `int`, `float` or `cudaStream_t`.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

int premvos_nms(const float* boxes, const uint8_t* alive, int batch, int n,
                float iou_threshold, int max_outputs,
                unsigned long long* mask_scratch, uint8_t* keep,
                cudaStream_t stream);

int premvos_multilevel_roi_align(const void* p2, const void* p3,
                                 const void* p4, const void* p5, int h2,
                                 int w2, int h3, int w3, int h4, int w4,
                                 int h5, int w5, int c, int is_bf16,
                                 const float* boxes, const int* levels,
                                 int batch, int n, int p, int s, void* out,
                                 cudaStream_t stream);

int premvos_correlation(const float* f1, const float* f2, int b, int h, int w,
                        int c, int md, int stride, float* out,
                        cudaStream_t stream);

int premvos_resample2d(const void* src, int is_bf16, const float* flow, int b,
                       int c, int h, int w, float* out, cudaStream_t stream);

#ifdef __cplusplus
}
#endif
