// Shared helpers of the port's CUDA kernels.
//
// Every kernel library is built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (see ops/cuda_build.py).  -fmad=false keeps a*b + c as two roundings,
// like the plain PyTorch versions, so that candidate grids, sample
// indices and colour distances round exactly as they do; division and
// sqrtf stay IEEE (no --use_fast_math).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define RSLF_EXPORT extern "C" __attribute__((visibility("default")))

// cudaGetErrorString under a per-library name, for the Python wrapper.
#define RSLF_DEFINE_ERROR_STRING(name)                      \
  RSLF_EXPORT const char* name(int err) {                   \
    return cudaGetErrorString(static_cast<cudaError_t>(err)); \
  }

// Round half away from zero (C++ std::round), as types.round_half_away.
__device__ __forceinline__ float rslf_round_half_away(float x) {
  return copysignf(floorf(fabsf(x) + 0.5f), x);
}
