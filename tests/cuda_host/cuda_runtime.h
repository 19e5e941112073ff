// Host stand-ins for the CUDA names the port's sweep core uses, so that
// g++ can compile csrc/sweep_pc.cuh for the CPU: its device functions run
// as plain C++ (one thread), and its launcher's plan runs against an
// occupancy that counts shared memory and warps only (an H100's: 132 SMs,
// 227 KB a block, 228 KB an SM less 1 KB a block, 64 warps, 32 blocks).
// Used by tests/test_torch_sweep_core_host.py; kernels are compiled, never
// launched.
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
using std::max;
using std::min;
#define __device__
#define __host__
#define __global__
#define __launch_bounds__(...)
#define __forceinline__ inline
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
template <typename T>
inline T __ldg(const T* p) {
  return *p;
}
struct rslf_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
static rslf_dim3 threadIdx, blockIdx, blockDim, gridDim;
inline unsigned __ballot_sync(unsigned, bool b) { return b; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
template <typename T>
inline T __shfl_sync(unsigned, T v, int) {
  return v;
}
template <typename T>
inline T __shfl_down_sync(unsigned, T v, int) {
  return v;
}
template <typename T>
inline T atomicAdd(T* p, T v) {
  const T o = *p;
  *p += v;
  return o;
}
inline void __syncthreads() {}
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9
};
typedef void* cudaStream_t;
enum cudaDeviceAttr {
  cudaDevAttrMaxSharedMemoryPerBlockOptin,
  cudaDevAttrMultiProcessorCount
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? 132 : 232448;
  return cudaSuccess;
}
template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <typename F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* nb, F, int T, size_t bytes) {
  const int by_smem = (int)(233472 / ((long)bytes + 1024));
  const int by_warps = 64 / ((T + 31) / 32);
  *nb = std::min(std::min(by_smem, by_warps), 32);
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
