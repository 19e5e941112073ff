// Selective (confidence- and colour-gated) median filter.
//
// Replaces the TPU kernel remotesensingproject_tpu/ops/median_pallas.py
// `_median_kernel` (wrapper `selective_median_pallas`).  Plain version:
// ops/median.py `selective_median`; wrapper: ops/median_pallas.py.
// Reference: selective_median_filter, rslf_depth_computation_core.hpp:663-718.
//
// What it computes, per (v, u) under the mask: the size x size window taps
// that lie in the image, are masked, and whose frame colour is within eps
// of the centre's (sqrt(chan_scale * sum_c diff^2) < eps, channel 0
// first, the types.norm expression); the result is the element n // 2 of
// the sorted included values.  Unmasked pixels get 0.
//
// Bound on this card: bytes.  Each pixel reads its source value, mask
// byte and C colour values and writes one float; the taps come from L1.
//
// Design: one thread per pixel.  The included values are insertion-sorted
// into a per-thread array as they are found.  Any correct sort yields the
// same element n // 2 for finite values, so the result equals the plain
// version's odd-even network bit for bit.  The TPU kernel's 16-row VMEM
// windows with lane padding are not needed: neighbouring threads share
// the taps through the cache.  Any channel count C is taken, as by the TPU
// kernel: for C <= 3 the centre's colours sit in registers; beyond that
// they are read again from global memory (L1) at each tap.

#include "common.cuh"

namespace {

constexpr int kMaxSize = 17;
constexpr int kMaxTaps = kMaxSize * kMaxSize;

// kFixedC > 0: the centre's colours held in registers (C <= kFixedC);
// kFixedC == 0: any C, the centre's colours re-read at each tap.
template <int kFixedC>
__global__ void selective_median_kernel(
    const float* __restrict__ src, const unsigned char* __restrict__ mask,
    const float* __restrict__ frame, int V, int U, int C, int size,
    float eps, float cs, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)V * U) return;
  if (!mask[i]) {
    out[i] = 0.f;
    return;
  }
  const int v = (int)(i / U);
  const int u = (int)(i - (long long)v * U);
  const int w = (size - 1) / 2;
  float fc[kFixedC > 0 ? kFixedC : 1] = {};
  if (kFixedC > 0)
    for (int c = 0; c < C; ++c) fc[c] = frame[i * C + c];

  float vals[kMaxTaps];
  int n = 0;
  for (int dy = 0; dy < size; ++dy) {
    const int tv = v - w + dy;
    if (tv < 0 || tv >= V) continue;
    for (int dx = 0; dx < size; ++dx) {
      const int tu = u - w + dx;
      if (tu < 0 || tu >= U) continue;
      const long long j = (long long)tv * U + tu;
      if (!mask[j]) continue;
      float dsq = 0.f;
      for (int c = 0; c < C; ++c) {
        const float f0 = (kFixedC > 0) ? fc[c] : frame[i * C + c];
        const float diff = f0 - frame[j * C + c];
        const float d2 = diff * diff;
        dsq = (c == 0) ? d2 : dsq + d2;
      }
      if (!(sqrtf(cs * dsq) < eps)) continue;
      const float x = src[j];
      int k = n++;
      while (k > 0 && vals[k - 1] > x) {
        vals[k] = vals[k - 1];
        --k;
      }
      vals[k] = x;
    }
  }
  // n == 0 only when eps <= 0: the plain version then picks +inf
  out[i] = (n > 0) ? vals[n / 2] : __int_as_float(0x7f800000);
}

}  // namespace

RSLF_DEFINE_ERROR_STRING(rslf_median_error_string)

// Launch on `stream`; returns cudaGetLastError() of the launch.
RSLF_EXPORT int rslf_selective_median(const float* src,
                                      const unsigned char* mask,
                                      const float* frame, int V, int U, int C,
                                      int size, float eps, float cs,
                                      float* out, void* stream) {
  const int threads = 256;
  const long long n = (long long)V * U;
  const int blocks = (int)((n + threads - 1) / threads);
  if (C <= 3)
    selective_median_kernel<3><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        src, mask, frame, V, U, C, size, eps, cs, out);
  else
    selective_median_kernel<0><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        src, mask, frame, V, U, C, size, eps, cs, out);
  return (int)cudaGetLastError();
}
