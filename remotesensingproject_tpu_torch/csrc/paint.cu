// Temporal propagation: line painting along EPI lines.
//
// Replaces the TPU kernel remotesensingproject_tpu/ops/propagation_pallas.py
// `_paint_kernel` (wrapper `propagate_pallas`).  Plain version:
// ops/propagation.py `propagate`; wrapper: ops/propagation_pallas.py.
// Reference: rslf_depth_computation_core.hpp:1083-1129.
//
// What it computes: every source pixel (v, u') of the s_hat plane that
// passes the propagation criterion paints its payloads onto targets
// (s, v, u' + o), o = round_half_away(offs[v, u'] * (s_hat - s)), that
// are still unclaimed and whose frame colour is within eps of the
// source's r_bar (chan_scale * sum_c diff^2 < eps^2).  The reference's
// order is first writer wins with u' ascending; the plain version visits
// o in descending order over [o_lo, o_hi] of the plane.
//
// Bound on this card: bytes.  Each target reads its claim byte; an
// unclaimed one also reads its C colours and, where painted, writes its
// claim byte and its two payloads (depth and disp_conf); the source rows
// are a [V, U] plane that stays in cache.
//
// Design: one thread per target (s, v, u).  Whether a target gets painted
// depends on its own claim bit only, and within one offset o a target has
// at most one source, u - o.  So the thread scans o from o_hi down to o_lo
// and stops at the first source that qualifies: that is the plain
// version's first-writer-wins order, with no synchronisation, and the
// result is bit for bit the same.  Claimed targets return at once, so late
// passes cost little.  The TPU kernel's v-tiles, lane-aligned roll windows
// and per-tile offset ranges are not needed.  Any channel count C is
// taken, as by the TPU kernel: for C <= 3 the target's colours sit in
// registers; beyond that they are read again at each candidate source.

#include "common.cuh"

namespace {

// kFixedC > 0: the target's colours held in registers (C <= kFixedC);
// kFixedC == 0: any C, the target's colours re-read at each source.
template <int kFixedC>
__global__ void paint_kernel(unsigned char* __restrict__ claim,
                             const float* __restrict__ frames,
                             const float* __restrict__ tag,
                             const float* __restrict__ rbar,
                             const float* __restrict__ range, int S, int V,
                             int U, int C, int s_hat, float cs, float eps_sq,
                             const float* __restrict__ src0,
                             float* __restrict__ tgt0,
                             const float* __restrict__ src1,
                             float* __restrict__ tgt1) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long plane = (long long)V * U;
  if (i >= (long long)S * plane) return;
  if (!claim[i]) return;
  if (range[2] == 0.f) return;  // no source at all
  const int s = (int)(i / plane);
  const long long vu = i - (long long)s * plane;
  const int v = (int)(vu / U);
  const int u = (int)(vu - (long long)v * U);

  const float ds = (float)(s_hat - s);
  const float c1 = rslf_round_half_away(range[0] * ds);
  const float c2 = rslf_round_half_away(range[1] * ds);
  const int o_lo = (int)fminf(c1, c2);
  const int o_hi = (int)fmaxf(c1, c2);
  float fr[kFixedC > 0 ? kFixedC : 1] = {};
  if (kFixedC > 0)
    for (int c = 0; c < C; ++c) fr[c] = frames[i * C + c];

  for (int o = o_hi; o >= o_lo; --o) {
    const int us = u - o;
    if (us < 0 || us >= U) continue;
    const long long j = (long long)v * U + us;
    const float tg = tag[j];
    if (tg != tg) continue;  // not a source (NaN tag)
    if (rslf_round_half_away(tg * ds) != (float)o) continue;
    float dsq = 0.f;
    for (int c = 0; c < C; ++c) {
      const float f0 = (kFixedC > 0) ? fr[c] : frames[i * C + c];
      const float diff = f0 - rbar[j * C + c];
      const float d2 = diff * diff;
      dsq = (c == 0) ? d2 : dsq + d2;
    }
    if (!(cs * dsq < eps_sq)) continue;
    tgt0[i] = src0[j];
    tgt1[i] = src1[j];
    claim[i] = 0;
    return;
  }
}

}  // namespace

RSLF_DEFINE_ERROR_STRING(rslf_paint_error_string)

// Launch on `stream`; updates claim and the two targets in place.
// `range` is a device array {min offs, max offs, any source} over the
// sources.
RSLF_EXPORT int rslf_paint(unsigned char* claim, const float* frames,
                           const float* tag, const float* rbar,
                           const float* range, int S, int V, int U, int C,
                           int s_hat, float cs, float eps_sq,
                           const float* src0, float* tgt0, const float* src1,
                           float* tgt1, void* stream) {
  const int threads = 256;
  const long long n = (long long)S * V * U;
  const int blocks = (int)((n + threads - 1) / threads);
  if (C <= 3)
    paint_kernel<3><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        claim, frames, tag, rbar, range, S, V, U, C, s_hat, cs, eps_sq, src0,
        tgt0, src1, tgt1);
  else
    paint_kernel<0><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        claim, frames, tag, rbar, range, S, V, U, C, s_hat, cs, eps_sq, src0,
        tgt0, src1, tgt1);
  return (int)cudaGetLastError();
}
