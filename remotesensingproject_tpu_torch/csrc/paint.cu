// Temporal propagation: line painting along EPI lines.
//
// Replaces the TPU kernel remotesensingproject_tpu/ops/propagation_pallas.py
// `_paint_kernel` (wrapper `propagate_pallas`).  Plain version:
// ops/propagation.py `propagate`; wrapper: ops/propagation_pallas.py.
// Reference: rslf_depth_computation_core.hpp:1083-1129.
//
// What it computes: every source pixel (v, u') of the s_hat plane (those of
// `mask`) paints its payloads (1 to 3 (source, target) pairs: depth and
// disp_conf, and line_conf in line mode) onto the targets
// (s, v, u' - u_origin + o), o = round_half_away((depth[v, u'] * slope) *
// (s_hat - s)), that are still unclaimed and whose frame colour is within
// eps of the source's r_bar (chan_scale * sum_c diff^2 < eps^2).  The source
// planes are Us >= U columns wide and the targets' column 0 is source column
// u_origin: Us = U and u_origin = 0 for whole rows; the (v, u) mesh passes
// sources haloed by `pado` columns on each side and u_origin = pado (the TPU
// path's `u_origin`).  The reference's order is first writer wins with u'
// ascending, so a contested target takes the qualifying source with the
// smallest u' (a haloed column is monotone in the image column, so the
// smallest haloed column is the image's smallest).
//
// Bound on this card: bytes.  Each target reads its claim byte; an
// unclaimed one that a source reaches also reads its C colours and, where
// painted, writes its claim byte and its payloads; the source rows are
// [V, Us] planes that stay in cache.
//
// Design: the work is driven from the sources, one rounding per
// (s, source), not from the targets (a target cannot know which of the
// sources within reach point at it without trying every offset).  A block
// owns one row v, a run of frames s and a tile [u0, u0 + tile) of target
// columns, with an int `win[tile]` in shared memory.  For each frame of its
// run, the threads walk the row's sources in batches (all offsets of a
// batch, then all claim bytes, then the colours of the open targets, so
// that the loads of a batch are in flight together): a source whose target
// lies in the tile, is open and passes the colour test does
// atomicMin(&win[target], u').  After a block barrier each target with a
// winner takes the payloads of source win[target], in payload order, and
// closes its claim (a third payload is one more load and store there, under
// a test on a launch constant).
// The minimum does not depend on the order of the atomics, so the result is
// deterministic and equals the plain version's descending-offset scan bit
// for bit.  Neighbouring sources have near offsets, so the claim and frame
// reads of a warp are near-coalesced; the source row is read again for
// every frame of the run, from cache.  A row without any source ends after
// one look at its sources.  Any U (tiles), any C (registers for C <= 4,
// read again beyond).  The TPU kernel's v-tiles, lane-aligned roll windows
// and per-tile offset ranges are not needed.

#include <limits.h>

#include "common.cuh"

namespace {

struct PaintArgs {
  unsigned char* claim;        // [S, V, U], 1 = unclaimed
  const float* frames;         // [S, V, U, C]
  const float* depth;          // [V, Us] the sources' depths
  const unsigned char* mask;   // [V, Us] 1 = source
  const float* rbar;           // [V, Us, C]
  int S, V, U, C;
  int Us, u_origin;            // source columns; the targets' column 0
  int s_hat;
  float slope, cs, eps_sq;
  int n_pay;                   // payloads, 1 to 3
  const float* src0;           // [V, Us] payload sources (unused: null)
  const float* src1;
  const float* src2;
  float* tgt0;                 // [S, V, U] payload targets (unused: null)
  float* tgt1;
  float* tgt2;
  int tile;                    // target columns of a block
  int n_tiles;
  int s_run;                   // frames of a block
  int n_runs;
};

constexpr int kNone = INT_MAX;  // no source has qualified
constexpr int kThreads = 256;
constexpr int kBatch = 4;       // sources a thread keeps in flight

// NC > 0: exactly NC channels, unrolled; NC == 0: any C.  HALO: sources
// wider than the targets (Us, u_origin); without, Us = U and u_origin = 0
// are constants and whole rows pay nothing for them.
template <int NC, bool HALO>
__global__ void __launch_bounds__(kThreads) paint_kernel(const PaintArgs a) {
  extern __shared__ int win[];  // [tile] smallest qualifying u' per target
  const int tid = threadIdx.x;
  const int C = NC > 0 ? NC : a.C;
  const int U = a.U;
  const int Us = HALO ? a.Us : U;
  const int org = HALO ? a.u_origin : 0;
  int b = blockIdx.x;
  const int k = b % a.n_tiles;
  b /= a.n_tiles;
  const int r = b % a.n_runs;
  const int v = b / a.n_runs;
  const int u0 = k * a.tile;
  const int nt = min(a.tile, U - u0);
  const int s_begin = r * a.s_run;
  const int s_end = min(a.S, s_begin + a.s_run);
  const size_t vrow = (size_t)v * Us;  // the sources' row
  // the first and last target columns of the tile, in source columns
  const int t_lo = u0 + org;
  const int t_hi = t_lo + nt - 1;

  // a row without any source paints nothing
  int any = 0;
  for (int us = tid; us < Us; us += kThreads) any |= a.mask[vrow + us];
  if (!__syncthreads_or(any)) return;
  for (int i = tid; i < nt; i += kThreads) win[i] = kNone;
  __syncthreads();

  for (int s = s_begin; s < s_end; ++s) {
    const float ds = (float)(a.s_hat - s);
    const size_t trow = ((size_t)s * a.V + v) * U;  // the targets' row
    // ---- scatter: each source of the row bids for its target ----
    for (int base = 0; base < Us; base += kBatch * kThreads) {
      int ut[kBatch];  // the target column, or -1
      unsigned char is_open[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int us = base + j * kThreads + tid;
        ut[j] = -1;
        if (us < Us && a.mask[vrow + us]) {
          const float tg = __ldg(a.depth + vrow + us) * a.slope;
          const float of = rslf_round_half_away(tg * ds);
          // t_lo <= us + of <= t_hi, on floats: exact for the integers of
          // a row, and false for an offset beyond the int range
          if (of >= (float)(t_lo - us) && of <= (float)(t_hi - us))
            ut[j] = us + (int)of - org;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        is_open[j] = ut[j] >= 0 ? a.claim[trow + ut[j]] : 0;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (!is_open[j]) continue;
        const int us = base + j * kThreads + tid;
        const float* f = a.frames + (trow + ut[j]) * C;
        const float* rb = a.rbar + (vrow + us) * C;
        float dsq = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float diff = __ldg(f + c) - __ldg(rb + c);
          const float d2 = diff * diff;
          dsq = (c == 0) ? d2 : dsq + d2;
        }
        if (a.cs * dsq < a.eps_sq) atomicMin(&win[ut[j] - u0], us);
      }
    }
    __syncthreads();
    // ---- resolve: a target with a winner takes its payloads ----
    for (int i = tid; i < nt; i += kThreads) {
      const int us = win[i];
      if (us == kNone) continue;
      win[i] = kNone;  // for the next frame
      const size_t t = trow + u0 + i;
      a.tgt0[t] = __ldg(a.src0 + vrow + us);
      if (a.n_pay > 1) a.tgt1[t] = __ldg(a.src1 + vrow + us);
      if (a.n_pay > 2) a.tgt2[t] = __ldg(a.src2 + vrow + us);
      a.claim[t] = 0;
    }
    __syncthreads();
  }
}

template <int NC>
cudaError_t launch(const PaintArgs& a, cudaStream_t stream) {
  const long long blocks = (long long)a.V * a.n_runs * a.n_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t bytes = (size_t)a.tile * sizeof(int);
  if (a.Us != a.U || a.u_origin != 0)
    paint_kernel<NC, true><<<(unsigned)blocks, kThreads, bytes, stream>>>(a);
  else
    paint_kernel<NC, false><<<(unsigned)blocks, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

RSLF_DEFINE_ERROR_STRING(rslf_paint_error_string)

// Launch on `stream`; updates claim and the `n_payloads` (1 to 3) targets in
// place, (src0, tgt0) first; the pointers of unused payloads are null.  The
// source planes (depth, mask, rbar, src*) are `Us` >= U columns wide, the
// targets' column 0 at their column `u_origin` (Us = U, u_origin = 0 for
// whole rows).  `tile`
// is the number of target columns of a block; 0 lets the launcher choose
// (whole rows up to 4,096 columns).  A block takes a run of frames that
// leaves some 32 blocks for each SM (on an H100 runs of 4 to 25 frames are
// within 3% of each other, single frames 30% slower).
RSLF_EXPORT int rslf_paint(unsigned char* claim, const float* frames,
                           const float* depth, const unsigned char* mask,
                           const float* rbar, int S, int V, int U, int C,
                           int Us, int u_origin, int s_hat, float slope,
                           float cs, float eps_sq,
                           int n_payloads, const float* src0, float* tgt0,
                           const float* src1, float* tgt1, const float* src2,
                           float* tgt2, int tile, void* stream) {
  const float* srcs[3] = {src0, src1, src2};
  const float* tgts[3] = {tgt0, tgt1, tgt2};
  if (n_payloads < 1 || n_payloads > 3) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i)
    if ((i < n_payloads) != (srcs[i] != nullptr && tgts[i] != nullptr))
      return (int)cudaErrorInvalidValue;
  if (Us < U || u_origin < 0 || u_origin > Us - U)
    return (int)cudaErrorInvalidValue;
  if (S <= 0 || V <= 0 || U <= 0) return (int)cudaSuccess;
  if (tile < 0 || tile > 8192) return (int)cudaErrorInvalidValue;
  if (tile == 0) tile = U < 4096 ? U : 4096;
  if (tile > U) tile = U;
  const int n_tiles = (U + tile - 1) / tile;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)V * n_tiles;
  long long runs = (32LL * sms + rows - 1) / rows;
  if (runs > S) runs = S;
  const int s_run = (int)((S + runs - 1) / runs);
  const int n_runs = (S + s_run - 1) / s_run;
  const PaintArgs a{claim, frames, depth, mask, rbar, S, V, U, C, Us,
                    u_origin, s_hat, slope, cs, eps_sq, n_payloads, src0,
                    src1, src2, tgt0, tgt1, tgt2, tile, n_tiles, s_run,
                    n_runs};
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1:
      return (int)launch<1>(a, st);
    case 2:
      return (int)launch<2>(a, st);
    case 3:
      return (int)launch<3>(a, st);
    case 4:
      return (int)launch<4>(a, st);
    default:
      return (int)launch<0>(a, st);
  }
}
