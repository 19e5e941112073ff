// Per-pixel-bounds sweep (the tile sweep), with mean-shift scoring.
//
// Replaces the TPU kernel remotesensingproject_tpu/ops/sweep_pallas_perpixel.py
// `_sweep_pp_kernel` / `_sweep_pp_body` (wrapper
// `sweep_pile_pallas_perpixel`).  Plain version: ops/sweep.py `sweep_pile`
// (with `pdmin_v_u` / `pdmax_v_u` in the masked mode); wrapper:
// ops/sweep_pallas_perpixel.py `sweep_pile_tiles`.
//
// What it computes, per pixel (v, u) it is given: for each candidate
// delta = lo + (d * (hi - lo)) / (D - 1) of the pixel's own grid bounds
// [lo, hi] (in the tile mode the caller passes bounds shared by each
// 128-lane tile), the S samples at I = u + ((s_hat - s) * delta) * slope,
// computed per pixel: (1 - t) * row[floor(I)] + t * row[ceil(I)], valid
// iff floor(I) >= 0 and ceil(I) <= U - 1.  Then the mean shift, scoring,
// first-max argmax and score mean of sweep_ms.cuh, and optionally k_best.
// In the masked mode (allowed ranges [pdmin, pdmax] given) a candidate
// outside [pdmin - step, pdmax + step], step = (hi - lo) / (D - 1), can
// neither win nor count in the mean, which becomes
// (sum * D / max(n_allowed, 1)) / D.
//
// Bound on this card: fp32 CUDA-core arithmetic, as the row sweep; in the
// masked mode only the allowed candidates are work.
//
// Design: the row sweep's (one thread per pixel of a compacted list,
// samples staged in the thread's shared-memory column, candidates in
// order), with the per-pixel positions; a masked-out candidate is skipped
// before its samples are staged, since nothing it computes is read.  The
// TPU kernel's window scan over 8-row blocks, lane rolls and row cursor
// exist because the TPU has no per-lane gather; here each thread reads its
// own samples.  The 128-lane tiles stay a semantic of the caller (the
// quantized grid bounds), not of the block shape.

#include "sweep_ms.cuh"

namespace {

template <int MAXC>
__global__ void sweep_tiles_kernel(const float* __restrict__ epis, int S,
                                   int U, int C, const int* __restrict__ act,
                                   int n_act, const float* __restrict__ bmin,
                                   const float* __restrict__ bmax,
                                   const float* __restrict__ pmin,
                                   const float* __restrict__ pmax, int D,
                                   int s_hat, float slope, float a_coef,
                                   int iters, SweepOut out) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int n = blockIdx.x * T + tid;
  if (n >= n_act) return;
  const int pix = act[n];
  const int v = pix / U;
  const int u = pix - v * U;
  const float* row = epis + (size_t)v * S * U * C;  // [S][U][C]
  float* samp = smem + tid;                          // [S][C][T]
  ChanVec<MAXC> rb, rbp, srk;
  rslf_bind_chan<MAXC>(smem, S, C, T, tid, rb, rbp, srk);

  const float lo = bmin[pix];
  const float rng = bmax[pix] - lo;
  const float den = (float)(D - 1);
  const bool masked = pmin != nullptr;
  float plo = 0.f, phi = 0.f;
  if (masked) {
    const float tol = rng / den;
    plo = pmin[pix] - tol;
    phi = pmax[pix] + tol;
  }

  auto stage = [&](int d, float* delta) -> float {
    const float dl = lo + ((float)d * rng) / den;
    *delta = dl;
    if (masked && !(dl >= plo && dl <= phi)) return -1.f;
    float card = 0.f;
    for (int s = 0; s < S; ++s) {
      const float ds = (float)(s_hat - s);
      const float idx = (float)u + (ds * dl) * slope;
      const float fi = floorf(idx);
      const float ci = ceilf(idx);
      const bool ok = (fi >= 0.f) && (ci <= (float)(U - 1));
      const float t = idx - fi;
      for (int c = 0; c < C; ++c) {
        float val = __int_as_float(0x7fc00000);  // NaN marks invalid
        if (ok) {
          const float a = row[((size_t)s * U + (int)fi) * C + c];
          const float b = row[((size_t)s * U + (int)ci) * C + c];
          val = (1.f - t) * a + t * b;
        }
        samp[(s * C + c) * T] = val;
      }
      card = card + (ok ? 1.f : 0.f);
    }
    return card;
  };
  rslf_sweep_candidates<MAXC>(stage, samp, row + ((size_t)s_hat * U + u) * C,
                              S, U, C, T, D, a_coef, iters, masked, v, u, rb,
                              rbp, srk, out);
}

template <int MAXC>
int launch(const float* epis, int S, int U, int C, const int* act, int n_act,
           const float* bmin, const float* bmax, const float* pmin,
           const float* pmax, int D, int s_hat, float slope, float a_coef,
           int iters, int threads, const SweepOut& out, cudaStream_t stream) {
  const long long smem =
      rslf_sweep_smem_floats(S, C, threads, MAXC) * (long long)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_tiles_kernel<MAXC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_act + threads - 1) / threads;
  sweep_tiles_kernel<MAXC><<<blocks, threads, (size_t)smem, stream>>>(
      epis, S, U, C, act, n_act, bmin, bmax, pmin, pmax, D, s_hat, slope,
      a_coef, iters, out);
  return (int)cudaGetLastError();
}

}  // namespace

RSLF_DEFINE_ERROR_STRING(rslf_sweep_tiles_error_string)

// Shared memory a block of `threads` threads needs.
RSLF_EXPORT long long rslf_sweep_tiles_smem_bytes(int S, int C, int threads) {
  return rslf_sweep_smem_floats(S, C, threads, rslf_sweep_maxc(C)) *
         (long long)sizeof(float);
}

// Launch on `stream`; returns cudaGetLastError() of the launch.  `pmin` /
// `pmax` (the masked mode), `k_best` and `work_count` may be null.
RSLF_EXPORT int rslf_sweep_tiles(const float* epis, int S, int U, int C,
                                 const int* act, int n_act, const float* bmin,
                                 const float* bmax, const float* pmin,
                                 const float* pmax, int D, int s_hat,
                                 float slope, float a_coef, int iters,
                                 int threads, float* best_score,
                                 float* score_mean, float* best_depth,
                                 float* rbar, float* k_best,
                                 unsigned long long* work_count,
                                 void* stream) {
  const SweepOut out{best_score, score_mean, best_depth, rbar, k_best,
                     work_count};
  cudaStream_t st = (cudaStream_t)stream;
  switch (rslf_sweep_maxc(C)) {
    case 1:
      return launch<1>(epis, S, U, C, act, n_act, bmin, bmax, pmin, pmax, D,
                       s_hat, slope, a_coef, iters, threads, out, st);
    case 4:
      return launch<4>(epis, S, U, C, act, n_act, bmin, bmax, pmin, pmax, D,
                       s_hat, slope, a_coef, iters, threads, out, st);
    default:
      return launch<0>(epis, S, U, C, act, n_act, bmin, bmax, pmin, pmax, D,
                       s_hat, slope, a_coef, iters, threads, out, st);
  }
}
