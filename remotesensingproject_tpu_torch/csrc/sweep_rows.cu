// Dense row sweep over a uniform candidate grid, with mean-shift scoring.
//
// Replaces the TPU kernel remotesensingproject_tpu/ops/sweep_pallas.py
// `_sweep_kernel` / `_sweep_row_body` (wrapper `sweep_pile_pallas`).
// Plain version: ops/sweep_pallas.py `sweep_rows_plain`; wrapper:
// ops/sweep_pallas.py `sweep_pile_rows`.
//
// What it computes, per pixel (v, u) it is given: for each candidate
// d = dvec[k] of the uniform grid (one value for every pixel), the S
// samples at u + shift, where shift = ((s_hat - s) * d) * slope is ONE value
// per (s, d) shared by all u: i0 = floor(shift), t = shift - i0, the sample
// is row[i0 + u] where t == 0 and (1 - t) * row[i0 + u] + t * row[i0 + u + 1]
// elsewhere, valid iff -i0 <= u <= U - 1 - (i0 + (t > 0)).  This differs
// from the per-pixel rounding of floor(u + shift) (sweep_pixel.cu) in the
// last ulp of the weight, as the TPU kernel does.  Then the truncated mean
// shift and scoring of sweep_ms.cuh, the first-max argmax and the score
// mean over all D candidates, and optionally k_best [V, S, U], the winning
// candidate's kernel values.
//
// Bound on this card: fp32 CUDA-core arithmetic.  The work is pixels x D x
// valid samples x mean-shift steps x (4C + 5) flops; the bytes are one read
// of the EPI volume and a few floats out per pixel.
//
// Design: one thread per pixel, over a compacted list of the pixels to
// sweep (the TPU kernel's per-row and per-128-lane-chunk activity flags
// become that list, so a skipped pixel costs nothing).  Consecutive threads
// hold consecutive pixels of a row, and since all u of a row read at one
// offset per (s, d), a warp's global reads are contiguous.  Each thread
// stages its S x C samples of the current candidate in its own column of
// shared memory ([s][c][thread], conflict-free), runs the mean shift on
// them, and walks the candidates in order, so that the argmax and the
// score sum follow the plain version's order with no synchronisation.
// The TPU kernel's padded VMEM rows, lane-group gathers and manual DMA
// are not needed.  No limit on D; any C (registers for C <= 4, shared
// memory beyond).

#include "sweep_ms.cuh"

namespace {

template <int MAXC>
__global__ void sweep_rows_kernel(const float* __restrict__ epis, int S,
                                  int U, int C, const int* __restrict__ act,
                                  int n_act, const float* __restrict__ dvec,
                                  int D, int s_hat, float slope, float a_coef,
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

  auto stage = [&](int d, float* delta) -> float {
    const float dval = dvec[d];
    *delta = dval;
    float card = 0.f;
    for (int s = 0; s < S; ++s) {
      const float shift = ((float)(s_hat - s) * dval) * slope;
      const float f0 = floorf(shift);
      const float t = shift - f0;
      const int i0 = (int)f0;
      const bool ok = (u >= -i0) && (u <= U - 1 - (i0 + (t > 0.f ? 1 : 0)));
      const float* src = row + ((size_t)s * U + (ok ? i0 + u : 0)) * C;
      for (int c = 0; c < C; ++c) {
        float val = __int_as_float(0x7fc00000);  // NaN marks invalid
        if (ok) {
          const float a = src[c];
          val = (t == 0.f) ? a : (1.f - t) * a + t * src[C + c];
        }
        samp[(s * C + c) * T] = val;
      }
      card = card + (ok ? 1.f : 0.f);
    }
    return card;
  };
  rslf_sweep_candidates<MAXC>(stage, samp, row + ((size_t)s_hat * U + u) * C,
                              S, U, C, T, D, a_coef, iters, false, v, u, rb,
                              rbp, srk, out);
}

template <int MAXC>
int launch(const float* epis, int S, int U, int C, const int* act, int n_act,
           const float* dvec, int D, int s_hat, float slope, float a_coef,
           int iters, int threads, const SweepOut& out, cudaStream_t stream) {
  const long long smem =
      rslf_sweep_smem_floats(S, C, threads, MAXC) * (long long)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_rows_kernel<MAXC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_act + threads - 1) / threads;
  sweep_rows_kernel<MAXC><<<blocks, threads, (size_t)smem, stream>>>(
      epis, S, U, C, act, n_act, dvec, D, s_hat, slope, a_coef, iters, out);
  return (int)cudaGetLastError();
}

}  // namespace

RSLF_DEFINE_ERROR_STRING(rslf_sweep_rows_error_string)

// Shared memory a block of `threads` threads needs.
RSLF_EXPORT long long rslf_sweep_rows_smem_bytes(int S, int C, int threads) {
  return rslf_sweep_smem_floats(S, C, threads, rslf_sweep_maxc(C)) *
         (long long)sizeof(float);
}

// Launch on `stream`; returns cudaGetLastError() of the launch.  `k_best`
// and `work_count` may be null.
RSLF_EXPORT int rslf_sweep_rows(const float* epis, int S, int U, int C,
                                const int* act, int n_act, const float* dvec,
                                int D, int s_hat, float slope, float a_coef,
                                int iters, int threads, float* best_score,
                                float* score_mean, float* best_depth,
                                float* rbar, float* k_best,
                                unsigned long long* work_count, void* stream) {
  const SweepOut out{best_score, score_mean, best_depth, rbar, k_best,
                     work_count};
  cudaStream_t st = (cudaStream_t)stream;
  switch (rslf_sweep_maxc(C)) {
    case 1:
      return launch<1>(epis, S, U, C, act, n_act, dvec, D, s_hat, slope,
                       a_coef, iters, threads, out, st);
    case 4:
      return launch<4>(epis, S, U, C, act, n_act, dvec, D, s_hat, slope,
                       a_coef, iters, threads, out, st);
    default:
      return launch<0>(epis, S, U, C, act, n_act, dvec, D, s_hat, slope,
                       a_coef, iters, threads, out, st);
  }
}
