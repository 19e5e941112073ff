// Per-pixel candidate loop with mean-shift scoring, shared by the dense row
// sweep (sweep_rows.cu) and the per-pixel tile sweep (sweep_tiles.cu).
//
// One thread sweeps one pixel.  For each candidate d in order, a staging
// function writes the pixel's S sheared samples into the thread's column
// of shared memory, samp[(s * C + c) * T] (NaN marks an invalid sample),
// and returns card_R, the count of valid samples.  Then the truncated mean
// shift from r_bar = the pixel's s_hat colour, the score sum_s K / card_R
// with the kernel values K of the last step, and, over the candidates, the
// first-max argmax and the sequential score sum: every sum and every
// comparison in the order of the plain PyTorch versions, so that the
// result is theirs bit for bit (with -fmad=false).
#pragma once

#include "common.cuh"

// One thread's channel vector: registers for C <= MAXC (MAXC > 0), or a
// column of shared memory, element c at col[c * stride], for any C
// (MAXC == 0).
template <int MAXC>
struct ChanVec {
  float reg[MAXC > 0 ? MAXC : 1];
  float* col;
  int stride;
  __device__ __forceinline__ float& operator[](int c) {
    return MAXC > 0 ? reg[c] : col[c * stride];
  }
};

// Loop over the channels c < C, unrolled over MAXC when the channel vectors
// sit in registers, so that every register index is known when compiling.
#define RSLF_FOR_C(c)                                                 \
  _Pragma("unroll") for (int c = 0; c < (MAXC > 0 ? MAXC : C); ++c) \
    if (MAXC == 0 || c < C)

// K = max(1 - a * sum_c (x_c - r_c)^2, 0), channel 0 first.
template <int MAXC>
__device__ __forceinline__ float rslf_ms_kernel(const float* x, int C, int T,
                                                float a_coef,
                                                ChanVec<MAXC>& r) {
  float dsq = 0.f;
  RSLF_FOR_C(c) {
    const float diff = x[c * T] - r[c];
    const float d2 = diff * diff;
    dsq = (c == 0) ? d2 : dsq + d2;
  }
  return fmaxf(1.f - a_coef * dsq, 0.f);
}

// Output pointers and constants of one sweep launch.
struct SweepOut {
  float* best_score;   // [V, U]
  float* score_mean;   // [V, U]
  float* best_depth;   // [V, U]
  float* rbar;         // [V, U, C]
  float* k_best;       // [V, S, U] or null
  unsigned long long* work_count;  // or null
};

// The candidate loop of pixel (v, u).  `stage(d, &delta)` stages candidate
// d's samples and returns card_R, or returns -1 for a candidate that is
// masked out (it can neither win nor count in the mean, so it is not
// swept).  `r0` points at the pixel's s_hat colours.  `masked` selects the
// mean over the allowed candidates, (sum * D / max(n_allowed, 1)) / D.
template <int MAXC, typename Stage>
__device__ __forceinline__ void rslf_sweep_candidates(
    Stage stage, const float* samp, const float* r0, int S, int U, int C,
    int T, int D, float a_coef, int iters, bool masked, int v, int u,
    ChanVec<MAXC>& rb, ChanVec<MAXC>& rbp, ChanVec<MAXC>& srk,
    const SweepOut& out) {
  const size_t pix = (size_t)v * U + u;
  float best = -1.f, best_d = 0.f, sum = 0.f;
  int n_allowed = 0;
  unsigned long long work = 0ULL;
  for (int d = 0; d < D; ++d) {
    float delta;
    const float card = stage(d, &delta);
    if (card < 0.f) continue;
    ++n_allowed;
    RSLF_FOR_C(c) rb[c] = r0[c];

    // truncated mean shift; a fixed point of r_bar ends it, since every
    // later step would repeat the last one bit for bit
    float sum_k = 0.f;
    int it = 0;
    while (it < iters) {
      ++it;
      float sk = 0.f;
      RSLF_FOR_C(c) {
        rbp[c] = rb[c];
        srk[c] = 0.f;
      }
      for (int s = 0; s < S; ++s) {
        const float* x = samp + s * C * T;
        if (x[0] != x[0]) continue;  // invalid sample: K = 0
        const float k = rslf_ms_kernel<MAXC>(x, C, T, a_coef, rb);
        sk = sk + k;
        RSLF_FOR_C(c) srk[c] = srk[c] + fmaxf(x[c * T], 0.f) * k;
      }
      bool same = true;
      RSLF_FOR_C(c) {
        const float nr = (sk > 0.f) ? srk[c] / sk : 0.f;
        same = same && (nr == rb[c]);
        rb[c] = nr;
      }
      sum_k = sk;
      if (same) break;
    }
    work += (unsigned long long)it * (unsigned long long)card;
    const float score = (card > 0.f) ? sum_k / card : 0.f;

    if (score > best) {
      best = score;
      best_d = delta;
      RSLF_FOR_C(c) out.rbar[pix * C + c] = rb[c];
      if (out.k_best != nullptr) {
        // K of the last step, from the r_bar that step started with
        for (int s = 0; s < S; ++s) {
          const float* x = samp + s * C * T;
          out.k_best[((size_t)v * S + s) * U + u] =
              (x[0] != x[0]) ? 0.f : rslf_ms_kernel<MAXC>(x, C, T, a_coef, rbp);
        }
      }
    }
    sum = sum + score;
  }
  out.best_score[pix] = best;
  out.best_depth[pix] = best_d;
  const float fD = (float)D;
  out.score_mean[pix] =
      masked ? ((sum * fD) / (float)max(n_allowed, 1)) / fD : sum / fD;
  if (out.work_count != nullptr) atomicAdd(out.work_count, work);
}

// Shared memory of a block of T threads: the samples, and the three
// channel vectors when they do not sit in registers.
__host__ __device__ inline long long rslf_sweep_smem_floats(int S, int C,
                                                            int T, int maxc) {
  return (long long)S * C * T + (maxc == 0 ? 3LL * C * T : 0LL);
}

// The register width used for C channels.
__host__ __device__ inline int rslf_sweep_maxc(int C) {
  return C == 1 ? 1 : (C <= 4 ? 4 : 0);
}

// Binds the channel vectors of thread `tid` (only read when MAXC == 0).
template <int MAXC>
__device__ __forceinline__ void rslf_bind_chan(float* smem, int S, int C,
                                               int T, int tid,
                                               ChanVec<MAXC>& rb,
                                               ChanVec<MAXC>& rbp,
                                               ChanVec<MAXC>& srk) {
  float* base = smem + (size_t)S * C * T + tid;
  rb.col = base;
  rbp.col = base + (size_t)C * T;
  srk.col = base + 2 * (size_t)C * T;
  rb.stride = rbp.stride = srk.stride = T;
}
