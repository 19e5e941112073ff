// Pixel-compacted slope sweep with mean-shift scoring.
//
// Replaces the TPU kernel remotesensingproject_tpu/ops/sweep_pallas_pixel.py
// `_pixel_kernel` (wrapper `sweep_pile_pallas_pixel`).  Plain version:
// ops/sweep.py `sweep_pile`; wrapper: ops/sweep_pallas_pixel.py.
//
// What it computes, per active pixel (v, u) of the pass: for each of the
// D candidate disparities d = lo + (k * (hi - lo)) / (D - 1) (uniform or
// the pixel's own [lo, hi]), the S radiances sampled at
// u + ((s_hat - s) * d) * slope by linear interpolation (a sample is
// valid iff floor >= 0 and ceil <= U - 1), then `iters` truncated
// mean-shift steps, the score sum_s K / card_R with the kernel of the
// last step, and over the candidates the first-max argmax and the score
// sum.
//
// Bound on this card: fp32 CUDA-core arithmetic.  The work is
// active px x D x S x mean-shift steps x (4C + 5) flops; the bytes are one
// read of the EPI rows and a few floats out per pixel.
//
// Design: one block per active pixel, one thread per candidate (blocks of
// DB <= 128 threads loop over candidate chunks).  Each thread gathers its
// S samples once into shared memory ([s][c][thread], conflict-free), then
// runs the mean shift on them; a thread stops early once r_bar is a fixed
// point, since further steps would repeat the last one bit for bit.
// Scores and r_bar of all candidates land in shared memory and thread 0
// scans them in candidate order: the first-max argmax and the sequential
// score sum are then exactly the plain version's.  Sums over s are
// sequential from s = 0, as in the plain version.  The TPU's 128-lane
// groups, 8-pixel batches and scalar-core compaction are not carried
// over: the wrapper compacts the active pixels with torch.nonzero.

#include "common.cuh"

namespace {

__global__ void sweep_pixel_kernel(
    const float* __restrict__ epis, int S, int U, int C,
    const int* __restrict__ act,
    const float* __restrict__ bmin, const float* __restrict__ bmax,
    float dmin, float dmax, int D, int s_hat, float slope, float a_coef,
    int iters, float* __restrict__ best_score,
    float* __restrict__ score_mean, float* __restrict__ best_depth,
    float* __restrict__ rbar_out, unsigned long long* work_count) {
  extern __shared__ float smem[];
  const int DB = blockDim.x;
  const int tid = threadIdx.x;
  float* samp = smem;                    // [S][C][DB]
  float* sc_score = samp + S * C * DB;   // [D]
  float* sc_rbar = sc_score + D;         // [D][C]
  __shared__ unsigned long long blk_work;
  if (tid == 0) blk_work = 0ULL;
  __syncthreads();

  const int pix = act[blockIdx.x];
  const int v = pix / U;
  const int u = pix - v * U;
  float lo = dmin, hi = dmax;
  if (bmin != nullptr) {
    lo = bmin[pix];
    hi = bmax[pix];
  }
  const float rng = hi - lo;
  const float den = (float)(D - 1);
  const float* row = epis + (size_t)v * S * U * C;  // [S][U][C]
  float r0[3] = {0.f, 0.f, 0.f};
  for (int c = 0; c < C; ++c) r0[c] = row[((size_t)s_hat * U + u) * C + c];

  // valid samples x mean-shift steps this thread ran (the work count)
  unsigned long long my_work = 0ULL;
  for (int d0 = 0; d0 < D; d0 += DB) {
    const int d = d0 + tid;
    if (d < D) {
      const float delta = lo + ((float)d * rng) / den;
      float card = 0.f;
      for (int s = 0; s < S; ++s) {
        const float ds = (float)(s_hat - s);
        const float idx = (float)u + (ds * delta) * slope;
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
          samp[(s * C + c) * DB + tid] = val;
        }
        card = card + (ok ? 1.f : 0.f);
      }

      float rb[3] = {r0[0], r0[1], r0[2]};
      float sum_k = 0.f;
      int it = 0;
      while (it < iters) {
        ++it;
        float sk = 0.f;
        float srk[3] = {0.f, 0.f, 0.f};
        for (int s = 0; s < S; ++s) {
          const float x0 = samp[(s * C) * DB + tid];
          if (x0 != x0) continue;  // invalid sample: K = 0
          float dsq = 0.f;
          for (int c = 0; c < C; ++c) {
            const float diff = samp[(s * C + c) * DB + tid] - rb[c];
            const float d2 = diff * diff;
            dsq = (c == 0) ? d2 : dsq + d2;
          }
          const float k = fmaxf(1.f - a_coef * dsq, 0.f);
          sk = sk + k;
          for (int c = 0; c < C; ++c)
            srk[c] = srk[c] + fmaxf(samp[(s * C + c) * DB + tid], 0.f) * k;
        }
        bool same = true;
        for (int c = 0; c < C; ++c) {
          const float nr = (sk > 0.f) ? srk[c] / sk : 0.f;
          same = same && (nr == rb[c]);
          rb[c] = nr;
        }
        sum_k = sk;
        if (same) break;  // a fixed point: later steps repeat this one
      }
      my_work += (unsigned long long)it * (unsigned long long)card;
      sc_score[d] = (card > 0.f) ? sum_k / card : 0.f;
      for (int c = 0; c < C; ++c) sc_rbar[d * C + c] = rb[c];
    }
    // the next chunk reuses the sample buffer of the same thread only
  }
  if (work_count != nullptr) atomicAdd(&blk_work, my_work);
  __syncthreads();

  if (tid == 0) {
    float best = -1.f, sum = 0.f;
    int bi = -1;
    for (int d = 0; d < D; ++d) {
      const float sc = sc_score[d];
      if (sc > best) {
        best = sc;
        bi = d;
      }
      sum = sum + sc;
    }
    best_score[pix] = best;
    score_mean[pix] = sum / (float)D;
    best_depth[pix] = (bi >= 0) ? lo + ((float)bi * rng) / den : 0.f;
    for (int c = 0; c < C; ++c)
      rbar_out[(size_t)pix * C + c] = (bi >= 0) ? sc_rbar[bi * C + c] : 0.f;
    if (work_count != nullptr) atomicAdd(work_count, blk_work);
  }
}

}  // namespace

RSLF_DEFINE_ERROR_STRING(rslf_sweep_pixel_error_string)

// Shared memory the launch needs for a block of `db` threads.
RSLF_EXPORT long long rslf_sweep_pixel_smem_bytes(int S, int C, int D,
                                                  int db) {
  return (long long)(S * C * db + D * (1 + C)) * (long long)sizeof(float);
}

// Launch on `stream`; returns cudaGetLastError() of the launch.
RSLF_EXPORT int rslf_sweep_pixel(
    const float* epis, int S, int U, int C, const int* act, int n_act,
    const float* bmin, const float* bmax, float dmin, float dmax, int D,
    int s_hat, float slope, float a_coef, int iters, int db,
    float* best_score, float* score_mean, float* best_depth, float* rbar,
    unsigned long long* work_count, void* stream) {
  const long long smem = rslf_sweep_pixel_smem_bytes(S, C, D, db);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_pixel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sweep_pixel_kernel<<<n_act, db, (size_t)smem, (cudaStream_t)stream>>>(
      epis, S, U, C, act, bmin, bmax, dmin, dmax, D, s_hat, slope, a_coef,
      iters, best_score, score_mean, best_depth, rbar, work_count);
  return (int)cudaGetLastError();
}
