// The pass's merge: the sweep's results into the state's s_hat planes.
//
// Plain version: ops/merge.py `merge`; wrapper: the same module's
// `merge_cuda`.  Reference: the JAX package's models/depth2d.py `_pass_fn`
// (its merge, lines 433-455), which XLA fuses; the JAX package has no TPU
// kernel for it.
//
// What it computes, at each pixel p of the [V, U] plane: an inactive pixel
// keeps every plane.  An active one is good where best_score > threshold
// (float32, as PyTorch compares a float32 tensor with a Python scalar) and
// bad elsewhere (NaN included).  A bad pixel gets ce = 0 and ce_mask =
// false.  A good pixel gets the sweep's best_depth and r_bar (C channels)
// and disp_conf = ce * |best_score - score_mean|, its ce unchanged (a good
// pixel is not bad).  `conf` [V, U], a buffer of its own, receives
// disp_conf after the merge at every pixel; `good` [V, U], where given, the
// good bit at every pixel.  Every operation rounds as the plain version's
// (-fmad=false), so the result is bitwise the same.
//
// Bound on this card: bytes.  Every pixel reads its active byte and writes
// its conf (and good) entry; a pixel that is not good reads disp_conf for
// the copy; an active one reads best_score; a bad one writes ce and
// ce_mask; a good one reads ce, score_mean, the sweep's depth and r_bar and
// writes best_depth, disp_conf and r_bar.
//
// Design: one thread a pixel, no shared memory.  The kernel replaces the
// pass's 19 PyTorch launches (comparisons, four wheres, five plane writes)
// with one, whose device time is a few microseconds on the passes of a
// scene; the host time of those launches was the cost.

#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // pixels a block

struct MergeArgs {
  const unsigned char* active;  // [V, U] 1 = swept this pass
  const float* best_score;      // [V, U] the sweep's
  const float* score_mean;      // [V, U]
  const float* sweep_depth;     // [V, U]
  const float* sweep_rbar;      // [V, U, C]
  float threshold;              // raw_score_threshold, rounded to float32
  float* ce;                    // [V, U] the state's planes at s_hat
  unsigned char* ce_mask;       // [V, U]
  float* disp_conf;             // [V, U]
  float* best_depth;            // [V, U]
  float* rbar;                  // [V, U, C]
  float* conf;                  // [V, U] disp_conf after the merge
  unsigned char* good;          // [V, U] or null
  int n, C;                     // V * U, channels
};

__global__ void __launch_bounds__(kThreads) merge_kernel(const MergeArgs a) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= a.n) return;
  bool good = false;
  if (a.active[p] != 0) {
    const float score = __ldg(a.best_score + p);
    if (score > a.threshold) {
      good = true;
      const float conf = __fmul_rn(
          a.ce[p], fabsf(__fsub_rn(score, __ldg(a.score_mean + p))));
      a.best_depth[p] = __ldg(a.sweep_depth + p);
      a.disp_conf[p] = conf;
      a.conf[p] = conf;
      const size_t q = static_cast<size_t>(p) * a.C;
      for (int c = 0; c < a.C; ++c)
        a.rbar[q + c] = __ldg(a.sweep_rbar + q + c);
    } else {
      a.ce[p] = 0.0f;
      a.ce_mask[p] = 0;
    }
  }
  if (!good) a.conf[p] = a.disp_conf[p];
  if (a.good != nullptr) a.good[p] = good;
}

}  // namespace

RSLF_DEFINE_ERROR_STRING(rslf_merge_error_string)

// The merge of one pass at the s_hat planes.  `good` may be null.  Returns
// a CUDA error code (cudaErrorInvalidValue for C < 1 or a plane of about
// 2^31 pixels or more).
RSLF_EXPORT int rslf_merge(const unsigned char* active,
                           const float* best_score, const float* score_mean,
                           const float* sweep_depth, const float* sweep_rbar,
                           float threshold, float* ce, unsigned char* ce_mask,
                           float* disp_conf, float* best_depth, float* rbar,
                           float* conf, unsigned char* good, int V, int U,
                           int C, void* stream) {
  if (V < 0 || U < 0 || C < 1 ||
      static_cast<long long>(V) * U > INT_MAX - kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = V * U;
  if (n == 0) return 0;
  const MergeArgs a{active, best_score, score_mean, sweep_depth, sweep_rbar,
                    threshold, ce, ce_mask, disp_conf, best_depth, rbar,
                    conf, good, n, C};
  merge_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
