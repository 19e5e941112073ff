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
// iff floor(I) >= 0 and ceil(I) <= U - 1, or with `nearest` the one sample
// row[round_half_away(I)], valid iff that column lies in [0, U - 1] (the
// plain version's `interpolation="nearest"`; callers take the pixel mode
// for it, each pixel's own grid).  With a window [u_lo, u_hi] of valid
// columns other than [0, U - 1] (the (v, u) mesh's u-haloed block), I is
// taken in the window's columns, I = (u - u_lo) + ..., validity against
// [0, u_hi - u_lo] and the columns read are u_lo + floor(I) and
// u_lo + ceil(I), clamped to [0, U - 1]: the core's position rules, shared
// with the pixel sweep.  Then the mean shift, scoring,
// first-max argmax and score mean, and optionally k_best.  In the masked
// mode (allowed ranges [pmin, pmax] given) a candidate outside
// [pmin - step, pmax + step], step = (hi - lo) / (D - 1), can neither win
// nor count in the mean, which becomes (sum * D / max(n_allowed, 1)) / D.
//
// Bound on this card: fp32 CUDA-core arithmetic that cannot fuse; in the
// masked mode only the allowed candidates are work.
//
// Design: a launcher of the (pixel, candidate) core, sweep_pc.cuh.  A block
// takes a group of consecutive listed pixels and lays only their ALLOWED
// candidates densely over its threads, so a warp never runs the union of
// its pixels' candidates, and a coarse level of a few thousand pixels still
// becomes pixels x allowed candidates items spread over every SM.  What
// bounds it is the shared memory of the staged samples (1,600 bytes a
// thread at S = 100, C = 4, some 130 resident threads an SM), so the inner
// loop is unrolled to keep several samples in flight in each thread.  The
// TPU kernel's window scan over 8-row blocks, lane rolls and row cursor
// exist because the TPU has no per-lane gather; here each thread reads its
// own samples.  The 128-lane tiles stay a semantic of the caller (the
// quantized grid bounds), not of the block shape.  Any D, any C (registers
// for C <= 4, shared memory beyond).  The linear and the nearest rule are
// two instantiations of the core (PcRulePixel, PcRuleNearest), each with a
// twin for a window other than the whole row (PcRulePixelWindow,
// PcRuleNearestWindow), so that whole rows pay nothing for the window.
// Fast mode does not cap this kernel (the TPU caps only its pixel kernel).

#include "sweep_pc.cuh"

RSLF_DEFINE_ERROR_STRING(rslf_sweep_tiles_error_string)

// The launcher's plan for this size and mode, under the linear or the
// nearest rule, into out[5]: threads of a block, items of a window, bytes of
// shared memory a block, resident blocks an SM, SMs.  Returns the CUDA error
// code (cudaErrorInvalidConfiguration when no block size fits).
RSLF_EXPORT int rslf_sweep_tiles_plan(int S, int C, int with_k, int masked,
                                      int nearest, int* out) {
  return nearest ? rslf_pc::plan_for_c<PcRuleNearest>(S, C, with_k, masked,
                                                      0, out)
                 : rslf_pc::plan_for_c<PcRulePixel>(S, C, with_k, masked, 0,
                                                    out);
}

// Launch on `stream`; returns the CUDA error code of the launch.  `act`
// holds `cap` entries, of which the first `*count` (device memory, never
// read by the host) list the pixels to sweep.  `pmin` / `pmax` (the masked
// mode), `k_best` and `work_count` may be null; `nearest` != 0 takes the
// nearest rule; [u_lo, u_hi] is the window of valid sample columns
// ([0, U - 1] for whole rows).
RSLF_EXPORT int rslf_sweep_tiles(const float* epis, int S, int U, int C,
                                 const int* act, const int* count, int cap,
                                 const float* bmin, const float* bmax,
                                 const float* pmin, const float* pmax, int D, int s_hat,
                                 float slope, float a_coef, int iters,
                                 int nearest, int u_lo, int u_hi,
                                 float* best_score,
                                 float* score_mean, float* best_depth,
                                 float* rbar, float* k_best,
                                 unsigned long long* work_count,
                                 void* stream) {
  const PcArgs a{epis, S, U, C, act, count, cap, bmin, bmax, 0.f, 0.f,
                 pmin, pmax, D, s_hat, slope, a_coef, iters, 0, 0,
                 u_lo, u_hi, SweepOut{best_score, score_mean, best_depth, rbar, k_best,
                          work_count}};
  const cudaStream_t st = (cudaStream_t)stream;
  // whole rows keep the rules without a window (their own instantiations)
  if (u_lo == 0 && u_hi == U - 1)
    return nearest ? rslf_pc::launch_for_c<PcRuleNearest>(a, st)
                   : rslf_pc::launch_for_c<PcRulePixel>(a, st);
  return nearest ? rslf_pc::launch_for_c<PcRuleNearestWindow>(a, st)
                 : rslf_pc::launch_for_c<PcRulePixelWindow>(a, st);
}
