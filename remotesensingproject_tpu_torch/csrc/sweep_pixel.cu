// Pixel-compacted slope sweep with mean-shift scoring.
//
// Replaces the TPU kernel remotesensingproject_tpu/ops/sweep_pallas_pixel.py
// `_pixel_kernel` (wrapper `sweep_pile_pallas_pixel`).  Plain version:
// ops/sweep.py `sweep_pile`; wrapper: ops/sweep_pallas_pixel.py.
//
// What it computes, per active pixel (v, u) of the pass: for each of the
// D candidate disparities d = lo + (k * (hi - lo)) / (D - 1) (uniform or
// the pixel's own [lo, hi]), the S radiances sampled at
// I = (u - u_lo) + ((s_hat - s) * d) * slope by linear interpolation (a
// sample is valid iff floor(I) >= 0 and ceil(I) <= u_hi - u_lo) or, with
// `nearest`, at round_half_away(I) (valid iff it lies in [0, u_hi - u_lo];
// the plain version's `interpolation="nearest"`), column u_lo + I of the
// row, clamped to [0, U - 1].  The window [u_lo, u_hi] of valid columns is
// [0, U - 1] for whole rows; the (v, u) mesh sweeps a block haloed in u and
// passes the image's columns (the TPU kernel's `u_valid`), and positions
// taken in the window's columns are the whole image's bit for bit.  Then
// `iters` truncated
// mean-shift steps, the score sum_s K / card_R with the kernel of the
// last step, and over the candidates the first-max argmax and the score
// sum.  Optionally k_best [V, S, U], the winning candidate's kernel values
// of its last step (line mode's input; `sweep_pile(..., with_k_best=True)`).
// The wrapper passes iters = min(mean_shift_max_iter, 5) in fast mode, as
// the TPU kernel caps it; the kernel itself only runs the count it is given.
//
// Bound on this card: fp32 CUDA-core arithmetic that cannot fuse.  The work
// is active px x D x valid samples x mean-shift steps x (4C + 5) operations;
// the bytes are one read of the EPI rows, a few floats out per pixel and,
// with k_best, S floats more.
//
// Design: a launcher of the (pixel, candidate) core, sweep_pc.cuh, in its
// unmasked mode: every candidate of every listed pixel is an item, a thread
// owns one item at a time, blocks take groups of consecutive pixels, and
// one thread per pixel folds the scores in candidate order.  What bounds it
// is where each thread keeps its staged samples (S x C floats a thread),
// which sets the resident threads of an SM: shared memory at C = 1; at
// C = 3 (the RGB scene) the 32 samples around s_hat in registers and the
// rest in shared memory, 8 warps an SM where shared memory alone held 5
// (csrc/sweep_pc.cuh says why 8 is the most).  The launcher picks the block
// size from the occupancy the runtime reports.  The linear
// and the nearest rule are two instantiations of the core (PcRulePixel,
// PcRuleNearest), each with a twin for a window of valid columns other than
// the whole row (PcRulePixelWindow, PcRuleNearestWindow), so that whole
// rows pay nothing for the window.  k_best is the core's export: after a group, one (pixel,
// s) a thread recomputes the winner's sample and its K (consecutive threads
// take consecutive s of one pixel, so their stores lie U floats apart).
// The TPU's 128-lane groups, 8-pixel batches and scalar-core compaction are
// not carried over: the wrapper compacts the active pixels with
// torch.nonzero.

#include "sweep_pc.cuh"

RSLF_DEFINE_ERROR_STRING(rslf_sweep_pixel_error_string)

// The launcher's plan for this size, with or without k_best, under the
// linear or the nearest rule, into out[5]: threads of a block, items of a
// window, bytes of shared memory a block, resident blocks an SM, SMs.
// Returns the CUDA error code (cudaErrorInvalidConfiguration when no block
// size fits).
RSLF_EXPORT int rslf_sweep_pixel_plan(int S, int C, int with_k, int nearest,
                                      int* out) {
  return nearest
             ? rslf_pc::plan_for_c<PcRuleNearest>(S, C, with_k, 0, 0, out)
             : rslf_pc::plan_for_c<PcRulePixel>(S, C, with_k, 0, 0, out);
}

// Launch on `stream`; returns the CUDA error code of the launch.  `bmin` /
// `bmax` (per-pixel bounds), `k_best` and `work_count` may be null;
// `nearest` != 0 takes the nearest rule; [u_lo, u_hi] is the window of valid
// sample columns ([0, U - 1] for whole rows).
RSLF_EXPORT int rslf_sweep_pixel(
    const float* epis, int S, int U, int C, const int* act, int n_act,
    const float* bmin, const float* bmax, float dmin, float dmax, int D,
    int s_hat, float slope, float a_coef, int iters, int nearest, int u_lo,
    int u_hi, float* best_score, float* score_mean, float* best_depth,
    float* rbar, float* k_best, unsigned long long* work_count,
    void* stream) {
  const PcArgs a{epis, S, U, C, act, n_act, bmin, bmax, dmin, dmax,
                 nullptr, nullptr, D, s_hat, slope, a_coef, iters, 0, 0, 0,
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
