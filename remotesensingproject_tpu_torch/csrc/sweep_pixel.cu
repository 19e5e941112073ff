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
// Bound on this card: fp32 CUDA-core arithmetic that cannot fuse.  The work
// is active px x D x valid samples x mean-shift steps x (4C + 5) operations;
// the bytes are one read of the EPI rows and a few floats out per pixel.
//
// Design: a launcher of the (pixel, candidate) core, sweep_pc.cuh, in its
// unmasked mode: every candidate of every listed pixel is an item, a thread
// owns one item at a time, blocks take groups of consecutive pixels, and
// one thread per pixel folds the scores in candidate order.  What bounds it
// is the shared memory that holds each thread's staged samples (S x C
// floats a thread), which sets the resident threads of an SM; the launcher
// picks the block size from the occupancy the runtime reports.  The TPU's
// 128-lane groups, 8-pixel batches and scalar-core compaction are not
// carried over: the wrapper compacts the active pixels with torch.nonzero.

#include "sweep_pc.cuh"

RSLF_DEFINE_ERROR_STRING(rslf_sweep_pixel_error_string)

// The launcher's plan for this size into out[5]: threads of a block, items
// of a window, bytes of shared memory a block, resident blocks an SM, SMs.
// Returns the CUDA error code (cudaErrorInvalidConfiguration when no block
// size fits).
RSLF_EXPORT int rslf_sweep_pixel_plan(int S, int C, int* out) {
  return rslf_pc::plan_for_c<PcRulePixel>(S, C, 0, 0, 0, out);
}

// Launch on `stream`; returns the CUDA error code of the launch.  `bmin` /
// `bmax` (per-pixel bounds) and `work_count` may be null.
RSLF_EXPORT int rslf_sweep_pixel(
    const float* epis, int S, int U, int C, const int* act, int n_act,
    const float* bmin, const float* bmax, float dmin, float dmax, int D,
    int s_hat, float slope, float a_coef, int iters,
    float* best_score, float* score_mean, float* best_depth, float* rbar,
    unsigned long long* work_count, void* stream) {
  const PcArgs a{epis, S, U, C, act, n_act, bmin, bmax, dmin, dmax,
                 nullptr, nullptr, D, s_hat, slope, a_coef, iters, 0, 0, 0,
                 SweepOut{best_score, score_mean, best_depth, rbar, nullptr,
                          work_count}};
  return rslf_pc::launch_for_c<PcRulePixel>(a, (cudaStream_t)stream);
}
