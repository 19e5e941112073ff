// Dense row sweep over a uniform candidate grid, with mean-shift scoring.
//
// Replaces the TPU kernel remotesensingproject_tpu/ops/sweep_pallas.py
// `_sweep_kernel` / `_sweep_row_body` (wrapper `sweep_pile_pallas`).
// Plain version: ops/sweep_pallas.py `sweep_rows_plain`; wrapper:
// ops/sweep_pallas.py `sweep_pile_rows`.
//
// What it computes, per pixel (v, u) it is given: for each candidate
// delta = dmin + (d * (dmax - dmin)) / (D - 1) of the uniform grid (one
// value for every pixel), the S samples at u + shift, where
// shift = ((s_hat - s) * delta) * slope is ONE value per (s, d) shared by
// all u: i0 = floor(shift), t = shift - i0, the sample is
// (1 - t) * row[i0 + u] + t * row[i0 + u + 1] (row[i0 + u] where t == 0),
// valid iff -i0 <= u <= U - 1 - (i0 + (t > 0)).  This differs from the
// per-pixel rounding of floor(u + shift) (sweep_pixel.cu) in the last ulp
// of the weight, as the TPU kernel does.  Then the truncated mean shift and
// scoring, the first-max argmax and the score mean over all D candidates,
// and optionally k_best [V, S, U], the winning candidate's kernel values.
//
// Bound on this card: fp32 CUDA-core arithmetic that cannot fuse.  The work
// is pixels x D x valid samples x mean-shift steps x (4C + 5) operations;
// the bytes are one read of the EPI volume and a few floats out per pixel.
//
// Design: a launcher of the (pixel, candidate) core, sweep_pc.cuh, in its
// unmasked mode under the shared-shift position rule (PcRuleRow): every
// candidate of every listed pixel is an item, a thread owns one item at a
// time, a block takes a group of consecutive listed pixels (the TPU
// kernel's per-row and per-128-lane-chunk activity flags become that list,
// so a skipped pixel costs nothing), and one thread per pixel folds the
// scores in candidate order.  What bounds it is the shared memory of the
// staged samples (S x C floats a thread), so the parallelism is found
// inside a thread (batches of samples in flight) and over the D candidates
// of a pixel, not only over pixels: a late pass with a few thousand active
// pixels still fills the card.  A group's slots are laid d * G + p, so that
// a warp's 32 items are 32 neighbouring pixels of one candidate, which under
// this rule read contiguous addresses (on an H100 5% faster than p * D + d,
// 32 neighbouring candidates of one pixel).  The TPU kernel's padded VMEM
// rows, lane-group gathers and manual DMA are not needed.  Any D, any C
// (registers for C <= 4, shared memory beyond).

#include "sweep_pc.cuh"

RSLF_DEFINE_ERROR_STRING(rslf_sweep_rows_error_string)

// The launcher's plan for this size into out[5]: threads of a block, items
// of a window, bytes of shared memory a block, resident blocks an SM, SMs.
// Returns the CUDA error code (cudaErrorInvalidConfiguration when no block
// size fits).
RSLF_EXPORT int rslf_sweep_rows_plan(int S, int C, int with_k, int* out) {
  return rslf_pc::plan_for_c<PcRuleRow>(S, C, with_k, 0, 1, out);
}

// Launch on `stream`; returns the CUDA error code of the launch.  `act`
// holds `cap` entries, of which the first `*count` (device memory, never
// read by the host) list the pixels to sweep.  `k_best` and `work_count`
// may be null.
RSLF_EXPORT int rslf_sweep_rows(const float* epis, int S, int U, int C,
                                const int* act, const int* count, int cap,
                                float dmin, float dmax, int D, int s_hat,
                                float slope, float a_coef, int iters,
                                float* best_score, float* score_mean,
                                float* best_depth, float* rbar, float* k_best,
                                unsigned long long* work_count, void* stream) {
  const PcArgs a{epis, S, U, C, act, count, cap, nullptr, nullptr, dmin, dmax,
                 nullptr, nullptr, D, s_hat, slope, a_coef, iters, 0,
                 /*by_pixel=*/1, /*u_lo, u_hi (not read)=*/0, U - 1,
                 SweepOut{best_score, score_mean, best_depth, rbar, k_best,
                          work_count}};
  return rslf_pc::launch_for_c<PcRuleRow>(a, (cudaStream_t)stream);
}
