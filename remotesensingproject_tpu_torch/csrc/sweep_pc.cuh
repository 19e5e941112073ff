// The (pixel, candidate) core of the pixel sweep (sweep_pixel.cu), the tile
// sweep (sweep_tiles.cu) and the row sweep (sweep_rows.cu).
//
// What it computes, per pixel (v, u) of a compacted list: for each candidate
// delta = lo + (d * rng) / (D - 1) of the pixel's grid [lo, lo + rng] (the
// level's uniform bounds or the pixel's own), the S samples at the positions
// of the launcher's position rule (a compile-time parameter):
//   * per pixel (PcRulePixel): I = u + ((s_hat - s) * delta) * slope,
//     (1 - t) * row[floor(I)] + t * row[ceil(I)], valid iff floor(I) >= 0
//     and ceil(I) <= U - 1; in a window [lo, hi] of valid columns other
//     than [0, U - 1] (PcRulePixelWindow) I = (u - lo) + ..., valid iff
//     floor(I) >= 0 and ceil(I) <= hi - lo, columns lo + floor(I) and
//     lo + ceil(I) read, clamped to [0, U - 1]: a u-sharded caller sweeps
//     a block haloed in u and passes the image's columns in the block's
//     coordinates, so its positions are the whole image's bit for bit;
//   * shared shift (PcRuleRow): shift = ((s_hat - s) * delta) * slope is one
//     value for every u, i0 = floor(shift), t = shift - i0, the sample is
//     (1 - t) * row[i0 + u] + t * row[i0 + u + 1], valid iff
//     -i0 <= u <= U - 1 - (i0 + (t > 0)); it differs from the first rule in
//     the last ulp of the weight;
//   * nearest (PcRuleNearest, interpolation="nearest"): I as per pixel,
//     r = round_half_away(I), the one sample row[r], valid iff
//     0 <= r <= U - 1, or in a window (PcRuleNearestWindow) row[lo + r]
//     clamped, valid iff 0 <= r <= hi - lo (the plain version's
//     `_radiances` nearest branch);
// then the truncated mean shift from the pixel's s_hat colour; the score
// sum_s K / card_R with the kernel values of the last step; over the
// candidates the first-max argmax and the score sum in candidate order;
// optionally k_best, the winner's kernel values.  In the masked mode (allowed ranges given) a
// candidate outside [pmin - step, pmax + step], step = rng / (D - 1), can
// neither win nor count in the mean, which is (sum * D / max(n_allowed, 1))
// / D.  Every sum over s is sequential from s = 0 and every comparison is
// the plain version's (ops/sweep.py `sweep_pile`; under the shared-shift
// rule ops/sweep_pallas.py `sweep_rows_plain`), so the result is its result
// bit for bit (with -fmad=false and IEEE division).
//
// Bound on this card: fp32 CUDA-core arithmetic that cannot fuse (valid
// samples x mean-shift steps x (4C + 5) operations); the mean shift is a
// nonlinear weight inside a loop on its own last result, so the tensor
// cores have no part.  What limits the layout is where a thread keeps the
// S x C samples of its item across the mean-shift steps (400 bytes at
// S = 100, C = 1; 1,200 at C = 3; 1,600 at C = 4), which sets the warps an
// SM holds, so the inner loop must find its parallelism inside a thread.
// In shared memory alone an SM holds 16 warps at C = 1, 5 at C = 3 and 4 at
// C = 4.  At C = 3 a thread holds 32 samples in registers and the rest in
// shared memory, and an SM holds 8 warps (128-thread blocks, 2 an SM; 255
// registers a thread).  8 is the most: a third warp on one of the SM's four
// register sub-partitions (16,384 registers each) leaves a thread 168
// registers, and 9 warps' runs do not fit in those beside the working
// registers and in 228 KB of shared memory (on an H100, capping the
// registers with __maxnreg__ only spilled).  Other C keep their run in
// shared memory: at C = 4 the registers measured slower, and C = 1 needs
// none.
//
// Design.  A thread owns one (pixel, candidate) item at a time.  A block
// takes a group of G consecutive entries of the pixel list; their G x D
// (pixel, candidate) slots are walked in order in windows: each window
// evaluates the allowed flag of the next slots and compacts the allowed ones
// into a list in shared memory (warp ballots and a prefix over the warps),
// until the list holds `ncap` items or the group ends.  Warps then draw 32
// neighbouring items at a time from the list.  Slot p * D + d makes them
// neighbouring candidates of one pixel (their sample runs, their mean-shift
// lengths and their addresses are alike); the unmasked mode can also lay the
// slots d * G + p (`by_pixel`), which makes them neighbouring pixels of one
// candidate: under the shared-shift rule those read contiguous addresses.
// An item's thread
//   * stages its samples in batches: the positions of a batch, then all its
//     loads (through the read-only path, branch-free; the ceil column is
//     read only where it differs from the floor column), then the
//     interpolation, so that many loads are in flight; it notes the run
//     [s_a, s_b] of valid samples: the position (under every rule) is
//     monotone in s, so the valid samples are one run.  Where the
//     instantiation holds R samples in registers (rslf_pc_regs), those are
//     the R around s_hat (valid for the most candidates), staged after the
//     others (so that the registers fill only then) and set to FLT_MAX where
//     invalid, which makes their K and their numerator term exact zeros;
//     the other samples sit in the thread's column of shared memory;
//   * runs the mean shift over that run only, in s order (the column's
//     samples before the register segment, the segment's batches that meet
//     the run, the column's samples after it), with no validity test, each
//     staged word read once a step, in batches whose K are independent
//     while the adds to the sums keep their order; a fixed point of r_bar
//     ends it, since later steps repeat the last one;
//   * leaves its score and r_bar in the item's slot of shared memory.
// For C = 1 to 4 a column is packed into 16-byte slots laid [slot][thread],
// so a batch is a few conflict-free 16-byte accesses; the batches start at
// a slot (at C = 3 every fourth sample).  Each C <= 4 has its own
// instantiation with the channel vectors in registers and no test in a
// channel loop; any other C keeps them in shared memory, its samples laid
// [word][thread].
// After a window one thread per pixel folds its pixel's items, in candidate
// order, into the pixel's running best, score sum and allowed count, so a
// pixel may span windows and D is not limited.  At the end of the group the
// same threads write the outputs, and, if k_best is asked for, all threads
// recompute the winner's samples, one (pixel, s) each, and its kernel values
// from the r_bar its last step started with.
//
// The launcher chooses the block size from the occupancy the runtime
// reports for this build (the most resident threads an SM holds), once per
// kernel and size, and G from the number of pixels and resident blocks.
// The per-instantiation choices below (rslf_pc_regs, rslf_pc_um,
// rslf_pc_us) are the ones measured fastest on an H100;
// scripts/torch_pc_designs.py builds and times others.
#pragma once

#include <cfloat>
#include <mutex>

#include "common.cuh"

// Internal linkage: the pixel, the tile and the row sweep are three
// libraries that all hold this core, and each must launch and configure its
// own copy.
namespace {

// Output pointers of one sweep launch.
struct SweepOut {
  float* best_score;   // [V, U]
  float* score_mean;   // [V, U]
  float* best_depth;   // [V, U]
  float* rbar;         // [V, U, C]
  float* k_best;       // [V, S, U] or null
  unsigned long long* work_count;  // or null
};

// One thread's channel vector in a column of shared memory, element c at
// col[c * stride] (any C; for C <= 4 the vectors sit in registers).
struct ChanCol {
  float* col;
  int stride;
  __device__ __forceinline__ float& operator[](int c) const {
    return col[c * stride];
  }
};

// Inputs, outputs and constants of one launch.
struct PcArgs {
  const float* epis;  // [V, S, U, C]
  int S, U, C;
  const int* act;     // [n_act] flat pixel indices v * U + u
  int n_act;
  const float* bmin;  // [V, U] grid bounds, or null for the uniform ones
  const float* bmax;
  float dmin, dmax;   // the uniform grid bounds
  const float* pmin;  // [V, U] allowed ranges (the masked mode), or null
  const float* pmax;
  int D, s_hat;
  float slope, a_coef;
  int iters;
  int G;              // pixels of a group
  int ncap;           // items of a window's list
  int by_pixel;       // slots laid d * G + p (unmasked mode only)
  int u_lo, u_hi;     // the window of valid sample columns (not PcRuleRow)
  SweepOut out;
};

// The most pixels a group may hold.  In the masked mode a pixel has few
// items, and a larger group fills the windows' lists better; with the slots
// laid by pixel a warp's 32 items want 32 pixels of one candidate (measured
// on an H100: 32 beats both 16 and 64 there).
__host__ __device__ inline int rslf_pc_gmax(bool masked, bool by_pixel) {
  return masked ? 64 : (by_pixel ? 32 : 16);
}

// Items of a window's list for each thread of the block.
#define RSLF_PC_WINDOW 4

// Samples of an item's run that its thread holds in registers, per channel
// instantiation (a multiple of the batches, rslf_pc_um and rslf_pc_us; 0:
// the whole run sits in shared memory, as for the `any C` one, maxc = 0).
__host__ __device__ constexpr int rslf_pc_regs(int maxc) {
  return maxc == 3 ? 32 : 0;
}

// Samples a thread keeps in flight: rslf_pc_um in the mean-shift loop,
// rslf_pc_us while staging (each staged sample is up to 2 C loads).  Both
// times NC are multiples of 4, the words of a slot.  The mean-shift batch is
// 4 at C = 3, where the register segment leaves few registers (on an H100
// 5% faster than 8 there, 10% slower at C = 1).
__host__ __device__ constexpr int rslf_pc_um(int nc) { return nc == 3 ? 4 : 8; }
__host__ __device__ constexpr int rslf_pc_us(int nc) {
  return nc == 1 ? 16 : 4;
}

// Words of one thread's column of staged samples (see PcCol): the samples
// outside the register segment, in whole 16-byte slots.
__host__ __device__ inline int rslf_pc_col_words(int S, int C, int maxc) {
  const bool packed = maxc == 1 || maxc == 2 || maxc == 3 || maxc == 4;
  const int R = rslf_pc_regs(maxc);
  if (R > 0) S = S > R ? S - R : 0;
  return packed ? (S * C + 3) / 4 * 4 : S * C;
}

// Offsets (in 4-byte words) of a block's shared memory.
struct PcLayout {
  int chan, list, score, irb, irbp, px, prb, prbp, misc, total;
};

// Per-pixel state planes of G words each: pix, lo, rng, plo, phi, best,
// sum, best_d, n_allowed.
#define RSLF_PC_PX_PLANES 9

__host__ __device__ inline PcLayout rslf_pc_layout(int S, int C, int T,
                                                   int maxc, int ncap, int G,
                                                   bool with_k) {
  PcLayout l;
  l.chan = rslf_pc_col_words(S, C, maxc) * T;
  l.list = l.chan + (maxc == 0 ? 3 * C * T : 0);
  l.score = l.list + ncap;
  l.irb = l.score + ncap;
  l.irbp = l.irb + ncap * C;
  l.px = l.irbp + (with_k ? ncap * C : 0);
  l.prb = l.px + RSLF_PC_PX_PLANES * G;
  l.prbp = l.prb + G * C;
  l.misc = l.prbp + (with_k ? G * C : 0);
  l.total = l.misc + 32 + 4;  // warp counts, the draw counter
  return l;
}

// Position of a sample at `ds` = s_hat - s rows from the reference row:
// weight t, column i0 of the floor sample (0 where the sample is invalid),
// up = the sample also reads column i0 + 1, ok = valid.
struct PcPos {
  float t;
  int i0;
  bool up, ok;
};

// The per-pixel rule on whole rows: I = u + (ds * delta) * slope.  With
// ceil(I) = floor(I) + (I > floor(I)), floor(I) >= 0 is I >= 0 and
// ceil(I) <= U - 1 is I <= U - 1, exactly.  (lo, hi are 0 and U - 1 and
// are not read: the launchers take PcRulePixelWindow for another window.)
struct PcRulePixel {
  static __device__ __forceinline__ PcPos pos(float ds, int u, int U, int,
                                              int, float delta,
                                              float slope) {
    const float idx = (float)u + (ds * delta) * slope;
    const float fi = floorf(idx);
    PcPos p;
    p.t = idx - fi;
    p.ok = (idx >= 0.f) && (idx <= (float)(U - 1));
    p.up = p.ok && (p.t > 0.f);
    p.i0 = p.ok ? (int)fi : 0;
    return p;
  }
};

// The per-pixel rule in a window [lo, hi] of valid columns other than
// [0, U - 1] (a u-haloed block): I = (u - lo) + (ds * delta) * slope, the
// position in the window's columns, valid iff 0 <= I <= hi - lo (floor and
// ceil tests, exactly, as in PcRulePixel).  The columns read are
// lo + floor(I) and lo + ceil(I) clamped to [0, U - 1], as the plain
// version gathers them: where the clamp makes them one column, the ceil
// sample is the floor one.  Under the window [0, U - 1] it gives
// PcRulePixel's samples; it is a rule of its own so that whole rows keep
// that rule's code.
struct PcRulePixelWindow {
  static __device__ __forceinline__ PcPos pos(float ds, int u, int U, int lo,
                                              int hi, float delta,
                                              float slope) {
    const float idx = (float)(u - lo) + (ds * delta) * slope;
    const float fi = floorf(idx);
    const float fc = fi + (float)lo;  // the floor column, exact
    PcPos p;
    p.t = idx - fi;
    p.ok = (idx >= 0.f) && (idx <= (float)(hi - lo));
    p.up = p.ok && (p.t > 0.f) && (fc >= 0.f) && (fc <= (float)(U - 2));
    p.i0 = p.ok ? min(max((int)fc, 0), U - 1) : 0;
    return p;
  }
};

// The shared-shift rule of the row sweep: shift = (ds * delta) * slope for
// every u, columns floor(shift) + u and one more where t > 0, valid iff
// -floor(shift) <= u <= U - 1 - (floor(shift) + (t > 0)).  The comparisons
// are made on floats (exact for the integers of an image row), so a shift
// beyond the int range is invalid and never converted.  It takes no window
// (lo, hi are not read): the row sweep runs on whole rows only.
struct PcRuleRow {
  static __device__ __forceinline__ PcPos pos(float ds, int u, int U, int,
                                              int, float delta,
                                              float slope) {
    const float shift = (ds * delta) * slope;
    const float f0 = floorf(shift);
    PcPos p;
    p.t = shift - f0;
    const float fu = (float)u;
    const float top = f0 + (p.t > 0.f ? 1.f : 0.f);
    p.ok = (fu >= -f0) && (fu <= (float)(U - 1) - top);
    p.up = p.ok && (p.t > 0.f);
    p.i0 = p.ok ? (int)f0 + u : 0;
    return p;
  }
};

// The nearest rule on whole rows: I = u + (ds * delta) * slope as in
// PcRulePixel, the column r = sign(I) * floor(|I| + 0.5), valid iff
// 0 <= r <= U - 1.  With t = 0 and up = false an item's (1 - t) * a + t * b
// is a and the ceil column is never read, so staging, mean shift, scores
// and k_best need nothing else.  r is monotone in s like I, so the valid
// samples stay one run.  The comparisons are made on floats, so a column
// beyond the int range is invalid and never converted.
struct PcRuleNearest {
  static __device__ __forceinline__ PcPos pos(float ds, int u, int U, int,
                                              int, float delta,
                                              float slope) {
    const float idx = (float)u + (ds * delta) * slope;
    const float r = rslf_round_half_away(idx);
    PcPos p;
    p.t = 0.f;
    p.ok = (r >= 0.f) && (r <= (float)(U - 1));
    p.up = false;
    p.i0 = p.ok ? (int)r : 0;
    return p;
  }
};

// The nearest rule in a window [lo, hi]: I = (u - lo) + (ds * delta) *
// slope as in PcRulePixelWindow, r = sign(I) * floor(|I| + 0.5), valid iff
// 0 <= r <= hi - lo, read at column lo + r clamped to [0, U - 1].
struct PcRuleNearestWindow {
  static __device__ __forceinline__ PcPos pos(float ds, int u, int U, int lo,
                                              int hi, float delta,
                                              float slope) {
    const float idx = (float)(u - lo) + (ds * delta) * slope;
    const float r = rslf_round_half_away(idx) + (float)lo;  // exact
    PcPos p;
    p.t = 0.f;
    p.ok = (r >= (float)lo) && (r <= (float)hi);
    p.up = false;
    p.i0 = p.ok ? min(max((int)r, 0), U - 1) : 0;
    return p;
  }
};

// A thread's column of staged samples.  For C = 1 to 4 the words i * C + c
// of a column (i the sample's place in the column) are packed four to a
// 16-byte slot, slot q of thread tid at word (q * T + tid) * 4, so that a
// warp reads or writes whole slots without bank conflicts and a batch of
// samples is a few 16-byte accesses.  (The `any C` instantiation keeps its
// samples in a layout of its own, word i of thread tid at i * T + tid.)
template <int NC>
struct PcCol {
  static constexpr bool kPacked = NC == 1 || NC == 2 || NC == 3 || NC == 4;
  // a batch of samples starts at a place i with (i * NC) % 4 == 0: a slot
  static constexpr int kAlign = !kPacked ? 1 : (NC == 3 ? 4 : 4 / NC);
  float* base;  // the thread's first word
  int T;
  __device__ __forceinline__ PcCol(float* smem, int tid, int threads)
      : base(smem + (kPacked ? 4 * tid : tid)), T(threads) {}
  __device__ __forceinline__ float& word(int i) const {
    return kPacked ? base[(i >> 2) * 4 * T + (i & 3)] : base[i * T];
  }
  // words i .. i + N - 1 (packed: i and N multiples of 4)
  template <int N>
  __device__ __forceinline__ void load(int i, float (&x)[N]) const {
    if constexpr (kPacked && N % 4 == 0) {
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 f =
            *reinterpret_cast<const float4*>(base + ((i >> 2) + q) * 4 * T);
        x[4 * q] = f.x, x[4 * q + 1] = f.y, x[4 * q + 2] = f.z,
               x[4 * q + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) x[n] = word(i + n);
    }
  }
  template <int N>
  __device__ __forceinline__ void store(int i, const float (&x)[N]) const {
    if constexpr (kPacked && N % 4 == 0) {
#pragma unroll
      for (int q = 0; q < N / 4; ++q)
        *reinterpret_cast<float4*>(base + ((i >> 2) + q) * 4 * T) =
            make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) word(i + n) = x[n];
    }
  }
};

// Gathers samples s .. s + UN - 1 of one item into x: all positions, then
// all loads, then the interpolation, so that up to 2 * UN * NC loads are in
// flight at once.  `rs` points at row s of the pixel's EPI.  The ceil column
// is read only where it differs from the floor column; elsewhere its weight
// is 0 and the floor value stands in.  `vec` reads the 4 channels of a
// column as one 16-byte word (NC == 4, aligned volume).  ok[j]: sample
// s + j is valid, and [s_a, s_b] grows to take it in.  With kGuard (the
// register segment, gathered after the column's samples) a sample at or
// beyond row S is invalid and reads row S - 1, and s_b only grows.
template <typename Rule, int NC, int UN, bool kGuard>
__device__ __forceinline__ void rslf_pc_gather(
    const float* rs, int s, int S, float ds, int u, int U, int lo, int hi,
    float delta, float slope, bool vec, float (&x)[UN * NC], bool (&ok)[UN],
    int& s_a, int& s_b) {
  PcPos q[UN];
  int rj[UN];  // the row read for sample s + j, counted from row s
  float xa[UN][NC], xb[UN][NC];
#pragma unroll
  for (int j = 0; j < UN; ++j) {
    q[j] = Rule::pos(ds - (float)j, u, U, lo, hi, delta, slope);
    rj[j] = j;
    if (kGuard && s + j >= S) {
      q[j].ok = q[j].up = false;
      q[j].i0 = 0;
      rj[j] = S - 1 - s;
    }
  }
  if (NC == 4 && vec) {
#pragma unroll
    for (int j = 0; j < UN; ++j) {
      const float4* r4 =
          reinterpret_cast<const float4*>(rs) + (rj[j] * U + q[j].i0);
      const float4 va = __ldg(r4);
      const float4 vb = q[j].up ? __ldg(r4 + 1) : va;
      xa[j][0] = va.x, xa[j][1 % NC] = va.y, xa[j][2 % NC] = va.z,
      xa[j][3 % NC] = va.w;
      xb[j][0] = vb.x, xb[j][1 % NC] = vb.y, xb[j][2 % NC] = vb.z,
      xb[j][3 % NC] = vb.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < UN; ++j) {
      const float* ra = rs + (rj[j] * U + q[j].i0) * NC;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        xa[j][c] = __ldg(ra + c);
        xb[j][c] = q[j].up ? __ldg(ra + NC + c) : xa[j][c];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < UN; ++j) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      x[j * NC + c] = (1.f - q[j].t) * xa[j][c] + q[j].t * xb[j][c];
    ok[j] = q[j].ok;
    if (q[j].ok) {
      s_a = min(s_a, s + j);
      s_b = kGuard ? max(s_b, s + j) : s + j;
    }
  }
}

// Stages samples [s, end) of one item at places s - off .. of its column,
// in batches of rslf_pc_us (a batch's first place starts a slot), then
// one at a time.
template <typename Rule, int NC>
__device__ __forceinline__ void rslf_pc_stage(const PcArgs& a,
                                              const float* row, int u,
                                              float delta,
                                              const PcCol<NC>& col, bool vec,
                                              int s, int end, int off,
                                              int& s_a, int& s_b) {
  constexpr int US = rslf_pc_us(NC);
  const int U = a.U;
  const float fsh = (float)a.s_hat;
  const float* rs = row + (size_t)s * U * NC;
  for (; s + US <= end; s += US, rs += US * U * NC) {
    float x[US * NC];
    bool ok[US];
    rslf_pc_gather<Rule, NC, US, false>(rs, s, 0, fsh - (float)s, u, U,
                                        a.u_lo, a.u_hi, delta, a.slope, vec,
                                        x, ok, s_a, s_b);
    col.store((s - off) * NC, x);
  }
  for (; s < end; ++s, rs += U * NC) {
    float x[NC];
    bool ok[1];
    rslf_pc_gather<Rule, NC, 1, false>(rs, s, 0, fsh - (float)s, u, U,
                                       a.u_lo, a.u_hi, delta, a.slope, vec,
                                       x, ok, s_a, s_b);
    col.store((s - off) * NC, x);
  }
}

// One mean-shift step over UN samples x[j * NC + c]: all K, then the sums
// in s order.
template <int NC, int UN>
__device__ __forceinline__ void rslf_pc_ms_vals(const float* x, float a_coef,
                                                const float (&rb)[NC],
                                                float& sk, float (&srk)[NC]) {
  float k[UN];
#pragma unroll
  for (int j = 0; j < UN; ++j) {
    float dsq = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float diff = x[j * NC + c] - rb[c];
      const float d2 = diff * diff;
      dsq = (c == 0) ? d2 : dsq + d2;
    }
    k[j] = fmaxf(1.f - a_coef * dsq, 0.f);
  }
#pragma unroll
  for (int j = 0; j < UN; ++j) {
    sk = sk + k[j];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      srk[c] = srk[c] + fmaxf(x[j * NC + c], 0.f) * k[j];
  }
}

// The same over the samples at places [i, end) of the column: one at a
// time up to the first place that starts a slot, then batches of
// rslf_pc_um loaded together, then one at a time.
template <int NC>
__device__ __forceinline__ void rslf_pc_ms(const PcCol<NC>& col, int i,
                                           int end, float a_coef,
                                           const float (&rb)[NC], float& sk,
                                           float (&srk)[NC]) {
  constexpr int UM = rslf_pc_um(NC);
  constexpr int kAlign = PcCol<NC>::kAlign;
  const int i_al = min(end, (i + kAlign - 1) / kAlign * kAlign);
  float x[UM * NC], x1[NC];
  for (; i < i_al; ++i) {
    col.load(i * NC, x1);
    rslf_pc_ms_vals<NC, 1>(x1, a_coef, rb, sk, srk);
  }
  for (; i + UM <= end; i += UM) {
    col.load(i * NC, x);
    rslf_pc_ms_vals<NC, UM>(x, a_coef, rb, sk, srk);
  }
  for (; i < end; ++i) {
    col.load(i * NC, x1);
    rslf_pc_ms_vals<NC, 1>(x1, a_coef, rb, sk, srk);
  }
}

// One item with NC channels in registers: stages the samples of candidate
// `delta` of pixel (row, u), runs the mean shift, and leaves the score, the
// final r_bar and (if `o_rbp`) the r_bar the last step started with.
// Returns valid samples x steps run.
template <typename Rule, int NC>
__device__ __forceinline__ unsigned long long rslf_pc_item(
    const PcArgs& a, const float* row, int u, float delta,
    const PcCol<NC>& col, bool vec, float* o_score, float* o_rb,
    float* o_rbp) {
  static_assert((rslf_pc_us(NC) * NC) % 4 == 0 &&
                    (rslf_pc_um(NC) * NC) % 4 == 0,
                "whole slots");
  const int S = a.S, U = a.U;
  // stage the samples; [s_a, s_b] is the run of valid ones
  int s_a = S, s_b = -1;
  rslf_pc_stage<Rule, NC>(a, row, u, delta, col, vec, 0, S, 0, s_a, s_b);
  const int card = (s_b >= s_a) ? s_b - s_a + 1 : 0;

  float rb[NC], rbp[NC], srk[NC];
  const float* r0 = row + ((size_t)a.s_hat * U + u) * NC;
#pragma unroll
  for (int c = 0; c < NC; ++c) rb[c] = __ldg(r0 + c);
  // truncated mean shift; a fixed point of r_bar ends it, since every later
  // step would repeat the last one bit for bit
  float sum_k = 0.f;
  int it = 0;
  while (it < a.iters) {
    ++it;
    float sk = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      rbp[c] = rb[c];
      srk[c] = 0.f;
    }
    rslf_pc_ms<NC>(col, s_a, s_b + 1, a.a_coef, rb, sk, srk);
    bool same = true;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float nr = (sk > 0.f) ? srk[c] / sk : 0.f;
      same = same && (nr == rb[c]);
      rb[c] = nr;
    }
    sum_k = sk;
    if (same) break;
  }
  *o_score = (card > 0) ? sum_k / (float)card : 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    o_rb[c] = rb[c];
    if (o_rbp != nullptr) o_rbp[c] = rbp[c];
  }
  return (unsigned long long)it * (unsigned long long)card;
}

// rslf_pc_item for an instantiation that holds R = rslf_pc_regs(NC) > 0
// samples in registers: the R around s_hat (valid for the most candidates),
// from r0; the column holds samples [0, r0) at place s and [r0 + R, S) at
// place s - R.  The results are rslf_pc_item's bit for bit: the sums run
// over the valid run in s order, and a register sample outside it reads
// FLT_MAX, whose K and numerator term are exact zeros.  It is an item of
// its own, not a branch of rslf_pc_item: a shared item made C = 1 up to 4%
// slower on an H100.
template <typename Rule, int NC>
__device__ __forceinline__ unsigned long long rslf_pc_item_regs(
    const PcArgs& a, const float* row, int u, float delta,
    const PcCol<NC>& col, bool vec, float* o_score, float* o_rb,
    float* o_rbp) {
  constexpr int US = rslf_pc_us(NC);
  constexpr int UM = rslf_pc_um(NC);
  constexpr int R = rslf_pc_regs(NC);
  static_assert((US * NC) % 4 == 0 && (UM * NC) % 4 == 0, "whole slots");
  static_assert(R % US == 0 && R % UM == 0, "whole batches in registers");
  const int S = a.S, U = a.U;
  // r0 a multiple of 4: the column's places after the segment start at a
  // slot
  const int r0 = max(0, min(a.s_hat - R / 2, S - R)) & ~3;
  // stage the column's samples in s order, then the segment's (so that the
  // registers fill only then); [s_a, s_b] is the run of valid ones
  int s_a = S, s_b = -1;
  float xr[R * NC];
  rslf_pc_stage<Rule, NC>(a, row, u, delta, col, vec, 0, r0, 0, s_a, s_b);
  rslf_pc_stage<Rule, NC>(a, row, u, delta, col, vec, r0 + R, S, R, s_a,
                          s_b);
  {
    const float fsh = (float)a.s_hat;
#pragma unroll
    for (int b = 0; b < R; b += US) {
      float x[US * NC];
      bool ok[US];
      rslf_pc_gather<Rule, NC, US, true>(
          row + (size_t)(r0 + b) * U * NC, r0 + b, S, fsh - (float)(r0 + b),
          u, U, a.u_lo, a.u_hi, delta, a.slope, vec, x, ok, s_a, s_b);
#pragma unroll
      for (int j = 0; j < US; ++j)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          xr[(b + j) * NC + c] = ok[j] ? x[j * NC + c] : FLT_MAX;
    }
  }
  const int card = (s_b >= s_a) ? s_b - s_a + 1 : 0;

  float rb[NC], rbp[NC], srk[NC];
  const float* rh = row + ((size_t)a.s_hat * U + u) * NC;
#pragma unroll
  for (int c = 0; c < NC; ++c) rb[c] = __ldg(rh + c);
  // truncated mean shift over the run in s order: the column's samples
  // before the segment, the segment's batches that meet the run, the
  // column's samples after it; a fixed point of r_bar ends it
  float sum_k = 0.f;
  int it = 0;
  while (it < a.iters) {
    ++it;
    float sk = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      rbp[c] = rb[c];
      srk[c] = 0.f;
    }
    rslf_pc_ms<NC>(col, s_a, min(s_b + 1, r0), a.a_coef, rb, sk, srk);
#pragma unroll
    for (int b = 0; b < R; b += UM)
      if (r0 + b + UM > s_a && r0 + b <= s_b)
        rslf_pc_ms_vals<NC, UM>(xr + b * NC, a.a_coef, rb, sk, srk);
    rslf_pc_ms<NC>(col, max(s_a, r0 + R) - R, s_b + 1 - R, a.a_coef, rb, sk,
                   srk);
    bool same = true;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float nr = (sk > 0.f) ? srk[c] / sk : 0.f;
      same = same && (nr == rb[c]);
      rb[c] = nr;
    }
    sum_k = sk;
    if (same) break;
  }
  *o_score = (card > 0) ? sum_k / (float)card : 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    o_rb[c] = rb[c];
    if (o_rbp != nullptr) o_rbp[c] = rbp[c];
  }
  return (unsigned long long)it * (unsigned long long)card;
}

// One item with any C: the channel vectors sit in the thread's columns of
// shared memory (`smem` is the block's, `tid` the thread).
template <typename Rule>
__device__ __forceinline__ unsigned long long rslf_pc_item_any(
    const PcArgs& a, const float* row, int u, float delta, float* smem,
    int tid, int T, float* o_score, float* o_rb, float* o_rbp) {
  const int S = a.S, U = a.U, C = a.C;
  float* samp = smem + tid;
  // the thread's three channel vectors, behind the block's samples
  float* chan = smem + (size_t)S * C * T + tid;
  const ChanCol rb{chan, T}, rbp{chan + (size_t)C * T, T},
      srk{chan + 2 * (size_t)C * T, T};
  int s_a = S, s_b = -1;
  for (int s = 0; s < S; ++s) {
    const PcPos q = Rule::pos((float)(a.s_hat - s), u, U, a.u_lo, a.u_hi,
                              delta, a.slope);
    const float* ra = row + ((size_t)s * U + q.i0) * C;
    const float* rc = ra + (q.up ? C : 0);
    for (int c = 0; c < C; ++c)
      samp[(s * C + c) * T] = (1.f - q.t) * __ldg(ra + c) + q.t * __ldg(rc + c);
    if (q.ok) {
      s_a = min(s_a, s);
      s_b = s;
    }
  }
  const int card = (s_b >= s_a) ? s_b - s_a + 1 : 0;
  const float* r0 = row + ((size_t)a.s_hat * U + u) * C;
  for (int c = 0; c < C; ++c) rb[c] = __ldg(r0 + c);
  float sum_k = 0.f;
  int it = 0;
  while (it < a.iters) {
    ++it;
    float sk = 0.f;
    for (int c = 0; c < C; ++c) {
      rbp[c] = rb[c];
      srk[c] = 0.f;
    }
    for (int s = s_a; s <= s_b; ++s) {
      const float* x = samp + s * C * T;
      float dsq = 0.f;
      for (int c = 0; c < C; ++c) {
        const float diff = x[c * T] - rb[c];
        const float d2 = diff * diff;
        dsq = (c == 0) ? d2 : dsq + d2;
      }
      const float k = fmaxf(1.f - a.a_coef * dsq, 0.f);
      sk = sk + k;
      for (int c = 0; c < C; ++c) srk[c] = srk[c] + fmaxf(x[c * T], 0.f) * k;
    }
    bool same = true;
    for (int c = 0; c < C; ++c) {
      const float nr = (sk > 0.f) ? srk[c] / sk : 0.f;
      same = same && (nr == rb[c]);
      rb[c] = nr;
    }
    sum_k = sk;
    if (same) break;
  }
  *o_score = (card > 0) ? sum_k / (float)card : 0.f;
  for (int c = 0; c < C; ++c) {
    o_rb[c] = rb[c];
    if (o_rbp != nullptr) o_rbp[c] = rbp[c];
  }
  return (unsigned long long)it * (unsigned long long)card;
}

template <int MAXC, typename Rule>
__global__ void sweep_pc_kernel(const PcArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  // MAXC > 0 is the exact channel count, so every channel loop unrolls
  // with no test; MAXC == 0 takes any C, its vectors in shared memory
  const int C = MAXC > 0 ? MAXC : a.C;
  const int S = a.S, U = a.U, D = a.D;
  const bool masked = a.pmin != nullptr;
  const bool with_k = a.out.k_best != nullptr;
  const PcLayout L =
      rslf_pc_layout(S, C, T, MAXC, a.ncap, a.G, with_k);
  // the block's samples come first: [S][C][T], a column a thread; then, for
  // MAXC == 0, the threads' channel vectors
  const bool vec = (reinterpret_cast<size_t>(a.epis) & 15) == 0;
  const PcCol<MAXC> col(smem, tid, T);
  // slot p * D + d, or d * gp + p with the slots laid by pixel
  int* list = reinterpret_cast<int*>(smem + L.list);
  const bool by_pixel = a.by_pixel != 0;
  float* it_score = smem + L.score;
  float* it_rb = smem + L.irb;
  float* it_rbp = smem + L.irbp;
  int* px_pix = reinterpret_cast<int*>(smem + L.px);
  float* px_lo = smem + L.px + a.G;
  float* px_rng = smem + L.px + 2 * a.G;
  float* px_plo = smem + L.px + 3 * a.G;
  float* px_phi = smem + L.px + 4 * a.G;
  float* px_best = smem + L.px + 5 * a.G;
  float* px_sum = smem + L.px + 6 * a.G;
  int* px_bd = reinterpret_cast<int*>(smem + L.px + 7 * a.G);
  int* px_nal = reinterpret_cast<int*>(smem + L.px + 8 * a.G);
  float* px_rb = smem + L.prb;
  float* px_rbp = smem + L.prbp;
  int* wcnt = reinterpret_cast<int*>(smem + L.misc);
  int* draw = wcnt + 32;
  const float den = (float)(D - 1);
  // valid samples x mean-shift steps this thread ran (the work count)
  unsigned long long work = 0ULL;

  for (int g = blockIdx.x; g * a.G < a.n_act; g += gridDim.x) {
    const int p0 = g * a.G;
    const int gp = min(a.G, a.n_act - p0);
    for (int p = tid; p < gp; p += T) {
      const int pix = a.act[p0 + p];
      float lo = a.dmin, hi = a.dmax;
      if (a.bmin != nullptr) {
        lo = a.bmin[pix];
        hi = a.bmax[pix];
      }
      const float rng = hi - lo;
      px_pix[p] = pix;
      px_lo[p] = lo;
      px_rng[p] = rng;
      if (masked) {
        const float tol = rng / den;
        px_plo[p] = a.pmin[pix] - tol;
        px_phi[p] = a.pmax[pix] + tol;
      }
      px_best[p] = -1.f;
      px_sum[p] = 0.f;
      px_bd[p] = -1;
      px_nal[p] = 0;
    }
    __syncthreads();

    const int n_slots = gp * D;
    int pos = 0;  // the next slot to look at; the same in every thread
    while (pos < n_slots) {
      // ---- the window's item list: the allowed slots from pos on ----
      int n_items = 0;
      if (tid == 0) *draw = 0;
      while (pos < n_slots && n_items + T <= a.ncap) {
        const int r = pos + tid;
        bool ok = r < n_slots;
        if (ok && masked) {  // never with the slots laid by pixel
          const int p = r / D;
          const int d = r - p * D;
          const float dl = px_lo[p] + ((float)d * px_rng[p]) / den;
          ok = (dl >= px_plo[p]) && (dl <= px_phi[p]);
        }
        const unsigned b = __ballot_sync(0xffffffffu, ok);
        if (lane == 0) wcnt[warp] = __popc(b);
        __syncthreads();
        int off = n_items, tot = 0;
        for (int w = 0; w < nwarps; ++w) {
          const int cw = wcnt[w];
          if (w < warp) off += cw;
          tot += cw;
        }
        if (ok) list[off + __popc(b & ((1u << lane) - 1u))] = r;
        n_items += tot;
        pos += T;
        __syncthreads();
      }

      // ---- the items: warps draw 32 neighbouring ones at a time ----
      for (;;) {
        int jb = 0;
        if (lane == 0) jb = atomicAdd(draw, 32);
        jb = __shfl_sync(0xffffffffu, jb, 0);
        if (jb >= n_items) break;
        const int j = jb + lane;
        if (j < n_items) {
          const int r = list[j];
          const int q = r / (by_pixel ? gp : D);
          const int m = r - q * (by_pixel ? gp : D);
          const int p = by_pixel ? m : q;
          const int d = by_pixel ? q : m;
          const int pix = px_pix[p];
          const int v = pix / U;
          const int u = pix - v * U;
          const float delta = px_lo[p] + ((float)d * px_rng[p]) / den;
          const float* row = a.epis + (size_t)v * S * U * C;  // [S][U][C]
          float* o_rbp = with_k ? it_rbp + j * C : nullptr;
          if constexpr (rslf_pc_regs(MAXC) > 0) {
            work += rslf_pc_item_regs<Rule, MAXC>(a, row, u, delta, col, vec,
                                                  it_score + j,
                                                  it_rb + j * C, o_rbp);
          } else if constexpr (MAXC > 0) {
            work += rslf_pc_item<Rule, MAXC>(a, row, u, delta, col, vec,
                                             it_score + j, it_rb + j * C,
                                             o_rbp);
          } else {
            work += rslf_pc_item_any<Rule>(a, row, u, delta, smem, tid, T,
                                           it_score + j, it_rb + j * C,
                                           o_rbp);
          }
        }
      }
      __syncthreads();

      // ---- fold: one thread per pixel, its items in candidate order ----
      for (int p = tid; p < gp; p += T) {
        // the pixel's items of this window, in candidate order: list
        // positions j_lo, j_lo + step, ...
        int j_lo, step;
        if (by_pixel) {
          // unmasked: the list is the slots w0 .. w0 + n_items - 1, and
          // the pixel's are those congruent to p modulo gp
          const int w0 = list[0];
          j_lo = ((p - w0) % gp + gp) % gp;
          step = gp;
        } else {
          const int first = p * D;
          int lo_j = 0, hi_j = n_items;  // lower bound of `first` in the list
          while (lo_j < hi_j) {
            const int mid = (lo_j + hi_j) >> 1;
            if (list[mid] < first) {
              lo_j = mid + 1;
            } else {
              hi_j = mid;
            }
          }
          j_lo = lo_j;
          step = 1;
        }
        float best = px_best[p], sum = px_sum[p];
        int bd = px_bd[p], nal = px_nal[p], bj = -1;
        for (int j = j_lo; j < n_items; j += step) {
          const int d = by_pixel ? list[j] / gp : list[j] - p * D;
          if (d >= D) break;  // the next pixel's items
          const float sc = it_score[j];
          ++nal;
          if (sc > best) {
            best = sc;
            bd = d;
            bj = j;
          }
          sum = sum + sc;
        }
        px_best[p] = best;
        px_sum[p] = sum;
        px_bd[p] = bd;
        px_nal[p] = nal;
        if (bj >= 0) {
          for (int c = 0; c < C; ++c) {
            px_rb[p * C + c] = it_rb[bj * C + c];
            if (with_k) px_rbp[p * C + c] = it_rbp[bj * C + c];
          }
        }
      }
      __syncthreads();
    }

    // ---- the group's outputs ----
    for (int p = tid; p < gp; p += T) {
      const size_t pix = (size_t)px_pix[p];
      const int bd = px_bd[p];
      const float fD = (float)D;
      a.out.best_score[pix] = px_best[p];
      a.out.best_depth[pix] =
          (bd >= 0) ? px_lo[p] + ((float)bd * px_rng[p]) / den : 0.f;
      a.out.score_mean[pix] =
          masked ? ((px_sum[p] * fD) / (float)max(px_nal[p], 1)) / fD
                 : px_sum[p] / fD;
      for (int c = 0; c < C; ++c)
        a.out.rbar[pix * C + c] = (bd >= 0) ? px_rb[p * C + c] : 0.f;
    }
    if (with_k) {
      // K of the winner's last step, one (pixel, s) a thread
      for (int i = tid; i < gp * S; i += T) {
        const int p = i / S;
        const int s = i - p * S;
        const int bd = px_bd[p];
        const int pix = px_pix[p];
        const int v = pix / U;
        const int u = pix - v * U;
        float k = 0.f;
        if (bd >= 0) {
          const float delta = px_lo[p] + ((float)bd * px_rng[p]) / den;
          const PcPos q =
              Rule::pos((float)(a.s_hat - s), u, U, a.u_lo, a.u_hi, delta,
                        a.slope);
          if (q.ok) {
            const float* row = a.epis + (size_t)v * S * U * C;
            const float* ra = row + ((size_t)s * U + q.i0) * C;
            const float* rc = ra + (q.up ? C : 0);
            float dsq = 0.f;
            for (int c = 0; c < C; ++c) {
              const float x = (1.f - q.t) * __ldg(ra + c) + q.t * __ldg(rc + c);
              const float diff = x - px_rbp[p * C + c];
              const float d2 = diff * diff;
              dsq = (c == 0) ? d2 : dsq + d2;
            }
            k = fmaxf(1.f - a.a_coef * dsq, 0.f);
          }
        }
        a.out.k_best[((size_t)v * S + s) * U + u] = k;
      }
    }
    __syncthreads();  // the next group reuses the pixel state
  }

  if (a.out.work_count != nullptr) {
    for (int o = 16; o > 0; o >>= 1)
      work += __shfl_down_sync(0xffffffffu, work, o);
    if (lane == 0) atomicAdd(a.out.work_count, work);
  }
}

// What the launcher chose for one kernel and size.
struct PcPlan {
  int threads;        // threads of a block
  int ncap;           // items of a window's list
  int smem_bytes;     // dynamic shared memory of a block
  int blocks_per_sm;  // resident blocks an SM holds (the runtime's report)
  int sms;            // SMs of the card
};

namespace rslf_pc {

struct PlanKey {
  int device, S, C, with_k, g_max;
};

// The block size with the most resident threads an SM holds, among 128,
// 64, 256 and 32 threads (the first on a tie), from the occupancy the
// runtime reports for this build; a window's list holds RSLF_PC_WINDOW
// items a thread and the pixel state is sized for groups of `g_max` pixels.
// Queried, and the kernel's shared-memory limit raised, once per kernel and
// size.
template <int MAXC, typename Rule>
cudaError_t plan(int S, int C, bool with_k, int g_max, PcPlan* out) {
  static std::mutex mu;
  static PlanKey keys[64];
  static PcPlan plans[64];
  static int n_cached = 0;
  std::lock_guard<std::mutex> guard(mu);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n_cached; ++i) {
    const PlanKey& k = keys[i];
    if (k.device == device && k.S == S && k.C == C && k.with_k == with_k &&
        k.g_max == g_max) {
      *out = plans[i];
      return cudaSuccess;
    }
  }
  int optin = 0, sms = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sweep_pc_kernel<MAXC, Rule>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  PcPlan best{0, 0, 0, 0, sms};
  constexpr int kSizes[4] = {128, 64, 256, 32};
  for (const int T : kSizes) {
    const int ncap = RSLF_PC_WINDOW * T;
    const long long bytes =
        4LL * rslf_pc_layout(S, C, T, MAXC, ncap, g_max, with_k).total;
    if (bytes > (long long)optin) continue;
    int nb = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nb, sweep_pc_kernel<MAXC, Rule>, T, (size_t)bytes);
    if (err != cudaSuccess) return err;
    if (nb * T > best.blocks_per_sm * best.threads)
      best = PcPlan{T, ncap, (int)bytes, nb, sms};
  }
  if (best.threads == 0) return cudaErrorInvalidConfiguration;
  if (n_cached < 64) {
    keys[n_cached] = PlanKey{device, S, C, with_k ? 1 : 0, g_max};
    plans[n_cached++] = best;
  }
  *out = best;
  return cudaSuccess;
}

template <int MAXC, typename Rule>
cudaError_t launch(PcArgs a, cudaStream_t stream) {
  if (a.n_act <= 0) return cudaSuccess;
  // (float)d is exact up to 2^24, as the float32 arange of the plain
  // versions' grids is, and a group's G * D slots (G <= 64) stay in an int
  if (a.D < 1 || a.D > (1 << 24)) return cudaErrorInvalidValue;
  const bool with_k = a.out.k_best != nullptr;
  const bool masked = a.pmin != nullptr;
  const bool by_pixel = a.by_pixel != 0;
  if (masked && by_pixel) return cudaErrorInvalidValue;
  const int g_max = rslf_pc_gmax(masked, by_pixel);
  PcPlan p;
  const cudaError_t err = plan<MAXC, Rule>(a.S, a.C, with_k, g_max, &p);
  if (err != cudaSuccess) return err;
  // pixels of a group: spread the list over the resident blocks of the
  // card; in the masked mode a pixel has few items, so keep at least 8
  const int resident = p.blocks_per_sm * p.sms;
  const int g_min = masked ? 8 : 1;
  const int g_even = (a.n_act + resident - 1) / resident;
  a.G = g_even < g_min ? g_min : (g_even > g_max ? g_max : g_even);
  a.ncap = p.ncap;
  const int blocks = (a.n_act + a.G - 1) / a.G;
  const size_t bytes =
      4 * (size_t)rslf_pc_layout(a.S, a.C, p.threads, MAXC, p.ncap, a.G, with_k)
              .total;
  sweep_pc_kernel<MAXC, Rule><<<blocks, p.threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// Calls f.template operator()<MAXC>() with the instantiation for C
// channels: registers for C <= 4, shared memory beyond.
template <typename F>
cudaError_t for_channels(int C, F f) {
  switch (C) {
    case 1:
      return f.template operator()<1>();
    case 2:
      return f.template operator()<2>();
    case 3:
      return f.template operator()<3>();
    case 4:
      return f.template operator()<4>();
    default:
      return f.template operator()<0>();
  }
}

template <typename Rule>
struct LaunchFn {
  const PcArgs& a;
  cudaStream_t stream;
  template <int MAXC>
  cudaError_t operator()() const {
    return launch<MAXC, Rule>(a, stream);
  }
};

template <typename Rule>
struct PlanFn {
  int S, C;
  bool with_k;
  int g_max;
  PcPlan* out;
  template <int MAXC>
  cudaError_t operator()() const {
    return plan<MAXC, Rule>(S, C, with_k, g_max, out);
  }
};

// Launch on `stream` under position rule `Rule`; returns the CUDA error
// code.
template <typename Rule>
inline int launch_for_c(const PcArgs& a, cudaStream_t stream) {
  return (int)for_channels(a.C, LaunchFn<Rule>{a, stream});
}

// The plan for C channels into out[5]: threads, items of a window, bytes of
// shared memory, resident blocks an SM, SMs.  Returns the CUDA error code
// (cudaErrorInvalidConfiguration when no block size fits).
template <typename Rule>
inline int plan_for_c(int S, int C, int with_k, int masked, int by_pixel,
                      int* out) {
  PcPlan p{0, 0, 0, 0, 0};
  const cudaError_t err = for_channels(
      C, PlanFn<Rule>{S, C, with_k != 0,
                      rslf_pc_gmax(masked != 0, by_pixel != 0), &p});
  out[0] = p.threads;
  out[1] = p.ncap;
  out[2] = p.smem_bytes;
  out[3] = p.blocks_per_sm;
  out[4] = p.sms;
  return (int)err;
}

}  // namespace rslf_pc

}  // namespace
