// Line confidence C_l at the pixels of a mask.
//
// Plain version: ops/line_confidence.py `line_confidence`; wrapper: the same
// module's `line_confidence_cuda`.  Reference: the JAX package's
// models/depth2d.py `_line_confidence`, rslf_depth_computation_core.hpp:
// 1032-1081.  The JAX package has no TPU kernel for it (XLA fuses it).
//
// What it computes: for each pixel (v, u) of `mask`, with d = depth[v, u],
// over the frames s: the index I = (s_hat - s) * d + u; the sample counts
// iff floor(I) >= 0 and ceil(I) <= U - 1; C_e(I) is C_e[s, v, :]
// interpolated linearly at I (0 where the sample does not count); p_s =
// C_e(I) * k_best[v, s, u]; and C_l = sum_s p_s / sum_s k_best[v, s, u].
// 0 outside the mask; NaN where the sum of k_best is 0.  Both sums take the
// plain version's order, by halves: x[:h] + x[h:2h] with an odd last element
// carried, until one is left.  Every operation rounds as the plain
// version's does (-fmad=false, IEEE division), so the result is bitwise
// the same.
//
// Bound on this card: bytes.  A masked pixel reads its S values of k_best
// and 2S of C_e; every pixel reads its mask byte and writes its result.
//
// Design: one thread a masked pixel.  A block takes kThreads consecutive
// pixels of the [V, U] plane, writes 0 at those outside the mask, and packs
// the masked ones, in order, into a list in shared memory, whose pixels its
// first threads then take.  The passes after a level's first sweep a few
// per cent of the plane, scattered along edges, so packing leaves few warps
// at work, each with its lanes full, where a thread for each pixel of the
// plane would keep most warps busy for one or two lanes (packing took a
// sixth off the kernel's time a scene, most of it in the mid passes of
// level 0); and
// neighbouring list entries are neighbouring pixels of a row, so the
// k_best[v, s, u] reads of a warp stay near-coalesced for every s and its
// C_e reads, near u + (s_hat - s) * d, fall in few lines.  Larger runs a
// block, with a thread taking several pixels, gained nothing: they idle SMs
// at the coarse levels.
// The sums by halves are walked depth first: a node of step L + 1 is the
// sum of nodes j and j + h_L of step L, so the leaves visited in post-order
// need one pending partial sum a step (a left child waiting for its right
// sibling), kLevels of num and of den.  The host builds the walk once per S
// (`halves_program`): the leaf order, and for each leaf what its value does
// at each step on its way up (stored as a left child, added to the pending
// left sibling, or carried unchanged), two bits a step, and how many steps
// it takes.  The program is the same for every thread, so its branches do
// not diverge; a switch on the step count enters a walk unrolled to that
// count, so the pending sums stay in registers and a leaf takes its own
// steps only (two on average).  The loads of kBatch leaves are issued before
// their walks.  No [S, V, U] temporaries.

#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // pixels a block
constexpr int kLevels = 11;  // halving steps of the largest S, 2^kLevels
constexpr int kBatch = 8;    // leaves whose loads are in flight together

// a leaf's program word: two bits a step (0 to carry the value as it is,
// an odd last element; kAdd; kStore), the step count from bit kStepsShift
constexpr int kAdd = 1;      // a right child: add the pending left one
constexpr int kStore = 2;    // a left child: wait for its sibling
constexpr int kStepsShift = 24;

struct LineArgs {
  const float* ce;            // [S, V, U]
  const float* depth;         // [V, U]
  const float* k_best;        // [V, S, U]
  const unsigned char* mask;  // [V, U] 1 = computed
  const int2* prog;           // [S] (frame s, program word)
  float* out;                 // [V, U]
  int S, V, U, s_hat;
  unsigned long long* count;  // masked pixels, or null
};

struct Pending {
  float n[kLevels], d[kLevels];  // pending left children, a step each
};

// Leaf s's two values of pixel (v, u): the product p_s and k_s.
__device__ __forceinline__ float2 leaf_values(const LineArgs& a, int s,
                                              float d, float fu, float last,
                                              const float* ce_row,
                                              const float* k_col,
                                              size_t plane) {
  const float idx =
      __fadd_rn(__fmul_rn(static_cast<float>(a.s_hat - s), d), fu);
  const float fi = floorf(idx);
  const bool valid = fi >= 0.0f && ceilf(idx) <= last;
  const float t = __fsub_rn(idx, fi);
  const int i0 = static_cast<int>(fminf(fmaxf(fi, 0.0f), last));
  const int i1 = min(i0 + 1, a.U - 1);
  const float* row = ce_row + static_cast<size_t>(s) * plane;
  const float ca = __ldg(row + i0);
  const float cb = __ldg(row + i1);
  const float ce_i = valid ? __fadd_rn(__fmul_rn(__fsub_rn(1.0f, t), ca),
                                       __fmul_rn(t, cb))
                           : 0.0f;
  const float k = __ldg(k_col + static_cast<size_t>(s) * a.U);
  return make_float2(__fmul_rn(ce_i, k), k);
}

template <int N>
__device__ __forceinline__ void walk_steps(int word, float2& x,
                                           Pending& pend) {
#pragma unroll
  for (int L = 0; L < N; ++L) {
    const int c = (word >> (2 * L)) & 3;
    if (c == kAdd) {
      x.x = __fadd_rn(pend.n[L], x.x);
      x.y = __fadd_rn(pend.d[L], x.y);
    } else if (c == kStore) {
      pend.n[L] = x.x;
      pend.d[L] = x.y;
    }
  }
}

// A leaf's walk up the tree; x is the root after the last leaf.
__device__ __forceinline__ void walk(int word, float2& x, Pending& pend) {
  static_assert(kLevels == 11, "one case a step count");
  switch (word >> kStepsShift) {
    case 1: walk_steps<1>(word, x, pend); break;
    case 2: walk_steps<2>(word, x, pend); break;
    case 3: walk_steps<3>(word, x, pend); break;
    case 4: walk_steps<4>(word, x, pend); break;
    case 5: walk_steps<5>(word, x, pend); break;
    case 6: walk_steps<6>(word, x, pend); break;
    case 7: walk_steps<7>(word, x, pend); break;
    case 8: walk_steps<8>(word, x, pend); break;
    case 9: walk_steps<9>(word, x, pend); break;
    case 10: walk_steps<10>(word, x, pend); break;
    case 11: walk_steps<11>(word, x, pend); break;
    default: break;  // the one leaf of S = 1
  }
}

// C_l of pixel p of the plane.
__device__ __forceinline__ float line_conf_at(const LineArgs& a, int p) {
  const int v = p / a.U;
  const int u = p - v * a.U;
  const float d = a.depth[p];
  const float fu = static_cast<float>(u);
  const float last = static_cast<float>(a.U - 1);
  const size_t plane = static_cast<size_t>(a.V) * a.U;
  const float* ce_row = a.ce + static_cast<size_t>(v) * a.U;
  const float* k_col = a.k_best + static_cast<size_t>(v) * a.S * a.U + u;

  Pending pend;
  float2 x = make_float2(0.0f, 0.0f);
  int i = 0;
  for (; i + kBatch <= a.S; i += kBatch) {
    int2 leaf[kBatch];
    float2 val[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) leaf[b] = __ldg(&a.prog[i + b]);
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      val[b] = leaf_values(a, leaf[b].x, d, fu, last, ce_row, k_col, plane);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      x = val[b];
      walk(leaf[b].y, x, pend);
    }
  }
  for (; i < a.S; ++i) {
    const int2 leaf = __ldg(&a.prog[i]);
    x = leaf_values(a, leaf.x, d, fu, last, ce_row, k_col, plane);
    walk(leaf.y, x, pend);
  }
  return __fdiv_rn(x.x, x.y);
}

__global__ void __launch_bounds__(kThreads)
    line_conf_kernel(const LineArgs a) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int list[kThreads];
  __shared__ int warp_n[kWarps];
  const int n_pix = a.V * a.U;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // the masked pixels of the block's run, packed in order into the list
  const bool in = p < n_pix && a.mask[p] != 0;
  if (p < n_pix && !in) a.out[p] = 0.0f;
  const unsigned ballot = __ballot_sync(0xffffffffu, in);
  if (lane == 0) warp_n[warp] = __popc(ballot);
  __syncthreads();
  int n = 0, before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? warp_n[w] : 0;
    n += warp_n[w];
  }
  if (in) list[before + __popc(ballot & ((1u << lane) - 1u))] = p;
  if (a.count != nullptr && threadIdx.x == 0 && n != 0)
    atomicAdd(a.count, static_cast<unsigned long long>(n));
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < n) {
    const int q = list[threadIdx.x];
    a.out[q] = line_conf_at(a, q);
  }
}

}  // namespace

RSLF_DEFINE_ERROR_STRING(rslf_line_conf_error_string)

// C_l into `out` [V, U] at the pixels of `mask`, 0 elsewhere.  `prog` is
// the host's walk for S (ops/line_confidence.py `halves_program`); `count`
// may be null.  Returns a CUDA error code (cudaErrorInvalidValue for S
// outside [1, 2^kLevels] or a plane of about 2^31 pixels or more).
RSLF_EXPORT int rslf_line_conf(const float* ce, const float* depth,
                               const float* k_best, const unsigned char* mask,
                               const int* prog, float* out, int S, int V,
                               int U, int s_hat, unsigned long long* count,
                               void* stream) {
  if (S < 1 || S > (1 << kLevels) || V < 0 || U < 0 ||
      static_cast<long long>(V) * U > INT_MAX - kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_pix = V * U;
  if (n_pix == 0) return 0;
  const LineArgs a{ce, depth, k_best, mask,
                   reinterpret_cast<const int2*>(prog), out, S, V, U, s_hat,
                   count};
  line_conf_kernel<<<(n_pix + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
