// The sweep core's item and plan code (csrc/sweep_pc.cuh, its launch
// syntax taken out) compiled for the CPU with g++: one item at a time, each
// on its own place of a shared column of T threads' slots.
#include <vector>

#include "sweep_pc.cuh"

namespace {

template <typename Rule, int NC>
void run_items(const PcArgs& a, const float* delta, int V, float* score,
               float* rb, long long* work) {
  const int T = 5;  // items take the places of 5 threads in turn
  std::vector<float> col_words(rslf_pc_col_words(a.S, NC, NC) * T + 4);
  std::vector<float> rbp(NC);
  for (int v = 0; v < V; ++v)
    for (int u = 0; u < a.U; ++u) {
      const int i = v * a.U + u;
      const PcCol<NC> col(col_words.data(), i % T, T);
      const float* row = a.epis + (size_t)v * a.S * a.U * NC;
      float* o_rb = rb + (size_t)i * NC;
      if constexpr (rslf_pc_regs(NC) > 0)  // as sweep_pc_kernel picks
        work[i] = (long long)rslf_pc_item_regs<Rule, NC>(
            a, row, u, delta[i], col, false, score + i, o_rb, rbp.data());
      else
        work[i] = (long long)rslf_pc_item<Rule, NC>(
            a, row, u, delta[i], col, false, score + i, o_rb, rbp.data());
    }
}

template <typename Rule>
int run_rule(const PcArgs& a, const float* delta, int V, float* score,
             float* rb, long long* work) {
  switch (a.C) {
    case 1:
      run_items<Rule, 1>(a, delta, V, score, rb, work);
      return 0;
    case 3:
      run_items<Rule, 3>(a, delta, V, score, rb, work);
      return 0;
    case 4:
      run_items<Rule, 4>(a, delta, V, score, rb, work);
      return 0;
  }
  return 1;
}

}  // namespace

// Score, final r_bar and valid samples x steps of every (v, u) of the
// volume [V][S][U][C] at candidate delta[v * U + u]; rule 0: per pixel,
// 1: nearest, 2: per pixel in the window [u_lo, u_hi], 3: nearest there.
extern "C" int host_items(const float* epis, int V, int S, int U, int C,
                          int s_hat, float slope, float a_coef, int iters,
                          int rule, int u_lo, int u_hi, const float* delta,
                          float* score, float* rb, long long* work) {
  PcArgs a{};
  a.epis = epis, a.S = S, a.U = U, a.C = C, a.s_hat = s_hat;
  a.slope = slope, a.a_coef = a_coef, a.iters = iters;
  a.u_lo = u_lo, a.u_hi = u_hi;
  switch (rule) {
    case 0:
      return run_rule<PcRulePixel>(a, delta, V, score, rb, work);
    case 1:
      return run_rule<PcRuleNearest>(a, delta, V, score, rb, work);
    case 2:
      return run_rule<PcRulePixelWindow>(a, delta, V, score, rb, work);
    case 3:
      return run_rule<PcRuleNearestWindow>(a, delta, V, score, rb, work);
  }
  return 1;
}

// The pixel launcher's plan (rslf_pc::plan_for_c) under the host occupancy.
extern "C" int host_plan(int S, int C, int with_k, int* out) {
  return rslf_pc::plan_for_c<PcRulePixel>(S, C, with_k, 0, 0, out);
}

// rslf_pc_regs, rslf_pc_um and rslf_pc_us at nc channels.
extern "C" void host_batches(int nc, int* out) {
  out[0] = rslf_pc_regs(nc), out[1] = rslf_pc_um(nc), out[2] = rslf_pc_us(nc);
}
