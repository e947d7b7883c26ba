// Host driver of kernels 1-5: their lane bodies built with a host C++
// compiler, so their phases and teams run on the CPU.
// - Kernels 2 and 3 (csrc/team.cuh, csrc/solve_fm.cu): each scenario's team
//   is emulated in one thread: uniform code runs once, and each phase runs
//   its members one after another, first to last or
//   (vct_host_set_member_order(1)) last to first, on a shared area of
//   TEAM_FLOATS floats.
// - Kernel 4 (csrc/derivs_fm.cu): its lane over every (stage, scenario).
// - Kernels 1 and 5 (csrc/rollout_fm.cu, csrc/rollout_aos.cu): each block
//   through the kernels' own schedule (linesearch_block, linesearch.cuh)
//   with the kernel's record source, every thread of a phase in turn, in
//   either order; or, kernel 1, one lane at a time (linesearch_lane, every
//   stage's candidate_stage in order).
// Same arguments and layouts as the kernels' launchers, without the stream;
// each entry comes for the cascaded family (STParams) and, with the suffix
// _kin, for the kinematic family (KinParams) and, with _kc, for the kc
// cascade (KcParams), as the kernels' entries do.
//
//     g++ -std=c++17 -O1 -shared -fPIC -I csrc -o libvct_host.so csrc/host_driver.cpp
//
// tests/test_torch_host_kernels.py builds and loads it.
#if defined(VCT_COUNT_OPS)
#include "op_count.h"
#endif
#include <vector>

#include "derivs_fm.cu"
#include "rollout_aos.cu"
#include "rollout_fm.cu"
#include "solve_fm.cu"

extern "C" int vct_host_team() { return TEAM; }

extern "C" int vct_host_solve_config_size() { return (int)sizeof(SolveConfig); }

// STParams', KinParams' and KcParams' floats (the obstacle table's
// included), as vct_param_count, vct_kin_param_count and vct_kc_param_count
extern "C" int vct_host_param_count() { return (int)(sizeof(STParams) / sizeof(float)); }
extern "C" int vct_host_kin_param_count() { return (int)(sizeof(KinParams) / sizeof(float)); }
extern "C" int vct_host_kc_param_count() { return (int)(sizeof(KcParams) / sizeof(float)); }

extern "C" void vct_host_set_member_order(int last_first) { host_member_order = last_first; }

template <class P>
static int host_backward(const float* params, const float* x, const float* u, const float* lam,
                         const float* mu, const float* rho, const float* curv, const float* ds,
                         float* kff, float* kfb, float* dv, float* fail, int B, int H) {
  if (B < 1 || H < 1) return 1;
  P p;
  memcpy(&p, params, sizeof(P));
  std::vector<float> sh(TeamLayout<P>::TEAM_FLOATS);
  for (int b = 0; b < B; ++b)
    backward_lane(Team{sh.data(), 0u, 0}, b, B, H, x, u, lam, mu, rho, curv, ds, kff, kfb, dv, fail, p);
  return 0;
}

template <class P>
static int host_solve(const float* params, const void* config, const float* z0, const float* u0,
                      const float* lam0, const float* curv, const float* ds, float* x, float* u,
                      float* lam, float* kff, float* kfb, float* stats, int B, int H) {
  SolveConfig cfg;
  memcpy(&cfg, config, sizeof(SolveConfig));
  if (solve_args_error<P>(cfg, B, H)) return 1;
  P p;
  memcpy(&p, params, sizeof(P));
  std::vector<float> sh(TeamLayout<P>::TEAM_FLOATS);
  for (int b = 0; b < B; ++b)
    solve_lane(Team{sh.data(), 0u, 0}, b, B, H, cfg, p, z0, u0, lam0, curv, ds, x, u, lam, kff, kfb, stats);
  return 0;
}

// kernel 4's outputs, every (stage, scenario) by its lane (derivs_lane)
template <class P>
static int host_derivs(const float* params, const float* x, const float* u, const float* lam,
                       const float* mu, const float* curv, const float* ds, float* g, float* hw,
                       float* jm, int B, int H) {
  if (B < 1 || H < 1) return 1;
  P p;
  memcpy(&p, params, sizeof(P));
  for (int n = 0; n < H; ++n)
    for (int b = 0; b < B; ++b) derivs_lane(n, b, B, H, p, x, u, lam, mu, curv, ds, g, hw, jm);
  return 0;
}

// kernel 1's one-lane semantics: the line-search cost of step size alpha
// for scenario b, every stage's candidate_stage in order
template <class P>
static void linesearch_lane(int b, int B, int H, float alpha, const LsInputs& in,
                            float* cost_out, const P& p) {
  float z[P::NZ];
  for (int i = 0; i < P::NZ; ++i) z[i] = in.z0[i * B + b];
  float m = in.mu[b], acc = 0.f;
  for_each_stage(H, p, [&](int n, auto kc) {
    Stage<P> s;
    load_stage(n, b, B, in.xref, in.uref, in.kff, in.kfb, in.lam, in.curv, in.ds, p, s);
    candidate_stage<decltype(kc)::value>(n, H, alpha, m, s, p, z, acc);
  });
  cost_out[b] = vct::finite(acc) ? acc : INFINITY;
}

// every thread of a block, for linesearch_block: each phase runs them first
// to last, or last to first; the barriers and copies are plain
template <class P>
struct HostBlock {
  std::vector<LsThread<P>> t;
  bool last_first;
  template <class F>
  void each(F&& f) {
    const int n = (int)t.size();
    for (int k = 0; k < n; ++k) {
      const int i = last_first ? n - 1 - k : k;
      f(i >> 5, i & 31, t[i]);
    }
  }
  void commit() {}
  void wait_prior() {}
  void sync() {}
};

// every block of the line search with the record source src, threads in
// either order
template <class P, class Records>
static void host_blocks(const P& p, const float* alphas, int A, const Records& src, float* costs,
                        int B, int H, bool last_first) {
  Alphas al;
  for (int i = 0; i < MAX_ALPHA; ++i) al.v[i] = i < A ? alphas[i] : 0.f;
  const int C = ls_chunk<P>(A);
  std::vector<float> smem(ls_smem<P>(A, C) / sizeof(float));
  for (int b0 = 0; b0 < B; b0 += LS_SCEN) {
    HostBlock<P> blk{std::vector<LsThread<P>>(2 * ls_warps(A) * 32), last_first};
    linesearch_block(blk, p, al, A, C, src, smem.data(), costs, b0, B, H);
  }
}

// kernel 1's costs (A, B): mode 0, linesearch_lane for each (step size,
// scenario); 1 and 2, each block through linesearch_block, its threads
// first to last (1) or last to first (2)
template <class P>
static int host_linesearch(const float* params, const float* alphas, int A, const LsInputs& in,
                           float* costs, int B, int H, int mode) {
  if (A < 1 || A > MAX_ALPHA || B < 1 || H < 1) return 1;
  P p;
  memcpy(&p, params, sizeof(P));
  if (mode == 0) {
    for (int a = 0; a < A; ++a)
      for (int b = 0; b < B; ++b) linesearch_lane(b, B, H, alphas[a], in, costs + (size_t)a * B, p);
    return 0;
  }
  host_blocks(p, alphas, A, SoaRecords<P>{in}, costs, B, H, mode == 2);
  return 0;
}

// kernel 5's costs (A, B) from the (B, H, F) layout: each block through
// linesearch_block, its threads first to last (mode 1) or last to first (2)
template <class P>
static int host_linesearch_aos(const float* params, const float* alphas, int A,
                               const LsInputs& in, float* costs, int B, int H, int mode) {
  if (A < 1 || A > MAX_ALPHA || B < 1 || H < 1 || mode < 1 || mode > 2) return 1;
  P p;
  memcpy(&p, params, sizeof(P));
  host_blocks(p, alphas, A, AosRecords<P>{in}, costs, B, H, mode == 2);
  return 0;
}

// the C entries of each family: NAME for the cascaded family, NAME_kin for
// the kinematic family, NAME_kc for the kc cascade
#define VCT_HOST_ENTRIES(SUFFIX, P)                                                              \
  extern "C" int vct_host_backward##SUFFIX(                                                      \
      const float* params, const float* x, const float* u, const float* lam, const float* mu,    \
      const float* rho, const float* curv, const float* ds, float* kff, float* kfb, float* dv,   \
      float* fail, int B, int H) {                                                               \
    return host_backward<P>(params, x, u, lam, mu, rho, curv, ds, kff, kfb, dv, fail, B, H);     \
  }                                                                                              \
  extern "C" int vct_host_solve##SUFFIX(                                                         \
      const float* params, const void* config, const float* z0, const float* u0,                \
      const float* lam0, const float* curv, const float* ds, float* x, float* u, float* lam,     \
      float* kff, float* kfb, float* stats, int B, int H) {                                      \
    return host_solve<P>(params, config, z0, u0, lam0, curv, ds, x, u, lam, kff, kfb, stats, B,  \
                         H);                                                                     \
  }                                                                                              \
  extern "C" int vct_host_derivs##SUFFIX(const float* params, const float* x, const float* u,    \
                                         const float* lam, const float* mu, const float* curv,   \
                                         const float* ds, float* g, float* hw, float* jm, int B, \
                                         int H) {                                                \
    return host_derivs<P>(params, x, u, lam, mu, curv, ds, g, hw, jm, B, H);                     \
  }                                                                                              \
  extern "C" int vct_host_linesearch##SUFFIX(                                                    \
      const float* params, const float* alphas, int A, const float* xref, const float* uref,     \
      const float* kff, const float* kfb, const float* lam, const float* mu, const float* curv,  \
      const float* ds, const float* z0, float* costs, int B, int H, int mode) {                  \
    return host_linesearch<P>(params, alphas, A,                                                 \
                              LsInputs{xref, uref, kff, kfb, lam, mu, curv, ds, z0}, costs, B, H, \
                              mode);                                                             \
  }                                                                                              \
  extern "C" int vct_host_linesearch_aos##SUFFIX(                                                \
      const float* params, const float* alphas, int A, const float* xref, const float* uref,     \
      const float* kff, const float* kfb, const float* lam, const float* mu, const float* curv,  \
      const float* ds, const float* z0, float* costs, int B, int H, int mode) {                  \
    return host_linesearch_aos<P>(params, alphas, A,                                             \
                                  LsInputs{xref, uref, kff, kfb, lam, mu, curv, ds, z0}, costs, B, \
                                  H, mode);                                                      \
  }
VCT_HOST_ENTRIES(, STParams)
VCT_HOST_ENTRIES(_kin, KinParams)
VCT_HOST_ENTRIES(_kc, KcParams)
#undef VCT_HOST_ENTRIES

#if defined(VCT_COUNT_OPS)
// the f32 operations of the calls since the last read (op_count.h)
extern "C" double vct_host_ops() {
  const double n = vct_count::ops;
  vct_count::ops = 0.0;
  return n;
}
#endif
