// Host driver of kernels 1-4: their lane bodies built with a host C++
// compiler, so their phases and teams run on the CPU.
// - Kernels 2 and 3 (csrc/team.cuh, csrc/solve_fm.cu): each scenario's team
//   is emulated in one thread: uniform code runs once, and each phase runs
//   its members one after another, first to last or
//   (vct_host_set_member_order(1)) last to first, on a shared area of
//   TEAM_FLOATS floats.
// - Kernel 4 (csrc/derivs_fm.cu): its lane over every (stage, scenario).
// - Kernel 1 (csrc/rollout_fm.cu): each block through the kernel's own
//   schedule (linesearch_block), every thread of a phase in turn, in
//   either order; or one lane at a time (linesearch_lane, every stage's
//   candidate_stage in order).
// Same arguments and layouts as the kernels' launchers, without the stream.
//
//     g++ -std=c++17 -O1 -shared -fPIC -I csrc -o libvct_host.so csrc/host_driver.cpp
//
// tests/test_torch_host_kernels.py builds and loads it.
#include <vector>

#include "derivs_fm.cu"
#include "rollout_fm.cu"
#include "solve_fm.cu"

extern "C" int vct_host_team() { return TEAM; }


extern "C" int vct_host_solve_config_size() { return (int)sizeof(SolveConfig); }

extern "C" void vct_host_set_member_order(int last_first) { host_member_order = last_first; }

extern "C" int vct_host_backward(const float* params, const float* x, const float* u,
                                 const float* lam, const float* mu, const float* rho,
                                 const float* curv, const float* ds, float* kff, float* kfb,
                                 float* dv, float* fail, int B, int H) {
  if (B < 1 || H < 1) return 1;
  STParams p;
  memcpy(&p, params, sizeof(STParams));
  std::vector<float> sh(TEAM_FLOATS);
  for (int b = 0; b < B; ++b)
    backward_lane(Team{sh.data(), 0u, 0}, b, B, H, x, u, lam, mu, rho, curv, ds, kff, kfb, dv, fail, p);
  return 0;
}

extern "C" int vct_host_solve(const float* params, const void* config, const float* z0,
                              const float* u0, const float* lam0, const float* curv,
                              const float* ds, float* x, float* u, float* lam, float* kff,
                              float* kfb, float* stats, int B, int H) {
  SolveConfig cfg;
  memcpy(&cfg, config, sizeof(SolveConfig));
  if (solve_args_error(cfg, B, H)) return 1;
  STParams p;
  memcpy(&p, params, sizeof(STParams));
  std::vector<float> sh(TEAM_FLOATS);
  for (int b = 0; b < B; ++b)
    solve_lane(Team{sh.data(), 0u, 0}, b, B, H, cfg, p, z0, u0, lam0, curv, ds, x, u, lam, kff, kfb, stats);
  return 0;
}

// kernel 4's outputs, every (stage, scenario) by its lane (derivs_lane)
extern "C" int vct_host_derivs(const float* params, const float* x, const float* u,
                               const float* lam, const float* mu, const float* curv,
                               const float* ds, float* g, float* hw, float* jm, int B, int H) {
  if (B < 1 || H < 1) return 1;
  STParams p;
  memcpy(&p, params, sizeof(STParams));
  for (int n = 0; n < H; ++n)
    for (int b = 0; b < B; ++b) derivs_lane(n, b, B, H, p, x, u, lam, mu, curv, ds, g, hw, jm);
  return 0;
}

// kernel 1's one-lane semantics: the line-search cost of step size alpha
// for scenario b, every stage's candidate_stage in order
static void linesearch_lane(int b, int B, int H, float alpha, const LsInputs& in,
                            float* cost_out, const STParams& p) {
  float z[NZ];
  for (int i = 0; i < NZ; ++i) z[i] = in.z0[i * B + b];
  float m = in.mu[b], acc = 0.f;
  for_each_stage(H, p, [&](int n, auto kc) {
    Stage s;
    load_stage(n, b, B, in.xref, in.uref, in.kff, in.kfb, in.lam, in.curv, in.ds, p, s);
    candidate_stage<decltype(kc)::value>(n, H, alpha, m, s, p, z, acc);
  });
  cost_out[b] = vct::finite(acc) ? acc : INFINITY;
}

// every thread of a block, for linesearch_block: each phase runs them first
// to last, or last to first; the barriers and copies are plain
struct HostBlock {
  std::vector<LsThread> t;
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

// kernel 1's costs (A, B): mode 0, linesearch_lane for each (step size,
// scenario); 1 and 2, each block through linesearch_block, its threads
// first to last (1) or last to first (2)
extern "C" int vct_host_linesearch(const float* params, const float* alphas, int A,
                                   const float* xref, const float* uref, const float* kff,
                                   const float* kfb, const float* lam, const float* mu,
                                   const float* curv, const float* ds, const float* z0,
                                   float* costs, int B, int H, int mode) {
  if (A < 1 || A > MAX_ALPHA || B < 1 || H < 1) return 1;
  STParams p;
  memcpy(&p, params, sizeof(STParams));
  const LsInputs in{xref, uref, kff, kfb, lam, mu, curv, ds, z0};
  if (mode == 0) {
    for (int a = 0; a < A; ++a)
      for (int b = 0; b < B; ++b) linesearch_lane(b, B, H, alphas[a], in, costs + (size_t)a * B, p);
    return 0;
  }
  Alphas al;
  for (int i = 0; i < MAX_ALPHA; ++i) al.v[i] = i < A ? alphas[i] : 0.f;
  const int C = ls_chunk(A);
  std::vector<float> smem(ls_smem(A, C) / sizeof(float));
  for (int b0 = 0; b0 < B; b0 += LS_SCEN) {
    HostBlock blk{std::vector<LsThread>(2 * ls_warps(A) * 32), mode == 2};
    linesearch_block(blk, p, al, A, C, in, smem.data(), costs, b0, B, H);
  }
  return 0;
}
