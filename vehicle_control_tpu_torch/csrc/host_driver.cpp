// Host driver of kernels 2 and 3: the lane bodies of csrc/team.cuh and
// csrc/solve_fm.cu built with a host C++ compiler, so their team code runs
// on the CPU.  Each scenario's team is emulated in one thread: uniform code
// runs once, and each phase runs its members one after another, first to
// last or (vct_host_set_member_order(1)) last to first, on a shared area of
// TEAM_FLOATS floats.  Same arguments and layouts as vct_backward_fm and
// vct_solve_fm, without the stream.
//
//     g++ -std=c++17 -O1 -shared -fPIC -I csrc -o libvct_host.so csrc/host_driver.cpp
//
// tests/test_torch_host_kernels.py builds and loads it.
#include <vector>

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
