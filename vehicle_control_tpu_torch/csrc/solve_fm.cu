// Kernel 3: the whole AL-iLQR solve of the cascaded family (tail="none" or
// tail="pm") in one launch, by a team of TEAM threads per scenario.
//
// Replaces the Pallas TPU kernel build_solve_kernel_fm
// (vehicle_control_tpu/solvers/solve_kernel_fm.py).  Per scenario: clamp U,
// the warm rollout (stores nan_to_num(z), steps the raw z), then for each
// outer iteration an AL cost sweep and up to n_inner iterations of: the
// backward pass (backward_sweep in team.cuh, shared with kernel 2), the
// costs of every step size (candidate_stage, shared with kernel 1), Armijo
// selection of the largest passing step, the re-roll of that step into X
// and U, and the rho/done/accepted-count updates; then the multiplier
// update and the penalty growth.  The polish phase runs the inner loop once
// more at the boosted penalty; the finalize pass sums the raw cost and
// takes the largest violation.  Plain version: solve_plain.
//
// What bounds it on an H100: latency and instruction issue, not bytes.  Per
// scenario the inner iterations are a serial chain; each is a backward pass
// (a single-track stage's derivatives are ~40k dependent f32 operations,
// the Riccati step ~3k) plus A closed-loop rollouts and a re-roll (~1.5k
// operations a single-track stage).  The bytes are ~14 MB of inputs and
// outputs for ~1 ms of work at the f32 peak.
//
// The design spreads each scenario over a team (team.cuh): TEAM = 4
// threads, eight scenarios to a warp, blocks of 128 threads (32 scenarios)
// with 135,808 bytes of shared memory, one block (4 warps, 255 registers)
// an SM.  At B = 4096: 16,384 threads in 128 blocks on 128 of the 132 SMs,
// 4x the warps of one thread per scenario.  Teams of 8 (8 warps an SM) run
// the backward pass faster, but the line search, the re-roll and the sums
// slower on the cascade's 60 stages, where they lost to one thread per
// scenario; teams of 4 beat it on both families (PERF.md, kernel_ab.py).
// Within a team:
// - the backward pass is stage-parallel: each member computes one stage's
//   derivatives (stage_derivs, unchanged) into the team's shared chunk,
//   then the team runs the chunk's Riccati steps in order, splitting each
//   10-row product element by element, with the value function in shared
//   memory (faster than leaving the steps to one member: PERF.md);
// - the line search is step-parallel: member t rolls out candidates t,
//   t + TEAM, ... over the whole horizon, each in the stage order of the
//   sum, so each cost is the one a single thread computes; Armijo then
//   picks the largest passing step on every member alike, and member
//   (chosen step % TEAM) re-rolls it.  feedback_u and dyn are not inlined,
//   so the re-roll and its candidate agree to the bit;
// - the clamp of U, the multiplier update and the violation maximum are
//   stage-parallel (independent stages, an exact maximum); the AL cost sum
//   and the final cost sum are computed stage-parallel into shared memory
//   and summed by every member in stage order, as the plain version sums
//   (a reordered sum would move Armijo's ties); the warm rollout and the
//   re-roll are serial chains on one member.
// X, U, lam, kff and kfb stay in device memory (struct of arrays, (stage,
// field, scenario)); the cascade's 176 bytes a stage over 60 stages and 32
// scenarios an SM would not fit in shared memory.
// The early exit (a team leaves its inner loop when its lane is done) and
// ls_fast_path (candidate 1 first, the rest of the ladder only where it
// fails Armijo) keep their flags and change no output bit: every update of
// a done lane is masked, and a lane that takes alpha=1 reads no other
// candidate.  With 6 candidates on 4 members a line search is two serial
// rollouts; the fast path makes it one where alpha=1 passes and three
// where it fails (not measured).
//
// The lane body is plain C++ (VCT_HD): csrc/host_driver.cpp builds it with
// g++ for rehearsal; the kernel and its launcher are CUDA only.
#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif
#include <string.h>

#include "team.cuh"

using namespace vct;

constexpr int MAX_OUTER = 15;

// the solver's constants (cuda_lib.SolveConfig), f32 as the kernel computes
struct SolveConfig {
  int n_outer, n_inner, n_polish, n_alpha, early_exit, ls_fast_path;
  float alphas[MAX_ALPHA], alphas2[MAX_ALPHA];
  float mus[MAX_OUTER + 1];  // each outer iteration's penalty, then the polish phase's
  float armijo, tol_cost, tol_con, rho0, rho_scale, rho_min, rho_max;
};

// the per-lane state the inner iterations carry between outer iterations
// (uniform: every member holds the same values)
struct LaneState {
  float rho, first_alpha;
  int n_acc, runs;
  bool first;
};

namespace {

VCT_HD float nan_to_num(float x) {
  if (x != x) return 0.f;
  if (x == INFINITY) return 1e6f;
  if (x == -INFINITY) return -1e6f;
  return x;
}

VCT_HD void load_w(int n, int b, int B, const float* X, const float* U, float wf[NW]) {
  for (int i = 0; i < NZ; ++i) wf[i] = X[at2(n, i, NZ, b, B)];
  for (int j = 0; j < NU; ++j) wf[NZ + j] = U[at2(n, j, NU, b, B)];
}

// the per-stage values in the chunk's first H floats, summed in stage order
// by every member
VCT_HD float ordered_sum(const Team& tm, int H) {
  float acc = 0.f;
  for (int n = 0; n < H; ++n) acc = acc + tm.sh[n];
  team_sync(tm);  // every member has read them before the chunk is reused
  return acc;
}

// the AL cost of the lane's current (X, U) at penalty mu
VCT_HD float total_al_cost(const Team& tm, int b, int B, int H, float mu, const float* X,
                           const float* U, const float* lam, const float* ds,
                           const STParams& p) {
  const float dss = ds[seam_stage(p) * B + b];
  phase(tm, [&](int t) {
    for_member_stages(t, H, p, [&](int n, auto kc) {
      float wf[NW], lamv[NC];
      load_w(n, b, B, X, U, wf);
      for (int j = 0; j < NC; ++j) lamv[j] = lam[at2(n, j, NC, b, B)];
      tm.sh[n] = al_cost<decltype(kc)::value>(n, H, wf, lamv, mu, ds[n * B + b],
                                              ds[(n > 0 ? n - 1 : 0) * B + b], dss, p);
    });
  });
  return ordered_sum(tm, H);
}

// the costs of step sizes a0..a1-1 into sh[S_COST + a], member t rolling
// out a0 + t, a0 + t + TEAM, ...; the steps a1..A-1 get +inf
VCT_HD_NOINLINE void sweep_candidates(const Team& tm, int b, int B, int H, int a0, int a1,
                                      int A, float mu, const SolveConfig& cfg, const float* z0,
                                      const float* X, const float* U, const float* kff,
                                      const float* kfb, const float* lam, const float* curv,
                                      const float* ds, const STParams& p) {
  float* costs = tm.sh + S_COST;
  phase(tm, [&](int t) {
    for (int a = a0 + t; a < a1; a += TEAM) {
      float z[NZ], acc = 0.f;
      for (int i = 0; i < NZ; ++i) z[i] = z0[i * B + b];
      for_each_stage(H, p, [&](int n, auto kc) {
        Stage s;
        load_stage(n, b, B, X, U, kff, kfb, lam, curv, ds, p, s);
        candidate_stage<decltype(kc)::value>(n, H, cfg.alphas[a], mu, s, p, z, acc);
      });
      costs[a] = vct::finite(acc) ? acc : INFINITY;
    }
    if (t == 0)
      for (int a = a1; a < A; ++a) costs[a] = INFINITY;
  });
}

// roll the chosen step and write it into X and U, in place: stage n reads
// its old X and U before it overwrites them
VCT_HD void reroll(int b, int B, int H, float alpha, const float* z0, float* X, float* U,
                   const float* kff, const float* kfb, const float* lam, const float* curv,
                   const float* ds, const STParams& p) {
  float z[NZ];
  for (int i = 0; i < NZ; ++i) z[i] = z0[i * B + b];
  for_each_stage(H, p, [&](int n, auto kc) {
    Stage s;
    load_stage(n, b, B, X, U, kff, kfb, lam, curv, ds, p, s);
    float wf[NW], nxt[NZ];
    feedback_u(alpha, z, s, wf + NZ);
    for (int i = 0; i < NZ; ++i) wf[i] = z[i];
    dyn<decltype(kc)::value>(wf, s.kv, s.dsn, p, nxt);
    for (int i = 0; i < NZ; ++i) {
      X[at2(n, i, NZ, b, B)] = z[i];
      z[i] = nxt[i];
    }
    for (int j = 0; j < NU; ++j) U[at2(n, j, NU, b, B)] = wf[NZ + j];
  });
}

// Armijo on the quadratic model, unless the model's predicted decrease
// exceeds the whole current cost: then plain descent is accepted
VCT_HD bool armijo_ok(const SolveConfig& cfg, int a, float cost_a, float cost_al, float dV1,
                      float dV2, bool fail) {
  float expected = -(cfg.alphas[a] * dV1 + cfg.alphas2[a] * dV2);
  float improvement = cost_al - cost_a;
  bool model_sane = expected <= fabsf(cost_al) + 1.f;
  bool ok = !model_sane || improvement > cfg.armijo * vmax(expected, 0.f);
  return ok && vct::finite(cost_a) && improvement > 0.f && !fail;
}

// up to `length` inner iterations at penalty mu
VCT_HD_NOINLINE void run_inner(const Team& tm, int b, int B, int H, float mu, int length,
                               const SolveConfig& cfg, const float* z0, float* X, float* U,
                               const float* lam, float* kff, float* kfb, const float* curv,
                               const float* ds, const STParams& p, LaneState& st) {
  const int A = cfg.n_alpha;
  const float* costs = tm.sh + S_COST;
  float cost_al = total_al_cost(tm, b, B, H, mu, X, U, lam, ds, p);
  bool done = false;
  for (int it = 0; it < length; ++it) {
    if (cfg.early_exit && done) break;
    st.runs += 1;
    float dV1, dV2;
    bool fail;
    backward_sweep(tm, b, B, H, X, U, lam, mu, st.rho, curv, ds, kff, kfb, dV1, dV2, fail, p);
    const int first = cfg.ls_fast_path && A > 1 ? 1 : A;
    sweep_candidates(tm, b, B, H, 0, first, A, mu, cfg, z0, X, U, kff, kfb, lam, curv, ds, p);
    if (first < A && !armijo_ok(cfg, 0, costs[0], cost_al, dV1, dV2, fail) && !done)
      sweep_candidates(tm, b, B, H, first, A, A, mu, cfg, z0, X, U, kff, kfb, lam, curv, ds, p);
    // the largest step that passes (the ladder descends)
    int sel = 0;
    bool any_ok = false;
    for (int a = 0; a < A; ++a) {
      if (!any_ok && armijo_ok(cfg, a, costs[a], cost_al, dV1, dV2, fail)) {
        sel = a;
        any_ok = true;
      }
    }
    const float alpha_sel = cfg.alphas[sel], cost_sel = costs[sel];
    if (any_ok && !done)
      phase(tm, [&](int t) {
        if (t == sel % TEAM) reroll(b, B, H, alpha_sel, z0, X, U, kff, kfb, lam, curv, ds, p);
      });
    float cost_new = any_ok ? cost_sel : cost_al;
    // asymmetric LM schedule: climb fast on failure, relax slowly
    float rho_new = any_ok ? vmax(st.rho / cfg.rho_scale, cfg.rho_min)
                           : vmin(vmax(st.rho, cfg.rho0) * cfg.rho_scale * cfg.rho_scale,
                                  cfg.rho_max);
    float rel_impr = (cost_al - cost_new) / (fabsf(cost_al) + 1e-12f);
    bool converged_now = any_ok && rel_impr < cfg.tol_cost && alpha_sel >= 0.99f;
    bool small_grad = !fail && -dV1 < cfg.tol_cost * (fabsf(cost_al) + 1.f);
    bool stuck = !any_ok && st.rho >= cfg.rho_max;
    if (st.first) {
      st.first_alpha = any_ok ? alpha_sel : 0.f;
      st.first = false;
    }
    if (!done) {
      cost_al = cost_new;
      st.rho = rho_new;
      st.n_acc += any_ok ? 1 : 0;
    }
    done = done || converged_now || small_grad || stuck;
  }
}

}  // namespace

// kernel 3 on scenario b, by its team.  Inputs z0 (NZ, B), u0 (H, NU, B),
// lam0 (H, NC, B), curv and ds (H, B); outputs X (H, NZ, B), U (H, NU, B),
// lam (H, NC, B) and stats (6, B): cost, violation, converged, iterations,
// the step accepted in the first inner iteration and the inner iterations
// run (cuda_lib.SOLVE_STATS); kff (H, NU, B) and kfb (H, NU, NZ, B) are
// scratch.  H <= CHUNK (the per-stage sums live in the chunk).
VCT_HD void solve_lane(const Team& tm, int b, int B, int H, const SolveConfig& cfg,
                       const STParams& p, const float* z0, const float* u0, const float* lam0,
                       const float* curv, const float* ds, float* X, float* U, float* lam,
                       float* kff, float* kfb, float* stats) {
  phase(tm, [&](int t) {  // clamp U, copy the multipliers
    for (int n = t; n < H; n += TEAM) {
      float lo[NU], hi[NU];
      stage_box(n, p, lo, hi);
      for (int j = 0; j < NU; ++j)
        U[at2(n, j, NU, b, B)] = Clip(u0[at2(n, j, NU, b, B)], lo[j], hi[j]);
      for (int j = 0; j < NC; ++j) lam[at2(n, j, NC, b, B)] = lam0[at2(n, j, NC, b, B)];
    }
  });
  phase(tm, [&](int t) {  // warm rollout: a divergent start must not poison the derivatives
    if (t != 0) return;
    float z[NZ];
    for (int i = 0; i < NZ; ++i) z[i] = z0[i * B + b];
    for_each_stage(H, p, [&](int n, auto kc) {
      float wf[NW], nxt[NZ];
      for (int i = 0; i < NZ; ++i) {
        X[at2(n, i, NZ, b, B)] = nan_to_num(z[i]);
        wf[i] = z[i];
      }
      for (int j = 0; j < NU; ++j) wf[NZ + j] = U[at2(n, j, NU, b, B)];
      dyn<decltype(kc)::value>(wf, curv[n * B + b], ds[n * B + b], p, nxt);
      for (int i = 0; i < NZ; ++i) z[i] = nxt[i];
    });
  });
  LaneState st = {cfg.rho0, 0.f, 0, 0, true};
  for (int k = 0; k < cfg.n_outer; ++k) {
    const float mu = cfg.mus[k];
    run_inner(tm, b, B, H, mu, cfg.n_inner, cfg, z0, X, U, lam, kff, kfb, curv, ds, p, st);
    phase(tm, [&](int t) {  // multipliers at this penalty
      for_member_stages(t, H, p, [&](int n, auto kc) {
        float wf[NW], c[NC];
        load_w(n, b, B, X, U, wf);
        stage_constraints<decltype(kc)::value>(n, wf, p, c);
        for (int j = 0; j < NC; ++j) {
          int at = at2(n, j, NC, b, B);
          lam[at] = vmax(0.f, lam[at] + mu * c[j]);
        }
      });
    });
  }
  if (cfg.n_polish > 0)
    run_inner(tm, b, B, H, cfg.mus[cfg.n_outer], cfg.n_polish, cfg, z0, X, U, lam, kff, kfb,
              curv, ds, p, st);
  const float dss = ds[seam_stage(p) * B + b];
  float* part = tm.sh + S_PART;
  phase(tm, [&](int t) {  // raw stage costs and each member's largest violation
    float viol = 0.f;
    for_member_stages(t, H, p, [&](int n, auto kc) {
      constexpr int K = decltype(kc)::value;
      float wf[NW], c[NC];
      load_w(n, b, B, X, U, wf);
      tm.sh[n] = stage_cost<K>(n, H, wf, ds[n * B + b], ds[(n > 0 ? n - 1 : 0) * B + b], dss, p);
      stage_constraints<K>(n, wf, p, c);
      for (int j = 0; j < NC; ++j) viol = vmax(viol, c[j]);
    });
    part[t] = viol;
  });
  const float cost = ordered_sum(tm, H);
  float viol = 0.f;
  for (int t = 0; t < TEAM; ++t) viol = vmax(viol, part[t]);
  viol = vmax(viol, 0.f);
  const float n_acc = (float)st.n_acc, first_alpha = st.first_alpha, runs = (float)st.runs;
  phase(tm, [&](int t) {
    if (t != 0) return;
    stats[b] = cost;
    stats[B + b] = viol;
    stats[2 * B + b] = (viol < cfg.tol_con && vct::finite(cost)) ? 1.f : 0.f;
    stats[3 * B + b] = n_acc;
    stats[4 * B + b] = first_alpha;
    stats[5 * B + b] = runs;
  });
}

// the launcher's checks: 0 or the error to return
VCT_HD int solve_args_error(const SolveConfig& cfg, int B, int H) {
  return (B < 1 || H < 1 || H > CHUNK || cfg.n_alpha < 1 || cfg.n_alpha > MAX_ALPHA ||
          cfg.n_outer < 0 || cfg.n_outer > MAX_OUTER)
             ? 1
             : 0;
}

#if defined(__CUDACC__)

__global__ void __launch_bounds__(TEAM_BLOCK) solve_fm_kernel(
    STParams p, SolveConfig cfg, const float* __restrict__ z0, const float* __restrict__ u0,
    const float* __restrict__ lam0, const float* __restrict__ curv, const float* __restrict__ ds,
    float* __restrict__ x, float* __restrict__ u, float* __restrict__ lam, float* __restrict__ kff,
    float* __restrict__ kfb, float* __restrict__ stats, int B, int H) {
  extern __shared__ float smem[];
  const int b = (blockIdx.x * TEAM_BLOCK + threadIdx.x) / TEAM;
  if (b >= B) return;  // the whole team
  solve_lane(make_team(smem), b, B, H, cfg, p, z0, u0, lam0, curv, ds, x, u, lam, kff, kfb,
             stats);
}

extern "C" int vct_solve_config_size() { return (int)sizeof(SolveConfig); }

extern "C" int vct_solve_fm(const float* params, const void* config, const float* z0,
                            const float* u0, const float* lam0, const float* curv,
                            const float* ds, float* x, float* u, float* lam, float* kff,
                            float* kfb, float* stats, int B, int H, void* stream) {
  SolveConfig cfg;
  memcpy(&cfg, config, sizeof(SolveConfig));
  if (solve_args_error(cfg, B, H)) return (int)cudaErrorInvalidValue;
  STParams p;
  memcpy(&p, params, sizeof(STParams));
  cudaError_t rc = team_smem_setup(solve_fm_kernel);
  if (rc != cudaSuccess) return (int)rc;
  const int blocks = (int)(((long long)B * TEAM + TEAM_BLOCK - 1) / TEAM_BLOCK);
  solve_fm_kernel<<<blocks, TEAM_BLOCK, TEAM_SMEM_BYTES, (cudaStream_t)stream>>>(
      p, cfg, z0, u0, lam0, curv, ds, x, u, lam, kff, kfb, stats, B, H);
  return (int)cudaGetLastError();
}

// the launch shape at B scenarios (team.cuh: team_launch_info)
extern "C" int vct_solve_fm_info(int B, int* out) {
  return team_launch_info(solve_fm_kernel, B, out);
}

#endif
