// Kernel 3: the whole AL-iLQR solve of the single-track family in one
// launch.
//
// Replaces the Pallas TPU kernel build_solve_kernel_fm
// (vehicle_control_tpu/solvers/solve_kernel_fm.py).  Per scenario: clamp U,
// the warm rollout (stores nan_to_num(z), steps the raw z), then for each
// outer iteration an AL cost sweep and up to n_inner iterations of: the
// backward pass (backward_sweep, shared with kernel 2), the costs of every
// step size in one pass over the stages (candidate_stage, shared with
// kernel 1), Armijo selection of the largest passing step, the re-roll of
// that step into X and U, and the rho/done/accepted-count updates; then the
// multiplier update and the penalty growth.  The polish phase runs the
// inner loop once more at the boosted penalty; the finalize pass sums the
// raw cost and the largest violation.  Plain version: solve_plain.
//
// What bounds it on an H100: per scenario a serial chain of inner
// iterations, each a backward pass (30 stages of ~40k dependent f32
// operations, spilled to local memory, as in kernel 2) plus A candidate
// rollouts and a re-roll (30 stages of ~1.5k operations each): latency and
// instruction issue, not memory.  The whole state of a lane (X, U, lam in
// the output buffers, kff and kfb in a scratch tensor from the wrapper:
// 30 x 44 floats, 21.6 MB at B=4096) stays in the 50 MB L2.
// Design, correctness first: one thread per scenario, blocks of 32 (B=4096
// gives 128 blocks for 132 SMs), struct-of-arrays (stage, field, scenario)
// so a warp reads 32 consecutive floats.  Where the TPU kernel leaves its
// loop when a 1024-lane tile is done, a thread leaves as soon as its own
// lane is done (early_exit), and with ls_fast_path it costs the rest of the
// ladder only where alpha=1 fails Armijo: both change no output bit, since
// every update of a done lane is masked and a lane that takes alpha=1 reads
// no other candidate.  The candidate's feedback law, AL cost and RK4 step
// are not inlined, so the line search and the re-roll agree to the bit.
//
// The lane body is plain C++ (VCT_HD), so a host compiler builds it for
// rehearsal; the kernel and its launcher are CUDA only.
#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif
#include <string.h>

#include "singletrack.cuh"

using namespace vct;

constexpr int MAX_OUTER = 15;
constexpr int SOLVE_BLOCK = 32;

// the solver's constants (cuda_lib.SolveConfig), f32 as the kernel computes
struct SolveConfig {
  int n_outer, n_inner, n_polish, n_alpha, early_exit, ls_fast_path;
  float alphas[MAX_ALPHA], alphas2[MAX_ALPHA];
  float mus[MAX_OUTER + 1];  // each outer iteration's penalty, then the polish phase's
  float armijo, tol_cost, tol_con, rho0, rho_scale, rho_min, rho_max;
};

// the per-lane state the inner iterations carry between outer iterations
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

// the AL cost of the lane's current (X, U) at penalty mu
VCT_HD float total_al_cost(int b, int B, int H, float mu, const float* X, const float* U,
                           const float* lam, const float* ds, const STParams& p) {
  float acc = 0.f;
  for (int n = 0; n < H; ++n) {
    float wf[NW], lamv[NC];
    for (int i = 0; i < NZ; ++i) wf[i] = X[at2(n, i, NZ, b, B)];
    for (int j = 0; j < NU; ++j) wf[NZ + j] = U[at2(n, j, NU, b, B)];
    for (int j = 0; j < NC; ++j) lamv[j] = lam[at2(n, j, NC, b, B)];
    acc = acc + al_cost(n, H, wf, lamv, mu, ds[n * B + b], ds[(n > 0 ? n - 1 : 0) * B + b], p);
  }
  return acc;
}

// the costs of step sizes a0..a1-1 in one pass over the stages
VCT_HD_NOINLINE void sweep_candidates(int b, int B, int H, int a0, int a1, float mu,
                                      const SolveConfig& cfg, const float* z0, const float* X,
                                      const float* U, const float* kff, const float* kfb,
                                      const float* lam, const float* curv, const float* ds,
                                      const STParams& p, float costs[MAX_ALPHA]) {
  float zs[MAX_ALPHA][NZ], accs[MAX_ALPHA];
  for (int a = a0; a < a1; ++a) {
    for (int i = 0; i < NZ; ++i) zs[a][i] = z0[i * B + b];
    accs[a] = 0.f;
  }
  for (int n = 0; n < H; ++n) {
    Stage s;
    load_stage(n, b, B, X, U, kff, kfb, lam, curv, ds, s);
    for (int a = a0; a < a1; ++a) candidate_stage(n, H, cfg.alphas[a], mu, s, p, zs[a], accs[a]);
  }
  for (int a = a0; a < a1; ++a) costs[a] = finite(accs[a]) ? accs[a] : INFINITY;
}

// roll the chosen step and write it into X and U, in place: stage n reads
// its old X and U before it overwrites them
VCT_HD void reroll(int b, int B, int H, float alpha, const float* z0, float* X, float* U,
                   const float* kff, const float* kfb, const float* lam, const float* curv,
                   const float* ds, const STParams& p) {
  float z[NZ];
  for (int i = 0; i < NZ; ++i) z[i] = z0[i * B + b];
  for (int n = 0; n < H; ++n) {
    Stage s;
    load_stage(n, b, B, X, U, kff, kfb, lam, curv, ds, s);
    float wf[NW], nxt[NZ];
    feedback_u(alpha, z, s, p, wf + NZ);
    for (int i = 0; i < NZ; ++i) wf[i] = z[i];
    dyn(wf, s.kv, s.dsn, p, nxt);
    for (int i = 0; i < NZ; ++i) {
      X[at2(n, i, NZ, b, B)] = z[i];
      z[i] = nxt[i];
    }
    for (int j = 0; j < NU; ++j) U[at2(n, j, NU, b, B)] = wf[NZ + j];
  }
}

// Armijo on the quadratic model, unless the model's predicted decrease
// exceeds the whole current cost: then plain descent is accepted
VCT_HD bool armijo_ok(const SolveConfig& cfg, int a, float cost_a, float cost_al, float dV1,
                      float dV2, bool fail) {
  float expected = -(cfg.alphas[a] * dV1 + cfg.alphas2[a] * dV2);
  float improvement = cost_al - cost_a;
  bool model_sane = expected <= fabsf(cost_al) + 1.f;
  bool ok = !model_sane || improvement > cfg.armijo * vmax(expected, 0.f);
  return ok && finite(cost_a) && improvement > 0.f && !fail;
}

// up to `length` inner iterations at penalty mu
VCT_HD_NOINLINE void run_inner(int b, int B, int H, float mu, int length,
                               const SolveConfig& cfg, const float* z0, float* X, float* U,
                               const float* lam, float* kff, float* kfb, const float* curv,
                               const float* ds, const STParams& p, LaneState& st) {
  const int A = cfg.n_alpha;
  float cost_al = total_al_cost(b, B, H, mu, X, U, lam, ds, p);
  bool done = false;
  for (int it = 0; it < length; ++it) {
    if (cfg.early_exit && done) break;
    st.runs += 1;
    float dV1, dV2;
    bool fail;
    backward_sweep(b, B, H, X, U, lam, mu, st.rho, curv, ds, kff, kfb, dV1, dV2, fail, p);
    float costs[MAX_ALPHA];
    for (int a = 0; a < A; ++a) costs[a] = INFINITY;
    if (cfg.ls_fast_path && A > 1) {
      sweep_candidates(b, B, H, 0, 1, mu, cfg, z0, X, U, kff, kfb, lam, curv, ds, p, costs);
      if (!armijo_ok(cfg, 0, costs[0], cost_al, dV1, dV2, fail) && !done)
        sweep_candidates(b, B, H, 1, A, mu, cfg, z0, X, U, kff, kfb, lam, curv, ds, p, costs);
    } else {
      sweep_candidates(b, B, H, 0, A, mu, cfg, z0, X, U, kff, kfb, lam, curv, ds, p, costs);
    }
    // the largest step that passes (the ladder descends)
    float alpha_sel = cfg.alphas[0], cost_sel = costs[0];
    bool any_ok = false;
    for (int a = 0; a < A; ++a) {
      if (!any_ok && armijo_ok(cfg, a, costs[a], cost_al, dV1, dV2, fail)) {
        alpha_sel = cfg.alphas[a];
        cost_sel = costs[a];
        any_ok = true;
      }
    }
    if (any_ok && !done) reroll(b, B, H, alpha_sel, z0, X, U, kff, kfb, lam, curv, ds, p);
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

// kernel 3 on scenario b.  Inputs z0 (NZ, B), u0 (H, NU, B), lam0 (H, NC, B),
// curv and ds (H, B); outputs X (H, NZ, B), U (H, NU, B), lam (H, NC, B) and
// stats (6, B): cost, violation, converged, iterations, the step accepted in
// the first inner iteration and the inner iterations run (cuda_lib.SOLVE_STATS);
// kff (H, NU, B) and kfb (H, NU, NZ, B) are scratch.
VCT_HD void solve_lane(int b, int B, int H, const SolveConfig& cfg, const STParams& p,
                       const float* z0, const float* u0, const float* lam0, const float* curv,
                       const float* ds, float* X, float* U, float* lam, float* kff, float* kfb,
                       float* stats) {
  const float lo[NU] = {p.u0_lo, p.u1_lo}, hi[NU] = {p.u0_hi, p.u1_hi};
  for (int n = 0; n < H; ++n) {
    for (int j = 0; j < NU; ++j)
      U[at2(n, j, NU, b, B)] = Clip(u0[at2(n, j, NU, b, B)], lo[j], hi[j]);
    for (int j = 0; j < NC; ++j) lam[at2(n, j, NC, b, B)] = lam0[at2(n, j, NC, b, B)];
  }
  {  // warm rollout: a divergent start must not poison the derivatives
    float z[NZ];
    for (int i = 0; i < NZ; ++i) z[i] = z0[i * B + b];
    for (int n = 0; n < H; ++n) {
      float wf[NW], nxt[NZ];
      for (int i = 0; i < NZ; ++i) {
        X[at2(n, i, NZ, b, B)] = nan_to_num(z[i]);
        wf[i] = z[i];
      }
      for (int j = 0; j < NU; ++j) wf[NZ + j] = U[at2(n, j, NU, b, B)];
      dyn(wf, curv[n * B + b], ds[n * B + b], p, nxt);
      for (int i = 0; i < NZ; ++i) z[i] = nxt[i];
    }
  }
  LaneState st = {cfg.rho0, 0.f, 0, 0, true};
  for (int k = 0; k < cfg.n_outer; ++k) {
    float mu = cfg.mus[k];
    run_inner(b, B, H, mu, cfg.n_inner, cfg, z0, X, U, lam, kff, kfb, curv, ds, p, st);
    for (int n = 0; n < H; ++n) {  // multipliers at this outer iteration's penalty
      float wf[NW], c[NC];
      for (int i = 0; i < NZ; ++i) wf[i] = X[at2(n, i, NZ, b, B)];
      for (int j = 0; j < NU; ++j) wf[NZ + j] = U[at2(n, j, NU, b, B)];
      stage_constraints(n, wf, p, c);
      for (int j = 0; j < NC; ++j) {
        int at = at2(n, j, NC, b, B);
        lam[at] = vmax(0.f, lam[at] + mu * c[j]);
      }
    }
  }
  if (cfg.n_polish > 0)
    run_inner(b, B, H, cfg.mus[cfg.n_outer], cfg.n_polish, cfg, z0, X, U, lam, kff, kfb, curv,
              ds, p, st);
  float cost = 0.f, viol = 0.f;
  for (int n = 0; n < H; ++n) {
    float wf[NW], c[NC];
    for (int i = 0; i < NZ; ++i) wf[i] = X[at2(n, i, NZ, b, B)];
    for (int j = 0; j < NU; ++j) wf[NZ + j] = U[at2(n, j, NU, b, B)];
    cost = cost + stage_cost(n, H, wf, ds[n * B + b], ds[(n > 0 ? n - 1 : 0) * B + b], p);
    stage_constraints(n, wf, p, c);
    for (int j = 0; j < NC; ++j) viol = vmax(viol, c[j]);
  }
  viol = vmax(viol, 0.f);
  stats[b] = cost;
  stats[B + b] = viol;
  stats[2 * B + b] = (viol < cfg.tol_con && finite(cost)) ? 1.f : 0.f;
  stats[3 * B + b] = (float)st.n_acc;
  stats[4 * B + b] = st.first_alpha;
  stats[5 * B + b] = (float)st.runs;
}

#if defined(__CUDACC__)

__global__ void __launch_bounds__(SOLVE_BLOCK) solve_fm_kernel(
    STParams p, SolveConfig cfg, const float* __restrict__ z0, const float* __restrict__ u0,
    const float* __restrict__ lam0, const float* __restrict__ curv, const float* __restrict__ ds,
    float* __restrict__ x, float* __restrict__ u, float* __restrict__ lam, float* __restrict__ kff,
    float* __restrict__ kfb, float* __restrict__ stats, int B, int H) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  solve_lane(b, B, H, cfg, p, z0, u0, lam0, curv, ds, x, u, lam, kff, kfb, stats);
}

extern "C" int vct_solve_config_size() { return (int)sizeof(SolveConfig); }

extern "C" int vct_solve_fm(const float* params, const void* config, const float* z0,
                            const float* u0, const float* lam0, const float* curv,
                            const float* ds, float* x, float* u, float* lam, float* kff,
                            float* kfb, float* stats, int B, int H, void* stream) {
  SolveConfig cfg;
  memcpy(&cfg, config, sizeof(SolveConfig));
  if (B < 1 || H < 1 || cfg.n_alpha < 1 || cfg.n_alpha > MAX_ALPHA || cfg.n_outer < 0 ||
      cfg.n_outer > MAX_OUTER)
    return (int)cudaErrorInvalidValue;
  STParams p;
  memcpy(&p, params, sizeof(STParams));
  solve_fm_kernel<<<(B + SOLVE_BLOCK - 1) / SOLVE_BLOCK, SOLVE_BLOCK, 0, (cudaStream_t)stream>>>(
      p, cfg, z0, u0, lam0, curv, ds, x, u, lam, kff, kfb, stats, B, H);
  return (int)cudaGetLastError();
}

#endif
