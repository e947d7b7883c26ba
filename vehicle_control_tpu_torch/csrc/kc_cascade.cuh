// The kc cascade's device functions: the CUDA transcription of
// vehicle_control_tpu_torch/solvers/fm_family.py's build_cascaded_family for
// tail="kc" (stage_cost, constraints, al_cost, dyn, u_box, stage_derivs):
// N single-track stages, then K = horizon_kc kinematic-bicycle stages, H =
// N + K.  The solver state is the cascade's padded z (NZ = 10): the
// single-track state (Ux, Uy, r, delta, s, ey, epsi, t) before the seam,
// then (v, delta, s, ey, epsi, t, a_final, w_prev) on the tail, and the
// previous controls in z[8], z[9].  Control 0 is u_Fx (kN) before N and the
// acceleration a in units of FS from N on; control 1 is the steer rate w.
//
// Its parameter block, KcParams, holds the single-track family's STParams
// (pm = 0, no obstacles) and the tail's fields, so the kernels' templates
// (family.cuh, team.cuh, linesearch.cuh) build a third instantiation (the
// _kc entries) and the cascaded family's instantiation compiles to its own
// code, token for token.  The single-track stages call the cascaded
// family's functions on p.st; the seam, the switch, the tail and the
// terminal stage are kinds of their own:
// - the seam N-1 maps the state to the tail's (seam_map_kc) and stashes the
//   acceleration magnitude a_final = |(Ux', Uy')| of the temporal ODE under
//   the PREVIOUS controls (z[8] FS, z[9]) and z[9]; its cost and
//   constraints are a single-track stage's.  Its Jacobian reads the stash:
//   the team's slot keeps the stash columns for this family (team.cuh);
// - the switch N adds (w_Fy / ds[N]) ((z6 - a)^2 + (z7 - w)^2): the arc step
//   of stage N (seam_stage), not the point-mass switch's ds[N-1];
// - the tail's Euler step is kc_prime at floor 0.3, beta 10, v in [0.5,
//   1e3] (kc_tail_step), not the pure kinematic family's kin_step(), then
//   the steering stop at the tail's delta bounds; its u0 box is the a box in
//   solver units (stage_box);
// - the a-slew w_a (a - a_prev)^2 runs under JAX's traced mask (n >= N+1)
//   & (n-1 < K-1), as written: the reference's k < K - 1 on the global stage
//   index, so at N = K it is never live.
// dyn and stage_derivs are inlined, as the kinematic family's: called
// through the ABI, such functions have failed on the card while the host
// build was right (ROADMAP "Faults found").
#pragma once

#include "kinematic.cuh"
#include "singletrack.cuh"

namespace vct {

// the kinds of the kc cascade's stages past the single-track ones (K_ST)
constexpr int K_KC_SEAM = 8, K_KC_SWITCH = 9, K_KC_TAIL = 10, K_KC_TERM = 11;

// Parameters, weights and bounds of the kc cascade, every field a float;
// the order is cuda_lib.KC_PARAM_FIELDS (PARAM_FIELDS, then the tail's).
// Passed by value.
struct KcParams {
  static constexpr int NZ = vct::NZ, NU = vct::NU, NC = vct::NC, NX = 8, NW = vct::NW,
                       NSYM = STParams::NSYM;
  STParams st;  // the single-track stages (N = st.N; pm = 0, n_obs = 0)
  float w_dev_kc, w_w_kc, w_a, w_Fy;  // the tail's deviation, w, a-slew and switching weights
  float v_min, delta_min_kc, delta_max_kc, ey_min_kc, ey_max_kc;  // state_kc_constraints
  float a_min, a_max;                 // the a box (physical units)
  float u0_lo_kc, u0_hi_kc;           // the tail's u0 box (solver units)
  float K;                            // horizon_kc: the a-slew's mask
};

// the seam reads the previous controls: the team keeps its Jacobian's stash
// columns (team.cuh)
template <>
struct ReadsStash<KcParams> {
  static constexpr bool value = true;
};

// the kc tail's regularized step (fm_family.KC_TAIL_*): v in [0.5, 1e3],
// |delta| <= 1, |ey| <= 8, |epsi| <= 1.2, the single-track stages' floor and
// beta (a function: a namespace-scope object would not be visible on the card)
VCT_HD KcStep kc_tail_step() {
  return KcStep{FLOOR, BETA, {0.5f, -1.f, -8.f, -1.2f}, {1e3f, 1.f, 8.f, 1.2f}};
}

// -- the horizon's static segments ---------------------------------------------------

VCT_HD int stage_kind(int n, int H, const KcParams& p) {
  const int N = n_st(p.st);
  if (n < N - 1) return K_ST;
  if (n == N - 1) return K_KC_SEAM;
  if (n == N) return K_KC_SWITCH;  // also terminal when it is the last stage
  return n == H - 1 ? K_KC_TERM : K_KC_TAIL;
}

// the cuts {0, N-1, N, N+1, H-1, H}
VCT_HD Segments segments(int H, const KcParams& p) {
  Segments s;
  s.count = 0;
  const int N = n_st(p.st);
  const int last = N + 1 > H - 1 ? N + 1 : H - 1;
  add_segment(s, 0, N - 1, K_ST);
  add_segment(s, N - 1, N, K_KC_SEAM);
  add_segment(s, N, N + 1, K_KC_SWITCH);
  add_segment(s, N + 1, last, K_KC_TAIL);
  add_segment(s, last, H, K_KC_TERM);
  return s;
}

template <class F>
VCT_HD void with_kind(int kind, const KcParams&, F&& f) {
  switch (kind) {
    case K_KC_SEAM: f(KindC<K_KC_SEAM>{}); break;
    case K_KC_SWITCH: f(KindC<K_KC_SWITCH>{}); break;
    case K_KC_TAIL: f(KindC<K_KC_TAIL>{}); break;
    case K_KC_TERM: f(KindC<K_KC_TERM>{}); break;
    default: f(KindC<K_ST>{}); break;
  }
}

// the stage whose arc step the switching cost reads: ds[min(N, H-1)], which
// is N wherever the tail has a stage
VCT_HD int seam_stage(const KcParams& p) { return n_st(p.st); }

// the rollout control box of stage n: u0 is u_Fx before N, a from N on
VCT_HD void stage_box(int n, const KcParams& p, float lo[NU], float hi[NU]) {
  const bool tail = n >= n_st(p.st);
  lo[0] = tail ? p.u0_lo_kc : p.st.u0_lo;
  hi[0] = tail ? p.u0_hi_kc : p.st.u0_hi;
  lo[1] = p.st.u1_lo;
  hi[1] = p.st.u1_hi;
}

// JAX's traced a-slew mask, (n >= N+1) & (n-1 < K-1)
VCT_HD bool a_slew_on(int n, const KcParams& p) {
  return n >= n_st(p.st) + 1 && n - 1 < (int)p.K - 1;
}

// -- the seam ----------------------------------------------------------------------------

// |(a, b)|; on a first-order jet the partials by the chain (a a' + b b') /
// |(a, b)|, and 0 where the norm is 0, the subgradient of a norm at its kink
// (fm_family._norm2; JAX's autodiff of jnp.sqrt there gives inf x 0 = NaN)
VCT_HD float Norm2(float a, float b) { return sqrtf(a * a + b * b); }
template <int N>
VCT_HD Jet<N, 1> Norm2(const Jet<N, 1>& a, const Jet<N, 1>& b) {
  Jet<N, 1> r;
  r.v = sqrtf(a.v * a.v + b.v * b.v);
  const float ia = r.v > 0.f ? a.v / r.v : 0.f, ib = r.v > 0.f ? b.v / r.v : 0.f;
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * ia + b.d[i] * ib;
  r.h[0] = 0.f;
  return r;
}

// the handoff at stage N-1 (fm_family.kc_seam_fields) from the raw state x:
// V, delta, s, ey, beta + epsi, t, then a_final = |(Ux', Uy')| of the
// temporal ODE under the previous controls (Fx_prev in N, w_prev) and w_prev
template <class T>
VCT_HD void seam_map_kc(const T x[8], const T& Fx_prev, const T& w_prev, const STParams& p,
                        T out[8]) {
  const T &Ux = x[0], &Uy = x[1];
  out[0] = Sqrt(Ux * Ux + Uy * Uy);
  out[1] = x[3];
  out[2] = x[4];
  out[3] = x[5];
  out[4] = Arctan(SafeDiv(Uy, Ux, 1e-6f)) + x[6];
  out[5] = x[7];
  T xdot[8];
  temporal_fields(x, Fx_prev, w_prev, 0.f, p, xdot);
  out[6] = Norm2(xdot[0], xdot[1]);
  out[7] = w_prev;
}

// -- costs and constraints -------------------------------------------------------------

// the raw stage cost (no penalty) at stage n of H: a single-track stage's
// (the seam's included); on the tail the boundary, deviation and w costs,
// the a-slew under its mask, the switching cost at N against the seam's
// stashes (dss: the arc step of stage N), the terminal cost on (v, ey,
// epsi, t)
template <int K>
VCT_HD float stage_cost(int n, int H, const float wf[NW], float dsn, float dsp, float dss,
                        const KcParams& p) {
  if constexpr (K == K_ST || K == K_KC_SEAM) {
    return stage_cost<K_ST>(n, H, wf, dsn, dsp, dss, p.st);
  } else {
    const float ey = wf[3], a = wf[NZ] * FS, w = wf[NZ + 1];
    float cost = boundary(ey, dsn, p.ey_min_kc, p.ey_max_kc, p.st);
    cost = cost + p.w_dev_kc * dsn * (ey * ey);
    cost = cost + p.w_w_kc * (w * w);
    if (a_slew_on(n, p)) cost = cost + p.w_a * sq(a - wf[8] * FS);
    if constexpr (K == K_KC_SWITCH) cost = cost + (p.w_Fy / dss) * (sq(wf[6] - a) + sq(wf[7] - w));
    if (K == K_KC_TERM || n == H - 1) cost = cost + terminal(wf[0], wf[3], wf[4], wf[5], p.st);
    return cost;
  }
}

// the stage constraints: a single-track stage's (the state rows masked at
// the fixed stage-0 state); on the tail the v floor, the steering box, the
// a box (a = u_a FS rounded on its own, as the plain version rounds it) and
// the w box, padding
template <int K>
VCT_HD void stage_constraints(int n, const float wf[NW], const KcParams& p, float c[NC]) {
  if constexpr (K == K_ST || K == K_KC_SEAM) {
    stage_constraints<K_ST>(n, wf, p.st, c);
  } else {
    const float v = wf[0], delta = wf[1], a = mul_rn(wf[NZ], FS), w = wf[NZ + 1];
    c[0] = p.v_min - v;
    c[1] = delta - p.delta_max_kc;
    c[2] = p.delta_min_kc - delta;
    c[3] = a - p.a_max;
    c[4] = p.a_min - a;
    c[5] = w - p.st.w_max;
    c[6] = p.st.w_min - w;
    for (int j = 7; j < NC; ++j) c[j] = -1.f;
  }
}

// the AL stage cost at stage n of H
template <int K>
VCT_HD_NOINLINE float al_cost(int n, int H, const float wf[NW], const float lam[NC], float mu,
                              float dsn, float dsp, float dss, const KcParams& p) {
  if constexpr (K == K_ST || K == K_KC_SEAM) {
    return al_cost<K_ST>(n, H, wf, lam, mu, dsn, dsp, dss, p.st);
  } else {
    float cost = stage_cost<K>(n, H, wf, dsn, dsp, dss, p);
    float c[NC];
    stage_constraints<K>(n, wf, p, c);
    float acc = 0.f;
    for (int j = 0; j < NC; ++j) acc = acc + phr(c[j], lam[j], mu);
    return cost + acc / (2.f * mu);
  }
}

// the dynamics at a stage of kind K: the single-track RK4 step with the
// steering stop (the cascaded family's dyn), the seam, or the tail's Euler
// step with the steering stop at the tail's delta bounds (its stashes
// zeroed); stash = u.  Inlined (see the head of this file): every call site
// inlines the same expressions, so the line search and the re-roll of its
// choice agree to the bit, as chip_smoke.py checks.
template <int K>
VCT_HD void dyn(const float wf[NW], float kv, float dsn, const KcParams& p, float out[NZ]) {
  if constexpr (K == K_ST) {
    dyn<K_ST>(wf, kv, dsn, p.st, out);
  } else {
    if constexpr (K == K_KC_SEAM) {
      seam_map_kc(wf, wf[8] * FS, wf[9], p.st, out);
    } else {
      float prime[6];
      kc_prime(wf, wf[NZ] * FS, wf[NZ + 1], kv, p.st.l, kc_tail_step(), prime);
      for (int i = 0; i < 6; ++i) out[i] = wf[i] + dsn * prime[i];
      out[1] = Clip(out[1], p.delta_min_kc, p.delta_max_kc);
      out[6] = 0.f;
      out[7] = 0.f;
    }
    out[8] = wf[NZ];
    out[9] = wf[NZ + 1];
  }
}

// -- hand-derived stage derivatives --------------------------------------------------------

// The gradient and the packed Hessian of a tail stage's AL cost, in closed
// form: every term is linear, quadratic or a hinge in the fields.  The box
// rows' PHR slopes max(0, lam + mu c) dc/dw and curvatures mu active(lam +
// mu c) (dc/dw)^2 (dc/du_a = FS), the boundary, deviation and w terms, the
// a-slew under its mask, the switching cost at N, the terminal cost.
template <int K>
VCT_HD void kc_tail_cost_derivs(int n, int H, const float wf[NW], const float lam[NC], float mu,
                                float dsn, float dss, const KcParams& p, float g[NW],
                                float Hs[NSYM]) {
  const STParams& s = p.st;
  const float v = wf[0], ey = wf[3], a = wf[NZ] * FS, w = wf[NZ + 1];
  g[3] = boundary_slope(ey, dsn, p.ey_min_kc, p.ey_max_kc, s) + (p.w_dev_kc * dsn) * (2.f * ey);
  const float blo = ey < p.ey_min_kc ? 1.f : 0.f, bhi = ey > p.ey_max_kc ? 1.f : 0.f;
  Hs[sym_w(3, 3)] = 2.f * s.w_boundary * dsn * (blo + bhi) + 2.f * p.w_dev_kc * dsn;
  g[NZ + 1] = p.w_w_kc * (2.f * w);
  Hs[sym_w(NZ + 1, NZ + 1)] = 2.f * p.w_w_kc;
  float c[NC];
  stage_constraints<K>(n, wf, p, c);
  // the box rows in order: (row, variable, slope of c in it)
  const int row_var[7] = {0, 1, 1, NZ, NZ, NZ + 1, NZ + 1};
  const float row_sl[7] = {-1.f, 1.f, -1.f, FS, -FS, 1.f, -1.f};
  for (int r = 0; r < 7; ++r) {
    const float x = phr_arg(lam[r], mu, c[r]);
    const int i = row_var[r];
    g[i] += row_sl[r] * vmax(x, 0.f);
    Hs[sym_w(i, i)] += mu * active(x) * (row_sl[r] * row_sl[r]);
  }
  if (a_slew_on(n, p)) {  // the a-slew against the previous action (no ds factor)
    const float slew = p.w_a * (2.f * (a - wf[8] * FS)) * FS;
    g[NZ] += slew;
    g[8] -= slew;
    const float coef = (2.f * p.w_a) * (FS * FS);
    Hs[sym_w(8, 8)] += coef;
    Hs[sym_w(8, NZ)] -= coef;
    Hs[sym_w(NZ, NZ)] += coef;
  }
  if constexpr (K == K_KC_SWITCH) {  // a against the a_final stash, w against the w stash
    const float cw = p.w_Fy / dss;
    const float d6 = cw * (2.f * (wf[6] - a)), d7 = cw * (2.f * (wf[7] - w));
    g[6] += d6;
    g[NZ] -= d6 * FS;
    g[7] += d7;
    g[NZ + 1] -= d7;
    const float c2 = 2.f * p.w_Fy / dss;
    Hs[sym_w(6, 6)] += c2;
    Hs[sym_w(6, NZ)] -= c2 * FS;
    Hs[sym_w(NZ, NZ)] += c2 * (FS * FS);
    Hs[sym_w(7, 7)] += c2;
    Hs[sym_w(7, NZ + 1)] -= c2;
    Hs[sym_w(NZ + 1, NZ + 1)] += c2;
  }
  if (K == K_KC_TERM || n == H - 1) {  // the terminal cost on (v, ey, epsi, t)
    const int at[4] = {0, 3, 4, 5};
    terminal_slope(v, ey, wf[4], at, s, g);
    Hs[sym_w(0, 0)] += (2.f * s.w_speed) * (v >= s.max_speed ? 1.f : 0.f);
    Hs[sym_w(3, 3)] += 2.f * s.w_ey;
    Hs[sym_w(4, 4)] += 2.f * s.w_epsi;
  }
}

// g (NW), the Hessian as its packed upper triangle Hs (sym_w) and the
// Jacobian Jm at stage n of kind K.  The single-track stages are the
// cascaded family's.  The seam: its cost's derivatives are a single-track
// stage's; its Jacobian by first-order jets over (Ux, Uy, r, delta, z[8])
// through the temporal ODE, a_final's partials chained by hand (Norm2), so
// row 6 reads the Fx stash and row 7 is the w stash's unit column.  The
// tail: kc_step_jacobian at the tail's regularization with the steering
// stop (its a column times FS), s and t unit columns, the closed-form cost
// derivatives.  Inlined (see the head of this file).
template <int K>
VCT_HD void stage_derivs(int n, int H, const float wf[NW], const float lam[NC], float mu,
                         float kv, float dsn, float dsp, float dss, const KcParams& p,
                         float g[NW], float Hs[NSYM], float Jm[NZ][NW]) {
  if constexpr (K == K_ST) {
    stage_derivs<K_ST>(n, H, wf, lam, mu, kv, dsn, dsp, dss, p.st, g, Hs, Jm);
  } else {
    for (int r = 0; r < NZ; ++r)
      for (int c = 0; c < NW; ++c) Jm[r][c] = 0.f;
    for (int i = 0; i < NW; ++i) g[i] = 0.f;
    for (int i = 0; i < NSYM; ++i) Hs[i] = 0.f;
    Jm[8][NZ] = 1.f;  // stash_next = u
    Jm[9][NZ + 1] = 1.f;
    if constexpr (K == K_KC_SEAM) {
      using J5 = Jet<5, 1>;
      const int vidx[5] = {0, 1, 2, 3, 8};
      J5 x[8], nxt[8];
      for (int i = 0; i < 8; ++i) x[i] = cst<J5>(wf[i]);
      for (int i = 0; i < 4; ++i) x[i] = seed<5, 1>(wf[i], i);
      seam_map_kc(x, seed<5, 1>(wf[8], 4) * FS, cst<J5>(wf[9]), p.st, nxt);
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 5; ++c) Jm[r][vidx[c]] = nxt[r].d[c];
      Jm[2][4] = 1.f;  // s, ey and t pass through; epsi adds to beta
      Jm[3][5] = 1.f;
      Jm[4][6] = 1.f;
      Jm[5][7] = 1.f;
      Jm[7][9] = 1.f;  // the w stash
      st_cost_derivs<K_ST>(n, wf, lam, mu, dsn, dsp, p.st, g, Hs);
    } else {
      float J6[6][8];  // over (v, delta, s, ey, epsi, t, a, w)
      kc_step_jacobian(wf, wf[NZ] * FS, wf[NZ + 1], kv, dsn, p.st.l, kc_tail_step(),
                       p.delta_min_kc, p.delta_max_kc, J6);
      for (int r = 0; r < 6; ++r) {
        for (int c = 0; c < 6; ++c) Jm[r][c] = J6[r][c];
        Jm[r][NZ] = J6[r][6] * FS;
        Jm[r][NZ + 1] = J6[r][7];
      }
      kc_tail_cost_derivs<K>(n, H, wf, lam, mu, dsn, dss, p, g, Hs);
    }
  }
}

}  // namespace vct
