// The pure kinematic family's device functions: the CUDA transcription of
// vehicle_control_tpu_torch/solvers/fm_family.py's build_kinematic_family
// (stage_cost, constraints, al_cost, dyn, u_box, stage_derivs) and
// kc_prime / kc_prime_jacobian (the regularized kinematic bicycle).  H =
// N + 1 stages: N running stages (K_KIN) and the terminal stage (K_KIN_TERM).
// The solver state is z = [v, delta, s, ey, epsi, t, a_prev, w_prev] (NZ =
// 8), the controls (a, w) in physical units.
//
// Its parameter block, KinParams, is the family's type: every function here
// takes it where the cascaded family's take STParams (singletrack.cuh), so
// the kernels' templates (family.cuh, team.cuh, linesearch.cuh) compute this
// family wherever they are instantiated with it.  Every cost and constraint
// row is linear, quadratic or a hinge in the fields but the obstacle
// barrier (obstacle_derivs, shared with the cascaded family), so the stage
// derivatives are closed forms throughout, with no jets; the Jacobian is
// the Euler step's analytic chain through the clamps, the softplus floor and
// the steering stop.
#pragma once

#include "singletrack.cuh"

namespace vct {

constexpr int K_KIN = 6, K_KIN_TERM = 7;  // the kinds of the kinematic family's stages

// The kinematic bicycle's regularized spatial step (fm_family.kc_prime):
// the clamps of v, delta, ey and epsi (lo, hi; infinite where a family
// does not clamp the field) and the softplus floor on s_dot.
struct KcStep {
  float floor, beta;
  float lo[4], hi[4];  // v, delta, ey, epsi
};
// the pure kinematic family's: v unclamped, |delta| <= 1, |ey| <= 8,
// |epsi| <= 1.2, a floor far below the 0.1 m/s standing start, a sharp beta
// (a function: a namespace-scope object would not be visible on the card)
VCT_HD KcStep kin_step() {
  return KcStep{0.02f, 50.f, {-INFINITY, -1.f, -8.f, -1.2f}, {INFINITY, 1.f, 8.f, 1.2f}};
}

// Parameters, cost weights and bounds of the kinematic family, every field
// a float; the order is cuda_lib.KIN_PARAM_FIELDS.  Passed by value.
struct KinParams {
  static constexpr int NZ = 8, NU = 2, NC = 10, NX = 6, NW = NZ + NU, NSYM = NW * (NW + 1) / 2;
  float l;  // the wheelbase
  float w_time, w_v, w_ey, w_epsi, w_w, w_a, w_dev, w_boundary;
  float v_min, v_max, delta_min, delta_max, ey_min, ey_max, a_min, a_max, w_min, w_max;
  float u0_lo, u0_hi, u1_lo, u1_hi;  // rollout control boxes
  float N;                           // the running stages
  // the obstacle barrier, as STParams holds it
  float n_obs, w_obs;
  float obs[MAX_OBS][3];
};

// -- the horizon's static segments ---------------------------------------------------

template <class F>
VCT_HD void with_kind(int kind, const KinParams&, F&& f) {
  if (kind == K_KIN_TERM)
    f(KindC<K_KIN_TERM>{});
  else
    f(KindC<K_KIN>{});
}

VCT_HD int stage_kind(int n, int, const KinParams& p) {
  return n < (int)p.N ? K_KIN : K_KIN_TERM;
}

VCT_HD Segments segments(int H, const KinParams& p) {
  Segments s;
  s.count = 0;
  const int N = (int)p.N < H ? (int)p.N : H;
  add_segment(s, 0, N, K_KIN);
  add_segment(s, N, H, K_KIN_TERM);
  return s;
}

// no switching cost reads a seam's arc step
VCT_HD int seam_stage(const KinParams&) { return 0; }

VCT_HD void stage_box(int, const KinParams& p, float lo[2], float hi[2]) {
  lo[0] = p.u0_lo;
  hi[0] = p.u0_hi;
  lo[1] = p.u1_lo;
  hi[1] = p.u1_hi;
}

// -- the regularized Euler step ---------------------------------------------------------

// d(state)/ds of the clamped state with the softplus-floored 1/s_dot
// (fm_family.kc_prime); x the raw state (v, delta, s, ey, epsi, t)
VCT_HD void kc_prime(const float x[6], float a, float w, float k, float l, const KcStep& st,
                     float out[6]) {
  const float v = Clip(x[0], st.lo[0], st.hi[0]), delta = Clip(x[1], st.lo[1], st.hi[1]);
  const float ey = Clip(x[3], st.lo[2], st.hi[2]), epsi = Clip(x[4], st.lo[3], st.hi[3]);
  const float s_dot = (v * cosf(epsi)) / (1.f - ey * k);
  const float ey_dot = v * sinf(epsi);
  const float epsi_dot = v * Tan(delta) / l - s_dot * k;
  const float inv = 1.f / (st.floor + Softplus0(st.beta * (s_dot - st.floor)) / st.beta);
  out[0] = a * inv;
  out[1] = w * inv;
  out[2] = 1.f;
  out[3] = ey_dot * inv;
  out[4] = epsi_dot * inv;
  out[5] = inv;
}

// -- costs and constraints -------------------------------------------------------------

// the raw stage cost (no penalty) at stage n: a running stage's boundary,
// deviation, w and a-slew costs and the barrier on (s, ey) = (z[2], z[3]);
// the terminal stage's speed hinge, time, ey^2 and epsi^2
template <int K>
VCT_HD float stage_cost(int n, int, const float wf[KinParams::NW], float dsn, float, float,
                        const KinParams& p) {
  constexpr int NZ = KinParams::NZ;
  const float v = wf[0], ey = wf[3], epsi = wf[4];
  if constexpr (K == K_KIN_TERM) {
    const float over = v >= p.v_max ? sq(v - p.v_max) : 0.f;
    return p.w_v * over + p.w_time * wf[5] + p.w_ey * (ey * ey) + p.w_epsi * (epsi * epsi);
  } else {
    const float wact = wf[NZ + 1];
    float cost = boundary(ey, dsn, p.ey_min, p.ey_max, p);
    cost = cost + p.w_dev * dsn * (ey * ey);
    cost = cost + p.w_w * (wact * wact);
    if (n >= 1) cost = cost + p.w_a * sq(wf[NZ] - wf[6]);  // a-slew, no ds factor
    if (p.n_obs > 0.f) cost = cost + obstacle_barrier(wf[2], ey, dsn, p);
    return cost;
  }
}

// the stage constraints: the v floor, the steering box, the a and w boxes
// (the state rows masked at the fixed stage-0 state), padding; none at the
// terminal stage
template <int K>
VCT_HD void stage_constraints(int n, const float wf[KinParams::NW], const KinParams& p,
                              float c[KinParams::NC]) {
  constexpr int NZ = KinParams::NZ, NC = KinParams::NC;
  for (int j = 0; j < NC; ++j) c[j] = -1.f;
  if constexpr (K == K_KIN) {
    const float v = wf[0], delta = wf[1], a = wf[NZ], w = wf[NZ + 1];
    if (n != 0) {
      c[0] = p.v_min - v;
      c[1] = delta - p.delta_max;
      c[2] = p.delta_min - delta;
    }
    c[3] = a - p.a_max;
    c[4] = p.a_min - a;
    c[5] = w - p.w_max;
    c[6] = p.w_min - w;
  }
}

// the AL stage cost at stage n
template <int K>
VCT_HD_NOINLINE float al_cost(int n, int H, const float wf[KinParams::NW],
                              const float lam[KinParams::NC], float mu, float dsn, float dsp,
                              float dss, const KinParams& p) {
  constexpr int NC = KinParams::NC;
  float cost = stage_cost<K>(n, H, wf, dsn, dsp, dss, p);
  float c[NC];
  stage_constraints<K>(n, wf, p, c);
  float acc = 0.f;
  for (int j = 0; j < NC; ++j) acc = acc + phr(c[j], lam[j], mu);
  return cost + acc / (2.f * mu);
}

// the dynamics at a stage of kind K: the Euler step with the steering stop
// on a running stage, the state held on the terminal stage; stash = u.
// Inlined, unlike the cascaded family's: called through the ABI, it made
// kernel 3 drop the terminal stage on the card (the warm rollout's last
// state and the final cost's terminal term), while the host build and
// kernels 1, 2, 4 and 5 were right (ROADMAP "Faults found").  Every call
// site inlines the same expressions, so the line search and the re-roll of
// its choice agree to the bit, as chip_smoke.py checks (kernel 5 against
// kernel 1, kernel 3's exits).
template <int K>
VCT_HD void dyn(const float wf[KinParams::NW], float kv, float dsn, const KinParams& p,
                float out[KinParams::NZ]) {
  constexpr int NZ = KinParams::NZ;
  if constexpr (K == K_KIN) {
    float prime[6];
    kc_prime(wf, wf[NZ], wf[NZ + 1], kv, p.l, kin_step(), prime);
    for (int i = 0; i < 6; ++i) out[i] = wf[i] + dsn * prime[i];
    out[1] = Clip(out[1], p.delta_min, p.delta_max);
  } else {
    for (int i = 0; i < 6; ++i) out[i] = wf[i];
  }
  out[6] = wf[NZ];
  out[7] = wf[NZ + 1];
}

// -- hand-derived stage derivatives (fm_family.build_kinematic_family) ----------------------

// The Jacobian of the Euler step x + h kc_prime(x) with the steering stop
// (delta clipped to [dmin, dmax]) over the state fields and the controls
// (fm_family.kc_prime_jacobian): J[r][c], the next field r over the
// column c of (v, delta, s, ey, epsi, t, a, w); the clamps' partials with
// JAX's tie rule, the softplus floor's slope exp(y - softplus(y)), the
// stop's on the integrated delta.
VCT_HD void kc_step_jacobian(const float x[6], float a, float w, float k, float h, float l,
                             const KcStep& st, float dmin, float dmax, float J[6][8]) {
  const float cg[4] = {clip_grad(x[0], st.lo[0], st.hi[0]), clip_grad(x[1], st.lo[1], st.hi[1]),
                       clip_grad(x[3], st.lo[2], st.hi[2]), clip_grad(x[4], st.lo[3], st.hi[3])};
  const float v = Clip(x[0], st.lo[0], st.hi[0]), delta = Clip(x[1], st.lo[1], st.hi[1]);
  const float ey = Clip(x[3], st.lo[2], st.hi[2]), epsi = Clip(x[4], st.lo[3], st.hi[3]);
  const float ce = cosf(epsi), se = sinf(epsi), den = 1.f - ey * k;
  const float s_dot = (v * ce) / den, ey_dot = v * se;
  const float td = Tan(delta);
  const float epsi_dot = v * td / l - s_dot * k;
  const float y = st.beta * (s_dot - st.floor), sp = Softplus0(y);
  const float inv = 1.f / (st.floor + sp / st.beta);
  const float dinv = -(inv * inv) * expf(y - sp);  // d inv / d s_dot
  // the partials over the columns c = v, ey, epsi of s_dot, ey_dot and epsi_dot
  const int col[3] = {0, 3, 4};
  const float dsd[3] = {cg[0] * (ce / den), cg[2] * (s_dot * k / den), cg[3] * (-(v * se) / den)};
  const float dey[3] = {cg[0] * se, 0.f, cg[3] * (v * ce)};
  float D[6][8];  // the primes' partials over the columns
  for (int r = 0; r < 6; ++r)
    for (int c = 0; c < 8; ++c) D[r][c] = 0.f;
  D[0][6] = inv;
  D[1][7] = inv;
  for (int q = 0; q < 3; ++q) {
    const int c = col[q];
    const float tinv = dinv * dsd[q];
    const float dep = q == 0 ? cg[0] * (td / l) - k * dsd[0] : -k * dsd[q];
    D[0][c] = a * tinv;
    D[1][c] = w * tinv;
    D[5][c] = tinv;
    D[3][c] = dey[q] * inv + ey_dot * tinv;
    D[4][c] = dep * inv + epsi_dot * tinv;
  }
  D[4][1] = cg[1] * (v * (1.f + td * td) / l) * inv;
  const float next1 = x[1] + h * (w * inv);
  const float stop = clip_grad(next1, dmin, dmax);
  for (int r = 0; r < 6; ++r)
    for (int c = 0; c < 8; ++c) {
      const float Jrc = (r == c ? 1.f : 0.f) + h * D[r][c];
      J[r][c] = r == 1 ? Jrc * stop : Jrc;
    }
}

// g (NW), the Hessian as its packed upper triangle Hs (sym_n<NW>) and the
// Jacobian Jm at stage n of kind K, all in closed form: the box rows' PHR
// slopes max(0, lam + mu c) and curvatures mu * active(lam + mu c) (rows
// 0-2 constants at stage 0), the boundary, deviation, w and a-slew terms,
// the barrier on (s, ey) = (2, 3) after the (3, 3) entry is set; on the
// terminal stage the speed hinge, time, ey^2 and epsi^2, the state held.
// Inlined, as the cascaded family's (singletrack.cuh: stage_derivs).
template <int K>
VCT_HD void stage_derivs(int n, int, const float wf[KinParams::NW],
                         const float lam[KinParams::NC], float mu, float kv, float dsn, float,
                         float, const KinParams& p, float g[KinParams::NW],
                         float Hs[KinParams::NSYM], float Jm[KinParams::NZ][KinParams::NW]) {
  constexpr int NZ = KinParams::NZ, NW = KinParams::NW, NSYM = KinParams::NSYM;
  for (int r = 0; r < NZ; ++r)
    for (int c = 0; c < NW; ++c) Jm[r][c] = 0.f;
  for (int i = 0; i < NW; ++i) g[i] = 0.f;
  for (int i = 0; i < NSYM; ++i) Hs[i] = 0.f;
  Jm[6][NZ] = 1.f;  // stash_next = u
  Jm[7][NZ + 1] = 1.f;
  const float v = wf[0], ey = wf[3], epsi = wf[4];
  if constexpr (K == K_KIN_TERM) {
    for (int i = 0; i < 6; ++i) Jm[i][i] = 1.f;
    const bool live = v >= p.v_max;
    g[0] = live ? p.w_v * (2.f * (v - p.v_max)) : 0.f;
    g[3] = p.w_ey * (2.f * ey);
    g[4] = p.w_epsi * (2.f * epsi);
    g[5] = p.w_time;
    Hs[sym_n<NW>(0, 0)] = live ? 2.f * p.w_v : 0.f;
    Hs[sym_n<NW>(3, 3)] = 2.f * p.w_ey;
    Hs[sym_n<NW>(4, 4)] = 2.f * p.w_epsi;
  } else {
    float c[KinParams::NC];
    stage_constraints<K>(n, wf, p, c);
    // the box rows in order: (row, variable, slope of c in it)
    const int row_var[7] = {0, 1, 1, NZ, NZ, NZ + 1, NZ + 1};
    const float row_sl[7] = {-1.f, 1.f, -1.f, 1.f, -1.f, 1.f, -1.f};
    for (int r = n == 0 ? 3 : 0; r < 7; ++r) {
      const float x = phr_arg(lam[r], mu, c[r]);
      const int i = row_var[r];
      g[i] += row_sl[r] * vmax(x, 0.f);
      Hs[sym_n<NW>(i, i)] += mu * active(x);
    }
    const float blo = ey < p.ey_min ? 1.f : 0.f, bhi = ey > p.ey_max ? 1.f : 0.f;
    g[3] += boundary_slope(ey, dsn, p.ey_min, p.ey_max, p) + (p.w_dev * dsn) * (2.f * ey);
    Hs[sym_n<NW>(3, 3)] += 2.f * p.w_boundary * dsn * (blo + bhi) + 2.f * p.w_dev * dsn;
    g[NZ + 1] += p.w_w * (2.f * wf[NZ + 1]);
    Hs[sym_n<NW>(NZ + 1, NZ + 1)] += 2.f * p.w_w;
    if (n >= 1) {  // the a-slew against the previous action
      const float slew = p.w_a * (2.f * (wf[NZ] - wf[6]));
      g[NZ] += slew;
      g[6] -= slew;
      Hs[sym_n<NW>(NZ, NZ)] += 2.f * p.w_a;
      Hs[sym_n<NW>(6, 6)] += 2.f * p.w_a;
      Hs[sym_n<NW>(6, NZ)] -= 2.f * p.w_a;
    }
    if (p.n_obs > 0.f) obstacle_derivs(wf[2], ey, dsn, 2, 3, p, g, Hs);
    float J6[6][8];  // over (v, delta, s, ey, epsi, t, a, w): the controls at NZ, NZ + 1
    kc_step_jacobian(wf, wf[NZ], wf[NZ + 1], kv, dsn, p.l, kin_step(), p.delta_min, p.delta_max,
                     J6);
    for (int r = 0; r < 6; ++r)
      for (int c = 0; c < 8; ++c) Jm[r][c < 6 ? c : NZ + c - 6] = J6[r][c];
  }
}

}  // namespace vct
