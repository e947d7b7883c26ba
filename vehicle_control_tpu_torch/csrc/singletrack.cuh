// The cascaded family's device functions: the CUDA transcription of
// vehicle_control_tpu_torch/solvers/fm_singletrack.py, models/dynamic_car.py
// and the closures of solvers/fm_family.py (stage_cost, constraints,
// al_cost, dyn, u_box, stage_derivs) for tail="none" (N = H single-track
// stages) and tail="pm" (N single-track stages, then H - N point-mass
// stages).  Its parameter block, STParams, is the family's type: the
// kernels are templates over it (family.cuh), and the kinematic family
// (kinematic.cuh, KinParams) gives the same functions for its own.
// Templates over the scalar type give values (float) and exact derivatives
// (Jet); the stage derivatives take most of theirs in closed form (the RK4
// Jacobian by its analytic chain, the gradient and the Hessian outside one
// second-order jet pass).  The polynomial arctan is kept, as on every path
// of the JAX package, so the numbers stay comparable; no atanf.
//
// Stages are visited one static segment at a time, as the JAX kernels do
// (fm_family.Seg): single track, the seam N-1, the switch N, the point-mass
// tail and the terminal stage.  Each stage function is templated on its
// segment's kind, so no stage executes a dead branch and the point-mass
// stages do not carry the single-track jets.  All lanes of a block are at
// the same stage at once, so the choice of kind never diverges a warp.
//
// Layout: struct of arrays, (stage, field, scenario) with the scenario
// index fastest, so neighbouring threads read neighbouring addresses.
#pragma once

#include <type_traits>

#include "jet.cuh"

namespace vct {

// the cascaded family's widths (STParams::NZ, ...)
constexpr int NZ = 10;  // solver state: 8 model fields + previous (Fx, u1)
constexpr int NU = 2;   // controls: u_Fx (kN), then w or, on point-mass stages, u_Fy (kN)
constexpr int NC = 10;  // stage constraints
constexpr int NW = NZ + NU;
constexpr int MAX_ALPHA = 16;
constexpr float FS = 1000.f;   // FORCE_SCALE: forces solved in kN
constexpr float DSS = 1000.f;  // drive/brake split tanh scale
constexpr float FLOOR = 0.3f;  // softplus floor on s_dot
constexpr float BETA = 10.f;
constexpr float HALF_PI = 1.57079632679489661923f;
constexpr int MAX_OBS = 16;           // discs of the obstacle table (cuda_lib.MAX_OBS)
constexpr float OBSTACLE_EPS = 1e-2f;  // the floor of the barrier's denominator

// the packed upper triangle of a symmetric matrix of order N, row by row:
// the Hessian as stage_derivs gives it and kernels 2 and 3 keep it
template <int N>
VCT_HD int sym_n(int r, int c) {
  if (r > c) { int x = r; r = c; c = x; }
  return r * (2 * N - r + 1) / 2 + c - r;
}

// Car parameters, cost weights and bounds of the family, every field a
// float; the order is cuda_lib.PARAM_FIELDS.  Passed to the kernels by value.
// The static members are the family's widths: the solver state (NZ, its
// first NX fields the model's, then the previous controls), the controls,
// the constraint rows, a stage's variables and its packed Hessian.
struct STParams {
  static constexpr int NZ = vct::NZ, NU = vct::NU, NC = vct::NC, NX = 8, NW = vct::NW,
                       NSYM = NW * (NW + 1) / 2;
  float m, Izz, a, b, l, h, eps, Peng, Xdf, Xdr, Xbf, Xbr, Caf, Car, mu_f, mu_r,
      gcc, Av2, Cd, Frr;
  float w_time, w_speed, w_ey, w_epsi, w_w, w_Fx, w_dev, w_boundary, w_slip;
  float Ux_min, max_speed, delta_min, delta_max, ey_min, ey_max, w_min, w_max;
  float u0_lo, u0_hi, u1_lo, u1_hi;  // rollout control boxes (solver units)
  // the point-mass tail (tail="pm"; zero for the single-track family)
  float w_dev_pm, w_Fy, w_switch_F, V_min, ey_min_pm, ey_max_pm, u1_lo_pm, u1_hi_pm;
  float N;   // single-track stages (H for tail="none")
  float pm;  // 1 for tail="pm", 0 for tail="none"
  // the obstacle barrier: n_obs discs of the table in use (0: none), the
  // weight, and each disc's (s, ey, R = r + 0.1)
  float n_obs, w_obs;
  float obs[MAX_OBS][3];
};

// Whether some stage's dynamics read the previous controls (the Jacobian's
// stash columns): not the cascaded family's or the kinematic family's; the
// kc cascade's seam does (kc_cascade.cuh).  team.cuh sizes its slot by it.
template <class P>
struct ReadsStash {
  static constexpr bool value = false;
};

// -- the horizon's static segments (fm_family.Seg) --------------------------------

enum StageKind { K_ST, K_ST_TERM, K_SEAM, K_SWITCH, K_TAIL, K_TERM };

template <int K>
struct KindC {
  static constexpr int value = K;
};

// single-track cost and constraints (the seam's included)
template <int K>
VCT_HD constexpr bool st_kind() { return K <= K_SEAM; }

VCT_HD int n_st(const STParams& p) { return (int)p.N; }
VCT_HD bool has_tail(const STParams& p) { return p.pm != 0.f; }
// the stage whose arc step the switching cost reads
VCT_HD int seam_stage(const STParams& p) { return n_st(p) > 0 ? n_st(p) - 1 : 0; }

// the kind of stage n of H
VCT_HD int stage_kind(int n, int H, const STParams& p) {
  int N = n_st(p);
  if (!has_tail(p)) return n == H - 1 ? K_ST_TERM : K_ST;
  if (n < N - 1) return K_ST;
  if (n == N - 1) return K_SEAM;
  if (n == N) return K_SWITCH;  // also terminal when it is the last stage
  return n == H - 1 ? K_TERM : K_TAIL;
}

struct Segments {
  int count, lo[6], hi[6], kind[6];
};

VCT_HD void add_segment(Segments& s, int lo, int hi, int kind) {
  if (hi <= lo) return;
  s.lo[s.count] = lo;
  s.hi[s.count] = hi;
  s.kind[s.count] = kind;
  ++s.count;
}

// the cuts {0, N-1, N, N+1, H-1, H}
VCT_HD Segments segments(int H, const STParams& p) {
  Segments s;
  s.count = 0;
  int N = n_st(p);
  if (!has_tail(p)) {
    add_segment(s, 0, H - 1, K_ST);
    add_segment(s, H - 1, H, K_ST_TERM);
    return s;
  }
  int last = N + 1 > H - 1 ? N + 1 : H - 1;
  add_segment(s, 0, N - 1, K_ST);
  add_segment(s, N - 1, N, K_SEAM);
  add_segment(s, N, N + 1, K_SWITCH);
  add_segment(s, N + 1, last, K_TAIL);
  add_segment(s, last, H, K_TERM);
  return s;
}

// f(KindC<kind>{}): the kind as a compile-time constant
template <class F>
VCT_HD void with_kind(int kind, const STParams&, F&& f) {
  switch (kind) {
    case K_ST: f(KindC<K_ST>{}); break;
    case K_ST_TERM: f(KindC<K_ST_TERM>{}); break;
    case K_SEAM: f(KindC<K_SEAM>{}); break;
    case K_SWITCH: f(KindC<K_SWITCH>{}); break;
    case K_TAIL: f(KindC<K_TAIL>{}); break;
    default: f(KindC<K_TERM>{}); break;
  }
}

// the rollout control box of stage n: u1 is w before N, Fy from N on
VCT_HD void stage_box(int n, const STParams& p, float lo[NU], float hi[NU]) {
  bool tail = has_tail(p) && n >= n_st(p);
  lo[0] = p.u0_lo;
  hi[0] = p.u0_hi;
  lo[1] = tail ? p.u1_lo_pm : p.u1_lo;
  hi[1] = tail ? p.u1_hi_pm : p.u1_hi;
}

// -- math helpers (utils/math.py) ----------------------------------------------

template <class T>
VCT_HD T SafeDiv(const T& num, const T& den, float eps) {
  float sign = val(den) >= 0.f ? 1.f : -1.f;
  return num / (sign * Max(Abs(den), eps));
}

// tan as sin / cos of the value; on a jet one chain (tan' = 1 + tan^2)
template <class T>
VCT_HD T Tan(const T& x) {
  const float t = sinf(val(x)) / cosf(val(x));
  return chain(x, t, 1.f + t * t, 2.f * t * (1.f + t * t));
}

// polynomial arctan r(z) = z P(z^2), |err| < 3.5e-11 in exact arithmetic;
// on a jet, P, P' and P''/2 come from one Horner pass on values and are
// chained in once (utils/math.py: arctan), the value's products rounded on
// their own (mul_rn)
template <class T>
VCT_HD T Arctan(const T& x) {
  const float C[13] = {
      0.99999999999263123f,   -0.3333333306680264f,    0.1999998397885146f,
      -0.14285333912904893f,  0.11106380339266723f,    -0.090554546996879717f,
      0.075185007155151209f,  -0.060787989990705574f,  0.044565591157096275f,
      -0.026990770717991868f, 0.012096335799244793f,   -0.0034560864803735883f,
      0.00046365012913819137f};
  T ax = Abs(x);
  bool inv = val(ax) > 1.f;
  float s = val(x) >= 0.f ? 1.f : -1.f;
  T z = inv ? T(s / Max(ax, 1e-6f)) : x;
  constexpr bool jet = !std::is_same<T, float>::value;
  float zv = val(z), t = jet ? mul_rn(zv, zv) : zv * zv;
  float p = C[12], p1 = 0.f, p2 = 0.f;
  for (int i = 11; i >= 0; --i) {
    p2 = p2 * t + p1;
    p1 = p1 * t + p;
    p = (jet ? mul_rn(p, t) : p * t) + C[i];
  }
  // r' = P + 2t P', r'' = 6z P' + 4z t P''
  T r = chain(z, jet ? mul_rn(zv, p) : zv * p, p + 2.f * t * p1,
              zv * (6.f * p1 + 8.f * t * p2));
  return inv ? T(s * HALF_PI - r) : r;
}

// -- force stack (models/dynamic_car.py) ------------------------------------------

template <class T>
VCT_HD T Fx_f(const T& Fx, const STParams& p) {
  return Fx * ((p.Xdf - p.Xbf) / 2 * Tanh(2.f * (Fx / DSS + 0.5f)) + (p.Xdf + p.Xbf) / 2);
}

template <class T>
VCT_HD T Fx_r(const T& Fx, const STParams& p) {
  return Fx * ((p.Xbr - p.Xdr) / 2 * Tanh(-2.f * (Fx / DSS + 0.5f)) + (p.Xdr + p.Xbr) / 2);
}

template <class T>
VCT_HD T Fz_f(const T& Ux, const T& Fx, const STParams& p) {
  return (p.b / p.l) * p.m * (p.gcc + p.Av2 * (Ux * Ux)) - p.h * Fx / p.l;
}

template <class T>
VCT_HD T Fz_r(const T& Ux, const T& Fx, const STParams& p) {
  return (p.a / p.l) * p.m * (p.gcc + p.Av2 * (Ux * Ux)) + p.h * Fx / p.l;
}

template <class T>
VCT_HD T sq(const T& x) { return x * x; }

template <class T>
VCT_HD T Fy_max_f(const T& Ux, const T& Fx, const STParams& p) {
  return Sqrt(Max(sq(p.mu_f * Fz_f(Ux, Fx, p)) - sq(0.99f * Fx_f(Fx, p)), 1e-9f));
}

template <class T>
VCT_HD T Fy_max_r(const T& Ux, const T& Fx, const STParams& p) {
  return Sqrt(Max(sq(p.mu_r * Fz_r(Ux, Fx, p)) - sq(0.99f * Fx_r(Fx, p)), 1e-9f));
}

template <class T>
VCT_HD T alpha_f(const T& Ux, const T& Uy, const T& r, const T& delta, const STParams& p) {
  return Arctan(SafeDiv(Uy + p.a * r, Ux, 1e-6f)) - delta;
}

template <class T>
VCT_HD T alpha_r(const T& Ux, const T& Uy, const T& r, const STParams& p) {
  return Arctan(SafeDiv(Uy - p.b * r, Ux, 1e-6f));
}

// modified Fiala brush tire; only the selected branch is evaluated
template <class T>
VCT_HD T fiala(const T& alpha, const T& alphamod, const T& Fymax, float Ca, float eps) {
  T ta = Tan(alpha);
  if (fabsf(val(alpha)) <= val(alphamod)) {
    float Ca2 = (float)((double)Ca * Ca), Ca3 = (float)((double)Ca * Ca * Ca);
    return -Ca * ta + Ca2 * Abs(ta) * ta / (3.f * Fymax) - Ca3 * (ta * ta * ta) / (27.f * sq(Fymax));
  }
  float csat = (float)((double)Ca * (1.0 - 2.0 * eps + (double)eps * eps));
  float ksat = (float)(3.0 * eps * eps - 2.0 * (double)eps * eps * eps);
  return -csat * ta - Fymax * ksat * Sign(alpha);
}

template <class T>
VCT_HD T Fy_f(const T& Ux, const T& Uy, const T& r, const T& delta, const T& Fx,
              const STParams& p) {
  T af = alpha_f(Ux, Uy, r, delta, p);
  T Fm = Fy_max_f(Ux, Fx, p);
  return fiala(af, Arctan(3.f * Fm * p.eps / p.Caf), Fm, p.Caf, p.eps);
}

template <class T>
VCT_HD T Fy_r(const T& Ux, const T& Uy, const T& r, const T& Fx, const STParams& p) {
  T ar = alpha_r(Ux, Uy, r, p);
  T Fm = Fy_max_r(Ux, Fx, p);
  return fiala(ar, Arctan(3.f * Fm * p.eps / p.Car), Fm, p.Car, p.eps);
}

// -- single-track fields (solvers/fm_singletrack.py) --------------------------------

// the 8 d(state)/dt fields of the (clamped) state x
template <class T>
VCT_HD void temporal_fields(const T x[8], const T& Fx, const T& wact, float k,
                            const STParams& p, T out[8]) {
  const T &Ux = x[0], &Uy = x[1], &r = x[2], &delta = x[3], &ey = x[5], &epsi = x[6];
  T fxf = Fx_f(Fx, p), fxr = Fx_r(Fx, p);
  T fyf = Fy_f(Ux, Uy, r, delta, Fx, p), fyr = Fy_r(Ux, Uy, r, Fx, p);
  T Fd = p.Frr + p.Cd * (Ux * Ux);
  T cd = Cos(delta), sd = Sin(delta);
  T ce = Cos(epsi), se = Sin(epsi);
  out[0] = (fxf * cd - fyf * sd + fxr - Fd) / p.m + r * Uy;
  out[1] = (fyf * cd + fxf * sd + fyr) / p.m - r * Ux;
  out[2] = (p.a * (fyf * cd + fxf * sd) - p.b * fyr) / p.Izz;
  out[3] = wact;
  out[4] = (Ux * ce - Uy * se) / (1.f - k * ey);
  out[5] = Ux * se + Uy * ce;
  out[6] = r - k * out[4];
  out[7] = cst<T>(1.f);
}

// d(state)/ds: state clamps, then the softplus-floored 1/s_dot
template <class T>
VCT_HD void spatial_prime(const T x[8], const T& Fx, const T& wact, float k,
                          const STParams& p, T out[8]) {
  T xc[8];
  for (int i = 0; i < 8; ++i) xc[i] = x[i];
  xc[0] = Clip(x[0], 1.f, 1e3f);
  xc[3] = Clip(x[3], -1.f, 1.f);
  xc[5] = Clip(x[5], -8.f, 8.f);
  xc[6] = Clip(x[6], -1.3f, 1.3f);
  T xdot[8];
  temporal_fields(xc, Fx, wact, k, p, xdot);
  T inv = 1.f / (FLOOR + Softplus0(BETA * (xdot[4] - FLOOR)) / BETA);
  out[0] = xdot[0] * inv;
  out[1] = xdot[1] * inv;
  out[2] = xdot[2] * inv;
  out[3] = xdot[3] * inv;
  out[4] = cst<T>(1.f);
  out[5] = xdot[5] * inv;
  out[6] = xdot[6] * inv;
  out[7] = inv;
}

template <class T>
VCT_HD_NOINLINE void rk4_step(const T x[8], const T& Fx, const T& wact, float k, float h,
                              const STParams& p, T out[8]) {
  T k1[8], k2[8], k3[8], k4[8], xs[8];
  spatial_prime(x, Fx, wact, k, p, k1);
  for (int i = 0; i < 8; ++i) xs[i] = x[i] + 0.5f * h * k1[i];
  spatial_prime(xs, Fx, wact, k, p, k2);
  for (int i = 0; i < 8; ++i) xs[i] = x[i] + 0.5f * h * k2[i];
  spatial_prime(xs, Fx, wact, k, p, k3);
  for (int i = 0; i < 8; ++i) xs[i] = x[i] + h * k3[i];
  spatial_prime(xs, Fx, wact, k, p, k4);
  for (int i = 0; i < 8; ++i)
    out[i] = x[i] + h * (k1[i] + 2.f * k2[i] + 2.f * k3[i] + k4[i]) / 6.f;
}

// the handoff at stage N-1 (fm_singletrack.seam_fields): V, s, ey,
// beta + epsi, t and the lateral-force stash, from the raw state
template <class T>
VCT_HD void seam_map(const T x[8], const T& Fx, const STParams& p, T out[6]) {
  const T &Ux = x[0], &Uy = x[1], &r = x[2], &delta = x[3];
  out[0] = Sqrt(Ux * Ux + Uy * Uy);
  out[1] = x[4];
  out[2] = x[5];
  out[3] = Arctan(SafeDiv(Uy, Ux, 1e-6f)) + x[6];
  out[4] = x[7];
  out[5] = Fy_f(Ux, Uy, r, delta, Fx, p) + Fy_r(Ux, Uy, r, Fx, p);
}

// the point mass's explicit Euler step (fm_family.pm_step) of the raw state
// (V, s, ey, epsi, t): clamps, then the softplus-floored 1/s_dot; forces in N
template <class T>
VCT_HD void pm_step(const T x[5], const T& Fx, const T& Fy, float k, float h, const STParams& p,
                    T out[5]) {
  T V = Clip(x[0], 0.5f, 1e3f), ey = Clip(x[2], -8.f, 8.f), epsi = Clip(x[3], -1.3f, 1.3f);
  T V_dot = (Fx - (p.Frr + p.Cd * (V * V))) / p.m;
  T s_dot = (V * Cos(epsi)) / (1.f - k * ey);
  T ey_dot = V * Sin(epsi);
  T V_safe = Where(fabsf(val(V)) > 1e-3f, V, 1e-3f);
  T epsi_dot = Fy / (p.m * V_safe) - k * s_dot;
  T inv = 1.f / (FLOOR + Softplus0(BETA * (s_dot - FLOOR)) / BETA);
  out[0] = x[0] + h * (V_dot * inv);
  out[1] = x[1] + h;
  out[2] = x[2] + h * (ey_dot * inv);
  out[3] = x[3] + h * (epsi_dot * inv);
  out[4] = x[4] + h * inv;
}

// -- costs and constraints -------------------------------------------------------------

template <class T, class P>
VCT_HD T boundary(const T& ey, float dsn, float lo, float hi, const P& p) {
  T below = Where(val(ey) < lo, sq(ey - lo), 0.f);
  T above = Where(val(ey) > hi, sq(ey - hi), 0.f);
  return p.w_boundary * dsn * (below + above);
}

template <class T>
VCT_HD T terminal(const T& speed, const T& ey, const T& epsi, const T& t, const STParams& p) {
  T over = Where(val(speed) >= p.max_speed, sq(speed - p.max_speed), 0.f);
  return p.w_speed * over + p.w_time * t + p.w_ey * (ey * ey) + p.w_epsi * (epsi * epsi);
}

template <class T>
VCT_HD T slip_penalty(const T x[8], const T& Fx, const STParams& p) {
  const T &Ux = x[0], &Uy = x[1], &r = x[2], &delta = x[3];
  T ta_f = Abs(Tan(alpha_f(Ux, Uy, r, delta, p)));
  T tam_f = Tan(Arctan(3.f * Fy_max_f(Ux, Fx, p) * p.eps / p.Caf));
  T ta_r = Abs(Tan(alpha_r(Ux, Uy, r, p)));
  T tam_r = Tan(Arctan(3.f * Fy_max_r(Ux, Fx, p) * p.eps / p.Car));
  return p.w_slip * (Where(val(ta_f) >= val(tam_f), sq(ta_f - tam_f), 0.f) +
                     Where(val(ta_r) >= val(tam_r), sq(ta_r - tam_r), 0.f));
}

// the 10 single-track constraints, c <= 0 feasible (forces in kN)
template <class T>
VCT_HD void constraints(const T x[8], const T& Fx, const T& wact, const STParams& p, T c[NC]) {
  const float fs = 1.f / FS;
  const T &Ux = x[0], &Uy = x[1], &r = x[2], &delta = x[3];
  T bound_f = p.mu_f * Fz_f(Ux, Fx, p) * Cos(alpha_f(Ux, Uy, r, delta, p));
  T bound_r = p.mu_r * Fz_r(Ux, Fx, p) * Cos(alpha_r(Ux, Uy, r, p));
  T fxf = Fx_f(Fx, p), fxr = Fx_r(Fx, p);
  c[0] = p.Ux_min - Ux;
  c[1] = delta - p.delta_max;
  c[2] = p.delta_min - delta;
  c[3] = (Fx - p.Peng / Max(Ux, 1.f)) * fs;
  c[4] = wact - p.w_max;
  c[5] = p.w_min - wact;
  c[6] = (fxf - bound_f) * fs;
  c[7] = (-fxf - bound_f) * fs;
  c[8] = (fxr - bound_r) * fs;
  c[9] = (-fxr - bound_r) * fs;
}

template <class T>
VCT_HD T phr(const T& c, float lam, float mu) {
  T lam_hat = Max(0.f, lam + mu * c);
  return lam_hat * lam_hat - lam * lam;
}

// the curvature factor of a PHR row along its constraint: 1 where lam + mu c
// > 0, 0 below and, at the tie, the 0.25 of JAX's autodiff of the max
// (fm_family._active)
VCT_HD float active(float x) { return x > 0.f ? 1.f : (x == 0.f ? 0.25f : 0.f); }

// The obstacle barrier at (s, ey) (fm_family._obstacles_std): over the
// discs in table order, w dsn / max(dist - R, OBSTACLE_EPS), R = r + 0.1.
// The squares are rounded on their own (mul_rn), so dist rounds as the
// plain version's and the floor decides alike.  Every lane reads the same
// table, so the loop does not diverge a warp.
template <class P>
VCT_HD float obstacle_barrier(float s, float ey, float dsn, const P& p) {
  float acc = 0.f;
  const int n_obs = (int)p.n_obs;
  for (int i = 0; i < n_obs; ++i) {
    const float a = s - p.obs[i][0], b = ey - p.obs[i][1];
    const float dist = sqrtf(mul_rn(a, a) + mul_rn(b, b));
    acc = acc + (p.w_obs * dsn) / vmax(dist - p.obs[i][2], OBSTACLE_EPS);
  }
  return acc;
}

// the family's raw stage cost (no penalty) at stage n of H; dss is the arc
// step of the seam stage N-1, which the switching cost reads; with
// obstacles the barrier on (s, ey) after the running cost
template <int K, class T>
VCT_HD T stage_cost(int n, int H, const T wf[NW], float dsn, float dsp, float dss,
                    const STParams& p) {
  if constexpr (st_kind<K>()) {
    const T* x = wf;
    T Fx = wf[NZ] * FS, wact = wf[NZ + 1];
    const T& ey = x[5];
    T cost = boundary(ey, dsn, p.ey_min, p.ey_max, p);
    cost = cost + p.w_dev * dsn * (ey * ey);
    cost = cost + p.w_w * (wact * wact);
    cost = cost + slip_penalty(x, Fx, p);
    if (n >= 1) cost = cost + (p.w_Fx / dsp) * sq(Fx - wf[8] * FS);  // Fx slew
    if (p.n_obs > 0.f) cost = cost + obstacle_barrier(x[4], ey, dsn, p);
    if constexpr (K == K_ST_TERM) cost = cost + terminal(x[0], x[5], x[6], x[7], p);
    return cost;
  } else {
    // point mass: u1 is Fy in kN; the previous u1 is in kN from N+1 on
    T Fx = wf[NZ] * FS, Fy = wf[NZ + 1] * FS, Fx_prev = wf[8] * FS;
    const T& ey = wf[2];
    T cost = boundary(ey, dsn, p.ey_min_pm, p.ey_max_pm, p);
    cost = cost + p.w_dev_pm * dsn * (ey * ey);
    if constexpr (K != K_SWITCH)  // Fx/Fy slew
      cost = cost + ((p.w_Fx / dsp) * sq(Fx - Fx_prev) + (p.w_Fy / dsp) * sq(Fy - wf[9] * FS));
    if (p.n_obs > 0.f) cost = cost + obstacle_barrier(wf[1], ey, dsn, p);
    if constexpr (K == K_SWITCH)  // switching cost against the seam's stash z[5]
      cost = cost + (p.w_switch_F / dss) * (sq(Fx - Fx_prev) + sq(Fy - wf[5]));
    if (K == K_TERM || n == H - 1) cost = cost + terminal(wf[0], wf[2], wf[3], wf[4], p);
    return cost;
  }
}

// the stage constraints at stage n: single track with the state-only rows
// masked at the fixed stage-0 state; point mass: the speed floor, the
// engine power, padding
template <int K, class T>
VCT_HD void stage_constraints(int n, const T wf[NW], const STParams& p, T c[NC]) {
  if constexpr (st_kind<K>()) {
    constraints(wf, wf[NZ] * FS, wf[NZ + 1], p, c);
    if (n == 0)
      for (int j = 0; j < 3; ++j) c[j] = cst<T>(-1.f);
  } else {
    const T& V = wf[0];
    c[0] = p.V_min - V;
    c[1] = (wf[NZ] * FS - p.Peng / Max(V, 1.f)) * (1.f / FS);
    for (int j = 2; j < NC; ++j) c[j] = cst<T>(-1.f);
  }
}

// the family's AL stage cost at stage n of H
template <int K, class T>
VCT_HD_NOINLINE T al_cost(int n, int H, const T wf[NW], const float lam[NC], float mu, float dsn,
                          float dsp, float dss, const STParams& p) {
  T cost = stage_cost<K>(n, H, wf, dsn, dsp, dss, p);
  T c[NC];
  stage_constraints<K>(n, wf, p, c);
  T acc = cst<T>(0.f);
  for (int j = 0; j < NC; ++j) acc = acc + phr(c[j], lam[j], mu);
  return cost + acc / (2.f * mu);
}

// the family's dynamics at a stage of kind K: the RK4 step with the
// steering stop, the seam, or the point-mass Euler step; stash = u.  Not
// inlined, so the line search and the re-roll of its choice run the same
// instructions on every kind of stage and agree to the bit.
template <int K>
VCT_HD_NOINLINE void dyn(const float wf[NW], float kv, float dsn, const STParams& p,
                         float out[NZ]) {
  if constexpr (K == K_ST || K == K_ST_TERM) {
    rk4_step(wf, wf[NZ] * FS, wf[NZ + 1], kv, dsn, p, out);
    out[3] = Clip(out[3], p.delta_min, p.delta_max);
  } else if constexpr (K == K_SEAM) {
    seam_map(wf, wf[NZ] * FS, p, out);
    out[6] = 0.f;
    out[7] = 0.f;
  } else {
    pm_step(wf, wf[NZ] * FS, wf[NZ + 1] * FS, kv, dsn, p, out);
    out[5] = 0.f;
    out[6] = 0.f;
    out[7] = 0.f;
  }
  out[8] = wf[NZ];
  out[9] = wf[NZ + 1];
}

// -- hand-derived stage derivatives (fm_family.stage_derivs) -------------------------------

// d clip(x, lo, hi) / dx with JAX's 0.5 at a tie (Clip is min of max)
VCT_HD float clip_grad(float x, float lo, float hi) {
  return tie_weight(x, lo) * tie_weight(hi, vmax(x, lo));
}

// The RK4 step's Jacobian by its sparse analytic chain, as the TPU kernel
// computes it (fm_singletrack.spatial_prime_jac, rk4_step_jac): at each
// substage spatial_prime's structural partials, written out once, move the
// 8 tangent columns (Ux, Uy, r, delta, ey, epsi, Fx, w); no jets.  A
// column's tangent holds the 6 state fields spatial_prime differentiates
// (0-3, 5, 6; it reads s and t through nothing).  arctan' = 1/(1+q^2), as
// in JAX, not the polynomial's own derivative: the two differ far inside
// f32 rounding.
struct PrimePartials {
  float f[8];                   // spatial_prime's value
  float v[6];                   // the temporal fields Ux', Uy', r', delta', ey', epsi'
  float d[3][5];                // d(Ux', Uy', r') / d(Ux, Uy, r, delta, Fx), clamps folded in
  float sd[4], e5[3];           // d s_dot / d(Ux, Uy, ey, epsi), d ey' / d(Ux, Uy, epsi)
  float k, inv, dinv;           // curvature, 1/s_dot_eff, its slope
};

// the modified Fiala tire's force and its partials along the slip angle's
// tangent (d/d alpha) and Fy_max (d/dF): the selected branch only
VCT_HD float fiala_d(float alpha, float F, float Ca, float eps, float& fy_a, float& fy_F) {
  float ta = sinf(alpha) / cosf(alpha), dta = 1.f + ta * ta;
  float amod = Arctan(3.f * F * eps / Ca);
  if (fabsf(alpha) <= amod) {
    float Ca2 = (float)((double)Ca * Ca), Ca3 = (float)((double)Ca * Ca * Ca);
    float at = fabsf(ta), F3 = 3.f * F, F2 = sq(F);
    fy_a = (-Ca + Ca2 * 2.f * at / F3 - Ca3 * (3.f * ta * ta) / (27.f * F2)) * dta;
    fy_F = -Ca2 * at * ta / (F3 * F) + Ca3 * (ta * ta * ta) * 2.f / (27.f * F2 * F);
    return -Ca * ta + Ca2 * at * ta / F3 - Ca3 * (ta * ta * ta) / (27.f * F2);
  }
  float csat = (float)((double)Ca * (1.0 - 2.0 * eps + (double)eps * eps));
  float ksat = (float)(3.0 * eps * eps - 2.0 * (double)eps * eps * eps);
  float sg = Sign(alpha);
  fy_a = -csat * dta;
  fy_F = -ksat * sg;
  return -csat * ta - F * ksat * sg;
}

// Fy_max of one axle and its partials along Ux and Fx (Max's tie rule)
VCT_HD float fymax_d(float mu_ax, float Fz, float dFz_Ux, float dFz_Fx, float fx, float dfx,
                     float& dF_Ux, float& dF_Fx) {
  float arg = sq(mu_ax * Fz) - sq(0.99f * fx);
  float F = sqrtf(vmax(arg, 1e-9f));
  float gF = tie_weight(arg, 1e-9f) * (0.5f / F);
  dF_Ux = gF * (2.f * (mu_ax * Fz) * (mu_ax * dFz_Ux));
  dF_Fx = gF * (2.f * (mu_ax * Fz) * (mu_ax * dFz_Fx) - 2.f * (0.99f * fx) * (0.99f * dfx));
  return F;
}

// spatial_prime's value at x and its partials
VCT_HD void prime_partials(const float x[8], float Fx, float wact, float k, const STParams& p,
                           PrimePartials& P) {
  const float cg0 = clip_grad(x[0], 1.f, 1e3f), cg3 = clip_grad(x[3], -1.f, 1.f);
  const float cg5 = clip_grad(x[5], -8.f, 8.f), cg6 = clip_grad(x[6], -1.3f, 1.3f);
  const float Ux = Clip(x[0], 1.f, 1e3f), Uy = x[1], r = x[2], delta = Clip(x[3], -1.f, 1.f);
  const float ey = Clip(x[5], -8.f, 8.f), epsi = Clip(x[6], -1.3f, 1.3f);
  // drive/brake split: functions of Fx
  const float thf = tanhf(2.f * (Fx / DSS + 0.5f)), thr = tanhf(-2.f * (Fx / DSS + 0.5f));
  const float Xf = (p.Xdf - p.Xbf) / 2 * thf + (p.Xdf + p.Xbf) / 2;
  const float Xr = (p.Xbr - p.Xdr) / 2 * thr + (p.Xdr + p.Xbr) / 2;
  const float fxf = Fx * Xf, fxr = Fx * Xr;
  const float dfxf = Xf + Fx * ((p.Xdf - p.Xbf) / 2 * (1.f - thf * thf) * (2.f / DSS));
  const float dfxr = Xr - Fx * ((p.Xbr - p.Xdr) / 2 * (1.f - thr * thr) * (2.f / DSS));
  // normal loads and Fy_max (Ux >= 1: SafeDiv's guard never binds)
  const float czf = (p.b / p.l) * p.m, czr = (p.a / p.l) * p.m;
  const float Fzf = czf * (p.gcc + p.Av2 * (Ux * Ux)) - p.h * Fx / p.l;
  const float Fzr = czr * (p.gcc + p.Av2 * (Ux * Ux)) + p.h * Fx / p.l;
  float dFf_Ux, dFf_Fx, dFr_Ux, dFr_Fx;
  const float Ff = fymax_d(p.mu_f, Fzf, czf * p.Av2 * 2.f * Ux, -p.h / p.l, fxf, dfxf, dFf_Ux,
                           dFf_Fx);
  const float Fr = fymax_d(p.mu_r, Fzr, czr * p.Av2 * 2.f * Ux, p.h / p.l, fxr, dfxr, dFr_Ux,
                           dFr_Fx);
  // slip angles and tire forces; partials over (Ux, Uy, r, delta, Fx)
  const float qf = (Uy + p.a * r) / Ux, qr = (Uy - p.b * r) / Ux;
  const float gf = 1.f / (1.f + qf * qf) / Ux, gr = 1.f / (1.f + qr * qr) / Ux;
  float fyf_a, fyf_F, fyr_a, fyr_F;
  const float fyf = fiala_d(Arctan(qf) - delta, Ff, p.Caf, p.eps, fyf_a, fyf_F);
  const float fyr = fiala_d(Arctan(qr), Fr, p.Car, p.eps, fyr_a, fyr_F);
  const float dfyf[5] = {fyf_a * (-gf * qf) + fyf_F * dFf_Ux, fyf_a * gf, fyf_a * (gf * p.a),
                         -fyf_a, fyf_F * dFf_Fx};
  const float dfyr[5] = {fyr_a * (-gr * qr) + fyr_F * dFr_Ux, fyr_a * gr, fyr_a * (-gr * p.b), 0.f,
                         fyr_F * dFr_Fx};
  // the temporal fields and their partials
  const float cd = cosf(delta), sd = sinf(delta), ce = cosf(epsi), se = sinf(epsi);
  const float Fd = p.Frr + p.Cd * (Ux * Ux);
  const float lat = fyf * cd + fxf * sd;  // the front axle's lateral force in the body frame
  P.v[0] = (fxf * cd - fyf * sd + fxr - Fd) / p.m + r * Uy;
  P.v[1] = (lat + fyr) / p.m - r * Ux;
  P.v[2] = (p.a * lat - p.b * fyr) / p.Izz;
  P.v[3] = wact;
  const float deninv = 1.f / (1.f - k * ey);
  const float sdot = (Ux * ce - Uy * se) / (1.f - k * ey);
  P.v[4] = Ux * se + Uy * ce;
  P.v[5] = r - k * sdot;
  for (int j = 0; j < 5; ++j) {
    float dlat = dfyf[j] * cd + (j == 3 ? fxf * cd - fyf * sd : 0.f) + (j == 4 ? dfxf * sd : 0.f);
    float d0 = -dfyf[j] * sd + (j == 3 ? -fxf * sd - fyf * cd : 0.f) +
               (j == 4 ? dfxf * cd + dfxr : 0.f) - (j == 0 ? 2.f * p.Cd * Ux : 0.f);
    P.d[0][j] = d0 / p.m + (j == 1 ? r : 0.f) + (j == 2 ? Uy : 0.f);
    P.d[1][j] = (dlat + dfyr[j]) / p.m - (j == 0 ? r : 0.f) - (j == 2 ? Ux : 0.f);
    P.d[2][j] = (p.a * dlat - p.b * dfyr[j]) / p.Izz;
  }
  for (int i = 0; i < 3; ++i) {
    P.d[i][0] *= cg0;
    P.d[i][3] *= cg3;
  }
  P.sd[0] = ce * deninv * cg0;
  P.sd[1] = -se * deninv;
  P.sd[2] = sdot * k * deninv * cg5;
  P.sd[3] = (-Ux * se - Uy * ce) * deninv * cg6;
  P.e5[0] = se * cg0;
  P.e5[1] = ce;
  P.e5[2] = (Ux * ce - Uy * se) * cg6;
  P.k = k;
  // the softplus floor on s_dot, then the division
  const float y = BETA * (sdot - FLOOR), sp = Softplus0(y);
  P.inv = 1.f / (FLOOR + sp / BETA);
  P.dinv = -(P.inv * P.inv) * expf(y - sp);
  P.f[0] = P.v[0] * P.inv;
  P.f[1] = P.v[1] * P.inv;
  P.f[2] = P.v[2] * P.inv;
  P.f[3] = P.v[3] * P.inv;
  P.f[4] = 1.f;
  P.f[5] = P.v[4] * P.inv;
  P.f[6] = P.v[5] * P.inv;
  P.f[7] = P.inv;
}

// the tangent of spatial_prime along one column: t the column's tangent of
// the state fields 0-3, 5, 6; tFx, tw its direct Fx and w components; out
// rows 0-7 (row 4, s' = 1, is 0)
VCT_HD void prime_tangent(const PrimePartials& P, const float t[6], float tFx, float tw,
                          float out[8]) {
  const float tsd = P.sd[0] * t[0] + P.sd[1] * t[1] + P.sd[2] * t[4] + P.sd[3] * t[5];
  const float tinv = P.dinv * tsd;
  float tv[6];
  for (int i = 0; i < 3; ++i)
    tv[i] = P.d[i][0] * t[0] + P.d[i][1] * t[1] + P.d[i][2] * t[2] + P.d[i][3] * t[3] +
            P.d[i][4] * tFx;
  tv[3] = tw;
  tv[4] = P.e5[0] * t[0] + P.e5[1] * t[1] + P.e5[2] * t[5];
  tv[5] = t[2] - P.k * tsd;
  const int row[6] = {0, 1, 2, 3, 5, 6};
  for (int i = 0; i < 6; ++i) out[row[i]] = tv[i] * P.inv + P.v[i] * tinv;
  out[4] = 0.f;
  out[7] = tinv;
}

// Jm's rows 0-7 over the columns (Ux, Uy, r, delta, ey, epsi, u_Fx, w) of
// the RK4 step with the steering stop, at wf; Fx = u_Fx * FS
VCT_HD_NOINLINE void rk4_jacobian(const float wf[NW], float kv, float h, const STParams& p,
                                  float Jm[NZ][NW]) {
  const int COLS[8] = {0, 1, 2, 3, 5, 6, NZ, NZ + 1};
  const float Fx = wf[NZ] * FS, wact = wf[NZ + 1];
  float T[8][6], acc[8][8], xs[8], next3 = 0.f;  // T[c]: column c's state tangent
  for (int c = 0; c < 8; ++c)
    for (int i = 0; i < 6; ++i) T[c][i] = c == i ? 1.f : 0.f;
  for (int i = 0; i < 8; ++i) xs[i] = wf[i];
  const float wsub[4] = {1.f, 2.f, 2.f, 1.f}, step[4] = {0.5f * h, 0.5f * h, h, 0.f};
  for (int q = 0; q < 4; ++q) {
    PrimePartials P;
    prime_partials(xs, Fx, wact, kv, p, P);
    next3 = q == 0 ? P.f[3] : next3 + wsub[q] * P.f[3];
    for (int i = 0; i < 8; ++i) xs[i] = wf[i] + step[q] * P.f[i];
    for (int c = 0; c < 8; ++c) {
      float D[8];
      prime_tangent(P, T[c], c == 6 ? FS : 0.f, c == 7 ? 1.f : 0.f, D);
      for (int r = 0; r < 8; ++r) acc[r][c] = q == 0 ? D[r] : acc[r][c] + wsub[q] * D[r];
      const int row[6] = {0, 1, 2, 3, 5, 6};
      for (int i = 0; i < 6; ++i) T[c][i] = (c == i ? 1.f : 0.f) + step[q] * D[row[i]];
    }
  }
  next3 = wf[3] + h * next3 / 6.f;
  const float stop = clip_grad(next3, p.delta_min, p.delta_max);
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) {
      float J = (r < 4 || r == 5 || r == 6) && COLS[c] == r ? 1.f : 0.f;
      J = J + h * acc[r][c] / 6.f;
      Jm[r][COLS[c]] = r == 3 ? J * stop : J;
    }
}

// the cascaded family's packed Hessian (sym_n)
constexpr int NSYM = STParams::NSYM;  // 78
VCT_HD int sym_w(int r, int c) { return sym_n<NW>(r, c); }

// tan and cos of a: the sine and cosine of the value once, each a chain
template <class T>
VCT_HD void tan_cos(const T& a, T& t, T& c) {
  const float sv = sinf(val(a)), cv = cosf(val(a)), tv = sv / cv;
  t = chain(a, tv, 1.f + tv * tv, 2.f * tv * (1.f + tv * tv));
  c = chain(a, cv, -sv, -cv);
}

// The nonquadratic part of a single-track stage's AL cost over (Ux, Uy, r,
// delta, Fx): the slip penalty and the PHR rows 3 and 6-9 over 2 mu
// (slip_penalty, constraints), with the slip angles, their tangents and
// cosines, the normal loads and the drive/brake split computed once for both.
template <class T>
VCT_HD T st_block(const T x[4], const T& Fx, const float lam[NC], float mu, const STParams& p) {
  const T &Ux = x[0], &Uy = x[1], &r = x[2], &delta = x[3];
  const float fs = 1.f / FS;
  T fxf = Fx_f(Fx, p), fxr = Fx_r(Fx, p), fzf = Fz_f(Ux, Fx, p), fzr = Fz_r(Ux, Fx, p);
  T ta_f, ca_f, ta_r, ca_r;
  tan_cos(alpha_f(Ux, Uy, r, delta, p), ta_f, ca_f);
  tan_cos(alpha_r(Ux, Uy, r, p), ta_r, ca_r);
  ta_f = Abs(ta_f);
  ta_r = Abs(ta_r);
  T tam_f = Tan(Arctan(3.f * Sqrt(Max(sq(p.mu_f * fzf) - sq(0.99f * fxf), 1e-9f)) * p.eps / p.Caf));
  T tam_r = Tan(Arctan(3.f * Sqrt(Max(sq(p.mu_r * fzr) - sq(0.99f * fxr), 1e-9f)) * p.eps / p.Car));
  T cost = p.w_slip * (Where(val(ta_f) >= val(tam_f), sq(ta_f - tam_f), 0.f) +
                       Where(val(ta_r) >= val(tam_r), sq(ta_r - tam_r), 0.f));
  T bound_f = p.mu_f * fzf * ca_f, bound_r = p.mu_r * fzr * ca_r;
  const T c[5] = {(Fx - p.Peng / Max(Ux, 1.f)) * fs, (fxf - bound_f) * fs, (-fxf - bound_f) * fs,
                  (fxr - bound_r) * fs, (-fxr - bound_r) * fs};
  const int rows[5] = {3, 6, 7, 8, 9};
  T pen = cst<T>(0.f);
  for (int j = 0; j < 5; ++j) pen = pen + phr(c[j], lam[rows[j]], mu);
  return cost + pen / (2.f * mu);
}

// lam + mu c rounded as the plain version does (mul_rn): a PHR row's
// activity, active(lam + mu c), and its slope over 2 mu, max(0, lam + mu c)
VCT_HD float phr_arg(float lam, float mu, float c) { return lam + mul_rn(mu, c); }

// d/dey of the boundary cost: w_boundary dsn 2 (ey - bound) beyond a bound
template <class P>
VCT_HD float boundary_slope(float ey, float dsn, float lo, float hi, const P& p) {
  float below = ey < lo ? 2.f * (ey - lo) : 0.f, above = ey > hi ? 2.f * (ey - hi) : 0.f;
  return p.w_boundary * dsn * (below + above);
}

// the terminal cost's gradient on (speed, ey, epsi, t) into g at those indices
VCT_HD void terminal_slope(float speed, float ey, float epsi, const int at[4], const STParams& p,
                           float g[NW]) {
  g[at[0]] += speed >= p.max_speed ? p.w_speed * (2.f * (speed - p.max_speed)) : 0.f;
  g[at[1]] += p.w_ey * (2.f * ey);
  g[at[2]] += p.w_epsi * (2.f * epsi);
  g[at[3]] += p.w_time;
}

// The obstacle barrier's gradient on (s, ey) and its 2x2 Hessian block,
// added into g and Hs (the family's packed Hessian) at (is, ie), in closed
// form.  Per disc, with d the
// (s, ey) distance to its centre, u = (s - so, ey - eo) / d and the term
// f(d) = w dsn / max(d - R, OBSTACLE_EPS): the gradient f'(d) u and the
// block f''(d) u u' + f'(d) (I - u u') / d.  On a floored disc (d - R <
// OBSTACLE_EPS) the term is a constant and adds nothing; at the tie, JAX's
// max takes half of each side (tie_weight).
template <class P>
VCT_HD void obstacle_derivs(float s, float ey, float dsn, int is, int ie, const P& p, float* g,
                            float* Hs) {
  float gs = 0.f, ge = 0.f, hss = 0.f, hse = 0.f, hee = 0.f;
  const int n_obs = (int)p.n_obs;
  const float wd = p.w_obs * dsn;
  for (int i = 0; i < n_obs; ++i) {
    const float a = s - p.obs[i][0], b = ey - p.obs[i][1];
    const float d = sqrtf(mul_rn(a, a) + mul_rn(b, b));
    const float x = d - p.obs[i][2];
    const float live = tie_weight(x, OBSTACLE_EPS);
    if (live == 0.f) continue;
    const float den = vmax(x, OBSTACLE_EPS);
    const float f1 = -live * wd / (den * den);  // f'(d), by the tie weight
    const float f2 = live * live * (2.f * wd) / (den * den * den);
    const float ua = a / d, ub = b / d, c = f1 / d;
    gs += f1 * ua;
    ge += f1 * ub;
    hss += f2 * (ua * ua) + c * (1.f - ua * ua);
    hse += (f2 - c) * (ua * ub);
    hee += f2 * (ub * ub) + c * (1.f - ub * ub);
  }
  g[is] += gs;
  g[ie] += ge;
  Hs[sym_n<P::NW>(is, is)] += hss;
  Hs[sym_n<P::NW>(is, ie)] += hse;
  Hs[sym_n<P::NW>(ie, ie)] += hee;
}

// The gradient and the packed Hessian of a single-track stage's AL cost
// (the seam's included): the nonquadratic part over (Ux, Uy, r, delta,
// u_Fx) by one second-order jet pass (st_block), the rest in closed form:
// the boundary, deviation, w, slew and terminal terms, the linear
// constraint rows 0-2 (constants at stage 0), 4 and 5, and the obstacle
// barrier on (s, ey) = (4, 5), added after the (5, 5) entry is set
template <int K>
VCT_HD void st_cost_derivs(int n, const float wf[NW], const float lam[NC], float mu, float dsn,
                           float dsp, const STParams& p, float g[NW], float Hs[NSYM]) {
  {
    using H5 = Jet<5, 2>;
    const int vidx[5] = {0, 1, 2, 3, NZ};
    H5 x[4];
    for (int i = 0; i < 4; ++i) x[i] = seed<5, 2>(wf[i], i);
    H5 block = st_block(x, seed<5, 2>(wf[NZ], 4) * FS, lam, mu, p);
    for (int i = 0; i < 5; ++i) {
      g[vidx[i]] = block.d[i];
      for (int j = i; j < 5; ++j) Hs[sym_w(vidx[i], vidx[j])] = hess(block, i, j);
    }
  }
  const float Ux = wf[0], delta = wf[3], ey = wf[5], wact = wf[NZ + 1];
  const float crow[5] = {p.Ux_min - Ux, delta - p.delta_max, p.delta_min - delta,
                         wact - p.w_max, p.w_min - wact};  // rows 0, 1, 2, 4, 5
  const int lrow[5] = {0, 1, 2, 4, 5};
  float slope[5], act[5];
  for (int j = 0; j < 5; ++j) {
    const float x = phr_arg(lam[lrow[j]], mu, crow[j]);
    slope[j] = vmax(x, 0.f);
    act[j] = active(x);
  }
  const float keep = n == 0 ? 0.f : 1.f;
  g[0] -= slope[0] * keep;
  g[3] += (slope[1] - slope[2]) * keep;
  g[NZ + 1] = p.w_w * (2.f * wact) + (slope[3] - slope[4]);
  g[5] = boundary_slope(ey, dsn, p.ey_min, p.ey_max, p) + (p.w_dev * dsn) * (2.f * ey);
  float termf = 0.f;
  if constexpr (K == K_ST_TERM) {
    const int at[4] = {0, 5, 6, 7};
    terminal_slope(Ux, ey, wf[6], at, p, g);
    termf = 1.f;
  }
  Hs[sym_w(0, 0)] += mu * act[0] * keep + termf * (2.f * p.w_speed) * (Ux >= p.max_speed ? 1.f : 0.f);
  Hs[sym_w(3, 3)] += mu * (act[1] + act[2]) * keep;
  Hs[sym_w(NZ + 1, NZ + 1)] = 2.f * p.w_w + mu * (act[3] + act[4]);
  float blo = ey < p.ey_min ? 1.f : 0.f, bhi = ey > p.ey_max ? 1.f : 0.f;
  Hs[sym_w(5, 5)] = 2.f * p.w_boundary * dsn * (blo + bhi) + 2.f * p.w_dev * dsn + termf * (2.f * p.w_ey);
  Hs[sym_w(6, 6)] = termf * (2.f * p.w_epsi);
  if (n >= 1) {  // Fx slew against the previous action
    float slew = (p.w_Fx / dsp) * (2.f * (wf[NZ] * FS - wf[8] * FS)) * FS;
    g[NZ] += slew;
    g[8] -= slew;
    float coef = (2.f * p.w_Fx / dsp) * (FS * FS);
    Hs[sym_w(8, 8)] += coef;
    Hs[sym_w(8, NZ)] -= coef;
    Hs[sym_w(NZ, NZ)] += coef;
  }
  if (p.n_obs > 0.f) obstacle_derivs(wf[4], ey, dsn, 4, 5, p, g, Hs);
}

// the gradient and the packed Hessian of a point-mass stage's AL cost, all
// in closed form (rows 2-9 of its constraints are constants; the obstacle
// barrier on (s, ey) = (1, 2), added after the (2, 2) entry is set)
template <int K>
VCT_HD void pm_cost_derivs(int n, int H, const float wf[NW], const float lam[NC], float mu,
                           float dsn, float dsp, float dss, const STParams& p, float g[NW],
                           float Hs[NSYM]) {
  const float fs = 1.f / FS;
  float V = wf[0], ey = wf[2];
  g[2] = boundary_slope(ey, dsn, p.ey_min_pm, p.ey_max_pm, p) + (p.w_dev_pm * dsn) * (2.f * ey);
  float blo = ey < p.ey_min_pm ? 1.f : 0.f, bhi = ey > p.ey_max_pm ? 1.f : 0.f;
  Hs[sym_w(2, 2)] = 2.f * p.w_boundary * dsn * (blo + bhi) + 2.f * p.w_dev_pm * dsn;
  // constraint rows: 0 the V floor (linear), 1 the engine power
  const float x0 = phr_arg(lam[0], mu, p.V_min - V);
  g[0] -= vmax(x0, 0.f);
  Hs[sym_w(0, 0)] += mu * active(x0);
  float Vm = vmax(V, 1.f);
  const float x1 = phr_arg(lam[1], mu, mul_rn(mul_rn(wf[NZ], FS) - p.Peng / Vm, fs));
  float liveV = (V > 1.f ? 1.f : 0.f) + (V == 1.f ? 0.5f : 0.f);  // max's tie rule
  float gV = fs * p.Peng / (Vm * Vm) * liveV;  // d c1 / dV; d c1 / du_Fx = 1
  float lam_hat1 = vmax(x1, 0.f);
  float a1 = mu * active(x1);
  g[0] += lam_hat1 * gV;
  g[NZ] += lam_hat1;
  Hs[sym_w(0, 0)] += a1 * gV * gV + lam_hat1 * (-2.f * fs * p.Peng / (Vm * Vm * Vm)) * liveV;
  Hs[sym_w(0, NZ)] += a1 * gV;
  Hs[sym_w(NZ, NZ)] += a1;
  if constexpr (K == K_SWITCH) {  // switching cost: Fx against the stash, Fy against z[5]
    const float ws = p.w_switch_F / dss;
    const float dFx = ws * (2.f * (wf[NZ] * FS - wf[8] * FS)) * FS;
    const float dFy = ws * (2.f * (wf[NZ + 1] * FS - wf[5]));
    g[NZ] += dFx;
    g[8] -= dFx;
    g[NZ + 1] += dFy * FS;
    g[5] -= dFy;
    float cw = 2.f * p.w_switch_F / dss;
    Hs[sym_w(NZ, NZ)] += cw * (FS * FS);
    Hs[sym_w(8, NZ)] -= cw * (FS * FS);
    Hs[sym_w(8, 8)] += cw * (FS * FS);
    Hs[sym_w(NZ + 1, NZ + 1)] += cw * (FS * FS);
    Hs[sym_w(5, NZ + 1)] -= cw * FS;
    Hs[sym_w(5, 5)] += cw;
  } else {  // Fx/Fy slew (both previous actions in kN)
    const float w_sl[2] = {p.w_Fx, p.w_Fy};
    for (int j = 0; j < 2; ++j) {
      float slew = (w_sl[j] / dsp) * (2.f * (wf[NZ + j] * FS - wf[8 + j] * FS)) * FS;
      g[NZ + j] += slew;
      g[8 + j] -= slew;
      float coef = (2.f * w_sl[j] / dsp) * (FS * FS);
      Hs[sym_w(8 + j, 8 + j)] += coef;
      Hs[sym_w(8 + j, NZ + j)] -= coef;
      Hs[sym_w(NZ + j, NZ + j)] += coef;
    }
  }
  if (K == K_TERM || n == H - 1) {  // terminal cost on the point-mass fields
    const int at[4] = {0, 2, 3, 4};
    terminal_slope(V, ey, wf[3], at, p, g);
    Hs[sym_w(0, 0)] += (2.f * p.w_speed) * (V >= p.max_speed ? 1.f : 0.f);
    Hs[sym_w(2, 2)] += 2.f * p.w_ey;
    Hs[sym_w(3, 3)] += 2.f * p.w_epsi;
  }
  if (p.n_obs > 0.f) obstacle_derivs(wf[1], ey, dsn, 1, 2, p, g, Hs);
}

// g (NW), the Hessian d2L/dw_r dw_c as its packed upper triangle Hs
// (sym_w), the Jacobian Jm[r][c] at stage n of kind K.  Inlined: called
// through the ABI from the team kernels (2 and 3), this function made
// kernel 2 fault with an illegal address on the card in the optimized
// build only (-G builds and the host build, under AddressSanitizer too,
// were right; ROADMAP "Faults found").
template <int K>
VCT_HD void stage_derivs(int n, int H, const float wf[NW], const float lam[NC],
                                  float mu, float kv, float dsn, float dsp, float dss,
                                  const STParams& p, float g[NW], float Hs[NSYM],
                                  float Jm[NZ][NW]) {
  for (int r = 0; r < NZ; ++r)
    for (int c = 0; c < NW; ++c) Jm[r][c] = 0.f;
  for (int i = 0; i < NW; ++i) g[i] = 0.f;
  for (int i = 0; i < NSYM; ++i) Hs[i] = 0.f;
  Jm[8][NZ] = 1.f;  // stash_next = u
  Jm[9][NZ + 1] = 1.f;
  if constexpr (K == K_ST || K == K_ST_TERM) {
    rk4_jacobian(wf, kv, dsn, p, Jm);
    Jm[4][4] = 1.f;  // s_next = s + ds
    Jm[7][7] = 1.f;  // t_next = t + ds / s_dot
  } else if constexpr (K == K_SEAM) {
    // jets through the handoff over (Ux, Uy, r, delta, u_Fx); s, ey and t
    // pass through and epsi adds to beta
    using J5 = Jet<5, 1>;
    const int vidx[5] = {0, 1, 2, 3, NZ};
    J5 x[8];
    for (int i = 0; i < 8; ++i) x[i] = cst<J5>(wf[i]);
    for (int i = 0; i < 4; ++i) x[i] = seed<5, 1>(wf[i], i);
    J5 nxt[6];
    seam_map(x, seed<5, 1>(wf[NZ], 4) * FS, p, nxt);
    for (int r = 0; r < 6; ++r)
      for (int c = 0; c < 5; ++c) Jm[r][vidx[c]] = nxt[r].d[c];
    Jm[1][4] = 1.f;
    Jm[2][5] = 1.f;
    Jm[3][6] = 1.f;
    Jm[4][7] = 1.f;
  } else {
    // jets through the Euler step over (V, ey, epsi, u_Fx, u_Fy)
    using J5 = Jet<5, 1>;
    const int cols[5] = {0, 2, 3, NZ, NZ + 1};
    J5 x[5] = {seed<5, 1>(wf[0], 0), cst<J5>(wf[1]), seed<5, 1>(wf[2], 1), seed<5, 1>(wf[3], 2),
               cst<J5>(wf[4])};
    J5 nxt[5];
    pm_step(x, seed<5, 1>(wf[NZ], 3) * FS, seed<5, 1>(wf[NZ + 1], 4) * FS, kv, dsn, p, nxt);
    for (int r = 0; r < 5; ++r)
      for (int c = 0; c < 5; ++c) Jm[r][cols[c]] = nxt[r].d[c];
    Jm[1][1] = 1.f;  // s_next = s + ds
    Jm[4][4] = 1.f;  // t_next = t + ds / s_dot_eff
  }
  if constexpr (st_kind<K>())
    st_cost_derivs<K>(n, wf, lam, mu, dsn, dsp, p, g, Hs);
  else
    pm_cost_derivs<K>(n, H, wf, lam, mu, dsn, dsp, dss, p, g, Hs);
}

}  // namespace vct
