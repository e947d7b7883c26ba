// The cascaded family's device functions: the CUDA transcription of
// vehicle_control_tpu_torch/solvers/fm_singletrack.py, models/dynamic_car.py
// and the closures of solvers/fm_family.py (stage_cost, constraints,
// al_cost, dyn, u_box, stage_derivs) for tail="none" (N = H single-track
// stages) and tail="pm" (N single-track stages, then H - N point-mass
// stages), plus the per-lane pieces the kernels share: the closed-loop stage
// of a line-search candidate (kernels 1, 3 and 5) and the backward sweep
// (kernels 2 and 3).  Templates over the scalar type give values (float) and
// exact derivatives (Jet).  The polynomial arctan is kept, as on every path
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

#include "jet.cuh"

namespace vct {

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

// Car parameters, cost weights and bounds of the family, every field a
// float; the order is cuda_lib.PARAM_FIELDS.  Passed to the kernels by value.
struct STParams {
  float m, Izz, a, b, l, h, eps, Peng, Xdf, Xdr, Xbf, Xbr, Caf, Car, mu_f, mu_r,
      gcc, Av2, Cd, Frr;
  float w_time, w_speed, w_ey, w_epsi, w_w, w_Fx, w_dev, w_boundary, w_slip;
  float Ux_min, max_speed, delta_min, delta_max, ey_min, ey_max, w_min, w_max;
  float u0_lo, u0_hi, u1_lo, u1_hi;  // rollout control boxes (solver units)
  // the point-mass tail (tail="pm"; zero for the single-track family)
  float w_dev_pm, w_Fy, w_switch_F, V_min, ey_min_pm, ey_max_pm, u1_lo_pm, u1_hi_pm;
  float N;   // single-track stages (H for tail="none")
  float pm;  // 1 for tail="pm", 0 for tail="none"
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
VCT_HD void with_kind(int kind, F&& f) {
  switch (kind) {
    case K_ST: f(KindC<K_ST>{}); break;
    case K_ST_TERM: f(KindC<K_ST_TERM>{}); break;
    case K_SEAM: f(KindC<K_SEAM>{}); break;
    case K_SWITCH: f(KindC<K_SWITCH>{}); break;
    case K_TAIL: f(KindC<K_TAIL>{}); break;
    default: f(KindC<K_TERM>{}); break;
  }
}

// f(n, KindC<kind of n>{}) for every stage in order, one segment at a time
template <class F>
VCT_HD void for_each_stage(int H, const STParams& p, F&& f) {
  Segments sg = segments(H, p);
  for (int s = 0; s < sg.count; ++s) {
    int lo = sg.lo[s], hi = sg.hi[s];
    with_kind(sg.kind[s], [&](auto kc) {
      for (int n = lo; n < hi; ++n) f(n, kc);
    });
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

template <class T>
VCT_HD T Tan(const T& x) { return Sin(x) / Cos(x); }

// polynomial arctan r(z) = z P(z^2), |err| < 3.5e-11 in exact arithmetic;
// on a jet, P, P' and P''/2 come from one Horner pass on values and are
// chained in once (utils/math.py: arctan)
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
  float zv = val(z), t = zv * zv;
  float p = C[12], p1 = 0.f, p2 = 0.f;
  for (int i = 11; i >= 0; --i) {
    p2 = p2 * t + p1;
    p1 = p1 * t + p;
    p = p * t + C[i];
  }
  // r' = P + 2t P', r'' = 6z P' + 4z t P''
  T r = chain(z, zv * p, p + 2.f * t * p1, zv * (6.f * p1 + 8.f * t * p2));
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

template <class T>
VCT_HD T boundary(const T& ey, float dsn, float lo, float hi, const STParams& p) {
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

// the family's raw stage cost (no penalty) at stage n of H; dss is the arc
// step of the seam stage N-1, which the switching cost reads
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
    if constexpr (K == K_ST_TERM) cost = cost + terminal(x[0], x[5], x[6], x[7], p);
    return cost;
  } else {
    // point mass: u1 is Fy in kN; the previous u1 is in kN from N+1 on
    T Fx = wf[NZ] * FS, Fy = wf[NZ + 1] * FS, Fx_prev = wf[8] * FS;
    const T& ey = wf[2];
    T cost = boundary(ey, dsn, p.ey_min_pm, p.ey_max_pm, p);
    cost = cost + p.w_dev_pm * dsn * (ey * ey);
    if constexpr (K == K_SWITCH)  // switching cost against the seam's stash z[5]
      cost = cost + (p.w_switch_F / dss) * (sq(Fx - Fx_prev) + sq(Fy - wf[5]));
    else  // Fx/Fy slew
      cost = cost + ((p.w_Fx / dsp) * sq(Fx - Fx_prev) + (p.w_Fy / dsp) * sq(Fy - wf[9] * FS));
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
// steering stop, the seam, or the point-mass Euler step; stash = u
template <int K>
VCT_HD void dyn(const float wf[NW], float kv, float dsn, const STParams& p, float out[NZ]) {
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

// the Hessian of a single-track stage's AL cost (the seam's included):
// second-order jets on the nonquadratic block, the rest in closed form
template <int K>
VCT_HD void st_hessian(int n, const float wf[NW], const float lam[NC], float mu, float dsn,
                       float dsp, const STParams& p, float Hw[NW][NW]) {
  {  // nonquadratic block over (Ux, Uy, r, delta, u_Fx): second-order jets
    using H5 = Jet<5, 2>;
    const int vidx[5] = {0, 1, 2, 3, NZ};
    H5 x[8];
    for (int i = 0; i < 8; ++i) x[i] = cst<H5>(wf[i]);
    for (int i = 0; i < 4; ++i) x[i] = seed<5, 2>(wf[i], i);
    H5 Fx = seed<5, 2>(wf[NZ], 4) * FS;
    H5 c[NC];
    constraints(x, Fx, cst<H5>(wf[NZ + 1]), p, c);
    const int rows[5] = {3, 6, 7, 8, 9};
    H5 pen = cst<H5>(0.f);
    for (int j = 0; j < 5; ++j) pen = pen + phr(c[rows[j]], lam[rows[j]], mu);
    H5 block = slip_penalty(x, Fx, p) + pen / (2.f * mu);
    for (int i = 0; i < 5; ++i)
      for (int j = 0; j < 5; ++j) Hw[vidx[i]][vidx[j]] = block.h[i * 5 + j];
  }
  // closed-form quadratic / piecewise-quadratic entries
  float c[NC];
  stage_constraints<K>(n, wf, p, c);
  float act[NC];
  for (int j = 0; j < NC; ++j) act[j] = active(lam[j] + mu * c[j]);
  float keep = n == 0 ? 0.f : 1.f;
  float termf = K == K_ST_TERM ? 1.f : 0.f;
  float Ux = wf[0], ey = wf[5];
  Hw[0][0] += mu * act[0] * keep + termf * (2.f * p.w_speed) * (Ux >= p.max_speed ? 1.f : 0.f);
  Hw[3][3] += mu * (act[1] + act[2]) * keep;
  Hw[NZ + 1][NZ + 1] = 2.f * p.w_w + mu * (act[4] + act[5]);
  float blo = ey < p.ey_min ? 1.f : 0.f, bhi = ey > p.ey_max ? 1.f : 0.f;
  Hw[5][5] += 2.f * p.w_boundary * dsn * (blo + bhi) + 2.f * p.w_dev * dsn + termf * (2.f * p.w_ey);
  Hw[6][6] = termf * (2.f * p.w_epsi);
  if (n >= 1) {  // Fx slew against the previous action
    float coef = (2.f * p.w_Fx / dsp) * (FS * FS);
    Hw[8][8] += coef;
    Hw[8][NZ] -= coef;
    Hw[NZ][8] -= coef;
    Hw[NZ][NZ] += coef;
  }
}

// the Hessian of a point-mass stage's AL cost, all in closed form
template <int K>
VCT_HD void pm_hessian(int n, int H, const float wf[NW], const float lam[NC], float mu,
                       float dsn, float dsp, float dss, const STParams& p, float Hw[NW][NW]) {
  const float fs = 1.f / FS;
  float c[NC];
  stage_constraints<K>(n, wf, p, c);
  float V = wf[0], ey = wf[2];
  float blo = ey < p.ey_min_pm ? 1.f : 0.f, bhi = ey > p.ey_max_pm ? 1.f : 0.f;
  Hw[2][2] = 2.f * p.w_boundary * dsn * (blo + bhi) + 2.f * p.w_dev_pm * dsn;
  // constraint rows: 0 the V floor (linear), 1 the engine power
  Hw[0][0] += mu * active(lam[0] + mu * c[0]);
  float Vm = vmax(V, 1.f);
  float liveV = (V > 1.f ? 1.f : 0.f) + (V == 1.f ? 0.5f : 0.f);  // max's tie rule
  float gV = fs * p.Peng / (Vm * Vm) * liveV;  // d c1 / dV; d c1 / du_Fx = 1
  float lam_hat1 = vmax(lam[1] + mu * c[1], 0.f);
  float a1 = mu * active(lam[1] + mu * c[1]);
  Hw[0][0] += a1 * gV * gV + lam_hat1 * (-2.f * fs * p.Peng / (Vm * Vm * Vm)) * liveV;
  Hw[0][NZ] += a1 * gV;
  Hw[NZ][0] += a1 * gV;
  Hw[NZ][NZ] += a1;
  if constexpr (K == K_SWITCH) {  // switching cost: Fx against the stash, Fy against z[5]
    float cw = 2.f * p.w_switch_F / dss;
    Hw[NZ][NZ] += cw * (FS * FS);
    Hw[NZ][8] -= cw * (FS * FS);
    Hw[8][NZ] -= cw * (FS * FS);
    Hw[8][8] += cw * (FS * FS);
    Hw[NZ + 1][NZ + 1] += cw * (FS * FS);
    Hw[NZ + 1][5] -= cw * FS;
    Hw[5][NZ + 1] -= cw * FS;
    Hw[5][5] += cw;
  } else {  // Fx/Fy slew (both previous actions in kN)
    const float w_sl[2] = {p.w_Fx, p.w_Fy};
    for (int j = 0; j < 2; ++j) {
      float coef = (2.f * w_sl[j] / dsp) * (FS * FS);
      Hw[8 + j][8 + j] += coef;
      Hw[8 + j][NZ + j] -= coef;
      Hw[NZ + j][8 + j] -= coef;
      Hw[NZ + j][NZ + j] += coef;
    }
  }
  if (K == K_TERM || n == H - 1) {  // terminal cost on the point-mass fields
    Hw[0][0] += (2.f * p.w_speed) * (V >= p.max_speed ? 1.f : 0.f);
    Hw[2][2] += 2.f * p.w_ey;
    Hw[3][3] += 2.f * p.w_epsi;
  }
}

// g (NW), unsymmetrized Hessian Hw[r][c] = d2L/dw_r dw_c, Jacobian Jm[r][c]
// at stage n of kind K
template <int K>
VCT_HD_NOINLINE void stage_derivs(int n, int H, const float wf[NW], const float lam[NC],
                                  float mu, float kv, float dsn, float dsp, float dss,
                                  const STParams& p, float g[NW], float Hw[NW][NW],
                                  float Jm[NZ][NW]) {
  {  // gradient of the full AL cost: first-order jets over all 12 inputs
    using J12 = Jet<NW, 1>;
    J12 w[NW];
    for (int i = 0; i < NW; ++i) w[i] = seed<NW, 1>(wf[i], i);
    J12 L = al_cost<K>(n, H, w, lam, mu, dsn, dsp, dss, p);
    for (int i = 0; i < NW; ++i) g[i] = L.d[i];
  }
  for (int r = 0; r < NZ; ++r)
    for (int c = 0; c < NW; ++c) Jm[r][c] = 0.f;
  for (int r = 0; r < NW; ++r)
    for (int c = 0; c < NW; ++c) Hw[r][c] = 0.f;
  Jm[8][NZ] = 1.f;  // stash_next = u
  Jm[9][NZ + 1] = 1.f;
  if constexpr (K == K_ST || K == K_ST_TERM) {
    // dynamics Jacobian: jets over (Ux, Uy, r, delta, ey, epsi, u_Fx, w)
    using J8 = Jet<8, 1>;
    const int cols[6] = {0, 1, 2, 3, 5, 6};
    J8 x[8];
    for (int i = 0; i < 8; ++i) x[i] = cst<J8>(wf[i]);
    for (int c = 0; c < 6; ++c) x[cols[c]] = seed<8, 1>(wf[cols[c]], c);
    J8 Fx = seed<8, 1>(wf[NZ], 6) * FS;
    J8 w = seed<8, 1>(wf[NZ + 1], 7);
    J8 nxt[8];
    rk4_step(x, Fx, w, kv, dsn, p, nxt);
    nxt[3] = Clip(nxt[3], p.delta_min, p.delta_max);
    for (int r = 0; r < 8; ++r) {
      for (int c = 0; c < 6; ++c) Jm[r][cols[c]] = nxt[r].d[c];
      Jm[r][NZ] = nxt[r].d[6];
      Jm[r][NZ + 1] = nxt[r].d[7];
    }
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
    st_hessian<K>(n, wf, lam, mu, dsn, dsp, p, Hw);
  else
    pm_hessian<K>(n, H, wf, lam, mu, dsn, dsp, dss, p, Hw);
}

// -- per-lane kernel bodies ----------------------------------------------------------------

// SoA indexing helpers: (stage, field, scenario)
VCT_HD int at2(int n, int f, int F, int b, int B) { return (n * F + f) * B + b; }

// one stage of one lane as the closed-loop rollouts read it: the reference
// state and control, the gains, the multipliers, the arc parameters (dss:
// the seam stage's arc step) and the control box
struct Stage {
  float xref[NZ], uref[NU], kff[NU], kfb[NU][NZ], lam[NC];
  float kv, dsn, dsp, dss;
  float lo[NU], hi[NU];
};

VCT_HD void load_stage(int n, int b, int B, const float* X, const float* U, const float* kff,
                       const float* kfb, const float* lam, const float* curv, const float* ds,
                       const STParams& p, Stage& s) {
  for (int i = 0; i < NZ; ++i) s.xref[i] = X[at2(n, i, NZ, b, B)];
  for (int j = 0; j < NU; ++j) {
    s.uref[j] = U[at2(n, j, NU, b, B)];
    s.kff[j] = kff[at2(n, j, NU, b, B)];
    for (int i = 0; i < NZ; ++i) s.kfb[j][i] = kfb[((size_t)(n * NU + j) * NZ + i) * B + b];
  }
  for (int j = 0; j < NC; ++j) s.lam[j] = lam[at2(n, j, NC, b, B)];
  s.kv = curv[n * B + b];
  s.dsn = ds[n * B + b];
  s.dsp = ds[(n > 0 ? n - 1 : 0) * B + b];
  s.dss = ds[seam_stage(p) * B + b];
  stage_box(n, p, s.lo, s.hi);
}

// the closed-loop law u = clip(uref + alpha*kff + Kfb (z - xref), u_box).
// Not inlined, so the line search and the re-roll of its choice run the
// same instructions and agree to the bit.
VCT_HD_NOINLINE void feedback_u(float alpha, const float z[NZ], const Stage& s, float u[NU]) {
  float dz[NZ];
  for (int i = 0; i < NZ; ++i) dz[i] = z[i] - s.xref[i];
  for (int j = 0; j < NU; ++j) {
    float fb = dz[0] * s.kfb[j][0];
    for (int i = 1; i < NZ; ++i) fb = fb + dz[i] * s.kfb[j][i];
    float uj = s.uref[j] + alpha * s.kff[j] + fb;
    u[j] = vmin(vmax(uj, s.lo[j]), s.hi[j]);
  }
}

// one stage of kind K of a line-search candidate: adds the AL stage cost to
// acc and steps z; a next state that is non-finite or reaches |z| >= 1e7
// makes acc +inf for good
template <int K>
VCT_HD void candidate_stage(int n, int H, float alpha, float mu, const Stage& s,
                            const STParams& p, float z[NZ], float& acc) {
  float wf[NW], nxt[NZ];
  feedback_u(alpha, z, s, wf + NZ);
  for (int i = 0; i < NZ; ++i) wf[i] = z[i];
  float cost = al_cost<K>(n, H, wf, s.lam, mu, s.dsn, s.dsp, s.dss, p);
  dyn<K>(wf, s.kv, s.dsn, p, nxt);
  bool ok = true;
  for (int i = 0; i < NZ; ++i) {
    ok = ok && finite(nxt[i]) && fabsf(nxt[i]) < 1e7f;
    z[i] = nxt[i];
  }
  acc = ok ? acc + cost : INFINITY;
}

// kernel 1: the line-search cost of step size alpha for scenario b
VCT_HD void linesearch_lane(int b, int B, int H, float alpha, const float* xref,
                            const float* uref, const float* kff, const float* kfb,
                            const float* lam, const float* mu, const float* curv,
                            const float* ds, const float* z0, float* cost_out,
                            const STParams& p) {
  float z[NZ];
  for (int i = 0; i < NZ; ++i) z[i] = z0[i * B + b];
  float m = mu[b], acc = 0.f;
  for_each_stage(H, p, [&](int n, auto kc) {
    Stage s;
    load_stage(n, b, B, xref, uref, kff, kfb, lam, curv, ds, p, s);
    candidate_stage<decltype(kc)::value>(n, H, alpha, m, s, p, z, acc);
  });
  cost_out[b] = finite(acc) ? acc : INFINITY;
}

// the fused backward pass (derivatives + Riccati) of scenario b: writes the
// gains kff (H, NU, B) and kfb (H, NU, NZ, B); returns the expected-decrease
// terms and whether some stage's regularized Quu was not positive definite.
// The stages run backward one segment at a time; each takes the stage
// derivatives of its kind, then the Riccati step with the closed-form 2x2
// solve of Quu + rho I.
VCT_HD void backward_sweep(int b, int B, int H, const float* X, const float* U,
                           const float* lam, float mu, float rho, const float* curv,
                           const float* ds, float* kff, float* kfb, float& dV1_out,
                           float& dV2_out, bool& fail_out, const STParams& p) {
  float Vx[NZ], Vxx[NZ][NZ];
  for (int r = 0; r < NZ; ++r) {
    Vx[r] = 0.f;
    for (int c = 0; c < NZ; ++c) Vxx[r][c] = 0.f;
  }
  float dV1 = 0.f, dV2 = 0.f;
  bool fail = false;
  const float dss = ds[seam_stage(p) * B + b];
  Segments sg = segments(H, p);
  for (int seg = sg.count - 1; seg >= 0; --seg) {
    for (int n = sg.hi[seg] - 1; n >= sg.lo[seg]; --n) {
      float wf[NW], lamv[NC], g[NW], Hw[NW][NW], Jm[NZ][NW];
      for (int i = 0; i < NZ; ++i) wf[i] = X[at2(n, i, NZ, b, B)];
      for (int j = 0; j < NU; ++j) wf[NZ + j] = U[at2(n, j, NU, b, B)];
      for (int j = 0; j < NC; ++j) lamv[j] = lam[at2(n, j, NC, b, B)];
      const float kv = curv[n * B + b], dsn = ds[n * B + b];
      const float dsp = ds[(n > 0 ? n - 1 : 0) * B + b];
      with_kind(sg.kind[seg], [&](auto kc) {
        stage_derivs<decltype(kc)::value>(n, H, wf, lamv, mu, kv, dsn, dsp, dss, p, g, Hw, Jm);
      });
      // Q terms; A = Jm[:, :NZ], B = Jm[:, NZ:], Hessian symmetrized
      float Qx[NZ], Qu[NU], VxxA[NZ][NZ], VxxB[NZ][NU], Qxx[NZ][NZ], Qux[NU][NZ], Quu[NU][NU];
      for (int r = 0; r < NZ; ++r) {
        float s = g[r];
        for (int k = 0; k < NZ; ++k) s += Jm[k][r] * Vx[k];
        Qx[r] = s;
      }
      for (int j = 0; j < NU; ++j) {
        float s = g[NZ + j];
        for (int k = 0; k < NZ; ++k) s += Jm[k][NZ + j] * Vx[k];
        Qu[j] = s;
      }
      for (int r = 0; r < NZ; ++r) {
        for (int c = 0; c < NZ; ++c) {
          float s = 0.f;
          for (int k = 0; k < NZ; ++k) s += Vxx[r][k] * Jm[k][c];
          VxxA[r][c] = s;
        }
        for (int j = 0; j < NU; ++j) {
          float s = 0.f;
          for (int k = 0; k < NZ; ++k) s += Vxx[r][k] * Jm[k][NZ + j];
          VxxB[r][j] = s;
        }
      }
      for (int r = 0; r < NZ; ++r)
        for (int c = 0; c < NZ; ++c) {
          float s = 0.5f * (Hw[r][c] + Hw[c][r]);
          for (int k = 0; k < NZ; ++k) s += Jm[k][r] * VxxA[k][c];
          Qxx[r][c] = s;
        }
      for (int j = 0; j < NU; ++j) {
        for (int c = 0; c < NZ; ++c) {
          float s = 0.5f * (Hw[NZ + j][c] + Hw[c][NZ + j]);
          for (int k = 0; k < NZ; ++k) s += Jm[k][NZ + j] * VxxA[k][c];
          Qux[j][c] = s;
        }
        for (int l = 0; l < NU; ++l) {
          float s = 0.5f * (Hw[NZ + j][NZ + l] + Hw[NZ + l][NZ + j]);
          for (int k = 0; k < NZ; ++k) s += Jm[k][NZ + j] * VxxB[k][l];
          Quu[j][l] = s;
        }
      }
      // closed-form solve with Quu + rho I; not PD when a <= 0 or det <= 0
      float a = 0.5f * (Quu[0][0] + Quu[0][0]) + rho;
      float bb = 0.5f * (Quu[0][1] + Quu[1][0]);
      float d = 0.5f * (Quu[1][1] + Quu[1][1]) + rho;
      float det = a * d - bb * bb;
      bool bad = (a <= 0.f) || (det <= 0.f);
      float inv_det = bad ? 1.f : 1.f / det;
      float k0 = -((d * Qu[0] - bb * Qu[1]) * inv_det);
      float k1 = -((a * Qu[1] - bb * Qu[0]) * inv_det);
      float K[NU][NZ];
      for (int c = 0; c < NZ; ++c) {
        K[0][c] = -((d * Qux[0][c] - bb * Qux[1][c]) * inv_det);
        K[1][c] = -((a * Qux[1][c] - bb * Qux[0][c]) * inv_det);
      }
      kff[at2(n, 0, NU, b, B)] = k0;
      kff[at2(n, 1, NU, b, B)] = k1;
      for (int j = 0; j < NU; ++j)
        for (int c = 0; c < NZ; ++c) kfb[((size_t)(n * NU + j) * NZ + c) * B + b] = K[j][c];
      // value function update with the regularized Quu
      float Quuk0 = a * k0 + bb * k1, Quuk1 = bb * k0 + d * k1;
      float QuuK[NU][NZ];
      for (int c = 0; c < NZ; ++c) {
        QuuK[0][c] = a * K[0][c] + bb * K[1][c];
        QuuK[1][c] = bb * K[0][c] + d * K[1][c];
      }
      for (int c = 0; c < NZ; ++c)
        Vx[c] = Qx[c] + K[0][c] * (Quuk0 + Qu[0]) + K[1][c] * (Quuk1 + Qu[1]) + Qux[0][c] * k0 +
                Qux[1][c] * k1;
      for (int r = 0; r < NZ; ++r)
        for (int c = 0; c < NZ; ++c)
          Qxx[r][c] += K[0][r] * QuuK[0][c] + K[1][r] * QuuK[1][c] + K[0][r] * Qux[0][c] +
                       K[1][r] * Qux[1][c] + Qux[0][r] * K[0][c] + Qux[1][r] * K[1][c];
      for (int r = 0; r < NZ; ++r)
        for (int c = 0; c < NZ; ++c) Vxx[r][c] = 0.5f * (Qxx[r][c] + Qxx[c][r]);
      dV1 += k0 * Qu[0] + k1 * Qu[1];
      dV2 += 0.5f * (k0 * Quuk0 + k1 * Quuk1);
      fail = fail || bad;
    }
  }
  dV1_out = dV1;
  dV2_out = dV2;
  fail_out = fail;
}

// kernel 2: the backward pass of scenario b; dv (2, B), fail_out (B) as 0/1
VCT_HD void backward_lane(int b, int B, int H, const float* X, const float* U,
                          const float* lam, const float* mu, const float* rho,
                          const float* curv, const float* ds, float* kff, float* kfb,
                          float* dv, float* fail_out, const STParams& p) {
  bool fail;
  backward_sweep(b, B, H, X, U, lam, mu[b], rho[b], curv, ds, kff, kfb, dv[b], dv[B + b], fail,
                 p);
  fail_out[b] = fail ? 1.f : 0.f;
}

}  // namespace vct
