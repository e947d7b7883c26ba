// Forward-mode Taylor jets: the CUDA twin of vehicle_control_tpu_torch/utils/jet.py.
//
// A Jet<N, K> is a float value with its first derivatives with respect to N
// seeded inputs and, for K == 2, the second derivatives: the upper triangle
// of the symmetric N x N block, row by row (N(N+1)/2 entries; hess(a, i, j)
// reads either triangle), so each entry is computed once and the block
// comes out exactly symmetric.  The physics
// in singletrack.cuh is written once as templates over the scalar type, so
// the same expression gives values (float) or exact derivatives (Jet).
// Non-smooth ops follow JAX's conventions as the Python twin does: max/min
// split the derivative 0.5/0.5 at a tie, |x|' = +1 at 0, sign' = 0, and a
// select takes the chosen branch's derivatives.
//
// Everything here is plain C++17 under VCT_HD, so a host compiler builds
// the same code for rehearsal without a GPU.
#pragma once

#include <float.h>
#include <math.h>
#include <stddef.h>

#if defined(__CUDACC__)
#define VCT_HD __host__ __device__ __forceinline__
// static: each .cu gets its own copy, so the two kernels' translation
// units link into one library without duplicate symbols
#define VCT_HD_NOINLINE static __host__ __device__ __noinline__
#else
#define VCT_HD inline
#define VCT_HD_NOINLINE static inline
#endif

namespace vct {

template <int N, int K>
struct Jet {
  static constexpr int NH = K == 2 ? N * (N + 1) / 2 : 1;
  float v;
  float d[N];
  float h[NH];
};

// the packed index of (i, j), i <= j, of an N x N upper triangle
template <int N>
VCT_HD constexpr int tri(int i, int j) { return i * (2 * N - i + 1) / 2 + j - i; }

template <int N>
VCT_HD float hess(const Jet<N, 2>& a, int i, int j) {
  return i <= j ? a.h[tri<N>(i, j)] : a.h[tri<N>(j, i)];
}

// -- constants, seeds, values -------------------------------------------------

template <class T>
struct Scalar {
  static VCT_HD T make(float c) { return c; }
};

template <int N, int K>
struct Scalar<Jet<N, K>> {
  static VCT_HD Jet<N, K> make(float c) {
    Jet<N, K> r;
    r.v = c;
    for (int i = 0; i < N; ++i) r.d[i] = 0.f;
    if constexpr (K == 2)
      for (int i = 0; i < Jet<N, K>::NH; ++i) r.h[i] = 0.f;
    return r;
  }
};

// a constant of scalar type T (zero derivatives for a jet)
template <class T>
VCT_HD T cst(float c) { return Scalar<T>::make(c); }

// the jet of input i: value v, first derivative e_i
template <int N, int K>
VCT_HD Jet<N, K> seed(float v, int i) {
  Jet<N, K> r = cst<Jet<N, K>>(v);
  r.d[i] = 1.f;
  return r;
}

VCT_HD float val(float x) { return x; }
template <int N, int K>
VCT_HD float val(const Jet<N, K>& x) { return x.v; }

VCT_HD bool finite(float x) { return fabsf(x) <= FLT_MAX; }

// a product rounded on its own, never fused into a neighbouring add (FMA
// contraction): a jet's value is rounded as the plain version's, op by op,
// so a PHR row's activity and a branch's side, which turn on values that sit
// on a constraint's boundary at a solver's optimum, come out as there
VCT_HD float mul_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

// NaN-propagating max/min of values (as torch.maximum / jnp.maximum)
VCT_HD float vmax(float a, float b) { return (a != a || b != b) ? a + b : (a > b ? a : b); }
VCT_HD float vmin(float a, float b) { return (a != a || b != b) ? a + b : (a < b ? a : b); }

// -- arithmetic ------------------------------------------------------------------

template <int N, int K>
VCT_HD Jet<N, K> operator-(const Jet<N, K>& a) {
  Jet<N, K> r;
  r.v = -a.v;
  for (int i = 0; i < N; ++i) r.d[i] = -a.d[i];
  if constexpr (K == 2)
    for (int i = 0; i < Jet<N, K>::NH; ++i) r.h[i] = -a.h[i];
  return r;
}

template <int N, int K>
VCT_HD Jet<N, K> operator+(const Jet<N, K>& a, const Jet<N, K>& b) {
  Jet<N, K> r;
  r.v = a.v + b.v;
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] + b.d[i];
  if constexpr (K == 2)
    for (int i = 0; i < Jet<N, K>::NH; ++i) r.h[i] = a.h[i] + b.h[i];
  return r;
}

template <int N, int K>
VCT_HD Jet<N, K> operator+(const Jet<N, K>& a, float c) {
  Jet<N, K> r = a;
  r.v = a.v + c;
  return r;
}

template <int N, int K>
VCT_HD Jet<N, K> operator+(float c, const Jet<N, K>& a) { return a + c; }

template <int N, int K>
VCT_HD Jet<N, K> operator-(const Jet<N, K>& a, const Jet<N, K>& b) {
  Jet<N, K> r;
  r.v = a.v - b.v;
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] - b.d[i];
  if constexpr (K == 2)
    for (int i = 0; i < Jet<N, K>::NH; ++i) r.h[i] = a.h[i] - b.h[i];
  return r;
}

template <int N, int K>
VCT_HD Jet<N, K> operator-(const Jet<N, K>& a, float c) {
  Jet<N, K> r = a;
  r.v = a.v - c;
  return r;
}

template <int N, int K>
VCT_HD Jet<N, K> operator-(float c, const Jet<N, K>& a) {
  Jet<N, K> r = -a;
  r.v = c - a.v;
  return r;
}

template <int N, int K>
VCT_HD Jet<N, K> operator*(const Jet<N, K>& a, const Jet<N, K>& b) {
  Jet<N, K> r;
  r.v = mul_rn(a.v, b.v);
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b.v + b.d[i] * a.v;
  if constexpr (K == 2)
    for (int i = 0, e = 0; i < N; ++i)
      for (int j = i; j < N; ++j, ++e)
        r.h[e] = a.h[e] * b.v + b.h[e] * a.v + a.d[i] * b.d[j] + b.d[i] * a.d[j];
  return r;
}

template <int N, int K>
VCT_HD Jet<N, K> operator*(const Jet<N, K>& a, float c) {
  Jet<N, K> r;
  r.v = mul_rn(a.v, c);
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * c;
  if constexpr (K == 2)
    for (int i = 0; i < Jet<N, K>::NH; ++i) r.h[i] = a.h[i] * c;
  return r;
}

template <int N, int K>
VCT_HD Jet<N, K> operator*(float c, const Jet<N, K>& a) { return a * c; }

template <int N, int K>
VCT_HD Jet<N, K> operator/(const Jet<N, K>& a, const Jet<N, K>& b) {
  Jet<N, K> r;
  r.v = a.v / b.v;
  for (int i = 0; i < N; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) / b.v;
  if constexpr (K == 2)
    for (int i = 0, e = 0; i < N; ++i)
      for (int j = i; j < N; ++j, ++e)
        r.h[e] = (a.h[e] - r.v * b.h[e] - r.d[i] * b.d[j] - b.d[i] * r.d[j]) / b.v;
  return r;
}

template <int N, int K>
VCT_HD Jet<N, K> operator/(const Jet<N, K>& a, float c) {
  Jet<N, K> r;
  r.v = a.v / c;
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] / c;
  if constexpr (K == 2)
    for (int i = 0; i < Jet<N, K>::NH; ++i) r.h[i] = a.h[i] / c;
  return r;
}

template <int N, int K>
VCT_HD Jet<N, K> operator/(float c, const Jet<N, K>& b) {
  Jet<N, K> r;
  r.v = c / b.v;
  for (int i = 0; i < N; ++i) r.d[i] = -r.v * b.d[i] / b.v;
  if constexpr (K == 2)
    for (int i = 0, e = 0; i < N; ++i)
      for (int j = i; j < N; ++j, ++e)
        r.h[e] = (-r.v * b.h[e] - r.d[i] * b.d[j] - b.d[i] * r.d[j]) / b.v;
  return r;
}

// -- elementwise functions ---------------------------------------------------------

// the jet of f(a) from f(a.v), f'(a.v) and f''(a.v); on a value, f(a)
VCT_HD float chain(float, float f0, float, float) { return f0; }
template <int N, int K>
VCT_HD Jet<N, K> chain(const Jet<N, K>& a, float f0, float f1, float f2) {
  Jet<N, K> r;
  r.v = f0;
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * f1;
  if constexpr (K == 2)
    for (int i = 0, e = 0; i < N; ++i)
      for (int j = i; j < N; ++j, ++e) r.h[e] = a.h[e] * f1 + f2 * (a.d[i] * a.d[j]);
  return r;
}

VCT_HD float Sin(float x) { return sinf(x); }
template <int N, int K>
VCT_HD Jet<N, K> Sin(const Jet<N, K>& a) {
  float s = sinf(a.v);
  return chain(a, s, cosf(a.v), -s);
}

VCT_HD float Cos(float x) { return cosf(x); }
template <int N, int K>
VCT_HD Jet<N, K> Cos(const Jet<N, K>& a) {
  float c = cosf(a.v);
  return chain(a, c, -sinf(a.v), -c);
}

VCT_HD float Tanh(float x) { return tanhf(x); }
template <int N, int K>
VCT_HD Jet<N, K> Tanh(const Jet<N, K>& a) {
  float t = tanhf(a.v);
  float g = 1.f - t * t;
  return chain(a, t, g, -2.f * t * g);
}

VCT_HD float Sqrt(float x) { return sqrtf(x); }
template <int N, int K>
VCT_HD Jet<N, K> Sqrt(const Jet<N, K>& a) {
  float r = sqrtf(a.v);
  float g = 0.5f / r;
  return chain(a, r, g, -0.5f * g / a.v);
}

VCT_HD float Abs(float x) { return fabsf(x); }
template <int N, int K>
VCT_HD Jet<N, K> Abs(const Jet<N, K>& a) { return a.v >= 0.f ? a : -a; }

// sign of the value; a constant for differentiation
template <class T>
VCT_HD float Sign(const T& x) { return (val(x) > 0.f) - (val(x) < 0.f); }

// JAX's tie rule: weight 1 where a > b, 0 where a < b, 0.5 at a tie
VCT_HD float tie_weight(float a, float b) { return a > b ? 1.f : (a < b ? 0.f : 0.5f); }

template <int N, int K>
VCT_HD Jet<N, K> blend(float v, const Jet<N, K>& a, float wa, const Jet<N, K>& b) {
  Jet<N, K> r;
  r.v = v;
  float wb = 1.f - wa;
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * wa + b.d[i] * wb;
  if constexpr (K == 2)
    for (int i = 0; i < Jet<N, K>::NH; ++i) r.h[i] = a.h[i] * wa + b.h[i] * wb;
  return r;
}

VCT_HD float Max(float a, float b) { return vmax(a, b); }
template <int N, int K>
VCT_HD Jet<N, K> Max(const Jet<N, K>& a, const Jet<N, K>& b) {
  return blend(vmax(a.v, b.v), a, tie_weight(a.v, b.v), b);
}
template <int N, int K>
VCT_HD Jet<N, K> Max(const Jet<N, K>& a, float c) { return Max(a, cst<Jet<N, K>>(c)); }
template <int N, int K>
VCT_HD Jet<N, K> Max(float c, const Jet<N, K>& b) { return Max(cst<Jet<N, K>>(c), b); }

VCT_HD float Min(float a, float b) { return vmin(a, b); }
template <int N, int K>
VCT_HD Jet<N, K> Min(const Jet<N, K>& a, const Jet<N, K>& b) {
  return blend(vmin(a.v, b.v), a, tie_weight(b.v, a.v), b);
}
template <int N, int K>
VCT_HD Jet<N, K> Min(const Jet<N, K>& a, float c) { return Min(a, cst<Jet<N, K>>(c)); }

// jnp.clip: minimum(maximum(x, lo), hi)
template <class T>
VCT_HD T Clip(const T& x, float lo, float hi) { return Min(Max(x, lo), hi); }

// select by a value-level condition
template <class T>
VCT_HD T Where(bool c, const T& a, const T& b) { return c ? a : b; }
template <int N, int K>
VCT_HD Jet<N, K> Where(bool c, const Jet<N, K>& a, float b) { return c ? a : cst<Jet<N, K>>(b); }

// logaddexp(0, y) with jnp.logaddexp's value formula and derivative exp(y - out)
VCT_HD float Softplus0(float y) { return vmax(y, 0.f) + log1pf(expf(-fabsf(y))); }
template <int N, int K>
VCT_HD Jet<N, K> Softplus0(const Jet<N, K>& y) {
  float out = Softplus0(y.v);
  float g = expf(y.v - out);
  return chain(y, out, g, g * (1.f - g));
}

}  // namespace vct
