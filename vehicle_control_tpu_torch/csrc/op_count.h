// A float that counts its arithmetic, for the host build of the kernels'
// lane bodies with -DVCT_COUNT_OPS (csrc/host_driver.cpp): every float of
// the sources becomes a vct_count::F, so the library counts the f32
// operations that kernels 2-4 do on given inputs (chip_smoke.py's bounds).
//
// One operation each: +, -, *, / and unary minus of floats and a math
// function (sqrtf, expf, ...), as chip_smoke.count_ops counts one per output
// element of an elementwise op.  Comparisons, selects, copies and integer
// work are free, so the count is at most what the code does.  The
// arithmetic is float's, op by op, so the outputs are the plain host
// build's bit for bit.  Expressions in double (the tire constants) stay
// double and are not counted.
#pragma once

#include <float.h>
#include <math.h>
#include <stddef.h>
#include <string.h>

#include <type_traits>
#include <vector>

namespace vct_count {

inline double ops = 0.0;

constexpr void tick() {
  if (!__builtin_is_constant_evaluated()) ops += 1.0;
}

struct F {
  float x;
  F() = default;
  constexpr F(float v) : x(v) {}
  explicit constexpr operator double() const { return x; }
  explicit constexpr operator int() const { return (int)x; }
};

// a float, an int or another F with an F is F arithmetic (counted); a
// double with an F stays double (not counted)
template <class A>
using Mixed = std::enable_if_t<std::is_arithmetic_v<A>,
                               std::conditional_t<std::is_floating_point_v<A> &&
                                                      (sizeof(A) > sizeof(float)),
                                                  double, F>>;

#define VCT_COUNT_BINARY(OP)                                                       \
  constexpr F operator OP(F a, F b) { return tick(), F(a.x OP b.x); }              \
  template <class A>                                                               \
  constexpr Mixed<A> operator OP(A a, F b) {                                       \
    if constexpr (std::is_same_v<Mixed<A>, F>) return F((float)a) OP b;            \
    else return (double)a OP (double)b.x;                                          \
  }                                                                                \
  template <class A>                                                               \
  constexpr Mixed<A> operator OP(F a, A b) {                                       \
    if constexpr (std::is_same_v<Mixed<A>, F>) return a OP F((float)b);            \
    else return (double)a.x OP (double)b;                                          \
  }                                                                                \
  constexpr F& operator OP##=(F& a, F b) { return a = a OP b; }
VCT_COUNT_BINARY(+)
VCT_COUNT_BINARY(-)
VCT_COUNT_BINARY(*)
VCT_COUNT_BINARY(/)
#undef VCT_COUNT_BINARY

#define VCT_COUNT_COMPARE(OP) \
  constexpr bool operator OP(F a, F b) { return a.x OP b.x; }
VCT_COUNT_COMPARE(<)
VCT_COUNT_COMPARE(<=)
VCT_COUNT_COMPARE(>)
VCT_COUNT_COMPARE(>=)
VCT_COUNT_COMPARE(==)
VCT_COUNT_COMPARE(!=)
#undef VCT_COUNT_COMPARE

constexpr F operator-(F a) { return tick(), F(-a.x); }

// the sources' select of two values of one type, here of an F and a float
inline F Where(bool c, F a, F b) { return c ? a : b; }

}  // namespace vct_count

#define VCT_COUNT_UNARY(FN) \
  inline vct_count::F FN(vct_count::F a) { return vct_count::tick(), vct_count::F(::FN(a.x)); }
VCT_COUNT_UNARY(sqrtf)
VCT_COUNT_UNARY(expf)
VCT_COUNT_UNARY(log1pf)
VCT_COUNT_UNARY(tanhf)
VCT_COUNT_UNARY(fabsf)
VCT_COUNT_UNARY(sinf)
VCT_COUNT_UNARY(cosf)
#undef VCT_COUNT_UNARY

#define float vct_count::F
