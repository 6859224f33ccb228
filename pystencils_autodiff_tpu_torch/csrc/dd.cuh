// Extended-precision wide sums: the accumulate="dd" mode of the emitted
// single-step body (codegen/cuda_printer.py::_emit_dd), the counterpart of
// the double-word float32 TwoProd/TwoSum trees the JAX package compiles into
// its Pallas kernels (pystencils_autodiff_tpu/ops/common.py::_compile_dd_add).
//
// A wide sum (8 or more addends) is evaluated in an accumulator type A that
// depends on the compute type T of the kernel:
//
//   T = float (float32 and bfloat16 storage): A = double.  The card has
//       float64 arithmetic, so no pair is needed: each leaf is converted up
//       once, products and the pairwise tree run in float64, and the sum is
//       rounded to float once.  The fields keep their storage; the cost is
//       the conversions and float64 operations, not bytes.
//   T = double: A = dd2, a double-word pair (hi + lo): TwoProd as
//       p = a*b; e = fma(a, b, -p) (exact, the same pair as Veltkamp's
//       split in the plain version), TwoSum as Knuth's.
//
// Every product and sum goes through the round-to-nearest intrinsics
// (__dmul_rn, __dadd_rn, __dsub_rn), which the compiler never contracts
// into an fma: the body rounds where the plain version
// (ops/common.py::_compile_dd_add, eager PyTorch, which does not contract)
// rounds, so the two agree bit for bit on the tree.  Leaves (reads,
// subexpressions, non-arithmetic terms) are computed in T as in pairwise
// mode and enter the tree exactly; a dd library is built with
// --fmad=false (the printer asks for it in the source), so a leaf's mul
// and add round where the plain version's do too.
#pragma once

#include <cuda_runtime.h>
#include <type_traits>

namespace psat {

struct dd2 {
    double hi, lo;
};

template <typename T>
struct DdAcc {
    using type = double;
};
template <>
struct DdAcc<double> {
    using type = dd2;
};

__device__ __forceinline__ dd2 dd_two_sum(double a, double b) {
    const double s = __dadd_rn(a, b);
    const double bp = __dsub_rn(s, a);
    const double e = __dadd_rn(__dsub_rn(a, __dsub_rn(s, bp)),
                               __dsub_rn(b, bp));
    return {s, e};
}

// a leaf of working type T, entered exactly
template <typename T>
__device__ __forceinline__ typename DdAcc<T>::type ddv(T x) {
    if constexpr (std::is_same_v<T, double>)
        return dd2{x, 0.0};
    else
        return double(x);
}

// a constant, correctly rounded to float64 (a pair with a zero low word in
// float64 programs, as the JAX package's float64 constant pairs are)
template <typename T>
__device__ __forceinline__ typename DdAcc<T>::type ddk(double c) {
    if constexpr (std::is_same_v<T, double>)
        return dd2{c, 0.0};
    else
        return c;
}

__device__ __forceinline__ double ddmul(double a, double b) {
    return __dmul_rn(a, b);
}

__device__ __forceinline__ double ddadd(double a, double b) {
    return __dadd_rn(a, b);
}

__device__ __forceinline__ dd2 ddmul(dd2 a, dd2 b) {
    const double h = __dmul_rn(a.hi, b.hi);
    double e = fma(a.hi, b.hi, -h);
    e = __dadd_rn(e, __dadd_rn(__dmul_rn(a.hi, b.lo), __dmul_rn(a.lo, b.hi)));
    return dd_two_sum(h, e);
}

__device__ __forceinline__ dd2 ddadd(dd2 a, dd2 b) {
    const dd2 s = dd_two_sum(a.hi, b.hi);
    return dd_two_sum(s.hi, __dadd_rn(s.lo, __dadd_rn(a.lo, b.lo)));
}

// the sum rounded once to T
template <typename T>
__device__ __forceinline__ T ddto(double a) {
    return T(a);
}

template <typename T>
__device__ __forceinline__ T ddto(dd2 a) {
    return T(__dadd_rn(a.hi, a.lo));
}

}  // namespace psat
