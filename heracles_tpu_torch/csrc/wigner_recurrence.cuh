// The scaled Wigner-d recurrence shared by the analysis and synthesis
// kernels (sht_analysis.cu, sht_synthesis.cu), so that the two directions
// evaluate the same functions with the same rounding.
//
// The normalised Wigner-d functions d^l of one column (m, s) follow the
// three-term recurrence in l
//     d^{l+1} = (a1 x + a0) d^l - b d^{l-1},   x = cos(theta),
// seeded at j0 = max(m, s).  The seed ~ sin^m(theta/2) underflows any
// float format near the poles, so each ring carries a mantissa and a count
// k of factors 2^60 (block rescaling), and only k = 0 or -1 emit.  The
// seed and the coefficients are evaluated in float64 and rounded to the
// working type; the recurrence runs unfused (round-to-nearest mul/add/sub
// that the compiler may not contract into an FMA), so it rounds exactly as
// the plain PyTorch versions in heracles_tpu_torch/ops/wigner.py do.

#pragma once

#include <cuda_runtime.h>

namespace wigner {

constexpr int kNoSeed = -(1 << 30);  // exponent of a padding ring
constexpr double kLog2Scale = 60.0;
constexpr double kLn2 = 0.6931471805599453;
constexpr double kInvFourPi = 0.07957747154594767;

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  __device__ static __forceinline__ float scale() { return 0x1p60f; }
  __device__ static __forceinline__ float inv_scale() { return 0x1p-60f; }
  __device__ static __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
};

template <>
struct Arith<double> {
  __device__ static __forceinline__ double scale() { return 0x1p60; }
  __device__ static __forceinline__ double inv_scale() { return 0x1p-60; }
  __device__ static __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
};

// The factor that turns a scaled value into the function: 1 at k = 0,
// 2^-60 at k = -1, 0 below.
template <typename T>
__device__ __forceinline__ T emit_of(int k) {
  return k == 0 ? T(1) : (k == -1 ? Arith<T>::inv_scale() : T(0));
}

// sqrt((2l+1)/4pi), rounded from float64.
template <typename T>
__device__ __forceinline__ T norm_of(int l) {
  return T(sqrt((2.0 * l + 1.0) * kInvFourPi));
}

// Seed d^{j0} = sign * exp(logc + pc log cos(t/2) + ps log sin(t/2)) as
// mant * 2^(60 k), evaluated in float64.
template <typename T>
__device__ __forceinline__ void seed_of(double logc, double sign, double pc,
                                        double ps, double lch, double lsh,
                                        T& mant, int& k) {
  double lv = logc;  // unfused, as the plain version evaluates it
  if (pc != 0.0) lv = __dadd_rn(lv, __dmul_rn(pc, lch));
  if (ps != 0.0) lv = __dadd_rn(lv, __dmul_rn(ps, lsh));
  const double ls = lv / (kLn2 * kLog2Scale);
  const double kf = floor(ls);
  mant = T(sign * exp2((ls - kf) * kLog2Scale));
  k = int(kf);
}

// Coefficients taking (d^{L-2}, d^{L-1}) to d^L = (a1 x + a0) d^{L-1} - b d^{L-2}
// for the column (m, s); zero outside j0 < L <= lmax.
template <typename T>
__device__ void coef_row(int L, int j0, int m, int s, int lmax, T* a1, T* a0,
                         T* b) {
  if (L > lmax || L <= j0) {
    *a1 = T(0);
    *a0 = T(0);
    *b = T(0);
    return;
  }
  const double l = L, lm = L - 1;
  const double m2 = double(m) * m, s2 = double(s) * s;
  const double al = sqrt((l * l - m2) * (l * l - s2)) / l;
  const double alm =
      lm > 0.0 ? sqrt(fmax((lm * lm - m2) * (lm * lm - s2), 0.0)) / lm : 0.0;
  const double inv = 1.0 / al;
  *a1 = T((2.0 * l - 1.0) * inv);
  *a0 = T(-(2.0 * l - 1.0) * (double(m) * s) / (fmax(lm, 1.0) * l) * inv);
  *b = T(alm * inv);
}

// d^{l+1} = (a1 x + a0) d^l - b d^{l-1}, unfused (see Arith).
template <typename T>
__device__ __forceinline__ T step(T a1x, T a0, T b, T dc, T dp) {
  using R = Arith<T>;
  return R::sub(R::mul(R::add(a1x, a0), dc), R::mul(b, dp));
}

// The same step for a column with m s = 0 (spin 0).  Its a0 is -0.0 in
// every row that coef_row fills, and x + (-0.0) = x for every x, so
// (a1 x + a0) is a1 x itself: the same value without the addition.
template <typename T>
__device__ __forceinline__ T step_a0_zero(T a1x, T b, T dc, T dp) {
  using R = Arith<T>;
  return R::sub(R::mul(a1x, dc), R::mul(b, dp));
}

// Take the new value with the 2^60 block rescale.
template <typename T>
__device__ __forceinline__ void advance(T dn, T& dp, T& dc, int& k) {
  const bool over = fabs(dn) > Arith<T>::scale();
  const T sc = over ? Arith<T>::inv_scale() : T(1);
  dp = dc * sc;
  dc = dn * sc;
  k += over ? 1 : 0;
}

// The compensated (comp) mode of the float32 kernels: x = cos(theta)
// enters the recurrence rounded to float32, x_hi, and that truncation is
// the dominant systematic error of a long float32 chain (it dephases the
// recurrence coherently, ~(l - m) eps x / sin(theta)).  A second value per
// column, lo, obeys the same recurrence with the truncation's forcing
// r (a1 x_hi) d^l, r = x_lo / x_hi (formed by the caller, 0 where x_hi
// is 0):
//   lo^{l+1} = (a1 x + a0) lo^l + r (a1 x d^l) - b lo^{l-1},
// unfused and in this order; d itself (step) is unchanged, so the paths
// and exponents are those of the plain kernel.  lo starts at 0 at the
// seed, shares d's 2^60 rescales, and a function emits d + lo.  Only the
// x term is corrected: the m s middle term is <= s / l of it, as in the
// reference's _pair_kernel_comp (heracles_tpu/ops/pallas_sht.py:1218).
// With r = 0, lo stays 0 and d + lo is d: the plain kernel's values.
template <typename T>
__device__ __forceinline__ T step_lo(T a1x, T a0, T b, T r, T dc, T dcl,
                                     T dpl) {
  using R = Arith<T>;
  return R::sub(R::add(R::mul(R::add(a1x, a0), dcl), R::mul(r, R::mul(a1x, dc))),
                R::mul(b, dpl));
}

// step_lo for a column with m s = 0 (see step_a0_zero).
template <typename T>
__device__ __forceinline__ T step_lo_a0_zero(T a1x, T b, T r, T dc, T dcl,
                                             T dpl) {
  using R = Arith<T>;
  return R::sub(R::add(R::mul(a1x, dcl), R::mul(r, R::mul(a1x, dc))),
                R::mul(b, dpl));
}

// advance for a column with its lo stream: the rescale d decides scales
// both.
template <typename T>
__device__ __forceinline__ void advance_comp(T dn, T dnl, T& dp, T& dc,
                                             T& dpl, T& dcl, int& k) {
  const bool over = fabs(dn) > Arith<T>::scale();
  const T sc = over ? Arith<T>::inv_scale() : T(1);
  dp = dc * sc;
  dc = dn * sc;
  dpl = dcl * sc;
  dcl = dnl * sc;
  k += over ? 1 : 0;
}

}  // namespace wigner
