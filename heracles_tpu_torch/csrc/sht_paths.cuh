// The per-warp choice of path shared by the spin-0 analysis and the two
// synthesis kernels (sht_analysis.cu, sht_synthesis.cu,
// sht_synthesis_pair.cu).
//
// A ring's value is a mantissa times 2^(60 k) (wigner_recurrence.cuh) and
// only k = 0 or -1 emit.  At the start of every sub-chunk of kSub
// multipoles a warp looks at the exponents of all its rings and takes
//   * the steady path where every ring sits at k = -1: an emitting ring
//     stays there, so the sub-chunk needs no rescale and no emit factor;
//   * the dead path where every exponent is <= -3: a step grows |d| by a
//     factor g < sqrt(2 lmax) + 2 < 2^8.1 (the wrappers refuse an lmax
//     above 32767), so a value below 2^-120 stays below 2^-60 through the
//     sub-chunk's last emit (g^7 < 2^60): nothing emits, and only the
//     recurrence runs.  Its rescale is deferred to the sub-chunk's end
//     (rescale_deferred): a mantissa that enters at or below 2^60 stays
//     below 2^125, short of float32's overflow, and since |d| only grows
//     while a ring is not yet emitting (a CPU test holds the plain
//     recurrence to that), the exponent at the sub-chunk's end is the one
//     the step-by-step rescale arrives at: the same mantissa, the same
//     numbers from there on;
//   * the full step otherwise.
// Padding rings (k = kNoSeed, all values zero) fit the first two.
// The kernels hold their other factor (spectra or alms) times 2^-60 and the
// emit factor times 2^60, so that the steady step multiplies the mantissa
// itself: both scalings are powers of two, so each product is the same
// exact number as that of the unscaled pair.

#pragma once

#include <cuda_runtime.h>

#include "wigner_recurrence.cuh"

namespace sht_paths {

constexpr int kSub = 8;  // multipoles per path decision

enum class Path { kSteady, kDead, kFull };

__device__ __forceinline__ bool is_steady(int k) {
  return k == -1 || k == wigner::kNoSeed;
}

__device__ __forceinline__ bool is_dead(int k) { return k <= -3; }

// The warp's path from each lane's verdict on its own rings.
__device__ __forceinline__ Path warp_path(bool steady, bool dead) {
  if (__all_sync(0xffffffffu, steady)) return Path::kSteady;
  if (__all_sync(0xffffffffu, dead)) return Path::kDead;
  return Path::kFull;
}

// The dead path's rescale, once per sub-chunk: after kSub steps without
// one a mantissa may have passed 2^60 once or (g^kSub < 2^65) twice.
template <typename T>
__device__ __forceinline__ void rescale_deferred(T& dp, T& dc, int& k) {
  using R = wigner::Arith<T>;
  const T a = fabs(dc);
  const bool once = a > R::scale();
  const bool twice = a > R::scale() * R::scale();
  const T sc = twice ? R::inv_scale() * R::inv_scale()
                     : (once ? R::inv_scale() : T(1));
  dp *= sc;
  dc *= sc;
  k += int(once) + int(twice);
}

// The same with the column's comp stream (wigner::step_lo), which takes
// d's scale: lo stays ~(l - m) eps of d, so it neither overflows nor
// turns subnormal where d does not.
template <typename T>
__device__ __forceinline__ void rescale_deferred(T& dp, T& dc, T& dpl, T& dcl,
                                                 int& k) {
  using R = wigner::Arith<T>;
  const T a = fabs(dc);
  const bool once = a > R::scale();
  const bool twice = a > R::scale() * R::scale();
  const T sc = twice ? R::inv_scale() * R::inv_scale()
                     : (once ? R::inv_scale() : T(1));
  dp *= sc;
  dc *= sc;
  dpl *= sc;
  dcl *= sc;
  k += int(once) + int(twice);
}

// The emit factor times 2^60: 2^60 at k = 0, 1 at k = -1, 0 below.
template <typename T>
__device__ __forceinline__ T emit_scaled(int k) {
  return k == 0 ? wigner::Arith<T>::scale() : (k == -1 ? T(1) : T(0));
}

__device__ __forceinline__ float madd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double madd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// A warp's count of sub-chunks on each path, for the diagnostic launches;
// the kernels proper carry the empty one.
template <bool kOn>
struct PathCounts {
  __device__ __forceinline__ void add(Path) {}
  __device__ __forceinline__ void flush(unsigned long long*, int) {}
};

template <>
struct PathCounts<true> {
  unsigned steady = 0, dead = 0, full = 0;
  __device__ __forceinline__ void add(Path p) {
    steady += p == Path::kSteady;
    dead += p == Path::kDead;
    full += p == Path::kFull;
  }
  // counts: (steady, dead, full), summed over every warp of the launch
  __device__ __forceinline__ void flush(unsigned long long* counts, int lane) {
    if (lane != 0) return;
    atomicAdd(counts, static_cast<unsigned long long>(steady));
    atomicAdd(counts + 1, static_cast<unsigned long long>(dead));
    atomicAdd(counts + 2, static_cast<unsigned long long>(full));
  }
};

}  // namespace sht_paths
