// The ring contraction of the grouped analysis kernels on the tensor cores
// (sht_analysis.cu's analysis_group_kernel, sht_analysis_pair.cu's
// pair_group_kernel).
//
// A warp owns 32 R rings (R ring slots a lane) and, per sub-chunk of 8
// multipoles, computes D[rows, l] = sum_ring A[rows, ring] Lam[ring, l]: A
// the group's spectra (16 rows a tile: (map, re / im) in rows g < 8 and
// their partners in rows g + 8), Lam the shared recurrence's emitted
// values.  One mma.sync m16n8k8 takes 8 rings (a k-step); the warp's
// rings are 4 R k-steps.  Lane (g, t) = (lane / 4, lane % 4) holds
//   A(g + 8 (i % 2), t + 4 (i / 2)) in a[i], Lam(t + 4 i, g) in b[i] and
//   D(g + 8 (i / 2), 2 t + i % 2) in d[i]
// (the same layout in float32 and in float64).  Ring k of k-step s is lane
// 4 (s % 8) + k % 4's ring slot 2 (s / 8) + k / 4: so a lane holds both
// rings of its b[] for slots 2p, 2p + 1, and the transpose from one ring
// a lane (the recurrence) to one multipole a lane (the fragment) is one
// 8- or 16-byte store per multipole and slot pair, and one load per
// k-step, through a per-warp staging buffer of 8 k-steps.
//
// Precision: float32 runs 3xTF32.  Each operand is split as
// hi = rna_tf32(x) and lo = x - hi (exact in float32; rna_tf32 is
// tf32_rna below, the rounding of cvt.rna.tf32.f32), and D gets
// A_lo B_hi + A_hi B_lo + A_hi B_hi, accumulated in float32.  lo goes to
// the tensor cores as it is: they read a TF32 operand from the top 19
// bits of its register, so lo is truncated to TF32 there (an error below
// 2^-21 of x), and the dropped A_lo B_lo is below 2^-22 of a product,
// where TF32 alone (2^-11) would miss float32's bar against float64.
// float64 runs one DMMA (mma.sync m16n8k8 .f64) per k-step.  The A tiles
// hold the spectra whole, in fragment order, written once per ring tile
// (so a float32 tile takes what a float64 one of half the rings does,
// and a block fits more of them); each k-step splits the A fragments it
// reads and the emitted values it reads, the latter once for every row
// tile.  Every sum runs in a fixed order, so launches repeat bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace tc {

constexpr int kStage = 32 + 4;  // value pairs a staged k-step (4 padding)

// x rounded to TF32 (10 explicit mantissa bits) to nearest, ties away
// from zero: what cvt.rna.tf32.f32 gives for a finite x, in two integer
// instructions (the magnitude lies in the low 31 bits, so adding half of
// the 13 dropped bits' unit and clearing them rounds it, a carry stepping
// the exponent), where the conversion takes four.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint4& a,
                                    const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(double (&d)[4], const double (&a)[4],
                                    const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// An A tile: one row tile's fragments for the warp's k-steps, kLanes
// lanes' worth (lanes past them repeat lower rows, whose sums nobody
// keeps), 4 values a lane and k-step.  put stores the pair (row g,
// row g + 8) at k = t + 4 h of lane g 4 + t.
__device__ __forceinline__ void put(float* step, int lane, int h, float v0,
                                    float v1) {
  *reinterpret_cast<float2*>(step + lane * 4 + 2 * h) = make_float2(v0, v1);
}
__device__ __forceinline__ void put(double* step, int lane, int h, double v0,
                                    double v1) {
  *reinterpret_cast<double2*>(step + lane * 4 + 2 * h) = make_double2(v0, v1);
}

// Elements of one k-step of an A tile.
template <int kLanes>
__host__ __device__ constexpr int step_elems() {
  return kLanes * 4;
}

// The staging buffer of a warp: kStage pairs a k-step, 8 k-steps.  A lane
// stores its slots (2p, 2p + 1) at multipole t where lane (t, its own
// lane % 4) of k-step lane / 4 reads them; the 4 padding pairs a k-step
// keep the stores of a half-warp (float2) or quarter-warp (double2) on
// distinct banks.
__device__ __forceinline__ void stage(float* buf, int lane, int t, float v0,
                                      float v1) {
  *reinterpret_cast<float2*>(buf + 2 * ((lane >> 2) * kStage + t * 4 +
                                        (lane & 3))) = make_float2(v0, v1);
}
__device__ __forceinline__ void stage(double* buf, int lane, int t, double v0,
                                      double v1) {
  *reinterpret_cast<double2*>(buf + 2 * ((lane >> 2) * kStage + t * 4 +
                                         (lane & 3))) = make_double2(v0, v1);
}

// The contraction over a staged slot pair: 8 k-steps, each reading the
// staged values and the A tiles of ``NT`` row tiles (in float32 each split
// as it is read), ``a`` at this slot pair's first k-step of row tile 0,
// ``qstride`` elements between row tiles; adds the products to d.
//
// An mma waits for the one before it into the same accumulator (a latency
// of tens of cycles), so the k-steps feed independent chains: in float32
// one per (product, k-step parity), six of four mmas each, in float64 one
// per k-step parity, summed once at the end in a fixed order (the small
// products first).
template <int NT, int kLanes>
__device__ __forceinline__ void contract(float (&d)[NT][4], const float* buf,
                                         const float* a, int qstride,
                                         int lane) {
  const int al = lane & (kLanes - 1);
  float acc[NT][3][2][4] = {};  // (lo hi, hi lo, hi hi), k-step parity
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float2 v =
        *reinterpret_cast<const float2*>(buf + 2 * (s * kStage + lane));
    unsigned bh[2], bl[2];
    split(v.x, bh[0], bl[0]);
    split(v.y, bh[1], bl[1]);
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const float4 av = *reinterpret_cast<const float4*>(
          a + q * qstride + s * step_elems<kLanes>() + al * 4);
      uint4 ah, alo;
      split(av.x, ah.x, alo.x);
      split(av.y, ah.y, alo.y);
      split(av.z, ah.z, alo.z);
      split(av.w, ah.w, alo.w);
      mma(acc[q][0][s & 1], alo, bh);
      mma(acc[q][1][s & 1], ah, bl);
      mma(acc[q][2][s & 1], ah, bh);
    }
  }
#pragma unroll
  for (int q = 0; q < NT; ++q) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float small = (acc[q][0][0][i] + acc[q][0][1][i]) +
                          (acc[q][1][0][i] + acc[q][1][1][i]);
      d[q][i] += small + (acc[q][2][0][i] + acc[q][2][1][i]);
    }
  }
}

template <int NT, int kLanes>
__device__ __forceinline__ void contract(double (&d)[NT][4],
                                         const double* buf, const double* a,
                                         int qstride, int lane) {
  const int al = lane & (kLanes - 1);
  double acc[NT][2][4] = {};  // k-step parity
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const double2 v =
        *reinterpret_cast<const double2*>(buf + 2 * (s * kStage + lane));
    const double b[2] = {v.x, v.y};
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const double* step = a + q * qstride + s * step_elems<kLanes>() + al * 4;
      const double2 a01 = *reinterpret_cast<const double2*>(step);
      const double2 a23 = *reinterpret_cast<const double2*>(step + 2);
      const double av[4] = {a01.x, a01.y, a23.x, a23.y};
      mma(acc[q][s & 1], av, b);
    }
  }
#pragma unroll
  for (int q = 0; q < NT; ++q) {
#pragma unroll
    for (int i = 0; i < 4; ++i) d[q][i] += acc[q][0][i] + acc[q][1][i];
  }
}

}  // namespace tc
