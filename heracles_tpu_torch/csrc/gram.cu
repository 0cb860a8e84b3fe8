// Weighted float64 Gram contraction for NVIDIA Hopper (sm_90a), on the
// FP64 tensor cores.
//
// Replaces the Pallas TPU kernel _gram_kernel of heracles_tpu/ops/df32.py
// (:93, called by _gram_call :146 behind gram_df32 :217 and matmul_df32
// :331).  It computes
//
//   M[a, b] = sum_k A[k, a] u[k] B[k, b]      (u = 1 when no u is given)
//
// with A (K, L1), B (K, L2) and u (K,) row-major float64 and M (L1, L2):
// the Gauss-Legendre quadrature of the MASTER mixing matrices, where A and
// B are Wigner-d tables on K nodes and u the node weights times the mask
// correlation.  The TPU kernel emulated float64 with (hi, lo) float32
// pairs, Dekker products and a compensated halving tree; the H100 has
// native float64, so none of that is carried over.
//
// What bounds it: FP64 tensor-core issue.  At the production size (K 4501,
// L1 = L2 = 3001) one contraction is 2 L1 L2 K = 8.1e10 flop against 0.2 GB
// of tables: 1.21 ms at the 67 TFLOP/s FP64 tensor-core peak, 0.07 ms of
// bytes.  The CUDA cores' FFMA peaks at half that rate, so the product runs
// on DMMA: mma.sync.aligned.m16n8k8.row.col.f64 (sm_90; Hopper has no
// wgmma for float64), accumulators in float64 registers.
//
// Design:
//   * one block of 384 threads (12 warps, 3 along a x 4 along b) per
//     192 x 96 output tile; each warp owns 64 x 24 outputs, 4 x 3 MMA
//     fragments of 16 x 8, so each A fragment it reads feeds 3 MMAs and
//     each B fragment 4.  At L1 = L2 = 3001 that is 16 x 32 = 512 blocks,
//     one resident per SM (registers and shared memory): 3.9 waves on 132
//     SMs, the last 88% full (128 x 96 tiles: 768 blocks, 5.8 waves, 82%;
//     128 x 128: 576 blocks, 4.4 waves, 36%).  The block tile sets the
//     bytes each block copies from L2 per output, (1/192 + 1/96) K 8: in
//     a trial, copying alone took about half the time of the 128 x 96
//     kernel, and 192 x 96 moves 14% fewer bytes with 12 warps in place of
//     8 to hide the copies;
//   * K is walked in stages of 16 rows through a ring of 4 shared-memory
//     stages (152 KB), filled by cp.async while the warps multiply the
//     stage that arrived.  Each thread copies one column of A (and, in the
//     first 192 threads, one of B) into every other row, so its source
//     address only steps by two rows; the copies of the next stage are
//     issued after the first k-step's 12 MMAs, so the tensor cores run
//     while they issue.  (Stages of 24 or 32 rows, 3 or 5 stages, the
//     m16n8k4 and m16n8k16 shapes and 128 x 128 tiles were tried on the
//     card and did no better than this shape at 128 x 96.)  Both operands
//     stay k-major as they lie in memory ([k][a], [k][b]), each row padded
//     by 4 doubles so that the transposing fragment reads (lane (g, t)
//     reads row t, column g) hit 16 distinct 8-byte bank pairs in each
//     half-warp;
//   * the alignment trap: a row of A or B is L x 8 bytes, 24,008 at L =
//     3001, not a multiple of 16, so TMA refuses the stride and 16-byte
//     cp.async is misaligned on every other row.  The copies are 8-byte
//     cp.async, with src-size 0 (zero fill) past the ragged edges of K, L1
//     and L2.  Padding the tables' rows was the other way; it would have
//     put the kernel's alignment into the table upload of twopoint.py and
//     into every caller, to save copies that cost a few dozen
//     instructions per thread per stage beside each warp's 24 MMAs;
//   * u is staged with its rows and folded into the B fragments after the
//     shared-memory read: one DMUL per B fragment element per k-step, used
//     by all 4 A fragments of the warp.  (B[k, b] u[k]) is rounded once
//     before the product, as in the plain version; u = None skips it;
//   * each output is summed over k in a fixed order by one thread's MMA
//     chain: no split-K and no atomics, so results repeat bit for bit.
//
// C interface (loaded with ctypes): heracles_gram_f64 launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBM = 192;                  // output tile along a (rows of M)
constexpr int kBN = 96;                   // output tile along b
constexpr int kBK = 16;                   // K rows per stage
constexpr int kStages = 4;                // shared-memory ring
constexpr int kThreads = 384;             // 12 warps: 3 along a, 4 along b
constexpr int kWarpsN = 4;                // warps along b
constexpr int kWM = 64;                   // warp tile along a
constexpr int kWN = kBN / kWarpsN;        // 24: warp tile along b
constexpr int kMK = 8;                    // MMA depth: m16n8k8
static_assert(kBK % kMK == 0, "whole MMA k-steps per stage");
constexpr int kFM = kWM / 16;             // A fragments per warp
constexpr int kFN = kWN / 8;              // B fragments per warp
constexpr int kLdA = kBM + 4;             // padded rows (doubles)
constexpr int kLdB = kBN + 4;
constexpr int kStageA = kBK * kLdA;
constexpr int kStageB = kBK * kLdB;
constexpr int kStage = kStageA + kStageB + kBK;  // A, B, u
constexpr size_t kSmemBytes = size_t(kStages) * kStage * sizeof(double);

static_assert((kBM / kWM) * kWarpsN * 32 == kThreads, "one warp per warp tile");
static_assert(kLdA % 16 == 4 && kLdB % 16 == 4, "bank-pair padding");
static_assert(kThreads == 2 * kBM && 2 * kBN + kBK <= kThreads &&
                  kBK % 2 == 0,
              "copies: 2 rows of A per pass over the block, 2 of B and u");

__device__ __forceinline__ void cp_async8(double* dst, const double* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D = A B + D on a 16 x 8 x 8 float64 tile.  Lane (g, t) = (lane / 4,
// lane % 4) holds A(g + 8 (i % 2), t + 4 (i / 2)) in a[i], B(t + 4 i, g)
// in b[i] and D(g + 8 (i / 2), 2 t + i % 2) in d[i].
__device__ __forceinline__ void mma16n8k8(double (&d)[4], const double (&a)[4],
                                          const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads, 1)
    gram_kernel(const double* __restrict__ A, const double* __restrict__ B,
                const double* __restrict__ u, double* __restrict__ M, int K,
                int L1, int L2) {
  extern __shared__ __align__(16) double smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / kWarpsN) * kWM;  // warp's rows within the tile
  const int wn = (warp % kWarpsN) * kWN;  // and columns
  const int a0 = blockIdx.y * kBM;
  const int b0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;

  // This thread's copies into a stage: A column ca of rows ra + 2 r (every
  // thread), B column cb of rows rb + 2 r (the first 2 kBN threads), u row
  // ru (the kBK threads after those).
  const int ra = tid / kBM, ca = tid % kBM;
  const bool a_ok = a0 + ca < L1;
  const double* a_col = A + (a_ok ? a0 + ca : 0);
  const bool b_thread = tid < 2 * kBN;
  const int rb = tid / kBN, cb = tid % kBN;
  const bool b_ok = b_thread && b0 + cb < L2;
  const double* b_col = B + (b_ok ? b0 + cb : 0);
  const int ru = tid - 2 * kBN;
  auto load_stage = [&](int stage, int k0) {
    double* As = smem + stage * kStage;
    double* Bs = As + kStageA;
    double* us = Bs + kStageB;
#pragma unroll
    for (int r = 0; r < kBK / 2; ++r) {
      const int kk = ra + 2 * r, k = k0 + kk;
      const bool ok = a_ok && k < K;
      cp_async8(&As[kk * kLdA + ca], ok ? a_col + size_t(k) * L1 : A, ok);
    }
    if (b_thread) {
#pragma unroll
      for (int r = 0; r < kBK / 2; ++r) {
        const int kk = rb + 2 * r, k = k0 + kk;
        const bool ok = b_ok && k < K;
        cp_async8(&Bs[kk * kLdB + cb], ok ? b_col + size_t(k) * L2 : B, ok);
      }
    } else if (kWeighted && ru < kBK) {
      const bool ok = k0 + ru < K;
      cp_async8(&us[ru], ok ? u + k0 + ru : u, ok);
    }
  };

  double acc[kFM][kFN][4];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s * kBK);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed
    __syncthreads();               // for every thread; stage kt - 1 is free

    const double* As = smem + (kt % kStages) * kStage;
    const double* Bs = As + kStageA;
    const double* us = Bs + kStageB;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += kMK) {
      double af[kFM][4], bf[kFN][2];
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          af[i][v] = As[(ks + t + 4 * (v / 2)) * kLdA + wm + 16 * i + g +
                        8 * (v % 2)];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int k = ks + t + 4 * v;
        const double uk = kWeighted ? us[k] : 1.0;
#pragma unroll
        for (int j = 0; j < kFN; ++j) {
          const double bv = Bs[k * kLdB + wn + 8 * j + g];
          bf[j][v] = kWeighted ? bv * uk : bv;
        }
      }
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j) mma16n8k8(acc[i][j], af[i], bf[j]);
      if (ks == 0) {
        // the copies of stage kt + kStages - 1, issued behind the first
        // MMAs so that the tensor cores run while the copies issue
        const int next = kt + kStages - 1;
        if (next < nk) load_stage(next % kStages, next * kBK);
        cp_async_commit();
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kFM; ++i) {
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int a = a0 + wm + 16 * i + g + 8 * (v / 2);
        const int b = b0 + wn + 8 * j + 2 * t + (v % 2);
        if (a < L1 && b < L2) M[size_t(a) * L2 + b] = acc[i][j][v];
      }
    }
  }
}

template <bool kWeighted>
int launch(const void* A, const void* B, const void* u, void* M, int K, int L1,
           int L2, void* stream) {
  auto kern = gram_kernel<kWeighted>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemBytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((L2 + kBN - 1) / kBN, (L1 + kBM - 1) / kBM);
  kern<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(A), static_cast<const double*>(B),
      static_cast<const double*>(u), static_cast<double*>(M), K, L1, L2);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int heracles_gram_f64(const void* A, const void* B, const void* u, void* M,
                      int K, int L1, int L2, void* stream) {
  if (L1 == 0 || L2 == 0) return int(cudaSuccess);
  return u != nullptr ? launch<true>(A, B, u, M, K, L1, L2, stream)
                      : launch<false>(A, B, u, M, K, L1, L2, stream);
}

}  // extern "C"
