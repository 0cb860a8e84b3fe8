// Ring analysis around cuFFT for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves its ring FFTs and the
// products around them to XLA (heracles_tpu/ops/ringfft.py, ring_analysis,
// whose chirp spectra it caches in chirp_fft_planes).  These are the
// elementwise passes of heracles_tpu_torch.ops.ringfft.ring_analysis on
// the card; cuFFT, through torch.fft, runs the FFTs between them.  A cap
// bucket's rings need a chirp-z (Bluestein) transform at a power-of-two
// length L, whose modulus is each ring's own length nph:
//
//   F_m = w_m sum_p (v_p w_p) b_{m-p},  w_x = e^{-i pi x^2 / nph},
//   b_j = e^{+i pi j^2 / nph}
//
// (the orders -m, of a complex map: the conjugate chirps), so a bucket
// pair (a north bucket and its southern mirror, of the same L) runs
//   * rows_kernel: the rings read straight from the maps, times w_p,
//     zero-padded to L (both directions of a complex map in one buffer);
//   * cuFFT forward;
//   * spectrum_kernel: times the cached FFT of b (scaled by 1/L, a power of
//     two: exact), of the north rows only (a southern ring reads its
//     northern mirror's row; the +1 direction reads conj(T[-k mod L]));
//   * cuFFT inverse, unnormalised;
//   * orders_kernel: the orders m0..mext-1 only, times w_m, times the phase
//     e^{-i m phi0} weight_r, written straight into the rows of F (and
//     Fneg).  The belt's one FFT (r2c of a real map, c2c of a complex one)
//     goes through the same write, at index m mod L.
//
// Chirps and phases are computed in float64 from the exact integer residue
// (p^2 mod 2 nph) and rounded to the working type, the products taken in
// the plain version's order (ringfft.ring_analysis_plain), so the result is
// the plain version's to the working type's rounding.
//
// What bounds them: bytes.  Each reads and writes its (rows, L) buffer once
// (the orders kernel reads mext of each row's L entries); the float64
// sincos per element is ~0.1 ms of FP64 work at nside 4096, hidden under
// the memory traffic.  Threads run along a row, so every read and write
// of a warp is contiguous; the southern rows and the +1 direction read the
// same table, so its bytes are those of the northern rows only.
//
// C interface (loaded with ctypes): heracles_ring_{rows,spectrum,orders}_
// {f32,f64} launch on the given stream and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kPerThread = 4;
// orders_kernel's source rows: a cap's inverse FFT (its first mext entries
// used), the belt's full c2c spectrum, the belt's r2c half spectrum
constexpr int kCap = 0;
constexpr int kBeltFull = 1;
constexpr int kBeltHalf = 2;

template <typename T> struct Cplx;
template <> struct Cplx<float> { using type = float2; };
template <> struct Cplx<double> { using type = double2; };
template <typename T> using C = typename Cplx<T>::type;

template <typename T>
__device__ __forceinline__ C<T> make(T x, T y) {
  C<T> r;
  r.x = x;
  r.y = y;
  return r;
}

template <typename T>
__device__ __forceinline__ C<T> cmul(C<T> a, C<T> b) {
  return make<T>(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

template <typename T>
__device__ __forceinline__ C<T> cconj(C<T> a) { return make<T>(a.x, -a.y); }

// e^{-i pi (q^2 mod 2n) / n}, the angle in float64 from the exact residue
// (ringfft._chirp), rounded to T.  The residue is taken in float64, where
// q^2 < 2^53 and qq - k 2n are exact: a quotient k = floor(q^2 / 2n) from
// the row's reciprocal inv2n = 1 / 2n is off by at most one, which one
// step corrects (an int64 remainder is a long subroutine on the card)
template <typename T>
__device__ __forceinline__ C<T> chirp(long long q, int n, double inv2n) {
  const double n2 = 2.0 * n;
  const double qq = double(q) * double(q);
  double r = fma(-n2, floor(qq * inv2n), qq);
  if (r < 0.0) r += n2;
  else if (r >= n2) r -= n2;
  double s, c;
  sincos(3.141592653589793 * r / double(n), &s, &c);
  return make<T>(T(c), T(-s));
}

// ring of row h of a launch: h < R the north rings rn0.., else the south
// rings rs0.. (a belt launch passes R = H)
__device__ __forceinline__ int ring_of(int h, int R, int rn0, int rs0) {
  return h < R ? rn0 + h : rs0 + (h - R);
}

// rows (B, dirs, H, L): row (b, d, h) holds ring r's pixels times w_p
// (conj(w_p) for d = 1), zero from nph on; a thread writes both directions
// of its pixel, from one chirp
template <typename T, bool kComplexIn>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const void* __restrict__ maps, long long npix,
                const long long* __restrict__ start,
                const int* __restrict__ nph, C<T>* __restrict__ rows, int L,
                int H, int R, int rn0, int rs0, int dirs, int nrows) {
  for (int q = blockIdx.y; q < nrows; q += gridDim.y) {
    const int h = q % H;
    const long long b = q / H;
    const int r = ring_of(h, R, rn0, rs0);
    const int n = nph[r];
    const double inv2n = 1.0 / (2.0 * n);
    const long long pix = b * npix + start[r];
    C<T>* out = rows + (b * dirs * H + h) * L;
    for (int p = blockIdx.x * kThreads + threadIdx.x; p < L;
         p += gridDim.x * kThreads) {
      C<T> v = make<T>(T(0), T(0)), vn = v;
      if (p < n) {
        const C<T> w = chirp<T>(p, n, inv2n);
        if (kComplexIn) {
          const C<T> x = static_cast<const C<T>*>(maps)[pix + p];
          v = cmul<T>(x, w);
          vn = cmul<T>(x, cconj<T>(w));
        } else {
          const T x = static_cast<const T*>(maps)[pix + p];
          v = make<T>(x * w.x, x * w.y);
        }
      }
      out[p] = v;
      if (dirs == 2) out[(long long)H * L + p] = vn;
    }
  }
}

// y (B, dirs, H, L) times the chirp spectrum of each row's northern ring:
// table row j = h (north) or 2R - 1 - h (its southern mirror); d = 1 reads
// conj(table[j, -k mod L])
template <typename T>
__global__ void __launch_bounds__(kThreads)
    spectrum_kernel(C<T>* __restrict__ y, const C<T>* __restrict__ table,
                    int L, int H, int R, int dirs, int nrows) {
  for (int q = blockIdx.y; q < nrows; q += gridDim.y) {
    const int h = q % H;
    const int d = (q / H) % dirs;
    const C<T>* row = table + (long long)(h < R ? h : 2 * R - 1 - h) * L;
    C<T>* out = y + (long long)q * L;
    for (int k = blockIdx.x * kThreads + threadIdx.x; k < L;
         k += gridDim.x * kThreads) {
      const C<T> s = d ? cconj<T>(row[(L - k) & (L - 1)]) : row[k];
      out[k] = cmul<T>(out[k], s);
    }
  }
}

// F[b, r, c] (and Fneg) for the orders m = m0 + c of the rows (B, H) of
// one launch: src row (b, h) (a cap: (b, d, h), d = 1 feeding Fneg), times
// w_m on a cap, times the phase e^{-i m phi0_r} weight_r (conjugated for
// Fneg)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    orders_kernel(const C<T>* __restrict__ src, long long ld, int mode, int L,
                  C<T>* __restrict__ F, C<T>* __restrict__ Fneg, int nr,
                  int m0, int nm, int H, int R, int rn0, int rs0, int dirs,
                  int nrows, const int* __restrict__ nph,
                  const double* __restrict__ phi0,
                  const double* __restrict__ weight) {
  for (int q = blockIdx.y; q < nrows; q += gridDim.y) {
    const int h = q % H;
    const long long b = q / H;
    const int r = ring_of(h, R, rn0, rs0);
    const int n = nph[r];
    const double inv2n = 1.0 / (2.0 * n);
    const double ph0 = phi0[r];
    const double wt = weight ? weight[r] : 1.0;
    const C<T>* row = src + (mode == kCap ? b * dirs * H + h : q) * ld;
    const long long out0 = (b * nr + r) * (long long)nm;
    for (int c = blockIdx.x * kThreads + threadIdx.x; c < nm;
         c += gridDim.x * kThreads) {
      const int m = m0 + c;
      double s, co;
      sincos(-double(m) * ph0, &s, &co);
      const C<T> ph = make<T>(T(co * wt), T(s * wt));
      if (mode == kCap) {
        const C<T> w = chirp<T>(m, n, inv2n);
        F[out0 + c] = cmul<T>(cmul<T>(row[m], w), ph);
        if (Fneg)
          Fneg[out0 + c] = cmul<T>(cmul<T>(row[(long long)H * ld + m],
                                           cconj<T>(w)), cconj<T>(ph));
        continue;
      }
      const int k = m % L;
      C<T> v;
      if (mode == kBeltHalf)
        v = k <= L / 2 ? row[k] : cconj<T>(row[L - k]);
      else
        v = row[k];
      F[out0 + c] = cmul<T>(v, ph);
      if (Fneg) Fneg[out0 + c] = cmul<T>(row[k ? L - k : 0], cconj<T>(ph));
    }
  }
}

// a block per kPerThread * kThreads entries of a row (a thread's setup of
// its row, the ring's tables and reciprocal, is paid over kPerThread
// entries), rows strided over at most kMaxGridY blocks
dim3 grid(int width, int nrows) {
  const int span = kThreads * kPerThread;
  return dim3((width + span - 1) / span,
              unsigned(nrows < kMaxGridY ? nrows : kMaxGridY));
}

// the launch's rows, or -1 where they overflow an int
int rows_of(long long nrows) {
  return nrows > 0x7fffffffLL ? -1 : int(nrows);
}

template <typename T>
int launch_rows(const void* maps, long long npix, const void* start,
                const void* nph, void* rows, int L, int H, int R, int rn0,
                int rs0, int dirs, int B, int complex_in, void* stream) {
  const int nrows = rows_of((long long)B * H);
  if (nrows == 0) return int(cudaSuccess);
  if (nrows < 0) return int(cudaErrorInvalidValue);
  // both directions from complex maps, one from real maps
  if ((L & (L - 1)) || dirs != (complex_in ? 2 : 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const long long*>(start);
  const auto* np = static_cast<const int*>(nph);
  auto* out = static_cast<C<T>*>(rows);
  if (complex_in)
    rows_kernel<T, true><<<grid(L, nrows), kThreads, 0, s>>>(
        maps, npix, st, np, out, L, H, R, rn0, rs0, dirs, nrows);
  else
    rows_kernel<T, false><<<grid(L, nrows), kThreads, 0, s>>>(
        maps, npix, st, np, out, L, H, R, rn0, rs0, dirs, nrows);
  return int(cudaGetLastError());
}

template <typename T>
int launch_spectrum(void* y, const void* table, int L, int H, int R, int dirs,
                    int B, void* stream) {
  const int nrows = rows_of((long long)B * dirs * H);
  if (nrows == 0) return int(cudaSuccess);
  if (nrows < 0 || (L & (L - 1)) || dirs < 1 || dirs > 2)
    return int(cudaErrorInvalidValue);
  spectrum_kernel<T><<<grid(L, nrows), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<C<T>*>(y), static_cast<const C<T>*>(table), L, H, R, dirs,
      nrows);
  return int(cudaGetLastError());
}

template <typename T>
int launch_orders(const void* src, long long ld, int mode, int L, void* F,
                  void* Fneg, int nr, int m0, int nm, int H, int R, int rn0,
                  int rs0, int dirs, int B, const void* nph, const void* phi0,
                  const void* weight, void* stream) {
  const int nrows = rows_of((long long)B * H);
  if (nrows == 0 || nm == 0) return int(cudaSuccess);
  if (nrows < 0) return int(cudaErrorInvalidValue);
  // a cap's L is a power of two; the belt's, 4 nside, need not be
  if ((mode == kCap && (L & (L - 1))) || mode < kCap || mode > kBeltHalf ||
      dirs < 1 || dirs > 2)
    return int(cudaErrorInvalidValue);
  orders_kernel<T><<<grid(nm, nrows), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C<T>*>(src), ld, mode, L, static_cast<C<T>*>(F),
      static_cast<C<T>*>(Fneg), nr, m0, nm, H, R, rn0, rs0, dirs, nrows,
      static_cast<const int*>(nph), static_cast<const double*>(phi0),
      static_cast<const double*>(weight));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int heracles_ring_rows_f32(const void* maps, long long npix, const void* start,
                           const void* nph, void* rows, int L, int H, int R,
                           int rn0, int rs0, int dirs, int B, int complex_in,
                           void* stream) {
  return launch_rows<float>(maps, npix, start, nph, rows, L, H, R, rn0, rs0,
                            dirs, B, complex_in, stream);
}

int heracles_ring_rows_f64(const void* maps, long long npix, const void* start,
                           const void* nph, void* rows, int L, int H, int R,
                           int rn0, int rs0, int dirs, int B, int complex_in,
                           void* stream) {
  return launch_rows<double>(maps, npix, start, nph, rows, L, H, R, rn0, rs0,
                             dirs, B, complex_in, stream);
}

int heracles_ring_spectrum_f32(void* y, const void* table, int L, int H, int R,
                               int dirs, int B, void* stream) {
  return launch_spectrum<float>(y, table, L, H, R, dirs, B, stream);
}

int heracles_ring_spectrum_f64(void* y, const void* table, int L, int H, int R,
                               int dirs, int B, void* stream) {
  return launch_spectrum<double>(y, table, L, H, R, dirs, B, stream);
}

int heracles_ring_orders_f32(const void* src, long long ld, int mode, int L,
                             void* F, void* Fneg, int nr, int m0, int nm,
                             int H, int R, int rn0, int rs0, int dirs, int B,
                             const void* nph, const void* phi0,
                             const void* weight, void* stream) {
  return launch_orders<float>(src, ld, mode, L, F, Fneg, nr, m0, nm, H, R,
                              rn0, rs0, dirs, B, nph, phi0, weight, stream);
}

int heracles_ring_orders_f64(const void* src, long long ld, int mode, int L,
                             void* F, void* Fneg, int nr, int m0, int nm,
                             int H, int R, int rn0, int rs0, int dirs, int B,
                             const void* nph, const void* phi0,
                             const void* weight, void* stream) {
  return launch_orders<double>(src, ld, mode, L, F, Fneg, nr, m0, nm, H, R,
                               rn0, rs0, dirs, B, nph, phi0, weight, stream);
}

}  // extern "C"
