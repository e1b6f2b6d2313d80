// K6 as it was before its redesign, kept as the reference of csrc/fit.cu:
// the fit's point generation (a thread an output coordinate, c + ldexp(x,
// -(depth + 1)), two 64-bit and several run-time integer divisions a
// coordinate) and
// its projection (a block a cell, F read one i-slab at a time behind two
// barriers, the j stage on (D+1)(D+2)/2 threads). chip_smoke.py builds this
// file apart from the library (_kernels.load_check), holds the shipped
// kernels to it (the points bit for bit; the projection bit for bit at the
// degrees whose cells the new kernel does not split) and times both in the
// same run. It is on no path of the package.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPointThreads = 256;
constexpr int kMaxDepth = 10;          // consts.TREE_MAX_DEPTH
constexpr int kMinDegree = 2, kMaxDegree = 11;
constexpr double kSqrt3 = 1.7320508075688772;   // math.sqrt(3.0)

template <int D>
struct Fit {
  static constexpr int Q = 4 * D + 1;                      // rule size
  static constexpr int P = D + 1;                          // L_0 .. L_D
  static constexpr int C = (D + 1) * (D + 2) * (D + 3) / 6;
  static constexpr int PAIRS = (D + 1) * (D + 2) / 2;      // q + r <= D
  static constexpr int S1 = Q * P;                         // (j, r)
  static constexpr int THREADS = S1 >= 256 ? 256 : (S1 + 31) / 32 * 32;
  static_assert(THREADS >= PAIRS, "a thread for every (q, r) pair");
};

__device__ __forceinline__ float scale2(float x, int e) {
  return ldexpf(x, e);
}
__device__ __forceinline__ double scale2(double x, int e) {
  return ldexp(x, e);
}

// the basis index of (p, q, r) (basis.basis_indices: by total degree n,
// then lexicographic in (p, q))
__device__ __forceinline__ int basis_index(int p, int q, int r) {
  const int n = p + q + r;
  return n * (n + 1) * (n + 2) / 6 + p * (n + 1) - p * (p - 1) / 2 + q;
}

template <typename T>
__global__ void __launch_bounds__(kPointThreads)
fit_points_reference_kernel(const T* __restrict__ centres,
                            const int32_t* __restrict__ depths,
                            const T* __restrict__ x, int Q, int64_t n,
                            T* __restrict__ out) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int64_t per_cell = (int64_t)Q * Q * Q * 3;
  const int64_t cell = e / per_cell;
  const int rem = (int)(e - cell * per_cell);
  const int a = rem % 3, pt = rem / 3;         // axis, point (i, j, k)
  const int node = a == 0 ? pt / (Q * Q) : a == 1 ? pt / Q % Q : pt % Q;
  out[e] = centres[3 * cell + a]
           + scale2(__ldg(x + node), -(__ldg(depths + cell) + 1));
}

template <int D, typename T>
__global__ void __launch_bounds__(Fit<D>::THREADS)
fit_project_reference_kernel(const T* __restrict__ F,
                             const int32_t* __restrict__ depths,
                             const T* __restrict__ A, const T* __restrict__ cn,
                             const T* __restrict__ prev, int pw, int nw,
                             T strength, T* __restrict__ out) {
  using K = Fit<D>;
  constexpr int Q = K::Q, P = K::P, C = K::C, NT = K::THREADS;
  __shared__ T a_s[P * Q];          // A[p, i]
  __shared__ T slab[Q * Q];         // F[i, j, k] of one i, (j, k)
  __shared__ T s1[Q * P];           // (j, r)
  __shared__ T row[C];              // raw sums, then the coefficients
  const int t = threadIdx.x;
  const int64_t cell = blockIdx.x;
  const T* f = F + cell * (Q * Q * Q);
  for (int e = t; e < P * Q; e += NT) a_s[e] = A[e];

  // this thread's (q, r) in the j stage, in basis order of (q, r)
  const bool owner = t < K::PAIRS;
  int q = 0, r = owner ? t : 0;
  while (r > D - q) {
    r -= D - q + 1;
    ++q;
  }
  T acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = T(0);

  for (int i = 0; i < Q; ++i) {
    // the k stage of slab i - 1 has passed its barrier: slab is free, and
    // the j stage of i - 1 has read s1 before this barrier
    for (int e = t; e < Q * Q; e += NT) slab[e] = f[i * (Q * Q) + e];
    __syncthreads();
    for (int e = t; e < Q * P; e += NT) {
      const int j = e / P, rr = e - j * P;
      T s = T(0);
#pragma unroll
      for (int k = 0; k < Q; ++k) s = fma(slab[j * Q + k], a_s[rr * Q + k], s);
      s1[e] = s;
    }
    __syncthreads();
    if (owner) {
      T s = T(0);
#pragma unroll
      for (int j = 0; j < Q; ++j) s = fma(a_s[q * Q + j], s1[j * P + r], s);
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (p <= D - q - r) acc[p] = fma(a_s[p * Q + i], s, acc[p]);
    }
  }

  if (owner) {
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (p <= D - q - r) row[basis_index(p, q, r)] = acc[p];
  }
  __syncthreads();
  const int depth = __ldg(depths + cell);
  const bool ok = depth >= 0 && depth <= kMaxDepth;
  const T h3 = scale2(T(1), -3 * (depth + 1));      // half^3, exact
  const T* pv = prev + cell * pw;
  T* o = out + cell * (C + 1);
  for (int c = t; c < C; c += NT) {
    T v = c < pw ? pv[c] : row[c] * cn[(ok ? depth : 0) * C + c] * h3;
    if (!ok) v = T(NAN);
    row[c] = v;
    o[c] = v;
  }
  __syncthreads();
  if (t == 0) {
    T err = T(0);
    for (int c = C - K::PAIRS; c < C; ++c) err += row[c] * row[c];
    if (nw != 0) {
      // exact cell mean: only the constant basis has one; c_0 is the kept
      // prev[0] when pw > 0
      const T fbar = fabs(row[0] * exp2(T(1.5) * T(depth)));
      T k;
      if (nw == 1) {
        k = pow(T(1) - fbar / T(kSqrt3), strength);
        k = k < T(0) ? T(0) : (k > T(1) ? T(1) : k);   // NaN stays NaN
      } else {
        k = exp(-strength * fbar / T(kSqrt3));
      }
      err = err * k;
    }
    o[C] = ok ? err : T(NAN);
  }
}

template <int D, typename T>
int project(const T* F, const int32_t* depths, const T* A, const T* cn,
            const T* prev, int pw, int nw, double strength, int64_t m,
            T* out, cudaStream_t stream) {
  if (pw < 0 || pw > Fit<D>::C) return (int)cudaErrorInvalidValue;
  fit_project_reference_kernel<D, T>
      <<<(unsigned)m, Fit<D>::THREADS, 0, stream>>>(
          F, depths, A, cn, prev, pw, nw, (T)strength, out);
  return (int)cudaGetLastError();
}

template <typename T>
int project_degree(int degree, const T* F, const int32_t* depths, const T* A,
                   const T* cn, const T* prev, int pw, int nw,
                   double strength, int64_t m, T* out, cudaStream_t s) {
  switch (degree) {
#define HPSDF_FIT_CASE(D) \
    case D: return project<D, T>(F, depths, A, cn, prev, pw, nw, strength, \
                                 m, out, s);
    HPSDF_FIT_CASE(2) HPSDF_FIT_CASE(3) HPSDF_FIT_CASE(4) HPSDF_FIT_CASE(5)
    HPSDF_FIT_CASE(6) HPSDF_FIT_CASE(7) HPSDF_FIT_CASE(8) HPSDF_FIT_CASE(9)
    HPSDF_FIT_CASE(10) HPSDF_FIT_CASE(11)
#undef HPSDF_FIT_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// centres: (m, 3), x: (Q,) Gauss-Legendre nodes, out: (m Q^3, 3), all of
// the value type (f64 when f64 != 0, else f32), contiguous; depths (m,)
// int32.
extern "C" int hpsdf_fit_points_reference(const void* centres,
                                          const int32_t* depths,
                                          const void* x, int Q, int64_t m,
                                          int f64, void* out, void* stream) {
  if (Q < 1) return (int)cudaErrorInvalidValue;
  const int64_t n = m * Q * Q * Q * 3;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kPointThreads - 1) / kPointThreads);
  if (f64)
    fit_points_reference_kernel<double><<<blocks, kPointThreads, 0,
                                          (cudaStream_t)stream>>>(
        (const double*)centres, depths, (const double*)x, Q, n,
        (double*)out);
  else
    fit_points_reference_kernel<float><<<blocks, kPointThreads, 0,
                                         (cudaStream_t)stream>>>(
        (const float*)centres, depths, (const float*)x, Q, n, (float*)out);
  return (int)cudaGetLastError();
}

// F: (m, Q, Q, Q) with Q = 4 degree + 1; A: (degree + 1, Q)
// quadrature_matrix; cn: (TREE_MAX_DEPTH + 1, C) coeff_norms; prev: (m, pw)
// or null when pw is 0; out: (m, C + 1) rows [coeffs | err]; all of the
// value type (f64 when f64 != 0, else f32), contiguous; depths (m,) int32;
// nw 0 (none), 1 (polynomial), 2 (exponential); degree 2..11.
extern "C" int hpsdf_fit_project_reference(const void* F,
                                           const int32_t* depths,
                                           const void* A, const void* cn,
                                           const void* prev, int pw,
                                           int degree, int nw,
                                           double strength, int64_t m,
                                           int f64, void* out, void* stream) {
  if (degree < kMinDegree || degree > kMaxDegree || nw < 0 || nw > 2)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  if (f64)
    return project_degree<double>(
        degree, (const double*)F, depths, (const double*)A,
        (const double*)cn, (const double*)prev, pw, nw, strength, m,
        (double*)out, (cudaStream_t)stream);
  return project_degree<float>(
      degree, (const float*)F, depths, (const float*)A, (const float*)cn,
      (const float*)prev, pw, nw, strength, m, (float*)out,
      (cudaStream_t)stream);
}
