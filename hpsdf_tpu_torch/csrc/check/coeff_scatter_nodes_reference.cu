// K8's node-range mode before its redesign, kept as the reference of
// coeff_scatter.cu's node-range mode: a thread a point, the warps with no
// live point stopping, the live lanes' axis factors in shared memory and
// K8's transposed scatter (lane m sums term m over the warp's points a run
// of one row at a time, one f64 atomic a run) into the (hi - lo, C)
// gradient the caller zeroed. chip_smoke.py builds this file apart from the
// library (_kernels.load_check), holds the shipped mode to it and times
// both in the same run. It is on no path of the package. The arithmetic is
// described in coeff_scatter.cu.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../packed_rows.cuh"
#include "../scatter.cuh"

namespace {

constexpr int kThreads = 128;

// sqrt(2q + 1) (odd == 0) or sqrt(2 (2q + 1)) (odd == 1), correctly
// rounded. Times 2^(d >> 1) they are sqrt((2q + 1) 2^d) in double bit for
// bit, since a power of 4 leaves a correctly rounded root's mantissa as it
// is.
__device__ __forceinline__ double odd_root(int q, int odd) {
  switch (2 * q + odd) {
    case 0: return 1.0;
    case 1: return 1.4142135623730951;
    case 2: return 1.7320508075688772;
    case 3: return 2.449489742783178;
    case 4: return 2.23606797749979;
    case 5: return 3.1622776601683795;
    case 6: return 2.6457513110645907;
    case 7: return 3.7416573867739413;
    case 8: return 3.0;
    case 9: return 4.242640687119285;
    case 10: return 3.3166247903554;
    case 11: return 4.69041575982343;
    case 12: return 3.605551275463989;
    case 13: return 5.0990195135927845;
    case 14: return 3.872983346207417;
    case 15: return 5.477225575051661;
    case 16: return 4.123105625617661;
    case 17: return 5.830951894845301;
    case 18: return 4.358898943540674;
    case 19: return 6.164414002968976;
    case 20: return 4.58257569495584;
    case 21: return 6.48074069840786;
    case 22: return 4.795831523312719;
    case 23: return 6.782329983125268;
    case 24: return 5.0;
    default: return 7.0710678118654755;
  }
}

// 2^k exactly, for a k well inside the exponent range
__device__ __forceinline__ double pow2(int k) {
  return __longlong_as_double((long long)(1023 + k) << 52);
}

// The indices (i, j, k) of basis term m < C of degree DEG, in
// for_each_term's order (by total degree p, then i, then j).
template <int DEG>
__device__ __forceinline__ void term_indices(int m, int& i, int& j, int& k) {
  int p = 0;
#pragma unroll 1
  while (p < DEG && m >= (p + 1) * (p + 2) / 2) {
    m -= (p + 1) * (p + 2) / 2;
    ++p;
  }
  i = 0;
#pragma unroll 1
  while (i < p && m >= p - i + 1) {
    m -= p - i + 1;
    ++i;
  }
  j = m;
  k = p - i - j;
}

// Lane j sums term j (then j + 32, ...) over the warp's live rays (the
// bits of `lanes`, the warp's first thread w0), a run of rays on one row at a
// time, and adds each run's sum into d_coeffs with one atomic: a ray's axis
// factors N in sN, its weight in sW and its row in sLeaf.
template <class T, int DEG>
__device__ __forceinline__ void scatter_terms(const T* sN, const T* sW,
                                              const int* sLeaf,
                                              unsigned lanes, int w0,
                                              int lane, T* d_coeffs) {
  constexpr int kC = (DEG + 1) * (DEG + 2) * (DEG + 3) / 6;
  constexpr int kNS = 3 * (DEG + 1);
#pragma unroll 1
  for (int m = lane; m < ((kC + 31) & ~31); m += 32) {
    int ix = 0, iy = 0, iz = 0;
    if (m < kC) term_indices<DEG>(m, ix, iy, iz);
    T acc = T(0);
    int leaf = -1;
    auto add_ray = [&](int r) {
      const int lr = sLeaf[r];
      if (lr != leaf) {
        if (leaf >= 0 && m < kC)
          atomicAdd(d_coeffs + (int64_t)leaf * kC + m, acc);
        acc = T(0);
        leaf = lr;
      }
      const T* n = sN + r * kNS;
      acc += sW[r] * (n[ix] * n[DEG + 1 + iy] * n[2 * (DEG + 1) + iz]);
    };
#pragma unroll
    for (int r = 0; r < 32; ++r)
      if (lanes >> r & 1u) add_ray(w0 + r);
    if (m < kC) atomicAdd(d_coeffs + (int64_t)leaf * kC + m, acc);
  }
}

// The node-range mode (the node axis, hpsdf_tpu_torch/parallel.py): the
// query form's VJP into the rows [lo, hi) a rank holds, d_coeffs (hi - lo,
// C), from each point's leaf (its global index, from the node-sharded
// query's descent) in place of the descent, which would need rows the rank
// lacks. A point carries a weight only where its leaf lies in the range;
// otherwise as the query form, f64.
template <int DEG>
__global__ void __launch_bounds__(kThreads)
coeff_scatter_nodes_reference_kernel(
    const double* __restrict__ centre, const int32_t* __restrict__ depth,
    int lo, int hi, const double* __restrict__ pts,
    const int32_t* __restrict__ leaf, int64_t B, double rc0, double rc1,
    double rc2, double inv0, double inv1, double inv2,
    const double* __restrict__ cot, int outside_zero,
    double* __restrict__ d_coeffs) {
  constexpr int kNS = 3 * (DEG + 1);
  __shared__ double sN[kThreads * kNS];
  __shared__ double sW[kThreads];
  __shared__ int sLeaf[kThreads];   // the leaf's row in the rank's arrays
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t i = (int64_t)blockIdx.x * kThreads + tid;
  const double rc[3] = {rc0, rc1, rc2};
  const double inv[3] = {inv0, inv1, inv2};

  bool live = false;
  int n = 0;
  if (i < B) {
    n = __ldg(leaf + i) - lo;
    live = n >= 0 && n < hi - lo && __ldg(cot + i) != 0.0;
    if (outside_zero) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        live = live &&
               fabs((__ldg(pts + 3 * i + k) - rc[k]) * inv[k]) <= 0.5;
    }
  }
  const unsigned lanes = __ballot_sync(hpsdf::kFullWarp, live);
  if (lanes == 0u) return;

  if (live) {
    double u[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const double w = (__ldg(pts + 3 * i + k) - rc[k]) * inv[k];
      u[k] = w < -0.5 ? -0.5 : (w > 0.5 ? 0.5 : w);
    }
    const int d = __ldg(depth + n);
    const double scale = pow2(d + 1);
    const double* cc = centre + 3 * (int64_t)n;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      double L[DEG + 1];
      hpsdf::legendre<DEG>((u[k] - __ldg(cc + k)) * scale, L);
#pragma unroll
      for (int q = 0; q <= DEG; ++q)
        sN[tid * kNS + k * (DEG + 1) + q] =
            L[q] * (odd_root(q, d & 1) * pow2(d >> 1));
    }
    sW[tid] = __ldg(cot + i);
    sLeaf[tid] = n;
  }
  __syncwarp();
  scatter_terms<double, DEG>(sN, sW, sLeaf, lanes, tid - lane, lane,
                             d_coeffs);
}

}  // namespace

// The node-range mode: d_coeffs (hi - lo, C) f64 of the rows [lo, hi), from
// the points' global leaves (B,) and cotangents (B,); zeroed by the caller.
extern "C" int hpsdf_coeff_scatter_nodes_reference(
    const double* centre, const int32_t* depth, int deg, int lo, int hi,
    const double* pts, const int32_t* leaf, int64_t B, double rc0,
    double rc1, double rc2, double inv0, double inv1, double inv2,
    const double* cot, int outside_zero, double* d_coeffs, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define HPSDF_LAUNCH(D)                                                      \
  coeff_scatter_nodes_reference_kernel<D><<<blocks, kThreads, 0, s>>>(       \
      centre, depth, lo, hi, pts, leaf, B, rc0, rc1, rc2, inv0, inv1, inv2,  \
      cot, outside_zero, d_coeffs)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
  return (int)cudaGetLastError();
}
