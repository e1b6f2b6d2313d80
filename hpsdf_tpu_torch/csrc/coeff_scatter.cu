// K8: gradients to the coefficients of the generic tree, in f64 (the VJP of
// K1's query) or f32 (the trace's implicit VJP).
//
// Replaces what autodiff gave the reference for the coefficients: the VJP of
// hpsdf_tpu/query.py query (:70-88; parallel.loss_fn, parallel.py:179-188)
// and the backward of the differentiable trace (render.py _trace_bwd,
// :964-998, through _values_at :120-130). The plain torch versions are
// query_vjp_plain in hpsdf_tpu_torch/query.py (autograd of query_plain) and
// trace_vjp_plain in hpsdf_tpu_torch/render.py. Per point the kernel runs
// K1's arithmetic (world -> unit cube, the clamp, depth_used rounds of the
// descent, the local frame, the Legendre recurrences with the norms
// sqrt((2p+1) 2^d) folded into the axes) and then adds w * norm_m * L_i(x)
// L_j(y) L_k(z) into d_coeffs[leaf, m] for every basis term m. Its weight w:
//   * query form: the cotangent of the point's value; zero outside the root
//     when the query returns the f64-max sentinel there (a constant);
//   * trace form (f32, fused): for a ray that hit at t, with cotangent dt,
//     p = o + t d, dfdt = grad f(p) . d (the clamp's derivative zero on an
//     axis clamped into the root), safe = dfdt where |dfdt| > 1e-6 and 1e-6
//     elsewhere (a negative small dfdt too, as the reference), and
//     w = -dt / safe; nothing for a ray that missed.
//
// Design. An inverse chunk's rays are mostly dead: a ray that missed, or
// whose cotangent is zero (dt is zero wherever the target missed), adds
// nothing, and at the reference's camera about half of a step's chunks hit
// nothing at all. The live rays crowd into the few dozen leaves near the
// surface, and neighbouring rays share one. So a warp of 32 rays (points)
//   * first decides from the cheap inputs which of them carry a weight
//     (trace: hit and dt != 0; query: cot != 0 and, under the sentinel,
//     inside the root), and stops when none does; only the live lanes run
//     the descent, the recurrences and (trace) the dfdt sum;
//   * takes the axis norms sqrt((2q+1) 2^d) from a table of roots and the
//     exponent, bit-equal to the double sqrt and ldexp that the kernel it
//     replaced computed at a cost (PERF.md);
//   * then scatters transposed: each live lane puts its leaf, its weight
//     and its 3 (DEG+1) axis factors N in shared memory, and lane j sums
//     term j (then j + 32, ...) over the warp's live rays in lane order,
//     one run of rays on a leaf at a time, adding each run's sum with one
//     atomic. A run's C adds are then one coalesced row from 32 lanes, where
//     the kernel it replaced summed each term over a leaf's lanes by
//     shuffles and had one lane add the C sums one by one.
// Skipping a zero weight is exact: the kernel it replaced added +-0 there.
// The (N, C) output is cleared by the caller (a memset) before the launch.
// Forms measured and dropped (a block-level queue of the live rays, a
// shared-memory table of the block's leaves flushed by float4 atomics or the
// bulk reduce-add, the rays staged in shared memory, the coefficient row in
// 16-byte loads, a rolled scatter loop, runs found by a ballot with the terms
// in registers, stores in place of the atomics, the norms by double sqrt and
// ldexp) are in PERF.md.
//
// Bound. Per live point one descent (depth_used dependent loads), one
// coefficient row (trace), the recurrences and C adds. A chunk has at most
// some 15,000 live rays and its launch is short: what costs is the launch
// and the memset, then one ray's chain of dependent loads and arithmetic,
// then the scatter's loop (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "packed_rows.cuh"
#include "scatter.cuh"

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

struct TraceIn {
  const float* origins;   // (B, 3)
  const float* dirs;      // (B, 3)
  const float* t;         // (B,)
  const uint8_t* hit;     // (B,)
};

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

template <class T, int DEG, bool TRACE>
__global__ void __launch_bounds__(kThreads)
coeff_scatter_kernel(const int32_t* __restrict__ child_idx,
                     const T* __restrict__ centre,
                     const int32_t* __restrict__ depth,
                     const T* __restrict__ coeffs, int depth_used,
                     const T* __restrict__ pts, TraceIn tr, int64_t B,
                     T rc0, T rc1, T rc2, T inv0, T inv1, T inv2,
                     const T* __restrict__ cot, int outside_zero,
                     T* __restrict__ d_coeffs) {
  constexpr int kC = (DEG + 1) * (DEG + 2) * (DEG + 3) / 6;
  constexpr int kNS = 3 * (DEG + 1);
  __shared__ T sN[kThreads * kNS];  // a live lane's N[axis][q]
  __shared__ T sW[kThreads];        // its weight
  __shared__ int sLeaf[kThreads];   // its leaf
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t i = (int64_t)blockIdx.x * kThreads + tid;
  const T rc[3] = {rc0, rc1, rc2};
  const T inv[3] = {inv0, inv1, inv2};

  // which rays carry a weight, from the cheap inputs
  bool live = false;
  if (i < B) {
    if constexpr (TRACE) {
      live = __ldg(tr.hit + i) != 0 && __ldg(cot + i) != T(0);
    } else {
      live = __ldg(cot + i) != T(0);
      if (outside_zero) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
          live = live &&
                 fabs((__ldg(pts + 3 * i + k) - rc[k]) * inv[k]) <=
                     T(0.5);
      }
    }
  }
  const unsigned lanes = __ballot_sync(hpsdf::kFullWarp, live);
  if (lanes == 0u) return;

  if (live) {
    T p[3], u[3], dir[3];
    bool in_axis[3];
    if constexpr (TRACE) {
      const float t = __ldg(tr.t + i);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dir[k] = __ldg(tr.dirs + 3 * i + k);
        p[k] = __ldg(tr.origins + 3 * i + k) + t * dir[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = __ldg(pts + 3 * i + k);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T w = (p[k] - rc[k]) * inv[k];
      in_axis[k] = fabs(w) <= T(0.5);
      u[k] = w < T(-0.5) ? T(-0.5) : (w > T(0.5) ? T(0.5) : w);
    }

    int cur = 0;
    for (int r = 0; r < depth_used; ++r) {
      const int c0 = __ldg(child_idx + cur);
      if (c0 < 0) break;
      const T* cc = centre + 3 * (int64_t)cur;
      cur = c0 + (u[0] >= __ldg(cc)) + ((u[1] >= __ldg(cc + 1)) << 1) +
            ((u[2] >= __ldg(cc + 2)) << 2);
    }
    const int d = __ldg(depth + cur);
    const T scale = (T)pow2(d + 1);
    const T* cc = centre + 3 * (int64_t)cur;
    // N[k][q] = L_q(x_k) nt[q], nt[q] = sqrt((2q+1) 2^d); dN likewise
    T N[3][DEG + 1], dN[3][DEG + 1];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      T L[DEG + 1], dL[DEG + 1];
      hpsdf::legendre<DEG>((u[k] - __ldg(cc + k)) * scale, L);
      if constexpr (TRACE) hpsdf::legendre_deriv<DEG>(L, dL);
#pragma unroll
      for (int q = 0; q <= DEG; ++q) {
        const T nt = (T)(odd_root(q, d & 1) * pow2(d >> 1));
        N[k][q] = L[q] * nt;
        if constexpr (TRACE) dN[k][q] = dL[q] * nt;
      }
    }

    T w;
    if constexpr (TRACE) {
      const T* c = coeffs + (int64_t)cur * kC;
      T g[3] = {T(0), T(0), T(0)};
      hpsdf::for_each_term_of<DEG>([&](int m, int ix, int iy, int iz) {
        const T cm = __ldg(c + m);
        g[0] += cm * (dN[0][ix] * N[1][iy] * N[2][iz]);
        g[1] += cm * (N[0][ix] * dN[1][iy] * N[2][iz]);
        g[2] += cm * (N[0][ix] * N[1][iy] * dN[2][iz]);
      });
      T dfdt = T(0);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (in_axis[k]) dfdt += g[k] * scale * inv[k] * dir[k];
      const T safe = fabs(dfdt) > T(1e-6) ? dfdt : T(1e-6);
      w = -__ldg(cot + i) / safe;
    } else {
      w = __ldg(cot + i);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int q = 0; q <= DEG; ++q)
        sN[tid * kNS + k * (DEG + 1) + q] = N[k][q];
    sW[tid] = w;
    sLeaf[tid] = cur;
  }
  __syncwarp();

  // lane j sums term j (then j + 32, ...) over the warp's live rays, a run
  // of rays on one leaf at a time, and adds each run's sum
  const int w0 = tid - lane;
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

}  // namespace

// dtype 8: the query form in f64 (pts, cot, the tree's centre and coeffs
// f64); dtype 4: the trace form in f32 (origins, dirs, t, hit, cot = dt; the
// tree's centre and coeffs f32). d_coeffs (N, C) must be zeroed by the
// caller.
extern "C" int hpsdf_coeff_scatter(const int32_t* child_idx,
                                   const void* centre, const int32_t* depth,
                                   const void* coeffs, int deg, int depth_used,
                                   const void* pts, const float* origins,
                                   const float* dirs, const float* t,
                                   const uint8_t* hit, int64_t B, double rc0,
                                   double rc1, double rc2, double inv0,
                                   double inv1, double inv2, const void* cot,
                                   int outside_zero, int dtype,
                                   void* d_coeffs, void* stream) {
  if (B <= 0 || (dtype != 4 && dtype != 8)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const TraceIn tr{origins, dirs, t, hit};
#define HPSDF_LAUNCH(D)                                                      \
  if (dtype == 8)                                                            \
    coeff_scatter_kernel<double, D, false><<<blocks, kThreads, 0, s>>>(      \
        child_idx, (const double*)centre, depth, (const double*)coeffs,      \
        depth_used, (const double*)pts, tr, B, rc0, rc1, rc2, inv0, inv1,    \
        inv2, (const double*)cot, outside_zero, (double*)d_coeffs);          \
  else                                                                       \
    coeff_scatter_kernel<float, D, true><<<blocks, kThreads, 0, s>>>(        \
        child_idx, (const float*)centre, depth, (const float*)coeffs,        \
        depth_used, nullptr, tr, B, (float)rc0, (float)rc1, (float)rc2,      \
        (float)inv0, (float)inv1, (float)inv2, (const float*)cot,            \
        outside_zero, (float*)d_coeffs)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
  return (int)cudaGetLastError();
}
