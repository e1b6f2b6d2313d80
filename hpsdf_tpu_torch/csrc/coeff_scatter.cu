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
//     p = o + t d, dfdt = grad f(p) . d, each axis weighted by the clamp's
//     derivative, jnp.clip's (1 inside the root, 1/2 on a face of it, 0
//     outside), safe = dfdt where |dfdt| > 1e-6 and 1e-6 elsewhere (a
//     negative small dfdt too, as the reference), and w = -dt / safe;
//     nothing for a ray that missed.
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
// The query and trace forms' (N, C) output is cleared by the caller (a
// memset) before the launch.
// Forms measured and dropped (a block-level queue of the live rays, a
// shared-memory table of the block's leaves flushed by float4 atomics or the
// bulk reduce-add, the rays staged in shared memory, the coefficient row in
// 16-byte loads, a rolled scatter loop, runs found by a ballot with the terms
// in registers, stores in place of the atomics, the norms by double sqrt and
// ldexp) are in PERF.md.
//
// K8g (coeff_scatter_grad_kernel), the VJP of query_with_gradient to the
// coefficients, is the query form with the unit gradient's cotangent too;
// it is described above its kernel below.
//
// The node-range mode (node_buckets_kernel, then coeff_scatter_nodes_kernel)
// is the query form for a rank of the node axis, which holds a range of the
// node rows; it is laid out for scattered points and described above its
// kernels below.
//
// Bound. Per live point one descent (depth_used dependent loads), one
// coefficient row (trace), the recurrences and C adds. A chunk has at most
// some 15,000 live rays and its launch is short: what costs is the launch
// and the memset, then one ray's chain of dependent loads and arithmetic,
// then the scatter's loop (PERF.md). The node-range mode at a rank of a
// large tree is bound by writing its (hi - lo, C) rows once.

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

// The leaf of the tree that holds the clamped unit-cube point u (up to
// depth_used rounds of the descent, stopping at a leaf), returned with its
// scale 2^(depth+1) and its axis factors N[a][q] = L_q(x_a) nt[q],
// nt[q] = sqrt((2q + 1) 2^depth), and with GRAD dN[a][q] = L'_q(x_a) nt[q];
// x = (u - centre) * scale. Every form of the file reads a point's leaf
// through it.
template <class T, int DEG, bool GRAD>
__device__ __forceinline__ int leaf_factors(
    const int32_t* __restrict__ child_idx, const T* __restrict__ centre,
    const int32_t* __restrict__ depth, int depth_used, const T (&u)[3],
    T& scale, T (&N)[3][DEG + 1], T (&dN)[3][DEG + 1]) {
  int cur = 0;
  for (int r = 0; r < depth_used; ++r) {
    const int c0 = __ldg(child_idx + cur);
    if (c0 < 0) break;
    const T* cc = centre + 3 * (int64_t)cur;
    cur = c0 + (u[0] >= __ldg(cc)) + ((u[1] >= __ldg(cc + 1)) << 1) +
          ((u[2] >= __ldg(cc + 2)) << 2);
  }
  const int d = __ldg(depth + cur);
  scale = (T)pow2(d + 1);
  const T* cc = centre + 3 * (int64_t)cur;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    T L[DEG + 1], dL[DEG + 1];
    hpsdf::legendre<DEG>((u[k] - __ldg(cc + k)) * scale, L);
    if constexpr (GRAD) hpsdf::legendre_deriv<DEG>(L, dL);
#pragma unroll
    for (int q = 0; q <= DEG; ++q) {
      const T nt = (T)(odd_root(q, d & 1) * pow2(d >> 1));
      N[k][q] = L[q] * nt;
      if constexpr (GRAD) dN[k][q] = dL[q] * nt;
    }
  }
  return cur;
}

// g = the leaf-frame gradient of the product sum over the coefficient row
// c, from leaf_factors' N and dN.
template <class T, int DEG>
__device__ __forceinline__ void leaf_gradient(const T* __restrict__ c,
                                              const T (&N)[3][DEG + 1],
                                              const T (&dN)[3][DEG + 1],
                                              T (&g)[3]) {
  g[0] = g[1] = g[2] = T(0);
  hpsdf::for_each_term_of<DEG>([&](int m, int ix, int iy, int iz) {
    const T cm = __ldg(c + m);
    g[0] += cm * (dN[0][ix] * N[1][iy] * N[2][iz]);
    g[1] += cm * (N[0][ix] * dN[1][iy] * N[2][iz]);
    g[2] += cm * (N[0][ix] * N[1][iy] * dN[2][iz]);
  });
}

// Lane j sums term j (then j + 32, ...) over the warp's live rays (the
// bits of `lanes`, the warp's first thread w0), a run of rays on one row at a
// time, and adds each run's sum into d_coeffs with one atomic: a ray's axis
// factors N in sN, its weight in sW and its row in sLeaf. With GRAD (K8g) a
// ray's factors are N and, after them, B_a = q_a dN_a, and its term m adds
// w N_i N_j N_k + B_i N_j N_k + N_i B_j N_k + N_i N_j B_k.
template <class T, int DEG, bool GRAD = false>
__device__ __forceinline__ void scatter_terms(const T* sN, const T* sW,
                                              const int* sLeaf,
                                              unsigned lanes, int w0,
                                              int lane, T* d_coeffs) {
  constexpr int kC = (DEG + 1) * (DEG + 2) * (DEG + 3) / 6;
  constexpr int kD = DEG + 1;
  constexpr int kNS = (GRAD ? 6 : 3) * kD;
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
      const T nx = n[ix], ny = n[kD + iy], nz = n[2 * kD + iz];
      acc += sW[r] * (nx * ny * nz);
      if constexpr (GRAD)
        acc += n[3 * kD + ix] * ny * nz + nx * n[4 * kD + iy] * nz +
               nx * ny * n[5 * kD + iz];
    };
#pragma unroll
    for (int r = 0; r < 32; ++r)
      if (lanes >> r & 1u) add_ray(w0 + r);
    if (m < kC) atomicAdd(d_coeffs + (int64_t)leaf * kC + m, acc);
  }
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
    T p[3], u[3], dir[3], slope[3];
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
      slope[k] = hpsdf::clamp_half_slope(w);
      u[k] = w < T(-0.5) ? T(-0.5) : (w > T(0.5) ? T(0.5) : w);
    }

    T scale, N[3][DEG + 1], dN[3][DEG + 1];
    const int cur = leaf_factors<T, DEG, TRACE>(child_idx, centre, depth,
                                                depth_used, u, scale, N, dN);

    T w;
    if constexpr (TRACE) {
      T g[3];
      leaf_gradient<T, DEG>(coeffs + (int64_t)cur * kC, N, dN, g);
      T dfdt = T(0);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (slope[k] != T(0))
          dfdt += slope[k] * g[k] * scale * inv[k] * dir[k];
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
  scatter_terms<T, DEG>(sN, sW, sLeaf, lanes, tid - lane, lane, d_coeffs);
}

// --- K8g: the VJP of query_with_gradient to the coefficients -------------
//
// query_with_gradient_vjp_plain's coefficient half, in f64, as the query
// form: a thread a point, the warp's live points scattered transposed
// (scatter_terms). A point is live where its value's cotangent (zero
// outside the root, where the value is the sentinel) or its unit
// gradient's is not zero. Like the trace form, a live point reads its
// leaf's coefficient row for the gradient g of its leaf frame: with
// s_a = 2^(depth+1) / size_a and gb = unit_vector_vjp(g s, wn, 1e-30),
// d_coeffs[leaf, m] += w' P_m + sum_a gb_a s_a dP_m/dx_a, P_m the
// normalised basis product. Its factors are twice the query form's, so a
// block is kGradThreads threads, whose factors fit 48 KB at degree 12.
// The (N, C) output is cleared by the caller (a memset) before the launch.

constexpr int kGradThreads = 64;

template <int DEG>
__global__ void __launch_bounds__(kGradThreads)
coeff_scatter_grad_kernel(const int32_t* __restrict__ child_idx,
                          const double* __restrict__ centre,
                          const int32_t* __restrict__ depth,
                          const double* __restrict__ coeffs, int depth_used,
                          const double* __restrict__ pts, int64_t B,
                          double rc0, double rc1, double rc2, double inv0,
                          double inv1, double inv2,
                          const double* __restrict__ wv,
                          const double* __restrict__ wn,
                          double* __restrict__ d_coeffs) {
  constexpr int kC = (DEG + 1) * (DEG + 2) * (DEG + 3) / 6;
  constexpr int kD = DEG + 1;
  constexpr int kNS = 6 * kD;
  __shared__ double sN[kGradThreads * kNS];  // a live lane's N, then B
  __shared__ double sW[kGradThreads];        // its value's weight
  __shared__ int sLeaf[kGradThreads];        // its leaf
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t i = (int64_t)blockIdx.x * kGradThreads + tid;
  const double rc[3] = {rc0, rc1, rc2};
  const double inv[3] = {inv0, inv1, inv2};

  // which points carry a weight, from the cheap inputs
  bool live = false;
  double x[3], w = 0.0, wnv[3] = {0.0, 0.0, 0.0};
  if (i < B) {
    bool inside = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      x[a] = (__ldg(pts + 3 * i + a) - rc[a]) * inv[a];
      inside = inside && fabs(x[a]) <= 0.5;
      wnv[a] = __ldg(wn + 3 * i + a);
    }
    w = inside ? __ldg(wv + i) : 0.0;
    live = w != 0.0 || wnv[0] != 0.0 || wnv[1] != 0.0 || wnv[2] != 0.0;
  }
  const unsigned lanes = __ballot_sync(hpsdf::kFullWarp, live);
  if (lanes == 0u) return;

  if (live) {
    double u[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      u[a] = x[a] < -0.5 ? -0.5 : (x[a] > 0.5 ? 0.5 : x[a]);
    double scale, N[3][kD], dN[3][kD], g[3];
    const int cur = leaf_factors<double, DEG, true>(
        child_idx, centre, depth, depth_used, u, scale, N, dN);
    leaf_gradient<double, DEG>(coeffs + (int64_t)cur * kC, N, dN, g);
    // local = (unit - centre) * 2^(depth+1), unit = (world - c) / sizes
    double s[3], G[3], gb[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s[a] = scale * inv[a];
      G[a] = g[a] * s[a];
    }
    hpsdf::unit_vector_vjp(G, wnv, 1e-30, gb);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const double qa = gb[a] * s[a];
#pragma unroll
      for (int q = 0; q <= DEG; ++q) {
        sN[tid * kNS + a * kD + q] = N[a][q];
        sN[tid * kNS + (3 + a) * kD + q] = qa * dN[a][q];
      }
    }
    sW[tid] = w;
    sLeaf[tid] = cur;
  }
  __syncwarp();
  scatter_terms<double, DEG, true>(sN, sW, sLeaf, lanes, tid - lane, lane,
                                   d_coeffs);
}

// --- the node-range mode --------------------------------------------------
//
// The query form's VJP into the rows [lo, hi) that a rank of the node axis
// (hpsdf_tpu_torch/parallel.py) holds, d_coeffs (hi - lo, C), from each
// point's leaf (its global index, from the node-sharded query's descent) in
// place of the descent, which would need rows the rank lacks. A point
// carries a weight only where its leaf lies in the range, its cotangent is
// not zero and, under the f64-max sentinel, it lies inside the root.
//
// Design. The rank's rows are cut into tiles of T consecutive rows, T x C
// at most kTileElems sums (the wrapper's node_tile_rows). Two plain
// launches, no memset, and no global atomic:
//   * node_sort_kernel, a block of kSortThreads threads a segment of
//     kSortPoints points: the block counts its live points a tile in shared
//     memory (tiles a window of kSortBins at a time), scans the counts,
//     writes each tile's first place in the segment to its row of offsets
//     (segment-major: offsets[g (n_tiles + 1) + t], the total last), lays
//     its live points, (index, row within the tile), out in tile order in
//     shared memory and writes them out whole from the segment's start.
//     Dead points are read here and never again; every store is coalesced.
//   * coeff_scatter_nodes_kernel, persistent blocks, a tile at a time: the
//     tile's runs (one a segment) are read kSegWindow segments at a time,
//     the first ones loaded into registers while the block works on the
//     tile before, and its rows' depth and centre are read whole into
//     shared memory. Its points are staged a chunk at a
//     time: each run's places written out by a thread a run, then a thread
//     a point (two in flight up to degree 4) loads the item, then the point
//     and cotangent, forms the axis factors N by the query form's
//     recurrences and norms and writes the point's C products w N_i N_j N_k
//     to shared memory, and lists the point with the warp that owns its row
//     (a warp owns T / 8 rows). Each warp then adds its points' products
//     one point after another, a lane a term, into the tile's T x C sums in
//     shared memory, so that no two threads ever add to one sum. The sums
//     are stored whole with 16-byte streaming stores, the zero rows too.
//     Each output element is written once, by a plain store.
// The offsets grow as the points times the tiles, G (n_tiles + 1) ints for
// G = ceil(B / kSortPoints) segments, and each tile reads and scans its G
// runs, so the call's share of its bound falls as the points grow
// (PERF.md).
// A shared f64 add is a compare-and-swap loop on sm_90a; none is used. The
// forms tried on the way (shared f64 atomics, a cooperative bucketing
// launch, sums in registers, the points copied in tile order, a search of
// the runs a point, sums across lanes by shuffles) are in PERF.md.

constexpr int kSortThreads = 1024;
constexpr int kSortPer = 4;                        // points a thread
constexpr int kSortPoints = kSortThreads * kSortPer;
constexpr int kSortBins = 8 * 1024;                // tiles a window
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTileElems = 4096;                   // sums a tile
constexpr int kTileMaxRows = 512;
constexpr int kStageBytes = 20 * 1024;             // a chunk's points
constexpr int kSegWindow = 2048;                   // segments' runs at once

// A tile's shape at degree DEG: its most rows, the points a chunk stages
// (at least 32), and its fixed shared memory (the sums, the rows' centre
// and depth, the staged points).
template <int DEG>
struct NodeTile {
  static constexpr int kC = (DEG + 1) * (DEG + 2) * (DEG + 3) / 6;
  static constexpr int kFit = (kTileElems / kC) & ~1;
  static constexpr int kRows = kFit < kTileMaxRows ? kFit : kTileMaxRows;
  // a staged point: its C products (f64), its place, and an entry in each
  // warp's list
  static constexpr int kPointBytes = 8 * kC + 4 + 4 * kTileWarps;
  static constexpr int kStage = kStageBytes / kPointBytes / 32 * 32;
  static constexpr int kPoints =
      kStage > 512 ? 512 : (kStage < 32 ? 32 : kStage);
  static constexpr int kSmem = 8 * kRows * kC + 28 * kRows +
                               kPoints * kPointBytes;
  // blocks an SM the registers are sized for (above degree 4 a block's
  // registers are not capped: its products would spill)
  static constexpr int kMinBlocks = DEG <= 4 ? 3 : 1;
};

// What both launches read of the points.
struct NodeIn {
  const double* pts;     // (B, 3)
  const int32_t* leaf;   // (B,) global leaf indices
  const double* cot;     // (B,)
  int64_t B;
  int lo, rows, tile_rows;
  int outside_zero;
  double rc[3], inv[3];
};

// Point i's tile and its row n in the rank's arrays, or -1 where it
// carries no weight into the rank's rows.
__device__ __forceinline__ int node_tile(const NodeIn& in, int64_t i,
                                         int& n) {
  n = __ldg(in.leaf + i) - in.lo;
  const double c = __ldg(in.cot + i);
  bool live = n >= 0 && n < in.rows && c != 0.0;
  if (in.outside_zero) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      live = live && fabs((__ldg(in.pts + 3 * i + k) - in.rc[k]) *
                          in.inv[k]) <= 0.5;
  }
  return live ? n / in.tile_rows : -1;
}

// An exclusive scan of v[0..n) in place across a block of THREADS threads,
// v[n] the total; the block's threads all call it, after a barrier that
// makes v whole, and find it scanned after a barrier of their own.
template <int THREADS>
__device__ __forceinline__ void block_scan(int* v, int n, int* warp_sums) {
  constexpr int kWarps = THREADS / 32;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int per = (n + THREADS - 1) / THREADS;
  const int first = tid * per;
  int own = 0;
  for (int k = 0; k < per; ++k)
    if (first + k < n) own += v[first + k];
  int x = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(hpsdf::kFullWarp, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(hpsdf::kFullWarp, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  int at = x - own + (wid > 0 ? warp_sums[wid - 1] : 0);
  for (int k = 0; k < per; ++k)
    if (first + k < n) {
      const int c = v[first + k];
      v[first + k] = at;
      at += c;
    }
  if (tid == THREADS - 1) v[n] = at;
}

// The sort: block g's segment is the points [g P, (g + 1) P), P =
// kSortPoints. On return tile t's points of segment g lie at places g P +
// [offsets[g (n_tiles + 1) + t], offsets[g (n_tiles + 1) + t + 1]) of items
// (point index, row within the tile). Dynamic shared memory: P items, then
// min(n_tiles, kSortBins) + 1 ints.
__global__ void __launch_bounds__(kSortThreads)
node_sort_kernel(NodeIn in, int n_tiles, int* __restrict__ offsets,
                 int2* __restrict__ items) {
  extern __shared__ int2 sItem[];                       // P
  int* sBin = reinterpret_cast<int*>(sItem + kSortPoints);
  __shared__ int sWarp[kSortThreads / 32];
  const int64_t base = (int64_t)blockIdx.x * kSortPoints;
  int* row_off = offsets + (int64_t)blockIdx.x * (n_tiles + 1);
  int t[kSortPer], n[kSortPer];
#pragma unroll
  for (int u = 0; u < kSortPer; ++u) {
    const int64_t i = base + threadIdx.x + u * kSortThreads;
    t[u] = i < in.B ? node_tile(in, i, n[u]) : -1;
  }
  int carry = 0;                      // the block's places before a window
  for (int w0 = 0; w0 < n_tiles; w0 += kSortBins) {
    const int W = min(kSortBins, n_tiles - w0);
    for (int k = threadIdx.x; k <= W; k += kSortThreads) sBin[k] = 0;
    __syncthreads();
    int rank[kSortPer];
#pragma unroll
    for (int u = 0; u < kSortPer; ++u)
      rank[u] = t[u] >= w0 && t[u] < w0 + W
                    ? atomicAdd(sBin + t[u] - w0, 1) : -1;
    __syncthreads();
    block_scan<kSortThreads>(sBin, W, sWarp);
    __syncthreads();
    for (int k = threadIdx.x; k < W; k += kSortThreads)
      row_off[w0 + k] = carry + sBin[k];
#pragma unroll
    for (int u = 0; u < kSortPer; ++u)
      if (rank[u] >= 0)
        sItem[carry + sBin[t[u] - w0] + rank[u]] = make_int2(
            (int)(base + threadIdx.x + u * kSortThreads),
            n[u] - t[u] * in.tile_rows);
    carry += sBin[W];
    __syncthreads();
  }
  if (threadIdx.x == 0) row_off[n_tiles] = carry;
  for (int k = threadIdx.x; k < carry; k += kSortThreads)
    items[base + k] = sItem[k];
}

// The tiles: block b forms tile b's T x C sums from its points and stores
// them whole, then takes tile b + gridDim.x, whose runs it has loaded into
// registers meanwhile. Dynamic shared memory: NodeTile<DEG>::kSmem bytes
// and then 2 min(G, kSegWindow) + 1 ints, G segments.
template <int DEG>
__global__ void __launch_bounds__(kTileThreads, NodeTile<DEG>::kMinBlocks)
coeff_scatter_nodes_kernel(const double* __restrict__ centre,
                           const int32_t* __restrict__ depth, NodeIn in,
                           int G, int n_tiles,
                           const int* __restrict__ offsets,
                           const int2* __restrict__ items,
                           double* __restrict__ d_coeffs) {
  using S = NodeTile<DEG>;
  constexpr int kC = S::kC, kP = S::kPoints;
  constexpr int kOffPer = 2;                    // runs a thread prefetches
  constexpr int kH = DEG <= 4 ? 2 : 1;          // points a thread stages at once
  extern __shared__ double sSum[];              // T x C
  double* sCentre = sSum + S::kRows * kC;       // T x 3
  double* sV = sCentre + 3 * S::kRows;          // kP x C: w N_i N_j N_k
  int* sDepth = reinterpret_cast<int*>(sV + kP * kC);  // T
  int* sPos = sDepth + S::kRows;                // kP: a staged point's place
  int* sList = sPos + kP;                       // kTileWarps x kP: p | r << 16
  const int W = min(G, kSegWindow);             // runs a window
  int* sStart = sList + kTileWarps * kP;        // W + 1: runs' first staged
  int* sOff = sStart + W + 1;                   // W: runs' first places
  __shared__ int sWarp[kTileWarps];
  __shared__ int sCnt[kTileWarps];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int T = in.tile_rows;
  const int per_warp = (T + kTileWarps - 1) / kTileWarps;  // rows a warp

  // a tile's runs (first place and end in each segment), loaded into
  // registers ahead of the tile
  int pa[kOffPer], pb[kOffPer];
  auto fetch = [&](int t) {
#pragma unroll
    for (int u = 0; u < kOffPer; ++u) {
      const int g = tid + u * kTileThreads;
      if (g < G) {
        const int* o = offsets + (int64_t)g * (n_tiles + 1) + t;
        pa[u] = __ldg(o);
        pb[u] = __ldg(o + 1);
      }
    }
  };
  int tile = blockIdx.x;
  if (tile < n_tiles) fetch(tile);

  for (; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * T;
    const int nr = min(T, in.rows - r0);
    const int n_el = nr * kC;
    double* out = d_coeffs + (int64_t)r0 * kC;
    double2* out2 = reinterpret_cast<double2*>(out);
    __syncthreads();                   // the last tile's shared reads done
    for (int k = tid; k < nr; k += kTileThreads) {
      sDepth[k] = __ldg(depth + r0 + k);
#pragma unroll
      for (int a = 0; a < 3; ++a)
        sCentre[3 * k + a] = __ldg(centre + 3 * (int64_t)(r0 + k) + a);
    }
    for (int k = tid; k < (n_el + 1) >> 1; k += kTileThreads)
      reinterpret_cast<double2*>(sSum)[k] = make_double2(0.0, 0.0);
    // the segments' runs a window of kSegWindow at a time, the first
    // window's first runs from the registers
    for (int g0 = 0; g0 < G; g0 += kSegWindow) {
      const int gw = min(kSegWindow, G - g0);
      if (g0 > 0) __syncthreads();       // the last window's shared reads done
#pragma unroll
      for (int u = 0; u < kOffPer; ++u) {
        const int g = tid + u * kTileThreads;
        if (g0 == 0 && g < G) {
          sOff[g] = pa[u];
          sStart[g] = pb[u] - pa[u];
        }
      }
      for (int g = tid + (g0 == 0 ? kOffPer * kTileThreads : 0); g < gw;
           g += kTileThreads) {
        const int* o = offsets + (int64_t)(g0 + g) * (n_tiles + 1) + tile;
        sOff[g] = __ldg(o);
        sStart[g] = __ldg(o + 1) - sOff[g];
      }
      __syncthreads();
      if (g0 == 0 && tile + (int)gridDim.x < n_tiles) fetch(tile + gridDim.x);
      block_scan<kTileThreads>(sStart, gw, sWarp);
      __syncthreads();
      const int total = sStart[gw];
      for (int c0 = 0; c0 < total; c0 += kP) {
        const int np = min(kP, total - c0);
        if (tid < kTileWarps) sCnt[tid] = 0;
        // the chunk's places, a thread a run
        for (int g = tid; g < gw; g += kTileThreads) {
          const int a = max(sStart[g], c0), e = min(sStart[g + 1], c0 + np);
          const int base = (g0 + g) * kSortPoints + sOff[g] - sStart[g];
          for (int q = a; q < e; ++q) sPos[q - c0] = base + q;
        }
        __syncthreads();
        // stage: a thread a point, kH in flight
        for (int p0 = tid; p0 < np; p0 += kH * kTileThreads) {
          int at[kH], i[kH], row[kH];      // places and indices below 2^31
          double x[kH][3], w[kH];
#pragma unroll
          for (int h = 0; h < kH; ++h)
            at[h] = sPos[min(p0 + h * kTileThreads, np - 1)];
#pragma unroll
          for (int h = 0; h < kH; ++h) {
            const int2 it = __ldg(items + at[h]);
            i[h] = it.x;
            row[h] = it.y;
          }
#pragma unroll
          for (int h = 0; h < kH; ++h) {
#pragma unroll
            for (int a = 0; a < 3; ++a)
              x[h][a] = __ldg(in.pts + 3 * (int64_t)i[h] + a);
            w[h] = __ldg(in.cot + i[h]);
          }
#pragma unroll
          for (int h = 0; h < kH; ++h) {
            const int p = p0 + h * kTileThreads;
            if (p >= np) break;
            const int d = sDepth[row[h]];
            const double scale = pow2(d + 1);
            const double nt_half = pow2(d >> 1);
            double N[3][DEG + 1];
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              const double v = (x[h][a] - in.rc[a]) * in.inv[a];
              const double u = v < -0.5 ? -0.5 : (v > 0.5 ? 0.5 : v);
              double L[DEG + 1];
              hpsdf::legendre<DEG>((u - sCentre[3 * row[h] + a]) * scale, L);
#pragma unroll
              for (int q = 0; q <= DEG; ++q)
                N[a][q] = L[q] * (odd_root(q, d & 1) * nt_half);
            }
            double* v = sV + p * kC;
            const double wp = w[h];
            hpsdf::for_each_term_of<DEG>([&](int m, int ix, int iy, int iz) {
              v[m] = wp * (N[0][ix] * N[1][iy] * N[2][iz]);
            });
            const int owner = row[h] / per_warp;
            sList[owner * kP + atomicAdd(sCnt + owner, 1)] = p | row[h] << 16;
          }
        }
        __syncthreads();
        // each warp adds its rows' points one after another, a lane a term
        // (m = lane, lane + 32, ...); the next point's product is loaded
        // before the sum is written
        const int mine = sCnt[wid];
        const int* list = sList + wid * kP;
        for (int m = lane; m < ((kC + 31) & ~31); m += 32) {
          const int mm = m < kC ? m : 0;
          int e = mine > 0 ? list[0] : 0;
          double v = sV[(e & 0xffff) * kC + mm];
          for (int s = 0; s < mine; ++s) {
            const int en = s + 1 < mine ? list[s + 1] : e;
            const double vn = sV[(en & 0xffff) * kC + mm];
            if (m < kC) sSum[(e >> 16) * kC + m] += v;
            v = vn;
            e = en;
          }
        }
        __syncthreads();
      }
    }
    __syncthreads();
    for (int k = tid; k < n_el >> 1; k += kTileThreads)
      __stcs(out2 + k, reinterpret_cast<const double2*>(sSum)[k]);
    if ((n_el & 1) && tid == 0) __stcs(out + n_el - 1, sSum[n_el - 1]);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
  }
  return sms;
}

NodeIn node_in(int lo, int hi, int tile_rows, const double* pts,
               const int32_t* leaf, int64_t B, double rc0, double rc1,
               double rc2, double inv0, double inv1, double inv2,
               const double* cot, int outside_zero) {
  return NodeIn{pts, leaf, cot, B, lo, hi - lo, tile_rows, outside_zero,
                {rc0, rc1, rc2}, {inv0, inv1, inv2}};
}

int n_tiles_of(int rows, int tile_rows) {
  return (rows + tile_rows - 1) / tile_rows;
}

int sort_blocks(int64_t B) {
  return (int)((B + kSortPoints - 1) / kSortPoints);
}

// The tiles' launch: as many blocks as the card holds at once, up to a
// tile each.
template <int DEG>
int launch_tiles(const double* centre, const int32_t* depth,
                 const NodeIn& in, const int32_t* offsets,
                 const int32_t* items, double* d_coeffs, cudaStream_t s) {
  using S = NodeTile<DEG>;
  if (in.tile_rows > S::kRows || (in.tile_rows * S::kC) % 2 != 0)
    return (int)cudaErrorInvalidValue;
  const int G = sort_blocks(in.B);
  const int smem = S::kSmem + 8 * (min(G, kSegWindow) + 1);
  cudaError_t e = cudaFuncSetAttribute(
      coeff_scatter_nodes_kernel<DEG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, coeff_scatter_nodes_kernel<DEG>, kTileThreads, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = n_tiles_of(in.rows, in.tile_rows);
  const int grid = min(n_tiles, max(1, per_sm) * max(1, sm_count()));
  coeff_scatter_nodes_kernel<DEG><<<grid, kTileThreads, (int)smem, s>>>(
      centre, depth, in, G, n_tiles, offsets,
      reinterpret_cast<const int2*>(items), d_coeffs);
  return (int)cudaGetLastError();
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

// K8g: d_coeffs (N, C) f64 += the VJP of query_with_gradient at the points
// (B, 3) with cotangents wv (B,) for the values and wn (B, 3) for the unit
// gradients; d_coeffs must be zeroed by the caller. One launch.
extern "C" int hpsdf_coeff_scatter_grad(const int32_t* child_idx,
                                        const double* centre,
                                        const int32_t* depth,
                                        const double* coeffs, int deg,
                                        int depth_used, const double* pts,
                                        int64_t B, double rc0, double rc1,
                                        double rc2, double inv0, double inv1,
                                        double inv2, const double* wv,
                                        const double* wn, double* d_coeffs,
                                        void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + kGradThreads - 1) / kGradThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define HPSDF_LAUNCH(D)                                                      \
  coeff_scatter_grad_kernel<D><<<blocks, kGradThreads, 0, s>>>(              \
      child_idx, centre, depth, coeffs, depth_used, pts, B, rc0, rc1, rc2,   \
      inv0, inv1, inv2, wv, wn, d_coeffs)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
  return (int)cudaGetLastError();
}

// The node-range mode's points a sort block takes: the offsets hold
// ceil(B / that) rows of n_tiles + 1 ints.
extern "C" int64_t hpsdf_node_sort_points() { return kSortPoints; }

// The most rows a tile of the node-range mode takes at degree deg, or -1
// for another degree.
extern "C" int64_t hpsdf_node_tile_rows(int deg) {
  if (deg < 0 || deg > 12) return -1;
#define HPSDF_ROWS(D) return NodeTile<D>::kRows
  HPSDF_DISPATCH_DEG(deg, HPSDF_ROWS)
#undef HPSDF_ROWS
  return -1;
}

// The node-range mode's sort: the live points of the rows [lo, hi) (their
// leaves (B,) and cotangents (B,); outside_zero: only those of the points
// (B, 3) inside the root) put by segment of hpsdf_node_sort_points points
// and tile of tile_rows rows into items (B, 2) i32 (point index, row
// within the tile), segment g's tile t at places [offsets[g, t],
// offsets[g, t + 1]) from the segment's start; offsets G x (n_tiles + 1)
// i32. One launch (none for B = 0).
extern "C" int hpsdf_node_buckets(int lo, int hi, int tile_rows,
                                  const double* pts, const int32_t* leaf,
                                  int64_t B, double rc0, double rc1,
                                  double rc2, double inv0, double inv1,
                                  double inv2, const double* cot,
                                  int outside_zero, int32_t* offsets,
                                  int32_t* items, void* stream) {
  if (hi <= lo || tile_rows < 1 || B < 0 || B >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)items % 8 != 0) return (int)cudaErrorMisalignedAddress;
  if (B == 0) return (int)cudaSuccess;
  const int n_tiles = n_tiles_of(hi - lo, tile_rows);
  const int smem = 8 * kSortPoints + 4 * (min(n_tiles, kSortBins) + 1);
  cudaError_t e = cudaFuncSetAttribute(
      node_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  node_sort_kernel<<<sort_blocks(B), kSortThreads, smem,
                     (cudaStream_t)stream>>>(
      node_in(lo, hi, tile_rows, pts, leaf, B, rc0, rc1, rc2, inv0, inv1,
              inv2, cot, outside_zero),
      n_tiles, offsets, reinterpret_cast<int2*>(items));
  return (int)cudaGetLastError();
}

// The node-range mode's sums: d_coeffs (hi - lo, C) f64 of the rows
// [lo, hi), every element written, from the points (B, 3), cotangents (B,)
// and what hpsdf_node_buckets left in offsets and items (same lo, hi,
// tile_rows, B). tile_rows at most hpsdf_node_tile_rows(deg), tile_rows *
// C even; d_coeffs 16-byte aligned. One launch.
extern "C" int hpsdf_coeff_scatter_nodes(const double* centre,
                                         const int32_t* depth, int deg,
                                         int lo, int hi, int tile_rows,
                                         const double* pts, const double* cot,
                                         int64_t B, double rc0, double rc1,
                                         double rc2, double inv0,
                                         double inv1, double inv2,
                                         const int32_t* offsets,
                                         const int32_t* items,
                                         double* d_coeffs, void* stream) {
  if (hi <= lo || tile_rows < 1 || B < 0 || B >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)d_coeffs % 16 != 0 || (uintptr_t)items % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  const NodeIn in = node_in(lo, hi, tile_rows, pts, nullptr, B, rc0, rc1,
                            rc2, inv0, inv1, inv2, cot, 0);
  cudaStream_t s = (cudaStream_t)stream;
#define HPSDF_LAUNCH(D) \
  return launch_tiles<D>(centre, depth, in, offsets, items, d_coeffs, s)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
  return (int)cudaErrorInvalidValue;
}
