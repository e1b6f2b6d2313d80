// K1: octree query -- descent plus Legendre evaluation, optionally with the
// analytic gradient, one thread per point, in f64.
//
// Replaces what XLA fused for hpsdf_tpu/query.py query / query_with_gradient:
// descend (query.py:39-58), _leaf_eval (:61-66) and basis.eval_basis /
// eval_basis_grad (basis.py:101-177); the plain torch versions are
// hpsdf_tpu_torch/query.py and basis.py. Per point the thread runs:
//   * world -> unit cube, the inside test |u| <= 0.5 and the clamp of u to
//     [-0.5, 0.5], as query.py:78-81;
//   * depth_used rounds of cur = child_idx[cur] + (x>=cx) + 2(y>=cy) + 4(z>=cz),
//     stopping at a leaf (the plain version carries the leaf unchanged);
//   * the local frame (u - centre) * 2^(depth+1);
//   * the three-term Legendre recurrence per axis up to the degree, a
//     template parameter, and with the gradient (ORDER 1) the derivative
//     recurrence L'_p = L'_{p-2} + (2p-1) L_{p-1};
//   * sum_m c_m * Lx[i_m] * Ly[j_m] * Lz[k_m] * coeff_norms[depth, m] over
//     the basis_indices triples, with the norm folded into the axes:
//     coeff_norms[d, m] = nt[i_m] nt[j_m] nt[k_m], nt[p] = sqrt((2p+1) 2^d),
//     each nt[p] equal bit for bit to basis.norm_table's;
//   * the f64-max sentinel outside the root AABB and, with the gradient, the
//     world-space chain rule and normalisation (query.py:103-109).
//
// Bound. The tree's arrays stay in the 50 MB L2 and the f64 arithmetic is
// about 3*C operations a point (11*C more with the gradient), below both
// the f64 peak and device memory: the loads bound the kernel. At scattered
// points a warp's 32 lanes read 32 nodes, so each load instruction costs up
// to 32 L1 wavefronts, and the bytes of a leaf's row come from L2 once a
// point. The design cuts the load instructions a point issues: the degree
// is a template parameter, so the recurrences and the (i, j, k) triples are
// registers and constants, with no index or norm loads; a centre is one
// 16-byte and one 8-byte load; and a warp that reads more than kStageMin
// rows stages them into shared memory with 8-byte cp.async copies,
// neighbouring lanes on neighbouring coefficients, each thread reading its
// row back from a slot whose stride is an odd number of doubles (no bank
// conflicts). Rows wider than 32 coefficients are staged 32 at a time and
// the sum is split there. The L1 the tile leaves matters, so the launch
// prefers kCarveout percent of shared memory. What is left is the descent:
// depth_used dependent rounds of a child load and a centre (three scattered
// loads a round), which keep their f64 decisions u >= centre, since a grid
// lookup rounds differently at the faces.
//
// The backward modes K1v and K1h (query_kernel with a cotangent, ORDER 1
// and 2) are the VJPs of query and query_with_gradient with respect to the
// points; they are described above the kernel below.
//
// The node-range mode (descend_nodes_kernel, leaf_nodes_kernel) serves the
// node axis of hpsdf_tpu_torch/parallel.py, where a rank holds a contiguous
// range of the node rows and XLA's counterpart is the descent's gathers on
// node-sharded arrays (hpsdf_tpu/parallel.py:89-97): one launch a descent
// round and one for the leaf, each answering only the points whose node lies
// in the rank's range, the ranks' answers summed between launches. The leaf
// launch evaluates through query_kernel's own code (eval_leaf).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "packed_rows.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;        // coefficients staged per round
constexpr int kMaxDeg = 12;       // BASIS_MAX_DEGREE
// A warp stages its rows when it reads more than kStageMin distinct ones;
// with fewer (points in runs, as a slice's raster gives) each lane reads
// its own row, and the loads are mostly broadcasts.
constexpr int kStageMin = 8;
// Percent of the SM's shared memory preferred over L1: 75 keeps the blocks
// the tile allows and leaves more L1 to the descent's nodes than the
// default (PERF.md).
constexpr int kCarveout = 75;
constexpr unsigned kFullMask = 0xffffffffu;

// --- warp-cooperative row staging -----------------------------------------
//
// Lanes that read the same row as the lane before them share its slot, so a
// run of them copies the row once and reads it by broadcast.

struct WarpSlots {
  int slot;   // this lane's slot: the rank of its run among the warp's runs
  int n;      // slots in use
};

// Assigns the warp's slots and writes each slot's row to slot_row[slot].
// Every lane of the warp must call it.
__device__ __forceinline__ WarpSlots warp_slots(const double* row,
                                                const double** slot_row) {
  const int lane = threadIdx.x & 31;
  const unsigned long long key = reinterpret_cast<unsigned long long>(row);
  const unsigned long long prev = __shfl_up_sync(kFullMask, key, 1);
  const bool lead = lane == 0 || prev != key;
  const unsigned leaders = __ballot_sync(kFullMask, lead);
  WarpSlots s;
  s.slot = __popc(leaders & (kFullMask >> (31 - lane))) - 1;
  s.n = __popc(leaders);
  if (lead) slot_row[s.slot] = row;
  __syncwarp();
  return s;
}

// Starts copying coefficients [e0, e0 + ne) of each slot's row into
// tile[slot * STRIDE + e - e0], one 8-byte cp.async a coefficient,
// neighbouring lanes on neighbouring coefficients; stage_wait() ends it.
template <int STRIDE>
__device__ __forceinline__ void stage_rows(double* tile,
                                           const double* const* slot_row,
                                           int n_slots, int e0, int ne) {
  for (int k = threadIdx.x & 31; k < n_slots * ne; k += 32) {
    const int s = k / ne, e = k - s * ne;
    const unsigned dst =
        (unsigned)__cvta_generic_to_shared(tile + s * STRIDE + e);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(slot_row[s] + e0 + e));
  }
}

// Waits for this lane's copies, then for the warp's.
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// --- the query ----------------------------------------------------------

template <int DEG>
struct Shape {
  static constexpr int kC = (DEG + 1) * (DEG + 2) * (DEG + 3) / 6;
  static constexpr int kChunks = (kC + kChunk - 1) / kChunk;
  static constexpr int kTile = kC < kChunk ? kC : kChunk;
  // odd: the 16 lanes of an 8-byte read phase hit 16 different bank pairs
  static constexpr int kStride = kTile | 1;
};

// Node n's centre: its 24-byte record as one 16-byte and one 8-byte load,
// whichever half is 16-byte aligned (the array's base is).
__device__ __forceinline__ void load_centre(const double* __restrict__ centre,
                                            int n, double c[3]) {
  const double* p = centre + 3 * (int64_t)n;
  const bool even = (n & 1) == 0;
  const double2 v =
      __ldg(reinterpret_cast<const double2*>(p + (even ? 0 : 1)));
  const double s = __ldg(p + (even ? 2 : 0));
  c[0] = even ? v.x : s;
  c[1] = even ? v.y : v.x;
  c[2] = even ? s : v.y;
}

// nt[p] = sqrt((2p+1) 2^d) for p = 0..DEG, bit for bit the host table's:
// sqrt(x 4^k) = sqrt(x) 2^k exactly, so for d = 2k it is sqrt(2p+1) 2^k and
// for d = 2k+1 sqrt(4p+2) 2^k.
template <int DEG>
__device__ __forceinline__ void axis_norms(int d, double (&nt)[DEG + 1]) {
  const double kEven[kMaxDeg + 1] = {
      1.0, 1.7320508075688772, 2.23606797749979, 2.6457513110645907, 3.0,
      3.3166247903554, 3.605551275463989, 3.872983346207417,
      4.123105625617661, 4.358898943540674, 4.58257569495584,
      4.795831523312719, 5.0};
  const double kOdd[kMaxDeg + 1] = {
      1.4142135623730951, 2.449489742783178, 3.1622776601683795,
      3.7416573867739413, 4.242640687119285, 4.69041575982343,
      5.0990195135927845, 5.477225575051661, 5.830951894845301,
      6.164414002968976, 6.48074069840786, 6.782329983125268,
      7.0710678118654755};
  const double two_k = __longlong_as_double((long long)(1023 + (d >> 1)) << 52);
#pragma unroll
  for (int p = 0; p <= DEG; ++p)
    nt[p] = ((d & 1) ? kOdd[p] : kEven[p]) * two_k;
}

// A point's axis factors and sums: ORDER 0 the value, 1 also the gradient,
// 2 also the Hessian h (xx, yy, zz, xy, xz, yz), all in the leaf's frame.
template <int DEG, int ORDER>
struct Leaf {
  double N[3][DEG + 1];                         // L_p(x_a) * nt[p]
  double dN[3][ORDER >= 1 ? DEG + 1 : 1];       // L'_p(x_a) * nt[p]
  double d2N[3][ORDER >= 2 ? DEG + 1 : 1];      // L''_p(x_a) * nt[p]
  double v, g[3], h[6];
};

// Adds the terms m in [lo, hi) to lf, coef(m) their coefficients.
template <int DEG, int ORDER, class Coef>
__device__ __forceinline__ void add_terms(Coef coef, int lo, int hi,
                                          Leaf<DEG, ORDER>& lf) {
  auto term = [&](int m, int i, int j, int k) {
    if (m < lo || m >= hi) return;
    const double cm = coef(m);
    const double(&N)[3][DEG + 1] = lf.N;
    const double xy = N[0][i] * N[1][j];
    lf.v += cm * (xy * N[2][k]);
    if constexpr (ORDER >= 1) {
      const auto& dN = lf.dN;
      lf.g[0] += cm * (dN[0][i] * N[1][j] * N[2][k]);
      lf.g[1] += cm * (N[0][i] * dN[1][j] * N[2][k]);
      lf.g[2] += cm * (xy * dN[2][k]);
      if constexpr (ORDER >= 2) {
        const auto& d2N = lf.d2N;
        lf.h[0] += cm * (d2N[0][i] * N[1][j] * N[2][k]);
        lf.h[1] += cm * (N[0][i] * d2N[1][j] * N[2][k]);
        lf.h[2] += cm * (xy * d2N[2][k]);
        lf.h[3] += cm * (dN[0][i] * dN[1][j] * N[2][k]);
        lf.h[4] += cm * (dN[0][i] * N[1][j] * dN[2][k]);
        lf.h[5] += cm * (N[0][i] * dN[1][j] * dN[2][k]);
      }
    }
  };
  // K1h's nine sums take the terms by (i, j): in for_each_term's order
  // their six kinds of pair product stay live across the row, which spilled
  // 48 bytes at degree 5 (PERF.md)
  if constexpr (ORDER >= 2 && DEG <= hpsdf::kUnrolledDeg)
    hpsdf::for_each_term_by_pair<DEG>(term);
  else if constexpr (ORDER >= 2)
    hpsdf::for_each_term_of<DEG>(term);
  else
    hpsdf::for_each_term<DEG>(term);
}

// The product sum over the row (one per lane; with `staged`, the warp's
// rows staged in the tile, chunk 0's copy started by the caller), kChunk
// coefficients at a time: unrolled up to two chunks, which the degrees up
// to 5 take, in a loop above.
template <int DEG, int ORDER>
__device__ __forceinline__ void sum_row(double* tile,
                                        const double* const* slot_row,
                                        WarpSlots ws, bool staged,
                                        const double* row,
                                        Leaf<DEG, ORDER>& lf) {
  using S = Shape<DEG>;
  if constexpr (S::kChunks <= 2) {
    if (staged) {
#pragma unroll
      for (int ch = 0; ch < S::kChunks; ++ch) {
        const int m0 = ch * kChunk;
        if (ch > 0) {
          __syncwarp();                       // the warp is done with ch - 1
          stage_rows<S::kStride>(tile, slot_row, ws.n, m0, S::kC - m0);
        }
        stage_wait();
        const double* cs = tile + ws.slot * S::kStride - m0;
        add_terms([&](int m) { return cs[m]; }, m0, min(m0 + kChunk, S::kC),
                  lf);
      }
    } else {
      add_terms([&](int m) { return __ldg(row + m); }, 0, S::kC, lf);
    }
  } else {
#pragma unroll 1
    for (int ch = 0; ch < S::kChunks; ++ch) {
      const int m0 = ch * kChunk;
      const double* cs = row;                 // cs[m]: term m's coefficient
      if (staged) {
        if (ch > 0) {
          __syncwarp();
          stage_rows<S::kStride>(tile, slot_row, ws.n, m0,
                                 min(kChunk, S::kC - m0));
        }
        stage_wait();
        cs = tile + ws.slot * S::kStride - m0;
      }
      add_terms([&](int m) { return cs[m]; }, m0, m0 + kChunk, lf);
    }
  }
}

// Adds leaf n's basis at the clamped unit-cube point u into lf: its row
// staged with the warp's when the warp reads more than kStageMin distinct
// rows, the leaf frame and the recurrences while the rows arrive. Every lane
// of the warp must call it. Returns the frame's scale 2^(depth+1).
template <int DEG, int ORDER>
__device__ __forceinline__ double eval_leaf(
    double* tile, const double** slot_row, const double* __restrict__ centre,
    const int32_t* __restrict__ depth, const double* __restrict__ coeffs,
    int n, const double (&u)[3], Leaf<DEG, ORDER>& lf) {
  using S = Shape<DEG>;
  const double* row = coeffs + (int64_t)n * S::kC;
  const WarpSlots ws = warp_slots(row, slot_row);
  const bool staged = ws.n > kStageMin;
  if (staged) stage_rows<S::kStride>(tile, slot_row, ws.n, 0, S::kTile);
  const int d = __ldg(depth + n);
  double cc[3];
  load_centre(centre, n, cc);
  const double scale = ldexp(1.0, d + 1);
  double nt[DEG + 1];
  axis_norms<DEG>(d, nt);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    double L[DEG + 1];
    hpsdf::legendre<DEG>((u[a] - cc[a]) * scale, L);
#pragma unroll
    for (int p = 0; p <= DEG; ++p) lf.N[a][p] = L[p] * nt[p];
    if constexpr (ORDER >= 1) {
      double dL[DEG + 1];
      hpsdf::legendre_deriv<DEG>(L, dL);
#pragma unroll
      for (int p = 0; p <= DEG; ++p) lf.dN[a][p] = dL[p] * nt[p];
      if constexpr (ORDER >= 2) {
        double d2L[DEG + 1];
        hpsdf::legendre_deriv2<DEG>(dL, d2L);
#pragma unroll
        for (int p = 0; p <= DEG; ++p) lf.d2N[a][p] = d2L[p] * nt[p];
      }
    }
  }
  sum_row<DEG, ORDER>(tile, slot_row, ws, staged, row, lf);
  return scale;
}

// The query (ORDER 0: values; 1: values and unit gradients, or K1v) and
// its backward modes K1v and K1h, the VJPs of query and
// query_with_gradient with respect to the points
// (query_points_vjp_plain, query_with_gradient_vjp_plain). A backward
// mode (w given, or ORDER 2) re-descends and re-evaluates the point's
// leaf to one order above its forward and writes the point's three
// cotangents. With s_a = 2^(depth+1) / size_a, c_a the clamp's slope (1
// inside, 1/2 on a face, 0 clamped, as jnp.clip's) and w' the value's
// cotangent, zero outside the root under the f64-max sentinel:
//   * K1v (ORDER 1, w): d_p_a = c_a w' g_a s_a, g the leaf-frame gradient;
//   * K1h (ORDER 2, w and wn, the unit gradient's cotangent): with G = g s
//     the world gradient and gb = unit_vector_vjp(G, wn, 1e-30),
//     d_p_b = c_b s_b (w' g_b + sum_a H_ab s_a gb_a), H the leaf-frame
//     Hessian (the second derivative recurrence). Its nine sums take
//     the terms grouped by (i, j) (for_each_term_by_pair) up to degree 6,
//     in a loop above it (for_each_term_of).
template <int DEG, int ORDER>
__global__ void __launch_bounds__(kThreads)
query_kernel(const int32_t* __restrict__ child_idx,
             const double* __restrict__ centre,
             const int32_t* __restrict__ depth,
             const double* __restrict__ coeffs, int depth_used,
             const double* __restrict__ pts, int64_t B,
             double rc0, double rc1, double rc2,
             double inv0, double inv1, double inv2, int outside_max,
             double* __restrict__ val, double* __restrict__ grad,
             const double* __restrict__ w, const double* __restrict__ wn,
             double* __restrict__ d_pts) {
  using S = Shape<DEG>;
  __shared__ double tiles[kWarps][32 * S::kStride];
  __shared__ const double* slot_rows[kWarps][32];
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t ip = i < B ? i : B - 1;     // spare lanes repeat the last point
  const double rc[3] = {rc0, rc1, rc2};
  const double inv[3] = {inv0, inv1, inv2};
  double u[3], slope[3];
  bool inside = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const double x = (pts[3 * ip + a] - rc[a]) * inv[a];
    inside = inside && fabs(x) <= 0.5;
    slope[a] = hpsdf::clamp_half_slope(x);
    u[a] = x < -0.5 ? -0.5 : (x > 0.5 ? 0.5 : x);
  }

  int cur = 0;
  for (int r = 0; r < depth_used; ++r) {
    const int c0 = __ldg(child_idx + cur);
    if (c0 < 0) break;
    double cc[3];
    load_centre(centre, cur, cc);
    cur = c0 + (u[0] >= cc[0]) + ((u[1] >= cc[1]) << 1) +
          ((u[2] >= cc[2]) << 2);
  }

  const int warp = threadIdx.x >> 5;
  Leaf<DEG, ORDER> lf{};
  const double scale = eval_leaf<DEG, ORDER>(
      tiles[warp], slot_rows[warp], centre, depth, coeffs, cur, u, lf);
  if (i >= B) return;

  // local = (unit - centre) * 2^(depth+1), unit = (world - c) / sizes
  const double s[3] = {scale * inv0, scale * inv1, scale * inv2};
  if (ORDER == 2 || (ORDER == 1 && w != nullptr)) {
    const double wv = (outside_max && !inside) ? 0.0 : __ldg(w + i);
    double dl[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) dl[a] = wv * lf.g[a];
    if constexpr (ORDER == 2) {
      const double G[3] = {lf.g[0] * s[0], lf.g[1] * s[1], lf.g[2] * s[2]};
      const double wnv[3] = {__ldg(wn + 3 * i), __ldg(wn + 3 * i + 1),
                             __ldg(wn + 3 * i + 2)};
      double gb[3], q[3], hq[3];
      hpsdf::unit_vector_vjp(G, wnv, 1e-30, gb);
#pragma unroll
      for (int a = 0; a < 3; ++a) q[a] = gb[a] * s[a];
      hpsdf::hessian_times(lf.h, q, hq);
#pragma unroll
      for (int a = 0; a < 3; ++a) dl[a] += hq[a];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) d_pts[3 * i + a] = slope[a] * (dl[a] * s[a]);
    return;
  }
  val[i] = (outside_max && !inside) ? DBL_MAX : lf.v;
  if constexpr (ORDER == 1) {
    const double g0 = lf.g[0] * scale * inv0;
    const double g1 = lf.g[1] * scale * inv1;
    const double g2 = lf.g[2] * scale * inv2;
    const double nrm = sqrt(g0 * g0 + g1 * g1 + g2 * g2);
    const double den = nrm > 1e-30 ? nrm : 1e-30;
    grad[3 * i] = g0 / den;
    grad[3 * i + 1] = g1 / den;
    grad[3 * i + 2] = g2 / den;
  }
}

// --- the node-range mode (the node axis, hpsdf_tpu_torch/parallel.py) ------
//
// A rank holds the rows [lo, hi) of the node arrays, row n of its arrays
// being node lo + n, and a query is depth_used descent rounds and one leaf
// evaluation, each summed over the node axis's ranks between launches. In
// both launches a rank answers the points whose node lies in its range and
// writes 0 for every other point: exactly one rank answers each point, so
// the sum is the answer, exactly.

// One descent round: cur's next node, cur itself on a leaf, from the f64
// decisions of query_kernel's descent (u >= centre).
__global__ void __launch_bounds__(kThreads)
descend_nodes_kernel(const int32_t* __restrict__ child_idx,
                     const double* __restrict__ centre, int lo, int hi,
                     const double* __restrict__ unit,
                     const int32_t* __restrict__ cur, int64_t B,
                     int32_t* __restrict__ next) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  const int c = __ldg(cur + i);
  int out = 0;
  if (c >= lo && c < hi) {
    const int c0 = __ldg(child_idx + (c - lo));
    out = c;
    if (c0 >= 0) {
      double cc[3];
      load_centre(centre, c - lo, cc);
      const double* u = unit + 3 * i;
      out = c0 + (__ldg(u) >= cc[0]) + ((__ldg(u + 1) >= cc[1]) << 1) +
            ((__ldg(u + 2) >= cc[2]) << 2);
    }
  }
  next[i] = out;
}

// The leaf evaluation: query_kernel's (eval_leaf) at the leaves in range. A
// point another rank answers reads row 0 with the warp and writes 0; a rank
// with no rows writes 0 everywhere.
template <int DEG>
__global__ void __launch_bounds__(kThreads)
leaf_nodes_kernel(const double* __restrict__ centre,
                  const int32_t* __restrict__ depth,
                  const double* __restrict__ coeffs, int lo, int hi,
                  const double* __restrict__ unit,
                  const int32_t* __restrict__ leaf, int64_t B,
                  double* __restrict__ val) {
  using S = Shape<DEG>;
  __shared__ double tiles[kWarps][32 * S::kStride];
  __shared__ const double* slot_rows[kWarps][32];
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (hi <= lo) {
    if (i < B) val[i] = 0.0;
    return;
  }
  const int64_t ip = i < B ? i : B - 1;     // spare lanes repeat the last point
  const int c = __ldg(leaf + ip);
  const bool own = c >= lo && c < hi;
  double u[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) u[a] = __ldg(unit + 3 * ip + a);
  const int warp = threadIdx.x >> 5;
  Leaf<DEG, 0> lf{};
  eval_leaf<DEG, 0>(tiles[warp], slot_rows[warp], centre, depth, coeffs,
                    own ? c - lo : 0, u, lf);
  if (i < B) val[i] = own ? lf.v : 0.0;
}

// query_kernel<DEG, ORDER>, the launch preferring kCarveout percent of
// shared memory.
template <int DEG, int ORDER, class... Args>
void launch_query(unsigned blocks, cudaStream_t s, Args... args) {
  cudaFuncSetAttribute(query_kernel<DEG, ORDER>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       kCarveout);
  query_kernel<DEG, ORDER><<<blocks, kThreads, 0, s>>>(args...);
}

}  // namespace

// grad == nullptr selects the value-only instantiation.
extern "C" int hpsdf_query(const int32_t* child_idx, const double* centre,
                           const int32_t* depth, const double* coeffs,
                           int deg, int depth_used, const double* pts,
                           int64_t B, double rc0, double rc1, double rc2,
                           double inv0, double inv1, double inv2,
                           int outside_max, double* val, double* grad,
                           void* stream) {
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define HPSDF_ARGS                                                          \
  child_idx, centre, depth, coeffs, depth_used, pts, B, rc0, rc1, rc2, inv0, \
      inv1, inv2, outside_max, val, grad, nullptr, nullptr, nullptr
#define HPSDF_LAUNCH(D)                                                      \
  if (grad != nullptr)                                                       \
    launch_query<D, 1>(blocks, s, HPSDF_ARGS);                               \
  else                                                                       \
    launch_query<D, 0>(blocks, s, HPSDF_ARGS)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
#undef HPSDF_ARGS
  return (int)cudaGetLastError();
}

// K1's backward modes: d_pts (B, 3), the VJP of query with respect to the
// points with cotangents w (B,) (K1v, wn == nullptr; nothing from points
// outside the root with outside_max), or of query_with_gradient with
// cotangents w (B,) for the values and wn (B, 3) for the unit gradients
// (K1h; pass outside_max = 1, as that query returns the sentinel).
extern "C" int hpsdf_query_vjp(const int32_t* child_idx, const double* centre,
                               const int32_t* depth, const double* coeffs,
                               int deg, int depth_used, const double* pts,
                               int64_t B, double rc0, double rc1, double rc2,
                               double inv0, double inv1, double inv2,
                               int outside_max, const double* w,
                               const double* wn, double* d_pts,
                               void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define HPSDF_ARGS                                                          \
  child_idx, centre, depth, coeffs, depth_used, pts, B, rc0, rc1, rc2, inv0, \
      inv1, inv2, outside_max, nullptr, nullptr, w, wn, d_pts
#define HPSDF_LAUNCH(D)                                                      \
  if (wn != nullptr)                                                         \
    launch_query<D, 2>(blocks, s, HPSDF_ARGS);                               \
  else                                                                       \
    launch_query<D, 1>(blocks, s, HPSDF_ARGS)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
#undef HPSDF_ARGS
  return (int)cudaGetLastError();
}

// K1's node-range mode, one descent round: next (B,) from cur (B,), the
// rank's child_idx and centre rows [lo, hi) and the clamped unit-cube points.
extern "C" int hpsdf_descend_nodes(const int32_t* child_idx,
                                   const double* centre, int lo, int hi,
                                   const double* unit, const int32_t* cur,
                                   int64_t B, int32_t* next, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  descend_nodes_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      child_idx, centre, lo, hi, unit, cur, B, next);
  return (int)cudaGetLastError();
}

// K1's node-range mode, the leaf evaluation: val (B,) at the leaves (B,) in
// [lo, hi), 0 elsewhere.
extern "C" int hpsdf_leaf_nodes(const double* centre, const int32_t* depth,
                                const double* coeffs, int deg, int lo, int hi,
                                const double* unit, const int32_t* leaf,
                                int64_t B, double* val, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define HPSDF_LAUNCH(D)                                                      \
  cudaFuncSetAttribute(leaf_nodes_kernel<D>,                                 \
                       cudaFuncAttributePreferredSharedMemoryCarveout,       \
                       kCarveout);                                           \
  leaf_nodes_kernel<D><<<blocks, kThreads, 0, s>>>(                        \
      centre, depth, coeffs, lo, hi, unit, leaf, B, val)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
  return (int)cudaGetLastError();
}
