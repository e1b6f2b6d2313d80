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
// The backward modes K1v and K1h (query_vjp_kernel) are the VJPs of query
// and query_with_gradient with respect to the points, and K1c (its CENTRE
// mode) with respect to the nodes' centres. They start from the leaf the
// forward wrote (query_kernel with LEAF) and run no descent; they are
// described above their kernel below. The leaf evaluation is
// query_leaf.cuh's, shared with the kernel K1v and K1h replaced.
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

#include "query_leaf.cuh"
#include "scatter.cuh"

namespace {

// The query: values (ORDER 0) or values and unit gradients (ORDER 1), and
// with LEAF each point's leaf, the node its descent ends at (one 4-byte
// store a point), which the backward modes start from.
template <int DEG, int ORDER, bool LEAF>
__global__ void __launch_bounds__(kThreads)
query_kernel(const int32_t* __restrict__ child_idx,
             const double* __restrict__ centre,
             const int32_t* __restrict__ depth,
             const double* __restrict__ coeffs, int depth_used,
             const double* __restrict__ pts, int64_t B,
             double rc0, double rc1, double rc2,
             double inv0, double inv1, double inv2, int outside_max,
             double* __restrict__ val, double* __restrict__ grad,
             int32_t* __restrict__ leaf) {
  using S = Shape<DEG>;
  __shared__ double tiles[kWarps][32 * S::kStride];
  __shared__ const double* slot_rows[kWarps][32];
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t ip = i < B ? i : B - 1;     // spare lanes repeat the last point
  const double rc[3] = {rc0, rc1, rc2};
  const double inv[3] = {inv0, inv1, inv2};
  double u[3];
  bool inside = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const double x = (pts[3 * ip + a] - rc[a]) * inv[a];
    inside = inside && fabs(x) <= 0.5;
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
  if constexpr (LEAF) {
    if (i < B) leaf[i] = cur;
  }

  const int warp = threadIdx.x >> 5;
  Leaf<DEG, ORDER> lf{};
  const double scale = eval_leaf<DEG, ORDER>(
      tiles[warp], slot_rows[warp], centre, depth, coeffs, cur, u, lf);
  if (i >= B) return;
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

// --- the backward modes K1v and K1h ----------------------------------------
//
// The VJPs of query (K1v, ORDER 1) and query_with_gradient (K1h, ORDER 2)
// with respect to the points, in place of XLA's autodiff of
// hpsdf_tpu/query.py:69-85 and :88-108 (plain versions
// query_points_vjp_plain, query_with_gradient_vjp_plain, given the leaf),
// from each point's leaf as the forward wrote it. With s_a = 2^(depth+1)
// / size_a, c_a the clamp's slope (1 inside, 1/2 on a face, 0 clamped, as
// jnp.clip's) and w' the value's cotangent, zero outside the root under
// the f64-max sentinel:
//   * K1v: d_p_a = c_a w' g_a s_a, g the leaf-frame gradient;
//   * K1h (wn the unit gradient's cotangent): with G = g s the world
//     gradient and gb = unit_vector_vjp(G, wn, 1e-30),
//     d_p_b = c_b s_b (w' g_b + sum_a H_ab s_a gb_a), H the leaf-frame
//     Hessian (the second derivative recurrence). Its nine sums take the
//     terms grouped by (i, j) (for_each_term_by_pair) up to degree 6, in a
//     loop above it (for_each_term_of).
// No value sum: the VJP needs none.
//
// Design. The leaf is the only dependent load. The point and, up to degree
// 3, its cotangents are loaded beside it; then the leaf's row (staged with
// the warp's by cp.async), depth and centre are all in flight together
// while the frame's recurrences wait for them. No descent: K1's forward
// already ran it, from the same f64 decisions, so the result is the
// re-descending kernel's bit for bit (csrc/check/query_vjp_reference.cu).
// The launch bounds hold as many blocks an SM as ptxas can give without a
// spill at degrees 3 and 5 (kVjpBlocks): K1v as many as the re-descending
// kernel held, K1h one fewer at degree 3. Two points a thread, more blocks
// an SM with spills, and every cotangent loaded early or late were slower
// or spilled (PERF.md).
//
// K1c (CENTRE) is the VJP of both with respect to tree.centre, in place of
// XLA's autodiff of the leaf frame local = (unit - centre[leaf]) 2^(depth+1)
// (hpsdf_tpu/query.py:61-66; plain version query_centre_vjp_plain). With
// dl the leaf frame's cotangent as K1v (ORDER 1) or K1h (ORDER 2) forms it,
// d_centre[leaf] -= 2^(depth+1) dl, summed over the leaf's points: no clamp
// slope (the centre enters after the clamp, so a point clamped onto a face
// still moves its leaf's centre), no root size, nothing through the descent.
// The lanes of a warp that share a leaf sum their terms by PeerSum
// (scatter.cuh) and the group's leader adds the three sums with f64 atomics
// into the zeroed table, so the order of the sums changes from call to
// call. The same launch writes d_pts where d_pts is given. The arrays may be
// a node block's rows [lo, hi) (the node axis of parallel.py): leaf n is row
// n - lo, and a point whose leaf lies outside the block adds nothing. K1v
// and K1h never read lo and hi.

// Least blocks of kThreads an SM, [CENTRE][ORDER - 1][degree <= 3, <= 5,
// above]: the most ptxas meets at degrees 3 and 5 without a spill
// (PERF.md). K1c holds its leaf row across the sums: at degree 5 it needs
// 222 registers (two blocks), and its ORDER 2 spills 16 B at the 255 a
// thread can have (PERF.md)
constexpr int kVjpBlocks[2][2][3] = {{{5, 3, 1}, {4, 2, 1}},
                                     {{5, 2, 1}, {4, 2, 1}}};

template <int DEG, int ORDER, bool CENTRE>
struct VjpBlocks {
  static constexpr int kMin =
      kVjpBlocks[CENTRE][ORDER - 1][DEG <= 3 ? 0 : (DEG <= 5 ? 1 : 2)];
};

template <int DEG, int ORDER, bool CENTRE>
__global__ void __launch_bounds__(kThreads,
                                  VjpBlocks<DEG, ORDER, CENTRE>::kMin)
query_vjp_kernel(const double* __restrict__ centre,
                 const int32_t* __restrict__ depth,
                 const double* __restrict__ coeffs,
                 const double* __restrict__ pts,
                 const int32_t* __restrict__ leaf, int64_t B, int lo, int hi,
                 double rc0, double rc1, double rc2,
                 double inv0, double inv1, double inv2, int outside_max,
                 const double* __restrict__ w, const double* __restrict__ wn,
                 double* __restrict__ d_pts, double* __restrict__ d_centre) {
  using S = Shape<DEG>;
  // Above degree 3 the cotangents wait for the sums: held across them
  // they cost the registers that spilled at degree 5.
  constexpr bool kEarly = DEG <= 3;
  __shared__ double tiles[kWarps][32 * S::kStride];
  __shared__ const double* slot_rows[kWarps][32];
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t ip = i < B ? i : B - 1;     // spare lanes repeat the last point
  int n = __ldg(leaf + ip);
  bool own = true;                          // K1c: the block holds the leaf
  if constexpr (CENTRE) {
    own = n >= lo && n < hi;
    n = own ? n - lo : 0;
  }
  double p[3], wv, wnv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    p[a] = __ldg(pts + 3 * ip + a);
    if constexpr (ORDER == 2 && kEarly) wnv[a] = __ldg(wn + 3 * ip + a);
  }
  if constexpr (kEarly) wv = __ldg(w + ip);
  const double rc[3] = {rc0, rc1, rc2};
  const double inv[3] = {inv0, inv1, inv2};
  double u[3], slope[3];
  bool inside = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const double x = (p[a] - rc[a]) * inv[a];
    inside = inside && fabs(x) <= 0.5;
    slope[a] = hpsdf::clamp_half_slope(x);
    u[a] = x < -0.5 ? -0.5 : (x > 0.5 ? 0.5 : x);
  }

  const int warp = threadIdx.x >> 5;
  Leaf<DEG, ORDER> lf{};
  const double scale = eval_leaf<DEG, ORDER>(
      tiles[warp], slot_rows[warp], centre, depth, coeffs, n, u, lf);
  // K1c's spare lanes stay for the warp's sums, with zero cotangents
  if constexpr (!CENTRE) {
    if (i >= B) return;
  }
  if constexpr (!kEarly) {
    const bool in = !CENTRE || i < B;
    wv = in ? __ldg(w + i) : 0.0;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      if constexpr (ORDER == 2) wnv[a] = in ? __ldg(wn + 3 * i + a) : 0.0;
  }

  // local = (unit - centre) * 2^(depth+1), unit = (world - c) / sizes
  const double s[3] = {scale * inv0, scale * inv1, scale * inv2};
  if (outside_max && !inside) wv = 0.0;
  double dl[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) dl[a] = wv * lf.g[a];
  if constexpr (ORDER == 2) {
    const double G[3] = {lf.g[0] * s[0], lf.g[1] * s[1], lf.g[2] * s[2]};
    double gb[3], q[3], hq[3];
    hpsdf::unit_vector_vjp(G, wnv, 1e-30, gb);
#pragma unroll
    for (int a = 0; a < 3; ++a) q[a] = gb[a] * s[a];
    hpsdf::hessian_times(lf.h, q, hq);
#pragma unroll
    for (int a = 0; a < 3; ++a) dl[a] += hq[a];
  }
  if constexpr (CENTRE) {
    const bool live = own && i < B;
    const hpsdf::PeerSum peers(live ? (unsigned long long)n : ~0ull);
    double c[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) c[a] = peers.sum(live ? -scale * dl[a] : 0.0);
    if (live && peers.leader) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
        atomicAdd(d_centre + 3 * (int64_t)n + a, c[a]);
    }
    if (d_pts == nullptr || i >= B) return;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) d_pts[3 * i + a] = slope[a] * (dl[a] * s[a]);
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

// A kernel's launch, preferring kCarveout percent of shared memory.
template <class Kernel, class... Args>
void launch(Kernel kernel, unsigned blocks, cudaStream_t s, Args... args) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       kCarveout);
  kernel<<<blocks, kThreads, 0, s>>>(args...);
}

}  // namespace

// val (B,), with grad (B, 3) the unit gradients (grad == nullptr: values
// only) and with leaf (B,) each point's leaf (leaf == nullptr: not written).
extern "C" int hpsdf_query(const int32_t* child_idx, const double* centre,
                           const int32_t* depth, const double* coeffs,
                           int deg, int depth_used, const double* pts,
                           int64_t B, double rc0, double rc1, double rc2,
                           double inv0, double inv1, double inv2,
                           int outside_max, double* val, double* grad,
                           int32_t* leaf, void* stream) {
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define HPSDF_ARGS                                                          \
  child_idx, centre, depth, coeffs, depth_used, pts, B, rc0, rc1, rc2, inv0, \
      inv1, inv2, outside_max, val, grad, leaf
#define HPSDF_LAUNCH(D)                                                      \
  if (grad != nullptr && leaf != nullptr)                                    \
    launch(query_kernel<D, 1, true>, blocks, s, HPSDF_ARGS);                 \
  else if (grad != nullptr)                                                  \
    launch(query_kernel<D, 1, false>, blocks, s, HPSDF_ARGS);                \
  else if (leaf != nullptr)                                                  \
    launch(query_kernel<D, 0, true>, blocks, s, HPSDF_ARGS);                 \
  else                                                                       \
    launch(query_kernel<D, 0, false>, blocks, s, HPSDF_ARGS)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
#undef HPSDF_ARGS
  return (int)cudaGetLastError();
}

// K1's backward modes: d_pts (B, 3), the VJP of query with respect to the
// points with cotangents w (B,) (K1v, wn == nullptr; nothing from points
// outside the root with outside_max), or of query_with_gradient with
// cotangents w (B,) for the values and wn (B, 3) for the unit gradients
// (K1h; pass outside_max = 1, as that query returns the sentinel), from
// the leaves (B,) hpsdf_query wrote for the same points.
extern "C" int hpsdf_query_vjp(const double* centre, const int32_t* depth,
                               const double* coeffs, int deg,
                               const double* pts, const int32_t* leaf,
                               int64_t B, double rc0, double rc1, double rc2,
                               double inv0, double inv1, double inv2,
                               int outside_max, const double* w,
                               const double* wn, double* d_pts,
                               void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define HPSDF_ARGS                                                          \
  centre, depth, coeffs, pts, leaf, B, 0, 0, rc0, rc1, rc2, inv0, inv1,     \
      inv2, outside_max, w, wn, d_pts, nullptr
#define HPSDF_LAUNCH(D)                                                      \
  if (wn != nullptr)                                                         \
    launch(query_vjp_kernel<D, 2, false>, blocks, s, HPSDF_ARGS);            \
  else                                                                       \
    launch(query_vjp_kernel<D, 1, false>, blocks, s, HPSDF_ARGS)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
#undef HPSDF_ARGS
  return (int)cudaGetLastError();
}

// K1c: d_centre (hi - lo, 3), zeroed by the caller, gets the VJP of query
// (wn == nullptr) or query_with_gradient (cotangents as hpsdf_query_vjp's)
// with respect to the centre rows [lo, hi) that centre, depth and coeffs
// hold (0 and N for a whole tree), from the global leaves (B,) hpsdf_query
// wrote; a point whose leaf lies outside [lo, hi) adds nothing. With d_pts
// (B, 3) the same launch writes the points' VJP (a whole tree only).
extern "C" int hpsdf_query_centre_vjp(const double* centre,
                                      const int32_t* depth,
                                      const double* coeffs, int deg, int lo,
                                      int hi, const double* pts,
                                      const int32_t* leaf, int64_t B,
                                      double rc0, double rc1, double rc2,
                                      double inv0, double inv1, double inv2,
                                      int outside_max, const double* w,
                                      const double* wn, double* d_pts,
                                      double* d_centre, void* stream) {
  if (B <= 0 || hi <= lo) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define HPSDF_ARGS                                                          \
  centre, depth, coeffs, pts, leaf, B, lo, hi, rc0, rc1, rc2, inv0, inv1,   \
      inv2, outside_max, w, wn, d_pts, d_centre
#define HPSDF_LAUNCH(D)                                                      \
  if (wn != nullptr)                                                         \
    launch(query_vjp_kernel<D, 2, true>, blocks, s, HPSDF_ARGS);             \
  else                                                                       \
    launch(query_vjp_kernel<D, 1, true>, blocks, s, HPSDF_ARGS)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
#undef HPSDF_ARGS
  return (int)cudaGetLastError();
}

// blocks[0]: the blocks of kThreads an SM holds of K1v (hess 0) or K1h
// (hess 1) at degree deg, with the launch's preferred carveout.
extern "C" int hpsdf_query_vjp_blocks(int deg, int hess, int* blocks) {
#define HPSDF_BLOCKS(D)                                                      \
  {                                                                          \
    const void* k = hess ? (const void*)query_vjp_kernel<D, 2, false>        \
                         : (const void*)query_vjp_kernel<D, 1, false>;       \
    cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,  \
                         kCarveout);                                         \
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kThreads, 0);   \
  }
  HPSDF_DISPATCH_DEG(deg, HPSDF_BLOCKS)
#undef HPSDF_BLOCKS
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
