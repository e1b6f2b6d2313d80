// K1's backward modes K1v and K1h as they were before their redesign,
// kept as the reference of query.cu's query_vjp_kernel: one thread a point
// re-runs K1's descent from the root, then evaluates the leaf to one order
// above its forward (query_kernel<DEG, 1> given a cotangent, and
// query_kernel<DEG, 2>), the forward's branch kept, so that the code timed
// is the code that ran. chip_smoke.py builds this file apart from the
// library (_kernels.load_check), holds the shipped kernel to it bit for bit
// and times both in the same run. It is on no path of the package.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "../query_leaf.cuh"

namespace {

// The query (ORDER 0: values; 1: values and unit gradients, or K1v) and
// its backward modes K1v and K1h, the VJPs of query and
// query_with_gradient with respect to the points. A backward mode (w
// given, or ORDER 2) re-descends and re-evaluates the point's leaf to one
// order above its forward and writes the point's three cotangents. With
// s_a = 2^(depth+1) / size_a, c_a the clamp's slope (1 inside, 1/2 on a
// face, 0 clamped, as jnp.clip's) and w' the value's cotangent, zero
// outside the root under the f64-max sentinel:
//   * K1v (ORDER 1, w): d_p_a = c_a w' g_a s_a, g the leaf-frame gradient;
//   * K1h (ORDER 2, w and wn, the unit gradient's cotangent): with G = g s
//     the world gradient and gb = unit_vector_vjp(G, wn, 1e-30),
//     d_p_b = c_b s_b (w' g_b + sum_a H_ab s_a gb_a), H the leaf-frame
//     Hessian (the second derivative recurrence). Its nine sums take
//     the terms grouped by (i, j) (for_each_term_by_pair) up to degree 6,
//     in a loop above it (for_each_term_of).
template <int DEG, int ORDER>
__global__ void __launch_bounds__(kThreads)
query_vjp_reference_kernel(const int32_t* __restrict__ child_idx,
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

template <int DEG, int ORDER, class... Args>
void launch_reference(unsigned blocks, cudaStream_t s, Args... args) {
  cudaFuncSetAttribute(query_vjp_reference_kernel<DEG, ORDER>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       kCarveout);
  query_vjp_reference_kernel<DEG, ORDER><<<blocks, kThreads, 0, s>>>(
      args...);
}

template <int DEG, int ORDER>
void reference_blocks(int* blocks) {
  cudaFuncSetAttribute(query_vjp_reference_kernel<DEG, ORDER>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       kCarveout);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, query_vjp_reference_kernel<DEG, ORDER>, kThreads, 0);
}

}  // namespace

// d_pts (B, 3): the VJP of query with respect to the points with
// cotangents w (B,) (K1v, wn == nullptr; nothing from points outside the
// root with outside_max), or of query_with_gradient with cotangents w (B,)
// and wn (B, 3) (K1h; outside_max = 1). The arguments of hpsdf_query_vjp
// before its redesign.
extern "C" int hpsdf_query_vjp_reference(
    const int32_t* child_idx, const double* centre, const int32_t* depth,
    const double* coeffs, int deg, int depth_used, const double* pts,
    int64_t B, double rc0, double rc1, double rc2, double inv0, double inv1,
    double inv2, int outside_max, const double* w, const double* wn,
    double* d_pts, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define HPSDF_ARGS                                                          \
  child_idx, centre, depth, coeffs, depth_used, pts, B, rc0, rc1, rc2, inv0, \
      inv1, inv2, outside_max, nullptr, nullptr, w, wn, d_pts
#define HPSDF_LAUNCH(D)                                                      \
  if (wn != nullptr)                                                         \
    launch_reference<D, 2>(blocks, s, HPSDF_ARGS);                           \
  else                                                                       \
    launch_reference<D, 1>(blocks, s, HPSDF_ARGS)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
#undef HPSDF_ARGS
  return (int)cudaGetLastError();
}

// blocks[0]: the blocks of kThreads an SM holds of the reference's K1v
// (hess 0) or K1h (hess 1) at degree deg.
extern "C" int hpsdf_query_vjp_reference_blocks(int deg, int hess,
                                                int* blocks) {
#define HPSDF_BLOCKS(D) \
  hess ? reference_blocks<D, 2>(blocks) : reference_blocks<D, 1>(blocks)
  HPSDF_DISPATCH_DEG(deg, HPSDF_BLOCKS)
#undef HPSDF_BLOCKS
  return (int)cudaGetLastError();
}
