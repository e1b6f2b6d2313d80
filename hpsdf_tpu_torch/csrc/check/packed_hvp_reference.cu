// K5h as it was before its redesign, kept as the reference of
// packed_eval.cu's packed_hvp_kernel: the point VJPs of normals and of
// values_and_gradient_at (normals_vjp_plain, values_and_gradient_vjp_plain),
// per point in f32. The thread locates its row again from the root grid
// (locate_row4) and reads it through K5's read (packed_leaf_sums), which
// sums the leaf-frame gradient g and the Hessian H (xx, yy, zz, xy, xz, yz;
// the second derivative recurrence), each term's triple products formed
// anew, the gradient's three sums in one pass over the terms and the
// Hessian's six in another.
// With c_a the clamp's slope (1, 1/2 on a face, 0 clamped) and
// s_a = scale / size_a (scale * inv_a where values_at's chain takes it):
//   * kNormalsVjp, cotangents wn (B, 3) of the unit normals g s /
//     max(|g s|, 1e-12): gb = unit_vector_vjp(g s, wn, 1e-12), q_a =
//     (gb_a / size_a) scale, and d_p_b = c_b scale inv_b sum_a H_ab q_a;
//   * kValuesGradVjp, cotangents w (B,) of the values and u (B_g, 3) of
//     the raw gradients c_a g_a scale inv_a of the first B_g points:
//     q_a = u_a c_a scale inv_a there (0 beyond), and
//     d_p_b = c_b scale inv_b (w g_b + sum_a H_ab q_a); a thread past B_g
//     sums no Hessian.
// chip_smoke.py builds this file apart from the library
// (_kernels.load_check), holds the shipped kernel to it and times both in
// the same run. It is on no path of the package.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../packed_rows.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kNormalsVjp = 0, kValuesGradVjp = 1;

template <int DEG, int MODE>
__global__ void __launch_bounds__(kThreads)
packed_hvp_reference_kernel(const float* __restrict__ grid,
                            const float* __restrict__ rows, int W, int gd,
                            int extra, const float* __restrict__ pts,
                            int64_t B, float rc0, float rc1, float rc2,
                            float inv0, float inv1, float inv2, float sz0,
                            float sz1, float sz2,
                            const float* __restrict__ w,
                            const float* __restrict__ cot3, int64_t B_g,
                            float* __restrict__ d_pts) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const bool hess = MODE == kNormalsVjp || i < B_g;
  const float rc[3] = {rc0, rc1, rc2};
  const float inv[3] = {inv0, inv1, inv2};
  const float sz[3] = {sz0, sz1, sz2};
  float u[3], slope[3];
  hpsdf::unit_point(pts + 3 * i, rc, inv, u, slope);
  const float* row = hpsdf::locate_row4(grid, rows, W, gd, extra, u);
  float v, g[3], h[6];
  const float scale =
      hpsdf::packed_leaf_sums<DEG, hpsdf::kSumGrad | hpsdf::kSumHess, true>(
          row, u, true, hess, v, g, h);

  float q[3] = {0.0f, 0.0f, 0.0f}, dl[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (MODE == kNormalsVjp) {
    // n = G / max(|G|, 1e-12), G_a = g_a scale / size_a
    float G[3], wn[3], gb[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      G[a] = g[a] * scale / sz[a];
      wn[a] = __ldg(cot3 + 3 * i + a);
    }
    hpsdf::unit_vector_vjp(G, wn, 1e-12f, gb);
#pragma unroll
    for (int a = 0; a < 3; ++a) q[a] = gb[a] / sz[a] * scale;
  } else {
    const float wi = __ldg(w + i);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      dl[a] = wi * g[a];
      if (hess) q[a] = __ldg(cot3 + 3 * i + a) * slope[a] * (scale * inv[a]);
    }
  }
  if (hess) {
    float hq[3];
    hpsdf::hessian_times(h, q, hq);
#pragma unroll
    for (int a = 0; a < 3; ++a) dl[a] += hq[a];
  }
  // local = (unit - centre) * scale, unit = clamp((p - c) * (1 / sizes))
#pragma unroll
  for (int a = 0; a < 3; ++a)
    d_pts[3 * i + a] = slope[a] * (dl[a] * scale * inv[a]);
}

}  // namespace

// d_pts (B, 3), mode 0 the VJP of the unit normals with cotangents cot3 =
// wn (B, 3); mode 1 the VJP of values_and_gradient_at with cotangents w
// (B,) for the values and cot3 = u (B_g, 3) for the raw gradients of the
// first B_g <= B points. Rows 16-byte aligned.
extern "C" int hpsdf_packed_hvp_reference(
    const float* grid, const float* rows, int W, int deg, int gd, int extra,
    const float* pts, int64_t B, float rc0, float rc1, float rc2, float inv0,
    float inv1, float inv2, float sz0, float sz1, float sz2, int mode,
    const float* w, const float* cot3, int64_t B_g, float* d_pts,
    void* stream) {
  if (B <= 0 || (mode != kNormalsVjp && mode != kValuesGradVjp) ||
      (mode == kValuesGradVjp && (B_g < 0 || B_g > B)))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define HPSDF_MODE(D, M)                                                     \
  packed_hvp_reference_kernel<D, M><<<blocks, kThreads, 0, s>>>(             \
      grid, rows, W, gd, extra, pts, B, rc0, rc1, rc2, inv0, inv1, inv2, sz0, \
      sz1, sz2, w, cot3, B_g, d_pts)
#define HPSDF_LAUNCH(D)          \
  if (mode == kNormalsVjp)       \
    HPSDF_MODE(D, kNormalsVjp);  \
  else                           \
    HPSDF_MODE(D, kValuesGradVjp)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
#undef HPSDF_MODE
  return (int)cudaGetLastError();
}
