// K2 / K5: packed locate + eval, one thread per point, in f32; K5 gives the
// unit normal instead of the value, or the raw world-space gradient.
//
// Replaces what XLA fused for hpsdf_tpu/accel.py values_at / query_packed
// (to_unit, locate_in, eval_row; accel.py:226-337) and, with the gradient,
// hpsdf_tpu/render.py _normals_at (:1092-1110). The plain torch versions are
// values_at_plain / query_packed_plain / normals_plain in
// hpsdf_tpu_torch/accel.py. Per point the thread runs:
//   * world -> unit cube in f32, the inside test |u| <= 0.5 and the clamp;
//   * the grid row of u's cell and `extra` masked descents (locate_row4);
//   * the Legendre product sum over the row's folded coefficient lanes, the
//     degree a template parameter so the recurrences stay in registers;
//   * values: the f32-max sentinel outside the root with `outside_max`;
//     normals: the local gradient chained through scale / root_sizes and
//     normalised with a 1e-12 floor;
//   * the raw gradient (K5's third form, for the backward of values_at and
//     the eikonal term of inverse rendering, hpsdf_tpu/inverse.py:233-240):
//     the local gradient chained through scale / root_sizes, as autodiff
//     of values_at chains it, times the clamp's derivative on each axis: 1
//     inside the root, 1/2 on a face (jnp.clip's max and min split the
//     tie), 0 where the point was clamped;
//   * values and raw gradients in one launch (the fused mode): the value at
//     every point and the raw gradient at the first B_g, the points of an
//     inverse chunk's one read (its band points first, whose gradients the
//     eikonal term takes; inverse.py chunk_loss). A thread i < B_g runs the
//     derivative recurrences and the three gradient sums on the row it
//     already holds, after the value's sum; each sum is written as in its
//     own mode, so the values are bit-equal to mode 0's and the gradients
//     to mode 2's. It saves the raw-gradient launch and its second read of
//     the same rows.
//
// Where the normals' backward needs the tables' gradient, the normals mode
// also saves what K7's form 2 starts from (kNormalsSave): each point's row
// key (locate_key, the walk locate_row4 takes) and its unnormalised world
// gradient G, one 16-byte store a point. Without it the normals mode is
// its own instantiation, unchanged.
//
// K5h (packed_hvp_kernel), the same read with the Hessian, gives the point
// VJPs of normals and values_and_gradient_at; it is described above its
// kernel below.
//
// Bound. The tables are a few MB and stay in the 50 MB L2, and the
// arithmetic is ~4*C f32 operations a point (~16*C with the gradient). At
// scattered points the 32 lanes of a warp read 32 rows, and each load
// instruction then costs up to 32 L1 wavefronts: reading a row one 4-byte
// load a lane (5 + C loads, 24 on a degree-3 row) made that the bound. So a
// thread reads its row in 16-byte loads: lanes 0-4 (the descent's and the
// leaf frame's) as one float4 and one scalar, the coefficients as float4s
// into registers (C/4 loads, 5 on a degree-3 row). What bounds the kernel
// then is the rows' bytes from L2 to the SMs, one row a point. Staging a
// warp's rows in shared memory with coalesced copies moves the same bytes:
// it gains ~10% at scattered points, but its warp-wide row count delays
// every warp, and the carve's batches, whose warps mostly read one row,
// run slower for it than this form (PERF.md). Rows wider than 64
// coefficient lanes (degree >= 6) are read one 4-byte load a term.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "packed_rows.cuh"

namespace {

constexpr int kThreads = 128;
// what a launch computes (the wrapper's `mode`)
constexpr int kValues = 0, kNormals = 1, kRawGrad = 2, kValuesGrad = 3,
              kNormalsSave = 4;

template <int DEG, int MODE>
__global__ void __launch_bounds__(kThreads)
packed_eval_kernel(const float* __restrict__ grid,
                   const float* __restrict__ rows, int W, int gd, int extra,
                   const float* __restrict__ pts, int64_t B, float rc0,
                   float rc1, float rc2, float inv0, float inv1, float inv2,
                   float sz0, float sz1, float sz2, int outside_max,
                   float* __restrict__ out, float* __restrict__ out_grad,
                   int64_t B_g) {
  constexpr int kSums =
      (MODE == kValues || MODE == kValuesGrad ? hpsdf::kSumValue : 0) |
      (MODE == kValues ? 0 : hpsdf::kSumGrad);
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // whether this thread sums the gradient
  const bool with_grad = MODE == kNormals || MODE == kNormalsSave ||
                         MODE == kRawGrad || (MODE == kValuesGrad && i < B_g);
  if (i >= B) return;
  const float rc[3] = {rc0, rc1, rc2};
  const float inv[3] = {inv0, inv1, inv2};
  float u[3], slope[3];
  hpsdf::unit_point(pts + 3 * i, rc, inv, u, slope);
  const bool inside = slope[0] > 0.0f && slope[1] > 0.0f && slope[2] > 0.0f;
  int key = 0;
  const float* row;
  if constexpr (MODE == kNormalsSave) {
    key = hpsdf::locate_key(grid, rows, W, gd, extra, u);
    const int G3 = 1 << (3 * gd);
    row = key < G3 ? grid + (int64_t)key * W : rows + (int64_t)(key - G3) * W;
  } else {
    row = hpsdf::locate_row4(grid, rows, W, gd, extra, u);
  }
  float v, g[3], h[6];
  const float scale = hpsdf::packed_leaf_sums<DEG, kSums>(row, u, with_grad,
                                                          false, v, g, h);

  if constexpr (MODE == kRawGrad || MODE == kValuesGrad) {
    // local = (unit - centre) * scale, unit = clamp((p - c) * (1 / sizes))
    float* dst = MODE == kRawGrad ? out : out_grad;
    if (with_grad) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
        dst[3 * i + a] =
            slope[a] > 0.0f ? slope[a] * (g[a] * scale * inv[a]) : 0.0f;
    }
    if constexpr (MODE == kValuesGrad) out[i] = v;
  } else if constexpr (MODE == kNormals || MODE == kNormalsSave) {
    // local = (unit - centre) * scale, unit = (p - c) / sizes
    const float sz[3] = {sz0, sz1, sz2};
#pragma unroll
    for (int a = 0; a < 3; ++a) g[a] = g[a] * scale / sz[a];
    const float nrm = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
    const float den = fmaxf(nrm, 1e-12f);
#pragma unroll
    for (int a = 0; a < 3; ++a) out[3 * i + a] = g[a] / den;
    if constexpr (MODE == kNormalsSave)
      reinterpret_cast<float4*>(out_grad)[i] =
          make_float4(__int_as_float(key), g[0], g[1], g[2]);
  } else {
    out[i] = (outside_max && !inside) ? FLT_MAX : v;
  }
}

// K5h: Hessian-vector products of the packed eval, the point VJPs of
// normals and of values_and_gradient_at (normals_vjp_plain,
// values_and_gradient_vjp_plain), per point in f32. The thread locates
// and reads its row through K5's read (packed_leaf_sums), which sums the
// leaf-frame gradient g and here the Hessian H too (xx, yy, zz, xy, xz,
// yz; the second derivative recurrence).
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
// Bound: the row read, as K5; the Hessian adds six sums a term. Above
// degree 6 the terms go in a loop (for_each_term_of).
constexpr int kNormalsVjp = 0, kValuesGradVjp = 1;

template <int DEG, int MODE>
__global__ void __launch_bounds__(kThreads)
packed_hvp_kernel(const float* __restrict__ grid,
                  const float* __restrict__ rows, int W, int gd, int extra,
                  const float* __restrict__ pts, int64_t B, float rc0,
                  float rc1, float rc2, float inv0, float inv1, float inv2,
                  float sz0, float sz1, float sz2,
                  const float* __restrict__ w, const float* __restrict__ cot3,
                  int64_t B_g, float* __restrict__ d_pts) {
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

// mode 0: values (B,) in out; 1: unit normals (B, 3); 2: raw gradients
// (B, 3); 3: values (B,) in out and the raw gradients of the first B_g
// points (B_g, 3) in out_grad, B_g <= B; 4: unit normals (B, 3) in out and
// in out_grad (B, 4), 16-byte aligned, each point's row key (its bits) and
// unnormalised gradient, for K7's form 2. Rows 16-byte aligned.
extern "C" int hpsdf_packed_eval(const float* grid, const float* rows, int W,
                                 int deg, int gd, int extra, const float* pts,
                                 int64_t B, float rc0, float rc1, float rc2,
                                 float inv0, float inv1, float inv2, float sz0,
                                 float sz1, float sz2, int outside_max,
                                 int mode, float* out, float* out_grad,
                                 int64_t B_g, void* stream) {
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode < kValues || mode > kNormalsSave ||
      (mode == kValuesGrad && (B_g < 0 || B_g > B)))
    return (int)cudaErrorInvalidValue;
  if (mode == kNormalsSave && (uintptr_t)out_grad % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
#define HPSDF_MODE(D, M)                                                     \
  packed_eval_kernel<D, M><<<blocks, kThreads, 0, s>>>(                      \
      grid, rows, W, gd, extra, pts, B, rc0, rc1, rc2, inv0, inv1, inv2, sz0, \
      sz1, sz2, outside_max, out, out_grad, B_g)
#define HPSDF_LAUNCH(D)                     \
  if (mode == kNormals)                     \
    HPSDF_MODE(D, kNormals);                \
  else if (mode == kNormalsSave)            \
    HPSDF_MODE(D, kNormalsSave);            \
  else if (mode == kRawGrad)                \
    HPSDF_MODE(D, kRawGrad);                \
  else if (mode == kValuesGrad)             \
    HPSDF_MODE(D, kValuesGrad);             \
  else                                      \
    HPSDF_MODE(D, kValues)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
#undef HPSDF_MODE
  return (int)cudaGetLastError();
}

// K5h: d_pts (B, 3), mode 0 the VJP of the unit normals with cotangents
// cot3 = wn (B, 3); mode 1 the VJP of values_and_gradient_at with
// cotangents w (B,) for the values and cot3 = u (B_g, 3) for the raw
// gradients of the first B_g <= B points. Rows 16-byte aligned.
extern "C" int hpsdf_packed_hvp(const float* grid, const float* rows, int W,
                                int deg, int gd, int extra, const float* pts,
                                int64_t B, float rc0, float rc1, float rc2,
                                float inv0, float inv1, float inv2, float sz0,
                                float sz1, float sz2, int mode,
                                const float* w, const float* cot3,
                                int64_t B_g, float* d_pts, void* stream) {
  if (B <= 0 || (mode != kNormalsVjp && mode != kValuesGradVjp) ||
      (mode == kValuesGradVjp && (B_g < 0 || B_g > B)))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define HPSDF_MODE(D, M)                                                     \
  packed_hvp_kernel<D, M><<<blocks, kThreads, 0, s>>>(                       \
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
