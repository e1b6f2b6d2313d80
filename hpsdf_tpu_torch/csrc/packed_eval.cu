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
//     of values_at chains it, and zero on each axis on which the point was
//     clamped into the root (the derivative of the clamp);
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
constexpr int kMaxQuads = 16;       // coefficient float4s held in registers
// what a launch computes (the wrapper's `mode`)
constexpr int kValues = 0, kNormals = 1, kRawGrad = 2, kValuesGrad = 3;

template <int DEG, int MODE>
__global__ void __launch_bounds__(kThreads)
packed_eval_kernel(const float* __restrict__ grid,
                   const float* __restrict__ rows, int W, int gd, int extra,
                   const float* __restrict__ pts, int64_t B, float rc0,
                   float rc1, float rc2, float inv0, float inv1, float inv2,
                   float sz0, float sz1, float sz2, int outside_max,
                   float* __restrict__ out, float* __restrict__ out_grad,
                   int64_t B_g) {
  constexpr int kC = (DEG + 1) * (DEG + 2) * (DEG + 3) / 6;
  constexpr int kQuads = (kC + 3) / 4;
  constexpr bool VALUES = MODE == kValues || MODE == kValuesGrad;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // whether this thread sums the gradient
  const bool with_grad = MODE == kNormals || MODE == kRawGrad ||
                         (MODE == kValuesGrad && i < B_g);
  if (i >= B) return;
  const float rc[3] = {rc0, rc1, rc2};
  const float inv[3] = {inv0, inv1, inv2};
  float u[3];
  bool in_axis[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float w = (pts[3 * i + a] - rc[a]) * inv[a];
    in_axis[a] = fabsf(w) <= 0.5f;
    u[a] = hpsdf::clamp_half(w);
  }
  const bool inside = in_axis[0] && in_axis[1] && in_axis[2];
  const float* row = hpsdf::locate_row4(grid, rows, W, gd, extra, u);
  const float4 meta = __ldg(reinterpret_cast<const float4*>(row));
  const float centre[3] = {meta.z, meta.w, __ldg(row + 4)};
  const float scale = meta.y;
  const float* coef = row + hpsdf::kCoeffLane;

  float L[3][DEG + 1], dL[3][DEG + 1];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    hpsdf::legendre<DEG>((u[a] - centre[a]) * scale, L[a]);
  if (with_grad) {
#pragma unroll
    for (int a = 0; a < 3; ++a) hpsdf::legendre_deriv<DEG>(L[a], dL[a]);
  }
  float v = 0.0f, g[3] = {0.0f, 0.0f, 0.0f};
  auto add_terms = [&](auto coef_of) {
    if constexpr (VALUES) {
      hpsdf::for_each_term<DEG>([&](int m, int ix, int iy, int iz) {
        v += coef_of(m) * (L[0][ix] * L[1][iy] * L[2][iz]);
      });
    }
    if (with_grad) {
      hpsdf::for_each_term<DEG>([&](int m, int ix, int iy, int iz) {
        const float cm = coef_of(m);
        g[0] += cm * (dL[0][ix] * L[1][iy] * L[2][iz]);
        g[1] += cm * (L[0][ix] * dL[1][iy] * L[2][iz]);
        g[2] += cm * (L[0][ix] * L[1][iy] * dL[2][iz]);
      });
    }
  };
  if constexpr (kQuads <= kMaxQuads) {
    float c[4 * kQuads];
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(coef) + q);
      c[4 * q] = f.x, c[4 * q + 1] = f.y, c[4 * q + 2] = f.z,
      c[4 * q + 3] = f.w;
    }
    add_terms([&](int m) { return c[m]; });
  } else {
    add_terms([&](int m) { return __ldg(coef + m); });
  }

  if constexpr (MODE == kRawGrad || MODE == kValuesGrad) {
    // local = (unit - centre) * scale, unit = clamp((p - c) * (1 / sizes))
    float* dst = MODE == kRawGrad ? out : out_grad;
    if (with_grad) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
        dst[3 * i + a] = in_axis[a] ? g[a] * scale * inv[a] : 0.0f;
    }
    if constexpr (MODE == kValuesGrad) out[i] = v;
  } else if constexpr (MODE == kNormals) {
    // local = (unit - centre) * scale, unit = (p - c) / sizes
    const float sz[3] = {sz0, sz1, sz2};
#pragma unroll
    for (int a = 0; a < 3; ++a) g[a] = g[a] * scale / sz[a];
    const float nrm = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
    const float den = fmaxf(nrm, 1e-12f);
#pragma unroll
    for (int a = 0; a < 3; ++a) out[3 * i + a] = g[a] / den;
  } else {
    out[i] = (outside_max && !inside) ? FLT_MAX : v;
  }
}

}  // namespace

// mode 0: values (B,) in out; 1: unit normals (B, 3); 2: raw gradients
// (B, 3); 3: values (B,) in out and the raw gradients of the first B_g
// points (B_g, 3) in out_grad, B_g <= B. Rows 16-byte aligned.
extern "C" int hpsdf_packed_eval(const float* grid, const float* rows, int W,
                                 int deg, int gd, int extra, const float* pts,
                                 int64_t B, float rc0, float rc1, float rc2,
                                 float inv0, float inv1, float inv2, float sz0,
                                 float sz1, float sz2, int outside_max,
                                 int mode, float* out, float* out_grad,
                                 int64_t B_g, void* stream) {
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode < kValues || mode > kValuesGrad ||
      (mode == kValuesGrad && (B_g < 0 || B_g > B)))
    return (int)cudaErrorInvalidValue;
#define HPSDF_MODE(D, M)                                                     \
  packed_eval_kernel<D, M><<<blocks, kThreads, 0, s>>>(                      \
      grid, rows, W, gd, extra, pts, B, rc0, rc1, rc2, inv0, inv1, inv2, sz0, \
      sz1, sz2, outside_max, out, out_grad, B_g)
#define HPSDF_LAUNCH(D)                     \
  if (mode == kNormals)                     \
    HPSDF_MODE(D, kNormals);                \
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
