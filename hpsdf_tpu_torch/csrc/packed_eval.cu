// K2 / K5: packed locate + eval, one thread per point, in f32; with WITH_GRAD
// the unit normal instead of the value.
//
// Replaces what XLA fused for hpsdf_tpu/accel.py values_at / query_packed
// (to_unit, locate_in, eval_row; accel.py:226-337) and, with the gradient,
// hpsdf_tpu/render.py _normals_at (:1092-1110). The plain torch versions are
// values_at_plain / query_packed_plain / normals_plain in
// hpsdf_tpu_torch/accel.py. Per point the thread runs:
//   * world -> unit cube in f32, the inside test |u| <= 0.5 and the clamp;
//   * the grid row of u's cell and `extra` masked descents (locate_row);
//   * the Legendre product sum over the row's folded coefficient lanes, the
//     degree a template parameter so the recurrences stay in registers;
//   * values: the f32-max sentinel outside the root with `outside_max`;
//     normals: the local gradient chained through scale / root_sizes and
//     normalised with a 1e-12 floor.
//
// Bound. A point reads one grid row and at most `extra` more rows, then the
// row's C coefficients (C = 20 at degree 3, 56 at degree 5): dependent
// gathers from tables of a few MB, which stay in the 50 MB L2. The arithmetic
// is ~4*C f32 operations (~16*C with the gradient). So the kernel is bound by
// gather latency, not by device memory; the design hides it with many points
// in flight (128-thread blocks, registers for the recurrences only) and
// reads the coefficients through the read-only cache.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "packed_rows.cuh"

namespace {

constexpr int kThreads = 128;

template <int DEG, bool WITH_GRAD>
__global__ void __launch_bounds__(kThreads)
packed_eval_kernel(const float* __restrict__ grid,
                   const float* __restrict__ rows, int W, int gd, int extra,
                   const float* __restrict__ pts, int64_t B, float rc0,
                   float rc1, float rc2, float inv0, float inv1, float inv2,
                   float sz0, float sz1, float sz2, int outside_max,
                   float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const float rc[3] = {rc0, rc1, rc2};
  const float inv[3] = {inv0, inv1, inv2};
  float u[3];
  bool inside = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float w = (pts[3 * i + a] - rc[a]) * inv[a];
    inside = inside && fabsf(w) <= 0.5f;
    u[a] = hpsdf::clamp_half(w);
  }
  const float* row = hpsdf::locate_row(grid, rows, W, gd, extra, u);
  const float scale = __ldg(row + 1);
  float local[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) local[a] = (u[a] - __ldg(row + 2 + a)) * scale;

  if constexpr (WITH_GRAD) {
    float g[3];
    hpsdf::eval_local_grad<DEG>(row, local, g);
    // local = (unit - centre) * scale, unit = (p - c) / sizes
    const float sz[3] = {sz0, sz1, sz2};
#pragma unroll
    for (int a = 0; a < 3; ++a) g[a] = g[a] * scale / sz[a];
    const float nrm = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
    const float den = fmaxf(nrm, 1e-12f);
#pragma unroll
    for (int a = 0; a < 3; ++a) out[3 * i + a] = g[a] / den;
  } else {
    const float v = hpsdf::eval_local<DEG>(row, local);
    out[i] = (outside_max && !inside) ? FLT_MAX : v;
  }
}

}  // namespace

// with_grad = 0: values (B,); 1: unit normals (B, 3).
extern "C" int hpsdf_packed_eval(const float* grid, const float* rows, int W,
                                 int deg, int gd, int extra, const float* pts,
                                 int64_t B, float rc0, float rc1, float rc2,
                                 float inv0, float inv1, float inv2, float sz0,
                                 float sz1, float sz2, int outside_max,
                                 int with_grad, float* out, void* stream) {
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define HPSDF_LAUNCH(D)                                                      \
  if (with_grad)                                                             \
    packed_eval_kernel<D, true><<<blocks, kThreads, 0, s>>>(                 \
        grid, rows, W, gd, extra, pts, B, rc0, rc1, rc2, inv0, inv1, inv2,   \
        sz0, sz1, sz2, outside_max, out);                                    \
  else                                                                       \
    packed_eval_kernel<D, false><<<blocks, kThreads, 0, s>>>(                \
        grid, rows, W, gd, extra, pts, B, rc0, rc1, rc2, inv0, inv1, inv2,   \
        sz0, sz1, sz2, outside_max, out)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
  return (int)cudaGetLastError();
}
