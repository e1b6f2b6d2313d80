// Device helpers shared by K2/K5 (packed_eval.cu) and K3 (march.cu): reading
// the packed row layout of hpsdf_tpu_torch/accel.py and evaluating the
// Legendre product sum over a row's folded coefficient lanes, in f32. K1
// (query.cu) takes the recurrences (in f64), the term order and the degree
// dispatch from here too.
//
// Row lanes: 0 = child_idx + 1 bitcast i32 -> f32 (0 for leaves), 1 = scale
// 2^(depth+1), 2..4 = cell centre in unit-cube coords, 8.. = coefficients
// with the (depth, basis) normalizers folded in, in basis_indices order (by
// total degree p, then i, then j; k = p - i - j).
//
// Constants follow hpsdf_tpu's f32 arithmetic: a Python float constant is
// rounded once to f32, so the recurrence factors are computed in double and
// then rounded.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hpsdf {

constexpr int kCoeffLane = 8;

__device__ __forceinline__ float clamp_half(float x) {
  return fminf(fmaxf(x, -0.5f), 0.5f);
}

// The depth-gd grid cell of the unit-cube point u (clamped into the root),
// and its row; then the row of the leaf containing u: the grid row, then up
// to `extra` descents, stopping at a leaf (accel.locate_in). The cell index
// truncates, as astype(int32) does; u + 0.5 >= 0, so that is floor.
__device__ __forceinline__ int grid_cell(int gd, const float u[3]) {
  const int g = 1 << gd;
  int c[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int ci = (int)((u[a] + 0.5f) * (float)g);
    c[a] = ci < 0 ? 0 : (ci > g - 1 ? g - 1 : ci);
  }
  return (c[0] * g + c[1]) * g + c[2];
}

__device__ __forceinline__ const float* grid_row(
    const float* __restrict__ grid, int W, int gd, const float u[3]) {
  return grid + (int64_t)grid_cell(gd, u) * W;
}

// The leaf's row: the descents read lanes 0-4 as one float4 and one scalar
// (rows 16-byte aligned).
__device__ __forceinline__ const float* locate_row4(
    const float* __restrict__ grid, const float* __restrict__ rows, int W,
    int gd, int extra, const float u[3]) {
  const float* row = grid_row(grid, W, gd, u);
  for (int r = 0; r < extra; ++r) {
    const float4 m = __ldg(reinterpret_cast<const float4*>(row));
    const int child = __float_as_int(m.x) - 1;
    if (child < 0) break;
    const int oct = (u[0] >= m.z) | ((u[1] >= m.w) << 1) |
                    ((u[2] >= __ldg(row + 4)) << 2);
    row = rows + (int64_t)(child + oct) * W;
  }
  return row;
}

// L_0..L_DEG at x by the three-term recurrence (basis.legendre_all), the
// factors computed in double and rounded once to T.
template <int DEG, class T>
__device__ __forceinline__ void legendre(T x, T (&L)[DEG + 1]) {
  L[0] = T(1);
  if constexpr (DEG >= 1) L[1] = x;
#pragma unroll
  for (int p = 2; p <= DEG; ++p)
    L[p] = (T)((2.0 * p - 1.0) / p) * x * L[p - 1] -
           (T)((p - 1.0) / p) * L[p - 2];
}

// L'_0..L'_DEG by L'_p = L'_{p-2} + (2p-1) L_{p-1}.
template <int DEG, class T>
__device__ __forceinline__ void legendre_deriv(const T (&L)[DEG + 1],
                                               T (&dL)[DEG + 1]) {
  dL[0] = T(0);
  if constexpr (DEG >= 1) dL[1] = T(1);
#pragma unroll
  for (int p = 2; p <= DEG; ++p) dL[p] = dL[p - 2] + (T)(2 * p - 1) * L[p - 1];
}

// f(m, i, j, k) for each basis term m of degree DEG, in basis_indices order
// (by total degree p, then i, then j; k = p - i - j).
template <int DEG, class F>
__device__ __forceinline__ void for_each_term(F&& f) {
  int m = 0;
#pragma unroll
  for (int p = 0; p <= DEG; ++p)
#pragma unroll
    for (int i = 0; i <= p; ++i)
#pragma unroll
      for (int j = 0; j <= p - i; ++j, ++m) f(m, i, j, p - i - j);
}

}  // namespace hpsdf

// Expands to a switch over the basis degree 0..12 (BASIS_MAX_DEGREE) that
// runs LAUNCH(D) with D a compile-time constant; other degrees return
// cudaErrorInvalidValue from the enclosing function.
#define HPSDF_DISPATCH_DEG(deg, LAUNCH) \
  switch (deg) {                        \
    case 0: LAUNCH(0); break;           \
    case 1: LAUNCH(1); break;           \
    case 2: LAUNCH(2); break;           \
    case 3: LAUNCH(3); break;           \
    case 4: LAUNCH(4); break;           \
    case 5: LAUNCH(5); break;           \
    case 6: LAUNCH(6); break;           \
    case 7: LAUNCH(7); break;           \
    case 8: LAUNCH(8); break;           \
    case 9: LAUNCH(9); break;           \
    case 10: LAUNCH(10); break;         \
    case 11: LAUNCH(11); break;         \
    case 12: LAUNCH(12); break;         \
    default: return (int)cudaErrorInvalidValue; \
  }
