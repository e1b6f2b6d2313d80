// Device helpers shared by K2/K5 and K5h (packed_eval.cu), K7
// (packed_grad.cu), K3 (march.cu) and the kernels of check/: reading the
// packed row layout of
// hpsdf_tpu_torch/accel.py and evaluating the Legendre product sums over a
// row's folded coefficient lanes, in f32 (packed_leaf_sums). K1
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
#include <math.h>
#include <stdint.h>

namespace hpsdf {

constexpr int kCoeffLane = 8;

__device__ __forceinline__ float clamp_half(float x) {
  return fminf(fmaxf(x, -0.5f), 0.5f);
}

// The derivative of the clamp into [-0.5, 0.5] at x, as jnp.clip's: 1
// inside, 1/2 on a face (max and min split a tie), 0 outside.
template <class T>
__device__ __forceinline__ T clamp_half_slope(T x) {
  const T a = x < T(0) ? -x : x;
  return a < T(0.5) ? T(1) : (a == T(0.5) ? T(0.5) : T(0));
}

// World point p's unit-cube coordinates (p - rc) * inv, clamped into the
// root, and the clamp's slope on each axis.
__device__ __forceinline__ void unit_point(const float* p,
                                           const float (&rc)[3],
                                           const float (&inv)[3],
                                           float (&u)[3], float (&slope)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float w = (p[a] - rc[a]) * inv[a];
    slope[a] = clamp_half_slope(w);
    u[a] = clamp_half(w);
  }
}

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

// The VJP of the unit vector g / max(|g|, floor) at g with cotangent wn:
// (wn - t n (n . wn)) / den, n = g / den, den = max(|g|, floor), t = 1
// above the floor, 1/2 on it (jnp.maximum splits a tie) and 0 below.
template <class T>
__device__ __forceinline__ void unit_vector_vjp(const T (&g)[3],
                                                const T (&wn)[3], T floor,
                                                T (&out)[3]) {
  const T nrm = root(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
  const T den = nrm > floor ? nrm : floor;
  const T t = nrm > floor ? T(1) : (nrm == floor ? T(0.5) : T(0));
  T n[3], nd = T(0);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    n[a] = g[a] / den;
    nd += n[a] * wn[a];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) out[a] = (wn[a] - t * n[a] * nd) / den;
}

// H (xx, yy, zz, xy, xz, yz) applied to the vector q: out_b = sum_a
// H_ab q_a.
template <class T>
__device__ __forceinline__ void hessian_times(const T (&h)[6],
                                              const T (&q)[3],
                                              T (&out)[3]) {
  out[0] = h[0] * q[0] + h[3] * q[1] + h[4] * q[2];
  out[1] = h[3] * q[0] + h[1] * q[1] + h[5] * q[2];
  out[2] = h[4] * q[0] + h[5] * q[1] + h[2] * q[2];
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

// The key of the row locate_row4 reaches from u: its grid cell k < 8^gd,
// or 8^gd + the node row of its last descent. K7 groups its points by it,
// and K5's normals forward saves it for K7's form 2.
__device__ __forceinline__ int locate_key(const float* __restrict__ grid,
                                          const float* __restrict__ rows,
                                          int W, int gd, int extra,
                                          const float u[3]) {
  const int G3 = 1 << (3 * gd);
  int k = grid_cell(gd, u);
  const float* row = grid + (int64_t)k * W;
  for (int r = 0; r < extra; ++r) {
    const float4 m = __ldg(reinterpret_cast<const float4*>(row));
    const int child = __float_as_int(m.x) - 1;
    if (child < 0) break;
    const int oct = (u[0] >= m.z) | ((u[1] >= m.w) << 1) |
                    ((u[2] >= __ldg(row + 4)) << 2);
    k = G3 + child + oct;
    row = rows + (int64_t)(child + oct) * W;
  }
  return k;
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

// L''_0..L''_DEG by L''_p = L''_{p-2} + (2p-1) L'_{p-1}
// (basis.legendre_second_derivative).
template <int DEG, class T>
__device__ __forceinline__ void legendre_deriv2(const T (&dL)[DEG + 1],
                                                T (&d2L)[DEG + 1]) {
  d2L[0] = T(0);
  if constexpr (DEG >= 1) d2L[1] = T(0);
#pragma unroll
  for (int p = 2; p <= DEG; ++p)
    d2L[p] = d2L[p - 2] + (T)(2 * p - 1) * dL[p - 1];
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

// for_each_term's terms grouped by (i, j), k rising in a group: the terms
// that share the pair products N_i(x) N_j(y) come one after another, so an
// unrolled sum holds a group's pair products, not the whole row's. m is
// term (i, j, k)'s place in for_each_term's order.
template <int DEG, class F>
__device__ __forceinline__ void for_each_term_by_pair(F&& f) {
#pragma unroll
  for (int i = 0; i <= DEG; ++i)
#pragma unroll
    for (int j = 0; j <= DEG - i; ++j)
#pragma unroll
      for (int k = 0; k <= DEG - i - j; ++k) {
        const int p = i + j + k;
        f(p * (p + 1) * (p + 2) / 6 + i * (p + 1) - i * (i - 1) / 2 + j, i,
          j, k);
      }
}

// for_each_term's order, unrolled up to degree
// kUnrolledDeg and in loops above it: the backward kernels do several
// products, shuffles and an atomic a term, and their high-degree
// instantiations, which no fitted tree on the main path reaches, would
// otherwise take ptxas minutes (their arrays go to local memory instead).
constexpr int kUnrolledDeg = 6;

template <int DEG, class F>
__device__ __forceinline__ void for_each_term_of(F&& f) {
  if constexpr (DEG <= kUnrolledDeg) {
    for_each_term<DEG>(f);
  } else {
    int m = 0;
#pragma unroll 1
    for (int p = 0; p <= DEG; ++p)
#pragma unroll 1
      for (int i = 0; i <= p; ++i)
#pragma unroll 1
        for (int j = 0; j <= p - i; ++j, ++m) f(m, i, j, p - i - j);
  }
}

// What packed_leaf_sums sums (bits of SUMS).
constexpr int kSumValue = 1, kSumGrad = 2, kSumHess = 4;
// coefficient float4s a thread holds in registers
constexpr int kMaxQuads = 16;

// The read of a packed row at the clamped unit-cube point u, one thread: the
// Legendre product sums over the row's coefficient lanes in its leaf frame
// (u - centre) * scale, those SUMS asks for: the value v (kSumValue), the
// gradient g (kSumGrad, where `grad`) and the Hessian h (xx, yy, zz, xy,
// xz, yz; kSumHess, where `hess`, which needs g's recurrences: `grad` too).
// Rows of up to MAX_QUADS float4 coefficient lanes are read in 16-byte
// loads into registers, wider ones one 4-byte load a term. With LOOPED the
// terms go in loops above kUnrolledDeg (for_each_term_of). K2/K5 read a
// row through it, and the Hessian serves K5h as it was before its
// redesign (check/packed_hvp_reference.cu). Returns the row's scale
// 2^(depth+1).
template <int DEG, int SUMS, bool LOOPED = false, int MAX_QUADS = kMaxQuads>
__device__ __forceinline__ float packed_leaf_sums(const float* row,
                                                  const float (&u)[3],
                                                  bool grad, bool hess,
                                                  float& v, float (&g)[3],
                                                  float (&h)[6]) {
  constexpr int kC = (DEG + 1) * (DEG + 2) * (DEG + 3) / 6;
  constexpr int kQuads = (kC + 3) / 4;
  const float4 meta = __ldg(reinterpret_cast<const float4*>(row));
  const float centre[3] = {meta.z, meta.w, __ldg(row + 4)};
  const float scale = meta.y;
  const float* coef = row + kCoeffLane;

  float L[3][DEG + 1], dL[3][DEG + 1], d2L[3][DEG + 1];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    legendre<DEG>((u[a] - centre[a]) * scale, L[a]);
    if constexpr ((SUMS & (kSumGrad | kSumHess)) != 0)
      if (grad) legendre_deriv<DEG>(L[a], dL[a]);
    if constexpr ((SUMS & kSumHess) != 0)
      if (hess) legendre_deriv2<DEG>(dL[a], d2L[a]);
  }
  v = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) g[a] = 0.0f;
#pragma unroll
  for (int a = 0; a < 6; ++a) h[a] = 0.0f;
  auto each = [](auto&& f) {
    if constexpr (LOOPED)
      for_each_term_of<DEG>(f);
    else
      for_each_term<DEG>(f);
  };
  auto add_terms = [&](auto coef_of) {
    if constexpr ((SUMS & kSumValue) != 0) {
      each([&](int m, int ix, int iy, int iz) {
        v += coef_of(m) * (L[0][ix] * L[1][iy] * L[2][iz]);
      });
    }
    if constexpr ((SUMS & kSumGrad) != 0) {
      if (grad) {
        each([&](int m, int ix, int iy, int iz) {
          const float cm = coef_of(m);
          g[0] += cm * (dL[0][ix] * L[1][iy] * L[2][iz]);
          g[1] += cm * (L[0][ix] * dL[1][iy] * L[2][iz]);
          g[2] += cm * (L[0][ix] * L[1][iy] * dL[2][iz]);
        });
      }
    }
    if constexpr ((SUMS & kSumHess) != 0) {
      if (hess) {
        each([&](int m, int ix, int iy, int iz) {
          const float cm = coef_of(m);
          h[0] += cm * (d2L[0][ix] * L[1][iy] * L[2][iz]);
          h[1] += cm * (L[0][ix] * d2L[1][iy] * L[2][iz]);
          h[2] += cm * (L[0][ix] * L[1][iy] * d2L[2][iz]);
          h[3] += cm * (dL[0][ix] * dL[1][iy] * L[2][iz]);
          h[4] += cm * (dL[0][ix] * L[1][iy] * dL[2][iz]);
          h[5] += cm * (L[0][ix] * dL[1][iy] * dL[2][iz]);
        });
      }
    }
  };
  if constexpr (kQuads <= MAX_QUADS) {
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
  return scale;
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
