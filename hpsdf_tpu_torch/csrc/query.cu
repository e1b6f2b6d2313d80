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
//   * the three-term Legendre recurrence per axis up to deg_used, and with
//     WITH_GRAD the derivative recurrence L'_p = L'_{p-2} + (2p-1) L_{p-1};
//   * sum_m c_m * Lx[i_m] * Ly[j_m] * Lz[k_m] * coeff_norms[depth, m] over the
//     basis_indices triples (i_m, j_m, k_m), both tables passed as device
//     arrays;
//   * the f64-max sentinel outside the root AABB and, with WITH_GRAD, the
//     world-space chain rule and normalisation (query.py:103-109).
//
// Bound. A point reads depth_used child/centre entries (dependent gathers)
// and one coefficient row of C f64 values (C = 56 at degree 5); the
// arithmetic is about 4*C f64 operations (16*C with the gradient). Rows of
// neighbouring points are mostly the same leaf, so the gathers hit in L2
// and the kernel is bound by f64 throughput and gather latency, not by
// device memory.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDeg = 12;       // BASIS_MAX_DEGREE

template <bool WITH_GRAD>
__global__ void __launch_bounds__(kThreads)
query_kernel(const int32_t* __restrict__ child_idx,
             const double* __restrict__ centre,
             const int32_t* __restrict__ depth,
             const double* __restrict__ coeffs, int C,
             const double* __restrict__ norms,       // (TREE_MAX_DEPTH+1, C)
             const int32_t* __restrict__ bidx,       // (C, 3)
             int deg, int depth_used,
             const double* __restrict__ pts, int64_t B,
             double rc0, double rc1, double rc2,
             double inv0, double inv1, double inv2, int outside_max,
             double* __restrict__ val, double* __restrict__ grad) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const double rc[3] = {rc0, rc1, rc2};
  const double inv[3] = {inv0, inv1, inv2};
  double u[3];
  bool inside = true;
  for (int a = 0; a < 3; ++a) {
    const double w = (pts[3 * i + a] - rc[a]) * inv[a];
    inside = inside && fabs(w) <= 0.5;
    u[a] = w < -0.5 ? -0.5 : (w > 0.5 ? 0.5 : w);
  }

  int cur = 0;
  for (int r = 0; r < depth_used; ++r) {
    const int c0 = child_idx[cur];
    if (c0 < 0) break;
    const double* cc = centre + 3 * (int64_t)cur;
    cur = c0 + (u[0] >= cc[0]) + ((u[1] >= cc[1]) << 1) +
          ((u[2] >= cc[2]) << 2);
  }

  const int d = depth[cur];
  const double scale = ldexp(1.0, d + 1);
  double L[3][kMaxDeg + 1];
  double dL[3][kMaxDeg + 1];
  for (int a = 0; a < 3; ++a) {
    const double x = (u[a] - centre[3 * (int64_t)cur + a]) * scale;
    L[a][0] = 1.0;
    if (deg >= 1) L[a][1] = x;
    for (int p = 2; p <= deg; ++p)
      L[a][p] = ((2.0 * p - 1.0) / p) * x * L[a][p - 1] -
                ((p - 1.0) / p) * L[a][p - 2];
    if constexpr (WITH_GRAD) {
      dL[a][0] = 0.0;
      if (deg >= 1) dL[a][1] = 1.0;
      for (int p = 2; p <= deg; ++p)
        dL[a][p] = dL[a][p - 2] + (2.0 * p - 1.0) * L[a][p - 1];
    }
  }

  const double* co = coeffs + (int64_t)cur * C;
  const double* nr = norms + (int64_t)d * C;
  double v = 0.0, gx = 0.0, gy = 0.0, gz = 0.0;
  for (int m = 0; m < C; ++m) {
    const int ix = bidx[3 * m], iy = bidx[3 * m + 1], iz = bidx[3 * m + 2];
    const double lx = L[0][ix], ly = L[1][iy], lz = L[2][iz];
    if constexpr (WITH_GRAD) {
      const double cn = co[m] * nr[m];
      v += cn * lx * ly * lz;
      gx += cn * dL[0][ix] * ly * lz;
      gy += cn * lx * dL[1][iy] * lz;
      gz += cn * lx * ly * dL[2][iz];
    } else {
      v += co[m] * lx * ly * lz * nr[m];
    }
  }
  val[i] = (outside_max && !inside) ? DBL_MAX : v;

  if constexpr (WITH_GRAD) {
    // local = (unit - centre) * 2^(depth+1), unit = (world - c) / sizes
    const double g0 = gx * scale * inv0;
    const double g1 = gy * scale * inv1;
    const double g2 = gz * scale * inv2;
    const double nrm = sqrt(g0 * g0 + g1 * g1 + g2 * g2);
    const double den = nrm > 1e-30 ? nrm : 1e-30;
    grad[3 * i] = g0 / den;
    grad[3 * i + 1] = g1 / den;
    grad[3 * i + 2] = g2 / den;
  }
}

}  // namespace

// grad == nullptr selects the value-only instantiation.
extern "C" int hpsdf_query(const int32_t* child_idx, const double* centre,
                           const int32_t* depth, const double* coeffs, int C,
                           const double* norms, const int32_t* bidx, int deg,
                           int depth_used, const double* pts, int64_t B,
                           double rc0, double rc1, double rc2, double inv0,
                           double inv1, double inv2, int outside_max,
                           double* val, double* grad, void* stream) {
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (grad != nullptr)
    query_kernel<true><<<blocks, kThreads, 0, s>>>(
        child_idx, centre, depth, coeffs, C, norms, bidx, deg, depth_used,
        pts, B, rc0, rc1, rc2, inv0, inv1, inv2, outside_max, val, grad);
  else
    query_kernel<false><<<blocks, kThreads, 0, s>>>(
        child_idx, centre, depth, coeffs, C, norms, bidx, deg, depth_used,
        pts, B, rc0, rc1, rc2, inv0, inv1, inv2, outside_max, val, grad);
  return (int)cudaGetLastError();
}
