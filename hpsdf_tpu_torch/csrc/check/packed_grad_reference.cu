// K7 as it was before its redesign, kept as the reference of packed_grad.cu:
// one thread a point locates its row as K2 does and adds its terms into the
// coefficient lanes of that row with float atomics, the lanes of a warp that
// share a row summing their terms in registers first (scatter.cuh), into
// tables the caller zeroed. chip_smoke.py builds this file apart from the
// library (_kernels.load_check), holds the shipped kernel to it and times
// both in the same run. It is on no path of the package. The arithmetic is
// described in packed_grad.cu; form 1 takes the clamp's slope on each axis
// as packed_grad.cu does since the face rule (1/2 on a face of the root),
// so that the two compute the same function.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../packed_rows.cuh"
#include "../scatter.cuh"

namespace {

constexpr int kThreads = 128;

template <int DEG, int FORM>
__global__ void __launch_bounds__(kThreads)
packed_grad_reference_kernel(const float* __restrict__ grid,
                             const float* __restrict__ rows, int W, int gd,
                             int extra, const float* __restrict__ pts,
                             int64_t B, float rc0, float rc1, float rc2,
                             float inv0, float inv1, float inv2,
                             const float* __restrict__ cot,
                             float* __restrict__ d_grid,
                             float* __restrict__ d_rows) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < B;
  const int64_t ip = valid ? i : B - 1;     // spare lanes repeat the last point
  const float rc[3] = {rc0, rc1, rc2};
  const float inv[3] = {inv0, inv1, inv2};
  float u[3], slope[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float w = (pts[3 * ip + a] - rc[a]) * inv[a];
    slope[a] = hpsdf::clamp_half_slope(w);
    u[a] = hpsdf::clamp_half(w);
  }
  // locate_row4, keeping the table the row comes from
  const float* row = hpsdf::grid_row(grid, W, gd, u);
  bool from_grid = true;
  for (int r = 0; r < extra; ++r) {
    const float4 m = __ldg(reinterpret_cast<const float4*>(row));
    const int child = __float_as_int(m.x) - 1;
    if (child < 0) break;
    const int oct = (u[0] >= m.z) | ((u[1] >= m.w) << 1) |
                    ((u[2] >= __ldg(row + 4)) << 2);
    row = rows + (int64_t)(child + oct) * W;
    from_grid = false;
  }
  float* dst = from_grid ? d_grid + (row - grid) : d_rows + (row - rows);
  dst += hpsdf::kCoeffLane;
  const float4 meta = __ldg(reinterpret_cast<const float4*>(row));
  const float centre[3] = {meta.z, meta.w, __ldg(row + 4)};
  const float scale = meta.y;

  float L[3][DEG + 1], dL[3][DEG + 1];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    hpsdf::legendre<DEG>((u[a] - centre[a]) * scale, L[a]);
    if constexpr (FORM == 1) hpsdf::legendre_deriv<DEG>(L[a], dL[a]);
  }
  float w = 0.0f, ua[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (FORM == 0) {
    w = valid ? cot[i] : 0.0f;
  } else {
#pragma unroll
    for (int a = 0; a < 3; ++a)
      ua[a] = valid && slope[a] > 0.0f
                  ? slope[a] * cot[3 * i + a] * (scale * inv[a])
                  : 0.0f;
  }

  const hpsdf::PeerSum peers(valid ? (unsigned long long)dst : ~0ull);
  const bool write = valid && peers.leader;
  hpsdf::for_each_term_of<DEG>([&](int m, int ix, int iy, int iz) {
    float x;
    if constexpr (FORM == 0) {
      x = w * (L[0][ix] * L[1][iy] * L[2][iz]);
    } else {
      x = ua[0] * (dL[0][ix] * L[1][iy] * L[2][iz]) +
          ua[1] * (L[0][ix] * dL[1][iy] * L[2][iz]) +
          ua[2] * (L[0][ix] * L[1][iy] * dL[2][iz]);
    }
    x = peers.sum(x);
    if (write) atomicAdd(dst + m, x);
  });
}

}  // namespace

// form 0: cot = w (B,); form 1: cot = u (B, 3). d_grid and d_rows (the
// tables' shapes) must be zeroed by the caller. Rows 16-byte aligned.
extern "C" int hpsdf_packed_grad_reference(
    const float* grid, const float* rows, int W, int deg, int gd, int extra,
    const float* pts, int64_t B, float rc0, float rc1, float rc2, float inv0,
    float inv1, float inv2, const float* cot, int form, float* d_grid,
    float* d_rows, void* stream) {
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if ((form != 0 && form != 1) || B <= 0) return (int)cudaErrorInvalidValue;
#define HPSDF_FORM(D, F)                                                     \
  packed_grad_reference_kernel<D, F><<<blocks, kThreads, 0, s>>>(            \
      grid, rows, W, gd, extra, pts, B, rc0, rc1, rc2, inv0, inv1, inv2, cot, \
      d_grid, d_rows)
#define HPSDF_LAUNCH(D) \
  if (form == 0)        \
    HPSDF_FORM(D, 0);   \
  else                  \
    HPSDF_FORM(D, 1)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
#undef HPSDF_FORM
  return (int)cudaGetLastError();
}
