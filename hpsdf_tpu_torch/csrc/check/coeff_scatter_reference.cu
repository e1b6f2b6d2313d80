// K8 as it was before its redesign, kept as the reference of
// coeff_scatter.cu: one thread a ray or point runs the descent, the
// recurrences and (trace form) the dfdt sum whatever its weight, and the
// lanes of a warp that share a leaf sum their terms in registers
// (scatter.cuh) before one lane a group adds them with scalar atomics, into
// the (N, C) gradient the caller zeroed. chip_smoke.py builds this file
// apart from the library (_kernels.load_check), holds the shipped kernel to
// it and times both in the same run. It is on no path of the package. The
// arithmetic is described in coeff_scatter.cu.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../packed_rows.cuh"
#include "../scatter.cuh"

namespace {

constexpr int kThreads = 128;

struct TraceIn {
  const float* origins;   // (B, 3)
  const float* dirs;      // (B, 3)
  const float* t;         // (B,)
  const uint8_t* hit;     // (B,)
};

template <class T, int DEG, bool TRACE>
__global__ void __launch_bounds__(kThreads)
coeff_scatter_reference_kernel(const int32_t* __restrict__ child_idx,
                     const T* __restrict__ centre,
                     const int32_t* __restrict__ depth,
                     const T* __restrict__ coeffs, int depth_used,
                     const T* __restrict__ pts, TraceIn tr, int64_t B,
                     T rc0, T rc1, T rc2, T inv0, T inv1, T inv2,
                     const T* __restrict__ cot, int outside_zero,
                     T* __restrict__ d_coeffs) {
  constexpr int kC = (DEG + 1) * (DEG + 2) * (DEG + 3) / 6;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t ip = i < B ? i : B - 1;     // spare lanes repeat the last point
  bool valid = i < B;
  const T rc[3] = {rc0, rc1, rc2};
  const T inv[3] = {inv0, inv1, inv2};
  T p[3], u[3];
  bool in_axis[3];
  if constexpr (TRACE) {
    valid = valid && tr.hit[ip] != 0;
    const float t = tr.t[ip];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      p[a] = tr.origins[3 * ip + a] + t * tr.dirs[3 * ip + a];
  } else {
#pragma unroll
    for (int a = 0; a < 3; ++a) p[a] = pts[3 * ip + a];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T w = (p[a] - rc[a]) * inv[a];
    in_axis[a] = fabs(w) <= T(0.5);
    u[a] = w < T(-0.5) ? T(-0.5) : (w > T(0.5) ? T(0.5) : w);
  }
  if (!TRACE && outside_zero)
    valid = valid && in_axis[0] && in_axis[1] && in_axis[2];

  int cur = 0;
  for (int r = 0; r < depth_used; ++r) {
    const int c0 = __ldg(child_idx + cur);
    if (c0 < 0) break;
    const T* cc = centre + 3 * (int64_t)cur;
    cur = c0 + (u[0] >= __ldg(cc)) + ((u[1] >= __ldg(cc + 1)) << 1) +
          ((u[2] >= __ldg(cc + 2)) << 2);
  }
  const int d = __ldg(depth + cur);
  const T scale = (T)ldexp(1.0, d + 1);
  const T* cc = centre + 3 * (int64_t)cur;
  // N[a][p] = L_p(x_a) nt[p], nt[p] = sqrt((2p+1) 2^d); dN likewise
  T N[3][DEG + 1], dN[3][DEG + 1];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    T L[DEG + 1], dL[DEG + 1];
    hpsdf::legendre<DEG>((u[a] - __ldg(cc + a)) * scale, L);
    if constexpr (TRACE) hpsdf::legendre_deriv<DEG>(L, dL);
#pragma unroll
    for (int q = 0; q <= DEG; ++q) {
      const T nt = (T)sqrt((2.0 * q + 1.0) * ldexp(1.0, d));
      N[a][q] = L[q] * nt;
      if constexpr (TRACE) dN[a][q] = dL[q] * nt;
    }
  }

  T w = T(0);
  if constexpr (TRACE) {
    const T* c = coeffs + (int64_t)cur * kC;
    T g[3] = {T(0), T(0), T(0)};
    hpsdf::for_each_term_of<DEG>([&](int m, int ix, int iy, int iz) {
      const T cm = __ldg(c + m);
      g[0] += cm * (dN[0][ix] * N[1][iy] * N[2][iz]);
      g[1] += cm * (N[0][ix] * dN[1][iy] * N[2][iz]);
      g[2] += cm * (N[0][ix] * N[1][iy] * dN[2][iz]);
    });
    T dfdt = T(0);
#pragma unroll
    for (int a = 0; a < 3; ++a)
      if (in_axis[a]) dfdt += g[a] * scale * inv[a] * tr.dirs[3 * ip + a];
    const T safe = fabs(dfdt) > T(1e-6) ? dfdt : T(1e-6);
    w = valid ? -cot[ip] / safe : T(0);
  } else {
    w = valid ? cot[ip] : T(0);
  }

  const hpsdf::PeerSum peers(valid ? (unsigned long long)cur : ~0ull);
  const bool write = valid && peers.leader;
  T* dst = d_coeffs + (int64_t)cur * kC;
  hpsdf::for_each_term_of<DEG>([&](int m, int ix, int iy, int iz) {
    T x = w * (N[0][ix] * N[1][iy] * N[2][iz]);
    x = peers.sum(x);
    if (write) atomicAdd(dst + m, x);
  });
}

}  // namespace

// dtype 8: the query form in f64 (pts, cot, the tree's centre and coeffs
// f64); dtype 4: the trace form in f32 (origins, dirs, t, hit, cot = dt; the
// tree's centre and coeffs f32). d_coeffs (N, C) must be zeroed by the
// caller.
extern "C" int hpsdf_coeff_scatter_reference(const int32_t* child_idx,
                                   const void* centre, const int32_t* depth,
                                   const void* coeffs, int deg, int depth_used,
                                   const void* pts, const float* origins,
                                   const float* dirs, const float* t,
                                   const uint8_t* hit, int64_t B, double rc0,
                                   double rc1, double rc2, double inv0,
                                   double inv1, double inv2, const void* cot,
                                   int outside_zero, int dtype,
                                   void* d_coeffs, void* stream) {
  if (B <= 0 || (dtype != 4 && dtype != 8)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const TraceIn tr{origins, dirs, t, hit};
#define HPSDF_LAUNCH(D)                                                      \
  if (dtype == 8)                                                            \
    coeff_scatter_reference_kernel<double, D, false>                         \
        <<<blocks, kThreads, 0, s>>>(                                        \
        child_idx, (const double*)centre, depth, (const double*)coeffs,      \
        depth_used, (const double*)pts, tr, B, rc0, rc1, rc2, inv0, inv1,    \
        inv2, (const double*)cot, outside_zero, (double*)d_coeffs);          \
  else                                                                       \
    coeff_scatter_reference_kernel<float, D, true>                           \
        <<<blocks, kThreads, 0, s>>>(                                        \
        child_idx, (const float*)centre, depth, (const float*)coeffs,        \
        depth_used, nullptr, tr, B, (float)rc0, (float)rc1, (float)rc2,      \
        (float)inv0, (float)inv1, (float)inv2, (const float*)cot,            \
        outside_zero, (float*)d_coeffs)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
  return (int)cudaGetLastError();
}
