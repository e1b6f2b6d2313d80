// P1: exact closest triangle per point, by a dense scan over all triangles.
//
// Replaces the Pallas TPU kernel hpsdf_tpu/mesh/pallas_sdf.py
// closest_tri_tiles (_call_kernel / _kernel / _closest_d2). Same contract:
//   in : tri_rows f32 (T, stride >= 9), lanes 0..8 = vertices a, b, c;
//        pts f32 (B, 3)
//   out: best_d2 f32[B]  squared distance to the closest triangle
//        best_idx i32[B] its row, lowest index on ties, clipped to [0, T-1]
//
// Design. One thread per point, blocks of kThreads points. Each block stages
// kTile triangles at a time (9 floats each) in shared memory and every
// thread walks them in ascending order, keeping its own running
// (best_d2, best_idx) with a strict '<'. That reproduces the TPU kernel's
// rule that the lowest index wins: there, the min of a masked iota inside a
// tile and 'loc_min < d2_ref' across tiles. The TPU grid carried the
// running min across triangle blocks in its resident output block; here
// that carry is this in-block loop, so there is no state across blocks and
// no atomics. The ragged tail of T is masked (no padding rows); padding rows
// the caller passes (coordinates 1e30, whose squared distance overflows to
// +inf) never win against the +inf initial best with a strict '<'.
//
// The closest-point cascade is Ericson's (RTCD 5.1.5), as in _closest_d2:
// six region predicates, the first true one wins. The TPU version computed
// every region's candidate and selected; here the thread branches to the
// winning region and computes only its point, with the same expressions.
//
// Numerics. Built without --use_fast_math: the cascade divides by guards of
// 1e-30 that flush-to-zero would break. nvcc contracts a*b+c into FMA by
// default, so at boundaries between regions a predicate can flip against the
// plain torch version; the feature changes there, the distance does not
// (the closest point is continuous across region boundaries).
//
// Bound. About 60 f32 operations per point-triangle pair (plus one
// division) and no device-memory traffic beyond the staged tiles, which
// every block reads from L2: f32 SIMT throughput is the limit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;        // triangles per shared-memory tile
constexpr float kEps = 1e-30f;

__device__ __forceinline__ float guard(float x) {
  return fabsf(x) > kEps ? x : kEps;
}

__device__ __forceinline__ float closest_d2(float px, float py, float pz,
                                            const float* t) {
  const float ax = t[0], ay = t[1], az = t[2];
  const float bx = t[3], by = t[4], bz = t[5];
  const float cx = t[6], cy = t[7], cz = t[8];
  const float abx = bx - ax, aby = by - ay, abz = bz - az;
  const float acx = cx - ax, acy = cy - ay, acz = cz - az;

  const float apx = px - ax, apy = py - ay, apz = pz - az;
  const float d1 = abx * apx + aby * apy + abz * apz;
  const float d2 = acx * apx + acy * apy + acz * apz;

  const float bpx = px - bx, bpy = py - by, bpz = pz - bz;
  const float d3 = abx * bpx + aby * bpy + abz * bpz;
  const float d4 = acx * bpx + acy * bpy + acz * bpz;

  const float cpx = px - cx, cpy = py - cy, cpz = pz - cz;
  const float d5 = abx * cpx + aby * cpy + abz * cpz;
  const float d6 = acx * cpx + acy * cpy + acz * cpz;

  const float va = d3 * d6 - d5 * d4;
  const float vb = d5 * d2 - d1 * d6;
  const float vc = d1 * d4 - d3 * d2;

  float qx, qy, qz;
  if (d1 <= 0.f && d2 <= 0.f) {                              // vertex a
    qx = ax; qy = ay; qz = az;
  } else if (d3 >= 0.f && d4 <= d3) {                        // vertex b
    qx = bx; qy = by; qz = bz;
  } else if (d6 >= 0.f && d5 <= d6) {                        // vertex c
    qx = cx; qy = cy; qz = cz;
  } else if (vc <= 0.f && d1 >= 0.f && d3 <= 0.f) {          // edge ab
    const float t_ab = d1 / guard(d1 - d3);
    qx = ax + abx * t_ab; qy = ay + aby * t_ab; qz = az + abz * t_ab;
  } else if (vb <= 0.f && d2 >= 0.f && d6 <= 0.f) {          // edge ca
    const float t_ca = d2 / guard(d2 - d6);
    qx = ax + acx * t_ca; qy = ay + acy * t_ca; qz = az + acz * t_ca;
  } else if (va <= 0.f && d4 - d3 >= 0.f && d5 - d6 >= 0.f) {  // edge bc
    const float t_bc = (d4 - d3) / guard((d4 - d3) + (d5 - d6));
    qx = bx + (cx - bx) * t_bc;
    qy = by + (cy - by) * t_bc;
    qz = bz + (cz - bz) * t_bc;
  } else {                                                   // face
    const float denom = guard(va + vb + vc);
    const float v = vb / denom;
    const float w = vc / denom;
    qx = ax + abx * v + acx * w;
    qy = ay + aby * v + acy * w;
    qz = az + abz * v + acz * w;
  }
  const float dx = px - qx, dy = py - qy, dz = pz - qz;
  return dx * dx + dy * dy + dz * dz;
}

__global__ void __launch_bounds__(kThreads)
closest_tri_kernel(const float* __restrict__ rows, int64_t T, int64_t stride,
                   const float* __restrict__ pts, int64_t B,
                   float* __restrict__ best_d2, int32_t* __restrict__ best_idx) {
  __shared__ float tile[kTile * 9];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < B;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (live) {
    px = pts[3 * i];
    py = pts[3 * i + 1];
    pz = pts[3 * i + 2];
  }
  float best = INFINITY;
  int64_t bi = 0;
  for (int64_t t0 = 0; t0 < T; t0 += kTile) {
    const int n = T - t0 < kTile ? (int)(T - t0) : kTile;
    for (int e = threadIdx.x; e < n * 9; e += blockDim.x) {
      const int r = e / 9;
      tile[e] = rows[(t0 + r) * stride + (e - 9 * r)];
    }
    __syncthreads();
    if (live) {
      for (int k = 0; k < n; ++k) {
        const float d2 = closest_d2(px, py, pz, &tile[9 * k]);
        if (d2 < best) {
          best = d2;
          bi = t0 + k;
        }
      }
    }
    __syncthreads();
  }
  if (live) {
    best_d2[i] = best;
    best_idx[i] = (int32_t)(bi < T ? bi : T - 1);   // bi >= 0 by construction
  }
}

}  // namespace

extern "C" int hpsdf_closest_tri(const float* rows, int64_t T, int64_t stride,
                                 const float* pts, int64_t B, float* best_d2,
                                 int32_t* best_idx, void* stream) {
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  closest_tri_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(rows, T, stride, pts, B,
                                               best_d2, best_idx);
  return (int)cudaGetLastError();
}

extern "C" const char* hpsdf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
