// The point-triangle distance that every mesh kernel computes: P1
// (closest_tri.cu), K10 (hybrid.cu) and K11 (bvh_walk.cu) share it, so the
// three give one triangle the same squared distance.
//
// A triangle is staged as (a, ab, ac, |ab|^2, ab.ac, |ac|^2), twelve floats
// in three float4s; closest_d2 then runs Ericson's cascade (RTCD 5.1.5) as
// tiles_sdf._closest_d2 writes it: six region predicates, the first true one
// wins, a division only in the region taken, by __fdividef (within 2 ulp, no
// flush to zero: the 1e-30 guards keep their meaning). d3..d6 follow from d1
// and d2 by one subtraction each. Built without --use_fast_math.
//
// aabb_d2 is the squared distance from a point to a box, written with
// __f*_rn intrinsics so that it rounds as the torch plain versions do
// (tri.aabb_dist2, sdf._axes_dist2): x, y and z added in that order.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace hpsdf {

constexpr float kTriEps = 1e-30f;

__device__ __forceinline__ float guard(float x) {
  return fabsf(x) > kTriEps ? x : kTriEps;
}

// vertices a, b, c -> the staged terms (a, ab, ac, |ab|^2, ab.ac, |ac|^2)
__device__ __forceinline__ void stage_terms(float ax, float ay, float az,
                                            float bx, float by, float bz,
                                            float cx, float cy, float cz,
                                            float4& s0, float4& s1,
                                            float4& s2) {
  const float abx = bx - ax, aby = by - ay, abz = bz - az;
  const float acx = cx - ax, acy = cy - ay, acz = cz - az;
  s0 = make_float4(ax, ay, az, abx);
  s1 = make_float4(aby, abz, acx, acy);
  s2 = make_float4(acz, abx * abx + aby * aby + abz * abz,
                   abx * acx + aby * acy + abz * acz,
                   acx * acx + acy * acy + acz * acz);
}

// squared distance from p to one staged triangle
__device__ __forceinline__ float closest_d2(float px, float py, float pz,
                                            float4 t0, float4 t1, float4 t2) {
  const float abx = t0.w, aby = t1.x, abz = t1.y;
  const float acx = t1.z, acy = t1.w, acz = t2.x;
  const float apx = px - t0.x, apy = py - t0.y, apz = pz - t0.z;
  const float d1 = abx * apx + aby * apy + abz * apz;
  const float d2 = acx * apx + acy * apy + acz * apz;
  const float d3 = d1 - t2.y, d4 = d2 - t2.z;     // ab.(p - b), ac.(p - b)
  const float d5 = d1 - t2.z, d6 = d2 - t2.w;     // ab.(p - c), ac.(p - c)
  const float va = d3 * d6 - d5 * d4;
  const float vb = d5 * d2 - d1 * d6;
  const float vc = d1 * d4 - d3 * d2;
  const float e43 = d4 - d3, e56 = d5 - d6;
  float s, t;
  if (d1 <= 0.f && d2 <= 0.f) {                          // vertex a
    s = 0.f; t = 0.f;
  } else if (d3 >= 0.f && d4 <= d3) {                    // vertex b
    s = 1.f; t = 0.f;
  } else if (d6 >= 0.f && d5 <= d6) {                    // vertex c
    s = 0.f; t = 1.f;
  } else if (vc <= 0.f && d1 >= 0.f && d3 <= 0.f) {      // edge ab
    s = __fdividef(d1, guard(d1 - d3)); t = 0.f;
  } else if (vb <= 0.f && d2 >= 0.f && d6 <= 0.f) {      // edge ca
    s = 0.f; t = __fdividef(d2, guard(d2 - d6));
  } else if (va <= 0.f && e43 >= 0.f && e56 >= 0.f) {    // edge bc
    const float g = guard(e43 + e56);
    s = __fdividef(e56, g); t = __fdividef(e43, g);
  } else {                                               // face
    const float g = guard(va + vb + vc);
    s = __fdividef(vb, g); t = __fdividef(vc, g);
  }
  const float dx = apx - abx * s - acx * t;
  const float dy = apy - aby * s - acy * t;
  const float dz = apz - abz * s - acz * t;
  return dx * dx + dy * dy + dz * dz;
}

// squared distance from p to the triangle whose vertices lead a packed row
// (lanes 0..8; the row 16-byte aligned): two float4 loads and a float
__device__ __forceinline__ float row_d2(float px, float py, float pz,
                                        const float* __restrict__ row) {
  const float4 v0 = __ldg(reinterpret_cast<const float4*>(row));
  const float4 v1 = __ldg(reinterpret_cast<const float4*>(row) + 1);
  const float v8 = __ldg(row + 8);
  float4 s0, s1, s2;
  stage_terms(v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w, v8, s0, s1, s2);
  return closest_d2(px, py, pz, s0, s1, s2);
}

// squared distance from p to the box [lo, hi]
__device__ __forceinline__ float aabb_d2(float px, float py, float pz,
                                         float lx, float ly, float lz,
                                         float hx, float hy, float hz) {
  const float dx = __fadd_rn(fmaxf(__fsub_rn(lx, px), 0.f),
                             fmaxf(__fsub_rn(px, hx), 0.f));
  const float dy = __fadd_rn(fmaxf(__fsub_rn(ly, py), 0.f),
                             fmaxf(__fsub_rn(py, hy), 0.f));
  const float dz = __fadd_rn(fmaxf(__fsub_rn(lz, pz), 0.f),
                             fmaxf(__fsub_rn(pz, hz), 0.f));
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

}  // namespace hpsdf
