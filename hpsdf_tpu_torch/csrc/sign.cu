// K14: the sign on the best triangle. Per point, the signed distance to the
// triangle of its best index: the closest point and its feature (vertex,
// edge, face) by Ericson's region cascade (RTCD 5.1.5), that feature's
// pseudo-normal, then sign(pn . (p - closest)) * |p - closest|
// (Baerentzen-Aanaes; the reference's Mesh::SignedDistanceAtPt,
// Source/Meshing/Mesh.cpp:162-242).
//
// Replaces the fused loop XLA made of hpsdf_tpu/mesh/sdf.py:61-70
// _signed_from_best, with _pseudo_normal (:48-58) and
// hpsdf_tpu/mesh/tri.py:21-85 closest_point_triangle. The plain torch
// version is signed_from_best_plain in hpsdf_tpu_torch/mesh/sdf.py: G's
// row gather, then mesh/tri.py's where-cascade and six selections, about
// 150 small launches a call where this is one. It runs on every F call of
// every mesh path (tiles, hybrid, bvh) and reads the row straight from the
// packed table, so the sign needs no gathered copy of the rows.
//
// Arithmetic. Each operation is the plain version's, in its order, with the
// __f*_rn intrinsics: nvcc contracts a*b + c into an FMA, torch's
// elementwise ops round each product, and a surface point's sign can flip
// on one ulp of pn . (p - closest). Divisions are IEEE (__fdiv_rn), as
// torch's; the 1e-30 guard and the cascade's order (vertex a, b, c, edge
// ab, ca, bc, then the face: the first true predicate wins) are
// mesh/tri.py's. A dot product adds x, y, then z. An index outside
// [0, rows) reads a row of zeros, as G gives one. Where the caller asks, the
// feature's code (mesh/tri.py: 0, 1, 2 the vertices a, b, c; 3, 4, 5 the
// edges ab, bc, ca; 6 the face) is written too, for the checks.
//
// Bound. Bytes: a point reads its 12 bytes and its index and writes 4; its
// row's lanes 0..11 (vertices and face normal: 16-byte loads, two sectors)
// and the three lanes of the feature's pseudo-normal come from the table,
// read once for every point that shares the row. The cascade is ~80 f32
// operations a point, far under the bytes on this card. A thread a point.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kGuard = 1e-30f;
// packed row lanes (mesh/bvh.py): vertex and edge pseudo-normals (the face
// normal, lanes 9..11, comes with the vertices' 16-byte loads)
constexpr int kVPN = 12, kEPN = 21;

__device__ __forceinline__ float guard(float x) {
  return fabsf(x) > kGuard ? x : kGuard;
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// q + e * s, a component
__device__ __forceinline__ float along(float q, float e, float s) {
  return __fadd_rn(q, __fmul_rn(e, s));
}

__global__ void __launch_bounds__(kThreads)
signed_from_best_kernel(const float* __restrict__ rows, int64_t n_rows,
                        int64_t stride, const int32_t* __restrict__ idx,
                        const float* __restrict__ pts, int64_t B,
                        float* __restrict__ out, int8_t* __restrict__ feat) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float px = pts[3 * b], py = pts[3 * b + 1], pz = pts[3 * b + 2];
  const int64_t r = (int64_t)__ldg(idx + b);
  const bool ok = r >= 0 && r < n_rows;
  const float* row = rows + (ok ? r : 0) * stride;
  float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f), v1 = v0, v2 = v0;
  if (ok) {
    v0 = __ldg(reinterpret_cast<const float4*>(row));
    v1 = __ldg(reinterpret_cast<const float4*>(row) + 1);
    v2 = __ldg(reinterpret_cast<const float4*>(row) + 2);
  }
  const float ax = v0.x, ay = v0.y, az = v0.z;
  const float bx = v0.w, by = v1.x, bz = v1.y;
  const float cx = v1.z, cy = v1.w, cz = v2.x;

  const float abx = __fsub_rn(bx, ax), aby = __fsub_rn(by, ay),
              abz = __fsub_rn(bz, az);
  const float acx = __fsub_rn(cx, ax), acy = __fsub_rn(cy, ay),
              acz = __fsub_rn(cz, az);
  const float d1 = dot3(abx, aby, abz, __fsub_rn(px, ax), __fsub_rn(py, ay),
                        __fsub_rn(pz, az));
  const float d2 = dot3(acx, acy, acz, __fsub_rn(px, ax), __fsub_rn(py, ay),
                        __fsub_rn(pz, az));
  const float bpx = __fsub_rn(px, bx), bpy = __fsub_rn(py, by),
              bpz = __fsub_rn(pz, bz);
  const float d3 = dot3(abx, aby, abz, bpx, bpy, bpz);
  const float d4 = dot3(acx, acy, acz, bpx, bpy, bpz);
  const float cpx = __fsub_rn(px, cx), cpy = __fsub_rn(py, cy),
              cpz = __fsub_rn(pz, cz);
  const float d5 = dot3(abx, aby, abz, cpx, cpy, cpz);
  const float d6 = dot3(acx, acy, acz, cpx, cpy, cpz);
  const float va = __fsub_rn(__fmul_rn(d3, d6), __fmul_rn(d5, d4));
  const float vb = __fsub_rn(__fmul_rn(d5, d2), __fmul_rn(d1, d6));
  const float vc = __fsub_rn(__fmul_rn(d1, d4), __fmul_rn(d3, d2));
  const float e43 = __fsub_rn(d4, d3), e56 = __fsub_rn(d5, d6);

  // the feature's code, its closest point (qx, qy, qz) and the lane of its
  // pseudo-normal: vertex k at kVPN + 3k, edge k at kEPN + 3k
  float qx, qy, qz;
  int code;
  if (d1 <= 0.f && d2 <= 0.f) {                            // vertex a
    qx = ax; qy = ay; qz = az; code = 0;
  } else if (d3 >= 0.f && d4 <= d3) {                      // vertex b
    qx = bx; qy = by; qz = bz; code = 1;
  } else if (d6 >= 0.f && d5 <= d6) {                      // vertex c
    qx = cx; qy = cy; qz = cz; code = 2;
  } else if (vc <= 0.f && d1 >= 0.f && d3 <= 0.f) {        // edge ab
    const float s = __fdiv_rn(d1, guard(__fsub_rn(d1, d3)));
    qx = along(ax, abx, s); qy = along(ay, aby, s); qz = along(az, abz, s);
    code = 3;
  } else if (vb <= 0.f && d2 >= 0.f && d6 <= 0.f) {        // edge ca
    const float s = __fdiv_rn(d2, guard(__fsub_rn(d2, d6)));
    qx = along(ax, acx, s); qy = along(ay, acy, s); qz = along(az, acz, s);
    code = 5;
  } else if (va <= 0.f && e43 >= 0.f && e56 >= 0.f) {      // edge bc
    const float s = __fdiv_rn(e43, guard(__fadd_rn(e43, e56)));
    qx = along(bx, __fsub_rn(cx, bx), s);
    qy = along(by, __fsub_rn(cy, by), s);
    qz = along(bz, __fsub_rn(cz, bz), s);
    code = 4;
  } else {                                                 // face
    const float g = guard(__fadd_rn(__fadd_rn(va, vb), vc));
    const float v = __fdiv_rn(vb, g), w = __fdiv_rn(vc, g);
    qx = __fadd_rn(along(ax, abx, v), __fmul_rn(acx, w));
    qy = __fadd_rn(along(ay, aby, v), __fmul_rn(acy, w));
    qz = __fadd_rn(along(az, abz, v), __fmul_rn(acz, w));
    code = 6;
  }
  float nx = v2.y, ny = v2.z, nz = v2.w;                   // lanes 9..11
  if (code != 6 && ok) {
    const int pn = code < 3 ? kVPN + 3 * code : kEPN + 3 * (code - 3);
    nx = __ldg(row + pn);
    ny = __ldg(row + pn + 1);
    nz = __ldg(row + pn + 2);
  }
  if (feat != nullptr) feat[b] = (int8_t)code;
  const float dx = __fsub_rn(px, qx), dy = __fsub_rn(py, qy),
              dz = __fsub_rn(pz, qz);
  const float dist = __fsqrt_rn(dot3(dx, dy, dz, dx, dy, dz));
  out[b] = dot3(nx, ny, nz, dx, dy, dz) >= 0.f ? dist : -dist;
}

}  // namespace

// rows: (n_rows, >= 30) f32, lanes contiguous, rows 16-byte aligned (row
// stride a multiple of 4 floats); idx: (B,) int32; pts: (B, 3) f32
// contiguous; out: (B,) f32; feat: (B,) int8 or null.
extern "C" int hpsdf_signed_from_best(const float* rows, int64_t n_rows,
                                      int64_t stride, const int32_t* idx,
                                      const float* pts, int64_t B,
                                      float* out, int8_t* feat,
                                      void* stream) {
  if (stride % 4 != 0 || (uintptr_t)rows % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (B == 0) return 0;
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  signed_from_best_kernel<<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>(rows, n_rows, stride, idx,
                                                    pts, B, out, feat);
  return (int)cudaGetLastError();
}
