// K11: the closest triangle per point by a walk of the perfect-heap BVH,
// one thread a point.
//
// Replaces the XLA-fused loop _closest_bvh_impl,
// hpsdf_tpu/mesh/sdf.py:73-160 (the batched while_loop of
// signed_distance). Same contract:
//   in : node_rows f32 (T2, 16), heap node n's children's boxes in lanes
//        0..11 (left min, left max, right min, right max); tri_rows f32
//        (T2, stride >= 9), the leaves in heap order (heap id T2 + row);
//        pts f32 (B, 3); max_iters, the visits after which a walk stops
//   out: best_d2 f32[B], best_idx i32[B] (a row of tri_rows)
// Each point first descends greedily, always into the nearer child, to one
// leaf, whose triangle seeds the best distance (an upper bound, so the walk
// prunes from its start); then it walks depth-first: at an internal node
// it descends into the nearer child if that box is nearer than the best and
// pushes the farther one if it is too, at a leaf it evaluates the triangle,
// and otherwise it pops. Every visit is one iteration; the walk stops when
// the stack is empty or after max_iters iterations (4 T2 visits every node
// a DFS can reach, so that cap is exact).
//
// A point's walk depends on that point alone, so a thread follows exactly
// the sequence of the lockstep plain version (sdf.closest_bvh_plain): the
// same decisions on the same distances. The box distances round as the
// plain version's do (tri.cuh aabb_d2); the triangle distance is P1's
// (tri.cuh), which differs from the plain cascade by FMA contraction in the
// last bits, so a decision can flip only where a box distance and the best
// are within an ulp or two.
//
// Bound on the H100. The work is data-dependent: per point, the node rows
// and triangle rows its walk visits (counted by the plain version, or by
// this kernel's `visits`). Each visit is a dependent load -- the next node
// is known only after the distances of this one -- of 48 bytes (a node row's
// twelve lanes as three float4s) or 36 (a triangle's vertices, two float4s
// and a float), and about 40 f32 operations (two box distances) or 70 (the
// staging and the cascade). So a walk is a chain of L2 or device-memory
// latencies, not a stream of bytes or operations: the kernel is bound by
// latency, and by divergence, since the 32 walks of a warp take different
// lengths and branches (a deep-interior point, nearly equidistant from much
// of the surface, visits thousands of nodes where a point near the surface
// visits tens). The design does the simple thing: one thread a point, the
// stack in local memory (32 ints, so T2 <= 2^30), rows read with 16-byte
// read-only loads, no reordering of the points. chip_smoke.py prices the
// bound on the visits the plain version counts and records how far the
// kernel is from it.
//
// Numerics. Built without --use_fast_math (the cascade's 1e-30 guards).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tri.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStack = 32;     // heap depth + 1 for T2 <= 2^30

// the two child boxes' squared distances of internal heap node n
__device__ __forceinline__ void child_d2(const float* __restrict__ node_rows,
                                         int32_t n, float px, float py,
                                         float pz, float& dl, float& dr) {
  const float4* r = reinterpret_cast<const float4*>(node_rows) + 4 * (int64_t)n;
  const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
  dl = hpsdf::aabb_d2(px, py, pz, a.x, a.y, a.z, a.w, b.x, b.y);
  dr = hpsdf::aabb_d2(px, py, pz, b.z, b.w, c.x, c.y, c.z, c.w);
}

__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const float* __restrict__ node_rows,
                const float* __restrict__ tri_rows, int64_t tri_stride,
                int32_t T2, int depth, const float* __restrict__ pts,
                int64_t B, int64_t max_iters, float* __restrict__ best_d2,
                int32_t* __restrict__ best_idx,
                int32_t* __restrict__ visits) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  const float px = pts[3 * i], py = pts[3 * i + 1], pz = pts[3 * i + 2];

  // greedy seed: always into the nearer child, down to one leaf
  int32_t seed = 1;
  for (int d = 0; d < depth; ++d) {
    float dl, dr;
    child_d2(node_rows, seed, px, py, pz, dl, dr);
    seed = dl <= dr ? 2 * seed : 2 * seed + 1;
  }
  const int32_t seed_row = min(max(seed - T2, 0), T2 - 1);
  float best = hpsdf::row_d2(px, py, pz, tri_rows + seed_row * tri_stride);
  int32_t idx = seed_row;
  int32_t n_nodes = depth, n_leaves = 1;

  int32_t stack[kMaxStack];
  int sp = 0;
  int32_t cur = 1;
  for (int64_t it = 0;;) {                    // as the plain loop: one visit
    bool descend = false;                     // even when max_iters < 1
    int32_t near = 0;
    if (cur >= T2) {                          // a leaf: its triangle
      const int32_t row = cur - T2;
      const float d2 = hpsdf::row_d2(px, py, pz, tri_rows + row * tri_stride);
      ++n_leaves;
      if (d2 < best) {
        best = d2;
        idx = row;
      }
    } else {                                  // internal: nearer, farther
      float dl, dr;
      child_d2(node_rows, cur, px, py, pz, dl, dr);
      ++n_nodes;
      const bool l_near = dl <= dr;
      near = l_near ? 2 * cur : 2 * cur + 1;
      descend = fminf(dl, dr) < best;
      if (descend && fmaxf(dl, dr) < best) stack[sp++] = l_near ? 2 * cur + 1
                                                                 : 2 * cur;
    }
    if (descend) {
      cur = near;
    } else if (sp > 0) {
      cur = stack[--sp];
    } else {
      break;
    }
    if (++it >= max_iters) break;
  }
  best_d2[i] = best;
  best_idx[i] = idx;
  if (visits != nullptr) {
    visits[2 * i] = n_nodes;
    visits[2 * i + 1] = n_leaves;
  }
}

}  // namespace

// K11 over B points. visits, if not null, gets i32[B, 2]: the node rows and
// the triangle rows each walk read (the seed's included).
extern "C" int hpsdf_bvh_walk(const float* node_rows, const float* tri_rows,
                              int64_t tri_stride, int64_t T2, int depth,
                              const float* pts, int64_t B, int64_t max_iters,
                              float* best_d2, int32_t* best_idx,
                              int32_t* visits, void* stream) {
  if (T2 < 1 || T2 > (int64_t(1) << 30) || depth < 0 ||
      depth + 1 > kMaxStack) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  bvh_walk_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      node_rows, tri_rows, tri_stride, (int32_t)T2, depth, pts, B, max_iters,
      best_d2, best_idx, visits);
  return (int)cudaGetLastError();
}
