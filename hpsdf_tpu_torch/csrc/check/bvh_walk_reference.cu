// K11 as it was before its redesign, kept as the exactness reference of
// bvh_walk.cu: a thread a point, each visit one dependent load of a node
// row or a triangle's vertices, the stack a 128-byte local frame. Both
// kernels walk exactly the sequence of the plain version (sdf.
// closest_bvh_plain) on the same distances (tri.cuh aabb_d2 and row_d2,
// read from rows holding the same vertex lanes), so bvh_walk.cu, which only
// loads the distances a window of the heap at a time and replays the
// decisions, must return this kernel's best_d2, best_idx and visits bit for
// bit; chip_smoke.py builds this file apart from the library
// (_kernels.load_check), holds bvh_walk.cu to it and times both. It is on no
// path of the package.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../tri.cuh"

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
bvh_walk_reference_kernel(const float* __restrict__ node_rows,
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

// The reference walk over B points, called as hpsdf_bvh_walk is.
extern "C" int hpsdf_bvh_walk_reference(
    const float* node_rows, const float* tri_rows, int64_t tri_stride,
    int64_t T2, int depth, const float* pts, int64_t B, int64_t max_iters,
    float* best_d2, int32_t* best_idx, int32_t* visits, void* stream) {
  if (T2 < 1 || T2 > (int64_t(1) << 30) || depth < 0 ||
      depth + 1 > kMaxStack) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  bvh_walk_reference_kernel<<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
      node_rows, tri_rows, tri_stride, (int32_t)T2, depth, pts, B, max_iters,
      best_d2, best_idx, visits);
  return (int)cudaGetLastError();
}
