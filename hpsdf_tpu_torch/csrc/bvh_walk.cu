// K11: the closest triangle per point by a walk of the perfect-heap BVH,
// a warp a point, the heap loaded a window of levels at a time.
//
// Replaces the XLA-fused loop _closest_bvh_impl,
// hpsdf_tpu/mesh/sdf.py:73-160 (the batched while_loop of
// signed_distance). Same contract:
//   in : node_rows f32 (T2, 16), heap node n's children's boxes in lanes
//        0..11 (left min, left max, right min, right max); tri_rows f32
//        (T2, stride >= 9), the leaves in heap order (heap id T2 + row):
//        the packed rows or, as the main path passes them, BVH.vertex_rows
//        (stride 12); pts f32 (B, 3); max_iters, the visits after which a
//        walk stops
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
// What bounds it. Not bytes or arithmetic (chip_smoke.py prices both on
// the rows the plain walks read: microseconds), but the walk's chain of
// dependent steps: the next node is known only after the distances of this
// one. Walked a thread a point (the kernel this one replaces), every visit
// waited on one load from L2 or device memory, ~0.3 us on the H100, and
// 32 walks of different lengths shared a warp.
//
// The design. A visit's decision depends only on the node's two child-box
// distances and on the best, and the best changes only at a leaf. So a
// warp follows one point's walk and, from the node where the walk stands,
// loads the heap subtree kLevels levels deep in one round (the heap keeps a
// subtree's level k below node r in the contiguous ids r 2^k .. r 2^k +
// 2^k - 1): a node row a lane, and where the window reaches the leaves
// (ids >= T2) their vertices too, a row a lane (48 contiguous bytes of
// vertex_rows): 63 items, two a lane. Each lane computes its items'
// child-box distances (tri.cuh aabb_d2, rounded as the plain version rounds)
// or triangle distance (P1's cascade, tri.cuh row_d2) in registers, and the
// warp turns them into bit masks by ballots (32 bits for the internal
// items, which lie on the top five levels, 64 for the leaves): which child
// is nearer, and, against the best, which nodes descend, which push, which
// leaves improve. Then the warp replays the sequential walk's visits in
// order from the bits, a descent a few bit operations a step, updating the
// best at a leaf in walk order (a shuffle of its value, and the masks
// again), until the walk leaves the window: it descends below it, or pops
// to a node outside it, and the next round loads the window under that
// node. The greedy seed descends the same way, a window a round. The stack
// lives in the warp's lanes, an entry a lane (a heap of depth d stacks at
// most d entries), read back with a shuffle: no local frame, no shared
// memory. So a walk pays one dependent round trip a window (on
// icosphere(0.3, 5) about 8 visits a round) instead of one a visit, and its
// visits are the thread-a-point walk's own, decision for decision: the
// same distances in the same order, hence the same results and visit
// counts. What bounds it now: alone, a round (~1,000 cycles: the loads'
// L2 latency, then the distances, the cascade's branches diverging) and
// the replay's dependent chain (~170 cycles a visit); in a batch, issue.
// Five levels, four walks a block and the replay as written were chosen
// by timing forms on the H100 (PERF.md); an unrolled descent, a replay of
// whole descent runs and an L1 prefetch of the next window were slower.
//
// Numerics. Built without --use_fast_math (the cascade's 1e-30 guards).
// The triangle distance is P1's, which differs from the plain cascade by
// FMA contraction in the last bits, so a decision can flip only where a box
// distance and the best are within an ulp or two.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tri.cuh"

namespace {

constexpr int kWarps = 4;                // walks a block, a warp each
constexpr int kLevels = 5;               // internal heap levels a window
constexpr int kMaxStack = 32;            // an entry a lane: depth <= 31
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int level_of(int32_t n) { return 31 - __clz(n); }

// One window: the items a lane holds (item lane and item 32 + lane) and the
// warp's masks over the items, bit j for item j (heap order from 1). An
// internal item lies on one of the window's top kLevels levels, so j < 32:
// its masks are one ballot of the lanes' first items.
struct Window {
  int32_t r;            // the heap node it hangs under
  int L, n;             // r's level; its item levels (items 1 .. 2^n - 1)
  int lim;              // items from here on are leaves, or below the window
  float x[2], y;        // (dl, dr) of an internal item, (d2, -) of a leaf
  bool inner, leaf[2];  // item lane's kind; both items' leafness
  uint32_t right;       // internal items whose right child is the nearer
  uint32_t desc, push;  // internal: nearer box < best; farther box < best
  uint64_t better;      // leaves: d2 < best

  // the masks that depend on the best (again whenever the best drops)
  __device__ __forceinline__ void against(float best) {
    desc = __ballot_sync(kFull, inner && fminf(x[0], y) < best);
    push = __ballot_sync(kFull, inner && fmaxf(x[0], y) < best);
    better = (uint64_t)__ballot_sync(kFull, leaf[0] && x[0] < best) |
             ((uint64_t)__ballot_sync(kFull, leaf[1] && x[1] < best) << 32);
  }

  // item j's first value, in every lane
  __device__ __forceinline__ float value(int j) const {
    return __shfl_sync(kFull, j < 32 ? x[0] : x[1], j & 31);
  }

  // the heap subtree under r (at level L): kLevels levels of internal nodes,
  // and the leaves' level too where it comes next (or every level down to
  // the leaves). Item j is heap id r 2^k + j - 2^k at k = level_of(j); the
  // lanes load their items' rows (every load issued before any arithmetic)
  // and compute the child-box or the triangle distances.
  __device__ __forceinline__ void load(
      const float* __restrict__ node_rows, const float* __restrict__ tri_rows,
      int64_t tri_stride, int32_t T2, int depth, int32_t root, float px,
      float py, float pz, int lane) {
    r = root;
    L = level_of(r);
    const int up = depth - L;
    n = up <= kLevels ? up + 1 : kLevels;
    lim = 1 << (up <= kLevels ? up : kLevels);
    float4 a[2], b[2];
    float c[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int j = lane + 32 * s;
      const bool item = j >= 1 && j < (1 << n);
      const int k = level_of(max(j, 1));
      const int32_t g = item ? (r << k) + (j - (1 << k)) : 0;
      leaf[s] = item && g >= T2;
      if (s == 0) inner = item && g < T2;
      if (leaf[s]) {
        const float* row = tri_rows + (int64_t)(g - T2) * tri_stride;
        a[s] = __ldg(reinterpret_cast<const float4*>(row));
        b[s] = __ldg(reinterpret_cast<const float4*>(row) + 1);
        c[s][0] = __ldg(row + 8);
      } else if (s == 0 && inner) {
        const float4* q = reinterpret_cast<const float4*>(node_rows) +
                          4 * (int64_t)g;
        a[s] = __ldg(q);
        b[s] = __ldg(q + 1);
        const float4 t = __ldg(q + 2);
        c[s][0] = t.x; c[s][1] = t.y; c[s][2] = t.z; c[s][3] = t.w;
      }
    }
    x[0] = x[1] = y = 0.f;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (leaf[s]) {
        float4 s0, s1, s2;
        hpsdf::stage_terms(a[s].x, a[s].y, a[s].z, a[s].w, b[s].x, b[s].y,
                           b[s].z, b[s].w, c[s][0], s0, s1, s2);
        x[s] = hpsdf::closest_d2(px, py, pz, s0, s1, s2);
      } else if (s == 0 && inner) {
        x[0] = hpsdf::aabb_d2(px, py, pz, a[0].x, a[0].y, a[0].z, a[0].w,
                              b[0].x, b[0].y);
        y = hpsdf::aabb_d2(px, py, pz, b[0].z, b[0].w, c[0][0], c[0][1],
                           c[0][2], c[0][3]);
      }
    }
    right = __ballot_sync(kFull, inner && !(x[0] <= y));
  }
};

static_assert(2 << kLevels == 64, "a window's items fill two 32-bit masks");

__global__ void __launch_bounds__(32 * kWarps)
bvh_walk_kernel(const float* __restrict__ node_rows,
                const float* __restrict__ tri_rows, int64_t tri_stride,
                int32_t T2, int depth, const float* __restrict__ pts,
                int64_t B, int32_t cap, float* __restrict__ best_d2,
                int32_t* __restrict__ best_idx,
                int32_t* __restrict__ visits) {
  const int lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= B) return;                     // the whole warp
  const float px = pts[3 * i], py = pts[3 * i + 1], pz = pts[3 * i + 2];
  Window w;

  // greedy seed: always into the nearer child, down to one leaf, a window
  // a round
  int32_t cur = 1;
  int j;
  for (;;) {
    w.load(node_rows, tri_rows, tri_stride, T2, depth, cur, px, py, pz,
           lane);
    j = 1;
    while (cur < T2 && j < (1 << w.n)) {
      const int right = (w.right >> j) & 1;
      cur = 2 * cur + right;
      j = 2 * j + right;
    }
    if (cur >= T2) break;                 // the leaf lies in this window
  }
  float best = w.value(j);
  int32_t idx = cur - T2;
  int32_t n_nodes = depth, n_leaves = 1;

  int32_t stack = 0;                      // lane t: entry t
  int sp = 0;
  cur = 1;
  bool fresh = true;                      // cur needs its window
  for (int32_t it = 0;;) {                // visits so far, as the plain loop
    if (fresh) {
      w.load(node_rows, tri_rows, tri_stride, T2, depth, cur, px, py, pz,
             lane);
      w.against(best);
      j = 1;
      fresh = false;
    }
    // descend into the nearer child while its box is nearer than the best,
    // pushing the farther one when its box is too: a visit a step, each a
    // few bit operations on the masks (an internal item has j < lim <= 32)
    if (cur < T2) {
      int steps = 0;
      for (;;) {
        const uint32_t bit = 1u << j;
        if (!(w.desc & bit)) break;       // the nearer box is no nearer
        const int right = (w.right >> j) & 1;
        const bool push = w.push & bit;
        if (push && lane == sp) stack = 2 * cur + 1 - right;
        sp += push;
        cur = 2 * cur + right;
        j = 2 * j + right;
        ++steps;
        if (j >= w.lim || it + steps >= cap) break;
      }
      n_nodes += steps;
      it += steps;
      if (it >= cap) break;
      if (j >= w.lim) {
        if (cur < T2) {                   // below the window
          fresh = true;
          continue;
        }
      } else {
        ++n_nodes;                        // the node it did not descend from
      }
    }
    if (cur >= T2) {                      // a leaf: its triangle
      ++n_leaves;
      if ((w.better >> j) & 1) {
        best = w.value(j);
        idx = cur - T2;
        w.against(best);
      }
    }
    if (sp == 0 || ++it >= cap) break;    // the stack is empty, or the cap
    --sp;                                 // pop
    cur = __shfl_sync(kFull, stack, sp);
    const int k = level_of(cur) - w.L;    // still inside the window?
    fresh = k < 0 || k >= w.n || (cur >> k) != w.r;
    if (!fresh) j = (1 << k) + (cur - (w.r << k));
  }
  if (lane == 0) {
    best_d2[i] = best;
    best_idx[i] = idx;
    if (visits != nullptr) {
      visits[2 * i] = n_nodes;
      visits[2 * i + 1] = n_leaves;
    }
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
  // a walk visits each of the 2 T2 - 1 heap nodes at most once, and at
  // least one as the plain loop does, so a cap clamped into 1 .. 2^31 - 1
  // stops every walk where max_iters does
  const int32_t cap = (int32_t)(max_iters < 1 ? 1
                                : max_iters < INT32_MAX ? max_iters
                                                        : INT32_MAX);
  const int64_t blocks = (B + kWarps - 1) / kWarps;
  bvh_walk_kernel<<<(unsigned)blocks, 32 * kWarps, 0,
                    (cudaStream_t)stream>>>(
      node_rows, tri_rows, tri_stride, (int32_t)T2, depth, pts, B, cap,
      best_d2, best_idx, visits);
  return (int)cudaGetLastError();
}
