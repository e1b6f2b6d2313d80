// K10: the closest triangle per point by the hybrid prune, a warp a point.
//
// Replaces the XLA-fused loop _hybrid_closest, hpsdf_tpu/mesh/sdf.py:292-364
// (with _axes_dist2 :261-271, _select_min :274-289 and _axes_dist2_pairs
// :367-375). Same contract:
//   in : node_lo, node_hi f32 (NC, 3), the boxes of the level-1 kd clusters
//        (sdf.cluster_aabbs: the heap level whose nodes cover CS = min(256,
//        T2) leaf rows, FIRST = T2 / CS = NC its first heap id); node_rows
//        f32 (>= 8 FIRST, 16); tri_rows f32 (T2, stride >= 9: the packed
//        rows or BVH.vertex_rows); pts f32 (B, 3); k1, k2 the clusters and
//        subclusters kept
//   out: best_d2 f32[B], best_idx i32[B] (a row of tri_rows), bound f32[B]
// Per point:
//   1. the squared distance to each of the NC cluster boxes;
//   2. the k1 smallest (all when k1 >= NC) and bound1, the smallest of the
//      rest (+inf when none is left);
//   3. two levels (CS >= 8): the distances to the 8 subclusters of each kept
//      cluster c (the boxes of heap rows 4 (FIRST + c) .. +3, two a row,
//      subcluster 8 c + j covering rows (8 c + j) SUB .. +SUB, SUB = CS / 8),
//      the k2 smallest of those and bound2; one level: the kept clusters'
//      CS rows each;
//   4. P1's distance (tri.cuh) to every row of the kept (sub)clusters, and
//      the smallest, the lowest row on ties.
// bound = min(bound1, bound2) is the exact minimum over every pruned box,
// so max(0, sqrt(best_d2) - sqrt(bound)) bounds the distance's error
// (sdf._dist_err_bound). Selection is exact: the k smallest by value, ties
// to the lower index (subcluster 8 c + j: ascending cluster order), so a
// pruned entry is never smaller than a kept one and bound is the (k+1)-th
// smallest value. The box distances round as the plain version's (tri.cuh
// aabb_d2), so both keep the same sets and give the same bound bit for bit;
// best_d2 differs from the plain cascade's only by FMA contraction.
//
// Design on the H100. A key is 64 bits, (distance bits, index): distances
// are >= +0, so the keys order as (value, lower index), the plain order.
//   - a block of W <= 8 warps takes W consecutive points of the batch, a
//     warp a point; after the first barrier no warp waits for another;
//   - the NC clusters fall into NCH <= 256 chunks of G = NC / NCH
//     consecutive clusters, chunk j the subtree of heap node NCH + j, whose
//     box its parent's row holds. The block stages the NCH chunk boxes in
//     shared memory once for its W points, and each warp takes its point's
//     distance to every chunk. A box contains its descendants' boxes (the
//     BVH's unions, bit for bit) and aabb_d2 does not decrease when a box
//     shrinks, so a chunk's distance is a lower bound of every key in it;
//   - the warp visits its chunks nearest first (a warp min over the chunk
//     distances) and stops at the first one above its threshold, a lane a
//     cluster distance of the chunk;
//   - the warp's candidates are a list in shared memory: a key joins (a
//     ballot gives its slot) only below the threshold, the (k+1)-th
//     smallest key of the list when it was last compacted; a compaction (a
//     bitonic sort of the list by the warp, any length) keeps the k+1
//     smallest. A list holds min(2 (k+1), n + 32) keys rounded up to a power
//     of two; where 8 such warps do not fit in a block's shared memory the
//     block takes fewer, and where one does not, its lists shrink toward
//     k + 33 keys (sdf._hybrid_shape), so every width whose lists of k + 33
//     keys fit one warp runs, compacting more often. A key
//     at or above the threshold ranks after k + 1 kept keys, so it is never
//     needed, whatever the ties: the selection has no overflow case. A last
//     sort puts the kept keys first in ascending order; key k's distance is
//     the bound;
//   - the subclusters: the kept clusters in ascending key order, 4 a round
//     (a lane a subcluster, its box from the grandchild row as float4s),
//     into a second list the same way; a round whose first cluster lies
//     above the threshold ends the stage (a subcluster's box lies inside its
//     cluster's);
//   - the lanes take the k2 SUB candidate rows 32 x kRounds at a time, the
//     kept blocks nearest box first (consecutive lanes on consecutive rows
//     of a subcluster), P1's cascade, and a warp argmin, lowest row on
//     ties. The rows stop at a box farther than the best row so far by
//     more than the rounding of both distances (kReach): a box holds its
//     rows' triangles, so no row there or in a farther box could come below
//     the best in the plain scan. best_d2 and the index are the full
//     scan's, up to the FMA contraction the cascade already differs by.
// The main path passes the BVH's vertex_rows, the rows' lanes 0..11 in 48
// bytes, as tri_rows: 32 rows of a subcluster then lie in twelve whole 128-byte
// lines, where 128-byte packed rows cost two 32-byte sectors each for the
// 36 bytes read. Results are the same on either.
// What this does about the earlier form's time (k10_forms.py at c73896f: a
// block a point, 8,192 cluster distances a point read from L2 0.22 ms, a
// radix select with a bank-conflicted compaction 0.80 ms, the cascade 0.21
// ms at 10,240 points on 1.31M triangles): the boxes a point reads fall to
// the chunks it visits (8 of 256 at uniform points), the selections sort
// lists of about a hundred keys, no block barrier waits on the slowest
// point, and a point near the surface scans a few of its 48 subclusters.
// What bounds it now: the bytes a point reads from L2 (about 1,370 rows a
// point away from the surface, the kept clusters' subcluster rows, the
// visited clusters); for points in random order the rows come from device
// memory. The selections' sorts run beside them. PERF.md §6 has the split
// (chip_smoke.py's [mesh scale]).
//
// Timing forms: chip_smoke.py compiles this source alone with
// HPSDF_K10_STAGE 1 (stop after the cluster selection) or 2 (after the
// subcluster selection); 3, the default, is the kernel.
//
// Numerics. Built without --use_fast_math (the cascade's 1e-30 guards).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tri.cuh"

#ifndef HPSDF_K10_STAGE
#define HPSDF_K10_STAGE 3
#endif

namespace {

constexpr int kMaxWarps = 8;              // points a block at most
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kDone = 0xffffffffu;   // a visited chunk
constexpr uint64_t kNone = ~0ull;         // above every key
// the rounding allowed for a point-box and a point-triangle distance, of the
// coordinates' scale 1 + |px| + |py| + |pz|: the f32 box distance and P1's
// cascade each round within a few ulps of it
constexpr float kReach = 1e-5f;
constexpr int kRounds = 2;                // cascade rounds between stops

__device__ __forceinline__ uint64_t make_key(float d, unsigned idx) {
  return ((uint64_t)__float_as_uint(d) << 32) | idx;
}

__device__ __forceinline__ unsigned key_bits(uint64_t key) {
  return (unsigned)(key >> 32);
}

__device__ __forceinline__ uint64_t umin64(uint64_t a, uint64_t b) {
  return b < a ? b : a;
}

// a[0, n) in ascending order, by the whole warp, in place: a bitonic
// network over the next power of two whose merges all run ascending (the
// first step of each mirrors the block), so the virtual entries past n are
// +inf that no comparator moves, and the list needs no more than n keys
__device__ void warp_sort(uint64_t* a, int n) {
  const int lane = threadIdx.x & 31;
  int len = 32;
  while (len < n) len <<= 1;
  for (int size = 2; size <= len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = lane; p < (len >> 1); p += 32) {
        const int i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
        const int j = stride == size >> 1 ? i ^ (size - 1) : i + stride;
        if (j < n) {
          const uint64_t x = a[i], y = a[j];
          if (x > y) {
            a[i] = y;
            a[j] = x;
          }
        }
      }
      __syncwarp();
    }
  }
}

// A warp's candidate keys. cap - 32 >= k + 1, or cap - 32 >= the keys
// the list is ever offered (then it never compacts).
struct List {
  uint64_t* a;
  int cap, k, count;
  uint64_t thr;       // a key joins only below it; kNone before a compaction
  bool sorted;        // nothing joined since the last sort
};

// each lane offers one key (valid lanes); the warp calls it together
__device__ __forceinline__ void list_push(List& L, bool valid, uint64_t key) {
  const int lane = threadIdx.x & 31;
  const bool take = valid && key < L.thr;
  const unsigned m = __ballot_sync(kFull, take);
  if (take) L.a[L.count + __popc(m & ((1u << lane) - 1u))] = key;
  L.count += __popc(m);
  L.sorted = L.sorted && m == 0u;
  if (L.count > L.cap - 32 || (L.thr == kNone && L.count > L.k)) {
    __syncwarp();
    warp_sort(L.a, L.count);
    L.count = L.k + 1;
    L.thr = L.a[L.k];
    L.sorted = true;
  }
}

// sorts the list and keeps its k smallest (all when it holds k or fewer);
// returns the (k+1)-th smallest key's distance, +inf when there is none
__device__ __forceinline__ float list_finish(List& L) {
  __syncwarp();
  if (!L.sorted) warp_sort(L.a, L.count);
  const float b = L.count > L.k ? __uint_as_float(key_bits(L.a[L.k]))
                                : INFINITY;
  L.count = min(L.count, L.k);
  return b;
}

template <bool kTwo>
__global__ void __launch_bounds__(32 * kMaxWarps)
hybrid_kernel(const float* __restrict__ node_lo,
              const float* __restrict__ node_hi,
              const float* __restrict__ node_rows,
              const float* __restrict__ tri_rows, int64_t tri_stride,
              int nc, int sub, int k1, int k2, int nch, int cap1, int cap2,
              const float* __restrict__ pts, int64_t B,
              float* __restrict__ best_d2, int32_t* __restrict__ best_idx,
              float* __restrict__ bound, int32_t* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  uint64_t* lists = reinterpret_cast<uint64_t*>(smem);  // [warps][cap1+cap2]
  float* box = reinterpret_cast<float*>(lists + warps * (cap1 + cap2));
  unsigned* chunk_keys = reinterpret_cast<unsigned*>(box + 6 * nch);

  // the chunk boxes (lo xyz, hi xyz, a row of nch each), once a block
  if (nch > 1) {
    for (int j = threadIdx.x; j < nch; j += blockDim.x) {
      const int node = nch + j;
      const float* r = node_rows + 16 * (int64_t)(node >> 1) + 6 * (node & 1);
#pragma unroll
      for (int e = 0; e < 6; ++e) box[e * nch + j] = __ldg(r + e);
    }
  }
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * warps + warp;
  if (i >= B) return;
  const float px = pts[3 * i], py = pts[3 * i + 1], pz = pts[3 * i + 2];

  // 1. the chunks' distances, a lower bound of their clusters'
  unsigned* ck = chunk_keys + warp * nch;
  uint64_t lmin = kNone;             // this lane's nearest unvisited chunk
  for (int j = lane; j < nch; j += 32) {
    const float d = nch > 1
        ? hpsdf::aabb_d2(px, py, pz, box[j], box[nch + j], box[2 * nch + j],
                         box[3 * nch + j], box[4 * nch + j], box[5 * nch + j])
        : 0.f;
    ck[j] = __float_as_uint(d);
    lmin = umin64(lmin, make_key(d, j));
  }

  // 2. the chunks nearest first, while one may hold a key below the
  // threshold; a lane a cluster
  List L1{lists + warp * (cap1 + cap2), cap1, k1, 0, kNone, true};
  const int g = nc / nch;
  int n_chunks = 0, n_clusters = 0, n_subclusters = 0;
  for (;;) {
    uint64_t m = lmin;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = umin64(m, __shfl_xor_sync(kFull, m, off));
    if (key_bits(m) == kDone || key_bits(m) > key_bits(L1.thr)) break;
    const int j = (int)(unsigned)m;
    if ((j & 31) == lane) {          // the owner marks it and finds its next
      ck[j] = kDone;
      lmin = kNone;
      for (int q = lane; q < nch; q += 32)
        if (ck[q] != kDone) lmin = umin64(lmin, ((uint64_t)ck[q] << 32) | q);
    }
    ++n_chunks;
    n_clusters += g;
    for (int c0 = j * g; c0 < (j + 1) * g; c0 += 32) {
      const int c = c0 + lane;
      const bool valid = c < (j + 1) * g;
      float d = 0.f;
      if (valid) {
        const float* l = node_lo + 3 * c;
        const float* h = node_hi + 3 * c;
        d = hpsdf::aabb_d2(px, py, pz, __ldg(l), __ldg(l + 1), __ldg(l + 2),
                           __ldg(h), __ldg(h + 1), __ldg(h + 2));
      }
      list_push(L1, valid, make_key(d, c));
    }
  }
  float bnd = list_finish(L1);
  const uint64_t* kept = L1.a;       // ascending keys
  int n_kept = L1.count;
  if (HPSDF_K10_STAGE == 1) {
    if (lane == 0) {
      best_d2[i] = bnd;
      best_idx[i] = (int32_t)(unsigned)kept[n_kept - 1];
      bound[i] = bnd;
    }
    return;
  }

  // 3. the subclusters of the kept clusters, nearest cluster first
  if (kTwo) {
    List L2{L1.a + cap1, cap2, k2, 0, kNone, true};
    const int64_t first = nc;
    for (int t = 0; 4 * t < n_kept; ++t) {
      if (key_bits(kept[4 * t]) > key_bits(L2.thr)) break;
      const int pos = 4 * t + (lane >> 3);
      const bool valid = pos < n_kept;
      n_subclusters += min(32, 8 * (n_kept - 4 * t));
      uint64_t key = kNone;
      if (valid) {
        const unsigned c = (unsigned)kept[pos];
        const int s = lane & 7;
        const int64_t row = 4 * (first + c) + (s >> 1);
        const float4* r =
            reinterpret_cast<const float4*>(node_rows + 16 * row);
        float d;
        if ((s & 1) == 0) {                 // lanes 0..5: the left child
          const float4 a = __ldg(r), b = __ldg(r + 1);
          d = hpsdf::aabb_d2(px, py, pz, a.x, a.y, a.z, a.w, b.x, b.y);
        } else {                            // lanes 6..11: the right child
          const float4 b = __ldg(r + 1), e = __ldg(r + 2);
          d = hpsdf::aabb_d2(px, py, pz, b.z, b.w, e.x, e.y, e.z, e.w);
        }
        key = make_key(d, 8 * c + s);
      }
      list_push(L2, valid, key);
    }
    bnd = fminf(bnd, list_finish(L2));
    kept = L2.a;
    n_kept = L2.count;
  }
  if (HPSDF_K10_STAGE == 2) {
    if (lane == 0) {
      best_d2[i] = bnd;
      best_idx[i] = (int32_t)(unsigned)kept[n_kept - 1];
      bound[i] = bnd;
    }
    return;
  }

  // 4. the rows of the kept (sub)clusters, nearest box first, 32 x kRounds
  // at a time; they stop at a box farther than the best row so far by more
  // than the rounding of both distances (kReach of the coordinates'
  // scale): a box holds its rows' triangles, so no row in it or in any
  // farther box can come below the best row in the plain scan
  const float reach = kReach * (1.f + fabsf(px) + fabsf(py) + fabsf(pz));
  float best = INFINITY, round_best = INFINITY;
  int32_t idx = INT32_MAX;
  const int log_sub = __ffs(sub) - 1;          // sub is a power of two
  const int total = n_kept << log_sub;
  int q0 = 0;
  for (; q0 < total; q0 += 32 * kRounds) {
    const float r = sqrtf(round_best) + reach;
    if (__uint_as_float(key_bits(kept[q0 >> log_sub])) > r * r) break;
    float d2[kRounds];
    int32_t row[kRounds];
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {   // the rows' loads all in flight
      const int q = q0 + 32 * u + lane;
      row[u] = -1;
      if (q < total) {
        row[u] = ((int32_t)(unsigned)kept[q >> log_sub] << log_sub)
                 + (q & (sub - 1));
        d2[u] = hpsdf::row_d2(px, py, pz, tri_rows + row[u] * tri_stride);
      }
    }
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      if (row[u] >= 0 && (d2[u] < best || (d2[u] == best && row[u] < idx))) {
        best = d2[u];
        idx = row[u];
      }
    }
    round_best = best;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      round_best = fminf(round_best, __shfl_xor_sync(kFull, round_best, off));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int32_t oi = __shfl_xor_sync(kFull, idx, off);
    if (ob < best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  if (lane == 0) {
    best_d2[i] = best;
    best_idx[i] = idx;
    bound[i] = bnd;
    if (stats != nullptr) {
      int32_t* st = stats + 4 * i;
      st[0] = n_chunks;
      st[1] = n_clusters;
      st[2] = n_subclusters;
      st[3] = min(q0, total);
    }
  }
}

}  // namespace

// K10 over B points; nc = first (node_lo is cluster_aabbs'), nc a power of
// two, k1 <= nc, and k2 <= 8 k1 with two levels. The launch's shape is the
// wrapper's (sdf._hybrid_shape): nch chunks, warps points a block, lists of
// cap1 and cap2 keys, smem bytes of shared memory a block. stats (B, 4) or
// null: a point's chunks visited, cluster and subcluster distances taken,
// rows scanned.
extern "C" int hpsdf_hybrid(const float* node_lo, const float* node_hi,
                            const float* node_rows, const float* tri_rows,
                            int64_t tri_stride, int64_t nc, int64_t first,
                            int64_t sub, int64_t k1, int64_t k2,
                            int two_level, int64_t nch, int64_t warps,
                            int64_t cap1, int64_t cap2, int64_t smem,
                            const float* pts, int64_t B, float* best_d2,
                            int32_t* best_idx, float* bound, int32_t* stats,
                            void* stream) {
  auto fits = [](int64_t cap, int64_t k, int64_t n) {
    return cap - 32 >= (k + 1 < n ? k + 1 : n);
  };
  if (first != nc || (nc & (nc - 1)) != 0 || nch < 1 || nc % nch != 0 ||
      warps < 1 || warps > kMaxWarps || !fits(cap1, k1, nc) ||
      (two_level && !fits(cap2, k2, 8 * k1)) ||
      smem < 8 * warps * (cap1 + cap2) + 4 * warps * nch + 24 * nch)
    return (int)cudaErrorInvalidValue;
  const void* fn = two_level ? (const void*)hybrid_kernel<true>
                             : (const void*)hybrid_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((B + warps - 1) / warps);
  const unsigned threads = (unsigned)(32 * warps);
  if (two_level) {
    hybrid_kernel<true><<<blocks, threads, smem, (cudaStream_t)stream>>>(
        node_lo, node_hi, node_rows, tri_rows, tri_stride, (int)nc,
        (int)sub, (int)k1, (int)k2, (int)nch, (int)cap1, (int)cap2, pts, B,
        best_d2, best_idx, bound, stats);
  } else {
    hybrid_kernel<false><<<blocks, threads, smem, (cudaStream_t)stream>>>(
        node_lo, node_hi, node_rows, tri_rows, tri_stride, (int)nc,
        (int)sub, (int)k1, (int)k2, (int)nch, (int)cap1, (int)cap2, pts, B,
        best_d2, best_idx, bound, stats);
  }
  return (int)cudaGetLastError();
}
