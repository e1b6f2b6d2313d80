// K10: the closest triangle per point by the hybrid prune, a block a point.
//
// Replaces the XLA-fused loop _hybrid_closest, hpsdf_tpu/mesh/sdf.py:292-364
// (with _axes_dist2 :261-271, _select_min :274-289 and _axes_dist2_pairs
// :367-375). Same contract:
//   in : node_lo, node_hi f32 (NC, 3), the boxes of the level-1 kd clusters
//        (sdf.cluster_aabbs: the heap level whose nodes cover CS = min(256,
//        T2) leaf rows, FIRST = T2 / CS its first heap id); node_rows f32
//        (>= 8 FIRST, 16); tri_rows f32 (T2, stride >= 9); pts f32 (B, 3);
//        k1, k2 the clusters and subclusters kept
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
// to the lower index (the subclusters indexed in ascending cluster order),
// so a pruned entry is never smaller than a kept one and bound is the
// (k+1)-th smallest value. The box distances round as the plain version's
// (tri.cuh aabb_d2), so both keep the same sets and give the same bound bit
// for bit; best_d2 differs from the plain cascade's only by FMA contraction.
//
// Bound on the H100. Per point the work is NC + 8 k1 box distances (about
// 20 f32 operations each) and k2 SUB triangle cascades (about 50), against
// 12 bytes in, 12 out, the cluster boxes (24 NC bytes, once for all points)
// and the candidate rows: at the reference scale (1,310,720 triangles, NC =
// 8,192, k1 = k2 = 48, SUB = 32) 180k operations and 1,536 rows a point.
// Few points share rows, so the rows' bytes and the operations are of one
// order; chip_smoke.py prices both on the run's points. The selections are
// not arithmetic: they are passes over shared memory. The design:
//   - a block of 256 threads a point; the NC cluster distances go to shared
//     memory (32 KB at NC = 8,192), computed lane-strided from the boxes,
//     which every block reads and which stay in L2;
//   - an exact k-selection over them by a radix select on the float bits
//     (the distances are >= +0, so their bits order as they do): four passes
//     of 8 bits, each a shared histogram filled with warp-aggregated atomics
//     (__match_any_sync: the distances of a pass share few digits) and a
//     block scan that finds the digit holding rank k - 1; then one pass that
//     takes every key below the k-th and, in index order, as many equal to it
//     as rank k - 1 needs, written in ascending index order, and the bound;
//   - the same over the 8 k1 subcluster boxes, read from the kept clusters'
//     grandchild heap rows as float4s;
//   - the threads stride over the k2 SUB candidate rows (consecutive threads
//     on consecutive rows of a subcluster), each row's vertices read as two
//     float4s and a float, P1's cascade, and a block argmin.
// Nothing of the TPU's gather economics carries over: no (B, K SUB, 32)
// gather is materialised.
//
// Numerics. Built without --use_fast_math (the cascade's 1e-30 guards).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tri.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Scratch {
  int hist[256];
  int warp_tot[kWarps];
  float red_f[kWarps];
  int red_i[kWarps];
  int digit, rest;
};

// exclusive prefix sum of v over the block in thread order; *total gets the
// block's sum. Every thread of the block calls it.
__device__ __forceinline__ int block_excl_scan(int v, Scratch& sh,
                                               int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) sh.warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? sh.warp_tot[lane] : 0;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const int y = __shfl_up_sync(kFull, t, off);
      if (lane >= off) t += y;
    }
    if (lane < kWarps) sh.warp_tot[lane] = t;
  }
  __syncthreads();
  const int before = warp > 0 ? sh.warp_tot[warp - 1] : 0;
  *total = sh.warp_tot[kWarps - 1];
  __syncthreads();                  // warp_tot is free again
  return before + x - v;
}

// the smallest of v over the block
__device__ __forceinline__ float block_min(float v, Scratch& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, off));
  if (lane == 0) sh.red_f[warp] = v;
  __syncthreads();
  float m = sh.red_f[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fminf(m, sh.red_f[w]);
  __syncthreads();
  return m;
}

// The k smallest of vals[0, n) (ties to the lower index) into out[0, k) in
// ascending index order; returns the smallest value left out, +inf when
// k >= n (then out holds 0 .. n - 1). Every thread of the block calls it.
__device__ float block_select(const float* vals, int n, int k, int* out,
                              Scratch& sh) {
  const int tid = threadIdx.x;
  if (k >= n) {
    for (int i = tid; i < n; i += kThreads) out[i] = i;
    __syncthreads();
    return INFINITY;
  }
  // radix select of the key of rank k - 1
  unsigned prefix = 0u, mask = 0u;
  int r = k - 1;
  for (int shift = 24; shift >= 0; shift -= 8) {
    sh.hist[tid] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += kThreads) {
      const int i = base + tid;
      unsigned key = 0u;
      bool in = false;
      if (i < n) {
        key = __float_as_uint(vals[i]);
        in = (key & mask) == prefix;
      }
      const int digit = in ? (int)((key >> shift) & 255u) : 256;
      const unsigned peers = __match_any_sync(kFull, digit);
      if (in && (threadIdx.x & 31) == __ffs(peers) - 1)
        atomicAdd(&sh.hist[digit], __popc(peers));
    }
    __syncthreads();
    const int c = sh.hist[tid];
    int unused;
    const int excl = block_excl_scan(c, sh, &unused);
    if (excl <= r && r < excl + c) {
      sh.digit = tid;
      sh.rest = r - excl;
    }
    __syncthreads();
    prefix |= (unsigned)sh.digit << shift;
    mask |= 255u << shift;
    r = sh.rest;
    __syncthreads();
  }
  // prefix is the k-th smallest key; take every smaller key and the first
  // r + 1 equal to it, in index order
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int lt = 0, eq = 0;
  float above = INFINITY;
  for (int i = lo; i < hi; ++i) {
    const unsigned key = __float_as_uint(vals[i]);
    lt += key < prefix;
    eq += key == prefix;
    if (key > prefix) above = fminf(above, vals[i]);
  }
  int eq_total;
  const int eq_before = block_excl_scan(eq, sh, &eq_total);
  const int take_eq = max(0, min(eq, r + 1 - eq_before));
  int n_sel;
  int pos = block_excl_scan(lt + take_eq, sh, &n_sel);
  int taken = 0;
  for (int i = lo; i < hi; ++i) {
    const unsigned key = __float_as_uint(vals[i]);
    if (key < prefix || (key == prefix && taken++ < take_eq)) out[pos++] = i;
  }
  // the smallest left out: the k-th value again if more are equal to it
  const float rest_min = block_min(above, sh);
  __syncthreads();                  // out is complete
  return eq_total > r + 1 ? __uint_as_float(prefix) : rest_min;
}

template <bool kTwo>
__global__ void __launch_bounds__(kThreads)
hybrid_kernel(const float* __restrict__ node_lo,
              const float* __restrict__ node_hi,
              const float* __restrict__ node_rows,
              const float* __restrict__ tri_rows, int64_t tri_stride,
              int nc, int first, int sub, int k1, int k2,
              const float* __restrict__ pts, float* __restrict__ best_d2,
              int32_t* __restrict__ best_idx, float* __restrict__ bound) {
  extern __shared__ float smem[];
  __shared__ Scratch sh;
  const int tid = threadIdx.x;
  const int64_t i = blockIdx.x;
  const float px = pts[3 * i], py = pts[3 * i + 1], pz = pts[3 * i + 2];
  float* d_clu = smem;                            // [nc]
  float* d_sub = d_clu + nc;                      // [8 k1] (two levels)
  int* sel1 = reinterpret_cast<int*>(d_sub + (kTwo ? 8 * k1 : 0));  // [k1]
  int* sel2 = sel1 + k1;                          // [k2] (two levels)

  // 1-2. the clusters
  for (int c = tid; c < nc; c += kThreads) {
    const float* l = node_lo + 3 * c;
    const float* h = node_hi + 3 * c;
    d_clu[c] = hpsdf::aabb_d2(px, py, pz, __ldg(l), __ldg(l + 1), __ldg(l + 2),
                              __ldg(h), __ldg(h + 1), __ldg(h + 2));
  }
  __syncthreads();
  float bnd = block_select(d_clu, nc, k1, sel1, sh);

  // 3. the subclusters of the kept clusters
  int n_blocks = k1;
  if (kTwo) {
    for (int q = tid; q < 8 * k1; q += kThreads) {
      const int64_t row = 4 * (int64_t)(first + sel1[q >> 3]) + ((q & 7) >> 1);
      const float4* r = reinterpret_cast<const float4*>(node_rows + 16 * row);
      float d;
      if ((q & 1) == 0) {                 // lanes 0..5: the left child
        const float4 a = __ldg(r), b = __ldg(r + 1);
        d = hpsdf::aabb_d2(px, py, pz, a.x, a.y, a.z, a.w, b.x, b.y);
      } else {                            // lanes 6..11: the right child
        const float4 b = __ldg(r + 1), c = __ldg(r + 2);
        d = hpsdf::aabb_d2(px, py, pz, b.z, b.w, c.x, c.y, c.z, c.w);
      }
      d_sub[q] = d;
    }
    __syncthreads();
    bnd = fminf(bnd, block_select(d_sub, 8 * k1, k2, sel2, sh));
    n_blocks = k2;
  }

  // 4. every row of the kept (sub)clusters
  float best = INFINITY;
  int32_t idx = INT32_MAX;
  const int total = n_blocks * sub;
  for (int q = tid; q < total; q += kThreads) {
    const int b = q / sub;
    int blk;
    if (kTwo) {
      const int s = sel2[b];
      blk = 8 * sel1[s >> 3] + (s & 7);
    } else {
      blk = sel1[b];
    }
    const int32_t row = blk * sub + (q - b * sub);
    const float d2 = hpsdf::row_d2(px, py, pz, tri_rows + row * tri_stride);
    if (d2 < best || (d2 == best && row < idx)) {
      best = d2;
      idx = row;
    }
  }
  const int lane = tid & 31, warp = tid >> 5;
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
    sh.red_f[warp] = best;
    sh.red_i[warp] = idx;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) {
      const float ob = sh.red_f[w];
      const int32_t oi = sh.red_i[w];
      if (ob < best || (ob == best && oi < idx)) {
        best = ob;
        idx = oi;
      }
    }
    best_d2[i] = best;
    best_idx[i] = idx;
    bound[i] = bnd;
  }
}

}  // namespace

// Shared memory a block of K10 needs, in bytes: nc + 8 k1 floats (two
// levels) and k1 + k2 ints, k1 and k2 already clipped (k1 <= nc, k2 <= 8 k1).
extern "C" int64_t hpsdf_hybrid_smem(int64_t nc, int64_t k1, int64_t k2,
                                     int two_level) {
  return 4 * (nc + (two_level ? 8 * k1 + k1 + k2 : k1));
}

// K10 over B points; k1 <= nc, and k2 <= 8 k1 with two levels.
extern "C" int hpsdf_hybrid(const float* node_lo, const float* node_hi,
                            const float* node_rows, const float* tri_rows,
                            int64_t tri_stride, int64_t nc, int64_t first,
                            int64_t sub, int64_t k1, int64_t k2,
                            int two_level, const float* pts, int64_t B,
                            float* best_d2, int32_t* best_idx, float* bound,
                            void* stream) {
  const int64_t smem = hpsdf_hybrid_smem(nc, k1, k2, two_level);
  const void* fn = two_level ? (const void*)hybrid_kernel<true>
                             : (const void*)hybrid_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (two_level) {
    hybrid_kernel<true><<<(unsigned)B, kThreads, smem,
                          (cudaStream_t)stream>>>(
        node_lo, node_hi, node_rows, tri_rows, tri_stride, (int)nc,
        (int)first, (int)sub, (int)k1, (int)k2, pts, best_d2, best_idx,
        bound);
  } else {
    hybrid_kernel<false><<<(unsigned)B, kThreads, smem,
                           (cudaStream_t)stream>>>(
        node_lo, node_hi, node_rows, tri_rows, tri_stride, (int)nc,
        (int)first, (int)sub, (int)k1, (int)k2, pts, best_d2, best_idx,
        bound);
  }
  return (int)cudaGetLastError();
}
