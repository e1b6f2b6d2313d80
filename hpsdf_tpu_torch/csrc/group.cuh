// Grouping by destination row before adding, shared by the backward kernels
// G's backward (row_gather.cu) and K7 (packed_grad.cu).
//
// Both add, per item (an index of a row gather, a point of a packed read),
// values into one row of a table. Adding with one float atomic per value
// serialises where many items share a row and costs an atomic per value
// where they do not, and the table has to be zeroed first. Here the items
// are first sorted by their destination row with a counting sort; then
// each row's sum is formed from its items in their sorted order.
//
// The counting sort runs inside one cooperative launch (all blocks
// resident, cudaLaunchCooperativeKernel), its phases separated by grid-wide
// barriers:
//   0. zero the K counters and the cursor (and whatever the caller clears
//      there);
//   1. each item's key (its destination row, -1 for none), and the counts,
//      one atomic per key a warp holds (the lanes sharing a key add their
//      count through one leader). The counters can lie a stride apart: a
//      few thousand keys packed into a few hundred cache lines serialise
//      their atomics on those lines;
//   2. each key's run of places: a warp scans the counts of 32 keys and
//      takes their runs from a cursor with one atomic, so the runs follow
//      each other in no particular order of keys;
//   3. placement: each item's place, handed to the caller, the lanes of a
//      warp sharing a key again taking one atomic and their ranks among
//      themselves.
// After that, key k's items hold the places [start(k), end(k)). Which warp
// reaches a key first decides the order within the key, so sums over a
// key's items are taken in an order that can change from launch to launch.
//
// The counters' layout is this file's: a caller sizes its scratch with
// group_ints(K) and passes counter_stride(K) to its kernel as an argument
// (or group_ints(K, cs) with cs = counter_stride(K, B)).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hpsdf {

// Up to kPadKeys keys, each counter has a cache line of its own.
constexpr int kCounterStride = 32;
constexpr int64_t kPadKeys = 1 << 16;

__host__ __device__ inline int counter_stride(int64_t K) {
  return K <= kPadKeys ? kCounterStride : 1;
}

// The stride that follows the batch (K7's form 2): a line a counter
// only where B items crowd K keys, kCrowd or more a key; where they are
// sparser the counters lie packed, so that the memory zeroed and scanned
// for them is 4 B a key, not 128.
constexpr int64_t kCrowd = 4;

__host__ __device__ inline int counter_stride(int64_t K, int64_t B) {
  return B >= kCrowd * K ? counter_stride(K) : 1;
}

// The ints of scratch group_by_key takes for K keys with counters cs ints
// apart (the counters, each key's first place, the cursor), or -1 where
// they do not fit 32-bit indices.
inline int64_t group_ints(int64_t K, int cs) {
  const int64_t n = ((int64_t)cs + 1) * K + 1;
  return K < 1 || n >= INT32_MAX ? -1 : n;
}

inline int64_t group_ints(int64_t K) {
  return group_ints(K, counter_stride(K));
}

// Where the items of each key lie once group_by_key returns.
struct Groups {
  const int* beg;      // each key's first place
  const int* cnt;      // each key's end, cs ints apart
  int cs;

  __device__ __forceinline__ int start(int64_t k) const {
    return __ldcg(beg + k);
  }
  __device__ __forceinline__ int end(int64_t k) const {
    return __ldcg(cnt + k * cs);
  }
};

// Sort the items 0..B-1 by key_of(b) in [0, K) (-1: left out), across
// every block of a cooperative launch of THREADS threads a block: place(b,
// pos, k) is called once for each item b of key k >= 0 with its place pos
// in the order. prep(i, n) is called in phase 0 by each thread i of the
// launch's n, to clear the caller's memory. keys: B ints of scratch where
// key_of is worth storing between phases 1 and 3, or nullptr to call it
// again; cnt: K counters cs ints apart, cs = counter_stride(K), then beg:
// K + 1 ints (group_ints(K) ints in all, from cnt). B < 2^31,
// group_ints(K) > 0.
template <int THREADS, class KeyOf, class Prep, class Place>
__device__ Groups group_by_key(int64_t B, int K, KeyOf key_of, int* keys,
                               int* cnt, int cs, int* beg, Prep prep,
                               Place place) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  // the first item of this thread's warp; warps step together so that
  // every lane reaches the warp-wide matches
  const int64_t warp0 = (int64_t)blockIdx.x * THREADS + (threadIdx.x & ~31);

  for (int64_t k = warp0 + lane; k < K; k += stride) cnt[k * cs] = 0;
  if (warp0 + lane == 0) beg[K] = 0;                 // the cursor
  prep(warp0 + lane, stride);
  grid.sync();

  // 1. keys and counts
  for (int64_t b0 = warp0; b0 < B; b0 += stride) {
    const int64_t b = b0 + lane;
    const int k = b < B ? key_of(b) : -1;
    if (keys != nullptr && b < B) keys[b] = k;
    const unsigned peers = __match_any_sync(0xffffffffu, k);
    if (k >= 0 && (__ffs(peers) - 1) == lane)
      atomicAdd(cnt + (int64_t)k * cs, __popc(peers));
  }
  grid.sync();

  // 2. runs: each counter becomes its key's first place
  for (int64_t k0 = warp0; k0 < K; k0 += stride) {
    const int64_t k = k0 + lane;
    const int c = k < K ? __ldcg(cnt + k * cs) : 0;
    int x = c;                                       // inclusive scan
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    int at = 0;
    if (lane == 31 && x > 0) at = atomicAdd(beg + K, x);
    at = __shfl_sync(0xffffffffu, at, 31) + x - c;
    if (k < K) beg[k] = at, cnt[k * cs] = at;
  }
  grid.sync();

  // 3. placement
  for (int64_t b0 = warp0; b0 < B; b0 += stride) {
    const int64_t b = b0 + lane;
    int k = -1;
    if (b < B) k = keys != nullptr ? keys[b] : key_of(b);
    const unsigned peers = __match_any_sync(0xffffffffu, k);
    const int leader = __ffs(peers) - 1;
    int at = 0;
    if (k >= 0 && leader == lane)
      at = atomicAdd(cnt + (int64_t)k * cs, __popc(peers));
    at = __shfl_sync(0xffffffffu, at, leader);
    if (k >= 0) place(b, at + __popc(peers & ((1u << lane) - 1u)), k);
  }
  grid.sync();
  return Groups{beg, cnt, cs};
}

// The most blocks of THREADS threads of `kernel` that can all be resident,
// up to per_sm a multiprocessor: the grid of a cooperative launch. Cached
// per kernel (one kind of device a process).
template <class Kernel>
inline int group_grid(Kernel kernel, int threads, int per_sm, int* cache) {
  if (*cache > 0) return *cache;
  int dev = 0, sms = 0, fit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, threads,
                                                    0) != cudaSuccess)
    return 0;
  *cache = sms * (fit < per_sm ? fit : per_sm);
  return *cache;
}

}  // namespace hpsdf
