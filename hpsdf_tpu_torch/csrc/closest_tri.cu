// P1: exact closest triangle per point, by a tiled scan over the triangles
// that skips empty tiles and, for each block of points, the tiles that
// provably hold no winner.
//
// Replaces the Pallas TPU kernel closest_tri_tiles,
// hpsdf_tpu/mesh/pallas_sdf.py:155-207 (_call_kernel / _kernel /
// _closest_d2). Same contract:
//   in : tri_rows f32 (T, stride >= 9), lanes 0..8 = vertices a, b, c;
//        pts f32 (B, 3)
//   out: best_d2 f32[B]  squared distance to the closest triangle
//        best_idx i32[B] its row, lowest index on ties, clipped to [0, T-1]
// The result is what a full ascending scan with a strict '<' gives.
//
// Bound on the H100. Per point-triangle pair the cascade below does about
// 50 f32 operations (p - a 3, d1 and d2 10, d3..d6 4, va vb vc 9, the
// region's denominator and two divisions 4, p - q 12, |p - q|^2 5, the
// compare 1; an FMA counted as two, predicates and selects not counted)
// and reads nothing from device memory but the staged tiles, which stay in
// L2. At the card's 67 TFLOP/s f32 outside the tensor cores a dense scan of
// 2^20 points over icosphere(0.3, 5)'s 20,480 triangles needs
// 2^20 * 20,480 * 50 / 67e12 s = 16.0 ms: P1 is bound by operations. With
// the cull the work a batch needs is the pairs of the tiles each block
// scans; the kernel writes each block's count of tiles and rows scanned to
// `visits`, from which chip_smoke.py prices that bound. The design, step by
// step:
//
//  1. Tile table (tiles_sdf.tile_boxes). The rows are read in tiles of
//     kTile. Each tile has a count of rows to scan (its last row that is not
//     padding, plus one) and the box of its real rows. Empty tiles are never
//     loaded; a tile's loop ends after its last real row. A padding row
//     inside that prefix is scanned and never wins (1e30 squared overflows
//     to +inf against a strict '<').
//  2. Register blocking and staged terms. A thread carries kPPT = 2 points,
//     a block kBlockPts. stage_rows, launched once per set of rows
//     (tiles_sdf.tile_table), stages every row as (a, ab, ac, |ab|^2, ab.ac,
//     |ac|^2), twelve floats that three 16-byte shared-memory loads bring to
//     every thread; d3..d6 then follow from d1 and d2 by one subtraction
//     each. The staging and the cascade live in tri.cuh, which K10 and K11
//     share: Ericson's cascade (RTCD 5.1.5) as in _closest_d2, six region
//     predicates, the first true one wins, a division only in the region
//     taken. Most pairs are far, in a vertex region, and divide nothing. A
//     division is __fdividef (within 2 ulp, no flush to zero: the 1e-30
//     guards keep their meaning).
//  3. Asynchronous tile loads. Tiles are double-buffered in shared memory
//     and filled with cp.async: tile k+1 loads while tile k is scanned. A
//     tile is 12 KB against 256 x 256 pairs of work, so this hides little.
//  4. Block-level tile cull (argument cull; 0 only to time the dense scan).
//     A block reduces its live points to their box, picks the non-empty
//     tile whose box's farthest corner is nearest that box (a bound on every
//     point's distance to the tile; the lowest index on ties), scans it, and
//     takes u, the largest of its points' best d2 there. Then every point's
//     best is reset to +inf and the non-empty tiles are scanned in ascending
//     order with the strict '<', the seed tile always, another only if it
//     passes the skip test (tile_skip in tiles_sdf.py, mirrored line for
//     line in tile_skipped):
//         skip  iff  bd2 > lim^2,   lim = sqrt(u) (1 + r) + r S,
//     bd2 the squared distance between the two boxes, S the largest
//     coordinate magnitude of the two boxes, r = kCullRel = 2^-12.
//
// Why the cull is exact. Let p be a point of the block and t a triangle of
// a skipped tile, eps = 2^-24. The box corners are exact floats, so the
// computed bd2 is within (1 + 4 eps) of the exact squared box distance
// delta^2, and delta <= dist(p, t). The cascade's closest point q lies in
// the triangle up to a few eps S for a triangle that is not a sliver, and
// |p - q|^2 adds three roundings, so the computed d2(p, t) is at least
// ((delta - 14 eps S)(1 - 2 eps))^2. With bd2 > lim^2 that is more than
// (sqrt(u) (1 + r/2))^2 > u, since r = 2^-12 exceeds the rounding terms
// (14 eps, 6 eps, and the 2 ulp of __fdividef) by a factor above 100; the
// same slack covers an ulp of difference between the seed scan's and the
// full scan's d2 of one pair.
// The full scan visits the seed tile, so every point ends with a best of at
// most u. A skipped triangle therefore has d2 > u >= best: it could neither
// win nor tie, and removing it leaves the minimum and its lowest index
// unchanged. A sliver (smallest altitude below 2^-10 of its longest edge)
// divides by a near-zero |ab x ac|^2 in the face region, and its q can
// leave the triangle by more than r S: tile_boxes gives its tile the
// unbounded box, which is never skipped. The reset to +inf keeps the rule
// that the lowest index wins: the result is that of the ascending scan over
// the visited tiles, which holds every triangle that can win or tie, so it
// equals the dense scan's bit for bit (chip_smoke.py checks this on the
// fit's whole batch).
//
// Numerics. Built without --use_fast_math: the cascade divides by guards of
// 1e-30 that flush-to-zero would break. nvcc contracts a*b+c into FMA, so
// at boundaries between regions a predicate can flip against the plain
// torch version; the feature changes there, the distance does not (the
// closest point is continuous across region boundaries). The skip test is
// written with __f*_rn intrinsics, so it rounds as its torch mirror does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tri.cuh"

namespace {

constexpr int kTile = 256;        // rows per tile (tiles_sdf.TILE)
constexpr int kBlockPts = 256;    // points per block (tiles_sdf.BLOCK_PTS)
constexpr int kPPT = 2;           // points per thread
constexpr int kThreads = kBlockPts / kPPT;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 12;        // staged floats per row (tiles_sdf.STAGE)
constexpr float kCullRel = 0x1p-12f;   // tiles_sdf.CULL_REL

using hpsdf::closest_d2;

// rows -> (a, ab, ac, |ab|^2, ab.ac, |ac|^2)
__global__ void stage_rows(const float* __restrict__ rows, int64_t T,
                           int64_t stride, float* __restrict__ staged) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= T) return;
  const float* v = rows + r * stride;
  float4* s = reinterpret_cast<float4*>(staged + r * kStage);
  hpsdf::stage_terms(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8],
                     s[0], s[1], s[2]);
}

// squared distance between the block's box and tile box bx (tiles_sdf._box_d2)
__device__ __forceinline__ float box_d2(const float* lo, const float* hi,
                                        const float* bx) {
  float g[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    g[a] = fmaxf(fmaxf(__fsub_rn(bx[a], hi[a]), __fsub_rn(lo[a], bx[3 + a])),
                 0.f);
  }
  return __fadd_rn(__fadd_rn(__fmul_rn(g[0], g[0]), __fmul_rn(g[1], g[1])),
                   __fmul_rn(g[2], g[2]));
}

// squared distance between the farthest corners of the block's box and tile
// box bx (tiles_sdf._box_far2), the seed's key
__device__ __forceinline__ float box_far2(const float* lo, const float* hi,
                                          const float* bx) {
  float g[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    g[a] = fmaxf(__fsub_rn(bx[3 + a], lo[a]), __fsub_rn(hi[a], bx[a]));
  }
  return __fadd_rn(__fadd_rn(__fmul_rn(g[0], g[0]), __fmul_rn(g[1], g[1])),
                   __fmul_rn(g[2], g[2]));
}

// tiles_sdf.tile_skip: s_blk is the largest coordinate magnitude of the
// block's box
__device__ __forceinline__ bool tile_skipped(const float* lo, const float* hi,
                                             float s_blk, float u,
                                             const float* bx) {
  const float bd2 = box_d2(lo, hi, bx);
  float s = s_blk;
#pragma unroll
  for (int a = 0; a < 6; ++a) s = fmaxf(s, fabsf(bx[a]));
  const float lim = __fadd_rn(__fmul_rn(sqrtf(u), 1.f + kCullRel),
                              __fmul_rn(kCullRel, s));
  return bd2 > __fmul_rn(lim, lim);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// start copying tile k's first n staged rows into dst
__device__ __forceinline__ void load_tile(float4* dst,
                                          const float4* __restrict__ staged,
                                          int k, int n) {
  const float4* src = staged + (int64_t)k * kTile * 3;
  for (int e = threadIdx.x; e < 3 * n; e += kThreads)
    cp_async16(dst + e, src + e);
  cp_async_commit();
}

// scan n staged rows of one tile (first row row0) for the thread's points
__device__ __forceinline__ void scan_tile(const float4* tile, int n, int row0,
                                          const float* px, const float* py,
                                          const float* pz, float* best,
                                          int* idx) {
  for (int k = 0; k < n; ++k) {
    const float4 t0 = tile[3 * k], t1 = tile[3 * k + 1], t2 = tile[3 * k + 2];
#pragma unroll
    for (int j = 0; j < kPPT; ++j) {
      const float d2 = closest_d2(px[j], py[j], pz[j], t0, t1, t2);
      if (d2 < best[j]) {
        best[j] = d2;
        idx[j] = row0 + k;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
closest_tri_kernel(const float4* __restrict__ staged,
                   const int32_t* __restrict__ tile_rows,
                   const float* __restrict__ tile_box, int n_tiles,
                   const float* __restrict__ pts, int64_t B, int cull,
                   float* __restrict__ best_d2, int32_t* __restrict__ best_idx,
                   int32_t* __restrict__ visits) {
  extern __shared__ float4 smem[];
  int* list = reinterpret_cast<int*>(smem + 2 * kTile * 3);
  __shared__ float s_red[kWarps][7];
  __shared__ int s_red_k[kWarps];
  __shared__ float s_lo[3], s_hi[3], s_sblk, s_u;
  __shared__ int s_seed, s_count;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t base = (int64_t)blockIdx.x * kBlockPts;
  float px[kPPT], py[kPPT], pz[kPPT];
  bool live[kPPT];
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    const int64_t i = base + j * kThreads + tid;
    live[j] = i < B;
    px[j] = live[j] ? pts[3 * i] : 0.f;
    py[j] = live[j] ? pts[3 * i + 1] : 0.f;
    pz[j] = live[j] ? pts[3 * i + 2] : 0.f;
  }

  int seed = -1;
  if (cull) {
    // --- the block's box (NaN coordinates drop out of fminf / fmaxf) ---
    float v[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY,
                  -INFINITY};
#pragma unroll
    for (int j = 0; j < kPPT; ++j) {
      if (!live[j]) continue;
      v[0] = fminf(v[0], px[j]); v[1] = fminf(v[1], py[j]);
      v[2] = fminf(v[2], pz[j]); v[3] = fmaxf(v[3], px[j]);
      v[4] = fmaxf(v[4], py[j]); v[5] = fmaxf(v[5], pz[j]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        v[a] = fminf(v[a], __shfl_xor_sync(0xffffffffu, v[a], off));
        v[3 + a] = fmaxf(v[3 + a], __shfl_xor_sync(0xffffffffu, v[3 + a], off));
      }
    }
    if (lane == 0) {
      for (int a = 0; a < 6; ++a) s_red[warp][a] = v[a];
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int a = 0; a < 3; ++a) {
        float lo = s_red[0][a], hi = s_red[0][3 + a];
        for (int w = 1; w < kWarps; ++w) {
          lo = fminf(lo, s_red[w][a]);
          hi = fmaxf(hi, s_red[w][3 + a]);
        }
        s_lo[a] = lo;
        s_hi[a] = hi;
        s = fmaxf(s, fmaxf(fabsf(lo), fabsf(hi)));
      }
      s_sblk = s;
    }
    __syncthreads();

    // --- seed: the non-empty tile whose box's farthest corner is nearest
    // the block's box, lowest index on ties ---
    float kb = INFINITY;
    int kk = INT32_MAX;
    for (int k = tid; k < n_tiles; k += kThreads) {
      if (tile_rows[k] == 0) continue;
      const float d = box_far2(s_lo, s_hi, tile_box + 6 * k);
      if (d < kb || (d == kb && k < kk)) { kb = d; kk = k; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, kb, off);
      const int ok = __shfl_xor_sync(0xffffffffu, kk, off);
      if (ob < kb || (ob == kb && ok < kk)) { kb = ob; kk = ok; }
    }
    if (lane == 0) { s_red[warp][6] = kb; s_red_k[warp] = kk; }
    __syncthreads();
    if (tid == 0) {
      float b = s_red[0][6];
      int k = s_red_k[0];
      for (int w = 1; w < kWarps; ++w) {
        const float ob = s_red[w][6];
        const int ok = s_red_k[w];
        if (ob < b || (ob == b && ok < k)) { b = ob; k = ok; }
      }
      s_seed = k == INT32_MAX ? -1 : k;
    }
    __syncthreads();
    seed = s_seed;

    // --- u: the largest of the points' best d2 over the seed tile ---
    if (seed < 0) {
      if (tid == 0) s_u = INFINITY;
    } else {
      const int n = tile_rows[seed];
      load_tile(smem, staged, seed, n);
      cp_async_wait<0>();
      __syncthreads();
      float sb[kPPT];
      int si[kPPT];
#pragma unroll
      for (int j = 0; j < kPPT; ++j) { sb[j] = INFINITY; si[j] = 0; }
      scan_tile(smem, n, seed * kTile, px, py, pz, sb, si);
      float m = 0.f;
#pragma unroll
      for (int j = 0; j < kPPT; ++j) if (live[j]) m = fmaxf(m, sb[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) s_red[warp][6] = m;
      __syncthreads();           // the seed's buffer is free after this
      if (tid == 0) {
        float mm = s_red[0][6];
        for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, s_red[w][6]);
        s_u = mm;
      }
    }
    __syncthreads();
  }

  // --- the tiles to scan, ascending: warp 0 compacts them by ballots and
  // counts their rows ---
  if (warp == 0) {
    int count = 0, rows = 0;
    for (int c = 0; c < n_tiles; c += 32) {
      const int k = c + lane;
      const int n = k < n_tiles ? tile_rows[k] : 0;
      bool take = n > 0;
      if (take && cull && k != seed)
        take = !tile_skipped(s_lo, s_hi, s_sblk, s_u, tile_box + 6 * k);
      const unsigned m = __ballot_sync(0xffffffffu, take);
      if (take) {
        list[count + __popc(m & ((1u << lane) - 1u))] = k;
        rows += n;
      }
      count += __popc(m);
    }
    rows = __reduce_add_sync(0xffffffffu, rows);
    if (lane == 0) {
      s_count = count;
      if (visits != nullptr) {
        visits[2 * blockIdx.x] = count;
        visits[2 * blockIdx.x + 1] = rows;
      }
    }
  }
  __syncthreads();
  const int n_list = s_count;

  // --- the full ascending scan, tile i+1 loading while tile i is scanned ---
  float best[kPPT];
  int idx[kPPT];
#pragma unroll
  for (int j = 0; j < kPPT; ++j) { best[j] = INFINITY; idx[j] = 0; }
  constexpr int kBuf = kTile * 3;     // float4s per buffer
  if (n_list > 0) load_tile(smem, staged, list[0], tile_rows[list[0]]);
  for (int i = 0; i < n_list; ++i) {
    if (i + 1 < n_list) {
      load_tile(smem + ((i + 1) & 1) * kBuf, staged, list[i + 1],
                tile_rows[list[i + 1]]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k = list[i];
    scan_tile(smem + (i & 1) * kBuf, tile_rows[k], k * kTile, px, py, pz, best,
              idx);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    if (!live[j]) continue;
    const int64_t i = base + j * kThreads + tid;
    best_d2[i] = best[j];
    best_idx[i] = idx[j];      // a scanned row: in [0, T - 1]
  }
}

}  // namespace

// Stage rows (T, stride) into staged, (ceil(T / kTile) * kTile, kStage) f32;
// rows past T are left as they are (the tile table never scans them).
extern "C" int hpsdf_stage_rows(const float* rows, int64_t T, int64_t stride,
                                float* staged, void* stream) {
  stage_rows<<<(unsigned)((T + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      rows, T, stride, staged);
  return (int)cudaGetLastError();
}

// The scan over staged rows with the tile table (tile_rows i32[n_tiles],
// tile_box f32[n_tiles, 6]). visits, if not null, gets i32[n_blocks, 2]: each
// block's count of tiles and of rows in its full pass.
extern "C" int hpsdf_closest_tri(const float* staged, const int32_t* tile_rows,
                                 const float* tile_box, int64_t n_tiles,
                                 const float* pts, int64_t B, int cull,
                                 float* best_d2, int32_t* best_idx,
                                 int32_t* visits, void* stream) {
  const size_t smem = 2 * kTile * 3 * sizeof(float4) + n_tiles * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        closest_tri_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = (B + kBlockPts - 1) / kBlockPts;
  closest_tri_kernel<<<(unsigned)blocks, kThreads, smem,
                       (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(staged), tile_rows, tile_box,
      (int)n_tiles, pts, B, cull, best_d2, best_idx, visits);
  return (int)cudaGetLastError();
}

extern "C" const char* hpsdf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
