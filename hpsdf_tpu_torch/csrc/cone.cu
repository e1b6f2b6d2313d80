// K4: the cone prepass, a lane per T x T pixel tile, in f32.
//
// Replaces what XLA fused for hpsdf_tpu/render.py cone_start / _cone_march
// (:193-291); the plain torch version is cone_start_plain in
// hpsdf_tpu_torch/render.py. For each tile of a row-major H x W ray grid:
//   * the centre ray, tile index (T/2) T + T/2, and do / dd, the largest
//     chord deviation of the tile's origins and directions from it, so that
//     every fine ray lies within do + t dd of the centre ray at parameter t;
//   * the centre ray marched against the cone margin f(p_c(t)) - (do + t dd)
//     (with LOD tables, f is the LOD rows' value minus their error lane, a
//     lower bound of the field): plain steps 0.95 margin / (1 + dd) + 1e-4,
//     stopping at contact, margin < max(hit_eps, 0.5 radius), after `cap`
//     rounds, or at escape, past the end of the tile's interval, where the
//     tile's rays get t_max + 1 and do not march;
//   * t_stop written to the tile's rays as their start t0 for K3, and, when
//     asked for, the rounds the tile's march took (the reference's lockstep
//     round count is their largest).
// The reference starts and stops on the centre ray's own box interval,
// which a fine ray can enter earlier or leave later by up to the cone's
// radius, so it dropped hits near the root's faces (ADVICE.md, high). Here
// the march covers the union of the fine rays' intervals [max(t_near, 0),
// min(t_far, t_max)], found with their slab tests: it starts at the earliest
// entry and escapes only past the latest exit, and a tile none of whose rays
// meets the root escapes at once. Where the centre ray is outside the root
// the field is read at its clamp into the root, which lies no farther from
// any fine ray inside the root than the centre ray itself.
//
// Bound. The reduction reads each ray's direction (and origin, unless one
// origin is shared) once and writes t0: bytes. The march is a chain of
// dependent loads and f32 operations a round (the locate's walk, the frame,
// the recurrences, the serial term sum, the step logic), at most `cap`
// rounds of one ray a tile: latency, with little issue. So the launch costs
// the reduction's bytes, then the longest tile's chain. What the design
// does about it:
//   * a block takes a strip of one tile row (kThreads / T tiles) and its
//     threads read the strip's rays in raster order, a thread a pixel
//     column (rows unrolled, so a thread's loads are in flight together),
//     so a warp reads consecutive rays of one pixel row; each thread keeps
//     its column's spread and interval, and the block combines them per
//     tile in shared memory (maxima and minima, which do not depend on
//     order);
//   * then a lane marches a tile, so a round costs one lane's issue and not
//     a warp's (the kernel this one replaced spent a warp on each tile's
//     march, 31 lanes of 32 repeating the first: 16,384 warps in 3-4 waves
//     at 1024^2);
//   * each row of the locate's walk is loaded whole, frame and coefficients
//     in 16-byte loads issued together, so the leaf's coefficients come
//     with its frame and need no load of their own after the walk;
//   * t0 goes back through shared memory in raster order.
// What was timed and lost (PERF.md §6): holding the leaf row and
// reloading it after the walk only when it changed (a warp's lanes march
// different tiles, and a round waits for any lane that reloads), reloading
// it every round, rows not unrolled, blocks of 128 threads, and the
// marching tiles spread over the block's warps. Every t0 is bit for bit
// that of the kernel this one replaced (check/cone_reference.cu): the
// schedule and the way a row reaches the registers change, the arithmetic
// does not.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "packed_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRegLanes = 64;    // coefficient lanes kept in registers
constexpr int kLoW = 32;            // accel.LO_W
constexpr int kLoLanes = 12;        // LOD lanes 8..19: 10 coefficients, err
constexpr int kLoErr = 10;          // accel.LO_ERR_LANE - COEFF_LANE
constexpr float kStepScale = 0.95f;
constexpr float kMinStep = 1e-4f;
constexpr float kStopFrac = 0.5f;   // render.CONE_STOP_FRAC

// What every tile of a launch shares. With LOD tables, grid, rows and W
// are the LOD tables'.
struct Scene {
  const float* grid;
  const float* rows;
  int W, gd, extra, cap;
  float bmin[3], bmax[3], rc[3], inv[3];
  float t_max, hit_eps;
};

// A row in registers: its pointer, the leaf frame and, for rows of at most
// kMaxRegLanes coefficient lanes, the coefficients (an LOD row's kLoLanes
// lanes, its error lane among them). EDEG is the degree evaluated.
template <int EDEG, bool LO>
struct Row {
  static constexpr int kC = (EDEG + 1) * (EDEG + 2) * (EDEG + 3) / 6;
  static constexpr int kQuads = LO ? kLoLanes / 4 : (kC + 3) / 4;
  static constexpr bool kInRegs = 4 * kQuads <= kMaxRegLanes;
  static constexpr int kN = kInRegs ? 4 * kQuads : 1;
  const float* row;
  float scale, c[3];
  float coef[kN];
};

// Load `row` into `h` (the frame and, where kept in registers, the
// coefficients, all loads issued together); child: its child_idx lane, -1
// on a leaf.
template <int EDEG, bool LO>
__device__ __forceinline__ void load_row(Row<EDEG, LO>& h, const float* row,
                                         int& child) {
  const float4 m = __ldg(reinterpret_cast<const float4*>(row));
  h.row = row;
  h.scale = m.y;
  h.c[0] = m.z, h.c[1] = m.w, h.c[2] = __ldg(row + 4);
  child = __float_as_int(m.x) - 1;
  if constexpr (Row<EDEG, LO>::kInRegs) {
    const float4* src =
        reinterpret_cast<const float4*>(row + hpsdf::kCoeffLane);
#pragma unroll
    for (int q = 0; q < Row<EDEG, LO>::kQuads; ++q) {
      const float4 f = __ldg(src + q);
      h.coef[4 * q] = f.x, h.coef[4 * q + 1] = f.y, h.coef[4 * q + 2] = f.z,
                 h.coef[4 * q + 3] = f.w;
    }
  }
}

// The leaf row of unit point u in `h`, every row of the walk loaded whole
// (locate_row4's walk: the grid row, then up to `extra` descents).
template <int EDEG, bool LO>
__device__ __forceinline__ void locate_load(const Scene& sc, const float u[3],
                                            Row<EDEG, LO>& h) {
  int child;
  load_row(h, hpsdf::grid_row(sc.grid, sc.W, sc.gd, u), child);
  for (int r = 0; r < sc.extra && child >= 0; ++r) {
    const int oct = (u[0] >= h.c[0]) | ((u[1] >= h.c[1]) << 1) |
                    ((u[2] >= h.c[2]) << 2);
    load_row(h, sc.rows + (int64_t)(child + oct) * sc.W, child);
  }
}

// The field's bound at `local` from the leaf row: sum_m coef[m] L_i(x)
// L_j(y) L_k(z) in basis order, less the error lane on an LOD row.
template <int EDEG, bool LO>
__device__ __forceinline__ float eval_row(const Row<EDEG, LO>& h,
                                           const float local[3]) {
  float Lx[EDEG + 1], Ly[EDEG + 1], Lz[EDEG + 1];
  hpsdf::legendre<EDEG>(local[0], Lx);
  hpsdf::legendre<EDEG>(local[1], Ly);
  hpsdf::legendre<EDEG>(local[2], Lz);
  float v = 0.0f;
  if constexpr (Row<EDEG, LO>::kInRegs) {
    hpsdf::for_each_term<EDEG>([&](int m, int i, int j, int k) {
      v += h.coef[m] * (Lx[i] * Ly[j] * Lz[k]);
    });
  } else {
    const float* coef = h.row + hpsdf::kCoeffLane;
    hpsdf::for_each_term<EDEG>([&](int m, int i, int j, int k) {
      v += __ldg(coef + m) * (Lx[i] * Ly[j] * Lz[k]);
    });
  }
  if constexpr (LO) v = v - h.coef[kLoErr];
  return v;
}

// The march of one tile's centre ray (oc, dc) against the cone margin over
// [lo, hi]; returns t_stop and sets `taken` to the rounds it took.
template <int EDEG, bool LO>
__device__ __forceinline__ float march_tile(const Scene& sc,
                                            const float oc[3],
                                            const float dc[3], float dev_o,
                                            float dev_d, float lo, float hi,
                                            int& taken) {
  const float escape = sc.t_max + 1.0f;
  float uo[3], ud[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    uo[a] = (oc[a] - sc.rc[a]) * sc.inv[a], ud[a] = dc[a] * sc.inv[a];
  const float inv_lip = 1.0f / (1.0f + dev_d);   // t-Lipschitz of the margin
  taken = 0;
  if (!(lo <= hi)) return escape;
  float t = lo;
  Row<EDEG, LO> h;
  for (int k = 0; k < sc.cap; ++k) {
    ++taken;
    float u[3], local[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) u[a] = hpsdf::clamp_half(uo[a] + t * ud[a]);
    locate_load(sc, u, h);
#pragma unroll
    for (int a = 0; a < 3; ++a) local[a] = (u[a] - h.c[a]) * h.scale;
    const float v = eval_row(h, local);
    const float radius = dev_o + t * dev_d;
    const float margin = v - radius;
    if (margin < fmaxf(sc.hit_eps, kStopFrac * radius)) break;    // contact
    const float adv = (kStepScale * margin) * inv_lip + kMinStep;
    if (t + adv > hi) return escape;                              // escape
    t = t + adv;
  }
  return t;
}

// A block: tile row blockIdx.x / strips, tiles [tx0, tx0 + nt) of it (nt =
// kThreads / T, or 1 when T > kThreads).
template <int EDEG, bool LO>
__global__ void __launch_bounds__(kThreads)
cone_kernel(Scene sc, const float* __restrict__ origins,
            int64_t origin_stride, const float* __restrict__ dirs, int width,
            int T, int nt, int strips, float* __restrict__ t0,
            int* __restrict__ rounds) {
  __shared__ float s_o2[kThreads], s_d2[kThreads], s_lo[kThreads],
      s_hi[kThreads], s_t[kThreads], s_c[6][kThreads];
  const int tid = threadIdx.x;
  const int tiles_x = width / T;
  const int ty = blockIdx.x / strips;
  const int tx0 = (blockIdx.x - ty * strips) * nt;
  const int ntb = min(nt, tiles_x - tx0);        // the strip's tiles
  const int cols = ntb * T;
  const int64_t ray0 = ((int64_t)ty * T) * width + (int64_t)tx0 * T;

  // each thread's columns: the spread around their tile's centre ray and
  // the union of their rays' intervals in the root
  float do2 = 0.0f, dd2 = 0.0f, lo = INFINITY, hi = -INFINITY;
  for (int c = tid; c < cols; c += kThreads) {
    const int64_t cr = ray0 + (int64_t)(T / 2) * width + (c / T) * T + T / 2;
    float oc[3], dc[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      oc[a] = origins[origin_stride * cr + a], dc[a] = dirs[3 * cr + a];
    if (c % T == 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
        s_c[a][c / T] = oc[a], s_c[3 + a][c / T] = dc[a];
    }
#pragma unroll 8
    for (int r = 0; r < T; ++r) {
      const int64_t ray = ray0 + (int64_t)r * width + c;
      float so = 0.0f, sd = 0.0f, t_near = -INFINITY, t_far = INFINITY;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float o = origins[origin_stride * ray + a];
        const float d = dirs[3 * ray + a];
        so += (o - oc[a]) * (o - oc[a]);
        sd += (d - dc[a]) * (d - dc[a]);
        const float id = 1.0f / d;
        const float l = (sc.bmin[a] - o) * id, h = (sc.bmax[a] - o) * id;
        t_near = fmaxf(t_near, fminf(l, h));
        t_far = fminf(t_far, fmaxf(l, h));
      }
      do2 = fmaxf(do2, so), dd2 = fmaxf(dd2, sd);
      const float ts = fmaxf(t_near, 0.0f), te = fminf(t_far, sc.t_max);
      if (t_far >= ts && ts <= te) lo = fminf(lo, ts), hi = fmaxf(hi, te);
    }
  }
  s_o2[tid] = do2, s_d2[tid] = dd2, s_lo[tid] = lo, s_hi[tid] = hi;
  __syncthreads();

  // a lane a tile: combine its columns, then march
  if (tid < ntb) {
    const int group = nt > 1 ? T : min(cols, kThreads);
    const int first = nt > 1 ? tid * T : 0;
    do2 = 0.0f, dd2 = 0.0f, lo = INFINITY, hi = -INFINITY;
    for (int i = first; i < first + group; ++i) {
      do2 = fmaxf(do2, s_o2[i]), dd2 = fmaxf(dd2, s_d2[i]);
      lo = fminf(lo, s_lo[i]), hi = fmaxf(hi, s_hi[i]);
    }
    const float oc[3] = {s_c[0][tid], s_c[1][tid], s_c[2][tid]};
    const float dc[3] = {s_c[3][tid], s_c[4][tid], s_c[5][tid]};
    int taken;
    s_t[tid] = march_tile<EDEG, LO>(sc, oc, dc, sqrtf(do2), sqrtf(dd2), lo,
                                    hi, taken);
    if (rounds != nullptr) rounds[(int64_t)ty * tiles_x + tx0 + tid] = taken;
  }
  __syncthreads();
  for (int c = tid; c < cols; c += kThreads) {
    const float t = s_t[c / T];
#pragma unroll 8
    for (int r = 0; r < T; ++r) t0[ray0 + (int64_t)r * width + c] = t;
  }
}

template <int EDEG, bool LO>
int launch(const Scene& sc, const float* origins, int64_t origin_stride,
           const float* dirs, int H, int width, int T, float* t0,
           int* rounds, cudaStream_t s) {
  const int nt = T <= kThreads ? kThreads / T : 1;
  const int strips = (width / T + nt - 1) / nt;
  const int64_t blocks = (int64_t)(H / T) * strips;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cone_kernel<EDEG, LO><<<(unsigned)blocks, kThreads, 0, s>>>(
      sc, origins, origin_stride, dirs, width, T, nt, strips, t0, rounds);
  return (int)cudaGetLastError();
}

}  // namespace

// Rays in row-major H x width order; T divides H and width. lo_grid ==
// nullptr: march on the full rows. origin_stride: 3, or 0 for one shared
// origin. cap: the round cap (min(CONE_CAP, max_steps)). box: bmin, bmax, the
// root centre and 1 / root sizes (12 floats). t0: (H * width) floats.
// rounds: nullptr, or (H / T) * (width / T) ints, the rounds each tile's
// march took.
extern "C" int hpsdf_cone(const float* grid, const float* rows, int W,
                          int deg, const float* lo_grid, const float* lo_rows,
                          int gd, int extra, const float* origins,
                          int64_t origin_stride, const float* dirs, int H,
                          int width, int T, const float* box, float t_max,
                          float hit_eps, int cap, float* t0, int* rounds,
                          void* stream) {
  if (T <= 0 || H % T || width % T) return (int)cudaErrorInvalidValue;
  Scene sc;
  const bool lod = lo_grid != nullptr;
  sc.grid = lod ? lo_grid : grid;
  sc.rows = lod ? lo_rows : rows;
  sc.W = lod ? kLoW : W;
  sc.gd = gd, sc.extra = extra, sc.cap = cap;
  for (int a = 0; a < 3; ++a) {
    sc.bmin[a] = box[a], sc.bmax[a] = box[3 + a];
    sc.rc[a] = box[6 + a], sc.inv[a] = box[9 + a];
  }
  sc.t_max = t_max, sc.hit_eps = hit_eps;
  cudaStream_t s = (cudaStream_t)stream;
  if (lod)
    return launch<2, true>(sc, origins, origin_stride, dirs, H, width, T, t0,
                           rounds, s);
#define HPSDF_LAUNCH(D)                                                    \
  return launch<D, false>(sc, origins, origin_stride, dirs, H, width, T, t0, \
                          rounds, s)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
  return 0;
}
