// K4 as it was before its redesign, kept as the exactness reference of
// cone.cu: a warp per T x T pixel tile, whose lanes reduce the tile's rays
// and then march the centre ray together, every lane the same arithmetic
// on the same row. A tile's start is a function of that tile's rays alone,
// and the reduction takes maxima and minima, which do not depend on order,
// so cone.cu, which only schedules tiles and moves rows differently, must
// return this kernel's t0 bit for bit; chip_smoke.py builds this file apart
// from the library (_kernels.load_check) and holds cone.cu to it. It is on
// no path of the package. Its design, as it was:
//
// K4: the cone prepass, a warp per T x T pixel tile, in f32.
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
//   * t_stop written to the tile's rays as their start t0 for K3.
// The reference starts and stops on the centre ray's own box interval,
// which a fine ray can enter earlier or leave later by up to the cone's
// radius, so it dropped hits near the root's faces (ADVICE.md, high). Here
// the march covers the union of the fine rays' intervals [max(t_near, 0),
// min(t_far, t_max)], found with their slab tests in the same warp: it starts
// at the earliest entry and escapes only past the latest exit, and a tile
// none of whose rays meets the root escapes at once. Where the centre ray is
// outside the root the field is read at its clamp into the root, which lies
// no farther from any fine ray inside the root than the centre ray itself.
//
// Bound. The reduction reads each ray's origin and direction once (24 bytes
// a ray) and writes t0 (4 bytes); the march is at most `cap` relocations of
// one ray a tile. One thread a tile would leave 16,384 threads at 1024^2
// rays, too few for the card, so a warp takes a tile: its lanes reduce the
// tile's rays (T^2 / 32 each) and then march the centre ray together, every
// lane the same arithmetic on the same row (broadcast loads), which is as
// fast as one lane marching and needs no broadcast of the result.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../packed_rows.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLoW = 32;            // accel.LO_W
constexpr int kLoErr = 18;          // accel.LO_ERR_LANE
constexpr float kStepScale = 0.95f;
constexpr float kMinStep = 1e-4f;
constexpr float kStopFrac = 0.5f;   // render.CONE_STOP_FRAC

struct Box {
  float bmin[3], bmax[3], rc[3], inv[3];
};

// sum_m coef[m] L_i(x) L_j(y) L_k(z) of a row's first C(EDEG) coefficient
// lanes at `local`
template <int EDEG>
__device__ __forceinline__ float eval_row(const float* __restrict__ row,
                                          const float local[3]) {
  float Lx[EDEG + 1], Ly[EDEG + 1], Lz[EDEG + 1];
  hpsdf::legendre<EDEG>(local[0], Lx);
  hpsdf::legendre<EDEG>(local[1], Ly);
  hpsdf::legendre<EDEG>(local[2], Lz);
  const float* coef = row + hpsdf::kCoeffLane;
  float v = 0.0f;
  hpsdf::for_each_term<EDEG>([&](int m, int i, int j, int k) {
    v += __ldg(coef + m) * (Lx[i] * Ly[j] * Lz[k]);
  });
  return v;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int DEG>
__global__ void __launch_bounds__(kThreads)
cone_kernel(const float* __restrict__ grid, const float* __restrict__ rows,
            int W, const float* __restrict__ lo_grid,
            const float* __restrict__ lo_rows, int gd, int extra,
            const float* __restrict__ origins, int64_t origin_stride,
            const float* __restrict__ dirs, int H, int width, int T, Box bx,
            float t_max, float hit_eps, int cap, float* __restrict__ t0) {
  const int lane = threadIdx.x & 31;
  const int64_t tile = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int tiles_x = width / T;
  if (tile >= (int64_t)(H / T) * tiles_x) return;       // whole warps
  const int64_t ty = tile / tiles_x, tx = tile - ty * tiles_x;
  auto ray = [&](int k) {
    return (ty * T + k / T) * (int64_t)width + tx * T + k % T;
  };
  const int64_t c = ray((T / 2) * T + T / 2);
  float oc[3], dc[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    oc[a] = origins[origin_stride * c + a], dc[a] = dirs[3 * c + a];

  // the tile's spread around the centre ray, and the union of its rays'
  // intervals in the root
  float do2 = 0.0f, dd2 = 0.0f, lo = INFINITY, hi = -INFINITY;
  for (int k = lane; k < T * T; k += 32) {
    const int64_t r = ray(k);
    float so = 0.0f, sd = 0.0f, t_near = -INFINITY, t_far = INFINITY;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float o = origins[origin_stride * r + a], d = dirs[3 * r + a];
      so += (o - oc[a]) * (o - oc[a]);
      sd += (d - dc[a]) * (d - dc[a]);
      const float id = 1.0f / d;
      const float l = (bx.bmin[a] - o) * id, h = (bx.bmax[a] - o) * id;
      t_near = fmaxf(t_near, fminf(l, h));
      t_far = fminf(t_far, fmaxf(l, h));
    }
    do2 = fmaxf(do2, so), dd2 = fmaxf(dd2, sd);
    const float ts = fmaxf(t_near, 0.0f), te = fminf(t_far, t_max);
    if (t_far >= ts && ts <= te) lo = fminf(lo, ts), hi = fmaxf(hi, te);
  }
  const float dev_o = sqrtf(warp_max(do2)), dev_d = sqrtf(warp_max(dd2));
  lo = warp_min(lo), hi = warp_max(hi);

  // the centre ray's march against the cone margin
  const float escape = t_max + 1.0f;
  float uo[3], ud[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    uo[a] = (oc[a] - bx.rc[a]) * bx.inv[a], ud[a] = dc[a] * bx.inv[a];
  const float inv_lip = 1.0f / (1.0f + dev_d);   // t-Lipschitz of the margin
  float t = escape;
  if (lo <= hi) {
    t = lo;
    for (int k = 0; k < cap; ++k) {
      float u[3], local[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) u[a] = hpsdf::clamp_half(uo[a] + t * ud[a]);
      float v;
      const float* row =
          lo_grid != nullptr
              ? hpsdf::locate_row4(lo_grid, lo_rows, kLoW, gd, extra, u)
              : hpsdf::locate_row4(grid, rows, W, gd, extra, u);
      const float4 m = __ldg(reinterpret_cast<const float4*>(row));
      const float centre[3] = {m.z, m.w, __ldg(row + 4)};
#pragma unroll
      for (int a = 0; a < 3; ++a) local[a] = (u[a] - centre[a]) * m.y;
      if (lo_grid != nullptr)
        v = eval_row<2>(row, local) - __ldg(row + kLoErr);
      else
        v = eval_row<DEG>(row, local);
      const float radius = dev_o + t * dev_d;
      const float margin = v - radius;
      if (margin < fmaxf(hit_eps, kStopFrac * radius)) break;    // contact
      const float adv = (kStepScale * margin) * inv_lip + kMinStep;
      if (t + adv > hi) {                                        // escape
        t = escape;
        break;
      }
      t = t + adv;
    }
  }
  for (int k = lane; k < T * T; k += 32) t0[ray(k)] = t;
}

}  // namespace

// Rays in row-major H x width order; T divides H and width. lo_grid ==
// nullptr: march on the full rows. origin_stride: 3, or 0 for one shared
// origin. cap: the round cap (min(CONE_CAP, max_steps)). box: bmin, bmax, the
// root centre and 1 / root sizes (12 floats). t0: (H * width) floats.
extern "C" int hpsdf_cone_reference(const float* grid, const float* rows,
                                    int W, int deg, const float* lo_grid,
                                    const float* lo_rows, int gd, int extra,
                                    const float* origins,
                                    int64_t origin_stride, const float* dirs,
                                    int H, int width, int T, const float* box,
                                    float t_max, float hit_eps, int cap,
                                    float* t0, void* stream) {
  if (T <= 0 || H % T || width % T) return (int)cudaErrorInvalidValue;
  Box bx;
  for (int a = 0; a < 3; ++a) {
    bx.bmin[a] = box[a], bx.bmax[a] = box[3 + a];
    bx.rc[a] = box[6 + a], bx.inv[a] = box[9 + a];
  }
  const int64_t threads = (int64_t)(H / T) * (width / T) * 32;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define HPSDF_LAUNCH(D)                                                  \
  cone_kernel<D><<<blocks, kThreads, 0, s>>>(                            \
      grid, rows, W, lo_grid, lo_rows, gd, extra, origins, origin_stride, \
      dirs, H, width, T, bx, t_max, hit_eps, cap, t0)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
  return (int)cudaGetLastError();
}
