// K3: the sphere-tracing march, both phases in one launch, in f32.
//
// Replaces what XLA fused for hpsdf_tpu/render.py _march_block (:649-919)
// without its resume machinery (init / outer_cap / return_state, which serve
// only the compacted lockstep schedule). The plain torch version is
// _march_block in hpsdf_tpu_torch/render.py, a masked lockstep loop over the
// whole batch; here each ray runs its own loop, which yields the same per-ray
// result: a lockstep lane that is frozen (active but out of its leaf) changes
// nothing until the next relocation, so a ray that ends the relocation round
// early and relocates at once computes what the lane does. Per ray:
//   * the slab test against the root AABB, t from max(t_near, 0) or, given a
//     start t0 (the cone prepass K4, cone.cu), from max(t_near, 0, t0[ray]),
//     and the exit plane t_end = min(t_far, t_max); a ray whose t0 lies past
//     t_end (its cone escaped) does not march;
//   * the unit-space ray uo + t * udir, clamped (render.py:743-746);
//   * with LOD tables (lo_grid != nullptr), phase 1 on the 32-lane deg<=2
//     rows: conservative steps 0.95 (v_lo - err) + 1e-4, hand-off to phase 2
//     when v_lo - err < LOD_HANDOFF * hit_eps; rays still marching at the
//     round cap also move on (merge_leftovers);
//   * phase 2 on the full rows: `inner_steps` steps per relocation, a hit
//     when v < hit_eps;
//   * in both, Keinert over-relaxation (omega) with the 1.001-slack overlap
//     test and rollback, the step cap, escape decided on the unrelaxed step
//     past t_end, and at most max_steps steps;
//   * kk = [max phase-1 rounds, max phase-2 rounds] over the batch, which is
//     the single lockstep block's round counts.
//
// Bound. The row tables are a few MB and stay in the 50 MB L2, so device
// memory is not what bounds the march. Its work is its rays' steps, each a
// chain of dependent f32 operations (locate -> frame -> recurrences -> the
// serial product sum -> step logic; about 240 instructions and, for a ray
// alone on the card, 0.3 us a round), and a ray's chain is serial. Rays are
// short (about 5 steps on average at 1024^2) but a few graze the surface
// for up to max_steps steps, so a launch is bound by instruction issue and
// then by its last long rays, which run while other warps share their
// schedulers. What the design does about it:
//   * a row reaches the registers in 16-byte loads (the leaf frame as one
//     float4 and one scalar, the coefficients as float4s), and stays there
//     while the ray stays in the leaf: the locate runs at every relocation
//     with the same arithmetic, only the reload is skipped when it returns
//     the row already held. Rows wider than kMaxHeld coefficient lanes
//     (degree >= 6) keep the frame and read a coefficient a term;
//   * a warp's time is its longest ray's, so when the rays are an image's
//     pixels in raster order and the caller says how wide it is, a warp
//     takes an 8x4 pixel tile and not a 32x1 strip: neighbours in both
//     directions march alike, and fewer warps hold a long ray.
// What was timed and lost (PERF.md): persistent warps that refill finished
// lanes from a global counter (their retire and refill tests lengthen every
// round's chain, and with 5 steps a ray there is little idle time to win
// back), holding only the leaf frame and reading the coefficients at every
// step, and register caps for more resident warps (the march does not wait
// on latency that more warps would hide). Every result is bit for bit that
// of the form this one replaced (check/march_reference.cu): the schedule
// and the way a row reaches the registers change, the arithmetic does not.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "packed_rows.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxHeld = 64;        // coefficient lanes kept in registers
constexpr int kLoW = 32;            // accel.LO_W
constexpr int kLoHeld = 12;         // LOD lanes 8..19: 10 coefficients, err
constexpr int kLoErr = 10;          // accel.LO_ERR_LANE - COEFF_LANE
constexpr int kInnerStepsLo = 3;    // render.INNER_STEPS_LO
constexpr int kStats = 6;           // per-ray counts (render.STATS)
constexpr float kStepScale = 0.95f;
constexpr float kMinStep = 1e-4f;
constexpr float kLeafTol = 1.00001f;
constexpr float kOverlapSlack = 1.001f;
constexpr float kLodHandoff = 8.0f;

struct Ray {
  float uo[3], ud[3];
  float t, t_end;
};

struct Stepper {
  float omega, step_cap, hit_eps;
  int max_steps;
  bool relax_on, use_cap;
};

// What every ray of a launch shares.
struct Scene {
  const float* grid;
  const float* rows;
  const float* lo_grid;             // nullptr: no LOD phase
  const float* lo_rows;
  int W, gd, extra, inner_steps;
  float bmin[3], bmax[3], rc[3], inv[3];
  float t_max;
  Stepper s;
};

struct Rays {
  const float* origins;
  int64_t origin_stride;            // 3, or 0 for one shared origin
  const float* dirs;
  int64_t B;
  float* t_out;
  uint8_t* hit_out;
  int* stats;                       // nullptr: off; else (B, kStats) counts
  const float* t0;                  // nullptr, or a start per ray (B,)
};

// Relaxation state of one ray: whether it still over-relaxes, and the
// pending relaxed step (its advance, 0 for none, and the value before it).
struct Relax {
  bool on;
  float adv_p, v_p;
};

// The row a ray holds: its pointer, the leaf frame and, for rows of at most
// kMaxHeld coefficient lanes, the coefficients.
template <int DEG>
struct Held {
  static constexpr int kC = (DEG + 1) * (DEG + 2) * (DEG + 3) / 6;
  static constexpr int kQuads = (kC + 3) / 4;
  static constexpr bool kInRegs = 4 * kQuads <= kMaxHeld;
  static constexpr int kN =
      kInRegs && 4 * kQuads > kLoHeld ? 4 * kQuads : kLoHeld;
  const float* row;
  float scale, c[3];
  float coef[kN];
};

template <int QUADS, int N>
__device__ __forceinline__ void load_quads(const float* __restrict__ row,
                                           float (&coef)[N]) {
  const float4* src = reinterpret_cast<const float4*>(row + hpsdf::kCoeffLane);
#pragma unroll
  for (int q = 0; q < QUADS; ++q) {
    const float4 f = __ldg(src + q);
    coef[4 * q] = f.x, coef[4 * q + 1] = f.y, coef[4 * q + 2] = f.z,
             coef[4 * q + 3] = f.w;
  }
}

// Hold `row`: a reload only when it is not the row held. LO: an LOD row.
// Returns whether it was the row held.
template <bool LO, int DEG>
__device__ __forceinline__ bool hold(Held<DEG>& h, const float* row) {
  if (row == h.row) return true;
  const float4 m = __ldg(reinterpret_cast<const float4*>(row));
  h.row = row;
  h.scale = m.y;
  h.c[0] = m.z, h.c[1] = m.w, h.c[2] = __ldg(row + 4);
  if constexpr (LO) {
    load_quads<kLoHeld / 4>(row, h.coef);
  } else if constexpr (Held<DEG>::kInRegs) {
    load_quads<Held<DEG>::kQuads>(row, h.coef);
  }
  return false;
}

// The ray's point in the held leaf's [-1, 1]^3 frame; false once it left
// the leaf.
template <int DEG>
__device__ __forceinline__ bool leaf_local(const Ray& r, const Held<DEG>& f,
                                           float local[3]) {
  bool in_leaf = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float u = hpsdf::clamp_half(r.uo[a] + r.t * r.ud[a]);
    local[a] = (u - f.c[a]) * f.scale;
    in_leaf = in_leaf && fabsf(local[a]) <= kLeafTol;
  }
  return in_leaf;
}

// Value of the held row at `local`: sum_m coef[m] Lx[i_m] Ly[j_m] Lz[k_m] in
// basis order. EDEG is the degree evaluated (2 on an LOD row).
template <int EDEG, bool IN_REGS, int DEG>
__device__ __forceinline__ float eval_held(const Held<DEG>& h,
                                           const float local[3]) {
  float Lx[EDEG + 1], Ly[EDEG + 1], Lz[EDEG + 1];
  hpsdf::legendre<EDEG>(local[0], Lx);
  hpsdf::legendre<EDEG>(local[1], Ly);
  hpsdf::legendre<EDEG>(local[2], Lz);
  float v = 0.0f;
  if constexpr (IN_REGS) {
    hpsdf::for_each_term<EDEG>([&](int m, int i, int j, int k) {
      v += h.coef[m] * (Lx[i] * Ly[j] * Lz[k]);
    });
  } else {
    const float* coef = h.row + hpsdf::kCoeffLane;
    hpsdf::for_each_term<EDEG>([&](int m, int i, int j, int k) {
      v += __ldg(coef + m) * (Lx[i] * Ly[j] * Lz[k]);
    });
  }
  return v;
}

// One step of a ray that is in its leaf and neither hit nor handed off:
// advance by the (possibly relaxed, rolled back or capped) step. Returns
// false once the ray stops marching (escaped or out of steps).
__device__ __forceinline__ bool take_step(Ray& r, Relax& x, int& nsteps,
                                          float v, bool over,
                                          const Stepper& s) {
  const float safe_adv = kStepScale * v + kMinStep;
  float adv = safe_adv;
  if (s.relax_on) {
    if (x.on) adv = s.omega * adv;
    // a relaxed step never carries the ray past the exit plane
    if (r.t + adv > r.t_end) adv = safe_adv;
    // rollback: undo the pending relaxed step, take the safe one instead
    if (over) adv = -x.adv_p + kStepScale * x.v_p + kMinStep;
    x.on = x.on && !over;
  }
  if (s.use_cap) adv = fminf(adv, s.step_cap);
  // escape is decided on the unrelaxed step past t_end
  const bool escaped = !over && (r.t + safe_adv > r.t_end);
  r.t = r.t + adv;
  ++nsteps;
  if (s.relax_on) {
    x.adv_p = over ? 0.0f : adv;
    x.v_p = v;
  }
  return !escaped && nsteps < s.max_steps;
}

// One ray's march state.
template <int DEG>
struct Lane {
  Ray r;
  Relax x;
  Held<DEG> h;
  int64_t i;                        // the ray's index
  int nsteps, k_lo, k_full, kept;   // kept: relocations that found h.row
  bool active, hit, need_full;

  __device__ __forceinline__ void start(const Scene& sc, const Rays& ry,
                                        int64_t ray) {
    i = ray;
    float t_near = -INFINITY, t_far = INFINITY;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float o = ry.origins[ry.origin_stride * i + a];
      const float d = ry.dirs[3 * i + a];
      const float id = 1.0f / d;
      const float lo = (sc.bmin[a] - o) * id, hi = (sc.bmax[a] - o) * id;
      t_near = fmaxf(t_near, fminf(lo, hi));
      t_far = fminf(t_far, fmaxf(lo, hi));
      r.uo[a] = (o - sc.rc[a]) * sc.inv[a];
      r.ud[a] = d * sc.inv[a];
    }
    const bool hits_box = t_far >= fmaxf(t_near, 0.0f);
    r.t_end = fminf(t_far, sc.t_max);
    r.t = fmaxf(t_near, 0.0f);
    if (ry.t0 != nullptr) r.t = fmaxf(r.t, ry.t0[i]);
    active = hits_box && r.t <= r.t_end;
    hit = need_full = false;
    nsteps = k_lo = k_full = kept = 0;
    x = Relax{sc.s.relax_on, 0.0f, 0.0f};
    h.row = nullptr;
  }

  template <bool LO>
  __device__ __forceinline__ void relocate(const Scene& sc) {
    float u[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      u[a] = hpsdf::clamp_half(r.uo[a] + r.t * r.ud[a]);
    const float* row =
        LO ? hpsdf::locate_row4(sc.lo_grid, sc.lo_rows, kLoW, sc.gd,
                                sc.extra, u)
           : hpsdf::locate_row4(sc.grid, sc.rows, sc.W, sc.gd, sc.extra, u);
    kept += hold<LO>(h, row);
  }

  __device__ __forceinline__ bool in_lo(const Scene& sc) const {
    return active && k_lo < sc.s.max_steps;
  }
  __device__ __forceinline__ bool in_full(const Scene& sc) const {
    return active && k_full < sc.s.max_steps;
  }

  // phase 1, one relocation round: far field on the LOD rows
  __device__ __forceinline__ void round_lo(const Scene& sc) {
    const Stepper& s = sc.s;
    const float handoff = kLodHandoff * s.hit_eps;
    relocate<true>(sc);
    const float err = h.coef[kLoErr];
    float local[3];
    for (int st = 0; st < kInnerStepsLo && active; ++st) {
      if (!leaf_local(r, h, local)) break;          // frozen until relocated
      const float v_lo = eval_held<2, true>(h, local);
      const float v = v_lo - err;                   // lower bound on f
      // overlap radii must lower-bound |f|: relu(|v_lo| - err)
      const bool over = s.relax_on && x.on && x.adv_p > 0.0f &&
                        (x.v_p + fmaxf(fabsf(v_lo) - err, 0.0f) <
                         x.adv_p * kOverlapSlack);
      if (!over && v < handoff) {
        need_full = true;
        active = false;
        break;
      }
      active = take_step(r, x, nsteps, v, over, s);
    }
    ++k_lo;
  }

  // phase 1 -> phase 2: rays still marching at the round cap go on as well,
  // with fresh relaxation state; the LOD row is no full row
  __device__ __forceinline__ void to_full(const Scene& sc, const Rays& ry) {
    if (ry.stats != nullptr) {
      int* st = ry.stats + kStats * i;
      st[0] = nsteps, st[2] = k_lo, st[4] = kept;
    }
    active = active || need_full;
    x = Relax{sc.s.relax_on, 0.0f, 0.0f};
    h.row = nullptr;
  }

  // phase 2, one relocation round on the full rows
  __device__ __forceinline__ void round_full(const Scene& sc) {
    const Stepper& s = sc.s;
    relocate<false>(sc);
    float local[3];
    for (int st = 0; st < sc.inner_steps && active; ++st) {
      if (!leaf_local(r, h, local)) break;
      const float v = eval_held<DEG, Held<DEG>::kInRegs>(h, local);
      // Keinert overlap test on the pending relaxed step
      const bool over = s.relax_on && x.on && x.adv_p > 0.0f &&
                        (fabsf(x.v_p) + fabsf(v) < x.adv_p * kOverlapSlack);
      if (!over && v < s.hit_eps) {
        hit = true;
        active = false;
        break;
      }
      active = take_step(r, x, nsteps, v, over, s);
    }
    ++k_full;
  }

  // write the ray's result; per-ray counts: steps, relocations and kept
  // relocations of phase 1 (written by to_full) and of phase 2
  __device__ __forceinline__ void retire(const Scene& sc, const Rays& ry) {
    ry.t_out[i] = r.t;
    ry.hit_out[i] = hit;
    if (ry.stats != nullptr) {
      int* st = ry.stats + kStats * i;
      if (sc.lo_grid == nullptr) st[0] = st[2] = st[4] = 0;
      st[1] = nsteps - st[0], st[3] = k_full, st[5] = kept - st[4];
    }
  }
};

// kk: max over the batch, one atomic per warp
__device__ __forceinline__ void reduce_kk(int* kk, int k_lo, int k_full) {
  k_lo = __reduce_max_sync(0xffffffffu, k_lo);
  k_full = __reduce_max_sync(0xffffffffu, k_full);
  if ((threadIdx.x & 31) == 0) {
    if (k_lo) atomicMax(kk, k_lo);
    if (k_full) atomicMax(kk + 1, k_full);
  }
}

// Thread index -> ray index with a warp on an 8x4 pixel tile of an image
// `width` wide (width % 8 == 0 and B % (4 width) == 0).
__device__ __forceinline__ int64_t tile_ray(int64_t i, int width) {
  const int64_t tile = i >> 5;
  const int within = (int)(i & 31);
  const int tiles_x = width >> 3;
  const int64_t ty = tile / tiles_x, tx = tile - ty * tiles_x;
  return (ty * 4 + (within >> 3)) * width + tx * 8 + (within & 7);
}

template <int DEG>
__global__ void __launch_bounds__(kThreads)
march_kernel(Scene sc, Rays ry, int width, int* __restrict__ kk) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int k_lo = 0, k_full = 0;
  if (i < ry.B) {
    if (width) i = tile_ray(i, width);
    Lane<DEG> L;
    L.start(sc, ry, i);
    if (sc.lo_grid != nullptr) {
      while (L.in_lo(sc)) L.round_lo(sc);
      L.to_full(sc, ry);
    }
    while (L.in_full(sc)) L.round_full(sc);
    L.retire(sc, ry);
    k_lo = L.k_lo, k_full = L.k_full;
  }
  reduce_kk(kk, k_lo, k_full);
}

}  // namespace

// lo_grid == nullptr: no LOD phase. origin_stride: 3, or 0 for one origin
// shared by every ray. kk (2 ints) must be zeroed by the caller. stats:
// nullptr, or (B, 6) ints. t0: nullptr, or a start per ray (B floats).
// width: 0, or the width of the image whose pixels the rays are in raster
// order (width % 8 == 0, B % (4 width) == 0).
extern "C" int hpsdf_march(const float* grid, const float* rows, int W,
                           int deg, const float* lo_grid, const float* lo_rows,
                           int gd, int extra, int inner_steps,
                           const float* origins, int64_t origin_stride,
                           const float* dirs, int64_t B, const float* box,
                           float t_max, float hit_eps, int max_steps,
                           float step_cap, int use_cap, float omega,
                           int relax_on, float* t, uint8_t* hit, int* kk,
                           int* stats, const float* t0, int width,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Scene sc;
  sc.grid = grid, sc.rows = rows, sc.lo_grid = lo_grid, sc.lo_rows = lo_rows;
  sc.W = W, sc.gd = gd, sc.extra = extra, sc.inner_steps = inner_steps;
  for (int a = 0; a < 3; ++a) {
    sc.bmin[a] = box[a], sc.bmax[a] = box[3 + a];
    sc.rc[a] = box[6 + a], sc.inv[a] = box[9 + a];
  }
  sc.t_max = t_max;
  sc.s = Stepper{omega, step_cap, hit_eps, max_steps, relax_on != 0,
                 use_cap != 0};
  const Rays ry{origins, origin_stride, dirs, B, t, hit, stats, t0};
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  if (width && (width < 0 || width % 8 || B % (4 * (int64_t)width)))
    return (int)cudaErrorInvalidValue;
#define HPSDF_LAUNCH(D) \
  march_kernel<D><<<blocks, kThreads, 0, st>>>(sc, ry, width, kk)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
  return (int)cudaGetLastError();
}
