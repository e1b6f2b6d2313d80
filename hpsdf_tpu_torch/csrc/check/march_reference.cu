// K3 as it was before its redesign, kept as the exactness reference of
// march.cu: one thread per ray, the row pointer and the leaf frame carried
// in registers, every row lane read by a 4-byte load at every step. A ray's
// march is a function of that ray alone, so march.cu, which only schedules
// rays and moves rows differently, must return this kernel's t, hit and kk
// bit for bit; chip_smoke.py builds this file apart from the library
// (_kernels.load_check) and holds march.cu to it. It is on no path of the
// package. The arithmetic is described in march.cu.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../packed_rows.cuh"

namespace hpsdf {

__device__ __forceinline__ int row_child(const float* row) {
  return __float_as_int(__ldg(row)) - 1;
}

__device__ __forceinline__ const float* locate_row(
    const float* __restrict__ grid, const float* __restrict__ rows, int W,
    int gd, int extra, const float u[3]) {
  const float* row = grid_row(grid, W, gd, u);
  for (int r = 0; r < extra; ++r) {
    const int child = row_child(row);
    if (child < 0) break;
    const int oct = (u[0] >= __ldg(row + 2)) | ((u[1] >= __ldg(row + 3)) << 1) |
                    ((u[2] >= __ldg(row + 4)) << 2);
    row = rows + (int64_t)(child + oct) * W;
  }
  return row;
}


// sum_m coef[m] * Lx[i_m] * Ly[j_m] * Lz[k_m] over the basis of degree DEG.
template <int DEG>
__device__ __forceinline__ float poly_sum(const float* __restrict__ coef,
                                          const float (&Lx)[DEG + 1],
                                          const float (&Ly)[DEG + 1],
                                          const float (&Lz)[DEG + 1]) {
  float v = 0.0f;
  for_each_term<DEG>([&](int m, int i, int j, int k) {
    v += __ldg(coef + m) * (Lx[i] * Ly[j] * Lz[k]);
  });
  return v;
}

// Value of a packed row at the point `local` of its leaf's [-1, 1]^3 frame.
template <int DEG>
__device__ __forceinline__ float eval_local(const float* __restrict__ row,
                                            const float local[3]) {
  float Lx[DEG + 1], Ly[DEG + 1], Lz[DEG + 1];
  legendre<DEG>(local[0], Lx);
  legendre<DEG>(local[1], Ly);
  legendre<DEG>(local[2], Lz);
  return poly_sum<DEG>(row + kCoeffLane, Lx, Ly, Lz);
}

}  // namespace hpsdf

namespace {

constexpr int kThreads = 128;
constexpr int kLoW = 32;            // accel.LO_W
constexpr int kLoErrLane = 18;      // accel.LO_ERR_LANE
constexpr int kInnerStepsLo = 3;    // render.INNER_STEPS_LO
constexpr float kStepScale = 0.95f;
constexpr float kMinStep = 1e-4f;
constexpr float kLeafTol = 1.00001f;
constexpr float kOverlapSlack = 1.001f;
constexpr float kLodHandoff = 8.0f;

struct Ray {
  float uo[3], ud[3];
  float t, t_end;
};

struct Leaf {
  const float* row;
  float scale, c[3];
};

__device__ __forceinline__ Leaf relocate(const Ray& r, const float* grid,
                                         const float* rows, int W, int gd,
                                         int extra) {
  float u[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) u[a] = hpsdf::clamp_half(r.uo[a] + r.t * r.ud[a]);
  Leaf f;
  f.row = hpsdf::locate_row(grid, rows, W, gd, extra, u);
  f.scale = __ldg(f.row + 1);
#pragma unroll
  for (int a = 0; a < 3; ++a) f.c[a] = __ldg(f.row + 2 + a);
  return f;
}

// The ray's point in the leaf's [-1, 1]^3 frame; false once it left the leaf.
__device__ __forceinline__ bool leaf_local(const Ray& r, const Leaf& f,
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

struct Stepper {
  float omega, step_cap, hit_eps;
  int max_steps;
  bool relax_on, use_cap;
};

// Relaxation state of one ray: whether it still over-relaxes, and the
// pending relaxed step (its advance, 0 for none, and the value before it).
struct Relax {
  bool on;
  float adv_p, v_p;
};

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

template <int DEG>
__global__ void __launch_bounds__(kThreads)
march_kernel(const float* __restrict__ grid, const float* __restrict__ rows,
             int W, const float* __restrict__ lo_grid,
             const float* __restrict__ lo_rows, int gd, int extra,
             int inner_steps, const float* __restrict__ origins,
             const float* __restrict__ dirs, int64_t B, float bmin0,
             float bmin1, float bmin2, float bmax0, float bmax1, float bmax2,
             float rc0, float rc1, float rc2, float inv0, float inv1,
             float inv2, float t_max, Stepper s, float* __restrict__ t_out,
             uint8_t* __restrict__ hit_out, int* __restrict__ kk) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int k_lo = 0, k_full = 0;
  if (i < B) {
    const float bmin[3] = {bmin0, bmin1, bmin2};
    const float bmax[3] = {bmax0, bmax1, bmax2};
    const float rc[3] = {rc0, rc1, rc2};
    const float inv[3] = {inv0, inv1, inv2};
    Ray r;
    float t_near = -INFINITY, t_far = INFINITY;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float o = origins[3 * i + a], d = dirs[3 * i + a];
      const float id = 1.0f / d;
      const float lo = (bmin[a] - o) * id, hi = (bmax[a] - o) * id;
      t_near = fmaxf(t_near, fminf(lo, hi));
      t_far = fminf(t_far, fmaxf(lo, hi));
      r.uo[a] = (o - rc[a]) * inv[a];
      r.ud[a] = d * inv[a];
    }
    const bool hits_box = t_far >= fmaxf(t_near, 0.0f);
    r.t_end = fminf(t_far, t_max);
    r.t = fmaxf(t_near, 0.0f);
    bool active = hits_box && r.t <= r.t_end;
    bool hit = false;
    int nsteps = 0;
    float local[3];

    if (lo_grid != nullptr) {
      // phase 1: far field on the LOD rows
      const float handoff = kLodHandoff * s.hit_eps;
      Relax x{s.relax_on, 0.0f, 0.0f};
      bool need_full = false;
      while (active && k_lo < s.max_steps) {
        const Leaf f = relocate(r, lo_grid, lo_rows, kLoW, gd, extra);
        const float err = __ldg(f.row + kLoErrLane);
        for (int st = 0; st < kInnerStepsLo && active; ++st) {
          if (!leaf_local(r, f, local)) break;        // frozen until relocated
          const float v_lo = hpsdf::eval_local<2>(f.row, local);
          const float v = v_lo - err;                 // lower bound on f
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
      // rays still marching at the round cap go on in phase 2 as well
      active = active || need_full;
    }

    // phase 2: full rows, fresh relaxation state
    Relax x{s.relax_on, 0.0f, 0.0f};
    while (active && k_full < s.max_steps) {
      const Leaf f = relocate(r, grid, rows, W, gd, extra);
      for (int st = 0; st < inner_steps && active; ++st) {
        if (!leaf_local(r, f, local)) break;
        const float v = hpsdf::eval_local<DEG>(f.row, local);
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
    t_out[i] = r.t;
    hit_out[i] = hit;
  }
  // kk: max over the batch, one atomic per warp
  k_lo = __reduce_max_sync(0xffffffffu, k_lo);
  k_full = __reduce_max_sync(0xffffffffu, k_full);
  if ((threadIdx.x & 31) == 0) {
    if (k_lo) atomicMax(kk, k_lo);
    if (k_full) atomicMax(kk + 1, k_full);
  }
}

}  // namespace

// lo_grid == nullptr: no LOD phase. kk (2 ints) must be zeroed by the caller.
extern "C" int hpsdf_march_reference(const float* grid, const float* rows, int W,
                           int deg, const float* lo_grid, const float* lo_rows,
                           int gd, int extra, int inner_steps,
                           const float* origins, const float* dirs, int64_t B,
                           float bmin0, float bmin1, float bmin2, float bmax0,
                           float bmax1, float bmax2, float rc0, float rc1,
                           float rc2, float inv0, float inv1, float inv2,
                           float t_max, float hit_eps, int max_steps,
                           float step_cap, int use_cap, float omega,
                           int relax_on, float* t, uint8_t* hit, int* kk,
                           void* stream) {
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  const Stepper s{omega, step_cap, hit_eps, max_steps, relax_on != 0,
                  use_cap != 0};
#define HPSDF_LAUNCH(D)                                                     \
  march_kernel<D><<<blocks, kThreads, 0, st>>>(                             \
      grid, rows, W, lo_grid, lo_rows, gd, extra, inner_steps, origins,     \
      dirs, B, bmin0, bmin1, bmin2, bmax0, bmax1, bmax2, rc0, rc1, rc2, inv0, \
      inv1, inv2, t_max, s, t, hit, kk)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
  return (int)cudaGetLastError();
}
