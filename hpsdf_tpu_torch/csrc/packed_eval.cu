// K2 / K5: packed locate + eval, one thread per point, in f32; K5 gives the
// unit normal instead of the value, or the raw world-space gradient.
//
// Replaces what XLA fused for hpsdf_tpu/accel.py values_at / query_packed
// (to_unit, locate_in, eval_row; accel.py:226-337) and, with the gradient,
// hpsdf_tpu/render.py _normals_at (:1092-1110). The plain torch versions are
// values_at_plain / query_packed_plain / normals_plain in
// hpsdf_tpu_torch/accel.py. Per point the thread runs:
//   * world -> unit cube in f32, the inside test |u| <= 0.5 and the clamp;
//   * the grid row of u's cell and `extra` masked descents (locate_row4);
//   * the Legendre product sum over the row's folded coefficient lanes, the
//     degree a template parameter so the recurrences stay in registers;
//   * values: the f32-max sentinel outside the root with `outside_max`;
//     normals: the local gradient chained through scale / root_sizes and
//     normalised with a 1e-12 floor;
//   * the raw gradient (K5's third form, for the backward of values_at and
//     the eikonal term of inverse rendering, hpsdf_tpu/inverse.py:233-240):
//     the local gradient chained through scale / root_sizes, as autodiff
//     of values_at chains it, times the clamp's derivative on each axis: 1
//     inside the root, 1/2 on a face (jnp.clip's max and min split the
//     tie), 0 where the point was clamped;
//   * values and raw gradients in one launch (the fused mode): the value at
//     every point and the raw gradient at the first B_g, the points of an
//     inverse chunk's one read (its band points first, whose gradients the
//     eikonal term takes; inverse.py chunk_loss). A thread i < B_g runs the
//     derivative recurrences and the three gradient sums on the row it
//     already holds, after the value's sum; each sum is written as in its
//     own mode, so the values are bit-equal to mode 0's and the gradients
//     to mode 2's. It saves the raw-gradient launch and its second read of
//     the same rows.
//
// Where the normals' backward needs a gradient (the tables' or the
// points'), the normals mode also saves what K7's form 2 and K5h start
// from (kNormalsSave): each point's row key (locate_key, the walk
// locate_row4 takes) and its unnormalised world gradient G, one 16-byte
// store a point. Where the fused read's backward needs the points'
// gradient, the fused mode saves each point's row key for K5h
// (kValuesGradSave), one 4-byte store a point. Without them both modes are
// their own instantiations, unchanged.
//
// K5h (packed_hvp_kernel), the same read with the Hessian from the saved
// key, gives the point VJPs of normals and values_and_gradient_at; it is
// described above its kernel below.
//
// Bound. The tables are a few MB and stay in the 50 MB L2, and the
// arithmetic is ~4*C f32 operations a point (~16*C with the gradient). At
// scattered points the 32 lanes of a warp read 32 rows, and each load
// instruction then costs up to 32 L1 wavefronts: reading a row one 4-byte
// load a lane (5 + C loads, 24 on a degree-3 row) made that the bound. So a
// thread reads its row in 16-byte loads: lanes 0-4 (the descent's and the
// leaf frame's) as one float4 and one scalar, the coefficients as float4s
// into registers (C/4 loads, 5 on a degree-3 row). What bounds the kernel
// then is the rows' bytes from L2 to the SMs, one row a point. Staging a
// warp's rows in shared memory with coalesced copies moves the same bytes:
// it gains ~10% at scattered points, but its warp-wide row count delays
// every warp, and the carve's batches, whose warps mostly read one row,
// run slower for it than this form (PERF.md). Rows wider than 64
// coefficient lanes (degree >= 6) are read one 4-byte load a term.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "packed_rows.cuh"

namespace {

constexpr int kThreads = 128;
// what a launch computes (the wrapper's `mode`)
constexpr int kValues = 0, kNormals = 1, kRawGrad = 2, kValuesGrad = 3,
              kNormalsSave = 4, kValuesGradSave = 5;

template <int DEG, int MODE>
__global__ void __launch_bounds__(kThreads)
packed_eval_kernel(const float* __restrict__ grid,
                   const float* __restrict__ rows, int W, int gd, int extra,
                   const float* __restrict__ pts, int64_t B, float rc0,
                   float rc1, float rc2, float inv0, float inv1, float inv2,
                   float sz0, float sz1, float sz2, int outside_max,
                   float* __restrict__ out, float* __restrict__ out_grad,
                   int64_t B_g, int* __restrict__ keys) {
  // the fused mode, saving each point's row key or not
  constexpr bool kFused = MODE == kValuesGrad || MODE == kValuesGradSave;
  constexpr int kSums =
      (MODE == kValues || kFused ? hpsdf::kSumValue : 0) |
      (MODE == kValues ? 0 : hpsdf::kSumGrad);
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // whether this thread sums the gradient
  const bool with_grad = MODE == kNormals || MODE == kNormalsSave ||
                         MODE == kRawGrad || (kFused && i < B_g);
  if (i >= B) return;
  const float rc[3] = {rc0, rc1, rc2};
  const float inv[3] = {inv0, inv1, inv2};
  float u[3], slope[3];
  hpsdf::unit_point(pts + 3 * i, rc, inv, u, slope);
  const bool inside = slope[0] > 0.0f && slope[1] > 0.0f && slope[2] > 0.0f;
  int key = 0;
  const float* row;
  if constexpr (MODE == kNormalsSave || MODE == kValuesGradSave) {
    key = hpsdf::locate_key(grid, rows, W, gd, extra, u);
    const int G3 = 1 << (3 * gd);
    row = key < G3 ? grid + (int64_t)key * W : rows + (int64_t)(key - G3) * W;
  } else {
    row = hpsdf::locate_row4(grid, rows, W, gd, extra, u);
  }
  float v, g[3], h[6];
  const float scale = hpsdf::packed_leaf_sums<DEG, kSums>(row, u, with_grad,
                                                          false, v, g, h);

  if constexpr (MODE == kRawGrad || kFused) {
    // local = (unit - centre) * scale, unit = clamp((p - c) * (1 / sizes))
    float* dst = MODE == kRawGrad ? out : out_grad;
    if (with_grad) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
        dst[3 * i + a] =
            slope[a] > 0.0f ? slope[a] * (g[a] * scale * inv[a]) : 0.0f;
    }
    if constexpr (kFused) out[i] = v;
    if constexpr (MODE == kValuesGradSave) keys[i] = key;
  } else if constexpr (MODE == kNormals || MODE == kNormalsSave) {
    // local = (unit - centre) * scale, unit = (p - c) / sizes
    const float sz[3] = {sz0, sz1, sz2};
#pragma unroll
    for (int a = 0; a < 3; ++a) g[a] = g[a] * scale / sz[a];
    const float nrm = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
    const float den = fmaxf(nrm, 1e-12f);
#pragma unroll
    for (int a = 0; a < 3; ++a) out[3 * i + a] = g[a] / den;
    if constexpr (MODE == kNormalsSave)
      reinterpret_cast<float4*>(out_grad)[i] =
          make_float4(__int_as_float(key), g[0], g[1], g[2]);
  } else {
    out[i] = (outside_max && !inside) ? FLT_MAX : v;
  }
}

// K5h: Hessian-vector products of the packed eval, the point VJPs of
// normals and of values_and_gradient_at (normals_vjp_plain,
// values_and_gradient_vjp_plain), per point in f32, starting from what the
// forward saved for it: no locate. The normals' forward (kNormalsSave)
// saves each point's row key and unnormalised gradient G, the fused
// read's (kValuesGradSave) each point's row key. The thread loads its key,
// then its row (the key's grid row below 8^grid_depth, else its node row,
// as K7's form 2 resolves it), and sums by (i, j) pair (pair_sums): the
// Hessian H (xx, yy, zz, xy, xz, yz) and, in the values mode, the
// leaf-frame gradient g, which w g needs; the normals mode takes its G
// from the record and sums no gradient.
// With c_a the clamp's slope (1, 1/2 on a face, 0 clamped) and
// s_a = scale / size_a (scale * inv_a where values_at's chain takes it):
//   * kNormalsVjp, cotangents wn (B, 3) of the unit normals G /
//     max(|G|, 1e-12): gb = unit_vector_vjp(G, wn, 1e-12), q_a =
//     (gb_a / size_a) scale, and d_p_b = c_b scale inv_b sum_a H_ab q_a;
//   * kValuesGradVjp, cotangents w (B,) of the values and u (B_g, 3) of
//     the raw gradients c_a g_a scale inv_a of the first B_g points:
//     q_a = u_a c_a scale inv_a there (0 beyond), and
//     d_p_b = c_b scale inv_b (w g_b + sum_a H_ab q_a); a thread past B_g
//     sums no Hessian.
// The kernel it replaced (csrc/check/packed_hvp_reference.cu) located the
// row again from the root grid (a grid load and up to `extra` dependent
// descents), summed the gradient's three sums in the normals mode too, and
// formed each term's triple products anew in two passes over the row.
// Bound. The sums are a few operations a term (pair_sums: two a term a
// k-run sum, then an FMA a pair an entry), so what holds the kernel at
// scattered points is K5's: a warp's 32 lanes reading 32 rows, each
// 16-byte load instruction up to 32 L1 wavefronts. So a warp whose lanes
// read more than kHvpStageMin distinct rows stages them in shared memory,
// each row once, the lanes of a copy on consecutive 16-byte pieces of one
// row (cp.async), and each lane reads its own row from there; a warp on
// fewer rows (the render's hits, in raster order) reads its rows itself,
// its loads mostly broadcasts.
constexpr int kNormalsVjp = 0, kValuesGradVjp = 1;
// 128 threads a block, no minimum of blocks an SM asked of ptxas: 56 / 55
// registers at degree 3 (nine blocks an SM), 96 at degree 5 (five), no
// stack or spills. Blocks of 64 or 256 threads, and minimums that cap the
// registers, were no faster (PERF.md).
constexpr int kHvpThreads = 128;

// The row of key k, locate_key's: the grid row k below 8^gd, else node
// row k - 8^gd.
__device__ __forceinline__ const float* keyed_row(
    const float* __restrict__ grid, const float* __restrict__ rows, int W,
    int gd, int key) {
  const int G3 = 1 << (3 * gd);
  return key < G3 ? grid + (int64_t)key * W : rows + (int64_t)(key - G3) * W;
}

// A row as K5h reads it: its scale and centre (lanes 1-4) and its
// coefficients, up to kMaxQuads float4s held in registers (kHeld), else
// read a term at a time from the row. Where a warp stages its rows
// (packed_hvp_kernel), a slot holds the row's first kF float4s: lanes 0-7
// and the coefficients' quads; the slots' stride is odd, so that a
// quarter warp's 16-byte reads of eight slots meet no bank conflict.
template <int DEG>
struct HvpRow {
  static constexpr int kC = (DEG + 1) * (DEG + 2) * (DEG + 3) / 6;
  static constexpr int kQuads = (kC + 3) / 4;
  static constexpr bool kHeld = kQuads <= hpsdf::kMaxQuads;
  static constexpr int kF = 2 + kQuads;
  static constexpr int kStride = kF | 1;
  float scale, centre[3];
  float c[kHeld ? 4 * kQuads : 1];
  const float* coef;

  // the row at r: in global memory, or with SHARED a staged slot
  template <bool SHARED>
  __device__ __forceinline__ void load(const float* r) {
    auto quad = [&](int q) {
      const float4* p = reinterpret_cast<const float4*>(r) + q;
      if constexpr (SHARED)
        return *p;
      else
        return __ldg(p);
    };
    const float4 m0 = quad(0), m1 = quad(1);
    scale = m0.y;
    centre[0] = m0.z, centre[1] = m0.w, centre[2] = m1.x;
    coef = r + hpsdf::kCoeffLane;
    if constexpr (kHeld) {
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const float4 f = quad(2 + q);
        c[4 * q] = f.x, c[4 * q + 1] = f.y, c[4 * q + 2] = f.z,
        c[4 * q + 3] = f.w;
      }
    }
  }

  // term m's coefficient (for_each_term's order)
  __device__ __forceinline__ float operator()(int m) const {
    if constexpr (kHeld)
      return c[m];
    else
      return __ldg(coef + m);
  }
};

// The terms of pair (i, j), k rising (m their places in for_each_term's
// order, coef(m) their coefficients), summed against the third axis's
// factors, S_r = sum_k c_ijk N^(r)_k(z), r = 0, 1, 2 (2 where HESS); then
// each sum takes its pair product times one of them:
//   g += (N'_i N_j S_0, N_i N'_j S_0, N_i N_j S_1)               (GRAD)
//   h += (N''_i N_j S_0, N_i N''_j S_0, N_i N_j S_2,
//         N'_i N'_j S_0, N'_i N_j S_1, N_i N'_j S_1)            (HESS)
// The k run is unrolled up to kUnrolledDeg and a loop above it.
template <int DEG, bool GRAD, bool HESS>
__device__ __forceinline__ void pair_terms(int i, int j,
                                           const HvpRow<DEG>& coef,
                                           const float (&L)[3][DEG + 1],
                                           const float (&dL)[3][DEG + 1],
                                           const float (&d2L)[3][DEG + 1],
                                           float (&g)[3], float (&h)[6]) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  auto term = [&](int k) {
    const int p = i + j + k;
    const float c =
        coef(p * (p + 1) * (p + 2) / 6 + i * (p + 1) - i * (i - 1) / 2 + j);
    s0 += c * L[2][k];
    s1 += c * dL[2][k];
    if constexpr (HESS) s2 += c * d2L[2][k];
  };
  if constexpr (DEG <= hpsdf::kUnrolledDeg) {
#pragma unroll
    for (int k = 0; k <= DEG - i - j; ++k) term(k);
  } else {
#pragma unroll 1
    for (int k = 0; k <= DEG - i - j; ++k) term(k);
  }
  const float p00 = L[0][i] * L[1][j], p10 = dL[0][i] * L[1][j],
              p01 = L[0][i] * dL[1][j];
  if constexpr (GRAD) {
    g[0] += p10 * s0;
    g[1] += p01 * s0;
    g[2] += p00 * s1;
  }
  if constexpr (HESS) {
    h[0] += d2L[0][i] * L[1][j] * s0;
    h[1] += L[0][i] * d2L[1][j] * s0;
    h[2] += p00 * s2;
    h[3] += dL[0][i] * dL[1][j] * s0;
    h[4] += p10 * s1;
    h[5] += p01 * s1;
  }
}

// The sums of the row r at the clamped unit-cube point u, one thread, by
// (i, j) pair (pair_terms): the leaf-frame gradient g (GRAD) and Hessian
// h (HESS).
template <int DEG, bool GRAD, bool HESS>
__device__ __forceinline__ void pair_sums(const HvpRow<DEG>& r,
                                          const float (&u)[3],
                                          float (&g)[3], float (&h)[6]) {
  float L[3][DEG + 1], dL[3][DEG + 1], d2L[3][DEG + 1];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    hpsdf::legendre<DEG>((u[a] - r.centre[a]) * r.scale, L[a]);
    hpsdf::legendre_deriv<DEG>(L[a], dL[a]);
    if constexpr (HESS) hpsdf::legendre_deriv2<DEG>(dL[a], d2L[a]);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) g[a] = 0.0f;
#pragma unroll
  for (int a = 0; a < 6; ++a) h[a] = 0.0f;
  if constexpr (DEG <= hpsdf::kUnrolledDeg) {
#pragma unroll
    for (int i = 0; i <= DEG; ++i)
#pragma unroll
      for (int j = 0; j <= DEG - i; ++j)
        pair_terms<DEG, GRAD, HESS>(i, j, r, L, dL, d2L, g, h);
  } else {
#pragma unroll 1
    for (int i = 0; i <= DEG; ++i)
#pragma unroll 1
      for (int j = 0; j <= DEG - i; ++j)
        pair_terms<DEG, GRAD, HESS>(i, j, r, L, dL, d2L, g, h);
  }
}

// A warp whose lanes read more than kHvpStageMin distinct rows stages
// them in shared memory, each row once, with coalesced 16-byte copies;
// with fewer each lane reads its own row, the loads mostly broadcasts.
constexpr int kHvpStageMin = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// A point's own inputs, read once: streamed (evict first), so that they do
// not push the rows, which many points read, out of L1.
template <class T>
__device__ __forceinline__ T point_ld(const T* p) {
  return __ldcs(p);
}

template <int DEG, int MODE>
__global__ void __launch_bounds__(kHvpThreads)
packed_hvp_kernel(const float* __restrict__ grid,
                  const float* __restrict__ rows, int W, int gd,
                  const float* __restrict__ pts, int64_t B, float rc0,
                  float rc1, float rc2, float inv0, float inv1, float inv2,
                  float sz0, float sz1, float sz2,
                  const float* __restrict__ w, const float* __restrict__ cot3,
                  int64_t B_g, const void* __restrict__ saved,
                  float* __restrict__ d_pts) {
  using Row = HvpRow<DEG>;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  if (i - lane >= B) return;              // the whole warp past the end
  const bool active = i < B;
  const bool hess = active && (MODE == kNormalsVjp || i < B_g);
  // the key first: the row's loads wait on it alone (a lane past the end
  // takes grid row 0)
  int key = 0;
  float G[3] = {0.0f, 0.0f, 0.0f};
  if (active) {
    if constexpr (MODE == kNormalsVjp) {
      const float4 s = point_ld(reinterpret_cast<const float4*>(saved) + i);
      key = __float_as_int(s.x);
      G[0] = s.y, G[1] = s.z, G[2] = s.w;
    } else {
      key = point_ld(reinterpret_cast<const int*>(saved) + i);
    }
  }
  const float* row = keyed_row(grid, rows, W, gd, key);
  // the row's loads (or its copy into the warp's slots) are issued as soon
  // as the key is in, before the point's own loads are used
  Row r;
  bool staged = false;
  float4* slot_at = nullptr;
  if constexpr (Row::kHeld && kHvpStageMin < 32) {
    __shared__ float4 s_rows[kHvpThreads / 32][32 * Row::kStride];
    __shared__ const float* s_slot[kHvpThreads / 32][32];
    const int wid = threadIdx.x >> 5;
    // lanes that read the row of the lane before them share its slot
    // (every lane takes part in the shuffle before the test)
    const int prev = __shfl_up_sync(kFullMask, key, 1);
    const bool lead = lane == 0 || prev != key;
    const unsigned leaders = __ballot_sync(kFullMask, lead);
    const int n = __popc(leaders);
    staged = n > kHvpStageMin;
    if (staged) {
      const int slot = __popc(leaders & (kFullMask >> (31 - lane))) - 1;
      if (lead) s_slot[wid][slot] = row;
      __syncwarp();
      float4* tile = s_rows[wid];
      for (int k = lane; k < n * Row::kF; k += 32) {
        const int s = k / Row::kF, q = k - s * Row::kF;
        const unsigned dst =
            (unsigned)__cvta_generic_to_shared(tile + s * Row::kStride + q);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                     "l"(reinterpret_cast<const float4*>(s_slot[wid][s]) +
                         q));
      }
      slot_at = tile + slot * Row::kStride;
    }
  }
  if (!staged) r.template load<false>(row);
  const float rc[3] = {rc0, rc1, rc2};
  const float inv[3] = {inv0, inv1, inv2};
  const float sz[3] = {sz0, sz1, sz2};
  // a lane past the end reads the last point, and writes nothing
  const int64_t ip = active ? i : B - 1;
  float p[3], u[3], slope[3], cot[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int a = 0; a < 3; ++a) p[a] = point_ld(pts + 3 * ip + a);
  hpsdf::unit_point(p, rc, inv, u, slope);
  if (hess) {
#pragma unroll
    for (int a = 0; a < 3; ++a) cot[a] = point_ld(cot3 + 3 * i + a);
  }
  const float wi = MODE == kValuesGradVjp && active ? point_ld(w + i) : 0.0f;
  if (staged) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    r.template load<true>(reinterpret_cast<const float*>(slot_at));
  }
  if (!active) return;
  float g[3], h[6];
  if constexpr (MODE == kNormalsVjp)
    pair_sums<DEG, false, true>(r, u, g, h);
  else if (hess)
    pair_sums<DEG, true, true>(r, u, g, h);
  else
    pair_sums<DEG, true, false>(r, u, g, h);
  const float scale = r.scale;

  float q[3] = {0.0f, 0.0f, 0.0f}, dl[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (MODE == kNormalsVjp) {
    // n = G / max(|G|, 1e-12), G_a = g_a scale / size_a (K5's forward)
    float gb[3];
    hpsdf::unit_vector_vjp(G, cot, 1e-12f, gb);
#pragma unroll
    for (int a = 0; a < 3; ++a) q[a] = gb[a] / sz[a] * scale;
  } else {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      dl[a] = wi * g[a];
      if (hess) q[a] = cot[a] * slope[a] * (scale * inv[a]);
    }
  }
  if (hess) {
    float hq[3];
    hpsdf::hessian_times(h, q, hq);
#pragma unroll
    for (int a = 0; a < 3; ++a) dl[a] += hq[a];
  }
  // local = (unit - centre) * scale, unit = clamp((p - c) * (1 / sizes))
#pragma unroll
  for (int a = 0; a < 3; ++a)
    d_pts[3 * i + a] = slope[a] * (dl[a] * scale * inv[a]);
}

}  // namespace

// mode 0: values (B,) in out; 1: unit normals (B, 3); 2: raw gradients
// (B, 3); 3: values (B,) in out and the raw gradients of the first B_g
// points (B_g, 3) in out_grad, B_g <= B; 4: unit normals (B, 3) in out and
// in out_grad (B, 4), 16-byte aligned, each point's row key (its bits) and
// unnormalised gradient, for K7's form 2 and K5h; 5: mode 3's outputs and
// in keys (B,) each point's row key, for K5h. Rows 16-byte aligned.
extern "C" int hpsdf_packed_eval(const float* grid, const float* rows, int W,
                                 int deg, int gd, int extra, const float* pts,
                                 int64_t B, float rc0, float rc1, float rc2,
                                 float inv0, float inv1, float inv2, float sz0,
                                 float sz1, float sz2, int outside_max,
                                 int mode, float* out, float* out_grad,
                                 int64_t B_g, int* keys, void* stream) {
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const bool fused = mode == kValuesGrad || mode == kValuesGradSave;
  if (mode < kValues || mode > kValuesGradSave ||
      (fused && (B_g < 0 || B_g > B)) ||
      (mode == kValuesGradSave && keys == nullptr))
    return (int)cudaErrorInvalidValue;
  if (mode == kNormalsSave && (uintptr_t)out_grad % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
#define HPSDF_MODE(D, M)                                                     \
  packed_eval_kernel<D, M><<<blocks, kThreads, 0, s>>>(                      \
      grid, rows, W, gd, extra, pts, B, rc0, rc1, rc2, inv0, inv1, inv2, sz0, \
      sz1, sz2, outside_max, out, out_grad, B_g, keys)
#define HPSDF_LAUNCH(D)                     \
  if (mode == kNormals)                     \
    HPSDF_MODE(D, kNormals);                \
  else if (mode == kNormalsSave)            \
    HPSDF_MODE(D, kNormalsSave);            \
  else if (mode == kRawGrad)                \
    HPSDF_MODE(D, kRawGrad);                \
  else if (mode == kValuesGrad)             \
    HPSDF_MODE(D, kValuesGrad);             \
  else if (mode == kValuesGradSave)         \
    HPSDF_MODE(D, kValuesGradSave);         \
  else                                      \
    HPSDF_MODE(D, kValues)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
#undef HPSDF_MODE
  return (int)cudaGetLastError();
}

// K5h: d_pts (B, 3), mode 0 the VJP of the unit normals with cotangents
// cot3 = wn (B, 3), from saved (B, 4) f32, 16-byte aligned, what mode 4 of
// hpsdf_packed_eval saved for these points; mode 1 the VJP of
// values_and_gradient_at with cotangents w (B,) for the values and cot3 =
// u (B_g, 3) for the raw gradients of the first B_g <= B points, from
// saved (B,) i32, the keys mode 5 saved. Rows 16-byte aligned.
extern "C" int hpsdf_packed_hvp(const float* grid, const float* rows, int W,
                                int deg, int gd, const float* pts, int64_t B,
                                float rc0, float rc1, float rc2, float inv0,
                                float inv1, float inv2, float sz0, float sz1,
                                float sz2, int mode, const float* w,
                                const float* cot3, int64_t B_g,
                                const void* saved, float* d_pts,
                                void* stream) {
  if (B <= 0 || (mode != kNormalsVjp && mode != kValuesGradVjp) ||
      (mode == kValuesGradVjp && (B_g < 0 || B_g > B)) || saved == nullptr)
    return (int)cudaErrorInvalidValue;
  if (mode == kNormalsVjp && (uintptr_t)saved % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const unsigned blocks = (unsigned)((B + kHvpThreads - 1) / kHvpThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define HPSDF_MODE(D, M)                                                  \
  packed_hvp_kernel<D, M><<<blocks, kHvpThreads, 0, s>>>(                 \
      grid, rows, W, gd, pts, B, rc0, rc1, rc2, inv0, inv1, inv2, sz0, sz1, \
      sz2, w, cot3, B_g, saved, d_pts)
#define HPSDF_LAUNCH(D)          \
  if (mode == kNormalsVjp)       \
    HPSDF_MODE(D, kNormalsVjp);  \
  else                           \
    HPSDF_MODE(D, kValuesGradVjp)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
#undef HPSDF_MODE
  return (int)cudaGetLastError();
}

// Blocks of K5h an SM holds at degree deg in mode `mode`
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *out.
extern "C" int hpsdf_packed_hvp_blocks(int deg, int mode, int* out) {
  if (mode != kNormalsVjp && mode != kValuesGradVjp)
    return (int)cudaErrorInvalidValue;
#define HPSDF_MODE(D, M)                                             \
  {                                                                  \
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(   \
        out, packed_hvp_kernel<D, M>, kHvpThreads, 0);               \
    if (e != cudaSuccess) return (int)e;                             \
  }
#define HPSDF_LAUNCH(D)          \
  if (mode == kNormalsVjp)       \
    HPSDF_MODE(D, kNormalsVjp)   \
  else                           \
    HPSDF_MODE(D, kValuesGradVjp)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
#undef HPSDF_MODE
  return 0;
}
