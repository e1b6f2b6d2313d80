// K7's form 2 as it was before its redesign, kept as the reference of
// packed_grad.cu's normals_grad_kernel: the VJP of the unit normals (K5's
// normals, normals_vjp_plain) with respect to the packed tables, in one
// cooperative launch that locates each point's row, groups the points by
// row over the 8^grid_depth grid cells and the node rows (group.cuh, the
// counters a line apart up to 2^16 keys, kGroupPerSM blocks on every
// multiprocessor), evaluates the row's gradient g for the unit vector's
// VJP where it places each point's record (K5's read, packed_leaf_sums),
// clears both tables, then sums chunks of kSeg places a warp. Only form 2
// is instantiated here; forms 0 and 1 are packed_grad.cu's. chip_smoke.py
// builds this file apart from the library (_kernels.load_check), holds the
// shipped kernel to it and times both in the same run. It is on no path of
// the package. The arithmetic is described in packed_grad.cu.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../group.cuh"
#include "../packed_rows.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupPerSM = 6;        // blocks a multiprocessor
// the places of the row order a warp sums at a time (a chunk)
constexpr int kSeg = 64;

template <int DEG, int FORM>
struct Terms {
  static constexpr int N = DEG + 1;                   // a Legendre table
  static constexpr int C = N * (N + 1) * (N + 2) / 6;
  // a point's tables in shared memory: L_x (times w in form 0), L_y, L_z
  // and, form 1, u_a (scale / size_a) dL_a for each axis; one more float so
  // that the points' strides are odd (stores without bank conflicts)
  static constexpr int S = (FORM == 0 ? 3 : 6) * N + 1;
  // the row lanes a lane may sum into: lane + 32 k
  static constexpr int OUT = (hpsdf::kCoeffLane + C + 31) / 32;
  // the points whose tables a lane computes at once (two where the block's
  // tables fit in 40 KB), and a warp's batch
  static constexpr int PPL = kWarps * 64 * S * 4 <= 40960 ? 2 : 1;
  static constexpr int BATCH = 32 * PPL;
  // float4s of a point's record, its unit-cube coordinates u and its
  // cotangent: (u, w), or (u, c_0) and (c_1, c_2, 0, 0), form 1's
  // cotangent c_a times the clamp's slope, form 2's gb_a / size_a
  static constexpr int REC = FORM == 0 ? 1 : 2;
};

// Basis term m's (i, j, k) in for_each_term's order (by total degree, then
// i, then j), packed as i | j << 8 | k << 16.
__device__ __forceinline__ int term_ijk(int m) {
  for (int p = 0;; ++p) {
    const int n = (p + 1) * (p + 2) / 2;
    if (m < n) {
      for (int i = 0;; ++i) {
        if (m <= p - i) return i | (m << 8) | ((p - i - m) << 16);
        m -= p - i + 1;
      }
    }
    m -= n;
  }
}

struct Inputs {
  const float* grid;
  const float* rows;
  int W, gd, extra, G3;
  const float* pts;
  const float* cot;
  float rc[3], inv[3], sz[3];

  // the point's unit-cube coordinates, clamped into the root, and the
  // clamp's slope on each axis
  __device__ __forceinline__ void unit(int64_t b, float (&u)[3],
                                       float (&slope)[3]) const {
    hpsdf::unit_point(pts + 3 * b, rc, inv, u, slope);
  }

  // the row the point reads (locate_row4): key < G3 the grid row key,
  // else node row key - G3
  __device__ __forceinline__ int key(int64_t b) const {
    float u[3], slope[3];
    unit(b, u, slope);
    int k = hpsdf::grid_cell(gd, u);
    const float* row = grid + (int64_t)k * W;
    for (int r = 0; r < extra; ++r) {
      const float4 m = __ldg(reinterpret_cast<const float4*>(row));
      const int child = __float_as_int(m.x) - 1;
      if (child < 0) break;
      const int oct = (u[0] >= m.z) | ((u[1] >= m.w) << 1) |
                      ((u[2] >= __ldg(row + 4)) << 2);
      k = G3 + child + oct;
      row = rows + (int64_t)(child + oct) * W;
    }
    return k;
  }

  __device__ __forceinline__ const float* row(int64_t k) const {
    return k < G3 ? grid + k * W : rows + (k - G3) * W;
  }

  // point b's record (Terms::REC float4s at r); it reads row k
  template <int DEG, int FORM>
  __device__ __forceinline__ void record(int64_t b, int64_t k,
                                         float4* r) const {
    float u[3], slope[3];
    unit(b, u, slope);
    if constexpr (FORM == 0) {
      r[0] = make_float4(u[0], u[1], u[2], cot[b]);
    } else {
      float c[3];
      if constexpr (FORM == 1) {
#pragma unroll
        for (int a = 0; a < 3; ++a)
          c[a] = slope[a] > 0.0f ? slope[a] * cot[3 * b + a] : 0.0f;
      } else {
        // the normal's gradient at the point (K5's read of row k, one
        // 4-byte load a term: the registers of the whole launch bound its
        // blocks a multiprocessor), then the unit vector's VJP
        float v, G[3], h[6], wn[3], gb[3];
        const float scale =
            hpsdf::packed_leaf_sums<DEG, hpsdf::kSumGrad, true, 0>(
                row(k), u, true, false, v, G, h);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          G[a] = G[a] * scale / sz[a];
          wn[a] = cot[3 * b + a];
        }
        hpsdf::unit_vector_vjp(G, wn, 1e-12f, gb);
#pragma unroll
        for (int a = 0; a < 3; ++a) c[a] = gb[a] / sz[a];
      }
      r[0] = make_float4(u[0], u[1], u[2], c[0]);
      r[1] = make_float4(c[1], c[2], 0.0f, 0.0f);
    }
  }

  // a point's tables (Terms::S floats at t) from its record, in the frame
  // of the row k it reads
  template <int DEG, int FORM>
  __device__ __forceinline__ void tables(const float4* r, int64_t k,
                                         float* t) const {
    constexpr int N = DEG + 1;
    const float* rw = row(k);
    const float4 meta = __ldg(reinterpret_cast<const float4*>(rw));
    const float centre[3] = {meta.z, meta.w, __ldg(rw + 4)};
    const float scale = meta.y;
    const float4 r0 = __ldcg(r);
    const float u[3] = {r0.x, r0.y, r0.z};
    float L[3][N];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      hpsdf::legendre<DEG>((u[a] - centre[a]) * scale, L[a]);
    if constexpr (FORM == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        t[i] = r0.w * L[0][i];
        t[N + i] = L[1][i];
        t[2 * N + i] = L[2][i];
      }
    } else {
      const float4 r1 = __ldcg(r + 1);
      const float c[3] = {r0.w, r1.x, r1.y};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float dL[N];
        hpsdf::legendre_deriv<DEG>(L[a], dL);
        const float ua = FORM == 1 ? c[a] * (scale * inv[a]) : c[a] * scale;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          t[a * N + i] = L[a][i];
          t[(3 + a) * N + i] = ua * dL[i];
        }
      }
    }
  }
};

// The sums one lane keeps for a row: row lane lane + 32 k, its term's
// offsets into a point's tables, and whether it is a coefficient lane.
template <int DEG, int FORM>
struct LaneTerms {
  using T = Terms<DEG, FORM>;
  int o[3][T::OUT];
  bool coeff[T::OUT];

  __device__ __forceinline__ LaneTerms() {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < T::OUT; ++k) {
      const int m = lane + 32 * k - hpsdf::kCoeffLane;
      coeff[k] = m >= 0 && m < T::C;
      const int ijk = coeff[k] ? term_ijk(m) : 0;
      o[0][k] = ijk & 255;
      o[1][k] = T::N + ((ijk >> 8) & 255);
      o[2][k] = 2 * T::N + (ijk >> 16);
    }
  }

  // acc += the terms of the point whose tables are at t
  __device__ __forceinline__ void add(const float* t,
                                      float (&acc)[T::OUT]) const {
    constexpr int N = T::N;
#pragma unroll
    for (int k = 0; k < T::OUT; ++k) {
      const float lx = t[o[0][k]], ly = t[o[1][k]], lz = t[o[2][k]];
      if constexpr (FORM == 0) {
        acc[k] += lx * ly * lz;
      } else {
        acc[k] += t[o[0][k] + 3 * N] * ly * lz + lx * t[o[1][k] + 3 * N] * lz +
                  lx * ly * t[o[2][k] + 3 * N];
      }
    }
  }

  // A row's sums over its points in a chunk, then acc zeroed: stored in
  // the row's coefficient lanes where those are all its points, else added
  // there (the row was cleared).
  __device__ __forceinline__ void emit(float* dst, bool whole,
                                       float (&acc)[T::OUT]) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < T::OUT; ++k) {
      if (coeff[k]) {
        if (whole)
          dst[lane + 32 * k] = acc[k];
        else
          atomicAdd(dst + lane + 32 * k, acc[k]);
      }
      acc[k] = 0.0f;
    }
  }
};

template <int DEG, int FORM>
__global__ void __launch_bounds__(kThreads)
packed_grad_form2_reference_kernel(const float* __restrict__ grid,
                   const float* __restrict__ rows, int W, int gd, int extra,
                   int Np, const float* __restrict__ pts, int64_t B,
                   float rc0, float rc1, float rc2, float inv0, float inv1,
                   float inv2, float sz0, float sz1, float sz2,
                   const float* __restrict__ cot, int cs,
                   void* __restrict__ scratch, float* __restrict__ d_grid,
                   float* __restrict__ d_rows) {
  using T = Terms<DEG, FORM>;
  __shared__ float s_tab[kWarps][T::BATCH * T::S];
  const int lane = threadIdx.x & 31;
  const Inputs in{grid, rows, W, gd, extra, 1 << (3 * gd), pts, cot,
                  {rc0, rc1, rc2}, {inv0, inv1, inv2}, {sz0, sz1, sz2}};
  const int K = in.G3 + Np;
  // scratch (scratch_bytes): the records, the keys, the row order, the
  // grouping's counters
  float4* recs = static_cast<float4*>(scratch);
  int32_t* keys = reinterpret_cast<int32_t*>(recs + B * T::REC);
  int32_t* sorted = keys + B;
  int32_t* cnt = sorted + B;
  auto clear = [&](int64_t i, int64_t n) {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int64_t q = i; q < (int64_t)in.G3 * W / 4; q += n)
      reinterpret_cast<float4*>(d_grid)[q] = z;
    for (int64_t q = i; q < (int64_t)Np * W / 4; q += n)
      reinterpret_cast<float4*>(d_rows)[q] = z;
  };
  auto place = [&](int64_t b, int pos, int k) {
    sorted[pos] = k;
    in.record<DEG, FORM>(b, k, recs + (int64_t)pos * T::REC);
  };
  hpsdf::group_by_key<kThreads>(
      B, K, [&](int64_t b) { return in.key(b); }, keys, cnt, cs,
      cnt + (int64_t)cs * K, clear, place);

  // 4. a warp a chunk of kSeg places of the row order: each row's sums
  // there, stored where all the row's points lie in the chunk (the keys
  // just before and after it are another row's), else added
  const LaneTerms<DEG, FORM> lt;
  float* tab = s_tab[threadIdx.x >> 5];
  auto dst = [&](int k) {
    return (k < in.G3 ? d_grid + (int64_t)k * W
                      : d_rows + (int64_t)(k - in.G3) * W);
  };
  const int warp_id = (int)(((int64_t)blockIdx.x * kThreads + threadIdx.x)
                            >> 5);
  const int n_warps = (int)(((int64_t)gridDim.x * kThreads) >> 5);
  const int n_chunks = (int)((B + kSeg - 1) / kSeg);
  for (int c = warp_id; c < n_chunks; c += n_warps) {
    const int j0 = c * kSeg, j1 = (int)min(B, (int64_t)j0 + kSeg);
    const int before = j0 > 0 ? __ldcg(sorted + j0 - 1) : -1;
    const int after = j1 < B ? __ldcg(sorted + j1) : -1;
    int cur = -1;
    bool whole = true;                 // cur began in this chunk
    float acc[T::OUT] = {};
    for (int jb = j0; jb < j1; jb += T::BATCH) {        // warp-uniform
      int key[T::PPL];
#pragma unroll
      for (int q = 0; q < T::PPL; ++q) {
        const int j = jb + 32 * q + lane;
        key[q] = j < j1 ? __ldcg(sorted + j) : -1;
        if (j < j1)
          in.tables<DEG, FORM>(recs + (int64_t)j * T::REC, key[q],
                               tab + (32 * q + lane) * T::S);
      }
      __syncwarp();
      const int nb = min(T::BATCH, j1 - jb);
      for (int n = 0; n < nb; ++n) {
        int kq = key[0];
        if constexpr (T::PPL == 2) kq = n < 32 ? key[0] : key[1];
        const int kn = __shfl_sync(0xffffffffu, kq, n & 31);
        if (kn != cur) {
          if (cur >= 0) lt.emit(dst(cur), whole, acc);
          whole = cur >= 0 || kn != before;
          cur = kn;
        }
        lt.add(tab + n * T::S, acc);
      }
      __syncwarp();
    }
    lt.emit(dst(cur), whole && cur != after, acc);
  }
}

template <int DEG, int FORM>
cudaError_t launch(void** args, cudaStream_t s) {
  static int grid_cache = 0;
  const int blocks =
      hpsdf::group_grid(packed_grad_form2_reference_kernel<DEG, FORM>,
                        kThreads, kGroupPerSM, &grid_cache);
  if (blocks <= 0) return cudaErrorInvalidConfiguration;
  return cudaLaunchCooperativeKernel(
      (const void*)packed_grad_form2_reference_kernel<DEG, FORM>,
      dim3(blocks), dim3(kThreads), args, 0, s);
}

// The bytes of scratch a launch takes for B points into K rows: each
// point's record (Terms::REC float4s), its key and its place in the row
// order, then the grouping's counters; -1 where 32-bit indices do not
// reach.
int64_t scratch_bytes(int64_t B, int gd, int64_t Np, int form) {
  if (form < 0 || form > 2 || B < 0 || 2 * B >= INT32_MAX || Np < 0 ||
      gd < 0 || gd > 10)
    return -1;
  const int64_t counts = hpsdf::group_ints((int64_t{1} << (3 * gd)) + Np);
  return counts < 0 ? -1
                    : 16 * (form == 0 ? 1 : 2) * B + 4 * (2 * B + counts);
}

}  // namespace

extern "C" int64_t hpsdf_packed_grad_form2_reference_scratch(int64_t B,
                                                             int gd, int Np) {
  return scratch_bytes(B, gd, Np, 2);
}

// K7's form 2 as hpsdf_packed_grad ran it before its redesign (cot = wn
// (B, 3), the normals' cotangents): d_grid and d_rows, every row written.
// One cooperative launch.
extern "C" int hpsdf_packed_grad_form2_reference(
    const float* grid, const float* rows, int W, int deg, int gd, int extra,
    int Np, const float* pts, int64_t B, float rc0, float rc1, float rc2,
    float inv0, float inv1, float inv2, float sz0, float sz1, float sz2,
    const float* cot, void* scratch, int64_t scratch_size, float* d_grid,
    float* d_rows, void* stream) {
  const int64_t need = scratch_bytes(B, gd, Np, 2);
  if (need < 0 || scratch_size < need || W % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)scratch % 16 != 0 || (uintptr_t)d_grid % 16 != 0 ||
      (uintptr_t)d_rows % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  int cs = hpsdf::counter_stride((int64_t{1} << (3 * gd)) + Np);
  void* args[] = {&grid, &rows,  &W,    &gd,   &extra, &Np,     &pts,
                  &B,    &rc0,   &rc1,  &rc2,  &inv0,  &inv1,   &inv2,
                  &sz0,  &sz1,   &sz2,  &cot,  &cs,    &scratch, &d_grid,
                  &d_rows};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
#define HPSDF_LAUNCH(D) e = launch<D, 2>(args, s)
  HPSDF_DISPATCH_DEG(deg, HPSDF_LAUNCH)
#undef HPSDF_LAUNCH
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}
