// G: row gather out[b, :] = table[idx[b], :], zeros where idx is outside
// [0, N), in f32.
//
// Replaces the three Pallas row gathers of experiments/gather_probe.py:
// pallas_loop / loop_kernel (G1, a fori_loop of dynamic row slices),
// pallas_take / take_kernel (G2, jnp.take with fill_value=0.0, whose
// out-of-range rule this keeps) and pallas_tal / tal_kernel (G3, the same on
// the transposed table; the port keeps rows contiguous, so one kernel serves
// all three). The plain torch version is row_gather_plain in
// hpsdf_tpu_torch/accel.py. On the port's path it derives the packed grid
// from the rows (accel.pack_tree / repack_folded).
//
// Bound. Pure data movement: B*W*4 bytes written (128 MB at 2^20 x 32) and
// as many read from a table that is small enough to stay in L2 (4681 x 32 x 4
// = 0.6 MB; the mesh's 32,768 x 32 rows, 4.2 MB). So it is bound by device
// memory write bandwidth. The design: one thread per 16-byte quarter of an
// output row (float4 loads and stores; the rows of neighbouring threads are
// contiguous, so stores coalesce), a grid-stride loop, and the index read
// through the read-only cache (the W/4 threads of a row share it). Every
// table on the path has a width that is a multiple of 4 floats (packed
// rows: 8; triangle rows: 32); the wrapper refuses any other layout.
//
// G's backward: d_table[idx[b], :] += d_out[b, :], out-of-range indices
// dropped; the plain torch versions are row_scatter_plain (index_add_) and
// row_scatter_csr_plain in accel.py. On the port's path it carries the
// grid's gradient back to the packed rows in repack_folded, where a shallow
// leaf copied into many grid cells receives many rows. Bound: the B*W*4
// bytes of d_out read once and d_table's bytes written once. Adding with one
// float atomic a lane (the earlier form, kept as
// csrc/check/row_scatter_reference.cu) serialises on rows shared by many
// indices, costs an atomic a float where they are not, and needs a zeroed
// table. So the indices are grouped by destination row first and each row
// is a gather-sum: one warp (a block for a row of many sources) reads its
// sources' rows with 16-byte loads, sums them in a fixed order and writes
// the row once, zeros included. Two forms:
//   * row_scatter_csr_kernel, with the inverse of idx given by the caller
//     as CSR (row offsets, then the indices b of each row, ascending). The
//     repack's grid sources are fixed for a tree, so pack_support builds
//     theirs once on the host. One plain launch, deterministic.
//   * row_scatter_kernel, any idx: a cooperative launch groups the indices
//     itself (group.cuh: a counting sort across the launch's blocks), then
//     sums. The order within a row follows the sort's atomics, so the last
//     bits of a sum can change between launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "group.cuh"

namespace {

constexpr int kThreads = 256;

// W, the table's row stride and both base pointers are multiples of 4
// floats (checked by the wrapper, accel.row_gather).
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float* __restrict__ table, int64_t N, int64_t W,
                  int64_t stride, const int32_t* __restrict__ idx, int64_t B,
                  float* __restrict__ out) {
  const int64_t per_row = W / 4;
  const int64_t total = B * per_row;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = e / per_row;
    const int64_t q = e - b * per_row;
    const int r = __ldg(idx + b);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r >= 0 && r < N)
      v = __ldg(reinterpret_cast<const float4*>(table + r * stride) + q);
    reinterpret_cast<float4*>(out + b * W)[q] = v;
  }
}

// --- G's backward ----------------------------------------------------------

constexpr int kWarps = kThreads / 32;
// a row of more sources than this many a group of lanes (RowLanes) is
// summed by the whole block, not by one warp
constexpr int kWarpRounds = 8;
constexpr int kGroupPerSM = 8;        // blocks a multiprocessor, grouping

// How the lanes of a warp cover a row of P float4s: L lanes a source (P
// rounded up to a power of two, at most 32) and G = 32 / L sources side by
// side; this lane reads column q0 (+ L, + 2L, ...) of source group sub.
struct RowLanes {
  int L, G, sub, q0;
  __device__ __forceinline__ explicit RowLanes(int64_t P) {
    L = 1;
    while (L < P && L < 32) L <<= 1;
    G = 32 / L;
    sub = (threadIdx.x & 31) / L;
    q0 = (threadIdx.x & 31) % L;
  }
};

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
}

// Column q of the rows of sources order[j], j = s + first, s + first +
// step, ... below e, summed in that order.
__device__ __forceinline__ float4 column_part(
    const float4* __restrict__ src, int64_t P, int64_t q,
    const int32_t* order, int s, int e, int first, int step) {
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int j = s + first; j < e; j += step)
    add4(acc, __ldg(src + (int64_t)__ldcg(order + j) * P + q));
  return acc;
}

// a summed over the lanes `from`, 2 `from`, ... apart (the source groups of
// a warp), the same bits in every lane
__device__ __forceinline__ float4 across_groups(float4 a, int from) {
  for (int o = from; o < 32; o <<= 1) {
    a.x += __shfl_xor_sync(0xffffffffu, a.x, o);
    a.y += __shfl_xor_sync(0xffffffffu, a.y, o);
    a.z += __shfl_xor_sync(0xffffffffu, a.z, o);
    a.w += __shfl_xor_sync(0xffffffffu, a.w, o);
  }
  return a;
}

// Rows r0 .. r0 + kWarps - 1 (those below N) of d_table (N, 4P), each the
// sum of the rows of d_out (B, 4P) of its sources order[s, e), seg(r, s, e):
// one warp a row, then the whole block for each row of more than
// kWarpRounds * G sources. Zero sources write zeros. Every thread of the
// block calls it.
template <class Seg>
__device__ __forceinline__ void sum_row_group(const float* __restrict__ d_out,
                                              int64_t P, const int32_t* order,
                                              int64_t N, int64_t r0, Seg seg,
                                              float* __restrict__ d_table,
                                              float4 (*part)[32]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const RowLanes ln(P);
  const int alone = kWarpRounds * ln.G;
  const float4* src = reinterpret_cast<const float4*>(d_out);
  float4* dst = reinterpret_cast<float4*>(d_table);
  const int64_t r = r0 + warp;
  if (r < N) {                                   // warp-uniform
    int s, e;
    seg(r, s, e);
    if (e - s <= alone) {
      for (int64_t c = 0; c < P; c += ln.L) {
        const int64_t q = c + ln.q0;
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (q < P) acc = column_part(src, P, q, order, s, e, ln.sub, ln.G);
        acc = across_groups(acc, ln.L);
        if (q < P && ln.sub == 0) dst[r * P + q] = acc;
      }
    }
  }
  for (int w = 0; w < kWarps && r0 + w < N; ++w) {   // block-uniform
    int s, e;
    seg(r0 + w, s, e);
    if (e - s <= alone) continue;
    for (int64_t c = 0; c < P; c += ln.L) {
      const int64_t q = c + ln.q0;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (q < P)
        acc = column_part(src, P, q, order, s, e, warp * ln.G + ln.sub,
                          kWarps * ln.G);
      part[warp][lane] = across_groups(acc, ln.L);
      __syncthreads();
      if (warp == 0) {
        float4 t = part[0][lane];
        for (int v = 1; v < kWarps; ++v) add4(t, part[v][lane]);
        if (q < P && ln.sub == 0) dst[(r0 + w) * P + q] = t;
      }
      __syncthreads();
    }
  }
}

// The CSR form: the inverse of idx given (offsets (N + 1), order).
__global__ void __launch_bounds__(kThreads)
row_scatter_csr_kernel(const float* __restrict__ d_out, int64_t W,
                       const int32_t* __restrict__ offsets,
                       const int32_t* __restrict__ order, int64_t N,
                       float* __restrict__ d_table) {
  __shared__ float4 part[kWarps][32];
  sum_row_group(d_out, W / 4, order, N, (int64_t)blockIdx.x * kWarps,
                [&](int64_t r, int& s, int& e) {
                  s = __ldg(offsets + r);
                  e = __ldg(offsets + r + 1);
                },
                d_table, part);
}

// The ints of scratch the general form takes: the row order of the
// indices, then the grouping's counters; -1 where 32-bit indices do not
// reach.
int64_t scratch_ints(int64_t B, int64_t N) {
  const int64_t counts = hpsdf::group_ints(N);
  return B < 0 || B >= INT32_MAX || counts < 0 ? -1 : B + counts;
}

// The general form, in a cooperative launch: group the indices by row
// (group.cuh), then sum each row. scratch: scratch_ints(B, N) ints.
__global__ void __launch_bounds__(kThreads)
row_scatter_kernel(const float* __restrict__ d_out, int64_t W,
                   const int32_t* __restrict__ idx, int64_t B, int64_t N,
                   int cs, int32_t* __restrict__ scratch,
                   float* __restrict__ d_table) {
  __shared__ float4 part[kWarps][32];
  int32_t* order = scratch;
  int32_t* cnt = order + B;
  const hpsdf::Groups g = hpsdf::group_by_key<kThreads>(
      B, (int)N,
      [&](int64_t b) {
        const int r = __ldg(idx + b);
        return r >= 0 && r < N ? r : -1;
      },
      nullptr, cnt, cs, cnt + cs * N, [](int64_t, int64_t) {},
      [&](int64_t b, int pos, int) { order[pos] = (int)b; });
  for (int64_t r0 = (int64_t)blockIdx.x * kWarps; r0 < N;
       r0 += (int64_t)gridDim.x * kWarps)
    sum_row_group(d_out, W / 4, order, N, r0,
                  [&](int64_t r, int& s, int& e) {
                    s = g.start(r);
                    e = g.end(r);
                  },
                  d_table, part);
}

}  // namespace

// d_out (B, W) contiguous, W a multiple of 4, d_out and d_table 16-byte
// aligned; offsets (N + 1) and order the inverse of idx (accel.gather_csr).
// Writes every row of d_table (N, W).
extern "C" int hpsdf_row_scatter_csr(const float* d_out, int64_t W,
                                     const int32_t* offsets,
                                     const int32_t* order, int64_t N,
                                     float* d_table, void* stream) {
  if (W % 4 != 0 || (uintptr_t)d_out % 16 != 0 ||
      (uintptr_t)d_table % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (N <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((N + kWarps - 1) / kWarps);
  row_scatter_csr_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      d_out, W, offsets, order, N, d_table);
  return (int)cudaGetLastError();
}

// The bytes of scratch hpsdf_row_scatter takes for B indices into N rows,
// or -1 where 32-bit indices do not reach.
extern "C" int64_t hpsdf_row_scatter_scratch(int64_t B, int64_t N) {
  const int64_t n = scratch_ints(B, N);
  return n < 0 ? -1 : 4 * n;
}

// As hpsdf_row_scatter_csr for any idx (B), out-of-range indices dropped;
// scratch: hpsdf_row_scatter_scratch bytes. One cooperative launch.
extern "C" int hpsdf_row_scatter(const float* d_out, int64_t W,
                                 const int32_t* idx, int64_t B, int64_t N,
                                 int32_t* scratch, int64_t scratch_size,
                                 float* d_table, void* stream) {
  if (W % 4 != 0 || (uintptr_t)d_out % 16 != 0 ||
      (uintptr_t)d_table % 16 != 0 || (uintptr_t)scratch % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int64_t need = scratch_ints(B, N);
  if (W <= 0 || need < 0 || scratch_size < 4 * need)
    return (int)cudaErrorInvalidValue;
  static int grid_cache = 0;
  const int blocks = hpsdf::group_grid(row_scatter_kernel, kThreads,
                                       kGroupPerSM, &grid_cache);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  int cs = hpsdf::counter_stride(N);
  void* args[] = {&d_out, &W, &idx, &B, &N, &cs, &scratch, &d_table};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)row_scatter_kernel, dim3(blocks), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

extern "C" int hpsdf_row_gather(const float* table, int64_t N, int64_t W,
                                int64_t stride, const int32_t* idx, int64_t B,
                                float* out, void* stream) {
  if (W % 4 != 0 || stride % 4 != 0 || (uintptr_t)table % 16 != 0 ||
      (uintptr_t)out % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int64_t total = B * (W / 4);
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride beyond 64 per SM
  row_gather_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      table, N, W, stride, idx, B, out);
  return (int)cudaGetLastError();
}
