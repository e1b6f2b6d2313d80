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
// from the rows (accel.pack_tree / repack_folded) and fetches each point's
// winning triangle row for the mesh sign (mesh/sdf.py _signed_from_best).
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
// G's backward, row_scatter: d_table[idx[b], :] += d_out[b, :], out-of-range
// indices dropped; the plain torch version is row_scatter_plain (index_add_)
// in accel.py. On the port's path it carries the grid's gradient back to the
// packed rows in repack_folded, where a shallow leaf copied into many grid
// cells receives many rows. Bound: the B*W*4 bytes of d_out read once and
// d_table's bytes written once; what can serialise is the atomics on a row
// shared by many indices. A thread takes one index and adds its row a float4
// at a time, one atomic a lane. Summing a warp's lanes of one row in
// registers first (scatter.cuh, as K7 and K8 do) was timed and lost here, at
// the repack's grid and at 2^20 random indices alike (PERF.md, Findings).

#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void __launch_bounds__(kThreads)
row_scatter_kernel(const float* __restrict__ d_out, int64_t W,
                   const int32_t* __restrict__ idx, int64_t B, int64_t N,
                   float* __restrict__ d_table) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int r = __ldg(idx + b);
  if (r < 0 || r >= N) return;
  const float4* src = reinterpret_cast<const float4*>(d_out + b * W);
  float* dst = d_table + (int64_t)r * W;
  for (int64_t q = 0; q < W / 4; ++q) {
    const float4 v = __ldg(src + q);
    atomicAdd(dst + 4 * q, v.x), atomicAdd(dst + 4 * q + 1, v.y);
    atomicAdd(dst + 4 * q + 2, v.z), atomicAdd(dst + 4 * q + 3, v.w);
  }
}

}  // namespace

// d_table (N, W) must be zeroed by the caller; d_out (B, W) contiguous and
// 16-byte aligned, W a multiple of 4.
extern "C" int hpsdf_row_scatter(const float* d_out, int64_t W,
                                 const int32_t* idx, int64_t B, int64_t N,
                                 float* d_table, void* stream) {
  if (W % 4 != 0 || (uintptr_t)d_out % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  row_scatter_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      d_out, W, idx, B, N, d_table);
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
