// G's backward as it was before its redesign, kept as the reference of
// row_gather.cu's row_scatter kernels: d_table[idx[b], :] += d_out[b, :],
// out-of-range indices dropped, one thread an index adding its row a float4
// at a time with one float atomic a lane, into a table the caller zeroed.
// chip_smoke.py builds this file apart from the library
// (_kernels.load_check), holds the shipped kernels to it and times both in
// the same run. It is on no path of the package.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
row_scatter_reference_kernel(const float* __restrict__ d_out, int64_t W,
                             const int32_t* __restrict__ idx, int64_t B,
                             int64_t N, float* __restrict__ d_table) {
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
extern "C" int hpsdf_row_scatter_reference(const float* d_out, int64_t W,
                                           const int32_t* idx, int64_t B,
                                           int64_t N, float* d_table,
                                           void* stream) {
  if (W % 4 != 0 || (uintptr_t)d_out % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  row_scatter_reference_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      d_out, W, idx, B, N, d_table);
  return (int)cudaGetLastError();
}
