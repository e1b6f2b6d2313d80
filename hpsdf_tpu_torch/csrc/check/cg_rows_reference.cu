// K9u's two launches in the row-sharded CG as they were before their
// redesign, kept as the reference of continuity.cu's cg_update_rows_kernel
// and cg_direction_kernel (the plain versions: cg_update_rows_plain and
// cg_direction_plain in hpsdf_tpu_torch/continuity.py). A thread a row with
// 8-byte loads, a grid of at most the blocks that stay resident; each
// launch reads the flag, then its scalars. The first launch adds its
// blocks' partial sums in block order in its last block to finish (an
// atomic count of the blocks done); the second counts its blocks so that
// its last block rewrites rz after every block has read it.
// chip_smoke.py builds this file apart from the library
// (_kernels.load_check), holds the shipped kernels to it and times both in
// the same run. It is on no path of the package. The state's slots are
// continuity.cu's (continuity._SC, _ST); these kernels read and write only
// the slots that were there before the redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 4096;

enum { kRz = 0, kAlpha, kBeta, kRr, kThresh, kPAp, kRzPart, kRrPart };
enum { kK = 0, kMaxIter, kActive, kCount };

// Sums v over the block in a fixed order (a tree of shuffles in each warp,
// then warp 0 over the warps); thread 0 holds the sums.
template <int N>
__device__ __forceinline__ void block_sum(double (&v)[N], double* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] += __shfl_down_sync(0xffffffffu, v[j], o);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();                            // smem may hold a last read
  if (l == 0)
#pragma unroll
    for (int j = 0; j < N; ++j) smem[j * kWarps + w] = v[j];
  __syncthreads();
  if (w == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = l < kWarps ? smem[j * kWarps + l] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < N; ++j)
        v[j] += __shfl_down_sync(0xffffffffu, v[j], o);
  }
}

// The launch's partials (N a block, block-major within each sum) added in
// block order by the whole block; thread 0 holds the totals.
template <int N>
__device__ __forceinline__ void sum_partials(const double* partials,
                                             double (&total)[N],
                                             double* smem) {
#pragma unroll
  for (int j = 0; j < N; ++j) total[j] = 0.0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads)
#pragma unroll
    for (int j = 0; j < N; ++j)
      total[j] += __ldcg(partials + j * gridDim.x + b);
  block_sum(total, smem);
}

// Adds v[0..N) of every block in block order in the launch's last block to
// finish (an atomic count of the blocks done, reset by that block); true in
// that block, whose thread 0 holds the totals.
template <int N>
__device__ __forceinline__ bool last_block_sums(double (&v)[N],
                                                double* partials, int* st,
                                                double* smem, bool* last) {
  block_sum(v, smem);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) partials[j * gridDim.x + blockIdx.x] = v[j];
    __threadfence();
    *last = atomicAdd(reinterpret_cast<unsigned*>(st + kCount), 1u) ==
            gridDim.x - 1;
  }
  __syncthreads();
  if (!*last) return false;
  __threadfence();
  sum_partials(partials, v, smem);
  if (threadIdx.x == 0) st[kCount] = 0;
  return true;
}

// K9u's first launch in the row-sharded CG, over the rank's n rows: alpha =
// rz / p.Ap (p.Ap all-reduced), x += alpha p, r -= alpha Ap, z = r / diag
// (times the reciprocal) kept in z, and the rank's r.z and r.r into
// sc[kRzPart] and sc[kRrPart]. The first form (INIT) leaves x and r as they
// are (x, p and Ap are not read).
template <bool INIT>
__global__ void __launch_bounds__(kThreads)
cg_update_rows_reference_kernel(int64_t n, const double* __restrict__ Ap,
                                const double* __restrict__ minv,
                                double* __restrict__ x, double* __restrict__ r,
                                const double* __restrict__ p,
                                double* __restrict__ z,
                                double* __restrict__ partials, double* sc,
                                int* st) {
  __shared__ double smem[2 * kWarps];
  __shared__ bool last;
  if (!INIT && !st[kActive]) return;          // uniform over the launch
  const double alpha = INIT ? 0.0 : sc[kRz] / sc[kPAp];
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  double v[2] = {0.0, 0.0};                   // r.z, r.r
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    double ri = r[i];
    if (!INIT) {
      x[i] = __fma_rn(alpha, p[i], x[i]);
      ri = __fma_rn(-alpha, Ap[i], ri);
      r[i] = ri;
    }
    const double zi = __dmul_rn(__ldg(minv + i), ri);
    z[i] = zi;
    v[0] = __fma_rn(ri, zi, v[0]);
    v[1] = __fma_rn(ri, ri, v[1]);
  }
  if (!last_block_sums(v, partials, st, smem, &last) || threadIdx.x) return;
  if (!INIT) sc[kAlpha] = alpha;
  sc[kRzPart] = v[0];
  sc[kRrPart] = v[1];
}

// K9u's second launch in the row-sharded CG, over the rank's n rows: beta =
// r.z / rz (r.z all-reduced), p = z + beta p (the first form: p = z). Every
// block reads rz before it counts itself done, and the last block then sets
// beta, rz, r.r, the count k and the flag: r.r > tol^2 b.b and k < max_iter.
template <bool INIT>
__global__ void __launch_bounds__(kThreads)
cg_direction_reference_kernel(int64_t n, const double* __restrict__ z,
                              double* __restrict__ p, double* sc, int* st) {
  __shared__ bool last;
  if (!INIT && !st[kActive]) return;          // uniform over the launch
  const double rz_new = sc[kRzPart];
  const double beta = INIT ? 0.0 : rz_new / sc[kRz];
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    p[i] = INIT ? z[i] : __fma_rn(beta, p[i], z[i]);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(reinterpret_cast<unsigned*>(st + kCount), 1u) ==
           gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x) return;
  __threadfence();
  const int k = INIT ? 0 : st[kK] + 1;
  const double rr = sc[kRrPart];
  st[kCount] = 0;
  sc[kBeta] = beta;
  sc[kRz] = rz_new;
  sc[kRr] = rr;
  st[kK] = k;
  st[kActive] = rr > sc[kThresh] && k < st[kMaxIter];
}

// The blocks a launch of `kernel` takes for `work` items of `per_block`:
// no more than stay resident on the card at once, so a grid-stride loop
// has no tail wave.
template <typename K>
int grid_for(K kernel, int64_t work, int per_block, int* cache) {
  if (*cache == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    const int cap = sms * per_sm;
    *cache = cap < 1 ? 1 : (cap > kMaxBlocks ? kMaxBlocks : cap);
  }
  const int64_t need = (work + per_block - 1) / per_block;
  return (int)(need < 1 ? 1 : (need < *cache ? need : *cache));
}

}  // namespace

// K9u's first launch over n rows (init = 1: z = minv r and the dots only).
extern "C" int hpsdf_cg_update_rows_reference(int init, int64_t n,
                                              const double* Ap,
                                              const double* minv, double* x,
                                              double* r, const double* p,
                                              double* z, double* partials,
                                              double* sc, int* st,
                                              void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  static int cache[2] = {0, 0};
  cudaStream_t stream_ = (cudaStream_t)stream;
  if (init) {
    const int blocks = grid_for(cg_update_rows_reference_kernel<true>, n,
                                kThreads, cache);
    cg_update_rows_reference_kernel<true><<<blocks, kThreads, 0, stream_>>>(
        n, Ap, minv, x, r, p, z, partials, sc, st);
  } else {
    const int blocks = grid_for(cg_update_rows_reference_kernel<false>, n,
                                kThreads, cache + 1);
    cg_update_rows_reference_kernel<false><<<blocks, kThreads, 0, stream_>>>(
        n, Ap, minv, x, r, p, z, partials, sc, st);
  }
  return (int)cudaGetLastError();
}

// K9u's second launch over n rows (init = 1: p = z and iteration 0's state).
extern "C" int hpsdf_cg_direction_reference(int init, int64_t n,
                                            const double* z, double* p,
                                            double* sc, int* st,
                                            void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  static int cache[2] = {0, 0};
  cudaStream_t stream_ = (cudaStream_t)stream;
  if (init) {
    const int blocks = grid_for(cg_direction_reference_kernel<true>, n,
                                kThreads, cache);
    cg_direction_reference_kernel<true><<<blocks, kThreads, 0, stream_>>>(
        n, z, p, sc, st);
  } else {
    const int blocks = grid_for(cg_direction_reference_kernel<false>, n,
                                kThreads, cache + 1);
    cg_direction_reference_kernel<false><<<blocks, kThreads, 0, stream_>>>(
        n, z, p, sc, st);
  }
  return (int)cudaGetLastError();
}
