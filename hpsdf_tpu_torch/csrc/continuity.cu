// K9 and K9u: one iteration of the continuity solve's Jacobi-preconditioned
// conjugate gradient, in f64, with the iteration's scalars kept on the card.
//
// Replace the CG body of hpsdf_tpu/continuity.py _cg_solve (:367-434), which
// XLA runs as a segment_sum over the COO entries (the matvec, :401-405), two
// vdots and three axpys (:419-428) inside a while_loop. That loop is not a
// Pallas kernel; it is the continuity post-process's hot loop (the reference
// runs Eigen's CG, Source/HP/Octree.cpp:1749-1755). The plain torch versions
// are cg_matvec_plain and cg_update_plain in hpsdf_tpu_torch/continuity.py.
//
//   K9, cg_matvec_kernel: y = A p + s p over the CSR of the face-jump Gram
//       matrix A, and p.y; its finish sets alpha = rz / p.y.
//   K9u, cg_update_kernel: x += alpha p, r -= alpha y, and r.z and r.r with
//       z = r / diag (times the reciprocal, as the reference); then, after
//       a barrier across the launch (a cooperative launch), every block adds
//       the partial sums itself, and the new search direction
//       p = z + (rz_new / rz) p is written in the same launch: z is never
//       stored, and the reference's separate axpy on p is one pass fewer.
//       Block 0 then sets beta, rz, r.r, the count k and the reference's
//       stopping rule, r.r > tol^2 b.b and k < max_iter, as a flag on the
//       card.
//
// Scalars on the card. Each launch writes one partial sum a block; K9's last
// block to finish (an atomic count of the blocks done) and each of K9u's
// blocks add the partials in block order. A launch whose flag is down
// returns at once, so the host enqueues iterations in chunks and reads the
// flag once a chunk (continuity._cg_kernels): the iterate and the count are
// exactly those of a check every iteration. No atomic adds a value, so a
// solve repeats bit for bit on one card (the grid, and so the order of the
// sums, follows the card's occupancy).
//
// Bound. Both are bound by bytes. K9 reads each entry once (an f64 value
// and an i32 column, 12 bytes), the row offsets and p, and writes y: at the
// 260,604-leaf row (nnz 62,039,808, n 2,606,040) about 0.80 GB, 0.24 ms at
// 3.35 TB/s; its f64 operations (3 an entry) are 0.005 ms at 34 TFLOP/s.
// The gathered p (n * 8 bytes, 21 MB there) stays in L2. The rows are short
// (about 23 entries), so a group of 16 lanes takes a row: a warp reads 2
// consecutive rows, which are contiguous in the CSR, and each lane sums
// every 16th entry before a fixed tree of shuffles (8 and 32 lanes a row,
// several rows in flight a group and streaming loads of the entries were
// slower on the card; PERF.md section 6 has their times). K9u reads five
// vectors and writes three (64 bytes a row), and reads r, the reciprocal
// diagonal and p once more after its barrier (most of it from L2).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 16;                    // lanes a row in K9
constexpr int kRowsPerWarp = 32 / kLanes;
// the most blocks a launch takes (its partial sums: 2 a block for K9u)
constexpr int kMaxBlocks = 4096;

// the f64 scalars of the iteration (continuity._SC)
enum { kRz = 0, kAlpha, kBeta, kRr, kThresh, kPAp };
// and the integers (continuity._ST)
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

__global__ void __launch_bounds__(kThreads)
cg_matvec_kernel(const int32_t* __restrict__ rowptr,
                 const int32_t* __restrict__ col,
                 const double* __restrict__ val, int64_t n, double s,
                 const double* __restrict__ p, double* __restrict__ y,
                 double* __restrict__ partials, double* sc, int* st) {
  __shared__ double smem[kWarps];
  __shared__ bool last;
  if (!st[kActive]) return;                   // uniform over the launch
  const int lane = threadIdx.x & (kLanes - 1);
  const int sub = (threadIdx.x & 31) / kLanes;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  double pap[1] = {0.0};
  // every lane of a warp takes every round, so the shuffles are whole
  for (int64_t base = warp * kRowsPerWarp; base < n;
       base += warps * kRowsPerWarp) {
    const int64_t i = base + sub;
    double sum = 0.0;
    if (i < n) {
      const int e1 = __ldg(rowptr + i + 1);
      for (int e = __ldg(rowptr + i) + lane; e < e1; e += kLanes)
        sum = __fma_rn(__ldg(val + e), __ldg(p + __ldg(col + e)), sum);
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (i < n && lane == 0) {
      const double pi = p[i];
      const double yi = __fma_rn(s, pi, sum);
      y[i] = yi;
      pap[0] = __fma_rn(pi, yi, pap[0]);
    }
  }
  block_sum(pap, smem);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = pap[0];
    __threadfence();
    last = atomicAdd(reinterpret_cast<unsigned*>(st + kCount), 1u) ==
           gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;                          // the last block finishes
  __threadfence();
  double total[1];
  sum_partials(partials, total, smem);
  if (threadIdx.x == 0) {
    st[kCount] = 0;
    sc[kPAp] = total[0];
    sc[kAlpha] = sc[kRz] / total[0];
  }
}

// A cooperative launch (every block resident).
template <bool INIT>
__global__ void __launch_bounds__(kThreads)
cg_update_kernel(int64_t n, const double* __restrict__ Ap,
                 const double* __restrict__ minv, double* __restrict__ x,
                 double* __restrict__ r, double* __restrict__ p,
                 double* __restrict__ partials, double* sc, int* st) {
  __shared__ double smem[2 * kWarps];
  __shared__ double beta;
  if (!INIT && !st[kActive]) return;          // uniform over the launch
  const double alpha = INIT ? 0.0 : sc[kAlpha];
  const double rz = sc[kRz];                  // before block 0 rewrites it
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
    v[0] = __fma_rn(ri, zi, v[0]);
    v[1] = __fma_rn(ri, ri, v[1]);
  }
  block_sum(v, smem);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = v[0];
    partials[gridDim.x + blockIdx.x] = v[1];
  }
  cg::this_grid().sync();
  double total[2];
  sum_partials(partials, total, smem);        // the same sums in every block
  if (threadIdx.x == 0) beta = INIT ? 0.0 : total[0] / rz;
  __syncthreads();
  const double b = beta;
  // each thread rewrites the indices it updated: z = minv r again, bit for
  // bit, and p = z + beta p (p = z in the first form)
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const double zi = __dmul_rn(__ldg(minv + i), r[i]);
    p[i] = INIT ? zi : __fma_rn(b, p[i], zi);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int k = INIT ? 0 : st[kK] + 1;
    sc[kBeta] = b;
    sc[kRz] = total[0];
    sc[kRr] = total[1];
    st[kK] = k;
    st[kActive] = total[1] > sc[kThresh] && k < st[kMaxIter];
  }
}

// The blocks a launch of `kernel` takes for `work` items of `per_block`:
// no more than stay resident on the card at once, so a grid-stride loop
// has no tail wave and a cooperative launch fits.
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

cudaError_t launch_matvec(const int32_t* rowptr, const int32_t* col,
                          const double* val, int64_t n, double s,
                          const double* p, double* y, double* partials,
                          double* sc, int* st, cudaStream_t stream) {
  static int cache = 0;
  const int blocks = grid_for(cg_matvec_kernel, n, kWarps * kRowsPerWarp,
                              &cache);
  cg_matvec_kernel<<<blocks, kThreads, 0, stream>>>(rowptr, col, val, n, s, p,
                                                   y, partials, sc, st);
  return cudaGetLastError();
}

template <bool INIT>
cudaError_t launch_update(int64_t n, const double* Ap, const double* minv,
                          double* x, double* r, double* p, double* partials,
                          double* sc, int* st, cudaStream_t stream) {
  static int cache = 0;
  int blocks = grid_for(cg_update_kernel<INIT>, n, kThreads, &cache);
  void* args[] = {&n, &Ap, &minv, &x, &r, &p, &partials, &sc, &st};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)cg_update_kernel<INIT>, dim3(blocks), dim3(kThreads), args,
      0, stream);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  return cudaGetLastError();
}

}  // namespace

// Bytes of the partial sums a launch of either kernel needs.
extern "C" int64_t hpsdf_cg_scratch() { return 2 * kMaxBlocks * 8; }

// K9 once: y = A p + s p, sc[alpha] = sc[rz] / p.y (a no-op if st's flag is
// down).
extern "C" int hpsdf_cg_matvec(const int32_t* rowptr, const int32_t* col,
                               const double* val, int64_t n, double s,
                               const double* p, double* y, double* partials,
                               double* sc, int* st, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  return (int)launch_matvec(rowptr, col, val, n, s, p, y, partials, sc, st,
                            (cudaStream_t)stream);
}

// K9u once. init = 0: x += alpha p, r -= alpha Ap, then r.z, r.r, beta,
// p = z + beta p, k + 1 and the flag into sc / st (z = minv r). init = 1:
// p = z and the state of iteration 0 (x and Ap are not read).
extern "C" int hpsdf_cg_update(int init, int64_t n, const double* Ap,
                               const double* minv, double* x, double* r,
                               double* p, double* partials, double* sc,
                               int* st, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream_ = (cudaStream_t)stream;
  return (int)(init ? launch_update<true>(n, Ap, minv, x, r, p, partials, sc,
                                          st, stream_)
                    : launch_update<false>(n, Ap, minv, x, r, p, partials,
                                           sc, st, stream_));
}

// `iters` iterations: K9 then K9u, each launched every iteration (a no-op
// once the flag is down).
extern "C" int hpsdf_cg_iterations(const int32_t* rowptr, const int32_t* col,
                                   const double* val, int64_t n, double s,
                                   const double* minv, double* x, double* r,
                                   double* p, double* Ap, double* partials,
                                   double* sc, int* st, int iters,
                                   void* stream) {
  if (n <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream_ = (cudaStream_t)stream;
  for (int it = 0; it < iters; ++it) {
    cudaError_t e = launch_matvec(rowptr, col, val, n, s, p, Ap, partials,
                                  sc, st, stream_);
    if (e != cudaSuccess) return (int)e;
    e = launch_update<false>(n, Ap, minv, x, r, p, partials, sc, st,
                             stream_);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
