// Development forms of K7 (csrc/packed_grad.cu), timed beside the shipped
// kernel by k7_forms.py and on no path of the package:
//   variant 0: the shipped cooperative kernel at per_sm blocks a
//     multiprocessor;
//   variant 1: block-level grouping (one plain launch after two fills): a
//     block sorts the keys of kTile consecutive points in shared memory
//     (cub::BlockRadixSort), each warp sums its quarter of the sorted tile
//     and adds each row's sums with one float atomic a lane into tables the
//     caller zeroed;
//   variant 2: the shipped phases in three plain launches, no cooperative
//     launch: (A) clear the tables, keys and counts, and the last block to
//     finish takes the runs; (B) placement; (C) the sums, then the
//     counters zeroed for the next call (the caller zeroes the scratch
//     once).
// Only degrees 3 and 5 are built.

#include <cub/block/block_radix_sort.cuh>

#include "../packed_grad.cu"

namespace {

constexpr int kItems = 8;                   // points a thread, variant 1
constexpr int kTile = kThreads * kItems;    // points a block, variant 1

// Inputs::tables from a record held in registers
template <int DEG, int FORM>
__device__ __forceinline__ void tables_of(const Inputs& in, const float4* r,
                                          int64_t k, float* t) {
  constexpr int N = DEG + 1;
  const float* rw = in.row(k);
  const float4 meta = __ldg(reinterpret_cast<const float4*>(rw));
  const float centre[3] = {meta.z, meta.w, __ldg(rw + 4)};
  const float scale = meta.y;
  const float4 r0 = r[0];
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
    const float4 r1 = r[1];
    const float c[3] = {r0.w, r1.x, r1.y};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float dL[N];
      hpsdf::legendre_deriv<DEG>(L[a], dL);
      const float ua = c[a] * (scale * in.inv[a]);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        t[a * N + i] = L[a][i];
        t[(3 + a) * N + i] = ua * dL[i];
      }
    }
  }
}

__device__ __forceinline__ float* dst_row(const Inputs& in, float* d_grid,
                                          float* d_rows, int k) {
  return k < in.G3 ? d_grid + (int64_t)k * in.W
                   : d_rows + (int64_t)(k - in.G3) * in.W;
}

// --- variant 1 ---------------------------------------------------------------

template <int DEG, int FORM>
__global__ void __launch_bounds__(kThreads)
k7_block_kernel(Inputs in, int K, int bits, int64_t B, float* d_grid,
                float* d_rows) {
  using T = Terms<DEG, FORM>;
  using Sort = cub::BlockRadixSort<int, kThreads, kItems, int>;
  __shared__ union {
    typename Sort::TempStorage sort;
    struct {
      int key[kTile];
      int pt[kTile];
    } s;
  } sh;
  __shared__ float s_tab[kWarps][T::BATCH * T::S];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tile0 = (int64_t)blockIdx.x * kTile;
  int keys[kItems], vals[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int v = threadIdx.x + i * kThreads;
    keys[i] = tile0 + v < B ? in.key(tile0 + v) : K;    // K sorts last
    vals[i] = v;
  }
  Sort(sh.sort).Sort(keys, vals, 0, bits);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    sh.s.key[threadIdx.x * kItems + i] = keys[i];
    sh.s.pt[threadIdx.x * kItems + i] = vals[i];
  }
  __syncthreads();
  const int n = (int)min((int64_t)kTile, B - tile0);
  constexpr int kPart = kTile / kWarps;
  const int j0 = warp * kPart, j1 = min(n, j0 + kPart);
  const LaneTerms<DEG, FORM> lt;
  float* tab = s_tab[warp];
  int cur = -1;
  float acc[T::OUT] = {};
  for (int jb = j0; jb < j1; jb += T::BATCH) {          // warp-uniform
    int key[T::PPL];
#pragma unroll
    for (int q = 0; q < T::PPL; ++q) {
      const int j = jb + 32 * q + lane;
      key[q] = j < j1 ? sh.s.key[j] : -1;
      if (j < j1) {
        float4 r[T::REC];
        in.record<FORM>(tile0 + sh.s.pt[j], r);
        tables_of<DEG, FORM>(in, r, key[q], tab + (32 * q + lane) * T::S);
      }
    }
    __syncwarp();
    const int nb = min(T::BATCH, j1 - jb);
    for (int m = 0; m < nb; ++m) {
      int kq = key[0];
      if constexpr (T::PPL == 2) kq = m < 32 ? key[0] : key[1];
      const int kn = __shfl_sync(0xffffffffu, kq, m & 31);
      if (kn != cur) {
        if (cur >= 0) lt.emit(dst_row(in, d_grid, d_rows, cur), false, acc);
        cur = kn;
      }
      lt.add(tab + m * T::S, acc);
    }
    __syncwarp();
  }
  if (cur >= 0) lt.emit(dst_row(in, d_grid, d_rows, cur), false, acc);
}

// --- variant 2 ---------------------------------------------------------------

struct Scratch {
  float4* recs;
  int32_t *keys, *sorted, *cnt, *beg, *ticket;
  int cs;
};

// hpsdf_packed_grad's scratch layout, then a ticket
template <int FORM>
__device__ __forceinline__ Scratch scratch_of(void* p, int64_t B, int K) {
  Scratch s;
  s.recs = static_cast<float4*>(p);
  s.keys = reinterpret_cast<int32_t*>(s.recs + B * Terms<3, FORM>::REC);
  s.sorted = s.keys + B;
  s.cnt = s.sorted + B;
  s.cs = hpsdf::counter_stride(K);
  s.beg = s.cnt + (int64_t)s.cs * K;
  s.ticket = s.beg + K + 1;
  return s;
}

template <int DEG, int FORM>
__global__ void __launch_bounds__(kThreads)
k7_count_kernel(Inputs in, int K, int64_t B, void* scratch, float* d_grid,
                float* d_rows) {
  const Scratch s = scratch_of<FORM>(scratch, B, K);
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t warp0 = (int64_t)blockIdx.x * kThreads + (threadIdx.x & ~31);
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int64_t q = warp0 + lane; q < (int64_t)in.G3 * in.W / 4; q += stride)
    reinterpret_cast<float4*>(d_grid)[q] = z;
  for (int64_t q = warp0 + lane; q < (int64_t)(K - in.G3) * in.W / 4;
       q += stride)
    reinterpret_cast<float4*>(d_rows)[q] = z;
  for (int64_t b0 = warp0; b0 < B; b0 += stride) {
    const int64_t b = b0 + lane;
    const int k = b < B ? in.key(b) : -1;
    if (b < B) s.keys[b] = k;
    const unsigned peers = __match_any_sync(0xffffffffu, k);
    if (k >= 0 && (__ffs(peers) - 1) == lane)
      atomicAdd(s.cnt + (int64_t)k * s.cs, __popc(peers));
  }
  // the last block to finish takes the runs
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(s.ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int64_t k0 = threadIdx.x & ~31; k0 < K; k0 += kThreads) {
    const int64_t k = k0 + lane;
    const int c = k < K ? __ldcg(s.cnt + k * s.cs) : 0;
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    int at = 0;
    if (lane == 31 && x > 0) at = atomicAdd(s.beg + K, x);
    at = __shfl_sync(0xffffffffu, at, 31) + x - c;
    if (k < K) s.beg[k] = at, s.cnt[k * s.cs] = at;
  }
  if (threadIdx.x == 0) *s.ticket = 0;
}

template <int DEG, int FORM>
__global__ void __launch_bounds__(kThreads)
k7_place_kernel(Inputs in, int K, int64_t B, void* scratch) {
  using T = Terms<DEG, FORM>;
  const Scratch s = scratch_of<FORM>(scratch, B, K);
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t warp0 = (int64_t)blockIdx.x * kThreads + (threadIdx.x & ~31);
  for (int64_t b0 = warp0; b0 < B; b0 += stride) {
    const int64_t b = b0 + lane;
    const int k = b < B ? __ldcg(s.keys + b) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, k);
    const int leader = __ffs(peers) - 1;
    int at = 0;
    if (k >= 0 && leader == lane)
      at = atomicAdd(s.cnt + (int64_t)k * s.cs, __popc(peers));
    at = __shfl_sync(0xffffffffu, at, leader);
    if (k >= 0) {
      const int pos = at + __popc(peers & ((1u << lane) - 1u));
      s.sorted[pos] = k;
      in.record<FORM>(b, s.recs + (int64_t)pos * T::REC);
    }
  }
}

template <int DEG, int FORM>
__global__ void __launch_bounds__(kThreads)
k7_sum_kernel(Inputs in, int K, int64_t B, void* scratch, float* d_grid,
              float* d_rows) {
  using T = Terms<DEG, FORM>;
  __shared__ float s_tab[kWarps][T::BATCH * T::S];
  const Scratch s = scratch_of<FORM>(scratch, B, K);
  const int lane = threadIdx.x & 31;
  const LaneTerms<DEG, FORM> lt;
  float* tab = s_tab[threadIdx.x >> 5];
  const int warp_id = (int)(((int64_t)blockIdx.x * kThreads + threadIdx.x)
                            >> 5);
  const int n_warps = (int)(((int64_t)gridDim.x * kThreads) >> 5);
  const int n_chunks = (int)((B + kSeg - 1) / kSeg);
  for (int c = warp_id; c < n_chunks; c += n_warps) {
    const int j0 = c * kSeg, j1 = (int)min(B, (int64_t)j0 + kSeg);
    const int before = j0 > 0 ? __ldcg(s.sorted + j0 - 1) : -1;
    const int after = j1 < B ? __ldcg(s.sorted + j1) : -1;
    int cur = -1;
    bool whole = true;
    float acc[T::OUT] = {};
    for (int jb = j0; jb < j1; jb += T::BATCH) {
      int key[T::PPL];
#pragma unroll
      for (int q = 0; q < T::PPL; ++q) {
        const int j = jb + 32 * q + lane;
        key[q] = j < j1 ? __ldcg(s.sorted + j) : -1;
        if (j < j1)
          in.tables<DEG, FORM>(s.recs + (int64_t)j * T::REC, key[q],
                               tab + (32 * q + lane) * T::S);
      }
      __syncwarp();
      const int nb = min(T::BATCH, j1 - jb);
      for (int m = 0; m < nb; ++m) {
        int kq = key[0];
        if constexpr (T::PPL == 2) kq = m < 32 ? key[0] : key[1];
        const int kn = __shfl_sync(0xffffffffu, kq, m & 31);
        if (kn != cur) {
          if (cur >= 0)
            lt.emit(dst_row(in, d_grid, d_rows, cur), whole, acc);
          whole = cur >= 0 || kn != before;
          cur = kn;
        }
        lt.add(tab + m * T::S, acc);
      }
      __syncwarp();
    }
    lt.emit(dst_row(in, d_grid, d_rows, cur), whole && cur != after, acc);
  }
  // the counters and the cursor zeroed for the next call
  for (int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x; k < K;
       k += (int64_t)gridDim.x * kThreads)
    s.cnt[k * s.cs] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) s.beg[K] = 0;
}

int sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <int DEG, int FORM>
cudaError_t run(int variant, int per_sm, void** args, const Inputs& in,
                int K, int64_t B, void* scratch, float* d_grid,
                float* d_rows, cudaStream_t st) {
  if (variant == 0) {
    int fit = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, packed_grad_kernel<DEG, FORM>, kThreads, 0);
    const int blocks = sms() * min(fit, per_sm);
    if (blocks <= 0) return cudaErrorInvalidConfiguration;
    return cudaLaunchCooperativeKernel(
        (const void*)packed_grad_kernel<DEG, FORM>, dim3(blocks),
        dim3(kThreads), args, 0, st);
  }
  if (variant == 1) {
    int bits = 1;
    while ((1 << bits) <= K) ++bits;
    const unsigned blocks = (unsigned)((B + kTile - 1) / kTile);
    if (blocks > 0)
      k7_block_kernel<DEG, FORM><<<blocks, kThreads, 0, st>>>(in, K, bits, B,
                                                              d_grid, d_rows);
    return cudaGetLastError();
  }
  const int cap = sms() * 8;
  const int fill = (int)max((int64_t)1,
                            min((int64_t)cap, (B + kThreads - 1) / kThreads));
  k7_count_kernel<DEG, FORM><<<fill, kThreads, 0, st>>>(in, K, B, scratch,
                                                         d_grid, d_rows);
  k7_place_kernel<DEG, FORM><<<fill, kThreads, 0, st>>>(in, K, B, scratch);
  const int64_t chunks = (B + kSeg - 1) / kSeg;
  const int sum = (int)max((int64_t)1, min((int64_t)cap,
                                           (chunks + kWarps - 1) / kWarps));
  k7_sum_kernel<DEG, FORM><<<sum, kThreads, 0, st>>>(in, K, B, scratch,
                                                      d_grid, d_rows);
  return cudaGetLastError();
}

}  // namespace

// As hpsdf_packed_grad, in the development form `variant` (see above);
// variant 1 takes no scratch and tables zeroed by the caller; variant 2
// takes hpsdf_packed_grad_scratch bytes + 4, zeroed once by the caller and
// kept so by each call.
extern "C" int hpsdf_dev_k7(int variant, int per_sm, const float* grid,
                            const float* rows, int W, int deg, int gd,
                            int extra, int Np, const float* pts, int64_t B,
                            float rc0, float rc1, float rc2, float inv0,
                            float inv1, float inv2, const float* cot,
                            int form, void* scratch, float* d_grid,
                            float* d_rows, void* stream) {
  if (variant < 0 || variant > 2 || (form != 0 && form != 1))
    return (int)cudaErrorInvalidValue;
  const Inputs in{grid, rows, W, gd, extra, 1 << (3 * gd), pts, cot,
                  {rc0, rc1, rc2}, {inv0, inv1, inv2}};
  const int K = in.G3 + Np;
  int cs = hpsdf::counter_stride(K);
  void* args[] = {&grid, &rows, &W,    &gd,      &extra,  &Np,
                  &pts,  &B,    &rc0,  &rc1,     &rc2,    &inv0,
                  &inv1, &inv2, &cot,  &cs,      &scratch, &d_grid,
                  &d_rows};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (deg == 3)
    e = form == 0 ? run<3, 0>(variant, per_sm, args, in, K, B, scratch,
                              d_grid, d_rows, st)
                  : run<3, 1>(variant, per_sm, args, in, K, B, scratch,
                              d_grid, d_rows, st);
  else if (deg == 5)
    e = form == 0 ? run<5, 0>(variant, per_sm, args, in, K, B, scratch,
                              d_grid, d_rows, st)
                  : run<5, 1>(variant, per_sm, args, in, K, B, scratch,
                              d_grid, d_rows, st);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}
