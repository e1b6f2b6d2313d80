// K6: the fit's point generation and its separable Gauss-Legendre
// projection, two launches a fit chunk.
//
// Replaces the program XLA fused of hpsdf_tpu/build.py:515-521 (the points
// inside _FitCache._fused, :501-528) and :100-157 (_fit_impl). The plain
// torch versions are fit_points_plain and fit_project_plain in
// hpsdf_tpu_torch/build.py: a broadcast and a stack of the points, then
// three f64 einsums, an advanced-index gather of the basis triples and
// about twenty elementwise launches. The kernels this file replaced are
// kept as csrc/check/fit_reference.cu.
//
// fit_points_kernel<D, T>: bound by the m Q^3 points it writes (3 values
// each). The replaced kernel spent ~200 instructions a value on 64-bit and
// run-time divisions and an ldexp. Here the degree is a template parameter,
// so every division by Q, Q^2 and 3 is a multiply and a shift, and a
// block's indices are 32-bit offsets from its tile's first cell. A block
// first writes, for each cell its tile touches, the 3Q coordinates c_a +
// half x[n] into shared memory (half = 2^-(depth+1) built from the
// exponent bits for depth 0..10); then each thread writes 16-byte vectors
// of the output (2 doubles or 4 floats, aligned to the chunk's base), each
// value read from that table: four vectors a thread, one where the chunk
// is too small to put a block of four on every SM. half * x is exact (a
// power of two), so the add rounds once, with or without FMA contraction:
// the points are the plain version's bit for bit.
//
// fit_project_kernel<D, T>: bound by F's bytes (Q^3 values a cell, read
// once; the FMAs are a third of the bytes' time or less at every degree).
// The replaced kernel kept one Q^2 slab of one cell in flight a block, behind
// two barriers, so the card's memory idled (28% of the byte bound at degree
// 2, 1.4% at 11, where a chunk holds 11 cells). Here a block copies its
// whole share of F into shared memory with cp.async, every copy issued
// before the first is waited on (8-byte copies in f64, 4-byte in f32: Q is
// odd, so neither F's rows nor its cells are 16-byte aligned, and TMA and
// bulk copies refuse them), and loads the epilogue's depths, norms and kept
// coefficients while F arrives. The share is fixed by the degree (kSplit,
// kCells):
//   - degrees 2 and 3: whole cells a block, kCells[D] (4 and 2: 23 and 35
//     KB of F in f64) while the chunk still puts a block on every SM, one
//     where it would not (a full chunk takes 360 / 239 blocks, several an
//     SM; 6 cells take 6);
//   - degrees 4..11: each cell's i-slabs split evenly over a cluster of
//     kSplit[D] blocks (2, 4 or 8; block s takes slabs [s Q / S, (s + 1) Q
//     / S)), so degree 11's 11 cells take 88 blocks.
// Then, from shared memory, three stages a barrier apart, each spread over
// the block's threads: k (a thread two rows (cell, i, j): S1[., r] =
// sum_k F[i, j, k] A[r, k] for all r in registers), j (a thread a (cell,
// i, q, r), q + r <= D: S2 = sum_j A[q, j] S1[j, r]) and i (a thread a
// (cell, p, q, r) of the basis: sum_i A[p, i] S2[i, q, r] over the block's
// slabs). Every sum runs in index order with an FMA a term, as the
// replaced kernel summed, so at degrees 2 and 3 the rows are its rows bit
// for bit.
// In a cluster, ranks 1.. write their sums into rank 0's shared memory
// (distributed shared memory, after a cluster barrier that every block
// arrived at once it started) and rank 0 adds them to its own in rank
// order, ((s_0 + s_1) + s_2) + ..., then runs the epilogue. A cell's row
// depends on its degree alone, never on the chunk that holds it or its
// place there (the sharded fit is the one-device fit bit for bit). No
// atomics.
//
// The epilogue is the replaced kernel's (hpsdf_tpu _fit_impl's order):
// coeffs = raw * cn[depth] * half^3, prev kept verbatim for c < pw, err the
// sum of c^2 over the triples of total degree D (the last (D+1)(D+2)/2 in
// basis order, all new when pw > 0), and the nearness weight from the kept
// c_0 (POLYNOMIAL: clamp((1 - fbar/sqrt 3)^s, 0, 1), NaN kept as
// torch.clamp keeps it; EXPONENTIAL: exp(-s fbar / sqrt 3)). A depth
// outside [0, TREE_MAX_DEPTH] gives a row of NaN.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kPointThreads = 256;
constexpr int kPointVecs = 4;          // most 16-byte vectors a thread
constexpr int kProjectThreads = 256;
constexpr int kMaxDepth = 10;          // consts.TREE_MAX_DEPTH
constexpr int kMinDegree = 2, kMaxDegree = 11;
constexpr double kSqrt3 = 1.7320508075688772;   // math.sqrt(3.0)
// blocks a cell (a cluster) and most cells a block, by degree
// (chip_smoke.K6_SPLIT and K6_CELLS; tests/test_torch_fit_project.py reads
// these two lines)
constexpr int kSplit[12] = {0, 0, 1, 1, 2, 4, 4, 8, 8, 8, 8, 8};
constexpr int kCells[12] = {0, 0, 4, 2, 1, 1, 1, 1, 1, 1, 1, 1};

template <int D>
struct Fit {
  static constexpr int Q = 4 * D + 1;                      // rule size
  static constexpr int P = D + 1;                          // L_0 .. L_D
  static constexpr int C = (D + 1) * (D + 2) * (D + 3) / 6;
  static constexpr int PAIRS = (D + 1) * (D + 2) / 2;      // q + r <= D
  static constexpr int S = kSplit[D];                      // blocks a cell
  static constexpr int CELLS = kCells[D];                  // cells a block
  static constexpr int L = (Q + S - 1) / S;                // most slabs
  static constexpr int ROWS = CELLS * L * Q;               // (cell, i, j)
  // shared memory in values: F's share, A transposed (Q, P), S1 (ROWS, P),
  // S2 (CELLS L, PAIRS), the rows (CELLS, C), the other ranks' sums
  // (S - 1, C)
  static constexpr int SMEM = CELLS * L * Q * Q + Q * P + ROWS * P
                              + CELLS * L * PAIRS + CELLS * C + (S - 1) * C;
  // entries of the rows a thread writes in the epilogue
  static constexpr int E = (CELLS * C + kProjectThreads - 1)
                           / kProjectThreads;
  static_assert(S == 1 || CELLS == 1, "a cluster holds one cell");
  static_assert(S <= 8, "a portable cluster");
};

template <typename T>
struct Vec16;                          // 16 bytes of T
template <>
struct Vec16<double> {
  static constexpr int N = 2;
  __device__ __forceinline__ static void store(double* p, const double* v) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
};
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

__device__ __forceinline__ float scale2(float x, int e) {
  return ldexpf(x, e);
}
__device__ __forceinline__ double scale2(double x, int e) {
  return ldexp(x, e);
}

// 2^-(depth+1), exact: from the exponent bits for depth 0..kMaxDepth
__device__ __forceinline__ double half_of(double, int depth) {
  if (depth >= 0 && depth <= kMaxDepth)
    return __longlong_as_double((long long)(1022 - depth) << 52);
  return ldexp(1.0, -(depth + 1));
}
__device__ __forceinline__ float half_of(float, int depth) {
  if (depth >= 0 && depth <= kMaxDepth)
    return __int_as_float((126 - depth) << 23);
  return ldexpf(1.0f, -(depth + 1));
}

__device__ __forceinline__ void cp_async(double* dst, const double* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// the (q, r) of pair index pr, q + r <= D, in order of q then r
template <int D>
__device__ __forceinline__ void pair_qr(int pr, int& q, int& r) {
  q = 0;
  r = pr;
  while (r > D - q) {
    r -= D - q + 1;
    ++q;
  }
}
template <int D>
__device__ __forceinline__ int pair_index(int q, int r) {
  return q * (D + 1) - q * (q - 1) / 2 + r;
}

// the (p, q, r) of basis index c (basis.basis_indices: by total degree n,
// then lexicographic in (p, q))
__device__ __forceinline__ void basis_triple(int c, int& p, int& q, int& r) {
  int n = 0;
  while ((n + 1) * (n + 2) * (n + 3) / 6 <= c) ++n;
  int rem = c - n * (n + 1) * (n + 2) / 6;
  p = 0;
  while (rem > n - p) {
    rem -= n - p + 1;
    ++p;
  }
  q = rem;
  r = n - p - q;
}

template <int D, typename T>
__global__ void __launch_bounds__(kPointThreads)
fit_points_kernel(const T* __restrict__ centres,
                  const int32_t* __restrict__ depths,
                  const T* __restrict__ x, int64_t m, int vecs,
                  T* __restrict__ out) {
  constexpr unsigned Q = 4 * D + 1, PER = 3 * Q * Q * Q;   // values a cell
  constexpr int V = Vec16<T>::N;
  constexpr int NC = kPointThreads * kPointVecs * V / PER + 2;  // most cells
  __shared__ T g[NC * 3 * Q];             // [cell][axis][node]
  const unsigned tile = kPointThreads * vecs * V;          // values a block
  const int64_t first = (int64_t)blockIdx.x * tile;
  const int64_t cell0 = first / PER;
  const unsigned off = (unsigned)(first - cell0 * PER);
  const int64_t n = m * PER;
  const int nc = (int)((off + tile - 1) / PER) + 1;        // cells touched
  for (int e = threadIdx.x; e < nc * 3 * (int)Q; e += kPointThreads) {
    const int cl = e / (3 * Q), a = e / Q % 3, node = e % Q;
    const int64_t cell = cell0 + cl;
    if (cell < m)
      g[e] = centres[3 * cell + a]
             + half_of(T(0), __ldg(depths + cell)) * __ldg(x + node);
  }
  __syncthreads();
  for (int it = 0; it < vecs; ++it) {
    const unsigned l0 = (it * kPointThreads + threadIdx.x) * V;
    const int64_t e0 = first + l0;
    if (e0 >= n) break;
    T v[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const unsigned idx = off + l0 + u;   // from cell0's first value
      const unsigned cl = idx / PER, rem = idx - cl * PER;
      const unsigned pt = rem / 3, a = rem - 3 * pt;   // point (i, j, k)
      const unsigned node = a == 0 ? pt / (Q * Q) : a == 1 ? pt / Q % Q
                                                            : pt % Q;
      v[u] = g[(cl * 3 + a) * Q + node];
    }
    if (e0 + V <= n) {
      Vec16<T>::store(out + e0, v);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u)
        if (e0 + u < n) out[e0 + u] = v[u];
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kProjectThreads)
fit_project_kernel(const T* __restrict__ F, const int32_t* __restrict__ depths,
                   const T* __restrict__ A, const T* __restrict__ cn,
                   const T* __restrict__ prev, int pw, int nw, T strength,
                   int64_t m, int cells, T* __restrict__ out) {
  using K = Fit<D>;
  constexpr int Q = K::Q, P = K::P, C = K::C, PAIRS = K::PAIRS, S = K::S;
  constexpr int L = K::L, NT = kProjectThreads, E = K::E;
  extern __shared__ __align__(16) unsigned char k6_smem[];
  T* f_s = reinterpret_cast<T*>(k6_smem);   // F's share, (cell, i, j, k)
  T* at_s = f_s + K::CELLS * L * Q * Q;     // A[p, i] at i P + p
  T* s1 = at_s + Q * P;                     // ((cell, i, j), r)
  T* s2 = s1 + K::ROWS * P;                 // ((cell, i), pair)
  T* row = s2 + K::CELLS * L * PAIRS;       // (cell, basis index)
  T* parts = row + K::CELLS * C;            // ranks 1.. S-1's sums (rank 0)
  const int t = threadIdx.x;
  const int rank = S > 1 ? (int)(blockIdx.x % S) : 0;
  const int64_t cell0 = S > 1 ? (int64_t)(blockIdx.x / S)
                              : (int64_t)blockIdx.x * cells;
  const int nc = S > 1 || m - cell0 >= cells ? cells : (int)(m - cell0);
  const int i0 = rank * Q / S, nl = (rank + 1) * Q / S - i0;   // slabs

  // F's share is contiguous: nc whole cells, or nl slabs of one; every copy
  // is issued before the first is waited on
  const T* src = F + cell0 * (Q * Q * Q) + (int64_t)i0 * (Q * Q);
  const int n = nc * nl * Q * Q;
  for (int e = t; e < n; e += NT) cp_async(f_s + e, src + e);
  for (int e = t; e < Q * P; e += NT) {
    const int i = e / P, p = e - i * P;
    at_s[e] = A[p * Q + i];
  }
  if constexpr (S > 1)       // this block has started (for the other ranks)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // the epilogue's inputs, loaded while F arrives: a thread's E entries of
  // the rows (depth, norm, kept coefficient) and the err thread's depth
  T norm[E], kept[E];
  int dep[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int w = t + e * NT, cl = w / C, c = w - cl * C;
    dep[e] = 0;
    norm[e] = kept[e] = T(0);
    if (rank == 0 && w < nc * C) {
      const int64_t cell = cell0 + cl;
      dep[e] = __ldg(depths + cell);
      const bool ok = dep[e] >= 0 && dep[e] <= kMaxDepth;
      norm[e] = cn[(ok ? dep[e] : 0) * C + c];
      if (c < pw) kept[e] = prev[cell * pw + c];
    }
  }
  const int dep_err = rank == 0 && t < nc ? __ldg(depths + cell0 + t) : 0;
  cp_async_wait_all();
  __syncthreads();

  // k: S1[(cell, i, j), r] = sum_k F[cell, i, j, k] A[r, k], a thread two
  // rows g and g + G (neighbouring threads on neighbouring rows)
  const int rows = nc * nl * Q, G = (rows + 1) / 2;
  for (int g = t; g < G; g += NT) {
    T s[2][P];
    const T* f[2] = {f_s + g * Q, f_s + min(g + G, rows - 1) * Q};
#pragma unroll
    for (int r = 0; r < P; ++r) s[0][r] = s[1][r] = T(0);
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const T v0 = f[0][k], v1 = f[1][k];
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const T a = at_s[k * P + r];
        s[0][r] = fma(v0, a, s[0][r]);
        s[1][r] = fma(v1, a, s[1][r]);
      }
    }
#pragma unroll
    for (int r = 0; r < P; ++r) s1[g * P + r] = s[0][r];
    if (g + G < rows) {
#pragma unroll
      for (int r = 0; r < P; ++r) s1[(g + G) * P + r] = s[1][r];
    }
  }
  __syncthreads();

  // j: S2[(cell, i), (q, r)] = sum_j A[q, j] S1[(cell, i, j), r]
  for (int w = t; w < nc * nl * PAIRS; w += NT) {
    const int slab = w / PAIRS;
    int q, r;
    pair_qr<D>(w - slab * PAIRS, q, r);
    const T* y = s1 + slab * Q * P + r;
    T s = T(0);
#pragma unroll
    for (int j = 0; j < Q; ++j) s = fma(at_s[j * P + q], y[j * P], s);
    s2[w] = s;
  }
  __syncthreads();

  // i: raw[cell, (p, q, r)] = sum_i A[p, i] S2[(cell, i), (q, r)] over the
  // block's slabs
  for (int w = t; w < nc * C; w += NT) {
    const int cl = w / C;
    int p, q, r;
    basis_triple(w - cl * C, p, q, r);
    const T* y = s2 + cl * nl * PAIRS + pair_index<D>(q, r);
    T acc = T(0);
#pragma unroll
    for (int i = 0; i < L; ++i)
      if (i < nl) acc = fma(at_s[(i0 + i) * P + p], y[i * PAIRS], acc);
    row[w] = acc;
  }

  if constexpr (S > 1) {
    // ranks 1.. put their sums into rank 0's shared memory (once every
    // block has started); rank 0 adds them to its own in rank order
    cg::cluster_group cluster = cg::this_cluster();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (rank != 0) {
      T* dst = cluster.map_shared_rank(parts, 0) + (rank - 1) * C;
      for (int c = t; c < C; c += NT) dst[c] = row[c];
    }
    cluster.sync();
    if (rank != 0) return;
    for (int c = t; c < C; c += NT) {
      T v = row[c];
#pragma unroll
      for (int s = 1; s < S; ++s) v += parts[(s - 1) * C + c];
      row[c] = v;
    }
  }
  __syncthreads();

  // the epilogue, a cell's row [coeffs | err]
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int w = t + e * NT, cl = w / C, c = w - cl * C;
    if (w < nc * C) {
      const int depth = dep[e];
      const bool ok = depth >= 0 && depth <= kMaxDepth;
      const T h3 = scale2(T(1), -3 * (depth + 1));      // half^3, exact
      T v = c < pw ? kept[e] : row[w] * norm[e] * h3;
      if (!ok) v = T(NAN);
      row[w] = v;
      out[(cell0 + cl) * (C + 1) + c] = v;
    }
  }
  __syncthreads();
  if (t < nc) {
    const int64_t cell = cell0 + t;
    const T* rw = row + t * C;
    const int depth = dep_err;
    const bool ok = depth >= 0 && depth <= kMaxDepth;
    T err = T(0);
    for (int c = C - PAIRS; c < C; ++c) err += rw[c] * rw[c];
    if (nw != 0) {
      // exact cell mean: only the constant basis has one; c_0 is the kept
      // prev[0] when pw > 0
      const T fbar = fabs(rw[0] * exp2(T(1.5) * T(depth)));
      T k;
      if (nw == 1) {
        k = pow(T(1) - fbar / T(kSqrt3), strength);
        k = k < T(0) ? T(0) : (k > T(1) ? T(1) : k);   // NaN stays NaN
      } else {
        k = exp(-strength * fbar / T(kSqrt3));
      }
      err = err * k;
    }
    out[cell * (C + 1) + C] = ok ? err : T(NAN);
  }
}

// the card's SMs (the device current at the first call)
int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess)
      return 0;
    return n;
  }();
  return sms;
}

// The projection's launch for a chunk of m cells: a cluster of S blocks a
// cell, or `cells` whole cells a block: CELLS while the chunk still puts a
// block on every SM, one where it would not (a cell's sums are the same
// whichever block holds it).
template <int D, typename T>
cudaLaunchConfig_t project_config(int64_t m, int cells, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  using K = Fit<D>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(K::S > 1 ? m * K::S
                                         : (m + cells - 1) / cells));
  cfg.blockDim = dim3(kProjectThreads);
  cfg.dynamicSmemBytes = K::SMEM * sizeof(T);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K::S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = K::S > 1 ? 1 : 0;
  return cfg;
}

template <int D, typename T>
int project(const T* F, const int32_t* depths, const T* A, const T* cn,
            const T* prev, int pw, int nw, double strength, int64_t m,
            T* out, cudaStream_t stream) {
  using K = Fit<D>;
  if (pw < 0 || pw > K::C) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fit_project_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(K::SMEM * sizeof(T)));
  if (e != cudaSuccess) return (int)e;
  const int cells =
      (m + K::CELLS - 1) / K::CELLS >= sm_count() ? K::CELLS : 1;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = project_config<D, T>(m, cells, stream, attr);
  e = cudaLaunchKernelEx(&cfg, fit_project_kernel<D, T>, F, depths, A, cn,
                         prev, pw, nw, (T)strength, m, cells, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// K6's projection launch at a degree: blocks a cell, most cells a block,
// threads, dynamic shared memory in bytes, and how many of its clusters
// (blocks where a cell takes one) the card holds at once
template <int D, typename T>
int project_shape(int64_t* shape) {
  using K = Fit<D>;
  const int smem = (int)(K::SMEM * sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      fit_project_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  int active = 0;
  if (K::S > 1) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = project_config<D, T>(K::S, 1, 0, attr);
    e = cudaOccupancyMaxActiveClusters(&active, fit_project_kernel<D, T>,
                                       &cfg);
  } else {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &active, fit_project_kernel<D, T>, kProjectThreads, smem);
    active *= sm_count();
  }
  if (e != cudaSuccess) return (int)e;
  shape[0] = K::S;
  shape[1] = K::CELLS;
  shape[2] = kProjectThreads;
  shape[3] = smem;
  shape[4] = active;
  return 0;
}

// the points: kPointVecs 16-byte vectors a thread, or one where a chunk
// would not put a block of four on every SM
template <int D, typename T>
int points(const T* centres, const int32_t* depths, const T* x, int64_t m,
           T* out, cudaStream_t stream) {
  constexpr int64_t per = 3LL * (4 * D + 1) * (4 * D + 1) * (4 * D + 1);
  constexpr int64_t vec = kPointThreads * Vec16<T>::N;     // values a vector
  const int vecs =
      (m * per + vec * kPointVecs - 1) / (vec * kPointVecs) >= sm_count()
          ? kPointVecs : 1;
  const int64_t blocks = (m * per + vec * vecs - 1) / (vec * vecs);
  fit_points_kernel<D, T><<<(unsigned)blocks, kPointThreads, 0, stream>>>(
      centres, depths, x, m, vecs, out);
  return (int)cudaGetLastError();
}

#define HPSDF_FIT_DEGREES(CASE)                                             \
  CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10) \
  CASE(11)

}  // namespace

// centres: (m, 3), x: (Q,) Gauss-Legendre nodes, Q = 4 degree + 1 for a
// degree 2..11, out: (m Q^3, 3), 16-byte aligned, all of the value type
// (f64 when f64 != 0, else f32), contiguous; depths (m,) int32.
extern "C" int hpsdf_fit_points(const void* centres, const int32_t* depths,
                                const void* x, int Q, int64_t m, int f64,
                                void* out, void* stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (m == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (Q) {
#define HPSDF_POINTS_CASE(D)                                              \
    case 4 * D + 1:                                                       \
      return f64 ? points<D, double>((const double*)centres, depths,      \
                                     (const double*)x, m, (double*)out, s) \
                 : points<D, float>((const float*)centres, depths,        \
                                    (const float*)x, m, (float*)out, s);
    HPSDF_FIT_DEGREES(HPSDF_POINTS_CASE)
#undef HPSDF_POINTS_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// F: (m, Q, Q, Q) with Q = 4 degree + 1; A: (degree + 1, Q)
// quadrature_matrix; cn: (TREE_MAX_DEPTH + 1, C) coeff_norms; prev: (m, pw)
// or null when pw is 0; out: (m, C + 1) rows [coeffs | err]; all of the
// value type (f64 when f64 != 0, else f32), contiguous; depths (m,) int32;
// nw 0 (none), 1 (polynomial), 2 (exponential); degree 2..11.
extern "C" int hpsdf_fit_project(const void* F, const int32_t* depths,
                                 const void* A, const void* cn,
                                 const void* prev, int pw, int degree, int nw,
                                 double strength, int64_t m, int f64,
                                 void* out, void* stream) {
  if (degree < kMinDegree || degree > kMaxDegree || nw < 0 || nw > 2)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (degree) {
#define HPSDF_PROJECT_CASE(D)                                               \
    case D:                                                                 \
      return f64 ? project<D, double>((const double*)F, depths,             \
                                      (const double*)A, (const double*)cn,  \
                                      (const double*)prev, pw, nw, strength, \
                                      m, (double*)out, s)                   \
                 : project<D, float>((const float*)F, depths,               \
                                     (const float*)A, (const float*)cn,     \
                                     (const float*)prev, pw, nw, strength,  \
                                     m, (float*)out, s);
    HPSDF_FIT_DEGREES(HPSDF_PROJECT_CASE)
#undef HPSDF_PROJECT_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// The projection's launch at a degree (f64 != 0: f64, else f32) on the
// current device: shape[0..4] = blocks a cell (the cluster), cells a block,
// threads a block, dynamic shared memory in bytes, and the clusters (or,
// where a cell takes one block, the blocks) the card holds at once.
extern "C" int hpsdf_fit_project_shape(int degree, int f64, int64_t* shape) {
  switch (degree) {
#define HPSDF_SHAPE_CASE(D)                                                 \
    case D:                                                                 \
      return f64 ? project_shape<D, double>(shape)                          \
                 : project_shape<D, float>(shape);
    HPSDF_FIT_DEGREES(HPSDF_SHAPE_CASE)
#undef HPSDF_SHAPE_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
