// K9 and K9u: the continuity solve's Jacobi-preconditioned conjugate
// gradient, in f64, with the iteration's scalars kept on the card.
//
// Replace the CG body of hpsdf_tpu/continuity.py _cg_solve (:367-434), which
// XLA runs as a segment_sum over the COO entries (the matvec, :401-405), two
// vdots and three axpys (:419-428) inside a while_loop. That loop is not a
// Pallas kernel; it is the continuity post-process's hot loop (the reference
// runs Eigen's CG, Source/HP/Octree.cpp:1749-1755). The plain torch versions
// are face_matvec_plain, cg_matvec_plain and cg_update_plain in
// hpsdf_tpu_torch/continuity.py.
//
//   K9, face_matvec_kernel: y = M p + s p and p.y on the face operator
//       (continuity.FaceOperator), its finish sets alpha = rz / p.y. No
//       same-depth matrix entry is read: each is sign * n_i * n_j with
//       n_q = sqrt((2q + 1) 2^depth) over a tangential-match pattern, so a
//       group of lanes owns a leaf, a lane a row of its block, and for each
//       of the leaf's same-depth faces the lane forms the jump
//       J = v_own - v_nbr of its row's tangential mode (v = sum over the
//       normal exponent k of L_k(face) n_k p_k, L_k(1) = 1, L_k(-1) =
//       (-1)^k) and adds L_{k_row}(face) n_{k_row} J: J^T J is the AA, AB,
//       BA and BB blocks. Rows of leaves with cross-depth faces add their
//       merged CSR entries. Degrees 0..12 share the code; a group loops
//       over the rows of a block wider than itself.
//   K9u, cg_update_kernel: x += alpha p, r -= alpha y, and r.z and r.r with
//       z = r / diag (times the reciprocal, as the reference); then, after
//       a barrier across the launch (a cooperative launch), every block adds
//       the partial sums itself, and the new search direction
//       p = z + (rz_new / rz) p is written in the same launch. Block 0 then
//       sets beta, rz, r.r, the count k and the reference's stopping rule,
//       r.r > tol^2 b.b and k < max_iter, as a flag on the card.
//   cg_chunk_kernel: `iters` iterations in one persistent cooperative
//       launch. Group g of the launch's T groups of lanes owns leaves g, g +
//       T, ... in every phase, the leaves the standalone K9 gives it: (1)
//       K9's matvec of its leaves into its slice of shared memory and the
//       p.y partial sums; grid barrier; alpha; (2) r -= alpha y, z = r /
//       diag in y's place, the r.z and r.r partial sums; grid barrier; beta
//       and the flag; (3) x += alpha p, p = z + beta p; grid barrier. y and
//       z never go through device memory (where the card cannot hold every
//       block's slices in shared memory at once, they go through a buffer
//       on the card). The interleaved leaves matter: with a contiguous
//       range of leaves a block, the matvec phase ran about three times
//       slower than the standalone K9 on the card (PERF.md section 6).
//   cg_matvec_kernel: K9 as PR 10 shipped it, on the COO sorted to a CSR
//       (16 lanes a row); kept for the comparison in chip_smoke.py, not on
//       the solve's path.
//
// The row-sharded CG (continuity._cg_rows_kernels, enforce_continuity's
// mesh=) gives each rank a contiguous block of leaves and their rows; its
// dot products are sums over ranks, and a collective cannot sit between the
// grid barriers of a cooperative launch, so an iteration there is K9 in its
// partial mode and K9u split at its barrier, with the host's all-gather of
// p and all-reduces of the dots between the launches on one stream:
//   K9, partial mode (hpsdf_face_matvec_rows): the rank's leaves only, y
//       into the rank's rows (row0 its first row in the gathered p), its
//       share of p.y left in sc[kPAp]; alpha is not set.
//   K9u's first launch, cg_update_rows_kernel: alpha = rz / p.Ap from the
//       reduced sum, x += alpha p, r -= alpha Ap, z = r / diag kept in z,
//       and the rank's r.z and r.r into sc[kRzPart] and sc[kRrPart]; it
//       copies the flag to st[kLive] and rz to sc[kRzOld].
//   K9u's second launch, cg_direction_kernel: beta = r.z / rz from the
//       reduced sum and the copied rz, p = z + beta p; its block 0 sets
//       beta, rz, r.r, k and the flag, the reference's stopping rule on the
//       global dots. It counts no block and has no fence: no block of a
//       launch reads a slot that another block of it writes.
// Both take rows in pairs (16-byte loads) and read their flag and scalars
// in one round trip; the scalars never leave the card. Their forms before
// the redesign, a thread a row, are csrc/check/cg_rows_reference.cu.
//
// Scalars on the card. Each launch writes one partial sum a block; K9's last
// block to finish (an atomic count of the blocks done) and each of K9u's and
// the persistent launch's blocks add the partials in block order. A launch
// whose flag is down returns at once, so the host enqueues a chunk and reads
// the flag once a chunk (continuity._cg_kernels): the iterate and the count
// are exactly those of a check every iteration. No atomic adds a value, so a
// solve repeats bit for bit on one card (the grid, and so the order of the
// sums, follows the card's occupancy).
//
// Bound. K9 is bound by bytes: the operator (16 bytes a leaf, 48 of face
// slots, the cross-depth CSR), p read and y written once; at the
// 260,604-leaf row about 62 MB against the 0.8 GB of PR 10's CSR form. p
// (21 MB there) stays in L2 for the neighbours' reads. An iteration of the
// persistent launch reads p, x, r and 1/diag and writes x, r and p.

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
enum { kRz = 0, kAlpha, kBeta, kRr, kThresh, kPAp, kRzPart, kRrPart, kRzOld };
// and the integers (continuity._ST)
enum { kK = 0, kMaxIter, kActive, kCount, kLive };

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

// --- the face operator -------------------------------------------------

constexpr int kMaxCoeffs = 455;               // coeff_count(12)
constexpr int kDegrees = 13;                  // BASIS_MAX_DEGREE + 1
constexpr int kDepths = 11;                   // TREE_MAX_DEPTH + 1

// continuity.FaceOperator on the card
struct Faces {
  const int4* leaves;    // row start, row end, degree | depth << 8, xoff
  const int2* slots;     // [leaf * 6 + 2d + side]: neighbour's start, degree
  const int* xrowptr;    // cross-depth CSR over the rows of leaves with xoff
  const int* xcols;
  const double* xvals;
  int n_leaves;
  int group;             // lanes a leaf, 1..32
  bool one_row;          // every leaf's block fits its group
};

// The norm table, bit for bit basis.norm_table() (the product is exact and
// both square roots are correctly rounded), and each basis index's
// exponents, e0 | e1 << 4 | e2 << 8 (basis.basis_indices order).
struct Tables {
  double nt[kDegrees * kDepths];
  int ex[kMaxCoeffs];
};

__device__ void load_tables(Tables& t) {
  for (int i = threadIdx.x; i < kDegrees * kDepths; i += blockDim.x)
    t.nt[i] = __dsqrt_rn((double)((2 * (i / kDepths) + 1) << (i % kDepths)));
  for (int i = threadIdx.x; i < kMaxCoeffs; i += blockDim.x) {
    int q = 0;
    while ((q + 1) * (q + 2) * (q + 3) / 6 <= i) ++q;
    int off = i - q * (q + 1) * (q + 2) / 6, e0 = 0;
    while (off >= q - e0 + 1) off -= q - e0 + 1, ++e0;
    t.ex[i] = e0 | off << 4 | (q - e0 - off) << 8;
  }
}

// The basis index of exponents (e0, e1, total degree q): by q, then e0, then
// e1 (basis.basis_indices); the same in a basis of any degree >= q.
__device__ __forceinline__ int basis_index(int e0, int e1, int q) {
  return q * (q + 1) * (q + 2) / 6 + e0 * (q + 1) - e0 * (e0 - 1) / 2 + e1;
}

// One of the three axes of row (e0, e1, e2): its exponent k along D and the
// sum t of the other two. `at` walks the basis indices of the row's
// tangential mode (its exponents along the other two axes): the member of
// normal exponent j, then j + 1, ... (from j to j + 1 the total degree q
// grows by one), with adds only.
template <int D>
struct Axis {
  int k, t, at, step;
  __device__ __forceinline__ Axis(int e0, int e1, int e2)
      : k(D == 0 ? e0 : D == 1 ? e1 : e2), t(e0 + e1 + e2 - k) {
    const int t1 = D == 0 ? e1 : D == 1 ? e2 : e0;
    const int t2 = D == 0 ? e2 : D == 1 ? e0 : e1;
    const int a0 = D == 0 ? 0 : D == 1 ? t2 : t1;
    const int a1 = D == 0 ? t1 : D == 1 ? 0 : t2;
    at = basis_index(a0, a1, t);
    // the step from q = t: (q+1)(q+2)/2 plus q + 2 (D = 0), t2 + 1 (D =
    // 1) or t1 (D = 2); each next step is q + 2 longer (q + 3 for D = 0)
    step = (t + 1) * (t + 2) / 2 + (D == 0 ? t + 2 : D == 1 ? t2 + 1 : t1);
  }
  __device__ __forceinline__ void next(int q) {
    at += step;
    step += q + 2 + (D == 0);
  }
};

// Adds, at normal exponent j (member `ax.at`), the terms of the jumps across
// the two faces along D: v[2D + side] += L_j(own face) n_j p_own -
// L_j(neighbour's face) n_j p_nbr on the row's tangential mode (side 0: the
// leaf is the low side, its face at +1 and the neighbour's at -1; L_j(-1) =
// (-1)^j).
template <int D>
__device__ __forceinline__ void face_terms(const Axis<D>& ax, int j, double w,
                                           const double* p, int own, int deg,
                                           const int2 (&nb)[6],
                                           double (&v)[6]) {
  const double po = j <= deg - ax.t ? p[own + ax.at] : 0.0;
  const double odd = (j & 1) ? -w : w;       // (-1)^j n_j
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int2 b = nb[2 * D + side];
    const double pn = b.x >= 0 && j <= b.y - ax.t ? p[b.x + ax.at] : 0.0;
    v[2 * D + side] = __fma_rn(side ? -w : -odd, pn,
                               __fma_rn(side ? odd : w, po, v[2 * D + side]));
  }
}

// The terms of normal exponent j on all three axes, then each axis's member
// steps to j + 1.
__device__ __forceinline__ void exponent_terms(Axis<0>& a0, Axis<1>& a1,
                                               Axis<2>& a2, int j,
                                               const double* nt,
                                               const double* p, int own,
                                               int deg, const int2 (&nb)[6],
                                               double (&v)[6]) {
  const double w = nt[j * kDepths];
  face_terms(a0, j, w, p, own, deg, nb, v);
  face_terms(a1, j, w, p, own, deg, nb, v);
  face_terms(a2, j, w, p, own, deg, nb, v);
  a0.next(j + a0.t);
  a1.next(j + a1.t);
  a2.next(j + a2.t);
}

// y of row r of a leaf: s p_r, plus L_k(face) n_k J for each same-depth face
// in slot order (k the row's exponent along the face's axis, J the jump of
// its tangential mode; an absent face's J is not added), then its
// cross-depth entries in CSR order. The loads of every face at one normal exponent go out
// together; up to three exponents, all of them.
__device__ __forceinline__ double leaf_row(const Faces& f, const Tables& t,
                                           const double* p, double s,
                                           int4 lf, const int2 (&nb)[6],
                                           int r) {
  const int deg = lf.z & 255, ex = t.ex[r];
  const double* nt = t.nt + (lf.z >> 8);
  Axis<0> a0(ex & 15, (ex >> 4) & 15, ex >> 8);
  Axis<1> a1(ex & 15, (ex >> 4) & 15, ex >> 8);
  Axis<2> a2(ex & 15, (ex >> 4) & 15, ex >> 8);
  int top = 0;                              // the most terms of a mode
#pragma unroll
  for (int slot = 0; slot < 6; ++slot) {
    const int tt = slot < 2 ? a0.t : slot < 4 ? a1.t : a2.t;
    if (nb[slot].x >= 0) top = max(top, max(deg, nb[slot].y) - tt + 1);
  }
  double v[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  const int k0 = a0.k, k1 = a1.k, k2 = a2.k;
  if (top <= 3) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (j < top) exponent_terms(a0, a1, a2, j, nt, p, lf.x, deg, nb, v);
  } else {
    for (int j = 0; j < top; ++j)
      exponent_terms(a0, a1, a2, j, nt, p, lf.x, deg, nb, v);
  }
  double acc = 0.0;
#pragma unroll
  for (int slot = 0; slot < 6; ++slot) {
    const int k = slot < 2 ? k0 : slot < 4 ? k1 : k2;
    const double w = nt[k * kDepths];
    if (nb[slot].x >= 0)
      acc = __fma_rn((slot & 1) && (k & 1) ? -w : w, v[slot], acc);
  }
  if (lf.w >= 0) {
    const int xr = lf.w + r, end = __ldg(f.xrowptr + xr + 1);
    for (int e = __ldg(f.xrowptr + xr); e < end; ++e)
      acc = __fma_rn(__ldg(f.xvals + e), p[__ldg(f.xcols + e)], acc);
  }
  return __fma_rn(s, p[lf.x + r], acc);
}

// The leaves of one group, leaf0, leaf0 + stride, ..., a lane a row: y_r
// into y[row - row0] or, LOCAL, into y in leaf order (the group's slice of
// shared memory); returns the lane's sum of p_r y_r. The next leaf's row
// block and face slots load while this one's rows run.
template <bool LOCAL>
__device__ __forceinline__ double group_leaves(const Faces& f,
                                               const Tables& t,
                                               const double* p, double s,
                                               int64_t leaf0, int64_t stride,
                                               int lane, double* y,
                                               int64_t row0) {
  double pap = 0.0;
  int4 lf = make_int4(0, 0, 0, -1);
  int2 nb[6];
  if (leaf0 < f.n_leaves) {
    lf = __ldg(f.leaves + leaf0);
#pragma unroll
    for (int j = 0; j < 6; ++j) nb[j] = __ldg(f.slots + leaf0 * 6 + j);
  }
  int off = 0;
  for (int64_t leaf = leaf0; leaf < f.n_leaves; leaf += stride) {
    const int64_t after = leaf + stride;
    int4 lf2 = lf;
    int2 nb2[6];
    if (after < f.n_leaves) {
      lf2 = __ldg(f.leaves + after);
#pragma unroll
      for (int j = 0; j < 6; ++j) nb2[j] = __ldg(f.slots + after * 6 + j);
    }
    for (int r = lane; r < lf.y - lf.x; r += f.group) {
      const double yr = leaf_row(f, t, p, s, lf, nb, r);
      y[LOCAL ? off + r : lf.x + r - row0] = yr;
      pap = __fma_rn(p[lf.x + r], yr, pap);
    }
    off += lf.y - lf.x;
    lf = lf2;
#pragma unroll
    for (int j = 0; j < 6; ++j) nb[j] = nb2[j];
  }
  return pap;
}

// The rows of the group's leaves leaf0, leaf0 + stride, ..., a lane a row,
// in batches of kBatch leaves: the batch's leaf rows, row indices and the
// slots of y (y[i] or, LOCAL, y in leaf order as group_leaves<true> wrote
// them). Where every leaf's block fits the group (degree <= 3), a lane has
// one row a leaf; else a lane loops over a leaf's rows, a batch a row.
constexpr int kBatch = 2;

template <bool LOCAL>
struct Rows {
  const Faces& f;
  int64_t leaf, stride;
  int lane, off = 0, j = 0;
  __device__ __forceinline__ Rows(const Faces& f_, int64_t leaf0,
                                  int64_t stride_, int lane_)
      : f(f_), leaf(leaf0), stride(stride_), lane(lane_) {}
  // the next batch: row index i[u] and y slot at[u] of each of its rows (-1
  // where none); false when the group's leaves are done
  __device__ __forceinline__ bool next(int (&i)[kBatch], int (&at)[kBatch]) {
    if (leaf >= f.n_leaves) return false;
    if (f.one_row) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int64_t l = leaf + u * stride;
        const int4 lf = l < f.n_leaves ? __ldg(f.leaves + l)
                                       : make_int4(0, 0, 0, 0);
        const bool has = lane < lf.y - lf.x;
        i[u] = has ? lf.x + lane : -1;
        at[u] = has ? (LOCAL ? off + lane : lf.x + lane) : -1;
        off += lf.y - lf.x;
      }
      leaf += kBatch * stride;
      return true;
    }
    const int4 lf = __ldg(f.leaves + leaf);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = lane + (j + u) * f.group;
      const bool has = r < lf.y - lf.x;
      i[u] = has ? lf.x + r : -1;
      at[u] = has ? (LOCAL ? off + r : lf.x + r) : -1;
    }
    j += kBatch;
    if (j * f.group >= lf.y - lf.x) {           // the leaf's last batch
      off += lf.y - lf.x;
      leaf += stride;
      j = 0;
    }
    return true;
  }
};

// A group's lanes: `sub` of the warp's groups, each of `group` lanes.
struct Group {
  int per_warp, sub, lane, index;
  __device__ __forceinline__ explicit Group(int group) {
    const int l = threadIdx.x & 31;
    per_warp = 32 / group;
    sub = l / group;
    lane = l - sub * group;
    index = (threadIdx.x >> 5) * per_warp + sub;
  }
  __device__ __forceinline__ bool live() const { return sub < per_warp; }
};

// K9 once on the face operator: a group of f.group lanes a leaf, the
// leaves in a grid-stride loop; p.y and alpha as cg_matvec_kernel. In the
// partial mode (the row-sharded CG) y starts at row row0, and only p.y is
// left in sc[kPAp], for the host to all-reduce.
__global__ void __launch_bounds__(kThreads)
face_matvec_kernel(Faces f, double s, const double* __restrict__ p,
                   double* __restrict__ y, int64_t row0, int partial,
                   double* __restrict__ partials, double* sc, int* st) {
  __shared__ Tables t;
  __shared__ double smem[kWarps];
  __shared__ bool last;
  if (!st[kActive]) return;                   // uniform over the launch
  load_tables(t);
  __syncthreads();
  const Group g(f.group);
  const int64_t groups = (int64_t)kWarps * g.per_warp;
  double pap[1] = {0.0};
  if (g.live())
    pap[0] = group_leaves<false>(f, t, p, s, blockIdx.x * groups + g.index,
                                 gridDim.x * groups, g.lane, y, row0);
  // the last block finishes
  if (!last_block_sums(pap, partials, st, smem, &last) || threadIdx.x) return;
  sc[kPAp] = pap[0];
  if (!partial) sc[kAlpha] = sc[kRz] / pap[0];
}

// `iters` CG iterations in one persistent cooperative launch (every block
// resident). Group g of the launch's T groups owns leaves g, g + T, ... in
// every phase (the leaves the standalone K9 gives it too: neighbouring
// leaves run together across the card), a lane a row. SMEM: the group keeps
// y, then z, of its rows in its `cap` doubles of shared memory, in leaf
// order; else y goes through ybuf. At most 128 registers, two blocks an SM. Every block adds the same partial sums in block order, so every
// block holds the same scalars and stops at the same iteration; block 0
// writes the state back. partials: p.y at [0, B), r.z and r.r at [B, 3B).
template <bool SMEM>
__global__ void __launch_bounds__(kThreads, 2)
cg_chunk_kernel(Faces f, int cap, double s, const double* __restrict__ minv,
                double* __restrict__ x, double* __restrict__ r,
                double* __restrict__ p, double* __restrict__ ybuf,
                double* partials, double* sc, int* st, int iters) {
  extern __shared__ double ysm[];
  __shared__ Tables t;
  __shared__ double smem[2 * kWarps];
  __shared__ double tot[2];
  if (!st[kActive]) return;                   // uniform over the launch
  load_tables(t);
  double rz = sc[kRz], alpha = sc[kAlpha], beta = sc[kBeta],
         pap = sc[kPAp], rr = sc[kRr];
  const double thresh = sc[kThresh];
  int k = st[kK];
  const int max_iter = st[kMaxIter];
  bool active = true;
  const Group g(f.group);
  const int64_t per_block = (int64_t)kWarps * g.per_warp;
  const int64_t leaf0 = blockIdx.x * per_block + g.index;
  const int64_t stride = gridDim.x * per_block;
  double* y = SMEM ? ysm + g.index * cap : ybuf;
  cg::grid_group grid = cg::this_grid();
  __syncthreads();
  for (int it = 0; it < iters && active; ++it) {
    if (it) grid.sync();                      // every block's p
    // (1) y = M p + s p of the group's leaves, and p.y
    double v1[1] = {0.0};
    if (g.live())
      v1[0] = group_leaves<SMEM>(f, t, p, s, leaf0, stride, g.lane, y, 0);
    block_sum(v1, smem);
    if (threadIdx.x == 0) partials[blockIdx.x] = v1[0];
    grid.sync();
    sum_partials(partials, v1, smem);
    if (threadIdx.x == 0) tot[0] = v1[0];
    __syncthreads();
    pap = tot[0];
    alpha = rz / pap;
    // (2) r -= alpha y, z = minv r in y's place, r.z and r.r
    double rz_part = 0.0, rr_part = 0.0;
    if (g.live()) {
      Rows<SMEM> rows(f, leaf0, stride, g.lane);
      int i[kBatch], at[kBatch];
      while (rows.next(i, at)) {
        double rv[kBatch], mv[kBatch], yv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (i[u] >= 0) {
            rv[u] = r[i[u]];
            mv[u] = __ldg(minv + i[u]);
            yv[u] = y[at[u]];
          }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (i[u] >= 0) {
            const double ri = __fma_rn(-alpha, yv[u], rv[u]);
            r[i[u]] = ri;
            const double zi = __dmul_rn(mv[u], ri);
            y[at[u]] = zi;
            rz_part = __fma_rn(ri, zi, rz_part);
            rr_part = __fma_rn(ri, ri, rr_part);
          }
      }
    }
    double v2[2] = {rz_part, rr_part};
    block_sum(v2, smem);
    if (threadIdx.x == 0) {
      partials[gridDim.x + blockIdx.x] = v2[0];
      partials[2 * gridDim.x + blockIdx.x] = v2[1];
    }
    grid.sync();
    sum_partials(partials + gridDim.x, v2, smem);
    if (threadIdx.x == 0) tot[0] = v2[0], tot[1] = v2[1];
    __syncthreads();
    beta = tot[0] / rz;
    rz = tot[0];
    rr = tot[1];
    // (3) x += alpha p and p = z + beta p, each lane the rows it updated
    if (g.live()) {
      Rows<SMEM> rows(f, leaf0, stride, g.lane);
      int i[kBatch], at[kBatch];
      while (rows.next(i, at)) {
        double pv[kBatch], xv[kBatch], zv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (i[u] >= 0) {
            pv[u] = p[i[u]];
            xv[u] = x[i[u]];
            zv[u] = y[at[u]];
          }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (i[u] >= 0) {
            x[i[u]] = __fma_rn(alpha, pv[u], xv[u]);
            p[i[u]] = __fma_rn(beta, pv[u], zv[u]);
          }
      }
    }
    ++k;
    active = rr > thresh && k < max_iter;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    sc[kRz] = rz;
    sc[kAlpha] = alpha;
    sc[kBeta] = beta;
    sc[kPAp] = pap;
    sc[kRr] = rr;
    st[kK] = k;
    st[kActive] = active;
  }
}

// K9 as PR 10 shipped it, on the CSR.
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
  // the last block finishes
  if (!last_block_sums(pap, partials, st, smem, &last) || threadIdx.x) return;
  sc[kPAp] = pap[0];
  sc[kAlpha] = sc[kRz] / pap[0];
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

// --- K9u's two launches in the row-sharded CG -----------------------------
//
// A thread takes rows in pairs (16-byte loads and stores; the last row of
// an odd n alone), a pair a thread where the rows fit one wave, the grid
// sized to the rows. Each launch reads its flag and the scalars it needs
// together, before the uniform test, so a launch waits one round trip to L2
// before its first row and a dead launch reads no row. Bound: bytes (the
// first reads Ap, 1/diag, x, r and p and writes x, r and z, 64 bytes a row;
// the second reads z and p and writes p, 24). At the fit + continuity
// solve's 40,960 rows that is under a microsecond of the card's rate, so a
// launch's fixed cost decides: hence one round trip for the scalars, no
// count or fence in the second launch, one warp adding the first's block
// sums, and programmatic dependent launch, which lets a launch start while
// the collective before it ends.

// A flag or scalar that no block of the launch writes, through the
// read-only path: a warp's load is served by its SM's L1 after the first,
// not by one L2 slice for every warp of the launch. The asm keeps the loads
// where they stand, ahead of the test on the flag.
__device__ __forceinline__ int load_flag(const int* a) {
  int v;
  asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v) : "l"(a));
  return v;
}

__device__ __forceinline__ double load_scalar(const double* a) {
  double v;
  asm volatile("ld.global.nc.f64 %0, [%1];" : "=d"(v) : "l"(a));
  return v;
}

// rows 2q and 2q + 1 of v; row 2q alone (and 0) where 2q + 1 == n
__device__ __forceinline__ double2 load_pair(const double* v, int64_t q,
                                             bool pair) {
  return pair ? reinterpret_cast<const double2*>(v)[q]
              : make_double2(v[2 * q], 0.0);
}

__device__ __forceinline__ void store_pair(double* v, int64_t q, bool pair,
                                           double2 a) {
  if (pair)
    reinterpret_cast<double2*>(v)[q] = a;
  else
    v[2 * q] = a.x;
}

// Programmatic dependent launch: the launch may start while the operation
// before it on the stream ends, and waits here for it, and for its writes,
// before any read.
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The warp's v summed in lane order (a tree of shuffles); lane 0 holds it.
template <int N>
__device__ __forceinline__ void warp_sum(double (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] += __shfl_down_sync(0xffffffffu, v[j], o);
}

// K9u's first launch in the row-sharded CG, over the rank's n rows: alpha =
// rz / p.Ap (p.Ap all-reduced), x += alpha p, r -= alpha Ap, z = r / diag
// (times the reciprocal) kept in z, and the rank's r.z and r.r into
// sc[kRzPart] and sc[kRrPart]. The first form (INIT) leaves x and r as they
// are (x, p and Ap are not read). Block 0 copies the flag to st[kLive] and
// rz to sc[kRzOld] for the second launch, which rewrites both originals.
// The sums: each block's in a fixed order (block_sum); the last block to
// finish (an atomic count of the blocks) adds them in block order with one
// warp, so no second block-wide sum follows the count.
template <bool INIT>
__global__ void __launch_bounds__(kThreads)
cg_update_rows_kernel(int64_t n, const double* __restrict__ Ap,
                      const double* __restrict__ minv,
                      double* __restrict__ x, double* __restrict__ r,
                      const double* __restrict__ p, double* __restrict__ z,
                      double* __restrict__ partials, double* sc, int* st) {
  __shared__ double smem[2 * kWarps];
  wait_for_previous();
  const int active = INIT ? 1 : load_flag(st + kActive);
  const double rz = load_scalar(sc + kRz);
  const double pap = INIT ? 1.0 : load_scalar(sc + kPAp);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    st[kLive] = active;
    if (active) sc[kRzOld] = rz;
  }
  if (!active) return;                        // uniform over the launch
  const double alpha = INIT ? 0.0 : rz / pap;
  const int64_t pairs = (n + 1) >> 1;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  double v[2] = {0.0, 0.0};                   // r.z, r.r
#pragma unroll 2
  for (int64_t q = (int64_t)blockIdx.x * kThreads + threadIdx.x; q < pairs;
       q += stride) {
    const bool pair = 2 * q + 1 < n;
    double2 ri = load_pair(r, q, pair);
    const double2 mi = pair ? __ldg(reinterpret_cast<const double2*>(minv) + q)
                            : make_double2(__ldg(minv + 2 * q), 0.0);
    if (!INIT) {
      const double2 pi = load_pair(p, q, pair), ai = load_pair(Ap, q, pair);
      double2 xi = load_pair(x, q, pair);
      xi.x = __fma_rn(alpha, pi.x, xi.x);
      xi.y = __fma_rn(alpha, pi.y, xi.y);
      ri.x = __fma_rn(-alpha, ai.x, ri.x);
      ri.y = __fma_rn(-alpha, ai.y, ri.y);
      store_pair(x, q, pair, xi);
      store_pair(r, q, pair, ri);
    }
    const double2 zi = make_double2(__dmul_rn(mi.x, ri.x),
                                    __dmul_rn(mi.y, ri.y));
    store_pair(z, q, pair, zi);
    v[0] = __fma_rn(ri.x, zi.x, v[0]);
    v[1] = __fma_rn(ri.x, ri.x, v[1]);
    if (pair) {
      v[0] = __fma_rn(ri.y, zi.y, v[0]);
      v[1] = __fma_rn(ri.y, ri.y, v[1]);
    }
  }
  block_sum(v, smem);
  // warp 0 finishes: thread 0 stores the block's sums and counts the block
  // done; in the last block to finish, warp 0 adds every block's sums
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  unsigned done = 0;
  if (lane == 0) {
    partials[blockIdx.x] = v[0];
    partials[gridDim.x + blockIdx.x] = v[1];
    __threadfence();
    done = atomicAdd(reinterpret_cast<unsigned*>(st + kCount), 1u);
  }
  if (__shfl_sync(0xffffffffu, done, 0) != gridDim.x - 1) return;
  __threadfence();
  v[0] = v[1] = 0.0;
  for (int b = lane; b < (int)gridDim.x; b += 32) {
    v[0] += __ldcg(partials + b);
    v[1] += __ldcg(partials + gridDim.x + b);
  }
  warp_sum(v);
  if (lane) return;
  st[kCount] = 0;
  if (!INIT) sc[kAlpha] = alpha;
  sc[kRzPart] = v[0];
  sc[kRrPart] = v[1];
}

// K9u's second launch in the row-sharded CG, over the rank's n rows: beta =
// r.z / rz (r.z all-reduced, rz as the first launch copied it), p = z +
// beta p (the first form: p = z). Its test reads the flag as the first
// launch copied it; block 0 sets beta, rz, r.r, the count k and the flag,
// r.r > tol^2 b.b and k < max_iter, slots no block of the launch reads.
template <bool INIT>
__global__ void __launch_bounds__(kThreads)
cg_direction_kernel(int64_t n, const double* __restrict__ z,
                    double* __restrict__ p, double* sc, int* st) {
  wait_for_previous();
  const int live = INIT ? 1 : load_flag(st + kLive);
  const double rz_new = load_scalar(sc + kRzPart);
  const double rz = INIT ? 1.0 : load_scalar(sc + kRzOld);
  const bool writer = blockIdx.x == 0 && threadIdx.x == 0;
  int k = 0, max_iter = 0;
  double rr = 0.0, thresh = 0.0;
  if (writer) {
    k = INIT ? 0 : st[kK] + 1;
    max_iter = st[kMaxIter];
    rr = sc[kRrPart];
    thresh = sc[kThresh];
  }
  if (!live) return;                          // uniform over the launch
  const double beta = INIT ? 0.0 : rz_new / rz;
  if (writer) {
    sc[kBeta] = beta;
    sc[kRz] = rz_new;
    sc[kRr] = rr;
    st[kK] = k;
    st[kActive] = rr > thresh && k < max_iter;
  }
  const int64_t pairs = (n + 1) >> 1;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t q = (int64_t)blockIdx.x * kThreads + threadIdx.x; q < pairs;
       q += stride) {
    const bool pair = 2 * q + 1 < n;
    const double2 zi = load_pair(z, q, pair);
    double2 pi = zi;
    if (!INIT) {
      pi = load_pair(p, q, pair);
      pi.x = __fma_rn(beta, pi.x, zi.x);
      pi.y = __fma_rn(beta, pi.y, zi.y);
    }
    store_pair(p, q, pair, pi);
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

template <typename... T>
bool aligned16(const T*... v) {
  return ((reinterpret_cast<uintptr_t>(v) % 16 == 0) && ...);
}

// K9u's launches in the row-sharded CG: a pair of rows a thread, at most the
// blocks that stay resident; with programmatic dependent launch.
template <typename... A, typename... B>
cudaError_t launch_rows(void (*kernel)(int64_t, A...), int64_t n, int* cache,
                        cudaStream_t stream, B... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_for(kernel, (n + 1) / 2, kThreads, cache));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, n, args...);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  return cudaGetLastError();
}

template <bool INIT>
cudaError_t launch_update_rows(int64_t n, const double* Ap,
                               const double* minv, double* x, double* r,
                               const double* p, double* z, double* partials,
                               double* sc, int* st, void* stream) {
  static int cache = 0;
  return launch_rows(cg_update_rows_kernel<INIT>, n, &cache,
                     (cudaStream_t)stream, Ap, minv, x, r, p, z, partials,
                     sc, st);
}

template <bool INIT>
cudaError_t launch_direction(int64_t n, const double* z, double* p,
                             double* sc, int* st, void* stream) {
  static int cache = 0;
  return launch_rows(cg_direction_kernel<INIT>, n, &cache,
                     (cudaStream_t)stream, z, p, sc, st);
}

Faces faces(const int* leaves, const int* slots, const int* xrowptr,
            const int* xcols, const double* xvals, int n_leaves, int group,
            int widest) {
  return Faces{reinterpret_cast<const int4*>(leaves),
               reinterpret_cast<const int2*>(slots), xrowptr, xcols, xvals,
               n_leaves, group, widest <= group};
}

// The most dynamic shared memory a block of the persistent launch may ask
// for (the card's opt-in limit less the kernel's static shared memory),
// granted to both forms once.
int chunk_smem_limit() {
  static int limit = -1;
  if (limit < 0) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaFuncAttributes a;
    cudaFuncGetAttributes(&a, (const void*)cg_chunk_kernel<true>);
    limit = optin - (int)a.sharedSizeBytes;
    cudaFuncSetAttribute((const void*)cg_chunk_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  }
  return limit;
}

}  // namespace

// Bytes of the partial sums a launch of any of the kernels needs.
extern "C" int64_t hpsdf_cg_scratch() { return 3 * kMaxBlocks * 8; }

// K9 once in PR 10's CSR form: y = A p + s p, sc[alpha] = sc[rz] / p.y (a
// no-op if st's flag is down).
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

// `iters` iterations as PR 10 ran them: K9 on the CSR then K9u, each
// launched every iteration (a no-op once the flag is down).
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

// Blocks of the persistent launch that stay resident together with `smem`
// bytes of dynamic shared memory each (y in shared memory; 0: y in a
// buffer), at most kMaxBlocks; 0 if a block cannot have that much.
extern "C" int64_t hpsdf_cg_chunk_blocks(int64_t smem) {
  if (smem > chunk_smem_limit()) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (smem > 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, (const void*)cg_chunk_kernel<true>, kThreads, (size_t)smem);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, (const void*)cg_chunk_kernel<false>, kThreads, 0);
  const int64_t cap = (int64_t)sms * per_sm;
  return cap > kMaxBlocks ? kMaxBlocks : cap;
}

cudaError_t launch_face_matvec(const int* leaves, const int* slots,
                               const int* xrowptr, const int* xcols,
                               const double* xvals, int n_leaves, int group,
                               int widest, int64_t row0, int partial,
                               double s, const double* p, double* y,
                               double* partials, double* sc, int* st,
                               void* stream) {
  if (n_leaves <= 0 || group < 1 || group > 32 || row0 < 0)
    return cudaErrorInvalidValue;
  static int cache = 0;
  const Faces f = faces(leaves, slots, xrowptr, xcols, xvals, n_leaves,
                        group, widest);
  const int blocks = grid_for(face_matvec_kernel, n_leaves,
                              kWarps * (32 / group), &cache);
  face_matvec_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      f, s, p, y, row0, partial, partials, sc, st);
  return cudaGetLastError();
}

// K9 once on the face operator (leaves (L, 4), slots (L, 6, 2), the
// cross-depth CSR; `group` lanes a leaf, `widest` the widest row block):
// y = M p + s p, sc[alpha] = sc[rz] / p.y (a no-op if st's flag is down).
extern "C" int hpsdf_face_matvec(const int* leaves, const int* slots,
                                 const int* xrowptr, const int* xcols,
                                 const double* xvals, int n_leaves,
                                 int group, int widest, int64_t n, double s,
                                 const double* p, double* y, double* partials,
                                 double* sc, int* st, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  return (int)launch_face_matvec(leaves, slots, xrowptr, xcols, xvals,
                                 n_leaves, group, widest, 0, 0, s, p, y,
                                 partials, sc, st, stream);
}

// K9's partial mode: the rank's leaves (their rows and neighbours in the
// gathered p), y at rows row0, row0 + 1, ... into y[0], y[1], ...; the
// rank's p.y into sc[kPAp], alpha not set (a no-op if st's flag is down).
extern "C" int hpsdf_face_matvec_rows(const int* leaves, const int* slots,
                                      const int* xrowptr, const int* xcols,
                                      const double* xvals, int n_leaves,
                                      int group, int widest, int64_t row0,
                                      double s, const double* p, double* y,
                                      double* partials, double* sc, int* st,
                                      void* stream) {
  return (int)launch_face_matvec(leaves, slots, xrowptr, xcols, xvals,
                                 n_leaves, group, widest, row0, 1, s, p, y,
                                 partials, sc, st, stream);
}

// K9u's first launch over n rows (init = 1: z = minv r and the dots only);
// the vectors 16-byte aligned.
extern "C" int hpsdf_cg_update_rows(int init, int64_t n, const double* Ap,
                                    const double* minv, double* x, double* r,
                                    const double* p, double* z,
                                    double* partials, double* sc, int* st,
                                    void* stream) {
  if (n <= 0 || !aligned16(Ap, minv, x, r, p, z))
    return (int)cudaErrorInvalidValue;
  return (int)(init ? launch_update_rows<true>(n, Ap, minv, x, r, p, z,
                                               partials, sc, st, stream)
                    : launch_update_rows<false>(n, Ap, minv, x, r, p, z,
                                                partials, sc, st, stream));
}

// K9u's second launch over n rows (init = 1: p = z and iteration 0's
// state); the vectors 16-byte aligned.
extern "C" int hpsdf_cg_direction(int init, int64_t n, const double* z,
                                  double* p, double* sc, int* st,
                                  void* stream) {
  if (n <= 0 || !aligned16(z, p)) return (int)cudaErrorInvalidValue;
  return (int)(init ? launch_direction<true>(n, z, p, sc, st, stream)
                    : launch_direction<false>(n, z, p, sc, st, stream));
}

// `iters` iterations in one persistent cooperative launch of `blocks`
// blocks; y in `cap` doubles of shared memory a group (each block's groups
// share kWarps * (32 / group) * cap doubles), or in ybuf (n) if cap is 0.
extern "C" int hpsdf_cg_chunk(const int* leaves, const int* slots,
                              const int* xrowptr, const int* xcols,
                              const double* xvals, int n_leaves, int group,
                              int widest, int64_t n, int blocks, int cap,
                              double s,
                              const double* minv, double* x, double* r,
                              double* p, double* ybuf, double* partials,
                              double* sc, int* st, int iters, void* stream) {
  const int64_t smem = (int64_t)kWarps * (32 / (group < 1 ? 1 : group)) *
                       cap * 8;
  if (n <= 0 || n_leaves <= 0 || group < 1 || group > 32 || iters < 0 ||
      blocks < 1 || blocks > kMaxBlocks || cap < 0 ||
      smem > chunk_smem_limit())
    return (int)cudaErrorInvalidValue;
  Faces f = faces(leaves, slots, xrowptr, xcols, xvals, n_leaves, group,
                  widest);
  void* args[] = {&f, &cap, &s, &minv, &x, &r, &p, &ybuf, &partials, &sc,
                  &st, &iters};
  const void* kernel = cap > 0 ? (const void*)cg_chunk_kernel<true> : (const void*)cg_chunk_kernel<false>;
  const cudaError_t e = cudaLaunchCooperativeKernel(
      kernel, dim3(blocks), dim3(kThreads), args, (size_t)smem,
      (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}
