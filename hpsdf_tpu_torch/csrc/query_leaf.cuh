// K1's leaf evaluation, shared by the query (query.cu) and the kernel its
// backward modes replaced (check/query_vjp_reference.cu): a warp's
// coefficient rows staged in shared memory with cp.async, the leaf frame,
// the Legendre recurrences to the order asked and the product sums over the
// row (eval_leaf). query.cu describes the design.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "packed_rows.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;        // coefficients staged per round
constexpr int kMaxDeg = 12;       // BASIS_MAX_DEGREE
// A warp stages its rows when it reads more than kStageMin distinct ones;
// with fewer (points in runs, as a slice's raster gives) each lane reads
// its own row, and the loads are mostly broadcasts.
constexpr int kStageMin = 8;
// Percent of the SM's shared memory preferred over L1: 75 keeps the blocks
// the tile allows and leaves more L1 to the descent's nodes than the
// default (PERF.md).
constexpr int kCarveout = 75;
constexpr unsigned kFullMask = 0xffffffffu;

// --- warp-cooperative row staging -----------------------------------------
//
// Lanes that read the same row as the lane before them share its slot, so a
// run of them copies the row once and reads it by broadcast.

struct WarpSlots {
  int slot;   // this lane's slot: the rank of its run among the warp's runs
  int n;      // slots in use
};

// Assigns the warp's slots and writes each slot's row to slot_row[slot].
// Every lane of the warp must call it.
__device__ __forceinline__ WarpSlots warp_slots(const double* row,
                                                const double** slot_row) {
  const int lane = threadIdx.x & 31;
  const unsigned long long key = reinterpret_cast<unsigned long long>(row);
  const unsigned long long prev = __shfl_up_sync(kFullMask, key, 1);
  const bool lead = lane == 0 || prev != key;
  const unsigned leaders = __ballot_sync(kFullMask, lead);
  WarpSlots s;
  s.slot = __popc(leaders & (kFullMask >> (31 - lane))) - 1;
  s.n = __popc(leaders);
  if (lead) slot_row[s.slot] = row;
  __syncwarp();
  return s;
}

// Starts copying coefficients [e0, e0 + ne) of each slot's row into
// tile[slot * STRIDE + e - e0], one 8-byte cp.async a coefficient,
// neighbouring lanes on neighbouring coefficients; stage_wait() ends it.
template <int STRIDE>
__device__ __forceinline__ void stage_rows(double* tile,
                                           const double* const* slot_row,
                                           int n_slots, int e0, int ne) {
  for (int k = threadIdx.x & 31; k < n_slots * ne; k += 32) {
    const int s = k / ne, e = k - s * ne;
    const unsigned dst =
        (unsigned)__cvta_generic_to_shared(tile + s * STRIDE + e);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(slot_row[s] + e0 + e));
  }
}

// Waits for this lane's copies, then for the warp's.
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// --- the query ----------------------------------------------------------

template <int DEG>
struct Shape {
  static constexpr int kC = (DEG + 1) * (DEG + 2) * (DEG + 3) / 6;
  static constexpr int kChunks = (kC + kChunk - 1) / kChunk;
  static constexpr int kTile = kC < kChunk ? kC : kChunk;
  // odd: the 16 lanes of an 8-byte read phase hit 16 different bank pairs
  static constexpr int kStride = kTile | 1;
};

// Node n's centre: its 24-byte record as one 16-byte and one 8-byte load,
// whichever half is 16-byte aligned (the array's base is).
__device__ __forceinline__ void load_centre(const double* __restrict__ centre,
                                            int n, double c[3]) {
  const double* p = centre + 3 * (int64_t)n;
  const bool even = (n & 1) == 0;
  const double2 v =
      __ldg(reinterpret_cast<const double2*>(p + (even ? 0 : 1)));
  const double s = __ldg(p + (even ? 2 : 0));
  c[0] = even ? v.x : s;
  c[1] = even ? v.y : v.x;
  c[2] = even ? s : v.y;
}

// nt[p] = sqrt((2p+1) 2^d) for p = 0..DEG, bit for bit the host table's:
// sqrt(x 4^k) = sqrt(x) 2^k exactly, so for d = 2k it is sqrt(2p+1) 2^k and
// for d = 2k+1 sqrt(4p+2) 2^k.
template <int DEG>
__device__ __forceinline__ void axis_norms(int d, double (&nt)[DEG + 1]) {
  const double kEven[kMaxDeg + 1] = {
      1.0, 1.7320508075688772, 2.23606797749979, 2.6457513110645907, 3.0,
      3.3166247903554, 3.605551275463989, 3.872983346207417,
      4.123105625617661, 4.358898943540674, 4.58257569495584,
      4.795831523312719, 5.0};
  const double kOdd[kMaxDeg + 1] = {
      1.4142135623730951, 2.449489742783178, 3.1622776601683795,
      3.7416573867739413, 4.242640687119285, 4.69041575982343,
      5.0990195135927845, 5.477225575051661, 5.830951894845301,
      6.164414002968976, 6.48074069840786, 6.782329983125268,
      7.0710678118654755};
  const double two_k = __longlong_as_double((long long)(1023 + (d >> 1)) << 52);
#pragma unroll
  for (int p = 0; p <= DEG; ++p)
    nt[p] = ((d & 1) ? kOdd[p] : kEven[p]) * two_k;
}

// A point's axis factors and sums: ORDER 0 the value, 1 also the gradient,
// 2 also the Hessian h (xx, yy, zz, xy, xz, yz), all in the leaf's frame.
template <int DEG, int ORDER>
struct Leaf {
  double N[3][DEG + 1];                         // L_p(x_a) * nt[p]
  double dN[3][ORDER >= 1 ? DEG + 1 : 1];       // L'_p(x_a) * nt[p]
  double d2N[3][ORDER >= 2 ? DEG + 1 : 1];      // L''_p(x_a) * nt[p]
  double v, g[3], h[6];
};

// Adds the terms m in [lo, hi) to lf, coef(m) their coefficients.
template <int DEG, int ORDER, class Coef>
__device__ __forceinline__ void add_terms(Coef coef, int lo, int hi,
                                          Leaf<DEG, ORDER>& lf) {
  auto term = [&](int m, int i, int j, int k) {
    if (m < lo || m >= hi) return;
    const double cm = coef(m);
    const double(&N)[3][DEG + 1] = lf.N;
    const double xy = N[0][i] * N[1][j];
    lf.v += cm * (xy * N[2][k]);
    if constexpr (ORDER >= 1) {
      const auto& dN = lf.dN;
      lf.g[0] += cm * (dN[0][i] * N[1][j] * N[2][k]);
      lf.g[1] += cm * (N[0][i] * dN[1][j] * N[2][k]);
      lf.g[2] += cm * (xy * dN[2][k]);
      if constexpr (ORDER >= 2) {
        const auto& d2N = lf.d2N;
        lf.h[0] += cm * (d2N[0][i] * N[1][j] * N[2][k]);
        lf.h[1] += cm * (N[0][i] * d2N[1][j] * N[2][k]);
        lf.h[2] += cm * (xy * d2N[2][k]);
        lf.h[3] += cm * (dN[0][i] * dN[1][j] * N[2][k]);
        lf.h[4] += cm * (dN[0][i] * N[1][j] * dN[2][k]);
        lf.h[5] += cm * (N[0][i] * dN[1][j] * dN[2][k]);
      }
    }
  };
  // K1h's nine sums take the terms by (i, j): in for_each_term's order
  // their six kinds of pair product stay live across the row, which spilled
  // 48 bytes at degree 5 (PERF.md)
  if constexpr (ORDER >= 2 && DEG <= hpsdf::kUnrolledDeg)
    hpsdf::for_each_term_by_pair<DEG>(term);
  else if constexpr (ORDER >= 2)
    hpsdf::for_each_term_of<DEG>(term);
  else
    hpsdf::for_each_term<DEG>(term);
}

// The product sum over the row (one per lane; with `staged`, the warp's
// rows staged in the tile, chunk 0's copy started by the caller), kChunk
// coefficients at a time: unrolled up to two chunks, which the degrees up
// to 5 take, in a loop above.
template <int DEG, int ORDER>
__device__ __forceinline__ void sum_row(double* tile,
                                        const double* const* slot_row,
                                        WarpSlots ws, bool staged,
                                        const double* row,
                                        Leaf<DEG, ORDER>& lf) {
  using S = Shape<DEG>;
  if constexpr (S::kChunks <= 2) {
    if (staged) {
#pragma unroll
      for (int ch = 0; ch < S::kChunks; ++ch) {
        const int m0 = ch * kChunk;
        if (ch > 0) {
          __syncwarp();                       // the warp is done with ch - 1
          stage_rows<S::kStride>(tile, slot_row, ws.n, m0, S::kC - m0);
        }
        stage_wait();
        const double* cs = tile + ws.slot * S::kStride - m0;
        add_terms([&](int m) { return cs[m]; }, m0, min(m0 + kChunk, S::kC),
                  lf);
      }
    } else {
      add_terms([&](int m) { return __ldg(row + m); }, 0, S::kC, lf);
    }
  } else {
#pragma unroll 1
    for (int ch = 0; ch < S::kChunks; ++ch) {
      const int m0 = ch * kChunk;
      const double* cs = row;                 // cs[m]: term m's coefficient
      if (staged) {
        if (ch > 0) {
          __syncwarp();
          stage_rows<S::kStride>(tile, slot_row, ws.n, m0,
                                 min(kChunk, S::kC - m0));
        }
        stage_wait();
        cs = tile + ws.slot * S::kStride - m0;
      }
      add_terms([&](int m) { return cs[m]; }, m0, m0 + kChunk, lf);
    }
  }
}

// Adds leaf n's basis at the clamped unit-cube point u into lf: its row
// staged with the warp's when the warp reads more than kStageMin distinct
// rows, the leaf frame and the recurrences while the rows arrive. Every lane
// of the warp must call it. Returns the frame's scale 2^(depth+1).
template <int DEG, int ORDER>
__device__ __forceinline__ double eval_leaf(
    double* tile, const double** slot_row, const double* __restrict__ centre,
    const int32_t* __restrict__ depth, const double* __restrict__ coeffs,
    int n, const double (&u)[3], Leaf<DEG, ORDER>& lf) {
  using S = Shape<DEG>;
  const double* row = coeffs + (int64_t)n * S::kC;
  const WarpSlots ws = warp_slots(row, slot_row);
  const bool staged = ws.n > kStageMin;
  if (staged) stage_rows<S::kStride>(tile, slot_row, ws.n, 0, S::kTile);
  const int d = __ldg(depth + n);
  double cc[3];
  load_centre(centre, n, cc);
  const double scale = ldexp(1.0, d + 1);
  double nt[DEG + 1];
  axis_norms<DEG>(d, nt);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    double L[DEG + 1];
    hpsdf::legendre<DEG>((u[a] - cc[a]) * scale, L);
#pragma unroll
    for (int p = 0; p <= DEG; ++p) lf.N[a][p] = L[p] * nt[p];
    if constexpr (ORDER >= 1) {
      double dL[DEG + 1];
      hpsdf::legendre_deriv<DEG>(L, dL);
#pragma unroll
      for (int p = 0; p <= DEG; ++p) lf.dN[a][p] = dL[p] * nt[p];
      if constexpr (ORDER >= 2) {
        double d2L[DEG + 1];
        hpsdf::legendre_deriv2<DEG>(dL, d2L);
#pragma unroll
        for (int p = 0; p <= DEG; ++p) lf.d2N[a][p] = d2L[p] * nt[p];
      }
    }
  }
  sum_row<DEG, ORDER>(tile, slot_row, ws, staged, row, lf);
  return scale;
}

}  // namespace
