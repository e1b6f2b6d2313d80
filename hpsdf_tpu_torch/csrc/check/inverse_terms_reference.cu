// K13's terms as they were before their redesign, kept as the reference
// of inverse_terms.cu: one launch a chunk, a thread a ray, that writes the
// chunk's loss and every cotangent of it (df, dg, dt), 256 partial sums
// added by the last block; the backward then scaled the cotangents by the
// loss's cotangent in three torch launches. The redesigned VJP computes
// each cotangent in this kernel's order and multiplies it by the loss's
// cotangent as torch's df * go rounds, so its output must be this
// kernel's times go bit for bit; chip_smoke.py builds this file apart from
// the library (_kernels.load_check), holds inverse_terms.cu to it and times
// both. It is on no path of the package.
//
// The note of the kernel as it shipped (its scratch: a ticket and a
// partial for each block of 256 rays, zero on entry and left zero):
//
// inverse_terms_kernel, a thread a ray: from the ray's 7 values f, its 3
// band gradients g, its masks and depths (t marched, tt the target), with
// s = target hit, m = hit & target hit, half = BAND / 2,
//   cs = surface_weight / surf_n, ce = eikonal_weight / (3 surf_n),
//   cd = depth_weight / dn (surf_n and dn read from the card: no sync),
//   loss_i = s (cs (fsurf^2 + relu(f_in + half)^2 + relu(half - f_out)^2
//                   + sum_k relu(half - f_free_k)^2 / 4)
//               + ce sum_j (sqrt(|g_j|^2 + 1e-12) - 1)^2)
//            + m cd (t - tt)^2
// and its VJP by hand: df (7n), dg (3n, 3) and dt (n), in the plain
// version's order of operations. relu's derivative is 0 at 0, as torch's
// (x > 0, not x >= 0); a padded ray (target hit false) gets zeros. The
// chunk's loss is summed deterministically: a fixed tree in each block,
// the block's partial to the caller's scratch, and the last block to finish
// (an integer ticket in the same scratch, no float atomics) sums the
// partials in a fixed order and sets the ticket back to 0. The scratch is
// the launch's own: launches in flight at once each need theirs.
// Bound: 74 bytes a ray in, 68 out; ~90 f32 operations a ray, under the
// bytes on this card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kHalf = 0.01f;                 // BAND * 0.5, exact
constexpr int kFracs = 4;
constexpr float kEikEps = 1e-12f;

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

// the block's sum of v, in a fixed order; valid in thread 0
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, warp_sums[w]);
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(kThreads)
inverse_terms_reference_kernel(
    const float* __restrict__ f, const float* __restrict__ g,
    const uint8_t* __restrict__ th, const uint8_t* __restrict__ hit,
    const float* __restrict__ t, const float* __restrict__ tt, int64_t n,
    const float* __restrict__ surf_n_p, const float* __restrict__ dn_p,
    float sw, float ew, float dw, float* __restrict__ loss,
    float* __restrict__ df, float* __restrict__ dg, float* __restrict__ dt,
    float* __restrict__ scratch) {
  __shared__ float warp_sums[kWarps];
  __shared__ bool last;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float contrib = 0.f;
  if (i < n) {
    const float surf_n = __ldg(surf_n_p), dn = __ldg(dn_p);
    const float cs = __fdiv_rn(sw, surf_n);
    const float ce = __fdiv_rn(ew, __fmul_rn(3.f, surf_n));
    const float cd = __fdiv_rn(dw, dn);
    const bool target = th[i] != 0;
    const float s = target ? 1.f : 0.f;
    const float m = (target && hit[i] != 0) ? 1.f : 0.f;

    // the field and free-space terms, and their cotangents
    const float fs = f[i];
    const float ri = fmaxf(__fadd_rn(f[n + i], kHalf), 0.f);
    const float ro = fmaxf(__fsub_rn(kHalf, f[2 * n + i]), 0.f);
    const float field = __fadd_rn(__fadd_rn(sq(fs), sq(ri)), sq(ro));
    const float ws = __fmul_rn(s, cs);
    const float w2 = __fmul_rn(2.f, ws), wh = __fmul_rn(0.5f, ws);
    df[i] = __fmul_rn(w2, fs);
    df[n + i] = __fmul_rn(w2, ri);
    df[2 * n + i] = -__fmul_rn(w2, ro);
    float free = 0.f;
#pragma unroll
    for (int k = 0; k < kFracs; ++k) {
      const float r = fmaxf(__fsub_rn(kHalf, f[(3 + k) * n + i]), 0.f);
      free = k == 0 ? sq(r) : __fadd_rn(free, sq(r));
      df[(3 + k) * n + i] = -__fmul_rn(wh, r);
    }

    // the eikonal term at the three band points, and its cotangent
    const float we2 = __fmul_rn(2.f, __fmul_rn(s, ce));
    float eik = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int64_t q = 3 * (j * n + i);
      const float gx = g[q], gy = g[q + 1], gz = g[q + 2];
      const float gn = __fsqrt_rn(
          __fadd_rn(__fadd_rn(__fadd_rn(sq(gx), sq(gy)), sq(gz)), kEikEps));
      const float e = __fsub_rn(gn, 1.f);
      eik = j == 0 ? sq(e) : __fadd_rn(eik, sq(e));
      const float c = __fmul_rn(we2, __fdiv_rn(e, gn));
      dg[q] = __fmul_rn(c, gx);
      dg[q + 1] = __fmul_rn(c, gy);
      dg[q + 2] = __fmul_rn(c, gz);
    }

    // the depth term
    const float dtt = __fsub_rn(t[i], tt[i]);
    dt[i] = __fmul_rn(__fmul_rn(2.f, __fmul_rn(m, cd)), dtt);
    contrib = __fadd_rn(
        __fmul_rn(s, __fadd_rn(__fmul_rn(cs, __fadd_rn(field,
                                                       __fmul_rn(0.25f, free))),
                               __fmul_rn(ce, eik))),
        __fmul_rn(m, __fmul_rn(cd, sq(dtt))));
  }

  // the chunk's loss: this block's partial, then the last block's sum;
  // scratch[0] counts the blocks done, the partials follow it
  unsigned* const ticket = reinterpret_cast<unsigned*>(scratch);
  float* const partials = scratch + 1;
  const float part = block_sum(contrib, warp_sums);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = part;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float acc = 0.f;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += blockDim.x)
    acc = __fadd_rn(acc, __ldcg(partials + b));
  const float total = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) {
    *loss = total;
    *ticket = 0;
  }
}

}  // namespace

// f: (7n,) f32; g: (3n, 3) f32; th, hit: (n,) bool as bytes; t, tt: (n,)
// f32; surf_n, dn: one f32 each on the card; loss: one f32; df (7n,),
// dg (3n, 3), dt (n,) f32; scratch: 1 + ceil(n / 256) words, zero on entry
// and left zero, no other launch's in flight. n > 0, all contiguous.
extern "C" int hpsdf_inverse_terms_reference(
    const float* f, const float* g, const uint8_t* th, const uint8_t* hit,
    const float* t, const float* tt, int64_t n, const float* surf_n,
    const float* dn, float sw, float ew, float dw, float* loss, float* df,
    float* dg, float* dt, float* scratch, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  inverse_terms_reference_kernel<<<blocks, kThreads, 0,
                                   (cudaStream_t)stream>>>(
      f, g, th, hit, t, tt, n, surf_n, dn, sw, ew, dw, loss, df, dg, dt,
      scratch);
  return (int)cudaGetLastError();
}
