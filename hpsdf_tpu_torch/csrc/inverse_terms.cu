// K13: the inverse chunk's loss terms, in three launches a chunk.
//
// Replaces the fused loop XLA made of hpsdf_tpu/inverse.py:188-244
// chunk_field (the target points, the field, free-space, eikonal and depth
// sums) and of its VJP (jax.grad through jax.checkpoint, :246). The plain
// torch versions are inverse_points_plain, chunk_terms_plain and
// chunk_terms_vjp_plain in hpsdf_tpu_torch/inverse.py; they replace some
// 128 small launches a chunk. K2/K5's fused read
// (accel.values_and_gradient_at) stays between the first launch and the
// others, and K7, K8 and G's backward take the cotangents written here.
//
// inverse_points_kernel, a thread a ray: the chunk's 7n points in the
// order the read takes them, the band points (surface o + tt d, in
// o + (tt + BAND) d, out o + (tt - BAND) d), then the free-space points at
// FRACS of tt, fraction-major. Each operation rounds as torch's elementwise
// ops do (the __f*_rn intrinsics keep nvcc from contracting an FMA), so the
// points are the plain version's bit for bit. They are written out, not
// formed inside K2, because K7's form 0 reads the same points in the
// backward. Bound: 28 bytes a ray in, 84 out.
//
// The terms: from the ray's 7 values f, its 3 band gradients g, its masks
// and depths (t marched, tt the target), with s = target hit, m = hit &
// target hit, half = BAND / 2, cs = surface_weight / surf_n,
// ce = eikonal_weight / (3 surf_n), cd = depth_weight / dn (surf_n and dn
// read from the card: no sync),
//   loss_i = s (cs (fsurf^2 + relu(f_in + half)^2 + relu(half - f_out)^2
//                   + sum_k relu(half - f_free_k)^2 / 4)
//               + ce sum_j (sqrt(|g_j|^2 + 1e-12) - 1)^2)
//            + m cd (t - tt)^2
// and its VJP by hand: df (7n), dg (3n, 3) and dt (n), in the plain
// version's order of operations. relu's derivative is 0 at 0, as torch's
// (x > 0, not x >= 0); a padded ray (target hit false) gets zeros. Both
// launches take a ray's terms from one function (ray_terms), in the order
// of the kernel they replaced (csrc/check/inverse_terms_reference.cu).
//
// inverse_loss_kernel, the forward: the chunk's loss alone, summed
// deterministically, with no float atomics: a thread adds its rays in
// index order, a fixed tree in each block, the block's partial to the
// caller's scratch, and the last block to finish (an integer ticket in the
// same scratch) sums the partials in a fixed order and sets the ticket
// back to 0. The scratch is the launch's own: launches in flight at once
// each need theirs. The grid is at most kLossBlocks blocks of 512 threads
// (a block an SM of the H100; a ray a thread at a chunk of 2^16 rays, more
// on larger chunks), so the last block adds at most 132 partials where the
// replaced kernel added one for every 256 rays; a block of 512 threads
// and a ray a thread timed faster than blocks of 256 or 1,024 threads and
// than two or four rays a thread loaded together. Bound: 74 bytes a ray
// in.
//
// inverse_vjp_kernel, the backward, a thread a ray: each cotangent in the
// replaced kernel's order, times the loss's cotangent go (read on the
// card) with __fmul_rn: that kernel's output times go bit for bit, as
// torch's df * go rounds it, in one launch where the replaced backward
// took three. Bound: 74 bytes a ray in, 68 out. The pair moves 216 bytes
// a ray in two launches; the replaced form moved 278 in four. Both are
// ~100 f32 operations a ray, under the bytes on this card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBand = 0.02f;                 // inverse.BAND
constexpr float kHalf = 0.01f;                 // BAND * 0.5, exact
constexpr int kFracs = 4;
__constant__ float kFrac[kFracs] = {0.35f, 0.6f, 0.8f, 0.93f};  // FRACS
constexpr float kEikEps = 1e-12f;
constexpr int kLossThreads = 512;      // the loss's block
constexpr int kLossWarps = kLossThreads / 32;
constexpr unsigned kLossBlocks = 132;   // the loss's blocks at most

__global__ void __launch_bounds__(kThreads)
inverse_points_kernel(const float* __restrict__ o,
                      const float* __restrict__ d,
                      const float* __restrict__ tt, int64_t n,
                      float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float t = tt[i];
  auto put = [&](int64_t row, float s) {
    out[3 * row] = __fadd_rn(ox, __fmul_rn(s, dx));
    out[3 * row + 1] = __fadd_rn(oy, __fmul_rn(s, dy));
    out[3 * row + 2] = __fadd_rn(oz, __fmul_rn(s, dz));
  };
  put(i, t);
  put(n + i, __fadd_rn(t, kBand));
  put(2 * n + i, __fsub_rn(t, kBand));
#pragma unroll
  for (int k = 0; k < kFracs; ++k) put((3 + k) * n + i, __fmul_rn(kFrac[k], t));
}

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

// The chunk's arrays and the loss's constants, as both terms launches
// read them.
struct Chunk {
  const float* __restrict__ f;
  const float* __restrict__ g;
  const uint8_t* __restrict__ th;
  const uint8_t* __restrict__ hit;
  const float* __restrict__ t;
  const float* __restrict__ tt;
  int64_t n;
  float cs, ce, cd;
};

__device__ __forceinline__ Chunk make_chunk(
    const float* f, const float* g, const uint8_t* th, const uint8_t* hit,
    const float* t, const float* tt, int64_t n, const float* surf_n_p,
    const float* dn_p, float sw, float ew, float dw) {
  const float surf_n = __ldg(surf_n_p), dn = __ldg(dn_p);
  return Chunk{f, g, th, hit, t, tt, n, __fdiv_rn(sw, surf_n),
               __fdiv_rn(ew, __fmul_rn(3.f, surf_n)), __fdiv_rn(dw, dn)};
}

// Ray i's loss; with kGrad also its cotangents times go into df, dg, dt.
template <bool kGrad>
__device__ __forceinline__ float ray_terms(const Chunk& c, int64_t i,
                                           float go, float* __restrict__ df,
                                           float* __restrict__ dg,
                                           float* __restrict__ dt) {
  const int64_t n = c.n;
  const bool target = c.th[i] != 0;
  const float s = target ? 1.f : 0.f;
  const float m = (target && c.hit[i] != 0) ? 1.f : 0.f;

  // the field and free-space terms, and their cotangents
  const float fs = c.f[i];
  const float ri = fmaxf(__fadd_rn(c.f[n + i], kHalf), 0.f);
  const float ro = fmaxf(__fsub_rn(kHalf, c.f[2 * n + i]), 0.f);
  const float field = __fadd_rn(__fadd_rn(sq(fs), sq(ri)), sq(ro));
  const float ws = __fmul_rn(s, c.cs);
  const float w2 = __fmul_rn(2.f, ws), wh = __fmul_rn(0.5f, ws);
  if (kGrad) {
    df[i] = __fmul_rn(__fmul_rn(w2, fs), go);
    df[n + i] = __fmul_rn(__fmul_rn(w2, ri), go);
    df[2 * n + i] = __fmul_rn(-__fmul_rn(w2, ro), go);
  }
  float free = 0.f;
#pragma unroll
  for (int k = 0; k < kFracs; ++k) {
    const float r = fmaxf(__fsub_rn(kHalf, c.f[(3 + k) * n + i]), 0.f);
    free = k == 0 ? sq(r) : __fadd_rn(free, sq(r));
    if (kGrad) df[(3 + k) * n + i] = __fmul_rn(-__fmul_rn(wh, r), go);
  }

  // the eikonal term at the three band points, and its cotangent
  const float we2 = __fmul_rn(2.f, __fmul_rn(s, c.ce));
  float eik = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int64_t q = 3 * (j * n + i);
    const float gx = c.g[q], gy = c.g[q + 1], gz = c.g[q + 2];
    const float gn = __fsqrt_rn(
        __fadd_rn(__fadd_rn(__fadd_rn(sq(gx), sq(gy)), sq(gz)), kEikEps));
    const float e = __fsub_rn(gn, 1.f);
    eik = j == 0 ? sq(e) : __fadd_rn(eik, sq(e));
    if (kGrad) {
      const float w = __fmul_rn(we2, __fdiv_rn(e, gn));
      dg[q] = __fmul_rn(__fmul_rn(w, gx), go);
      dg[q + 1] = __fmul_rn(__fmul_rn(w, gy), go);
      dg[q + 2] = __fmul_rn(__fmul_rn(w, gz), go);
    }
  }

  // the depth term
  const float dtt = __fsub_rn(c.t[i], c.tt[i]);
  if (kGrad)
    dt[i] = __fmul_rn(__fmul_rn(__fmul_rn(2.f, __fmul_rn(m, c.cd)), dtt),
                      go);
  return __fadd_rn(
      __fmul_rn(s, __fadd_rn(__fmul_rn(c.cs, __fadd_rn(field,
                                                       __fmul_rn(0.25f,
                                                                 free))),
                             __fmul_rn(c.ce, eik))),
      __fmul_rn(m, __fmul_rn(c.cd, sq(dtt))));
}

// the block's sum of v, in a fixed order; valid in thread 0
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kLossWarps; ++w) s = __fadd_rn(s, warp_sums[w]);
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(kLossThreads)
inverse_loss_kernel(const float* __restrict__ f, const float* __restrict__ g,
                    const uint8_t* __restrict__ th,
                    const uint8_t* __restrict__ hit,
                    const float* __restrict__ t, const float* __restrict__ tt,
                    int64_t n, const float* __restrict__ surf_n_p,
                    const float* __restrict__ dn_p, float sw, float ew,
                    float dw, float* __restrict__ loss,
                    float* __restrict__ scratch) {
  __shared__ float warp_sums[kLossWarps];
  __shared__ bool last;
  const Chunk c = make_chunk(f, g, th, hit, t, tt, n, surf_n_p, dn_p, sw,
                             ew, dw);
  // a thread's rays, in index order
  float acc = 0.f;
  for (int64_t i = (int64_t)blockIdx.x * kLossThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kLossThreads)
    acc = __fadd_rn(acc, ray_terms<false>(c, i, 1.f, nullptr, nullptr,
                                          nullptr));

  // the chunk's loss: this block's partial, then the last block's sum;
  // scratch[0] counts the blocks done, the partials follow it
  unsigned* const ticket = reinterpret_cast<unsigned*>(scratch);
  float* const partials = scratch + 1;
  const float part = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = part;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float sum = 0.f;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += blockDim.x)
    sum = __fadd_rn(sum, __ldcg(partials + b));
  const float total = block_sum(sum, warp_sums);
  if (threadIdx.x == 0) {
    *loss = total;
    *ticket = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
inverse_vjp_kernel(const float* __restrict__ f, const float* __restrict__ g,
                   const uint8_t* __restrict__ th,
                   const uint8_t* __restrict__ hit,
                   const float* __restrict__ t, const float* __restrict__ tt,
                   int64_t n, const float* __restrict__ surf_n_p,
                   const float* __restrict__ dn_p, float sw, float ew,
                   float dw, const float* __restrict__ go_p,
                   float* __restrict__ df, float* __restrict__ dg,
                   float* __restrict__ dt) {
  // go is loaded before the bounds test: loaded after it, as the argument
  // of ray_terms, the launch timed slower on the H100
  const float go = __ldg(go_p);
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Chunk c = make_chunk(f, g, th, hit, t, tt, n, surf_n_p, dn_p, sw,
                             ew, dw);
  ray_terms<true>(c, i, go, df, dg, dt);
}

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

unsigned loss_blocks(int64_t n) {
  const unsigned b = (unsigned)((n + kLossThreads - 1) / kLossThreads);
  return b < kLossBlocks ? b : kLossBlocks;
}

}  // namespace

// o, d: (n, 3) f32; tt: (n,) f32; out: (7n, 3) f32; all contiguous.
extern "C" int hpsdf_inverse_points(const float* o, const float* d,
                                    const float* tt, int64_t n, float* out,
                                    void* stream) {
  if (n == 0) return 0;
  inverse_points_kernel<<<blocks_for(n), kThreads, 0,
                          (cudaStream_t)stream>>>(o, d, tt, n, out);
  return (int)cudaGetLastError();
}

// The 4-byte words of inverse_loss's scratch: the ticket, then a partial
// a block.
extern "C" int64_t hpsdf_inverse_terms_scratch(int64_t n) {
  return 1 + (int64_t)loss_blocks(n);
}

// f: (7n,) f32; g: (3n, 3) f32; th, hit: (n,) bool as bytes; t, tt: (n,)
// f32; surf_n, dn: one f32 each on the card; loss: one f32; scratch:
// hpsdf_inverse_terms_scratch(n) words, zero on entry and left zero, no
// other launch's in flight. n > 0, all contiguous.
extern "C" int hpsdf_inverse_loss(const float* f, const float* g,
                                  const uint8_t* th, const uint8_t* hit,
                                  const float* t, const float* tt, int64_t n,
                                  const float* surf_n, const float* dn,
                                  float sw, float ew, float dw, float* loss,
                                  float* scratch, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  inverse_loss_kernel<<<loss_blocks(n), kLossThreads, 0,
                        (cudaStream_t)stream>>>(
      f, g, th, hit, t, tt, n, surf_n, dn, sw, ew, dw, loss, scratch);
  return (int)cudaGetLastError();
}

// The forward's inputs as there; go: the loss's cotangent, one f32 on the
// card; df (7n,), dg (3n, 3), dt (n,) f32. n > 0, all
// contiguous.
extern "C" int hpsdf_inverse_vjp(const float* f, const float* g,
                                 const uint8_t* th, const uint8_t* hit,
                                 const float* t, const float* tt, int64_t n,
                                 const float* surf_n, const float* dn,
                                 float sw, float ew, float dw,
                                 const float* go, float* df, float* dg,
                                 float* dt, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  inverse_vjp_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      f, g, th, hit, t, tt, n, surf_n, dn, sw, ew, dw, go, df, dg, dt);
  return (int)cudaGetLastError();
}
