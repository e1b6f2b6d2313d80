// Warp-aggregated scatter-add, used by the earlier forms of K7 and K8 kept
// in check/.
//
// Each of those adds, per point, a few to a few hundred values into one row
// of a table with atomics. Where many points of a warp land in the same row
// (the points of an inverse-rendering chunk crowd into the few hundred leaves
// near the surface), one atomic per lane serialises on that row. So the
// lanes that share a destination (their "peers", __match_any_sync on its
// key) first sum their values in registers, and only the lowest lane of each
// group issues the atomic. The sum follows E. Westphal's reduce_peers: in
// round r each lane adds the partial sum of the next peer still in play, and
// the peers of odd rank drop out, so a group of n lanes needs ceil(log2 n)
// rounds of one shuffle. The schedule depends only on the keys, so it is
// computed once per point and replayed for every value.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_rows.cuh"

namespace hpsdf {

constexpr unsigned kFullWarp = 0xffffffffu;

// The lanes of a warp sharing a key, and the schedule that sums a value over
// each group into its lowest lane (the leader). Every lane of the warp must
// build it and replay it together (full-mask shuffles).
struct PeerSum {
  int src[5];       // the lane read in round r (this lane's own: nothing)
  bool take[5];     // whether round r adds what it read
  int rounds;       // warp-uniform
  bool leader;

  __device__ __forceinline__ explicit PeerSum(unsigned long long key) {
    const int lane = threadIdx.x & 31;
    unsigned peers = __match_any_sync(kFullWarp, key);
    leader = (__ffs(peers) - 1) == lane;
    int rank = __popc(peers & ((1u << lane) - 1u));
    peers &= 0xfffffffeu << lane;             // the peers above this lane
    rounds = 0;
    // a group of at most 32 lanes is done in 5 rounds; the unrolled loop
    // keeps src and take in registers
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const bool more = __any_sync(kFullWarp, peers != 0u);
      const int next = __ffs(peers);          // 1-based, 0 for none
      src[r] = next > 0 ? next - 1 : lane;
      take[r] = more && next > 0;
      peers &= ~__ballot_sync(kFullWarp, rank & 1);
      rank >>= 1;
      rounds += more;
    }
  }

  // x summed over this lane's group, exact in the leader (others hold
  // partial sums).
  template <class T>
  __device__ __forceinline__ T sum(T x) const {
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      if (r >= rounds) break;
      const T y = __shfl_sync(kFullWarp, x, src[r]);
      if (take[r]) x += y;
    }
    return x;
  }
};

}  // namespace hpsdf
