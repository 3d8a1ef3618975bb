// ipcache LPM device functions.
//
// Replaces: cilium_tpu/datapath/lpm.py lookup_v4 / lookup_v6 /
// lpm_lookup (:258-291).
// Bound: latency.  A v4 lookup is up to three DEPENDENT 4-byte gathers
// (l1 -> l2 -> l3); a v6 lookup scans the whole TCAM (n_v6 x 36 B),
// which every v6 row of a warp reads at the same addresses.
// Design: called inline by datapath_kernel, so the identity row stays
// in a register; l1 (256 KB) and the TCAM stay hot in L2 across the
// batch, and __ldg routes the read-only tables through the read-only
// cache.  The TCAM scan keeps the JAX argmax rule: the first entry of
// the longest matching prefix wins.
#pragma once

#include "views.cuh"

__device__ __forceinline__ int32_t lpm_v4(const LpmView& t, uint32_t ip) {
  int32_t a = __ldg(&t.l1[ip >> 16]);
  if (a >= 0) return a;
  int64_t blk2 = xla_index(-(int64_t)a - 1, t.n_l2);
  int32_t b = __ldg(&t.l2[blk2 * 256 + ((ip >> 8) & 0xFF)]);
  if (b >= 0) return b;
  int64_t blk3 = xla_index(-(int64_t)b - 1, t.n_l3);
  return __ldg(&t.l3[blk3 * 256 + (ip & 0xFF)]);
}

__device__ __forceinline__ int32_t lpm_v6(const LpmView& t,
                                          const uint32_t ip[4]) {
  int32_t best = 0, best_score = 0;
  for (int32_t k = 0; k < t.n_v6; ++k) {
    bool hit = true;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      hit &= (ip[w] & __ldg(&t.v6_mask[k * 4 + w])) ==
             __ldg(&t.v6_net[k * 4 + w]);
    int32_t score = hit ? __ldg(&t.v6_plen[k]) : -1;
    if (k == 0 || score > best_score) {
      best = k;
      best_score = score;
    }
  }
  return best_score >= 0 ? __ldg(&t.v6_value[best]) : t.dflt;
}

__device__ __forceinline__ int32_t lpm_lookup_row(const LpmView& t,
                                                  const uint32_t ip[4],
                                                  uint32_t family) {
  return family == 4 ? lpm_v4(t, ip[3]) : lpm_v6(t, ip);
}
