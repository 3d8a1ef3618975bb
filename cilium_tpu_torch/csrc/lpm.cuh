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

// One level of the v4 walk: a word >= 0 is the answer and passes on; a
// negative word names the next level's block, whose entry for `byte`
// is loaded (K1 issues each level beside its other gathers).
__device__ __forceinline__ int32_t lpm_v4_step(const int32_t* level,
                                               int32_t n_blocks, int32_t a,
                                               uint32_t byte) {
  return a >= 0 ? a
                : __ldg(&level[xla_index(-(int64_t)a - 1, n_blocks) * 256 +
                               byte]);
}

__device__ __forceinline__ int32_t lpm_v4(const LpmView& t, uint32_t ip) {
  int32_t a = __ldg(&t.l1[ip >> 16]);
  int32_t b = lpm_v4_step(t.l2, t.n_l2, a, (ip >> 8) & 0xFF);
  return lpm_v4_step(t.l3, t.n_l3, b, ip & 0xFF);
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
