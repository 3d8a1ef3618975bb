// ipcache LPM device functions.
//
// Replaces: cilium_tpu/datapath/lpm.py lookup_v4 / lookup_v6 /
// lpm_lookup (:258-291).
// Bound: latency.  A v4 lookup is up to three DEPENDENT 4-byte gathers
// (l1 -> l2 -> l3); a v6 lookup is a probe of the TCAM's index for each
// distinct mask, longest first, until no shorter mask can win: one
// 32-byte slot a probe (two in config #3: the /128 pods, then ::/0).
// Design: called inline by datapath_kernel, so the identity row stays
// in a register; l1 (256 KB) and the index stay hot in L2 across the
// batch, and __ldg routes the read-only tables through the read-only
// cache.  The reference scans every entry and keeps the first of the
// longest matching prefix; the host (datapath/lpm.py lpm6_index) keys
// each entry that can win by (mask, net), keeps in each key's slot the
// entry of the largest plen (the lowest index on a tie), and orders the
// masks by their largest plen, so the probes give the same answer.  The
// old [K] scan cost 9 loads an entry for every v6 lane, and nearly every
// warp of a mixed batch has one (PERF.md).
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

// The index's slot hash of a masked address and its group.  The one
// source of its constants: datapath/lpm.py lpm6_index_hash copies it to
// place the entries on the host, so a change here is made there too.
__device__ __forceinline__ uint32_t lpm6_index_hash(uint4 w, uint32_t group) {
  uint32_t h = (w.x * 0x9E3779B1u) ^ (w.y * 0x85EBCA6Bu) ^
               (w.z * 0xC2B2AE35u) ^ (w.w * 0x27D4EB2Fu) ^
               (group * 0x165667B1u);
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  return h ^ (h >> 15);
}

// The v6 LPM of one address through t's index.  `groups` holds t's
// n_groups masks, two 16-byte words each (the mask, then its largest
// plen in .x), in shared or global memory: every lane of a warp reads
// the same group at once.  Each group's probe walks from the key's home
// slot to its slot or an empty one (half the slots are empty); a slot
// holds the entry of the largest plen of its key.  The longest plen
// wins, the lowest entry on a tie; a group whose largest plen is below
// the best so far cannot win, nor can any after it.
__device__ __forceinline__ int32_t lpm_v6(const LpmView& t,
                                          const uint4* groups,
                                          const uint32_t ip[4]) {
  const uint32_t cap_mask = (uint32_t)t.index_cap - 1;
  const uint4* slots = reinterpret_cast<const uint4*>(t.v6_index);
  int32_t best_plen = -1, best_entry = 0, best_value = t.dflt;
  for (int32_t g = 0; g < t.n_groups; ++g) {
    const uint4 m = groups[2 * g];
    if (best_plen > (int32_t)groups[2 * g + 1].x) break;
    const uint4 key = make_uint4(ip[0] & m.x, ip[1] & m.y, ip[2] & m.z,
                                 ip[3] & m.w);
    for (uint32_t h = lpm6_index_hash(key, (uint32_t)g) & cap_mask;;
         h = (h + 1) & cap_mask) {
      const uint4 net = __ldg(slots + 2 * h);
      const int4 e = __ldg(reinterpret_cast<const int4*>(slots) + 2 * h + 1);
      if (e.x < 0) break;  // an empty slot: no entry of this key
      if (e.x == g && net.x == key.x && net.y == key.y && net.z == key.z &&
          net.w == key.w) {
        if (e.z > best_plen || (e.z == best_plen && e.y < best_entry)) {
          best_plen = e.z;
          best_entry = e.y;
          best_value = e.w;
        }
        break;
      }
    }
  }
  return best_value;
}
