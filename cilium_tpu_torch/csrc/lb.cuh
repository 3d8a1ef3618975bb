// Service LB device functions: the frontend matches, the flow hashes
// and the Maglev pick.
//
// Replaces: the match and select of cilium_tpu/service/__init__.py
// lb_stage (:391) and lb6_stage (:435), which service/socklb.py _resolve
// (:172) repeats for the connect path.  K15 and K16 (lb.cu) and K17's
// resolve phase (socklb.cu) all call these, so the connect path selects
// exactly as lb_stage does: the same compare, the same lowest index.
//
// K15 and K16 probe an index that the host builds with the tables
// (service/__init__.py lb4_index, lb6_index): a probe a row (lb_find4,
// lb_find6), whatever the number of frontends.  K17's connect path (a
// few hundred to CONNECT_CAP misses spread over every SM) indexes the
// frontends its block staged (lb_index4) and looks a miss up a lane each
// (lb_lookup4), with lb_match4_staged, a warp a row over the staged
// addresses, where a port does not pack.  Its predecessor, a warp a row
// streaming the frontends from global memory, paid an L2 trip for every
// 32 frontends it passed (29 us for a batch's ~300 misses), and a
// warp-wide scan of staged frontends reads all of them for every miss
// (PERF.md).
//
// The match is the reference's [N, S] compare: every row against every
// frontend, the LOWEST matching index winning (two service names may
// share a VIP:port).  The indexes keep the lowest index of each key.
#pragma once

#include "views.cuh"

constexpr int LB_TPB = 256;

// K17's staging: the first `staged` (at most PER * blockDim.x) v4
// frontends' addresses into `ips` and their port << 8 | protocol into
// `pps` (shared memory), by every thread of the block.  -> whether every staged port is below 2^24 and
// every protocol below 2^8, so that the packed word compares exactly
// (else the matcher reads the port and protocol from global memory).
// Every load of a thread goes out before its first store: a load,
// store, load loop would wait an L2 round trip a frontend.
template <int PER>
__device__ __forceinline__ bool lb_stage4(const LbView& t, uint32_t* ips,
                                          uint32_t* pps, int staged) {
  uint32_t ip[PER], port[PER], proto[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int q = u * (int)blockDim.x + (int)threadIdx.x;
    if (q < staged) {
      ip[u] = __ldg(&t.svc_ip[q]);
      port[u] = __ldg(&t.svc_port[q]);
      proto[u] = __ldg(&t.svc_proto[q]);
    }
  }
  bool ok = true;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int q = u * (int)blockDim.x + (int)threadIdx.x;
    if (q < staged) {
      ips[q] = ip[u];
      pps[q] = (port[u] << 8) | proto[u];
      ok &= port[u] < (1u << 24) && proto[u] < (1u << 8);
    }
  }
  return __syncthreads_and(ok);
}

// The lowest v4 frontend matching one row, found by a whole warp (every
// lane passes the same row), for K17's misses where the staged ports do
// not pack (lb_stage4): a step covers LB_STAGED_STEP frontends, four
// 16-byte loads of staged addresses a lane (consecutive lanes on
// consecutive addresses: no bank conflict; past the staged ones, from
// global memory), the port and protocol read only where an address
// matches; ballots in index order pick the lowest match.  Each miss reads
// every staged address: the index (lb_index4) serves the packed case.
constexpr int LB_STAGED_STEP = 512;

__device__ __forceinline__ int32_t lb_match4_staged(const LbView& t,
                                                    const uint32_t* ips,
                                                    int staged,
                                                    uint32_t dst,
                                                    uint32_t dport,
                                                    uint32_t proto) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < t.s; base += LB_STAGED_STEP) {
    int hit[4];
    const bool in_smem = base + LB_STAGED_STEP <= staged;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int k = base + 128 * v + 4 * lane;
      uint32_t ip[4];
      if (in_smem) {
        const uint4 x = *reinterpret_cast<const uint4*>(ips + k);
        ip[0] = x.x;
        ip[1] = x.y;
        ip[2] = x.z;
        ip[3] = x.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          ip[q] = k + q < t.s ? __ldg(t.svc_ip + k + q) : 0u;
      }
      hit[v] = -1;
#pragma unroll
      for (int q = 3; q >= 0; --q)
        if (k + q < t.s && ip[q] == dst &&
            __ldg(t.svc_port + k + q) == dport &&
            __ldg(t.svc_proto + k + q) == proto)
          hit[v] = q;
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const unsigned m = __ballot_sync(0xFFFFFFFFu, hit[v] >= 0);
      if (m) {
        const int l = __ffs(m) - 1;
        return base + 128 * v + 4 * l + __shfl_sync(0xFFFFFFFFu, hit[v], l);
      }
    }
  }
  return -1;
}

// K17's index of what lb_stage4 staged (packed ports only): an
// open-addressing table of LB_INDEX slots in shared memory, each the
// LOWEST staged index of one (address, port << 8 | protocol) key, so
// that a miss finds its lowest matching frontend in a probe or two
// instead of a pass over every frontend.  Every thread of the block
// calls; `slots` holds LB_INDEX words.
constexpr int LB_INDEX = 8192;  // twice the frontends a block stages
constexpr int32_t LB_EMPTY = -1;

__device__ __forceinline__ uint32_t lb_index_hash(uint32_t ip, uint32_t pp) {
  return ((ip ^ (pp * 0x85EBCA6Bu)) * 0x9E3779B1u) >> 19;  // 13 bits
}

__device__ __forceinline__ void lb_index4(const uint32_t* ips,
                                          const uint32_t* pps,
                                          int32_t* slots, int staged) {
  for (int h = threadIdx.x; h < LB_INDEX; h += blockDim.x)
    slots[h] = LB_EMPTY;
  __syncthreads();
  for (int q = threadIdx.x; q < staged; q += blockDim.x) {
    const uint32_t ip = ips[q], pp = pps[q];
    uint32_t h = lb_index_hash(ip, pp);
    for (;;) {
      const int32_t cur = atomicCAS(&slots[h], LB_EMPTY, q);
      if (cur == LB_EMPTY) break;
      if (ips[cur] == ip && pps[cur] == pp) {  // the key's slot
        atomicMin(&slots[h], q);
        break;
      }
      h = (h + 1) & (LB_INDEX - 1);
    }
  }
  __syncthreads();
}

// The lowest v4 frontend matching one row, a lane a row, through the
// index (the staged frontends), then through t's frontends past them in
// global memory (in index order: every staged index is lower).
__device__ __forceinline__ int32_t lb_lookup4(const LbView& t,
                                              const uint32_t* ips,
                                              const uint32_t* pps,
                                              const int32_t* slots,
                                              int staged, uint32_t dst,
                                              uint32_t dport,
                                              uint32_t proto) {
  if (dport < (1u << 24) && proto < (1u << 8)) {
    const uint32_t want = (dport << 8) | proto;
    for (uint32_t h = lb_index_hash(dst, want);; h = (h + 1) & (LB_INDEX - 1)) {
      const int32_t q = slots[h];
      if (q == LB_EMPTY) break;
      if (ips[q] == dst && pps[q] == want) return q;
    }
  }
  for (int k = staged; k < t.s; ++k)
    if (__ldg(t.svc_ip + k) == dst && __ldg(t.svc_port + k) == dport &&
        __ldg(t.svc_proto + k) == proto)
      return k;
  return -1;
}

// The v6 index's slot hash of a frontend key.  The one source of its
// constants: service/__init__.py lb6_index_hash copies it to place the
// frontends on the host, so a change here is made there too.
__device__ __forceinline__ uint32_t lb6_index_hash(uint4 dst, uint32_t dport,
                                                  uint32_t proto) {
  uint32_t h = (dst.x * 0x9E3779B1u) ^ (dst.y * 0x85EBCA6Bu) ^
               (dst.z * 0xC2B2AE35u) ^ (dst.w * 0x27D4EB2Fu) ^
               (dport * 0x165667B1u) ^ proto;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  return h ^ (h >> 15);
}

// The lowest v6 frontend matching (dst, dport, proto), -1 for none: a
// linear probe of t's index (index_cap slots, a power of two above the
// frontends, so an empty slot ends every probe), each slot the lowest
// frontend of one key or LB_EMPTY; a slot's frontend is taken only when
// its own words match.
__device__ __forceinline__ int32_t lb_find6(const Lb6View& t, uint4 dst,
                                            uint32_t dport, uint32_t proto) {
  const uint32_t mask = (uint32_t)t.index_cap - 1;
  for (uint32_t h = lb6_index_hash(dst, dport, proto) & mask;;
       h = (h + 1) & mask) {
    const int32_t q = __ldg(t.index + h);
    if (q == LB_EMPTY) return -1;
    const uint4 f = __ldg(reinterpret_cast<const uint4*>(t.svc_ip) + q);
    if (f.x == dst.x && f.y == dst.y && f.z == dst.z && f.w == dst.w &&
        __ldg(t.svc_port + q) == dport && __ldg(t.svc_proto + q) == proto)
      return q;
  }
}

// The lowest v4 frontend matching (dst, dport, proto), -1 for none: a
// linear probe of t's index (index_cap slots, a power of two above the
// frontends, so an empty slot ends every probe) from the key's
// lb6_index_hash slot, the address in its last word (the host places
// the keys so: one source of the constants).  A slot is 16 bytes, the
// key's words and its lowest frontend (-1: empty), so a probe step is
// one load.
__device__ __forceinline__ int32_t lb_find4(const LbView& t, uint32_t dst,
                                            uint32_t dport, uint32_t proto) {
  const uint32_t mask = (uint32_t)t.index_cap - 1;
  const uint4* slots = reinterpret_cast<const uint4*>(t.index);
  for (uint32_t h = lb6_index_hash(make_uint4(0u, 0u, 0u, dst), dport,
                                   proto) & mask;;
       h = (h + 1) & mask) {
    const uint4 s = __ldg(slots + h);
    if ((int32_t)s.w < 0) return -1;
    if (s.x == dst && s.y == dport && s.z == proto) return (int32_t)s.w;
  }
}

// The v4 flow hash (u32 wrapping): src ip/port dominate, the dst side is
// the VIP; the same flow always takes the same slot.
__device__ __forceinline__ uint32_t lb_hash4(uint32_t src, uint32_t sport,
                                             uint32_t dst, uint32_t dport,
                                             uint32_t proto) {
  return (src * 0x9E3779B1u) ^ (sport * 0x85EBCA6Bu) ^ (dst * 0xC2B2AE35u) ^
         dport ^ proto;
}

__device__ __forceinline__ uint32_t lb_hash6(const uint32_t src[4],
                                             uint32_t sport, uint32_t dst3,
                                             uint32_t dport, uint32_t proto) {
  return (src[0] * 0x9E3779B1u) ^ (src[1] * 0x85EBCA6Bu) ^
         (src[2] * 0xC2B2AE35u) ^ (src[3] * 0x27D4EB2Fu) ^
         (sport * 0x165667B1u) ^ dst3 ^ dport ^ proto;
}

// The Maglev pick of matched frontend `svc` (-1: no frontend): the
// backend row, -1 when the frontend selects none.  The slot is the
// unsigned hash mod m.
__device__ __forceinline__ int32_t lb_pick(const int32_t* maglev, int32_t m,
                                           int32_t svc, uint32_t h) {
  if (svc < 0) return -1;
  return maglev[(size_t)svc * (size_t)m + h % (uint32_t)m];
}
