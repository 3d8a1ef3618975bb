// Service LB device functions: the frontend match over frontends staged
// in shared memory, the flow hashes and the Maglev pick.
//
// Replaces: the match and select of cilium_tpu/service/__init__.py
// lb_stage (:391) and lb6_stage (:435), which service/socklb.py _resolve
// (:172) repeats for the connect path.  K15 and K16 (lb.cu) and K17's
// resolve launch (socklb.cu) all call these, so the connect path selects
// exactly as lb_stage does: the same compare, the same lowest index.
//
// Two v4 matchers, one for each shape.  lb_match4, a thread a row over
// shared-memory tiles, serves K15's whole batches (2^16 rows fill every
// SM, and a tile staged once serves the block's 256 rows).
// lb_match4_warp, a warp a row, serves K17's connect path (a few hundred
// to CONNECT_CAP misses, which a thread a row would leave on a handful
// of SMs).  Built on the warp matcher, K15 took twice as long at 2^16
// rows x 4096 frontends (PERF.md, P12).
//
// The match is the reference's [N, S] compare: every row against every
// frontend, the LOWEST matching index winning (two service names may
// share a VIP:port).  A block stages the frontends into shared memory a
// tile at a time (every thread reads each entry, a broadcast), and stops
// once every thread of the block has its match.
#pragma once

#include "views.cuh"

constexpr int LB_TPB = 256;
constexpr int LB_TILE4 = 2048;  // v4 frontends a tile: 24 KB
constexpr int LB_TILE6 = 1024;  // v6 frontends a tile: 24 KB

struct LbTile4 {
  __align__(16) uint32_t ip[LB_TILE4];
  uint32_t port[LB_TILE4], proto[LB_TILE4];
};

struct LbTile6 {
  uint4 ip[LB_TILE6];
  uint32_t port[LB_TILE6], proto[LB_TILE6];
};

// The lowest v4 frontend matching (dst, dport, proto), -1 for none.
// Every thread of the block calls it (it synchronises); `active` false
// for a thread with no row.
__device__ __forceinline__ int32_t lb_match4(const LbView& t, LbTile4& tile,
                                             bool active, uint32_t dst,
                                             uint32_t dport, uint32_t proto) {
  int32_t found = -1;
  for (int base = 0; base < t.s; base += LB_TILE4) {
    int cnt = min(LB_TILE4, t.s - base);
    __syncthreads();  // the previous tile is consumed
    for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
      tile.ip[k] = t.svc_ip[base + k];
      tile.port[k] = t.svc_port[base + k];
      tile.proto[k] = t.svc_proto[base + k];
    }
    __syncthreads();
    if (active && found < 0) {
      // four addresses a 16-byte load; the port and protocol only where
      // an address matches
      for (int k = 0; k < cnt && found < 0; k += 4) {
        uint4 ip4 = *reinterpret_cast<const uint4*>(&tile.ip[k]);
        if (ip4.x != dst && ip4.y != dst && ip4.z != dst && ip4.w != dst)
          continue;
        for (int u = k; u < min(k + 4, cnt); ++u) {
          if (tile.ip[u] == dst && tile.port[u] == dport &&
              tile.proto[u] == proto) {
            found = base + u;
            break;
          }
        }
      }
    }
    if (!__syncthreads_or(active && found < 0)) break;
  }
  return found;
}

// The lowest v4 frontend matching one row, found by a whole warp (every
// lane passes the same row): lanes stride over the frontends in global
// memory (48 KB at 4096: L1- and L2-resident) and a ballot picks the
// lowest match.  For few rows (the connect path's misses).
__device__ __forceinline__ int32_t lb_match4_warp(const LbView& t,
                                                  uint32_t dst,
                                                  uint32_t dport,
                                                  uint32_t proto) {
  int lane = threadIdx.x & 31;
  for (int base = 0; base < t.s; base += 32) {
    int k = base + lane;
    bool hit = k < t.s && __ldg(t.svc_ip + k) == dst &&
               __ldg(t.svc_port + k) == dport &&
               __ldg(t.svc_proto + k) == proto;
    unsigned m = __ballot_sync(0xFFFFFFFFu, hit);
    if (m) return base + __ffs(m) - 1;
  }
  return -1;
}

// The same over v6 frontends (the 4-word destination).
__device__ __forceinline__ int32_t lb_match6(const Lb6View& t, LbTile6& tile,
                                             bool active, uint4 dst,
                                             uint32_t dport, uint32_t proto) {
  int32_t found = -1;
  for (int base = 0; base < t.s; base += LB_TILE6) {
    int cnt = min(LB_TILE6, t.s - base);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
      const uint32_t* w = t.svc_ip + (size_t)(base + k) * 4;
      tile.ip[k] = make_uint4(w[0], w[1], w[2], w[3]);
      tile.port[k] = t.svc_port[base + k];
      tile.proto[k] = t.svc_proto[base + k];
    }
    __syncthreads();
    if (active && found < 0) {
      for (int k = 0; k < cnt; ++k) {
        uint4 f = tile.ip[k];
        if (f.w == dst.w && f.z == dst.z && f.y == dst.y && f.x == dst.x &&
            tile.port[k] == dport && tile.proto[k] == proto) {
          found = base + k;
          break;
        }
      }
    }
    if (!__syncthreads_or(active && found < 0)) break;
  }
  return found;
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
