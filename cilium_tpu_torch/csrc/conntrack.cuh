// Conntrack device functions: keys, hash, fingerprint, probes.
//
// Replaces: cilium_tpu/datapath/conntrack.py ct_keys_from_headers,
// _hash, _fp_mix, _probe, _probe_fp, ct_lookup (:132-319).
// Bound: latency of random reads into a table larger than L2 (2^20 x
// 68 B rows = 68 MB, fingerprints 4 MB).  A probe reads the 64 B
// fingerprint window (two sectors), then a full 68 B row only for the
// few fingerprint matches.
// Design: one thread per key pair, everything in registers.  Both keys'
// windows load whole before any compare (aligned 16-byte loads where
// the window does not wrap), so the caller can issue its other gathers
// between ct_probe_begin and ct_lookup_finish, and the candidate rows of
// the two keys are fetched together (PR 14; before, each key's probe
// waited on one fingerprint word at a time).  The exact full-window
// fallback runs PER ROW, for rows whose fingerprint candidates
// overflowed; JAX's lax.cond reruns the whole batch instead.  The two
// agree row for row: a live slot's fingerprint is a function of its
// stored key, so for a row that did not overflow the filtered and the
// full probe find the same first live match.
#pragma once

#include "views.cuh"

constexpr int KEY_WORDS = 10;
constexpr int ROW_WORDS = 17;
constexpr int N_PROBE = 16;
constexpr int N_CAND = 4;
constexpr int N_CAND_INS = 4;
constexpr int N_ROUNDS = N_CAND_INS + N_PROBE;  // K4's insert rounds
constexpr int V_STATE = 10;
constexpr int V_EXPIRES = 11;
constexpr int V_TX_PKTS = 12;
constexpr int V_RX_PKTS = 13;
constexpr int V_TX_BYTES = 14;
constexpr int V_RX_BYTES = 15;
constexpr int V_PROXY = 16;

constexpr int32_t CT_NEW = 0;
constexpr int32_t CT_ESTABLISHED = 1;
constexpr int32_t CT_REPLY = 2;
constexpr int32_t CT_RELATED = 3;

constexpr uint32_t ST_FREE = 0;
constexpr uint32_t ST_SYN_SENT = 1;
constexpr uint32_t ST_ESTABLISHED = 2;
constexpr uint32_t ST_CLOSING = 3;

constexpr uint32_t LIFETIME_TCP = 21600;
constexpr uint32_t LIFETIME_NONTCP = 60;
constexpr uint32_t LIFETIME_SYN = 60;
constexpr uint32_t LIFETIME_CLOSE = 10;

constexpr uint32_t FLAG_RELATED = 0x100;
constexpr uint32_t TCP_FIN = 0x01;
constexpr uint32_t TCP_RST = 0x04;

// The CT slice batch row i works in.  Under sharded serving (P16a,
// cilium_tpu/parallel/mesh.py) the [C, ROW_WORDS] table is S private
// slices: shard s = i / block owns slots [s*C/S, (s+1)*C/S) and treats
// them as a table of its own (capacity C/S, its own probe mask), as each
// chip's CT shard does under the reference's shard_map.  *base is the
// slice's first global slot.  One shard: the whole table, base 0.
__device__ __forceinline__ CtView ct_shard(const CtView& ct,
                                           int32_t n_shards,
                                           int32_t block, int32_t i,
                                           int32_t* base) {
  CtView v = ct;
  *base = 0;
  if (n_shards > 1) {
    int32_t cs = ct.capacity / n_shards;
    int32_t s = i / block;
    *base = s * cs;
    v.table += (size_t)s * cs * ROW_WORDS;
    v.fp += (size_t)s * cs;
    v.capacity = cs;
  }
  return v;
}

// FNV-1a over the key words + murmur3 finalizer (u32 wrapping).
__device__ __forceinline__ uint32_t ct_hash(const uint32_t k[KEY_WORDS]) {
  uint32_t h = 0x811C9DC5u;
#pragma unroll
  for (int w = 0; w < KEY_WORDS; ++w) h = (h ^ k[w]) * 0x01000193u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// Key hash -> fingerprint byte in 1..255 (0 marks a free slot).
__device__ __forceinline__ uint32_t ct_fp_mix(uint32_t h) {
  uint32_t g = h ^ (h >> 16);
  g *= 0x85EBCA6Bu;
  g ^= g >> 13;
  g *= 0xC2B2AE35u;
  return (g >> 24) % 255u + 1u;
}

// Forward and reverse keys of one header (see ct_keys_from_headers):
// word 9 = proto | dir << 8; ICMP zeroes the ports; a RELATED row's
// reverse key keeps the embedded tuple and flips only the direction.
__device__ __forceinline__ void ct_keys(const uint32_t src[4],
                                        const uint32_t dst[4],
                                        uint32_t sport, uint32_t dport,
                                        uint32_t proto, uint32_t flags,
                                        uint32_t dirn,
                                        uint32_t fwd[KEY_WORDS],
                                        uint32_t rev[KEY_WORDS]) {
  bool portless = proto == 1 || proto == 58;
  uint32_t sp = portless ? 0u : sport, dp = portless ? 0u : dport;
  uint32_t fports = (sp << 16) | dp, rports = (dp << 16) | sp;
  uint32_t fpd = proto | (dirn << 8), rpd = proto | ((1u - dirn) << 8);
  bool related = (flags & FLAG_RELATED) != 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    fwd[w] = src[w];
    fwd[4 + w] = dst[w];
    rev[w] = related ? src[w] : dst[w];
    rev[4 + w] = related ? dst[w] : src[w];
  }
  fwd[8] = fports;
  fwd[9] = fpd;
  rev[8] = related ? fports : rports;
  rev[9] = rpd;
}

__device__ __forceinline__ bool ct_live_match(const uint32_t* row,
                                              const uint32_t k[KEY_WORDS],
                                              uint32_t now) {
  if (row[V_STATE] == ST_FREE || row[V_EXPIRES] < now) return false;
#pragma unroll
  for (int w = 0; w < KEY_WORDS; ++w)
    if (row[w] != k[w]) return false;
  return true;
}

// Exact probe: the first live match in the whole window.
__device__ __forceinline__ bool ct_probe_full(const CtView& ct,
                                              const uint32_t k[KEY_WORDS],
                                              uint32_t h, uint32_t now,
                                              int32_t* slot) {
  uint32_t mask = (uint32_t)ct.capacity - 1u;
  for (int step = 0; step < N_PROBE; ++step) {
    uint32_t s = (h + (uint32_t)step) & mask;
    if (ct_live_match(ct.table + (size_t)s * ROW_WORDS, k, now)) {
      *slot = (int32_t)s;
      return true;
    }
  }
  *slot = 0;
  return false;
}

// Bit j set where pred(fp[(start + j) & (capacity - 1)]) holds, for the
// 16 fingerprints of a window.  Every load issues before any compare:
// five aligned 16-byte loads where the window does not wrap at the
// capacity (and fp is 16-byte aligned), 16 scalar loads where it does.
// NC: through the read-only path (for kernels to which the CT is
// read-only); else from L2 (ct_update writes fingerprints later in its
// launch).
template <bool NC, typename Pred>
__device__ __forceinline__ uint32_t ct_fp_mask(const uint32_t* fp,
                                               uint32_t capacity,
                                               uint32_t start, Pred pred) {
  const uint32_t base = start & ~3u;
  if ((reinterpret_cast<uintptr_t>(fp) & 15u) == 0 &&
      base + 20u <= capacity) {
    const uint4* p = reinterpret_cast<const uint4*>(fp + base);
    uint4 v[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) v[q] = NC ? __ldg(p + q) : __ldcg(p + q);
    uint32_t m = 0;
#pragma unroll
    for (int q = 0; q < 5; ++q)
      m |= ((uint32_t)pred(v[q].x) | (uint32_t)pred(v[q].y) << 1 |
            (uint32_t)pred(v[q].z) << 2 | (uint32_t)pred(v[q].w) << 3)
           << (4 * q);
    return (m >> (start - base)) & 0xFFFFu;
  }
  uint32_t f[N_PROBE];
#pragma unroll
  for (int j = 0; j < N_PROBE; ++j) {
    const uint32_t* a = &fp[(start + (uint32_t)j) & (capacity - 1u)];
    f[j] = NC ? __ldg(a) : __ldcg(a);
  }
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < N_PROBE; ++j) m |= (uint32_t)pred(f[j]) << j;
  return m;
}

// One key's fingerprint-filtered probe in flight: its hash, the window
// positions whose fingerprint matched and are not tried yet, and how
// many matched in all.
struct CtProbe {
  uint32_t h;
  uint32_t m;
  int32_t n;
};

__device__ __forceinline__ CtProbe ct_probe_begin(
    const CtView& ct, const uint32_t k[KEY_WORDS]) {
  CtProbe p;
  p.h = ct_hash(k);
  const uint32_t kfp = ct_fp_mix(p.h);
  p.m = ct_fp_mask<true>(ct.fp, (uint32_t)ct.capacity,
                         p.h & ((uint32_t)ct.capacity - 1u),
                         [kfp](uint32_t f) { return f == kfp; });
  p.n = __popc(p.m);
  return p;
}

// the words a live match reads (key, state, expiry) of slot s's row
__device__ __forceinline__ void ct_row_head(const uint32_t* table, uint32_t s,
                                            uint32_t w[V_EXPIRES + 1]) {
  const uint32_t* row = table + (size_t)s * ROW_WORDS;
#pragma unroll
  for (int q = 0; q <= V_EXPIRES; ++q) w[q] = __ldg(&row[q]);
}

__device__ __forceinline__ bool ct_head_match(const uint32_t w[V_EXPIRES + 1],
                                              const uint32_t k[KEY_WORDS],
                                              uint32_t now) {
  bool ok = w[V_STATE] != ST_FREE && !(w[V_EXPIRES] < now);
#pragma unroll
  for (int q = 0; q < KEY_WORDS; ++q) ok &= w[q] == k[q];
  return ok;
}

// ct_lookup for one row from both keys' probes: full rows for the first
// N_CAND fingerprint matches of each key only, the two keys' candidate
// rows fetched together, in window order (the first live match wins).
// A key that misses with more than N_CAND matches could hide its entry
// past the candidate budget: then both keys rerun the exact probe.
__device__ __forceinline__ void ct_lookup_finish(
    const CtView& ct, CtProbe pf, CtProbe pr, const uint32_t fwd[KEY_WORDS],
    const uint32_t rev[KEY_WORDS], uint32_t now, int32_t* result,
    int32_t* slot, bool* is_reply) {
  const uint32_t mask = (uint32_t)ct.capacity - 1u;
  bool ff = false, rf = false;
  int32_t fs = 0, rs = 0;
#pragma unroll 1
  for (int c = 0; c < N_CAND && (pf.m | pr.m); ++c) {
    const uint32_t sf = (pf.h + (uint32_t)(__ffs(pf.m) - 1)) & mask;
    const uint32_t sr = (pr.h + (uint32_t)(__ffs(pr.m) - 1)) & mask;
    uint32_t wf[V_EXPIRES + 1], wr[V_EXPIRES + 1];
    if (pf.m) ct_row_head(ct.table, sf, wf);
    if (pr.m) ct_row_head(ct.table, sr, wr);
    if (pf.m) {
      if (ct_head_match(wf, fwd, now)) {
        ff = true;
        fs = (int32_t)sf;
        pf.m = 0;
      } else {
        pf.m &= pf.m - 1u;
      }
    }
    if (pr.m) {
      if (ct_head_match(wr, rev, now)) {
        rf = true;
        rs = (int32_t)sr;
        pr.m = 0;
      } else {
        pr.m &= pr.m - 1u;
      }
    }
  }
  if ((!ff && pf.n > N_CAND) || (!rf && pr.n > N_CAND)) {
    ff = ct_probe_full(ct, fwd, pf.h, now, &fs);
    rf = ct_probe_full(ct, rev, pr.h, now, &rs);
  }
  bool rep = !ff && rf;
  *slot = ff ? fs : rs;
  *result = ff ? CT_ESTABLISHED : (rep ? CT_REPLY : CT_NEW);
  *is_reply = rep;
}

// ct_lookup for one row: -> result (CT_*), slot, is_reply.
__device__ __forceinline__ void ct_lookup_row(const CtView& ct,
                                              const uint32_t fwd[KEY_WORDS],
                                              const uint32_t rev[KEY_WORDS],
                                              uint32_t now, int32_t* result,
                                              int32_t* slot,
                                              bool* is_reply) {
  ct_lookup_finish(ct, ct_probe_begin(ct, fwd), ct_probe_begin(ct, rev), fwd,
                   rev, now, result, slot, is_reply);
}
