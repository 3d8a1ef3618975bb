// K1: datapath_kernel<PACKED>, the verdict stage of one batch.
//
// Replaces: cilium_tpu/core/packets.py unpack_hdr (:132,155, PACKED
// only), datapath/lpm.py lpm_lookup (:284), datapath/conntrack.py
// ct_keys_from_headers + ct_lookup (:132-319) and the datapath_step
// body in datapath/verdict.py (:220-369) up to the ct_update call; the
// jitted datapath_step / datapath_step_packed / serve_step(_packed)
// fused all of it into one XLA program.
// Bound: latency of dependent random gathers per packet: the LPM walk,
// the CT fingerprint window and candidate rows (68 MB table, larger
// than L2), then ep_policy -> proto_table -> port_class -> class_map ->
// verdict -> auth.  The bytes that must move are small (16 or 64 B in,
// 24 B of out row, ~70 B of ct_update inputs per packet).
// Design (redesigned in PR 14): one thread per packet, the chain in
// registers as XLA fused it, so no intermediate touches device memory.
// - Metrics: the lanes of a warp that share a [reason, direction] cell
//   add once (__match_any_sync), into a block histogram in shared
//   memory, and each block adds each nonzero cell to the [13, 2] table
//   once.  Before, every row did a global atomicAdd onto one of 26 words
//   (nearly all onto one: the slice's traffic is FORWARDED ingress),
//   which the L2 serialized: 0.17 of the packed kernel's 0.24 ms at
//   2^18 rows (PERF.md, PR 14).  u32 adds commute, so the counts are
//   bit-exact whatever the order; rows whose reason or direction falls
//   outside the table are dropped, like XLA's mode="drop".
// - The chain: the loads that do not wait on each other issue first
//   (the row, LPM's first level, ep_policy, proto_table, both keys' CT
//   fingerprint windows), the CT candidate rows of both keys together
//   (conntrack.cuh ct_probe_begin / ct_lookup_finish), then the rest.
//   Read-only tables go through __ldg.
// - Stores: the block stages its out, fwd and l4 rows ([n, 6], [n, 10],
//   [n, 3], 24, 40 and 12 B a row) in shared memory and writes them as
//   contiguous 16-byte vectors; a row's scalar stores at those strides
//   touched every sector of the warp's span once a word.
// - Occupancy: ptxas gives the packed kernel 64 registers and the wide
//   one 80, no spills: 4 and 3 blocks of 256 an SM.  Held to 8 or 6 (32
//   or 40 registers) they spilled and ran 1.3-2x slower on the H100
//   (PERF.md, PR 14), so the bounds ask for no minimum.
// Every optional channel is a nullable pointer and audit a flag, so one
// build serves every caller.  Gathers clamp by the XLA rule (xla_index)
// and never read outside an array.
//
// Sharded serving (P16a: cilium_tpu/parallel/mesh.py:259, 336, the
// shard_map of datapath_step over S flow-routed blocks) is the same
// launch with n_shards > 1: row i probes the CT slice of shard i / block
// (conntrack.cuh ct_shard), and the slot it hands ct_update is local to
// that slice.  The metrics stay one global [13, 2] table: the reference
// psums the per-shard deltas, and u32 atomicAdd gives that sum.
#include "conntrack.cuh"
#include "lpm.cuh"

constexpr int N_COLS = 16;
constexpr int N_OUT = 6;
constexpr uint32_t MAX_ENDPOINTS = 4096;
constexpr uint32_t N_REASONS = 13;

constexpr int32_t VERDICT_ALLOW = 1;
constexpr int32_t VERDICT_DENY = 2;
constexpr int32_t VERDICT_REDIRECT = 3;

constexpr uint32_t REASON_FORWARDED = 0;
constexpr uint32_t REASON_POLICY_DENY = 1;
constexpr uint32_t REASON_POLICY_DEFAULT_DENY = 2;
constexpr uint32_t REASON_NO_ENDPOINT = 4;
constexpr uint32_t REASON_NAT_EXHAUSTED = 5;
constexpr uint32_t REASON_NO_SERVICE = 7;
constexpr uint32_t REASON_AUTH_REQUIRED = 8;

constexpr uint32_t EV_TRACE = 0;
constexpr uint32_t EV_VERDICT = 1;
constexpr uint32_t EV_DROP = 2;

constexpr int TPB = 256;
constexpr int N_CELLS = (int)N_REASONS * 2;

// One packet through the verdict stage.  Its out, fwd and l4 words go
// to the block's staging rows (o, f, l); the other hand-off words to
// device memory.  -> its metrics cell, or -1 where the row is not
// counted.
template <bool PACKED>
__device__ __forceinline__ int32_t verdict_row(const DatapathIO& io,
                                               const PolicyView& pol,
                                               const LpmView& lpm,
                                               const CtView& ct, int32_t i,
                                               uint32_t* o, uint32_t* f,
                                               uint32_t* l) {
  // P1: the row (packed: unpack in registers, ep/dir are stream scalars)
  uint32_t src[4], dst[4], sport, dport, proto, flags, len, fam, ep, dirn;
  if (PACKED) {
    uint4 w = __ldg(reinterpret_cast<const uint4*>(io.rows) + i);
    src[0] = src[1] = src[2] = 0;
    dst[0] = dst[1] = dst[2] = 0;
    src[3] = w.x;
    dst[3] = w.y;
    sport = w.z >> 16;
    dport = w.z & 0xFFFF;
    proto = w.w >> 24;
    flags = ((w.w >> 16) & 0xFF) | (((w.w >> 15) & 1) << 8);
    len = w.w & 0x7FFF;
    fam = 4;
    ep = io.ep;
    dirn = io.dirn;
  } else {
    const uint4* r = reinterpret_cast<const uint4*>(io.rows) + (size_t)i * 4;
    uint4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2), d = __ldg(r + 3);
    src[0] = a.x; src[1] = a.y; src[2] = a.z; src[3] = a.w;
    dst[0] = b.x; dst[1] = b.y; dst[2] = b.z; dst[3] = b.w;
    sport = c.x;
    dport = c.y;
    proto = c.z;
    flags = c.w;
    len = d.x;
    fam = d.y;
    ep = d.z;
    dirn = d.w;
  }
  int32_t dir_i = (int32_t)dirn;

  // the gathers that wait on nothing but the row issue first: LPM's
  // first level on the peer (src for ingress, dst for egress), the
  // endpoint's policy row, the protocol's index, both CT windows
  uint32_t rem[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) rem[w] = dir_i == 0 ? src[w] : dst[w];
  const bool v4 = fam == 4;
  const int32_t l1 = v4 ? __ldg(&lpm.l1[rem[3] >> 16]) : 0;
  const int32_t pol_row_raw =
      __ldg(&pol.ep_policy[xla_index((int32_t)ep, pol.n_ep)]);
  const int32_t proto_idx =
      __ldg(&pol.proto_table[xla_index((int32_t)proto, pol.n_proto_table)]);
  uint32_t fwd[KEY_WORDS], rev[KEY_WORDS];
  ct_keys(src, dst, sport, dport, proto, flags, dirn, fwd, rev);
  int32_t base;
  const CtView sct = ct_shard(ct, io.n_shards, io.block, i, &base);
  const CtProbe pf = ct_probe_begin(sct, fwd), pr = ct_probe_begin(sct, rev);

  // then what waits on those: the port class, LPM's second level, the
  // CT candidate rows (P3), LPM's third level and the class (P2, P4;
  // the XLA index rule on every gather)
  const bool no_ep = pol_row_raw < 0 || ep >= MAX_ENDPOINTS;
  const int64_t prow = xla_index(pol_row_raw < 0 ? 0 : pol_row_raw, pol.n_pol);
  const int32_t gcls =
      __ldg(&pol.port_class[xla_index(proto_idx, pol.n_proto) * pol.n_port +
                            xla_index((int32_t)dport, pol.n_port)]);
  const int32_t l2 =
      v4 ? lpm_v4_step(lpm.l2, lpm.n_l2, l1, (rem[3] >> 8) & 0xFF) : 0;
  int32_t ct_res, slot;
  bool is_reply;
  ct_lookup_finish(sct, pf, pr, fwd, rev, io.now, &ct_res, &slot, &is_reply);
  const int32_t cls =
      __ldg(&pol.class_map[prow * pol.n_cls + xla_index(gcls, pol.n_cls)]);
  const int32_t id_row =
      v4 ? lpm_v4_step(lpm.l3, lpm.n_l3, l2, rem[3] & 0xFF)
         : lpm_v6(lpm, reinterpret_cast<const uint4*>(lpm.v6_groups), rem);
  const bool related_hint = (flags & FLAG_RELATED) != 0;
  const bool is_related = related_hint && ct_res != CT_NEW;

  const int64_t idrow = xla_index(id_row, pol.n_rows);
  const int32_t packed = __ldg(&pol.verdict[((prow * 2 + xla_index(dir_i, 2)) *
                                                 pol.n_rows + idrow) *
                                                pol.n_local +
                                            xla_index(cls, pol.n_local)]);
  const uint32_t auth_exp = __ldg(&pol.auth[prow * pol.n_rows + idrow]);
  const int32_t ct_proxy =
      (int32_t)__ldg(&sct.table[(size_t)slot * ROW_WORDS + V_PROXY]);
  int32_t p_verdict = packed & 0xFF;
  int32_t p_proxy = (packed >> 8) & 0xFFFF;
  bool p_auth = ((packed >> 24) & 1) != 0;

  // the select chain (verdict.py datapath_step step 4, same order)
  bool is_new = ct_res == CT_NEW;
  bool allowed_new = p_verdict == VERDICT_ALLOW || p_verdict == VERDICT_REDIRECT;
  bool allowed = (!is_new || allowed_new) && !no_ep;
  bool auth_drop = allowed && is_new && p_auth && auth_exp <= io.now;
  allowed = allowed && !auth_drop;
  bool audit_fwd = false;
  if (io.audit) {
    audit_fwd = is_new && !allowed && !no_ep;
    allowed = allowed || audit_fwd;
  }
  bool nat_drop = false;
  if (io.pre_drop) {
    nat_drop = io.pre_drop[i] && allowed;
    allowed = allowed && !nat_drop;
  }
  bool stage_drop = false;
  uint32_t stage_reason = 0;
  if (io.pre_drop_reason) {
    stage_reason = io.pre_drop_reason[i];
    stage_drop = stage_reason != 0 && allowed;
    allowed = allowed && !stage_drop;
  }
  int32_t proxy = is_new ? (p_verdict == VERDICT_REDIRECT ? p_proxy : 0) : ct_proxy;
  if (is_related) proxy = 0;
  int32_t verdict = allowed ? (proxy > 0 ? VERDICT_REDIRECT : VERDICT_ALLOW)
                            : (no_ep ? VERDICT_DENY : p_verdict);
  bool reason_allowed = io.audit ? (allowed && !audit_fwd) : allowed;
  uint32_t reason = reason_allowed ? REASON_FORWARDED
                    : no_ep        ? REASON_NO_ENDPOINT
                    : p_verdict == VERDICT_DENY ? REASON_POLICY_DENY
                                                : REASON_POLICY_DEFAULT_DENY;
  if (auth_drop) {
    verdict = VERDICT_DENY;
    reason = REASON_AUTH_REQUIRED;
    proxy = 0;
  }
  if (audit_fwd && allowed) verdict = VERDICT_ALLOW;
  if (nat_drop) {
    verdict = VERDICT_DENY;
    reason = REASON_NAT_EXHAUSTED;
    proxy = 0;
  }
  if (stage_drop) {
    verdict = VERDICT_DENY;
    reason = stage_reason;
    proxy = 0;
  }
  bool lb = io.lb_drop && io.lb_drop[i];
  if (lb) {
    allowed = false;
    verdict = VERDICT_DENY;
    reason = REASON_NO_SERVICE;
    proxy = 0;
  }

  // what ct_update needs (related rows neither create nor refresh;
  // no_ep and pre-dropped rows touch nothing)
  bool untouched = is_related || no_ep || nat_drop || stage_drop || lb;
#pragma unroll
  for (int w = 0; w < KEY_WORDS; ++w) f[w] = fwd[w];
  io.ct_result[i] = untouched ? CT_NEW : ct_res;
  io.slot[i] = slot;
  io.is_reply[i] = is_reply;
  io.do_create[i] = allowed && is_new && !related_hint;
  io.proxy[i] = (uint32_t)proxy;
  l[0] = proto;
  l[1] = flags;
  l[2] = len;

  uint32_t event = !allowed ? EV_DROP : (is_new ? EV_VERDICT : EV_TRACE);
  o[0] = (uint32_t)verdict;
  o[1] = (uint32_t)proxy;
  o[2] = (uint32_t)(is_related ? CT_RELATED : ct_res);
  o[3] = (uint32_t)id_row;
  o[4] = reason;
  o[5] = event;

  // metrics: scatter-add that drops out-of-range reason/direction
  int64_t d = dir_i < 0 ? (int64_t)dir_i + 2 : dir_i;
  bool counted = (!io.valid || io.valid[i]) && reason < N_REASONS && d >= 0 &&
                 d < 2;
  return counted ? (int32_t)(reason * 2 + d) : -1;
}

// `words` staged words to dst, 16 bytes a store where whole (dst and
// src 16-byte aligned).
__device__ __forceinline__ void store_staged(uint32_t* dst,
                                             const uint32_t* src,
                                             int32_t words) {
  const int32_t vecs = words >> 2;
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int32_t v = threadIdx.x; v < vecs; v += TPB) d[v] = s[v];
  for (int32_t w = (vecs << 2) + threadIdx.x; w < words; w += TPB)
    dst[w] = src[w];
}

template <bool PACKED>
__global__ void __launch_bounds__(TPB)
    datapath_kernel(DatapathIO io, PolicyView pol, LpmView lpm, CtView ct) {
  __shared__ uint32_t hist[N_CELLS];
  __shared__ __align__(16) uint32_t s_out[TPB * N_OUT];
  __shared__ __align__(16) uint32_t s_fwd[TPB * KEY_WORDS];
  __shared__ __align__(16) uint32_t s_l4[TPB * 3];
  if (threadIdx.x < N_CELLS) hist[threadIdx.x] = 0u;
  const int32_t first = blockIdx.x * TPB, i = first + threadIdx.x;
  int32_t cell = -1;
  if (i < io.n) {
    cell = verdict_row<PACKED>(io, pol, lpm, ct, i,
                               s_out + threadIdx.x * N_OUT,
                               s_fwd + threadIdx.x * KEY_WORDS,
                               s_l4 + threadIdx.x * 3);
  }
  // metrics: a warp's lanes that share a cell add once, the block once
  // a cell
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, cell);
  __syncthreads();
  if (cell >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[cell], (uint32_t)__popc(peers));
  __syncthreads();
  if (threadIdx.x < N_CELLS && hist[threadIdx.x])
    atomicAdd(&io.metrics[threadIdx.x], hist[threadIdx.x]);
  const int32_t rows = io.n - first < TPB ? io.n - first : TPB;
  store_staged(io.out + (size_t)first * N_OUT, s_out, rows * N_OUT);
  store_staged(io.fwd + (size_t)first * KEY_WORDS, s_fwd, rows * KEY_WORDS);
  store_staged(io.l4 + (size_t)first * 3, s_l4, rows * 3);
}

extern "C" int datapath_launch(const DatapathIO* io, const PolicyView* pol,
                               const LpmView* lpm, const CtView* ct,
                               int packed, cudaStream_t stream) {
  if (io->n > 0) {
    int blocks = (io->n + TPB - 1) / TPB;
    if (packed)
      datapath_kernel<true><<<blocks, TPB, 0, stream>>>(*io, *pol, *lpm, *ct);
    else
      datapath_kernel<false><<<blocks, TPB, 0, stream>>>(*io, *pol, *lpm, *ct);
  }
  return (int)cudaGetLastError();
}

extern "C" size_t verdict_abi_size(int which) {
  switch (which) {
    case 0: return sizeof(LpmView);
    case 1: return sizeof(PolicyView);
    case 2: return sizeof(CtView);
    case 3: return sizeof(DatapathIO);
    default: return 0;
  }
}
