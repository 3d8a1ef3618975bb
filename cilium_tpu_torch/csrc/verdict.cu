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
// Design: one thread per packet, the whole chain in registers as XLA
// fused it, so no intermediate touches device memory; many warps in
// flight hide the gather latency.  Every optional channel is a nullable
// pointer and audit a flag, so one build serves every caller.  Gathers
// clamp by the XLA rule (xla_index) and never read outside an array;
// the metrics scatter drops rows whose reason or direction falls
// outside the table, like XLA's mode="drop".  u32 atomicAdd commutes,
// so the counts are bit-exact whatever the order.
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

template <bool PACKED>
__global__ void __launch_bounds__(256)
    datapath_kernel(DatapathIO io, PolicyView pol, LpmView lpm, CtView ct) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;

  // P1: the row (packed: unpack in registers, ep/dir are stream scalars)
  uint32_t src[4], dst[4], sport, dport, proto, flags, len, fam, ep, dirn;
  if (PACKED) {
    uint4 w = *reinterpret_cast<const uint4*>(io.rows + (size_t)i * 4);
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
    const uint4* r = reinterpret_cast<const uint4*>(io.rows + (size_t)i * N_COLS);
    uint4 a = r[0], b = r[1], c = r[2], d = r[3];
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

  // P2: ipcache on the peer (src for ingress, dst for egress)
  const uint32_t* remote = dir_i == 0 ? src : dst;
  uint32_t rem[4] = {remote[0], remote[1], remote[2], remote[3]};
  int32_t id_row = lpm_lookup_row(lpm, rem, fam);

  // P3: conntrack
  uint32_t fwd[KEY_WORDS], rev[KEY_WORDS];
  ct_keys(src, dst, sport, dport, proto, flags, dirn, fwd, rev);
  int32_t ct_res, slot, base;
  bool is_reply;
  const CtView sct = ct_shard(ct, io.n_shards, io.block, i, &base);
  ct_lookup_row(sct, fwd, rev, io.now, &ct_res, &slot, &is_reply);
  bool related_hint = (flags & FLAG_RELATED) != 0;
  bool is_related = related_hint && ct_res != CT_NEW;

  // P4: policy gathers (XLA index rule on every one)
  int32_t pol_row_raw = __ldg(&pol.ep_policy[xla_index((int32_t)ep, pol.n_ep)]);
  bool no_ep = pol_row_raw < 0 || ep >= MAX_ENDPOINTS;
  int64_t prow = xla_index(pol_row_raw < 0 ? 0 : pol_row_raw, pol.n_pol);
  int32_t proto_idx =
      __ldg(&pol.proto_table[xla_index((int32_t)proto, pol.n_proto_table)]);
  int32_t gcls = __ldg(&pol.port_class[xla_index(proto_idx, pol.n_proto) *
                                           pol.n_port +
                                       xla_index((int32_t)dport, pol.n_port)]);
  int32_t cls = __ldg(&pol.class_map[prow * pol.n_cls + xla_index(gcls, pol.n_cls)]);
  int64_t idrow = xla_index(id_row, pol.n_rows);
  int32_t packed = __ldg(&pol.verdict[((prow * 2 + xla_index(dir_i, 2)) *
                                           pol.n_rows + idrow) * pol.n_local +
                                      xla_index(cls, pol.n_local)]);
  int32_t p_verdict = packed & 0xFF;
  int32_t p_proxy = (packed >> 8) & 0xFFFF;
  bool p_auth = ((packed >> 24) & 1) != 0;

  // the select chain (verdict.py datapath_step step 4, same order)
  bool is_new = ct_res == CT_NEW;
  int32_t ct_proxy = (int32_t)sct.table[(size_t)slot * ROW_WORDS + V_PROXY];
  bool allowed_new = p_verdict == VERDICT_ALLOW || p_verdict == VERDICT_REDIRECT;
  bool allowed = (!is_new || allowed_new) && !no_ep;
  uint32_t auth_exp = __ldg(&pol.auth[prow * pol.n_rows + idrow]);
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
  for (int w = 0; w < KEY_WORDS; ++w) io.fwd[(size_t)i * KEY_WORDS + w] = fwd[w];
  io.ct_result[i] = untouched ? CT_NEW : ct_res;
  io.slot[i] = slot;
  io.is_reply[i] = is_reply;
  io.do_create[i] = allowed && is_new && !related_hint;
  io.proxy[i] = (uint32_t)proxy;
  io.l4[(size_t)i * 3] = proto;
  io.l4[(size_t)i * 3 + 1] = flags;
  io.l4[(size_t)i * 3 + 2] = len;

  // metrics: scatter-add that drops out-of-range reason/direction
  int64_t d = dir_i < 0 ? (int64_t)dir_i + 2 : dir_i;
  if ((!io.valid || io.valid[i]) && reason < N_REASONS && d >= 0 && d < 2)
    atomicAdd(&io.metrics[reason * 2 + d], 1u);

  uint32_t event = !allowed ? EV_DROP : (is_new ? EV_VERDICT : EV_TRACE);
  uint32_t* o = io.out + (size_t)i * N_OUT;
  o[0] = (uint32_t)verdict;
  o[1] = (uint32_t)proxy;
  o[2] = (uint32_t)(is_related ? CT_RELATED : ct_res);
  o[3] = (uint32_t)id_row;
  o[4] = reason;
  o[5] = event;
}

extern "C" int datapath_launch(const DatapathIO* io, const PolicyView* pol,
                               const LpmView* lpm, const CtView* ct,
                               int packed, cudaStream_t stream) {
  if (io->n > 0) {
    int blocks = (io->n + 255) / 256;
    if (packed)
      datapath_kernel<true><<<blocks, 256, 0, stream>>>(*io, *pol, *lpm, *ct);
    else
      datapath_kernel<false><<<blocks, 256, 0, stream>>>(*io, *pol, *lpm, *ct);
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
