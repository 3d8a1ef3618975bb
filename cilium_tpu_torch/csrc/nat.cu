// K11 snat_egress, K12 snat_reverse and K14 masq_rewrite: egress NAT.
//
// K11 replaces cilium_tpu/service/nat.py snat_egress (:225), the jitted
// snat_egress_jit; K12 snat_reverse (:356), snat_reverse_jit; K14 the
// stateless rewrite of cilium_tpu/datapath/verdict.py apply_masquerade
// (:374, with its reverse-CT probe) and service/nat.py snat_stage (:410,
// without).  The plain versions are cilium_tpu_torch/service/nat.py
// snat_egress_plain, snat_reverse_plain and masq_rewrite_plain.
//
// Bound: K11 by the latency of dependent random reads: the reverse-CT
// probe of the 68 MB CT table, then the 8-slot window of the NAT table
// (24 B rows, 384 KB at 2^14 slots: it lives in L2), and by the grid
// barriers between its phases (~1.1-1.4 us each on the H100).  K12 and
// K14 by one row read and one row written per packet (64 B each), plus
// K12's slot (24 B) and grid barrier; K14 by its bytes: the rows' 129 B
// (the mask byte with them), a candidate's 64 B fingerprint window and
// a found key's 40 B (0.0035 ms at 2^16 rows of which 4096 find their
// entry; without the probe the rows alone, 0.0025 ms).
//
// K11 design (PR 18; PRs 7-17 launched 20 kernels and a fill a call).
// The reference awards a contended slot, step by step, to the LOWEST
// batch row and lets a same-tuple loser adopt the winner's slot when it
// reads the slot back.  ONE cooperative kernel a call (every co-resident
// block of TPB threads, at most NAT_BLOCKS_PER_SM an SM, striding over
// the rows); grid barriers stand where a row reads what another wrote:
//   0. prep, a thread a row: the class (egress, v4, internal, portful),
//      the first matching egress-gateway rule, the reverse-CT probe (the
//      fingerprint window and its candidates, as K1 probes), the FNV
//      hash of (src, sport, dst, dport << 8 | proto) and the whole 8-slot
//      window, loaded before any compare, for a live same-tuple mapping,
//      whose stored IP (0 read as node_ip) it keeps.  A row with no slot
//      to claim is written out here;
//   1. after the barrier (every window scanned), matched rows write
//      their refreshed row (rows of one flow write the same six words:
//      the key pins the protocol, < 256 for a port-bearing row, so the
//      expiry agrees; the IP is the stored one); pending rows are listed
//      (one atomicAdd a block);
//   2. after the next (the bids read the refreshed expiries), each
//      pending row checks its window for a claimable slot (expired, or
//      holding its tuple) and bids (atomicMin of its row index) for step
//      0's;
//   3. after the next, when no pending row's window holds a claimable
//      slot, nothing can be written at any step: every pending row
//      fails and no step runs (a pool run dry).  Else the claim steps,
//      ONE grid barrier a step: after the barrier each bidder reads its
//      slot's claim word: the lowest bidder writes its row, and it and
//      every same-tuple bidder (whose key equals the winner's) have the
//      slot's node port and are written out.  The rest bid for the next
//      step in the same phase, judging a slot bid on in this step by its
//      winner's key and expiry (the winner writes it in this very
//      phase), any other by the table; a step's words are cleared two
//      phases later (three arrays in turn).  Each step's loads go out in
//      two rounds before its stores.  Rows still pending after the last
//      step are written out dropped and added to `failed` once a block;
//      so is, at step 1, a row that did not bid and whose window holds no
//      claimable slot past its next (snat_dead: where no expiry can wrap
//      past 2^32 in the call, it can never bid again; a pool that step 0
//      filled then ends its steps there).
//      The steps stop when no row is pending; once at most
//      NAT_TAIL_ROWS * TPB rows are, block 0 finishes them alone
//      (snat_tail: rows in registers, __syncthreads for the grid
//      barriers).
// The claim words live with the table (NATTable.claim, [3, P]) and are
// CLAIM_FREE between calls: a call clears every word it bids on.  The counters and phase stamps (views.cuh
// Stamps) sit in `counts`, set inside the launch.
//
// K12 design.  A reply hits slot dport - NAT_PORT_MIN when it is
// ingress, v4, in the pool, to the IP the mapping rewrote to, and the
// slot is live and holds the reply tuple.  Two replies of different
// protocol words can hit one slot (a forged protocol >= 256 aliases the
// low byte the slot stores) and their refreshed expiries then differ;
// the reference's scatter keeps the highest row's.  No block can tell
// whether another block's row hits its slot, so ONE cooperative kernel
// a call (at most REV_BLOCKS_PER_SM blocks of REV_TPB an SM) takes one
// grid barrier:
//   1. each thread takes its rows one after another (a row base + r *
//      grid threads, so a warp's loads stay neighbours): the row, 16
//      bytes a load, then its slot if it is in the pool, then the out
//      row; a hit keeps its slot and the expiry its refresh writes (now
//      + the lifetime of its protocol word) in registers (its first
//      REV_ROWS rows) and bids n - 1 - row into the slot's claim word
//      (atomicMin: the lowest bid is the highest row).  A hit whose next
//      row (the next lane) hits the same slot leaves the bid to it:
//      2^16 replies to one slot bid once a warp;
//   2. after the barrier, a hit whose bid stands in the claim word
//      writes its expiry and frees the word.  Only a hit bids n - 1 -
//      row, so rows past a thread's REV_ROWS (a batch larger than the
//      co-resident grid holds) read their port and protocol words
//      again and test the claim word alone.
// The claim words are the first row of the table's (free between
// calls): no fill, one graph node a call.
//
// K14 design.  A thread a row (MASQ_ROWS) in blocks of MASQ_TPB, at most
// MASQ_BLOCKS_PER_SM blocks an SM striding over the rows (at 2^16 rows a
// thread takes two in turn, which measured faster than a thread a row
// where most rows find their entry), no barrier and no memset: one
// graph node a call.  The row comes in four 16-byte loads (sixteen word loads where
// the rows sit off a 16-byte boundary).  The non-masquerade networks,
// a few words every thread of a warp reads at the same address, come
// through L1 (read-only loads; staging them in shared memory behind a
// block barrier measured slower).  A candidate (egress, v4, toward no
// such network) builds its reverse key and loads its fingerprint window
// whole (ct_probe_begin), then reads row heads only for the fingerprint
// matches, as K11 does (reverse_ct_found_fp: the whole window past
// N_CAND matches).  A miss in a sparse table thus costs one window load,
// not a chain of 16 dependent row reads.  Word 3 is rewritten in
// registers; the row goes out in four 16-byte stores, with its mask
// byte.
//
// All compares of expiries and ports are unsigned, as on the reference.
#include <cooperative_groups.h>

#include "conntrack.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int N_COLS = 16;
constexpr int TPB = 256;
// K11: at most this many blocks of TPB an SM (PERF.md, PR 18), and the
// rows a thread of its one-block tail
constexpr int NAT_BLOCKS_PER_SM = 1;
constexpr int NAT_TAIL_ROWS = 2;
// K12: its block, at most this many blocks an SM, and the hits a thread
// keeps in registers across its grid barrier (2^16 rows: 132 blocks of
// 256, at most 2 rows a thread)
constexpr int REV_TPB = 256;
constexpr int REV_BLOCKS_PER_SM = 1;
constexpr int REV_ROWS = 2;
constexpr int NAT_RULES = 256;  // gateway rules a block stages: 4 KB
constexpr int NAT_ROW = 6;
constexpr int NAT_PROBE = 8;
constexpr uint32_t NAT_PORT_MIN = 32768u;
constexpr uint32_t NAT_LIFETIME_TCP = 21600u;
constexpr uint32_t NAT_LIFETIME_NONTCP = 180u;
constexpr int NV_SRC = 0;
constexpr int NV_SPORT = 1;
constexpr int NV_DST = 2;
constexpr int NV_DP = 3;
constexpr int NV_EXPIRES = 4;
constexpr int NV_SNAT_IP = 5;
constexpr int32_t CLAIM_FREE = 0x7FFFFFFF;

// K11's per-row flags (aux word 3)
constexpr uint32_t F_MASQ = 1u;
constexpr uint32_t F_NEED = 2u;
constexpr uint32_t F_MATCH = 4u;
constexpr uint32_t F_PENDING = 8u;
constexpr uint32_t F_TRYING = 16u;

struct Hdr {
  uint32_t src[4], dst[4], sport, dport, proto, flags, fam, dirn;
};

__device__ __forceinline__ Hdr load_hdr(const uint32_t* rows, int32_t i) {
  const uint4* r = reinterpret_cast<const uint4*>(rows + (size_t)i * N_COLS);
  uint4 a = r[0], b = r[1], c = r[2], d = r[3];
  Hdr h;
  h.src[0] = a.x; h.src[1] = a.y; h.src[2] = a.z; h.src[3] = a.w;
  h.dst[0] = b.x; h.dst[1] = b.y; h.dst[2] = b.z; h.dst[3] = b.w;
  h.sport = c.x;
  h.dport = c.y;
  h.proto = c.z;
  h.flags = c.w;
  h.fam = d.y;
  h.dirn = d.w;
  return h;
}

// The row copied to `out` with the source IP and port (words 3 and 8)
// or the destination IP and port (words 7 and 9) replaced.
__device__ __forceinline__ void store_row(const uint32_t* rows, uint32_t* out,
                                          int32_t i, int ip_col, uint32_t ip,
                                          uint32_t port) {
  const uint4* r = reinterpret_cast<const uint4*>(rows + (size_t)i * N_COLS);
  uint4* o = reinterpret_cast<uint4*>(out + (size_t)i * N_COLS);
  uint4 a = r[0], b = r[1], c = r[2], d = r[3];
  if (ip_col == 3) {
    a.w = ip;
    c.x = port;
  } else {
    b.w = ip;
    c.y = port;
  }
  o[0] = a;
  o[1] = b;
  o[2] = c;
  o[3] = d;
}

__device__ __forceinline__ bool in_nets(const NatView& t, uint32_t a) {
  for (int k = 0; k < t.k; ++k)
    if ((a & t.mask[k]) == t.net[k]) return true;
  return false;
}

// A live CT entry for the row's reply key `rev` (the row answers a
// connection a remote opened into the node), probed as K1 probes
// (conntrack.cuh), from its fingerprint window (`p`, ct_probe_begin):
// full rows for the first N_CAND fingerprint matches, the whole window
// when more matched.
// A live slot's fingerprint is a function of its stored key, so this
// finds what ct_probe_full finds, through one or two dependent reads
// instead of up to 16.
__device__ __forceinline__ bool reverse_ct_found_fp(const CtView& ct,
                                                    const uint32_t* rev,
                                                    CtProbe p, uint32_t now) {
  const uint32_t mask = (uint32_t)ct.capacity - 1u;
  for (int c = 0; c < N_CAND && p.m; ++c) {
    uint32_t w[V_EXPIRES + 1];
    ct_row_head(ct.table, (p.h + (uint32_t)(__ffs(p.m) - 1)) & mask, w);
    if (ct_head_match(w, rev, now)) return true;
    p.m &= p.m - 1u;
  }
  int32_t slot;
  return p.n > N_CAND && ct_probe_full(ct, rev, p.h, now, &slot);
}

// FNV-1a over the four key words (service/nat.py _nat_hash).
__device__ __forceinline__ uint32_t nat_hash(uint4 k) {
  uint32_t h = 0x811C9DC5u;
  h = (h ^ k.x) * 0x01000193u;
  h = (h ^ k.y) * 0x01000193u;
  h = (h ^ k.z) * 0x01000193u;
  return (h ^ k.w) * 0x01000193u;
}

// A NAT row's six words, three 8-byte loads through L2 (K11's blocks
// write the table within the launch; the table is 8-byte aligned).
struct NatRow {
  uint4 k;  // src, sport, dst, dport << 8 | proto
  uint32_t expires, snat_ip;
};

__device__ __forceinline__ NatRow load_nat_row(const uint32_t* row) {
  const uint2* r = reinterpret_cast<const uint2*>(row);
  const uint2 a = __ldcg(r), b = __ldcg(r + 1), c = __ldcg(r + 2);
  return {make_uint4(a.x, a.y, b.x, b.y), c.x, c.y};
}

__device__ __forceinline__ bool keys_equal(uint4 a, uint4 b) {
  return a.x == b.x && a.y == b.y && a.z == b.z && a.w == b.w;
}

__device__ __forceinline__ void write_row(uint32_t* row, uint4 k, uint4 aux) {
  row[NV_SRC] = k.x;
  row[NV_SPORT] = k.y;
  row[NV_DST] = k.z;
  row[NV_DP] = k.w;
  row[NV_EXPIRES] = aux.z;
  row[NV_SNAT_IP] = aux.y;
}

__device__ __forceinline__ uint32_t nat_lifetime(uint32_t proto) {
  return proto == 6 ? NAT_LIFETIME_TCP : NAT_LIFETIME_NONTCP;
}

// --- K11 ---------------------------------------------------------------

// K11's counters (SnatIO.counts): the rows pending entering step s, then
// those still pending after the last (they fail); 1 + the step the
// one-block tail began at (0: none); then the phase stamps (views.cuh),
// then a word a block (whether one of its pending rows has a claimable
// slot in its window).
constexpr int C_TAIL = NAT_PROBE + 1;
constexpr int C_WORDS = STAMP_AT + STAMPS;
constexpr int NAT_MAX_BLOCKS = 1024;  // block words in `counts`

// Row i's out row: the source IP rewritten to the rule's or mapping's IP
// when masqueraded, the source port to the slot's node port when
// allocated; its drop bit.
__device__ __forceinline__ void snat_out(const SnatIO& io, int32_t i, uint4 k,
                                         uint4 aux, bool allocated,
                                         int32_t slot, bool dropped) {
  store_row(io.rows, io.out, i, 3, (aux.w & F_MASQ) ? aux.y : k.x,
            allocated ? NAT_PORT_MIN + (uint32_t)slot : k.y);
  io.drop[i] = dropped;
}

// The first gateway rule of `rules` (n staged ones, then the rest of
// t's) whose source is `src` and whose network holds `dst`: its egress
// IP in *ip.  Four rules a step, none skipped: the first match stands.
__device__ __forceinline__ bool gateway_rule(const NatView& t,
                                             const uint4* rules, int n,
                                             uint32_t src, uint32_t dst,
                                             uint32_t* ip) {
  int g = 0;
  for (; g + 4 <= n; g += 4) {
    int hit = -1;
#pragma unroll
    for (int u = 3; u >= 0; --u) {
      const uint4 r = rules[g + u];
      if (src == r.x && (dst & r.z) == r.y) hit = u;
    }
    if (hit >= 0) {
      *ip = rules[g + hit].w;
      return true;
    }
  }
  for (; g < n; ++g) {
    const uint4 r = rules[g];
    if (src == r.x && (dst & r.z) == r.y) {
      *ip = r.w;
      return true;
    }
  }
  for (g = n; g < t.g; ++g) {
    if (src == __ldg(&t.egw_src[g]) &&
        (dst & __ldg(&t.egw_mask[g])) == __ldg(&t.egw_net[g])) {
      *ip = __ldg(&t.egw_ip[g]);
      return true;
    }
  }
  return false;
}

// Phase 0 for row i: the class, the first matching egress-gateway rule,
// the reverse-CT probe, the hash and the whole-window scan for a live
// same-tuple mapping, whose stored IP (0 read as node_ip) it keeps.  The
// probe's fingerprint window is loaded before the rule scan, for every
// egress v4 row (a read, so reading it for an internal row changes
// nothing).  A row with no slot to claim is written out now; a row that
// refreshes or claims keeps its key, (hash, rewrite IP, expiry, flags)
// and slot.
__device__ void snat_prep_row(const SnatIO& io, const NatView& t,
                              const CtView& ct, const uint4* rules,
                              int n_rules, int32_t i) {
  Hdr h = load_hdr(io.rows, i);
  uint32_t src = h.src[3], dst = h.dst[3];
  const bool out4 = h.dirn == 1 && h.fam == 4;
  uint32_t fwd[KEY_WORDS], rev[KEY_WORDS];
  CtProbe p{0u, 0u, 0};
  if (out4) {
    ct_keys(h.src, h.dst, h.sport, h.dport, h.proto, h.flags, h.dirn, fwd,
            rev);
    p = ct_probe_begin(ct, rev);
  }
  uint32_t rip = t.node_ip;
  const bool gw = gateway_rule(t, rules, n_rules, src, dst, &rip);
  bool masq = out4 && (gw || !in_nets(t, dst)) &&
              !reverse_ct_found_fp(ct, rev, p, io.now);
  bool need = masq && (h.proto == 6 || h.proto == 17 || h.proto == 132);
  uint4 k = make_uint4(src, h.sport, dst, (h.dport << 8) | h.proto);
  uint32_t hash = nat_hash(k);
  uint32_t pmask = (uint32_t)io.capacity - 1u;
  bool match = false;
  int32_t mslot = 0;
  if (need) {
    // the window's first two slots (a repeated flow's mapping sits in
    // its home slot as a rule), the other six together where neither
    // holds it: the first live same-tuple slot in window order stands
    auto live_same = [&](const NatRow& r) {
      return r.expires >= io.now && keys_equal(r.k, k);
    };
    NatRow w[NAT_PROBE];
#pragma unroll
    for (int step = 0; step < 2; ++step)
      w[step] = load_nat_row(io.table +
                             (size_t)((hash + (uint32_t)step) & pmask) *
                                 NAT_ROW);
    const bool early = live_same(w[0]) || live_same(w[1]);
    if (!early) {
#pragma unroll
      for (int step = 2; step < NAT_PROBE; ++step)
        w[step] = load_nat_row(io.table +
                               (size_t)((hash + (uint32_t)step) & pmask) *
                                   NAT_ROW);
    }
#pragma unroll
    for (int step = NAT_PROBE - 1; step >= 0; --step) {
      if (!(step < 2 || !early) || !live_same(w[step])) continue;
      match = true;
      mslot = (int32_t)((hash + (uint32_t)step) & pmask);
      // a live mapping keeps the IP it was made with (0: node_ip)
      rip = w[step].snat_ip != 0 ? w[step].snat_ip : t.node_ip;
    }
  }
  uint32_t flags = (masq ? F_MASQ : 0u) | (need ? F_NEED : 0u) |
                   (match ? F_MATCH : 0u) | (need && !match ? F_PENDING : 0u);
  const uint4 aux = make_uint4(hash, rip, io.now + nat_lifetime(h.proto),
                               flags);
  if (need) {
    reinterpret_cast<uint4*>(io.key)[i] = k;
    reinterpret_cast<uint4*>(io.aux)[i] = aux;
    io.slot[i] = mslot;
  } else {
    io.aux[(size_t)i * 4 + 3] = flags;
  }
  if (!(flags & F_PENDING)) snat_out(io, i, k, aux, match, mslot, false);
}

// Step s's claim words: three arrays in turn, so that a step's bids, the
// previous step's verdicts and the clearing of the step before that can
// share one phase.
__device__ __forceinline__ int32_t* claim_of(const SnatIO& io, int step) {
  return io.claim + (size_t)(step % 3) * io.capacity;
}

__device__ __forceinline__ uint32_t nat_slot(const SnatIO& io, uint32_t hash,
                                             int step) {
  return (hash + (uint32_t)step) & ((uint32_t)io.capacity - 1u);
}

// What a pending row's step needs from memory, gathered before anything
// is decided and in two rounds, so that the loads of several rows go out
// together.  First its step-th slot's claim word (where it bid) and, for
// the next step's bid, that slot's claim word of this step and its row
// as the table holds it; then the winner's key (where another row won
// its slot) and, where the next slot was bid on this step, its winner's
// key and expiry in place of the row read (the winner writes that slot
// in this very phase).
struct NatStep {
  int32_t w, wq;
  NatRow rq;  // the next slot as this step leaves it
  uint4 kw;   // the key of the row that won this step's slot
};

__device__ __forceinline__ NatStep snat_gather(const SnatIO& io, uint4 aux,
                                               int step, bool next) {
  NatStep g;
  g.w = (aux.w & F_TRYING) ? __ldcg(&claim_of(io, step)[nat_slot(
                                 io, aux.x, step)])
                           : CLAIM_FREE;
  g.wq = CLAIM_FREE;
  g.rq = NatRow{};
  g.kw = make_uint4(0u, 0u, 0u, 0u);
  if (next) {
    const uint32_t q = nat_slot(io, aux.x, step + 1);
    g.wq = __ldcg(&claim_of(io, step)[q]);
    g.rq = load_nat_row(io.table + (size_t)q * NAT_ROW);
  }
  return g;
}

__device__ __forceinline__ void snat_gather2(const SnatIO& io, int32_t i,
                                             uint4 aux, NatStep& g) {
  const uint4* key = reinterpret_cast<const uint4*>(io.key);
  if ((aux.w & F_TRYING) && g.w != i) g.kw = __ldcg(key + g.w);
  if (g.wq != CLAIM_FREE) {
    g.rq.k = __ldcg(key + g.wq);
    g.rq.expires = __ldcg(&io.aux[(size_t)g.wq * 4 + 2]);
  }
}

// A pending row's bid for its `step`-th slot if `r` (the slot as the
// previous step leaves it) is claimable: expired, or holding its tuple.
// -> its flags with F_TRYING set or cleared.
__device__ __forceinline__ uint32_t snat_bid(const SnatIO& io, int32_t i,
                                             uint4 k, uint4 aux, int step,
                                             NatRow r) {
  if (!(r.expires < io.now || keys_equal(r.k, k))) return aux.w & ~F_TRYING;
  atomicMin(&claim_of(io, step)[nat_slot(io, aux.x, step)], i);
  return aux.w | F_TRYING;
}

// Step s for a pending row, its words gathered (`g`), once every bid is
// in.  The verdict: the lowest bidder of its slot (the index the claim
// word holds) writes its row; it and every same-tuple bidder (whose key
// equals the winner's) have the slot's node port and are written out.
// A row still pending after the last step fails: written out with its
// port and dropped.  Then, unless the step is the last, the next step's
// bid.  -> its flags, F_PENDING cleared where it won.
__device__ __forceinline__ uint32_t snat_step(const SnatIO& io, int32_t i,
                                              uint4 k, uint4 aux, int step,
                                              const NatStep& g) {
  uint32_t flags = aux.w & ~F_TRYING;
  if (aux.w & F_TRYING) {
    const int32_t s = (int32_t)nat_slot(io, aux.x, step);
    if (g.w == i) write_row(io.table + (size_t)s * NAT_ROW, k, aux);
    if (g.w == i || keys_equal(g.kw, k)) {
      flags &= ~F_PENDING;
      snat_out(io, i, k, aux, true, s, false);
      return flags;
    }
  }
  if (step + 1 == NAT_PROBE) {
    snat_out(io, i, k, aux, false, 0, true);
    return flags;
  }
  aux.w = flags;
  return snat_bid(io, i, k, aux, step + 1, g.rq);
}

// Whether none of a pending row's window slots from `from` on is
// claimable as the table stands (read while other rows may be writing
// it: a write leaves a live row of its writer's tuple, so a slot read as
// not claimable stays so, and a slot read mid-write as claimable only
// keeps the row).  With no expiry able to wrap past 2^32 in this call
// (`no_wrap`), such a row can never bid again: every write leaves a live
// row, and one of its own tuple only where it bids itself.
__device__ __forceinline__ bool snat_dead(const SnatIO& io, uint4 k,
                                          uint32_t hash, int from) {
  bool any = false;
#pragma unroll
  for (int step = 2; step < NAT_PROBE; ++step) {
    if (step < from) continue;
    const NatRow r = load_nat_row(io.table +
                                  (size_t)nat_slot(io, hash, step) * NAT_ROW);
    any |= r.expires < io.now || keys_equal(r.k, k);
  }
  return !any;
}

// The claim word a listed row's step may have taken back to CLAIM_FREE
// (every bidder of a word writes the same value; a word nobody bid on is
// free already).
__device__ __forceinline__ void snat_clear(const SnatIO& io, uint32_t hash,
                                           int step) {
  claim_of(io, step)[nat_slot(io, hash, step)] = CLAIM_FREE;
}

// Steps s0.. for the `nr` pending rows of `rows` (at most NAT_TAIL_ROWS *
// TPB), by one block: the rows in registers, their words gathered
// together, a __syncthreads where a grid barrier stood.  Step s0's bids
// are in and step s0 - 1's words clear.  Every claim word is free when
// it returns; the failures are added to `failed` once.
__device__ void snat_tail(const SnatIO& io, const int32_t* rows, int32_t nr,
                          int s0, Stamps& st) {
  int32_t i[NAT_TAIL_ROWS];
  uint4 k[NAT_TAIL_ROWS], aux[NAT_TAIL_ROWS];
  bool mine[NAT_TAIL_ROWS], pend[NAT_TAIL_ROWS];
#pragma unroll
  for (int q = 0; q < NAT_TAIL_ROWS; ++q) {
    const int32_t j = q * TPB + threadIdx.x;
    mine[q] = pend[q] = j < nr;
    i[q] = pend[q] ? __ldcg(&rows[j]) : 0;
    k[q] = aux[q] = make_uint4(0u, 0u, 0u, 0u);
    if (pend[q]) {
      k[q] = __ldcg(reinterpret_cast<const uint4*>(io.key) + i[q]);
      aux[q] = __ldcg(reinterpret_cast<const uint4*>(io.aux) + i[q]);
    }
  }
  for (int s = s0;; ++s) {
    const bool last = s + 1 == NAT_PROBE;
    NatStep g[NAT_TAIL_ROWS];
    // every row's loads before any row's stores: two rounds of loads
#pragma unroll
    for (int q = 0; q < NAT_TAIL_ROWS; ++q)
      if (pend[q]) g[q] = snat_gather(io, aux[q], s, !last);
#pragma unroll
    for (int q = 0; q < NAT_TAIL_ROWS; ++q)
      if (pend[q]) snat_gather2(io, i[q], aux[q], g[q]);
#pragma unroll
    for (int q = 0; q < NAT_TAIL_ROWS; ++q) {
      // step s - 1's words: read by every bidder before the barrier
      if (mine[q] && s > s0) snat_clear(io, aux[q].x, s - 1);
      if (pend[q]) {
        aux[q].w = snat_step(io, i[q], k[q], aux[q], s, g[q]);
        pend[q] = aux[q].w & F_PENDING;
      }
    }
    int left = 0;
#pragma unroll
    for (int q = 0; q < NAT_TAIL_ROWS; ++q) {
      if (q * TPB >= nr) break;  // block-uniform
      left += __syncthreads_count(pend[q]);
    }
    if (threadIdx.x == 0) {
      // the failures add to the rows the grid found dead
      if (last) atomicAdd(&io.counts[s + 1], (uint32_t)left);
      else io.counts[s + 1] = (uint32_t)left;
      if (last && left) atomicAdd(io.failed, (uint32_t)left);
    }
    st.mark();
    if (left == 0 || last) {
#pragma unroll
      for (int q = 0; q < NAT_TAIL_ROWS; ++q)
        if (mine[q]) snat_clear(io, aux[q].x, s);
      return;
    }
  }
}

__global__ void __launch_bounds__(TPB)
    snat_egress_kernel(SnatIO io, NatView t, CtView ct) {
  cg::grid_group grid = cg::this_grid();
  __shared__ uint4 rules[NAT_RULES];
  __shared__ uint32_t sh[2];
  const int32_t first = blockIdx.x * TPB, stride = gridDim.x * TPB;
  const int32_t tid = first + threadIdx.x;
  uint32_t* counts = io.counts;
  // the rows pending entering step s
  auto plist = [&io](int s) { return io.plist + (size_t)(s % 3) * io.n; };
  const uint4* key = reinterpret_cast<const uint4*>(io.key);
  const uint4* aux = reinterpret_cast<const uint4*>(io.aux);

  // the counters, read after the first barrier
  if (tid < STAMP_AT - 1) counts[tid] = 0u;
  Stamps st{counts, 0};
  st.mark();
  // the first NAT_RULES gateway rules, staged once a block
  const int staged = min(t.g, NAT_RULES);
  for (int g = threadIdx.x; g < staged; g += TPB)
    rules[g] = make_uint4(__ldg(&t.egw_src[g]), __ldg(&t.egw_net[g]),
                          __ldg(&t.egw_mask[g]), __ldg(&t.egw_ip[g]));
  __syncthreads();
  for (int32_t i = tid; i < io.n; i += stride)
    snat_prep_row(io, t, ct, rules, staged, i);
  grid.sync();  // every window scanned: the refresh may write
  st.mark();

  // matched rows write their new row (rows of one flow write the same
  // six words: the key pins the protocol, < 256 for a port-bearing row,
  // so the expiry agrees; the IP is the stored one); pending rows are
  // listed.  Trip counts are block-uniform, so every thread reaches the
  // append.
  for (int32_t b = first; b < io.n; b += stride) {
    const int32_t i = b + threadIdx.x;
    bool pend = false;
    if (i < io.n) {
      const uint32_t flags = __ldcg(&io.aux[(size_t)i * 4 + 3]);
      if ((flags & (F_NEED | F_MATCH)) == (F_NEED | F_MATCH))
        write_row(io.table + (size_t)__ldcg(&io.slot[i]) * NAT_ROW,
                  __ldcg(key + i), __ldcg(aux + i));
      pend = flags & F_PENDING;
    }
    block_append(pend, i, &counts[0], plist(0), nullptr, sh);
  }
  grid.sync();  // the refreshes are in: the bids read expiries after them
  st.mark();

  // every block reads the same counts after a barrier, so every branch on
  // them below is taken by the whole grid
  const int32_t np = (int32_t)__ldcg(&counts[0]);
  if (np == 0) return st.mark();
  // each pending row checks its window for a claimable slot (expired, or
  // holding its tuple) and bids for step 0's
  bool live = false;
  for (int32_t j = tid; j < np; j += stride) {
    const int32_t i = __ldcg(&plist(0)[j]);
    const uint4 k = __ldcg(key + i);
    uint4 a = __ldcg(aux + i);
    NatRow win[NAT_PROBE];
#pragma unroll
    for (int step = 0; step < NAT_PROBE; ++step)
      win[step] =
          load_nat_row(io.table + (size_t)nat_slot(io, a.x, step) * NAT_ROW);
#pragma unroll
    for (int step = 0; step < NAT_PROBE; ++step)
      live |= win[step].expires < io.now || keys_equal(win[step].k, k);
    io.aux[(size_t)i * 4 + 3] = snat_bid(io, i, k, a, 0, win[0]);
  }
  live = __syncthreads_or(live);
  if (threadIdx.x == 0) counts[C_WORDS + blockIdx.x] = live;
  grid.sync();  // step 0's bids are in
  st.mark();

  int any = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += TPB)
    any |= (int)__ldcg(&counts[C_WORDS + b]);
  if (!__syncthreads_or(any)) {
    // no pending row's window holds a claimable slot: nobody bid, and
    // nothing can be written at any step; every pending row fails
    for (int32_t b = first; b < np; b += stride) {
      const int32_t j = b + threadIdx.x;
      const int32_t i = j < np ? __ldcg(&plist(0)[j]) : -1;
      if (i >= 0) snat_out(io, i, __ldcg(key + i), __ldcg(aux + i), false, 0,
                           true);
      block_count(i >= 0, &counts[NAT_PROBE], io.failed);
    }
    if (tid == 0)
      for (int s = 1; s < NAT_PROBE; ++s) counts[s] = (uint32_t)np;
    return st.mark();
  }
  // no expiry this call writes can wrap past 2^32
  const bool no_wrap = io.now <= 0xFFFFFFFFu - NAT_LIFETIME_TCP;
  if (np <= NAT_TAIL_ROWS * TPB) {
    if (blockIdx.x == 0) {
      if (threadIdx.x == 0) counts[C_TAIL] = 1u;
      snat_tail(io, plist(0), np, 0, st);
    }
    return st.mark();
  }
  for (int s = 0;; ++s) {
    const int32_t nr = (int32_t)__ldcg(&counts[s]);
    const int32_t* cur = plist(s);
    const bool last = s + 1 == NAT_PROBE;
    if (s > 0) {
      // step s - 1's words, read by every bidder before the barrier
      const int32_t np0 = (int32_t)__ldcg(&counts[s - 1]);
      for (int32_t j = tid; j < np0; j += stride)
        snat_clear(io, __ldcg(&io.aux[(size_t)__ldcg(&plist(s - 1)[j]) * 4]),
                   s - 1);
    }
    // step s's verdicts and, in the same phase, step s + 1's bids; at
    // step 1 (a pool that step 0 filled), a row that did not bid and
    // whose window holds no claimable slot past its next fails now (it
    // would at the last step)
    for (int32_t b = first; b < nr; b += stride) {
      const int32_t j = b + threadIdx.x;
      const int32_t i = j < nr ? __ldcg(&cur[j]) : -1;
      bool still = false, dead = false;
      if (i >= 0) {
        const uint4 k = __ldcg(key + i);
        uint4 a = __ldcg(aux + i);
        NatStep g = snat_gather(io, a, s, !last);
        snat_gather2(io, i, a, g);
        a.w = snat_step(io, i, k, a, s, g);
        still = a.w & F_PENDING;
        if (still && s == 1 && no_wrap && !(a.w & F_TRYING) &&
            snat_dead(io, k, a.x, s + 2)) {
          snat_out(io, i, k, a, false, 0, true);
          still = false;
          dead = true;
        }
        io.aux[(size_t)i * 4 + 3] = a.w;
      }
      block_append(still, i, &counts[s + 1], last ? nullptr : plist(s + 1),
                   last ? io.failed : nullptr, sh);
      block_count(dead, &counts[NAT_PROBE], io.failed);
    }
    grid.sync();  // its verdicts and step s + 1's bids are in
    st.mark();
    const int32_t left = (int32_t)__ldcg(&counts[s + 1]);
    const bool stop = left == 0 || last;
    if (stop || left <= NAT_TAIL_ROWS * TPB) {
      for (int32_t j = tid; j < nr; j += stride)
        snat_clear(io, __ldcg(&io.aux[(size_t)__ldcg(&cur[j]) * 4]), s);
      if (stop) return st.mark();
      grid.sync();  // step s's words clear before one block goes on
      st.mark();
      if (blockIdx.x == 0) {
        if (threadIdx.x == 0) counts[C_TAIL] = (uint32_t)s + 2u;
        snat_tail(io, plist(s + 1), left, s + 1, st);
      }
      return st.mark();
    }
  }
}

// The most blocks of snat_egress_kernel a launch takes on device `dev`:
// co-resident ones, at most NAT_BLOCKS_PER_SM an SM (0: none fit).
int snat_max_blocks(int dev) {
  static int cached[64];
  if (dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, snat_egress_kernel,
                                                  TPB, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = min(per_sm, NAT_BLOCKS_PER_SM) * sms;
  }
  return cached[dev];
}

// --- K12 ---------------------------------------------------------------

// What a row's refresh needs after the barrier: the slot it hit (-1:
// none) and the expiry it writes there.
struct RevHit {
  int32_t slot;
  uint32_t expires;
};

// Row i (none past n): the row, 16 bytes a load, then its slot if it is
// an ingress v4 reply to a port in the pool, the hit test and the out
// row (the destination IP and port restored on a hit).
__device__ __forceinline__ RevHit rev_row(const SnatRevIO& io,
                                          const NatView& t, int32_t i) {
  if (i >= io.n) return RevHit{-1, 0u};
  const uint4* in = reinterpret_cast<const uint4*>(io.rows +
                                                   (size_t)i * N_COLS);
  uint4 w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] = __ldg(in + q);
  const uint32_t slot = w[2].y - NAT_PORT_MIN;  // dport
  const bool need = w[3].w == 0 && w[3].y == 4 && w[2].y >= NAT_PORT_MIN &&
                    slot < (uint32_t)io.capacity;
  const NatRow r = need ? load_nat_row(io.table + (size_t)slot * NAT_ROW)
                        : NatRow{};
  const uint32_t dst = w[1].w;
  const bool hit = need &&
                   (r.snat_ip != 0 ? dst == r.snat_ip : dst == t.node_ip) &&
                   r.expires >= io.now && r.k.z == w[0].w &&
                   r.k.w == ((w[2].x << 8) | w[2].z);
  if (hit) {
    w[1].w = r.k.x;
    w[2].y = r.k.y;
  }
  uint4* o = reinterpret_cast<uint4*>(io.out + (size_t)i * N_COLS);
#pragma unroll
  for (int q = 0; q < 4; ++q) o[q] = w[q];
  return hit ? RevHit{(int32_t)slot, io.now + nat_lifetime(w[2].z)}
             : RevHit{-1, 0u};
}

// Row i's bid for its slot (every lane of the warp calls, row i in lane
// i % 32): a hit whose next row, in the next lane, hits the same slot
// leaves the bid to that row, whose bid is lower.
__device__ __forceinline__ void rev_bid(const SnatRevIO& io, RevHit h,
                                        int32_t i) {
  const int32_t next = __shfl_down_sync(0xFFFFFFFFu, h.slot, 1);
  if (h.slot >= 0 && ((threadIdx.x & 31) == 31 || next != h.slot))
    atomicMin(&io.claim[h.slot], io.n - 1 - i);
}

// After the barrier: the claim word of a row's slot (CLAIM_FREE for no
// slot), then, where the row's bid stands in it, the refresh: the expiry
// written and the word freed.  Its losers read the bid or CLAIM_FREE,
// never theirs: only a hit bids n - 1 - row.
__device__ __forceinline__ int32_t rev_word(const SnatRevIO& io, RevHit h) {
  return h.slot >= 0 ? __ldcg(&io.claim[h.slot]) : CLAIM_FREE;
}

__device__ __forceinline__ void rev_refresh(const SnatRevIO& io, RevHit h,
                                            int32_t word, int32_t i) {
  if (word != io.n - 1 - i) return;
  io.table[(size_t)h.slot * NAT_ROW + NV_EXPIRES] = h.expires;
  io.claim[h.slot] = CLAIM_FREE;
}

__global__ void __launch_bounds__(REV_TPB)
    snat_reverse_kernel(SnatRevIO io, NatView t) {
  Stamps st{io.meta, 0};
  st.mark();
  const int32_t stride = gridDim.x * REV_TPB;
  const int32_t base = blockIdx.x * REV_TPB + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // 1. the rows whose hits stay in registers, one at a time (on the H100
  // faster than all of a thread's rows' loads in flight together)
  RevHit hit[REV_ROWS];
#pragma unroll
  for (int q = 0; q < REV_ROWS; ++q) {
    const int32_t i = base + q * stride;
    hit[q] = rev_row(io, t, i);
    rev_bid(io, hit[q], i);
  }
  // rows past them (warp-uniform trips): the same, their hits found
  // again after the barrier
  for (int32_t b = base - lane + REV_ROWS * stride; b < io.n; b += stride)
    rev_bid(io, rev_row(io, t, b + lane), b + lane);
  if (gridDim.x == 1) {
    __syncthreads();
  } else {
    cg::this_grid().sync();  // every bid is in
  }
  st.mark();

  // 2. the refreshes: every kept hit's claim word read before any store
  int32_t word[REV_ROWS];
#pragma unroll
  for (int q = 0; q < REV_ROWS; ++q) word[q] = rev_word(io, hit[q]);
#pragma unroll
  for (int q = 0; q < REV_ROWS; ++q)
    rev_refresh(io, hit[q], word[q], base + q * stride);
  for (int32_t i = base + REV_ROWS * stride; i < io.n; i += stride) {
    const uint4 c = __ldg(reinterpret_cast<const uint4*>(
                              io.rows + (size_t)i * N_COLS) + 2);
    const uint32_t s = c.y - NAT_PORT_MIN;
    const RevHit h{c.y >= NAT_PORT_MIN && s < (uint32_t)io.capacity
                       ? (int32_t)s : -1,
                   io.now + nat_lifetime(c.z)};
    rev_refresh(io, h, rev_word(io, h), i);
  }
  st.mark();
}

// The most blocks of snat_reverse_kernel a launch takes on device `dev`:
// co-resident ones, at most REV_BLOCKS_PER_SM an SM (0: none fit).
int rev_max_blocks(int dev) {
  static int cached[64];
  if (dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, snat_reverse_kernel, REV_TPB, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = min(per_sm, REV_BLOCKS_PER_SM) * sms;
  }
  return cached[dev];
}

// --- K14 ---------------------------------------------------------------

// K14: its block, the rows a thread takes at once (their loads and
// probes in flight together) and at most this many blocks an SM
constexpr int MASQ_TPB = 128;
constexpr int MASQ_ROWS = 1;
constexpr int MASQ_BLOCKS_PER_SM = 2;

// Row i's 16 words: four 16-byte loads, or word loads where the rows
// sit off a 16-byte boundary (`vec` false).
__device__ __forceinline__ void masq_load(const uint32_t* rows, bool vec,
                                          int32_t i, uint4 w[4]) {
  const uint32_t* r = rows + (size_t)i * N_COLS;
  if (vec) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = __ldg(reinterpret_cast<const uint4*>(r) + q);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = make_uint4(__ldg(r + 4 * q), __ldg(r + 4 * q + 1),
                        __ldg(r + 4 * q + 2), __ldg(r + 4 * q + 3));
  }
}

// Whether a non-masquerade network holds `a` (every lane reads the same
// words: one L1 broadcast a load).
__device__ __forceinline__ bool masq_in_nets(const NatView& t, uint32_t a) {
  bool in = false;
  for (int k = 0; k < t.k; ++k)
    in |= (a & __ldg(&t.mask[k])) == __ldg(&t.net[k]);
  return in;
}

// R rows a thread at once: rows b + q * (grid threads), q < R, then the
// next R * (grid threads) on.
template <int R>
__global__ void __launch_bounds__(MASQ_TPB)
    masq_kernel(MasqIO io, NatView t, CtView ct) {
  const int32_t stride = gridDim.x * MASQ_TPB;
  const bool vec = (reinterpret_cast<uintptr_t>(io.rows) & 15u) == 0;
  int32_t b = blockIdx.x * MASQ_TPB + threadIdx.x;
  uint4 w[R][4];
#pragma unroll
  for (int q = 0; q < R; ++q)
    if (b + q * stride < io.n) masq_load(io.rows, vec, b + q * stride, w[q]);
  for (;;) {
    bool masq[R];
    uint32_t rev[R][KEY_WORDS];
    CtProbe p[R];
    // every candidate's fingerprint window in flight before any row head
#pragma unroll
    for (int q = 0; q < R; ++q) {
      // egress (word 15), v4 (word 13), toward no such network (word 7)
      masq[q] = b + q * stride < io.n && w[q][3].w == 1 &&
                w[q][3].y == 4 && !masq_in_nets(t, w[q][1].w);
      if (masq[q] && io.probe) {
        const uint32_t src[4] = {w[q][0].x, w[q][0].y, w[q][0].z, w[q][0].w};
        const uint32_t dst[4] = {w[q][1].x, w[q][1].y, w[q][1].z, w[q][1].w};
        uint32_t fwd[KEY_WORDS];
        ct_keys(src, dst, w[q][2].x, w[q][2].y, w[q][2].z, w[q][2].w,
                w[q][3].w, fwd, rev[q]);
        p[q] = ct_probe_begin(ct, rev[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (masq[q] && io.probe)
        masq[q] = !reverse_ct_found_fp(ct, rev[q], p[q], io.now);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int32_t i = b + q * stride;
      if (i >= io.n) continue;
      if (masq[q]) w[q][0].w = t.node_ip;
      uint4* o = reinterpret_cast<uint4*>(io.out + (size_t)i * N_COLS);
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = w[q][k];
      io.masq[i] = masq[q];
    }
    b += R * stride;
    if (b >= io.n) return;
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (b + q * stride < io.n)
        masq_load(io.rows, vec, b + q * stride, w[q]);
  }
}

inline int blocks_for(int32_t n) { return (n + TPB - 1) / TPB; }

}  // namespace

extern "C" int snat_egress_launch(const SnatIO* iop, const NatView* tp,
                                  const CtView* ctp, cudaStream_t stream) {
  SnatIO io = *iop;
  NatView t = *tp;
  CtView ct = *ctp;
  if (io.n <= 0) return (int)cudaGetLastError();
  int dev = 0;
  cudaGetDevice(&dev);
  int blocks = blocks_for(io.n),
      most = min(snat_max_blocks(dev), NAT_MAX_BLOCKS);
  if (most <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (blocks > most) blocks = most;
  void* args[] = {&io, &t, &ct};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(snat_egress_kernel), dim3(blocks), dim3(TPB),
      args, 0, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int snat_reverse_launch(const SnatRevIO* iop, const NatView* tp,
                                   cudaStream_t stream) {
  SnatRevIO io = *iop;
  NatView t = *tp;
  if (io.n <= 0) return (int)cudaGetLastError();
  int dev = 0;
  cudaGetDevice(&dev);
  const int most = rev_max_blocks(dev);
  if (most <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  // a row a thread, at most `most` blocks (past them a thread takes
  // more rows)
  const int64_t want = ((int64_t)io.n + REV_TPB - 1) / REV_TPB;
  const int blocks = want < most ? (int)want : most;
  void* args[] = {&io, &t};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(snat_reverse_kernel), dim3(blocks),
      dim3(REV_TPB), args, 0, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int masq_rewrite_launch(const MasqIO* io, const NatView* t,
                                   const CtView* ct, cudaStream_t stream) {
  if (io->n > 0) {
    CtView none{};
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int64_t per_block = (int64_t)MASQ_TPB * MASQ_ROWS;
    const int64_t want = (io->n + per_block - 1) / per_block;
    const int64_t most = (int64_t)MASQ_BLOCKS_PER_SM * (sms > 0 ? sms : 1);
    masq_kernel<MASQ_ROWS><<<(int)(want < most ? want : most), MASQ_TPB, 0,
                             stream>>>(*io, *t, ct ? *ct : none);
  }
  return (int)cudaGetLastError();
}

extern "C" size_t nat_abi_size(int which) {
  switch (which) {
    case 0: return sizeof(NatView);
    case 1: return sizeof(CtView);
    case 2: return sizeof(SnatIO);
    case 3: return sizeof(SnatRevIO);
    case 4: return sizeof(MasqIO);
    default: return 0;
  }
}
