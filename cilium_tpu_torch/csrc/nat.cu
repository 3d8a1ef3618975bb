// K11 snat_egress, K12 snat_reverse and K14 masq_rewrite: egress NAT.
//
// K11 replaces cilium_tpu/service/nat.py snat_egress (:225), the jitted
// snat_egress_jit; K12 snat_reverse (:356), snat_reverse_jit; K14 the
// stateless rewrite of cilium_tpu/datapath/verdict.py apply_masquerade
// (:374, with its reverse-CT probe) and service/nat.py snat_stage (:410,
// without).  The plain versions are cilium_tpu_torch/service/nat.py
// snat_egress_plain, snat_reverse_plain and masq_rewrite_plain.
//
// Bound: K11 by the latency of dependent random reads: a 16-slot probe
// of the 68 MB CT table for the reverse key, then the 8-slot window of
// the NAT table (24 B rows, 384 KB at 2^14 slots: it lives in L2), and
// by its launches.  K12 and K14 by one row read and one row written per
// packet (64 B each), plus K14's CT probe.
//
// K11 design.  The reference awards a contended slot, step by step, to
// the LOWEST batch row and lets a same-tuple loser adopt the winner's
// slot when it reads the slot back.  Blocks run in no order, so every
// phase that reads a slot another row may write gets its own launch on
// the stream:
//   1. snat_prep, one thread per row: the class (egress, v4, internal,
//      portful), the first matching egress-gateway rule, the reverse-CT
//      probe (ct_probe_full, conntrack.cuh), the FNV hash of (src,
//      sport, dst, dport << 8 | proto) and the whole-window scan for a
//      live same-tuple mapping, whose stored IP (0 read as node_ip) it
//      keeps.  Per-row scratch: key, hash, rewrite IP, expiry, flags;
//   2. snat_refresh: matched rows write their new row (rows of one flow
//      write the same six words: the key pins the protocol, < 256 for a
//      port-bearing row, so the expiry agrees; the IP is the stored one);
//   3. NAT_PROBE claim steps: pending rows whose probe slot is claimable
//      (expired, or holding their own tuple) atomicMin their row index
//      into the slot's claim word; the lowest writes its row and frees
//      the word (snat_write); every bidder reads the slot back and has
//      won if it holds its key -- the winner, or a same-tuple loser that
//      adopts it -- and the rest bid for the next step in the same
//      launch (snat_verify).  The launcher fills the claim words with
//      CLAIM_FREE for each call, and the writer frees the word it won,
//      so every word is free again at the end of a step;
//   4. snat_final: the source IP and port rewrite, the drop mask, and
//      one atomicAdd per warp of the drops into `failed`.
// 20 launches a call, each a thread per row that exits early when the
// row has nothing left to do.
//
// K12 design: one thread per row gathers slot dport - NAT_PORT_MIN and
// runs the hit test (ingress, v4, in the pool, the IP the mapping
// rewrote to, live, the reply tuple).  Two replies of different
// protocol words can hit one slot (a forged protocol >= 256 aliases the
// low byte the slot stores) and their refreshed expiries then differ;
// the reference's scatter keeps the highest row's, so hits bid
// n - 1 - row into the slot's claim word and the lowest bid, the
// highest row, writes in a second launch and frees the word.
//
// All compares of expiries and ports are unsigned, as on the reference.
#include "conntrack.cuh"

namespace {

constexpr int N_COLS = 16;
constexpr int TPB = 256;
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

// A live CT entry for the row's reply tuple: the row answers a
// connection a remote opened into the node.
__device__ __forceinline__ bool reverse_ct_found(const CtView& ct,
                                                 const Hdr& h, uint32_t now) {
  uint32_t fwd[KEY_WORDS], rev[KEY_WORDS];
  ct_keys(h.src, h.dst, h.sport, h.dport, h.proto, h.flags, h.dirn, fwd, rev);
  int32_t slot;
  return ct_probe_full(ct, rev, ct_hash(rev), now, &slot);
}

// FNV-1a over the four key words (service/nat.py _nat_hash).
__device__ __forceinline__ uint32_t nat_hash(uint4 k) {
  uint32_t h = 0x811C9DC5u;
  h = (h ^ k.x) * 0x01000193u;
  h = (h ^ k.y) * 0x01000193u;
  h = (h ^ k.z) * 0x01000193u;
  return (h ^ k.w) * 0x01000193u;
}

__device__ __forceinline__ bool key_match(const uint32_t* row, uint4 k) {
  return row[NV_SRC] == k.x && row[NV_SPORT] == k.y && row[NV_DST] == k.z &&
         row[NV_DP] == k.w;
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

__global__ void snat_prep(SnatIO io, NatView t, CtView ct) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  Hdr h = load_hdr(io.rows, i);
  uint32_t src = h.src[3], dst = h.dst[3];
  bool gw = false;
  uint32_t rip = t.node_ip;
  for (int g = 0; g < t.g; ++g) {
    if (src == t.egw_src[g] && (dst & t.egw_mask[g]) == t.egw_net[g]) {
      gw = true;
      rip = t.egw_ip[g];
      break;
    }
  }
  bool masq = h.dirn == 1 && h.fam == 4 && (gw || !in_nets(t, dst)) &&
              !reverse_ct_found(ct, h, io.now);
  bool need = masq && (h.proto == 6 || h.proto == 17 || h.proto == 132);
  uint4 k = make_uint4(src, h.sport, dst, (h.dport << 8) | h.proto);
  uint32_t hash = nat_hash(k);
  uint32_t pmask = (uint32_t)io.capacity - 1u;
  bool match = false;
  int32_t mslot = 0;
  for (int step = 0; step < NAT_PROBE; ++step) {
    uint32_t s = (hash + (uint32_t)step) & pmask;
    const uint32_t* row = io.table + (size_t)s * NAT_ROW;
    if (row[NV_EXPIRES] >= io.now && key_match(row, k)) {
      match = true;
      mslot = (int32_t)s;
      break;
    }
  }
  if (match && need) {
    // a live mapping keeps the IP it was made with (0: node_ip)
    uint32_t stored = io.table[(size_t)mslot * NAT_ROW + NV_SNAT_IP];
    rip = stored != 0 ? stored : t.node_ip;
  }
  uint32_t flags = (masq ? F_MASQ : 0u) | (need ? F_NEED : 0u) |
                   (match ? F_MATCH : 0u) | (need && !match ? F_PENDING : 0u);
  reinterpret_cast<uint4*>(io.key)[i] = k;
  reinterpret_cast<uint4*>(io.aux)[i] =
      make_uint4(hash, rip, io.now + nat_lifetime(h.proto), flags);
  io.slot[i] = mslot;
}

__global__ void snat_refresh(SnatIO io) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  uint4 aux = reinterpret_cast<const uint4*>(io.aux)[i];
  if ((aux.w & (F_NEED | F_MATCH)) != (F_NEED | F_MATCH)) return;
  write_row(io.table + (size_t)io.slot[i] * NAT_ROW,
            reinterpret_cast<const uint4*>(io.key)[i], aux);
}

// A pending row's bid for its step-th probe slot; returns the flags with
// F_TRYING set or cleared.
__device__ __forceinline__ uint32_t snat_bid(const SnatIO& io, int32_t i,
                                             uint4 k, uint4 aux, int step) {
  uint32_t s = (aux.x + (uint32_t)step) & ((uint32_t)io.capacity - 1u);
  const uint32_t* row = io.table + (size_t)s * NAT_ROW;
  if (row[NV_EXPIRES] < io.now || key_match(row, k)) {
    atomicMin(&io.claim[s], i);
    return aux.w | F_TRYING;
  }
  return aux.w & ~F_TRYING;
}

__global__ void snat_claim(SnatIO io, int step) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  uint4 aux = reinterpret_cast<const uint4*>(io.aux)[i];
  if (!(aux.w & F_PENDING)) return;
  io.aux[(size_t)i * 4 + 3] =
      snat_bid(io, i, reinterpret_cast<const uint4*>(io.key)[i], aux, step);
}

__global__ void snat_write(SnatIO io, int step) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  uint4 aux = reinterpret_cast<const uint4*>(io.aux)[i];
  if (!(aux.w & F_TRYING)) return;
  uint32_t s = (aux.x + (uint32_t)step) & ((uint32_t)io.capacity - 1u);
  // only the lowest bidder reads its own index here; freeing the word
  // leaves every other bidder reading an index not its own
  if (io.claim[s] == i) {
    write_row(io.table + (size_t)s * NAT_ROW,
              reinterpret_cast<const uint4*>(io.key)[i], aux);
    io.claim[s] = CLAIM_FREE;
  }
}

__global__ void snat_verify(SnatIO io, int step) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  uint4 aux = reinterpret_cast<const uint4*>(io.aux)[i];
  if (!(aux.w & F_PENDING)) return;
  uint4 k = reinterpret_cast<const uint4*>(io.key)[i];
  if (aux.w & F_TRYING) {
    uint32_t s = (aux.x + (uint32_t)step) & ((uint32_t)io.capacity - 1u);
    aux.w &= ~F_TRYING;
    if (key_match(io.table + (size_t)s * NAT_ROW, k)) {
      io.slot[i] = (int32_t)s;
      aux.w &= ~F_PENDING;
    }
  }
  // the next step's bid, in the same launch: it reads rows no thread of
  // this launch writes, and every claim word is free again
  if (step + 1 < NAT_PROBE && (aux.w & F_PENDING))
    aux.w = snat_bid(io, i, k, aux, step + 1);
  io.aux[(size_t)i * 4 + 3] = aux.w;
}

__global__ void snat_final(SnatIO io) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  bool dropped = false;
  if (i < io.n) {
    uint4 aux = reinterpret_cast<const uint4*>(io.aux)[i];
    uint4 k = reinterpret_cast<const uint4*>(io.key)[i];
    bool need = aux.w & F_NEED, pending = aux.w & F_PENDING;
    dropped = need && pending;
    bool allocated = need && !pending;
    store_row(io.rows, io.out, i, 3, (aux.w & F_MASQ) ? aux.y : k.x,
              allocated ? NAT_PORT_MIN + (uint32_t)io.slot[i] : k.y);
    io.drop[i] = dropped;
  }
  unsigned ballot = __ballot_sync(0xFFFFFFFFu, dropped);
  if ((threadIdx.x & 31) == 0 && ballot)
    atomicAdd(io.failed, (uint32_t)__popc(ballot));
}

// --- K12 ---------------------------------------------------------------

__global__ void snat_reverse_hit(SnatRevIO io, NatView t) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  Hdr h = load_hdr(io.rows, i);
  uint32_t src = h.src[3], dst = h.dst[3];
  bool in_pool = h.dport >= NAT_PORT_MIN &&
                 h.dport < NAT_PORT_MIN + (uint32_t)io.capacity;
  uint32_t cand = in_pool ? h.dport - NAT_PORT_MIN : 0u;
  const uint32_t* row = io.table + (size_t)cand * NAT_ROW;
  uint32_t row_ip = row[NV_SNAT_IP];
  bool ip_ok = row_ip != 0 ? dst == row_ip : dst == t.node_ip;
  bool hit = h.dirn == 0 && h.fam == 4 && in_pool && ip_ok &&
             row[NV_EXPIRES] >= io.now && row[NV_DST] == src &&
             row[NV_DP] == ((h.sport << 8) | h.proto);
  store_row(io.rows, io.out, i, 7, hit ? row[NV_SRC] : dst,
            hit ? row[NV_SPORT] : h.dport);
  io.hit_slot[i] = hit ? (int32_t)cand : -1;
  if (hit) atomicMin(&io.claim[cand], io.n - 1 - i);  // the highest row
}

__global__ void snat_reverse_refresh(SnatRevIO io) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  int32_t s = io.hit_slot[i];
  if (s < 0 || io.claim[s] != io.n - 1 - i) return;
  io.table[(size_t)s * NAT_ROW + NV_EXPIRES] =
      io.now + nat_lifetime(io.rows[(size_t)i * N_COLS + 10]);
  io.claim[s] = CLAIM_FREE;
}

// --- K14 ---------------------------------------------------------------

__global__ void masq_kernel(MasqIO io, NatView t, CtView ct) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  Hdr h = load_hdr(io.rows, i);
  bool masq = h.dirn == 1 && h.fam == 4 && !in_nets(t, h.dst[3]);
  if (masq && io.probe) masq = !reverse_ct_found(ct, h, io.now);
  store_row(io.rows, io.out, i, 3, masq ? t.node_ip : h.src[3], h.sport);
  io.masq[i] = masq;
}

inline int blocks_for(int32_t n) { return (n + TPB - 1) / TPB; }

}  // namespace

extern "C" int snat_egress_launch(const SnatIO* io, const NatView* t,
                                  const CtView* ct, cudaStream_t stream) {
  if (io->n > 0) {
    int b = blocks_for(io->n);
    snat_prep<<<b, TPB, 0, stream>>>(*io, *t, *ct);
    snat_refresh<<<b, TPB, 0, stream>>>(*io);
    snat_claim<<<b, TPB, 0, stream>>>(*io, 0);
    for (int step = 0; step < NAT_PROBE; ++step) {
      snat_write<<<b, TPB, 0, stream>>>(*io, step);
      snat_verify<<<b, TPB, 0, stream>>>(*io, step);
    }
    snat_final<<<b, TPB, 0, stream>>>(*io);
  }
  return (int)cudaGetLastError();
}

extern "C" int snat_reverse_launch(const SnatRevIO* io, const NatView* t,
                                   cudaStream_t stream) {
  if (io->n > 0) {
    int b = blocks_for(io->n);
    snat_reverse_hit<<<b, TPB, 0, stream>>>(*io, *t);
    snat_reverse_refresh<<<b, TPB, 0, stream>>>(*io);
  }
  return (int)cudaGetLastError();
}

extern "C" int masq_rewrite_launch(const MasqIO* io, const NatView* t,
                                   const CtView* ct, cudaStream_t stream) {
  if (io->n > 0) {
    CtView none{};
    masq_kernel<<<blocks_for(io->n), TPB, 0, stream>>>(*io, *t,
                                                       ct ? *ct : none);
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
