// K17 socklb_stage: the flow-cached service LB (the socket-LB analogue).
//
// Replaces cilium_tpu/service/socklb.py socklb_stage (:228), the jitted
// socklb_stage_jit, with its _resolve (:172) and _aff_probe (:206).  The
// plain version is cilium_tpu_torch/service/socklb.py socklb_stage_plain.
//
// Bound: on a steady batch, the latency of dependent random reads: each
// row's 8-slot fingerprint window (32 B) and one or two 32 B rows of a
// table that lives in L2 at 2^16 slots (2 MB), against 128 B of the row
// read and written.  A batch of new flows adds the frontend compare of
// the misses (as K15) and the claim rounds.
//
// Design.  The reference compacts its misses into a fixed connect buffer
// (cumsum + scatter) and awards every contended slot, step by step, to
// the lowest connect row; connect order is batch-row order, so here the
// misses are listed in no order and bid with their BATCH ROW index.
// Every phase that reads what another row may write is its own launch:
//   1. sock_probe, a thread per row: key, FNV hash, the fingerprint
//      window, full rows of the first two candidates; a miss with more
//      than two fingerprint matches raises the batch's overflow flag;
//   2. sock_settle: under the flag, every row takes the full-window
//      probe (the reference's lax.cond); cached rows (found, v4) bid
//      n - 1 - row for their slot's refresh (the highest row's expiry
//      stands, as XLA's scatter keeps the last duplicate), and v4 misses
//      append themselves to the miss list (one atomicAdd a warp);
//   3. sock_refresh: the winning bidder writes the slot's expiry;
//   4. sock_resolve, a warp per listed miss: the frontend match with
//      the lanes striding over the frontends (a batch has few misses: a
//      thread each would leave the card idle) and the Maglev pick of
//      lb.cuh (K15's hash and pick), the affinity pin read, and, when
//      the misses number at most CONNECT_CAP, the first claim bids;
//      above it nothing is claimed and every miss is resolved uncached
//      (the decision reads the miss count on the card: no host sync);
//   5. SOCK_PROBE claim steps over the flow table and the pin table at
//      once: the lowest bidder writes its row (sock_write) and frees the
//      word; every bidder reads its slot back and is done if it holds
//      its key -- the writer, or a same-key loser that adopts it -- and
//      the rest bid for the next step in the same launch (sock_verify);
//   6. sock_final, a thread per row: the DNAT rewrite and the masks.
// 21 launches a call; the launcher fills the claim words with CLAIM_FREE
// and zeroes the two counters for each call.  Every expiry compare is
// unsigned, and now + lifetime wraps as on the reference.
#include "conntrack.cuh"
#include "lb.cuh"

namespace {

constexpr int N_COLS = 16;
constexpr int SK_PROBE = 8;
constexpr int SK_CAND = 2;
constexpr int32_t SK_CONNECT_CAP = 1 << 13;
constexpr uint32_t SK_LIFETIME_TCP = 21600u;
constexpr uint32_t SK_LIFETIME_NONTCP = 180u;
constexpr int SK_EXPIRES = 6;
constexpr int AF_EXPIRES = 5;
constexpr uint32_t SK_NO_BACKEND = 0xFFFFFFFFu;
constexpr uint32_t SK_AFF_SALT = 0x5EEDAFF1u;
constexpr int32_t SK_CLAIM_FREE = 0x7FFFFFFF;

// aux[i] = (hash, slot, flags, affinity hash), (backend ip, backend port,
// affinity TTL, 0): the backend of a cached row is its cached one, of a
// miss its resolution
constexpr uint32_t F_FOUND = 1u;
constexpr uint32_t F_CACHED = 2u;
constexpr uint32_t F_MISS = 4u;
constexpr uint32_t F_SVC = 8u;
constexpr uint32_t F_NOBE = 16u;
constexpr uint32_t F_PENDING = 32u;    // a flow slot to claim
constexpr uint32_t F_APENDING = 64u;   // an affinity pin to claim
constexpr uint32_t F_TRYING = 128u;    // bid for a flow slot this step
constexpr uint32_t F_ATRYING = 256u;   // bid for a pin slot this step

__device__ __forceinline__ uint32_t fnv4(uint32_t a, uint32_t b, uint32_t c,
                                         uint32_t d) {
  uint32_t h = 0x811C9DC5u;
  h = (h ^ a) * 0x01000193u;
  h = (h ^ b) * 0x01000193u;
  h = (h ^ c) * 0x01000193u;
  return (h ^ d) * 0x01000193u;
}

__device__ __forceinline__ uint4 load_row_part(const uint32_t* rows,
                                               int32_t i, int part) {
  return reinterpret_cast<const uint4*>(rows + (size_t)i * N_COLS)[part];
}

// A flow-table row: words 0-3 the key, then backend ip, port, expiry.
__device__ __forceinline__ bool same_key(const uint32_t* table, uint32_t s,
                                         uint4 k) {
  uint4 x = reinterpret_cast<const uint4*>(table + (size_t)s * 8)[0];
  return x.x == k.x && x.y == k.y && x.z == k.z && x.w == k.w;
}

__device__ __forceinline__ bool live_match(const uint32_t* table, uint32_t s,
                                           uint4 k, uint32_t now,
                                           uint32_t* be_ip,
                                           uint32_t* be_port) {
  const uint4* r = reinterpret_cast<const uint4*>(table + (size_t)s * 8);
  uint4 x = r[0], y = r[1];
  if (x.x == k.x && x.y == k.y && x.z == k.z && x.w == k.w && y.z >= now) {
    *be_ip = y.x;
    *be_port = y.y;
    return true;
  }
  return false;
}

// An affinity row: client src, vip, dport << 8 | proto, backend ip,
// port, expiry.
__device__ __forceinline__ bool same_pin(const uint32_t* aff, uint32_t s,
                                         uint4 k) {
  const uint32_t* r = aff + (size_t)s * 8;
  return r[0] == k.x && r[1] == k.z && r[2] == k.w;
}

__device__ __forceinline__ uint4* aux0(const SockIO& io, int32_t i) {
  return reinterpret_cast<uint4*>(io.aux) + (size_t)i * 2;
}

__device__ __forceinline__ uint4* aux1(const SockIO& io, int32_t i) {
  return reinterpret_cast<uint4*>(io.aux) + (size_t)i * 2 + 1;
}

// --- the established path ------------------------------------------------

__global__ void sock_probe(SockIO io) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  uint4 a = load_row_part(io.rows, i, 0), b = load_row_part(io.rows, i, 1),
        c = load_row_part(io.rows, i, 2);
  uint4 k = make_uint4(a.w, c.x, b.w, (c.y << 8) | c.z);
  uint32_t h = fnv4(k.x, k.y, k.z, k.w);
  uint32_t kfp = ct_fp_mix(h);
  uint32_t pmask = (uint32_t)io.capacity - 1u;
  unsigned fbits = 0;
#pragma unroll
  for (int step = 0; step < SK_PROBE; ++step)
    if (io.fp[(h + (uint32_t)step) & pmask] == kfp) fbits |= 1u << step;
  bool found = false;
  uint32_t slot = 0, be_ip = 0, be_port = 0;
  unsigned bits = fbits;
  for (int cand = 0; cand < SK_CAND && bits; ++cand) {
    uint32_t s = (h + (uint32_t)(__ffs(bits) - 1)) & pmask;
    bits &= bits - 1;
    if (live_match(io.table, s, k, io.now, &be_ip, &be_port)) {
      found = true;
      slot = s;
      break;
    }
  }
  if (!found && __popc(fbits) > SK_CAND) io.meta[0] = 1;
  reinterpret_cast<uint4*>(io.key)[i] = k;
  *aux0(io, i) = make_uint4(h, slot, found ? F_FOUND : 0u, 0u);
  *aux1(io, i) = make_uint4(be_ip, be_port, 0u, 0u);
}

__global__ void sock_settle(SockIO io) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  bool miss = false;
  if (i < io.n) {
    uint4 k = reinterpret_cast<const uint4*>(io.key)[i];
    uint4 x = *aux0(io, i), y = *aux1(io, i);
    bool found = x.z & F_FOUND;
    if (io.meta[0]) {
      // some row overflowed its candidates: every row re-probes the
      // whole window, as the reference reruns the batch
      uint32_t pmask = (uint32_t)io.capacity - 1u;
      found = false;
      for (int step = 0; step < SK_PROBE; ++step) {
        uint32_t s = (x.x + (uint32_t)step) & pmask;
        if (live_match(io.table, s, k, io.now, &y.x, &y.y)) {
          found = true;
          x.y = s;
          break;
        }
      }
    }
    bool v4 = io.rows[(size_t)i * N_COLS + 13] == 4u;
    bool cached = found && v4;
    miss = v4 && !cached;
    x.z = (cached ? F_CACHED : 0u) | (miss ? F_MISS : 0u);
    if (cached) atomicMin(&io.claim[x.y], io.n - 1 - i);
    *aux0(io, i) = x;
    *aux1(io, i) = y;
  }
  unsigned ballot = __ballot_sync(0xFFFFFFFFu, miss);
  if (ballot) {
    int lane = threadIdx.x & 31, leader = __ffs(ballot) - 1;
    int32_t base = 0;
    if (lane == leader) base = atomicAdd(&io.meta[1], __popc(ballot));
    base = __shfl_sync(0xFFFFFFFFu, base, leader);
    if (miss) io.list[base + __popc(ballot & ((1u << lane) - 1u))] = i;
  }
}

__global__ void sock_refresh(SockIO io) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  uint4 x = *aux0(io, i);
  if (!(x.z & F_CACHED) || io.claim[x.y] != io.n - 1 - i) return;
  uint32_t proto = io.rows[(size_t)i * N_COLS + 10];
  io.table[(size_t)x.y * 8 + SK_EXPIRES] =
      io.now + (proto == 6u ? SK_LIFETIME_TCP : SK_LIFETIME_NONTCP);
  io.claim[x.y] = SK_CLAIM_FREE;
}

// --- the connect path ------------------------------------------------------

// A listed miss's bids for its step-th flow slot and pin slot; returns
// its flags with F_TRYING / F_ATRYING set where it bid.
__device__ __forceinline__ uint32_t sock_bid(const SockIO& io, int32_t i,
                                             uint4 k, uint4 x, int step) {
  uint32_t flags = x.z & ~(F_TRYING | F_ATRYING);
  if (flags & F_PENDING) {
    uint32_t s = (x.x + (uint32_t)step) & ((uint32_t)io.capacity - 1u);
    if (io.table[(size_t)s * 8 + SK_EXPIRES] < io.now ||
        same_key(io.table, s, k)) {
      atomicMin(&io.claim[s], i);
      flags |= F_TRYING;
    }
  }
  if (flags & F_APENDING) {
    uint32_t s = (x.w + (uint32_t)step) & ((uint32_t)io.aff_capacity - 1u);
    if (io.aff[(size_t)s * 8 + AF_EXPIRES] < io.now || same_pin(io.aff, s, k)) {
      atomicMin(&io.aclaim[s], i);
      flags |= F_ATRYING;
    }
  }
  return flags;
}

// The connect path's resolution of listed miss `i` whose frontend is
// `svc` (-1: none): the Maglev pick, the affinity pin read, the flags and,
// when the misses number at most SK_CONNECT_CAP, the first claim bids.
__device__ __forceinline__ void sock_resolve_row(const SockIO& io,
                                                 const LbView& t, int32_t i,
                                                 int32_t svc, uint4 a, uint4 b,
                                                 uint4 c, int32_t cnt) {
  int32_t be = lb_pick(t.maglev, t.m, svc,
                       lb_hash4(a.w, c.x, b.w, c.y, c.z));
  bool is_svc = be >= 0, no_be = svc >= 0 && be < 0;
  uint32_t aff_ttl = svc >= 0 ? t.svc_aff[svc] : 0u;
  uint32_t be_ip = 0, be_port = SK_NO_BACKEND;
  if (is_svc) {
    be_ip = t.backend_ip[be];
    be_port = t.backend_port[be];
  }
  uint4 k = reinterpret_cast<const uint4*>(io.key)[i];
  uint4 x = *aux0(io, i);
  x.w = 0;
  if (is_svc && aff_ttl) {
    // a live (client, frontend) pin overrides Maglev
    x.w = fnv4(k.x, k.z, k.w, SK_AFF_SALT);
    uint32_t amask = (uint32_t)io.aff_capacity - 1u;
    for (int step = 0; step < SK_PROBE; ++step) {
      uint32_t s = (x.w + (uint32_t)step) & amask;
      const uint32_t* r = io.aff + (size_t)s * 8;
      if (same_pin(io.aff, s, k) && r[AF_EXPIRES] >= io.now) {
        be_ip = r[3];
        be_port = r[4];
        break;
      }
    }
  }
  x.z |= (is_svc ? F_SVC : 0u) | (no_be ? F_NOBE : 0u);
  if (cnt <= SK_CONNECT_CAP) {
    // no_backend rows never claim a slot; affinity service rows claim
    // (or refresh) their pin
    x.z |= (no_be ? 0u : F_PENDING) | (is_svc && aff_ttl ? F_APENDING : 0u);
    x.z = sock_bid(io, i, k, x, 0);
  }
  *aux0(io, i) = x;
  *aux1(io, i) = make_uint4(be_ip, be_port, aff_ttl, 0u);
}

__global__ void sock_resolve(SockIO io, LbView t) {
  int32_t cnt = io.meta[1];
  int lane = threadIdx.x & 31;
  int32_t warps = (int32_t)((gridDim.x * blockDim.x) >> 5);
  // a warp a listed miss (the loop bound is the same for all its lanes)
  for (int32_t j = (int32_t)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
       j < cnt; j += warps) {
    int32_t i = io.list[j];
    uint4 a = load_row_part(io.rows, i, 0), b = load_row_part(io.rows, i, 1),
          c = load_row_part(io.rows, i, 2);
    int32_t svc = lb_match4_warp(t, b.w, c.y, c.z);
    if (lane == 0) sock_resolve_row(io, t, i, svc, a, b, c, cnt);
    __syncwarp();
  }
}

__global__ void sock_write(SockIO io, int step) {
  int32_t j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= io.meta[1]) return;
  int32_t i = io.list[j];
  uint4 x = *aux0(io, i);
  if (!(x.z & (F_TRYING | F_ATRYING))) return;
  uint4 k = reinterpret_cast<const uint4*>(io.key)[i];
  uint4 y = *aux1(io, i);
  // only the lowest bidder reads its own index; freeing the word leaves
  // every other bidder reading an index not its own
  if (x.z & F_TRYING) {
    uint32_t s = (x.x + (uint32_t)step) & ((uint32_t)io.capacity - 1u);
    if (io.claim[s] == i) {
      uint32_t life = (k.w & 0xFFu) == 6u ? SK_LIFETIME_TCP : SK_LIFETIME_NONTCP;
      uint4* r = reinterpret_cast<uint4*>(io.table + (size_t)s * 8);
      r[0] = k;
      r[1] = make_uint4(y.x, y.y, io.now + life, 0u);
      io.fp[s] = ct_fp_mix(x.x);
      io.claim[s] = SK_CLAIM_FREE;
    }
  }
  if (x.z & F_ATRYING) {
    uint32_t s = (x.w + (uint32_t)step) & ((uint32_t)io.aff_capacity - 1u);
    if (io.aclaim[s] == i) {
      uint4* r = reinterpret_cast<uint4*>(io.aff + (size_t)s * 8);
      r[0] = make_uint4(k.x, k.z, k.w, y.x);
      r[1] = make_uint4(y.y, io.now + y.z, 0u, 0u);
      io.aclaim[s] = SK_CLAIM_FREE;
    }
  }
}

__global__ void sock_verify(SockIO io, int step) {
  int32_t j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= io.meta[1]) return;
  int32_t i = io.list[j];
  uint4 x = *aux0(io, i);
  if (!(x.z & (F_PENDING | F_APENDING))) return;
  uint4 k = reinterpret_cast<const uint4*>(io.key)[i];
  if (x.z & F_TRYING) {
    uint32_t s = (x.x + (uint32_t)step) & ((uint32_t)io.capacity - 1u);
    if (same_key(io.table, s, k)) x.z &= ~F_PENDING;
  }
  if (x.z & F_ATRYING) {
    uint32_t s = (x.w + (uint32_t)step) & ((uint32_t)io.aff_capacity - 1u);
    if (same_pin(io.aff, s, k)) x.z &= ~F_APENDING;
  }
  // the next step's bids, in the same launch: they read rows no thread
  // of this launch writes, and every claim word is free again
  x.z = step + 1 < SK_PROBE ? sock_bid(io, i, k, x, step + 1)
                            : x.z & ~(F_TRYING | F_ATRYING);
  aux0(io, i)->z = x.z;
}

__global__ void sock_final(SockIO io) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  uint32_t flags = aux0(io, i)->z;
  uint4 y = *aux1(io, i);
  bool hit = ((flags & F_CACHED) && y.y != SK_NO_BACKEND) ||
             ((flags & F_MISS) && (flags & F_SVC));
  const uint4* r = reinterpret_cast<const uint4*>(io.rows + (size_t)i * N_COLS);
  uint4* o = reinterpret_cast<uint4*>(io.out + (size_t)i * N_COLS);
  uint4 b = r[1], c = r[2];
  if (hit) {
    b.w = y.x;
    c.y = y.y;
  }
  o[0] = r[0];
  o[1] = b;
  o[2] = c;
  o[3] = r[3];
  io.svc_hit[i] = hit;
  io.no_backend[i] = (flags & F_MISS) && (flags & F_NOBE);
}

inline int blocks_for(int32_t n) { return (n + LB_TPB - 1) / LB_TPB; }

}  // namespace

extern "C" int socklb_stage_launch(const SockIO* io, const LbView* t,
                                   cudaStream_t stream) {
  if (io->n > 0) {
    int b = blocks_for(io->n);
    sock_probe<<<b, LB_TPB, 0, stream>>>(*io);
    sock_settle<<<b, LB_TPB, 0, stream>>>(*io);
    sock_refresh<<<b, LB_TPB, 0, stream>>>(*io);
    // 8 warps a block, a warp a miss, at most 8192 warps in flight
    sock_resolve<<<min((io->n + 7) / 8, 1024), LB_TPB, 0, stream>>>(*io,
                                                                    *t);
    for (int step = 0; step < SK_PROBE; ++step) {
      sock_write<<<b, LB_TPB, 0, stream>>>(*io, step);
      sock_verify<<<b, LB_TPB, 0, stream>>>(*io, step);
    }
    sock_final<<<b, LB_TPB, 0, stream>>>(*io);
  }
  return (int)cudaGetLastError();
}

extern "C" size_t socklb_abi_size(int which) {
  switch (which) {
    case 0: return sizeof(LbView);
    case 1: return sizeof(SockIO);
    default: return 0;
  }
}
