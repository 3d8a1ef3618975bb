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
// the misses (as K15) and the claim steps; every phase that reads what
// another row may write costs a grid barrier (~1.1-1.4 us on the H100).
//
// Design (PR 18; PRs 8-17 launched 21 kernels and 3 fills a call).  ONE
// cooperative kernel a call (cudaLaunchCooperativeKernel): every
// co-resident block of SK_TPB threads, at most SK_BLOCKS_PER_SM an SM;
// block b owns rows [b * R * SK_TPB, (b + 1) * R * SK_TPB), R rows a
// thread, the fewest that cover the batch.  Grid barriers stand where a
// row reads what another row wrote:
//   0. probe, a thread a row: key, FNV hash, the fingerprint window,
//      full rows of the first two candidates.  Assuming no row
//      overflows its candidates, it writes the row out (the cached
//      backend's DNAT for a hit), bids n - 1 - row for its slot's refresh
//      (the highest row's expiry stands, as XLA's scatter keeps the last
//      duplicate) and lists a v4 miss in its block's segment of `list`;
//      the block publishes its miss count and whether a row overflowed
//      (block words: nothing to zero before the first barrier);
//   1. when a row overflowed (the reference's lax.cond), the bids are
//      withdrawn, every row re-probes its whole window, rewrites its out
//      row and relists, and the bids are made again: two more barriers,
//      only then.  Then the refresh: the winning bidder writes its slot's
//      expiry and frees the word; the batch's misses number the sum of
//      the block counts, so a batch without one ends here, after ONE
//      barrier.  In the same phase the misses are resolved, a lane a
//      miss, up to 32 a warp: a block with misses stages up to SK_STAGE
//      frontends (address, port << 8 | protocol) in shared memory once;
//      with SK_INDEX_FROM or more misses a warp it indexes them (lb.cuh
//      lb_index4: the lowest index of each key, a probe or two a miss),
//      else (or where a port does not pack) the warp scans the staged
//      addresses for each of its misses; each lane then resolves its own
//      miss (the Maglev pick of K15, the affinity pin window read whole)
//      and writes its out row.  When the misses number at most
//      CONNECT_CAP, the rows with a flow slot or a pin to claim are
//      listed (one atomicAdd a warp); above it nothing is claimed (the
//      count is read on the card: no host sync);
//   2. the claim steps, flow table and pins at once, ONE grid barrier a
//      step.  Pending rows bid their row index (atomicMin) for their
//      step-th slot where it is claimable (expired, or holding their
//      key).  After the barrier each bidder reads its slot's claim word:
//      the lowest bidder writes its row (and fingerprint), and it and
//      every bidder whose key equals the winner's (a same-key loser that
//      adopts the slot) are done.  The rest bid for the next step in the
//      same phase, judging a slot bid on in this step by its winner's key
//      and lifetime (the winner writes it in this very phase), any other
//      by the table; a step's words are cleared two phases later (three
//      arrays in turn).  At step 1, a row pending on a flow slot only
//      that did not bid and whose window holds no claimable slot past
//      its next leaves the steps (flow_dead: where no flow expiry can
//      wrap past 2^32 in the call, it can never bid again, and stays
//      uncached).  The bids read the refreshed expiries, which
//      matters where now + lifetime wraps past 2^32.  The steps stop when
//      no row is pending; once at most SK_TAIL_ROWS * SK_TPB rows are,
//      block 0 finishes them alone (sock_tail: rows in registers,
//      __syncthreads for the grid barriers).  When one block takes them
//      all from step 0, a table (flows or pins) in which no pending
//      row's window holds a claimable slot can never be written, so its
//      steps are not run: a steady batch's misses whose windows are full
//      of live flows cost one look at their windows, not 8 steps.
// Rows are listed with one atomicAdd a block (one a warp queued a
// thousand at one address).  The claim words live with the table
// (SockLBTable.claim, .aclaim: [3, P], [3, A]) and are CLAIM_FREE between
// calls: a call clears every word it bids on.  The call's counters, its
// phase stamps (views.cuh Stamps) and the block words sit in `meta`, set
// inside the launch.  Data another block wrote earlier in the launch is
// read with ld.global.cg (L2), never through L1.  Scalars pass by value
// and nothing syncs the host, so a call is one CUDA-graph node.  Every
// expiry compare is unsigned, and now + lifetime wraps as on the
// reference.
#include <cooperative_groups.h>

#include "conntrack.cuh"
#include "lb.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int N_COLS = 16;
constexpr int SK_TPB = LB_TPB;
constexpr int SK_WARPS = SK_TPB / 32;
// at most this many blocks of SK_TPB an SM (PERF.md, PR 18)
constexpr int SK_BLOCKS_PER_SM = 1;
constexpr int SK_MAX_BLOCKS = 1024;  // entries of the blocks' prefix
constexpr int SK_TAIL_ROWS = 2;      // rows a thread of the one-block tail
constexpr int SK_TAIL_MAX = SK_TAIL_ROWS * SK_TPB;
constexpr int SK_STAGE = 4096;  // frontends a block stages: 32 KB
// dynamic shared memory: the staged addresses and packed ports, then
// their index (lb.cuh lb_index4)
constexpr int SK_DYN_BYTES = (2 * SK_STAGE + LB_INDEX) * 4;
constexpr int SK_INDEX_FROM = 3;  // misses a warp from which to index
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

// meta: the call's counters, then two words a block
constexpr int M_PEND = 0;  // [SK_PROBE + 1]: rows pending entering step s,
                           // then the rows left uncached after the last
constexpr int M_MISSES = SK_PROBE + 1;  // the batch's v4 misses
constexpr int M_TAIL = SK_PROBE + 2;    // 1 + the tail's first step, 0: none
// words STAMP_AT - 1.. hold the phase stamps (views.cuh); then the block
// words: (overflowed, misses) a block
constexpr int M_WORDS = STAMP_AT + STAMPS;

// aux[i] = (hash, slot, flags, affinity hash), (backend ip, backend port,
// affinity TTL, 0): the backend of a cached row is its cached one, of a
// miss its resolution.  A row's key and aux1 are written for misses only.
constexpr uint32_t F_CACHED = 2u;
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

__device__ __forceinline__ uint4 ldcg4(const uint32_t* p) {
  return __ldcg(reinterpret_cast<const uint4*>(p));
}

// part q (16 B) of input row i (never written: the read-only path)
__device__ __forceinline__ uint4 row_part(const uint32_t* rows, int32_t i,
                                          int q) {
  return __ldg(reinterpret_cast<const uint4*>(rows + (size_t)i * N_COLS) +
               q);
}

// A flow-table row: words 0-3 the key, then backend ip, port, expiry.
__device__ __forceinline__ bool live_match(const uint32_t* table, uint32_t s,
                                           uint4 k, uint32_t now,
                                           uint32_t* be_ip,
                                           uint32_t* be_port) {
  const uint32_t* r = table + (size_t)s * 8;
  uint4 x = ldcg4(r), y = ldcg4(r + 4);
  if (x.x == k.x && x.y == k.y && x.z == k.z && x.w == k.w && y.z >= now) {
    *be_ip = y.x;
    *be_port = y.y;
    return true;
  }
  return false;
}

__device__ __forceinline__ uint4* aux0(const SockIO& io, int32_t i) {
  return reinterpret_cast<uint4*>(io.aux) + (size_t)i * 2;
}

__device__ __forceinline__ uint4* aux1(const SockIO& io, int32_t i) {
  return reinterpret_cast<uint4*>(io.aux) + (size_t)i * 2 + 1;
}

__device__ __forceinline__ uint4* key_of(const SockIO& io, int32_t i) {
  return reinterpret_cast<uint4*>(io.key) + i;
}

// Row i's out row (the DNAT to be_ip:be_port where `hit`) and masks.
__device__ __forceinline__ void sock_out(const SockIO& io, int32_t i, uint4 a,
                                         uint4 b, uint4 c, uint4 d, bool hit,
                                         uint32_t be_ip, uint32_t be_port,
                                         bool no_be) {
  uint4* o = reinterpret_cast<uint4*>(io.out + (size_t)i * N_COLS);
  if (hit) {
    b.w = be_ip;
    c.y = be_port;
  }
  o[0] = a;
  o[1] = b;
  o[2] = c;
  o[3] = d;
  io.svc_hit[i] = hit;
  io.no_backend[i] = no_be;
}

// --- the established path ------------------------------------------------

// Phase 0 for row i: the probe over the first SK_CAND fingerprint
// candidates (a miss with more matches sets *ovf), or over the whole
// window when `full`.  Writes the row out as a hit or a pass-through,
// bids for a cached row's refresh and records (hash, slot, flags); a v4
// miss also records its key.  -> whether the row is a v4 miss.
__device__ bool sock_probe_row(const SockIO& io, int32_t i, bool full,
                               bool* ovf) {
  const uint4 a = row_part(io.rows, i, 0), b = row_part(io.rows, i, 1),
              c = row_part(io.rows, i, 2), d = row_part(io.rows, i, 3);
  const uint4 k = make_uint4(a.w, c.x, b.w, (c.y << 8) | c.z);
  const uint32_t h = fnv4(k.x, k.y, k.z, k.w);
  const uint32_t pmask = (uint32_t)io.capacity - 1u;
  bool found = false;
  uint32_t slot = 0, be_ip = 0, be_port = 0;
  if (full) {
    for (int step = 0; step < SK_PROBE && !found; ++step) {
      const uint32_t s = (h + (uint32_t)step) & pmask;
      if (live_match(io.table, s, k, io.now, &be_ip, &be_port)) {
        found = true;
        slot = s;
      }
    }
  } else {
    const uint32_t kfp = ct_fp_mix(h);
    uint32_t f[SK_PROBE];
#pragma unroll
    for (int step = 0; step < SK_PROBE; ++step)
      f[step] = __ldcg(&io.fp[(h + (uint32_t)step) & pmask]);
    unsigned fbits = 0;
#pragma unroll
    for (int step = 0; step < SK_PROBE; ++step)
      fbits |= (f[step] == kfp ? 1u : 0u) << step;
    unsigned bits = fbits;
    for (int cand = 0; cand < SK_CAND && bits; ++cand) {
      const uint32_t s = (h + (uint32_t)(__ffs(bits) - 1)) & pmask;
      bits &= bits - 1;
      if (live_match(io.table, s, k, io.now, &be_ip, &be_port)) {
        found = true;
        slot = s;
        break;
      }
    }
    if (!found && __popc(fbits) > SK_CAND) *ovf = true;
  }
  const bool v4 = d.y == 4u;
  const bool cached = found && v4, miss = v4 && !cached;
  if (cached) atomicMin(&io.claim[slot], io.n - 1 - i);  // fclaim(io, 0)
  *aux0(io, i) = make_uint4(h, slot, cached ? F_CACHED : 0u, 0u);
  if (miss) *key_of(io, i) = k;
  sock_out(io, i, a, b, c, d, cached && be_port != SK_NO_BACKEND, be_ip,
           be_port, false);
  return miss;
}

// Phase 0 (or its overflow rerun) over the block's rows: each row probed
// and its misses listed in the block's segment of io.list; the block's
// (overflowed, misses) words written.
__device__ void sock_probe_block(const SockIO& io, bool full,
                                 uint32_t* s_misses) {
  const int32_t base = blockIdx.x * io.rows_a_thread * SK_TPB;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) *s_misses = 0;
  __syncthreads();
  bool ovf = false;
  for (int r = 0; r < io.rows_a_thread; ++r) {
    const int32_t i = base + r * SK_TPB + threadIdx.x;
    const bool miss = i < io.n && sock_probe_row(io, i, full, &ovf);
    const unsigned m = __ballot_sync(0xFFFFFFFFu, miss);
    uint32_t at = 0;
    if (lane == 0 && m) at = atomicAdd(s_misses, (uint32_t)__popc(m));
    at = __shfl_sync(0xFFFFFFFFu, at, 0);
    if (miss) io.list[base + at + __popc(m & ((1u << lane) - 1u))] = i;
  }
  const int any = __syncthreads_or(ovf);
  if (threadIdx.x == 0) {
    io.meta[M_WORDS + 2 * blockIdx.x] = (uint32_t)any;
    io.meta[M_WORDS + 2 * blockIdx.x + 1] = *s_misses;
  }
}

// After the refresh bids: the highest row of each refreshed slot writes
// its expiry and frees the word.
__device__ __forceinline__ void sock_refresh_row(const SockIO& io,
                                                 int32_t i) {
  const uint4 x = __ldcg(aux0(io, i));
  if (!(x.z & F_CACHED) || __ldcg(&io.claim[x.y]) != io.n - 1 - i) return;
  const uint32_t proto = __ldg(&io.rows[(size_t)i * N_COLS + 10]);
  io.table[(size_t)x.y * 8 + SK_EXPIRES] =
      io.now + (proto == 6u ? SK_LIFETIME_TCP : SK_LIFETIME_NONTCP);
  io.claim[x.y] = SK_CLAIM_FREE;
}

// --- the connect path ------------------------------------------------------

// Step s's claim words, flow slots and pins: three arrays each in turn,
// so that a step's bids, the previous step's verdicts and the clearing
// of the step before that share one phase.  The refresh takes array 0.
__device__ __forceinline__ int32_t* fclaim(const SockIO& io, int step) {
  return io.claim + (size_t)(step % 3) * io.capacity;
}

__device__ __forceinline__ int32_t* pclaim(const SockIO& io, int step) {
  return io.aclaim + (size_t)(step % 3) * io.aff_capacity;
}

__device__ __forceinline__ bool keys_equal(uint4 a, uint4 b) {
  return a.x == b.x && a.y == b.y && a.z == b.z && a.w == b.w;
}

// Whether two flow keys share a pin's key (client src, vip, dport << 8 |
// proto).  An affinity row holds that key, then the backend ip, port and
// the pin's expiry.
__device__ __forceinline__ bool pins_equal(uint4 a, uint4 b) {
  return a.x == b.x && a.z == b.z && a.w == b.w;
}

__device__ __forceinline__ uint32_t lifetime(uint4 k) {
  return (k.w & 0xFFu) == 6u ? SK_LIFETIME_TCP : SK_LIFETIME_NONTCP;
}

__device__ __forceinline__ uint32_t flow_slot(const SockIO& io, uint32_t h,
                                              int step) {
  return (h + (uint32_t)step) & ((uint32_t)io.capacity - 1u);
}

__device__ __forceinline__ uint32_t pin_slot(const SockIO& io, uint32_t h,
                                             int step) {
  return (h + (uint32_t)step) & ((uint32_t)io.aff_capacity - 1u);
}

// What a listed row's step needs from memory, gathered before anything is
// decided and in two rounds, so that the loads of several rows go out
// together.  First the claim words of its step-th flow slot and pin
// (where it bid) and, for the next step's bids, those slots' claim words
// of this step and their rows as the table and the pins hold them; then
// the winners' keys (where another row won its slots) and, where a next
// slot was bid on this step, its winner's key (and pin TTL) in place of
// the row read (the winner writes that slot in this very phase).
struct SockStep {
  int32_t w, aw, wq, awq;
  uint4 fq0, fq1, pq0, pq1;  // the next slots' rows, as the table holds them
  uint4 kw, akw;             // the keys of this step's winners
  uint4 kwq, akwq;           // the keys of the next slots' winners
  uint32_t attl;             // the pin TTL of the next pin's winner
};

__device__ __forceinline__ SockStep sock_gather(const SockIO& io, uint4 x,
                                                int step, bool next) {
  SockStep g;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  g.w = g.aw = g.wq = g.awq = SK_CLAIM_FREE;
  g.fq0 = g.fq1 = g.pq0 = g.pq1 = g.kw = g.akw = g.kwq = g.akwq = zero;
  g.attl = 0u;
  if (x.z & F_TRYING)
    g.w = __ldcg(&fclaim(io, step)[flow_slot(io, x.x, step)]);
  if (x.z & F_ATRYING)
    g.aw = __ldcg(&pclaim(io, step)[pin_slot(io, x.w, step)]);
  if (next && (x.z & F_PENDING)) {
    const uint32_t q = flow_slot(io, x.x, step + 1);
    g.wq = __ldcg(&fclaim(io, step)[q]);
    g.fq0 = ldcg4(io.table + (size_t)q * 8);
    g.fq1 = ldcg4(io.table + (size_t)q * 8 + 4);
  }
  if (next && (x.z & F_APENDING)) {
    const uint32_t q = pin_slot(io, x.w, step + 1);
    g.awq = __ldcg(&pclaim(io, step)[q]);
    g.pq0 = ldcg4(io.aff + (size_t)q * 8);
    g.pq1 = ldcg4(io.aff + (size_t)q * 8 + 4);
  }
  return g;
}

__device__ __forceinline__ void sock_gather2(const SockIO& io, int32_t i,
                                             uint4 x, SockStep& g) {
  if ((x.z & F_TRYING) && g.w != i) g.kw = __ldcg(key_of(io, g.w));
  if ((x.z & F_ATRYING) && g.aw != i) g.akw = __ldcg(key_of(io, g.aw));
  if (g.wq != SK_CLAIM_FREE) g.kwq = __ldcg(key_of(io, g.wq));
  if (g.awq != SK_CLAIM_FREE) {
    g.akwq = __ldcg(key_of(io, g.awq));
    g.attl = __ldcg(&io.aux[(size_t)g.awq * 8 + 6]);
  }
}

// The bids of a listed row (key k, aux0 x) for its step-th flow slot and
// pin, where the slot is claimable (expired, or holding its key) as the
// previous step leaves it (`g`: a slot nobody bid on then as the table
// holds it, else as its winner writes it).  Returns its flags with
// F_TRYING / F_ATRYING set where it bid.
__device__ __forceinline__ uint32_t sock_bid(const SockIO& io, int32_t i,
                                             uint4 k, uint4 x, int step,
                                             const SockStep& g) {
  uint32_t flags = x.z & ~(F_TRYING | F_ATRYING);
  if (flags & F_PENDING) {
    const bool claimable =
        g.wq == SK_CLAIM_FREE
            ? g.fq1.z < io.now || keys_equal(g.fq0, k)
            : io.now + lifetime(g.kwq) < io.now || keys_equal(g.kwq, k);
    if (claimable) {
      atomicMin(&fclaim(io, step)[flow_slot(io, x.x, step)], i);
      flags |= F_TRYING;
    }
  }
  if (flags & F_APENDING) {
    const bool claimable =
        g.awq == SK_CLAIM_FREE
            ? g.pq1.y < io.now ||
                  (g.pq0.x == k.x && g.pq0.y == k.z && g.pq0.z == k.w)
            : io.now + g.attl < io.now || pins_equal(g.akwq, k);
    if (claimable) {
      atomicMin(&pclaim(io, step)[pin_slot(io, x.w, step)], i);
      flags |= F_ATRYING;
    }
  }
  return flags;
}

// The first step's bids: the slots as the table and the pins hold them.
__device__ __forceinline__ uint32_t sock_bid0(const SockIO& io, int32_t i,
                                              uint4 k, uint4 x) {
  SockStep g{};
  g.w = g.aw = g.wq = g.awq = SK_CLAIM_FREE;
  const uint32_t q = flow_slot(io, x.x, 0), a = pin_slot(io, x.w, 0);
  g.fq0 = ldcg4(io.table + (size_t)q * 8);
  g.fq1 = ldcg4(io.table + (size_t)q * 8 + 4);
  g.pq0 = ldcg4(io.aff + (size_t)a * 8);
  g.pq1 = ldcg4(io.aff + (size_t)a * 8 + 4);
  return sock_bid(io, i, k, x, 0, g);
}

// Step s for a listed row, its words gathered (`g`), once every bid is
// in.  The verdicts: the lowest bidder of a slot (the index its claim
// word holds) writes its flow row (and fingerprint) or its pin; it and
// every bidder whose key equals the winner's are done.  Then, unless the
// step is the last, the next step's bids.  -> its flags.
__device__ __forceinline__ uint32_t sock_step(const SockIO& io, int32_t i,
                                              uint4 k, uint4 x, uint4 y,
                                              int step, const SockStep& g) {
  uint32_t flags = x.z;
  if (flags & F_TRYING) {
    const uint32_t s = flow_slot(io, x.x, step);
    if (g.w == i) {
      uint4* r = reinterpret_cast<uint4*>(io.table + (size_t)s * 8);
      r[0] = k;
      r[1] = make_uint4(y.x, y.y, io.now + lifetime(k), 0u);
      io.fp[s] = ct_fp_mix(x.x);
    }
    if (g.w == i || keys_equal(g.kw, k)) flags &= ~F_PENDING;
  }
  if (flags & F_ATRYING) {
    const uint32_t s = pin_slot(io, x.w, step);
    if (g.aw == i) {
      uint4* r = reinterpret_cast<uint4*>(io.aff + (size_t)s * 8);
      r[0] = make_uint4(k.x, k.z, k.w, y.x);
      r[1] = make_uint4(y.y, io.now + y.z, 0u, 0u);
    }
    if (g.aw == i || pins_equal(g.akw, k)) flags &= ~F_APENDING;
  }
  x.z = flags & ~(F_TRYING | F_ATRYING);
  return step + 1 < SK_PROBE ? sock_bid(io, i, k, x, step + 1, g) : x.z;
}

// The claim words a listed row's step may have taken back to
// CLAIM_FREE (every bidder of a word writes the same value; a word
// nobody bid on is free already).
__device__ __forceinline__ void sock_clear(const SockIO& io, uint4 x,
                                           int step) {
  fclaim(io, step)[flow_slot(io, x.x, step)] = SK_CLAIM_FREE;
  pclaim(io, step)[pin_slot(io, x.w, step)] = SK_CLAIM_FREE;
}

__device__ __forceinline__ bool pending(uint32_t flags) {
  return flags & (F_PENDING | F_APENDING);
}

// The connect path's resolution of miss i whose frontend is `svc` (-1:
// none): the Maglev pick, the affinity pin read (the pins as the batch
// found them: they change only in the claim steps), its flags and out
// row; when `claim` (the misses number at most SK_CONNECT_CAP) the flow
// slot and pin it will claim.  -> whether it has one to claim.
__device__ bool sock_resolve_row(const SockIO& io, const LbView& t,
                                 int32_t i, int32_t svc, uint4 a, uint4 b,
                                 uint4 c, uint4 d, uint4 k, uint4 x,
                                 bool claim) {
  const int32_t be = lb_pick(t.maglev, t.m, svc,
                             lb_hash4(a.w, c.x, b.w, c.y, c.z));
  const bool is_svc = be >= 0, no_be = svc >= 0 && be < 0;
  const uint32_t aff_ttl = svc >= 0 ? __ldg(&t.svc_aff[svc]) : 0u;
  uint32_t be_ip = 0, be_port = SK_NO_BACKEND;
  if (is_svc) {
    be_ip = __ldg(&t.backend_ip[be]);
    be_port = __ldg(&t.backend_port[be]);
  }
  x.w = 0;
  if (is_svc && aff_ttl) {
    // a live (client, frontend) pin overrides Maglev: the window's first,
    // its rows loaded before any compare
    x.w = fnv4(k.x, k.z, k.w, SK_AFF_SALT);
    uint4 p0[SK_PROBE], p1[SK_PROBE];
#pragma unroll
    for (int step = 0; step < SK_PROBE; ++step) {
      const uint32_t* r = io.aff + (size_t)pin_slot(io, x.w, step) * 8;
      p0[step] = ldcg4(r);
      p1[step] = ldcg4(r + 4);
    }
#pragma unroll
    for (int step = SK_PROBE - 1; step >= 0; --step) {
      if (p0[step].x == k.x && p0[step].y == k.z && p0[step].z == k.w &&
          p1[step].y >= io.now) {
        be_ip = p0[step].w;
        be_port = p1[step].x;
      }
    }
  }
  if (claim) {
    // no_backend rows never claim a slot; affinity service rows claim
    // (or refresh) their pin
    x.z |= (no_be ? 0u : F_PENDING) | (is_svc && aff_ttl ? F_APENDING : 0u);
  }
  *aux0(io, i) = x;
  *aux1(io, i) = make_uint4(be_ip, be_port, aff_ttl, 0u);
  sock_out(io, i, a, b, c, d, is_svc, be_ip, be_port, no_be);
  return pending(x.z);
}

// The batch position of miss j: the entry of its block's segment of
// io.list, found through the blocks' exclusive prefix of miss counts.
__device__ __forceinline__ int32_t miss_row(const SockIO& io,
                                            const uint32_t* pre, int32_t j) {
  int lo = 0, hi = (int)gridDim.x - 1;  // the last block with pre <= j
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pre[mid] <= (uint32_t)j) lo = mid;
    else hi = mid - 1;
  }
  return __ldcg(&io.list[(size_t)lo * io.rows_a_thread * SK_TPB +
                         (j - (int32_t)pre[lo])]);
}

// The `cnt` misses resolved: warp w takes misses [w * kk, w * kk + kk),
// the next chunk a grid of warps later, kk the fewest (at most 32) that
// cover them in one pass.  The warp finds each miss's frontend over the
// block's staged addresses, then each lane resolves its own miss; rows
// with something to claim are listed in plist(0), counted in counts[0]
// (one atomicAdd a block).
__device__ void sock_resolve(const SockIO& io, const LbView& t,
                             const uint32_t* pre, uint32_t* fe_ip,
                             uint32_t* fe_pp, int32_t* fe_index,
                             uint32_t* sh, int32_t cnt, Stamps& st) {
  const int lane = threadIdx.x & 31;
  const int32_t warps = (int32_t)gridDim.x * SK_WARPS;
  const int32_t kk = min(32, max(1, (cnt + warps - 1) / warps));
  const int32_t first = (int32_t)blockIdx.x * SK_WARPS * kk;
  if (first >= cnt) return;  // none here (block-uniform)
  const int staged = min(t.s, SK_STAGE);
  // with SK_INDEX_FROM or more misses a warp, and every staged port
  // packing, the index finds a miss's frontend a lane a miss (building it
  // costs a block a few us); else the warp scans the staged addresses for
  // each of its misses
  const bool indexed =
      lb_stage4<SK_STAGE / SK_TPB>(t, fe_ip, fe_pp, staged) &&
      kk >= SK_INDEX_FROM;
  if (indexed) lb_index4(fe_ip, fe_pp, fe_index, staged);
  st.mark();
  const bool claim = cnt <= SK_CONNECT_CAP;
  // trip counts are block-uniform: every thread reaches block_append
  for (int32_t jb = first; jb < cnt; jb += warps * kk) {
    const int32_t j0 = jb + (threadIdx.x >> 5) * kk;
    const int32_t j = j0 + lane;
    const bool have = lane < kk && j < cnt;
    const int32_t i = have ? miss_row(io, pre, j) : 0;
    uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a, c = a, d = a, k = a, x = a;
    if (have) {
      a = row_part(io.rows, i, 0);
      b = row_part(io.rows, i, 1);
      c = row_part(io.rows, i, 2);
      d = row_part(io.rows, i, 3);
      k = __ldcg(key_of(io, i));
      x = __ldcg(aux0(io, i));
    }
    st.mark();
    int32_t svc = -1;
    if (indexed) {
      if (have)
        svc = lb_lookup4(t, fe_ip, fe_pp, fe_index, staged, b.w, c.y, c.z);
    } else {
      const int m_end = max(0, min(kk, cnt - j0));
      for (int m = 0; m < m_end; ++m) {
        const uint32_t dst = __shfl_sync(0xFFFFFFFFu, b.w, m);
        const uint32_t dport = __shfl_sync(0xFFFFFFFFu, c.y, m);
        const uint32_t proto = __shfl_sync(0xFFFFFFFFu, c.z, m);
        const int32_t f = lb_match4_staged(t, fe_ip, staged, dst, dport,
                                           proto);
        if (lane == m) svc = f;
      }
    }
    st.mark();
    const bool pend = have && sock_resolve_row(io, t, i, svc, a, b, c, d, k,
                                               x, claim);
    st.mark();
    block_append(pend, i, &io.meta[M_PEND], io.plist, nullptr, sh);
  }
}

// The grid's steps over a listed row i: its bids for step 0; step s's
// verdicts with step s + 1's bids (-> still pending); its step's words
// cleared.
__device__ __forceinline__ void sock_bid0_row(const SockIO& io, int32_t i) {
  io.aux[(size_t)i * 8 + 2] =
      sock_bid0(io, i, __ldcg(key_of(io, i)), __ldcg(aux0(io, i)));
}

// Whether none of a flow-pending row's window slots from `from` on is
// claimable as the table stands (read while other rows may be writing
// it: a write leaves a live row of its writer's key, so a slot read as
// not claimable stays so, and a slot read mid-write as claimable only
// keeps the row).  With no flow expiry able to wrap past 2^32 in this
// call, such a row can never bid for a flow slot again: every write
// leaves a live row, and one of its own key only where it bids itself.
__device__ __forceinline__ bool flow_dead(const SockIO& io, uint4 k,
                                          uint32_t h, int from) {
  bool any = false;
#pragma unroll
  for (int step = 2; step < SK_PROBE; ++step) {
    if (step < from) continue;
    const uint32_t* r = io.table + (size_t)flow_slot(io, h, step) * 8;
    const uint4 r0 = ldcg4(r), r1 = ldcg4(r + 4);
    any |= r1.z < io.now || keys_equal(r0, k);
  }
  return !any;
}

// -> 1: still pending, 0: done, -1: dead at step 1 (a flow it cannot
// claim, no pin to claim: it stays uncached, as after the last step)
__device__ __forceinline__ int sock_step_row(const SockIO& io, int32_t i,
                                             int step, bool no_wrap) {
  const uint4 k = __ldcg(key_of(io, i)), x = __ldcg(aux0(io, i)),
              y = __ldcg(aux1(io, i));
  const bool next = step + 1 < SK_PROBE;
  SockStep g = sock_gather(io, x, step, next);
  sock_gather2(io, i, x, g);
  const uint32_t z = sock_step(io, i, k, x, y, step, g);
  io.aux[(size_t)i * 8 + 2] = z;
  if (!pending(z)) return 0;
  if (step == 1 && no_wrap &&
      (z & (F_PENDING | F_APENDING | F_TRYING)) == F_PENDING &&
      flow_dead(io, k, x.x, step + 2))
    return -1;
  return 1;
}

__device__ __forceinline__ void sock_clear_row(const SockIO& io, int32_t i,
                                               int step) {
  sock_clear(io, __ldcg(aux0(io, i)), step);
}

// Whether any slot of the 8-slot window from hash h is claimable by
// key k, as the flow table (`pins` false) or the pins hold it: expired,
// or holding the key.  The window is loaded before any compare.
__device__ __forceinline__ bool window_claimable(const SockIO& io, uint32_t h,
                                                 uint4 k, bool pins) {
  uint4 r0[SK_PROBE], r1[SK_PROBE];
#pragma unroll
  for (int step = 0; step < SK_PROBE; ++step) {
    const uint32_t* r =
        pins ? io.aff + (size_t)pin_slot(io, h, step) * 8
             : io.table + (size_t)flow_slot(io, h, step) * 8;
    r0[step] = ldcg4(r);
    r1[step] = ldcg4(r + 4);
  }
  bool any = false;
#pragma unroll
  for (int step = 0; step < SK_PROBE; ++step)
    any |= pins ? (r1[step].y < io.now || pins_equal(
                       make_uint4(r0[step].x, 0u, r0[step].y, r0[step].z), k))
                : (r1[step].z < io.now || keys_equal(r0[step], k));
  return any;
}

// Steps s0.. for the `nr` rows of `rows` (at most SK_TAIL_MAX), by one
// block: SK_TAIL_ROWS rows a thread in registers, their words gathered
// together, a __syncthreads where a grid barrier stood.  `bid_first`:
// the rows have not bid for step s0 yet (s0 is 0); else step s0 - 1's
// words are clear.  From step 0, a table (the flows' or the pins') in
// which no pending row's window holds a claimable slot is idle: nothing
// can bid there, so nothing is written there, in any step; once only
// idle rows are pending, the steps left change nothing and are not run
// (their counts are the rows still pending).  Every claim word is free
// when it returns.
__device__ void sock_tail(const SockIO& io, const int32_t* rows, int32_t nr,
                          int s0, bool bid_first, Stamps& st) {
  int32_t i[SK_TAIL_ROWS];
  uint4 k[SK_TAIL_ROWS], x[SK_TAIL_ROWS], y[SK_TAIL_ROWS];
  bool mine[SK_TAIL_ROWS];
#pragma unroll
  for (int q = 0; q < SK_TAIL_ROWS; ++q) {
    const int32_t j = q * SK_TPB + threadIdx.x;
    mine[q] = j < nr;
    i[q] = mine[q] ? __ldcg(&rows[j]) : 0;
    k[q] = x[q] = y[q] = make_uint4(0u, 0u, 0u, 0u);
    if (mine[q]) {
      k[q] = __ldcg(key_of(io, i[q]));
      x[q] = __ldcg(aux0(io, i[q]));
      y[q] = __ldcg(aux1(io, i[q]));
    }
  }
  uint32_t idle = 0u;  // the pending bits of idle tables
  if (bid_first) {
    bool flows = false, pins = false;
#pragma unroll 1
    for (int q = 0; q < SK_TAIL_ROWS; ++q) {
      if (!mine[q]) continue;
      if (x[q].z & F_PENDING) flows |= window_claimable(io, x[q].x, k[q], false);
      if (x[q].z & F_APENDING) pins |= window_claimable(io, x[q].w, k[q], true);
    }
    idle = (__syncthreads_or(flows) ? 0u : F_PENDING) |
           (__syncthreads_or(pins) ? 0u : F_APENDING);
#pragma unroll
    for (int q = 0; q < SK_TAIL_ROWS; ++q) {
      if (!mine[q]) continue;
      uint4 xm = x[q];
      xm.z &= ~idle;
      x[q].z = sock_bid0(io, i[q], k[q], xm) | (x[q].z & idle);
    }
  }
  __syncthreads();  // step s0's bids are in
  st.mark();
  for (int s = s0;; ++s) {
    const bool last = s + 1 == SK_PROBE;
    SockStep g[SK_TAIL_ROWS];
    // every row's loads before any row's stores: two rounds of loads
#pragma unroll
    for (int q = 0; q < SK_TAIL_ROWS; ++q) {
      uint4 xm = x[q];
      xm.z &= ~idle;
      if (mine[q] && pending(xm.z)) g[q] = sock_gather(io, xm, s, !last);
    }
#pragma unroll
    for (int q = 0; q < SK_TAIL_ROWS; ++q) {
      uint4 xm = x[q];
      xm.z &= ~idle;
      if (mine[q] && pending(xm.z)) sock_gather2(io, i[q], xm, g[q]);
    }
#pragma unroll
    for (int q = 0; q < SK_TAIL_ROWS; ++q) {
      // step s - 1's words: read by every bidder before the barrier
      if (mine[q] && s > s0) sock_clear(io, x[q], s - 1);
      uint4 xm = x[q];
      xm.z &= ~idle;
      if (mine[q] && pending(xm.z))
        x[q].z = sock_step(io, i[q], k[q], xm, y[q], s, g[q]) |
                 (x[q].z & idle);
    }
    int left = 0, active = 0;
#pragma unroll
    for (int q = 0; q < SK_TAIL_ROWS; ++q) {
      if (q * SK_TPB >= nr) break;  // block-uniform
      left += __syncthreads_count(mine[q] && pending(x[q].z));
      if (idle)
        active += __syncthreads_count(mine[q] && pending(x[q].z & ~idle));
    }
    if (!idle) active = left;
    st.mark();
    if (active == 0 || last) {
      if (threadIdx.x == 0) {
        for (int r = s + 1; r < SK_PROBE; ++r)
          io.meta[M_PEND + r] = (uint32_t)left;
        // the rows left uncached add to those the grid found dead
        atomicAdd(&io.meta[M_PEND + SK_PROBE], (uint32_t)left);
      }
#pragma unroll
      for (int q = 0; q < SK_TAIL_ROWS; ++q)
        if (mine[q]) sock_clear(io, x[q], s);
      return;
    }
    if (threadIdx.x == 0) io.meta[M_PEND + s + 1] = (uint32_t)left;
  }
}

// Exclusive prefix of the blocks' miss counts into pre[0..gridDim] (four
// blocks a thread, SK_MAX_BLOCKS at most); every thread calls.
__device__ void block_prefix(const SockIO& io, uint32_t* pre) {
  __shared__ uint32_t warp_sums[SK_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t v[4], sum = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int b = 4 * threadIdx.x + q;
    v[q] = b < (int)gridDim.x ? __ldcg(&io.meta[M_WORDS + 2 * b + 1]) : 0u;
    sum += v[q];
  }
  uint32_t x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  uint32_t before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  uint32_t run = before + x - sum;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int b = 4 * threadIdx.x + q;
    if (b <= (int)gridDim.x) pre[b] = run;
    run += v[q];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(SK_TPB)
    socklb_kernel(SockIO io, LbView t) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) uint32_t dyn[];
  uint32_t* fe_ip = dyn;
  uint32_t* fe_pp = dyn + SK_STAGE;
  int32_t* fe_index = reinterpret_cast<int32_t*>(dyn + 2 * SK_STAGE);
  __shared__ uint32_t pre[SK_MAX_BLOCKS + 1];
  __shared__ uint32_t s_misses, sh[2];
  const int32_t first = blockIdx.x * SK_TPB, stride = gridDim.x * SK_TPB;
  const int32_t tid = first + threadIdx.x;
  const int32_t base = blockIdx.x * io.rows_a_thread * SK_TPB;
  uint32_t* counts = io.meta + M_PEND;
  // the list of rows pending entering step s
  auto plist = [&io](int s) { return io.plist + (size_t)(s % 3) * io.n; };

  // the counters, read after the first barrier
  if (tid < STAMP_AT - 1) io.meta[tid] = 0u;
  Stamps st{io.meta, 0};
  st.mark();
  sock_probe_block(io, false, &s_misses);
  grid.sync();
  st.mark();

  int ovf = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += SK_TPB)
    ovf |= (int)__ldcg(&io.meta[M_WORDS + 2 * b]);
  if (__syncthreads_or(ovf)) {
    // a miss overflowed its candidates: every refresh bid withdrawn,
    // every row probed over its whole window and relisted, then the
    // bids made again
    for (int r = 0; r < io.rows_a_thread; ++r) {
      const int32_t i = base + r * SK_TPB + threadIdx.x;
      if (i >= io.n) continue;
      const uint4 x = __ldcg(aux0(io, i));
      if (x.z & F_CACHED) io.claim[x.y] = SK_CLAIM_FREE;
    }
    grid.sync();
    sock_probe_block(io, true, &s_misses);
    grid.sync();
    st.mark();
  }
  // every block reads the same words after a barrier, so every branch on
  // them below is taken by the whole grid
  block_prefix(io, pre);
  const int32_t cnt = (int32_t)pre[gridDim.x];
  if (tid == 0) io.meta[M_MISSES] = (uint32_t)cnt;
  for (int r = 0; r < io.rows_a_thread; ++r) {
    const int32_t i = base + r * SK_TPB + threadIdx.x;
    if (i < io.n) sock_refresh_row(io, i);
  }
  if (cnt == 0) return st.mark();
  st.mark();
  sock_resolve(io, t, pre, fe_ip, fe_pp, fe_index, sh, cnt, st);
  if (cnt > SK_CONNECT_CAP) return st.mark();
  grid.sync();
  st.mark();

  const int32_t np = (int32_t)__ldcg(&counts[0]);
  if (np == 0) return;
  int s0 = 0;  // the step from which one block finishes
  bool bid_first = true;
  // no flow expiry this call writes can wrap past 2^32
  const bool no_wrap = io.now <= 0xFFFFFFFFu - SK_LIFETIME_TCP;
  if (np > SK_TAIL_MAX) {
    bid_first = false;
    for (int32_t j = tid; j < np; j += stride)
      sock_bid0_row(io, __ldcg(&plist(0)[j]));
    grid.sync();  // step 0's bids are in
    st.mark();
    for (int s = 0;; ++s) {
      const int32_t nr = (int32_t)__ldcg(&counts[s]);
      const int32_t* cur = plist(s);
      const bool last = s + 1 == SK_PROBE;
      if (s > 0) {
        // step s - 1's words, read by every bidder before the barrier
        const int32_t np0 = (int32_t)__ldcg(&counts[s - 1]);
        for (int32_t j = tid; j < np0; j += stride)
          sock_clear_row(io, __ldcg(&plist(s - 1)[j]), s - 1);
      }
      // step s's verdicts and, in the same phase, step s + 1's bids (a
      // row dead at step 1 leaves the steps: it stays uncached, as after
      // the last);
      // trip counts are block-uniform, so every thread reaches the append
      for (int32_t b = first; b < nr; b += stride) {
        const int32_t j = b + threadIdx.x;
        const int32_t i = j < nr ? __ldcg(&cur[j]) : -1;
        const int r = i >= 0 ? sock_step_row(io, i, s, no_wrap) : 0;
        block_append(r > 0, i, &counts[s + 1],
                     last ? nullptr : plist(s + 1), nullptr, sh);
        block_count(r < 0, &counts[SK_PROBE], nullptr);
      }
      grid.sync();  // its verdicts and step s + 1's bids are in
      st.mark();
      const int32_t left = (int32_t)__ldcg(&counts[s + 1]);
      const bool stop = left == 0 || last;
      if (stop || left <= SK_TAIL_MAX) {
        for (int32_t j = tid; j < nr; j += stride)
          sock_clear_row(io, __ldcg(&cur[j]), s);
        if (stop) return st.mark();
        s0 = s + 1;
        grid.sync();  // step s's words clear before one block goes on
        st.mark();
        break;
      }
    }
  }
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) io.meta[M_TAIL] = (uint32_t)s0 + 1u;
    sock_tail(io, plist(s0), (int32_t)__ldcg(&counts[s0]), s0, bid_first,
              st);
    st.mark();
  }
}

// The most blocks of socklb_kernel a launch takes on device `dev`:
// co-resident ones, at most SK_BLOCKS_PER_SM an SM (0: none fit).
int sock_max_blocks(int dev) {
  static int cached[64];
  if (dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaFuncSetAttribute(socklb_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SK_DYN_BYTES);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, socklb_kernel,
                                                  SK_TPB, SK_DYN_BYTES);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = min(per_sm, SK_BLOCKS_PER_SM) * sms;
  }
  return cached[dev];
}

}  // namespace

extern "C" int socklb_stage_launch(const SockIO* iop, const LbView* tp,
                                   cudaStream_t stream) {
  SockIO io = *iop;
  LbView t = *tp;
  if (io.n <= 0) return (int)cudaGetLastError();
  int dev = 0;
  cudaGetDevice(&dev);
  // pre[] holds a prefix entry for each block and one past them
  const int most = min(sock_max_blocks(dev),
                       min(io.blocks_cap, SK_MAX_BLOCKS - 1));
  if (most <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  // every co-resident block (the misses are resolved a warp each), R
  // rows a thread the fewest that cover the batch
  io.rows_a_thread = (int32_t)(((int64_t)io.n + (int64_t)most * SK_TPB - 1) /
                               ((int64_t)most * SK_TPB));
  void* args[] = {&io, &t};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(socklb_kernel), dim3(most), dim3(SK_TPB), args,
      SK_DYN_BYTES, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" size_t socklb_abi_size(int which) {
  switch (which) {
    case 0: return sizeof(LbView);
    case 1: return sizeof(SockIO);
    default: return 0;
  }
}
