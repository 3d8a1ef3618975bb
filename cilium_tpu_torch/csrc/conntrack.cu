// K3 ct_lookup_kernel and K4 ct_update.
//
// K3 replaces cilium_tpu/datapath/conntrack.py ct_lookup (:288), the
// jitted ct_lookup_jit.  On the serving path the same device functions
// (conntrack.cuh) run inside datapath_kernel; this launcher serves the
// module-level datapath/conntrack.py ct_lookup.
//
// K4 replaces conntrack.py ct_update (:322-438): ONE cooperative
// kernel a call (redesigned in PR 14; PRs 1-13 launched a memset and 45
// kernels, 41 of them insert rounds whether or not a row was pending).
// Bound: latency of scattered 68 B row reads, writes and atomics into
// the 68 MB table, a few dependent steps a phase, and the grid barriers
// between the phases (~1.1 us each on the H100, PERF.md PR 14).
// Design: a grid of min(ceil(n / 256), one block an SM) blocks strides
// over the rows (K4_BLOCKS_PER_SM); cooperative_groups grid barriers
// stand where the launches stood, so every phase sees the table as the
// one before left it:
// - phase 0 zeroes the round counters (this retires the memset); every
//   hit row upgrades its slot's state (a CAS loop: the upgrades are
//   monotone and commute under max, so the slot ends at the sequential
//   result, as the reference's scatter-max leaves it), atomicMaxes its
//   row index into the slot's claim word and atomicAdds its packet and
//   byte counters (u32, wrapping at 2^32); every pending insert computes
//   its hash, fingerprint and candidate slots from the fingerprint
//   window BEFORE any claim;
// - phase 1: the highest row of each hit slot writes the expiry from
//   the upgraded state (rows of one slot agree on it unless a forged
//   protocol number > 255 aliases the key's proto|dir word; then the
//   highest row's value stands, as XLA's scatter leaves it), and the
//   pending rows are compacted into a list (one atomicAdd a warp);
// - phase 2 clears the refresh's claim words and tries round 0; then
//   4 candidate rounds and 16 full-window rounds, in lockstep across
//   the batch, two barriers a round: rows judge `claimable` against the
//   table as the previous round left it and atomicMax their row index
//   into a per-slot claim word; after a barrier the highest index
//   writes its whole row (XLA's scatter order: the last duplicate
//   wins), and every row whose key equals the writer's has won and sets
//   the fingerprint.  The rows still pending are compacted into the
//   next round's list (one atomicAdd a warp), so a round walks only the
//   rows that entered it; after the next barrier every block reads the
//   list's length and, at 0, the rounds end for the whole grid at once.
//   Rounds with no pending row change nothing, so the result is the
//   20-round one (the plain version runs its full-window rounds only
//   while a row is pending); after the last round the rows still
//   pending are dropped inserts.  Once at most a block's worth of rows
//   is pending (256), one block finishes the rounds (tail_rounds: a row
//   a thread, __syncthreads for the grid barriers), so a row that never
//   finds a slot costs 2 block barriers a round, not 2 grid barriers
//   and their phases' dependent reads.
// Claim words alternate between two arrays by round parity: a round
// clears the previous round's words while it claims its own.  Every
// claim word a call sets is back at -1 when it ends, so the claim array
// lives with the table and is set to -1 only once.  Data that another
// block wrote in an earlier phase is read with ld.global.cg (L2), never
// from an SM's L1.  Scalars pass by value and nothing syncs the host,
// so the launch can be captured in a CUDA graph.
//
// K7 ct_gc replaces conntrack.py ct_gc (:441), the CT aging sweep:
// every live slot whose expiry lies before `now` (an UNSIGNED compare:
// expiries at or above 2^31 are late, not early) becomes free, state
// and fingerprint zeroed, and the evictions are counted.
// Bound: bytes.  The fingerprints (4 B a slot, coalesced) and, for each
// live slot, its state and expiry words: 8 B of its 68 B row, whose
// 32 B sector (two for one row in eight) the card reads whole; an
// expired slot writes its state and fingerprint.
// Design.  A slot's fingerprint is 0 exactly when its state is ST_FREE:
// every CT writer keeps it so (ct_update and its kernel write a claimed
// slot's row and fingerprint together, the sweep zeroes both, restores
// and conversions derive the fingerprints from the states;
// tests/test_torch_maint.py checks each).  So the sweep reads each
// slot's fingerprint first (a slot a thread a step, coalesced) and, where
// it is not 0, the state and expiry of its row (two 32-bit loads: the
// pair is 8-byte aligned only on even rows), both before the compare.
// The state test stays: a slot with a fingerprint and a free state is
// not evicted.  Free slots cost their 4 fingerprint bytes.  The grid,
// GC_BLOCKS_PER_SM blocks an SM, strides over the table, so the rows in
// flight lie in one window that slides through it, as a thread a slot's
// did.  On the H100 (PERF.md) this was faster than each block or thread
// taking a contiguous chunk of several slots at once, which beat the old
// sweep on sparse tables but lost to it by up to 15% where every slot
// expires.  The count: a warp and block sum, one atomicAdd a block into
// the stream's scratch, then a last-block ticket (atomicInc wraps it to
// 0) whose block moves the sum into `count` and zeroes it: no memset,
// one graph node a call.
//
// K8 ct_occupied replaces loader.py _ct_occupied (:76), the map-
// pressure sample: the count of slots whose fingerprint is not 0.
// Bound: bytes, the 4 B fingerprint of every slot (4 MB at 2^20 slots, ~1.3 us
// at 3.35 TB/s).  Design: one kernel, one graph node a call (it was a memset
// and a fixed grid of 132 * 8 blocks).  A grid of at most OCC_BLOCKS_PER_SM
// blocks an SM (the SM count read from the device) strides over the
// fingerprints in 16 B loads (4 slots a load), OCC_LOADS loads a thread in
// flight before any is counted; a scalar head and tail cover a view that does
// not start on a 16 B boundary or whose length is not a multiple of 4.  Counts
// sum in registers, then over the warp and the block.  The blocks meet in one
// 64-bit word of the stream's scratch: each adds (1 << 32) | its count with
// one atomicAdd, and the block whose add returns blocks - 1 in the high word
// writes the low word plus its own count and zeroes the word (the stream's
// next launch starts after this one ends), so no memset and no fence.  A sum
// word with a ticket behind a fence (K7's), or a count a block summed by the
// last, cost ~1.3 us more on the H100: their dependent L2 round trips
// (PERF.md, the K8 redesign).
#include <cooperative_groups.h>

#include "conntrack.cuh"

namespace cg = cooperative_groups;

constexpr int TPB = 256;
constexpr int K4_TPB = 256;  // ct_update_kernel's block
// At most this many blocks of K4_TPB an SM: measured on the H100 (PERF.md,
// PR 14), a grid of one block an SM ran the 2^18-row batches 20-25%
// faster than the co-resident maximum (8 an SM) and the 4096-row one as
// fast: a block that waits at a grid barrier polls it while the others
// still work
constexpr int K4_BLOCKS_PER_SM = 1;
// K7: at most this many blocks of TPB an SM
constexpr int GC_BLOCKS_PER_SM = 8;
// K8: at most this many blocks of TPB an SM, and 16 B loads a thread in
// flight (measured on the H100: PERF.md, the K8 redesign)
constexpr int OCC_BLOCKS_PER_SM = 2;
constexpr int OCC_LOADS = 4;

__global__ void ct_lookup_kernel(CtView ct, const uint32_t* fwd,
                                 const uint32_t* rev, uint32_t now,
                                 int32_t* result, int32_t* slot,
                                 bool* is_reply, int32_t n) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t f[KEY_WORDS], r[KEY_WORDS];
#pragma unroll
  for (int w = 0; w < KEY_WORDS; ++w) {
    f[w] = fwd[(size_t)i * KEY_WORDS + w];
    r[w] = rev[(size_t)i * KEY_WORDS + w];
  }
  ct_lookup_row(ct, f, r, now, &result[i], &slot[i], &is_reply[i]);
}

extern "C" int ct_lookup_launch(const CtView* ct, const uint32_t* fwd,
                                const uint32_t* rev, uint32_t now,
                                int32_t* result, int32_t* slot,
                                bool* is_reply, int32_t n,
                                cudaStream_t stream) {
  if (n > 0) {
    ct_lookup_kernel<<<(n + TPB - 1) / TPB, TPB, 0, stream>>>(
        *ct, fwd, rev, now, result, slot, is_reply, n);
  }
  return (int)cudaGetLastError();
}

// --- ct_update ---------------------------------------------------------

// Sharded serving (P16a, cilium_tpu/parallel/mesh.py:259): every row
// works in its shard's CT slice (conntrack.cuh ct_shard).  Its slot,
// candidates and tried slot are local to the slice; a claim word is
// indexed by the global slot (base + local), so one [2, C] claim array
// and one pending list serve the whole routed batch: flows never cross
// shards and the slices are disjoint.  Row order within a shard is the
// same locally and globally, so "the highest row wins" is unchanged, and
// ct.dropped stays one counter, the sum of the per-shard deltas.
__device__ __forceinline__ CtView row_shard(const CtView& ct,
                                            const CtUpdateIO& io, int32_t i,
                                            int32_t* base) {
  return ct_shard(ct, io.n_shards, io.block, i, base);
}

__device__ __forceinline__ bool ct_hit(const CtView& sv,
                                       const CtUpdateIO& io, int32_t i) {
  int32_t s = io.slot[i];
  return io.result[i] != CT_NEW && (!io.valid || io.valid[i]) && s >= 0 &&
         s < sv.capacity;
}

// a claim word of round parity `parity` for the slice slot `s`
__device__ __forceinline__ int32_t* claim_word(const CtView& ct,
                                               const CtUpdateIO& io,
                                               int parity, int32_t base,
                                               int32_t s) {
  return &io.claim[(size_t)parity * ct.capacity + base + s];
}

// the refresh uses the parity-1 claim words; phase 3 clears them
// before round 1 claims with that parity
__device__ __forceinline__ int32_t* refresh_claim(const CtView& ct,
                                                  const CtUpdateIO& io,
                                                  int32_t base, int32_t i) {
  return claim_word(ct, io, 1, base, io.slot[i]);
}

__device__ __forceinline__ bool key_eq(const uint32_t* row,
                                       const uint32_t* k) {
#pragma unroll
  for (int w = 0; w < KEY_WORDS; ++w)
    if (__ldcg(&row[w]) != k[w]) return false;
  return true;
}

// Phase 0 for row i.  A hit upgrades its slot's state, claims the slot
// for the expiry write with its row index and adds its counters.  The
// state goes up by a CAS loop that applies the row's transition to the
// state as it finds it: the transitions are monotone (SYN_SENT <
// ESTABLISHED < CLOSING) and commute under max, so in any order the
// slot ends at the max over its rows of each one's upgrade of the state
// as it stood, the sequential result (and the reference's).  A pending
// insert computes its hash, fingerprint and candidate slots.
__device__ void refresh_and_prep(const CtView& ct, const CtUpdateIO& io,
                                 int32_t i) {
  int32_t base;
  const CtView sv = row_shard(ct, io, i, &base);
  if (ct_hit(sv, io, i)) {
    const uint32_t proto = io.l4[(size_t)i * 3];
    const uint32_t flags = io.l4[(size_t)i * 3 + 1];
    const bool closing = proto == 6 && (flags & (TCP_FIN | TCP_RST)) != 0;
    const bool rep = io.is_reply[i];
    uint32_t* row = sv.table + (size_t)io.slot[i] * ROW_WORDS;
    uint32_t cur = __ldcg(&row[V_STATE]);
    for (;;) {
      const uint32_t up = closing ? ST_CLOSING
                          : rep && cur == ST_SYN_SENT ? ST_ESTABLISHED
                                                      : cur;
      if (up <= cur) break;
      const uint32_t seen = atomicCAS(&row[V_STATE], cur, up);
      if (seen == cur) break;
      cur = seen;
    }
    atomicMax(refresh_claim(ct, io, base, i), i);
    atomicAdd(&row[rep ? V_RX_PKTS : V_TX_PKTS], 1u);
    atomicAdd(&row[rep ? V_RX_BYTES : V_TX_BYTES], io.l4[(size_t)i * 3 + 2]);
  }
  bool pend = io.do_create[i] && io.result[i] == CT_NEW &&
              (!io.valid || io.valid[i]);
  io.pending[i] = pend;
  io.try_slot[i] = -1;
  if (!pend) return;
  uint32_t k[KEY_WORDS];
#pragma unroll
  for (int w = 0; w < KEY_WORDS; ++w) k[w] = io.fwd[(size_t)i * KEY_WORDS + w];
  uint32_t h = ct_hash(k), kfp = ct_fp_mix(h);
  io.hash[i] = h;
  io.key_fp[i] = kfp;
  // candidates: the first N_CAND_INS free (fp 0) or same-fingerprint
  // slots of the window, in window order (the window loaded whole)
  uint32_t mask = (uint32_t)sv.capacity - 1u;
  uint32_t m = ct_fp_mask<false>(sv.fp, (uint32_t)sv.capacity, h & mask,
                                 [kfp](uint32_t f) {
                                   return f == 0 || f == kfp;
                                 });
#pragma unroll
  for (int c = 0; c < N_CAND_INS; ++c) {
    io.cand[(size_t)i * N_CAND_INS + c] =
        m ? (int32_t)((h + (uint32_t)(__ffs(m) - 1)) & mask) : -1;
    m &= m - 1u;
  }
}

// Phase 1 for a hit row i: the slot's highest row writes the expiry from
// the upgraded state.  Rows of one slot agree on it unless a forged
// protocol number (> 255) aliases the key's proto|dir word; then the
// highest row's value stands, as XLA's scatter leaves it.
__device__ void refresh_expiry(const CtView& ct, const CtUpdateIO& io,
                               int32_t i) {
  int32_t base;
  const CtView sv = row_shard(ct, io, i, &base);
  if (!ct_hit(sv, io, i)) return;
  uint32_t* row = sv.table + (size_t)io.slot[i] * ROW_WORDS;
  const int32_t last = __ldcg(refresh_claim(ct, io, base, i));
  const uint32_t st = __ldcg(&row[V_STATE]);
  if (last != i) return;
  bool is_tcp = io.l4[(size_t)i * 3] == 6;
  uint32_t life = st == ST_CLOSING
                      ? LIFETIME_CLOSE
                      : (is_tcp ? (st >= ST_ESTABLISHED ? LIFETIME_TCP
                                                        : LIFETIME_SYN)
                                : LIFETIME_NONTCP);
  row[V_EXPIRES] = io.now + life;
}

// A slot a pending insert may claim: free, expired, or holding its key
// (the table as the previous round left it).
__device__ __forceinline__ bool claimable(const uint32_t* row,
                                          const uint32_t* k, uint32_t now) {
  return __ldcg(&row[V_STATE]) == ST_FREE || __ldcg(&row[V_EXPIRES]) < now ||
         key_eq(row, k);
}

// Row i's new entry, written into its slice's slot s.
__device__ __forceinline__ void write_row(const CtView& sv,
                                          const CtUpdateIO& io, int32_t i,
                                          int32_t s) {
  const uint32_t* k = io.fwd + (size_t)i * KEY_WORDS;
  uint32_t* row = sv.table + (size_t)s * ROW_WORDS;
#pragma unroll
  for (int q = 0; q < KEY_WORDS; ++q) row[q] = k[q];
  bool is_tcp = io.l4[(size_t)i * 3] == 6;
  row[V_STATE] = is_tcp ? ST_SYN_SENT : ST_ESTABLISHED;
  row[V_EXPIRES] = io.now + (is_tcp ? LIFETIME_SYN : LIFETIME_NONTCP);
  row[V_TX_PKTS] = 1u;
  row[V_RX_PKTS] = 0u;
  row[V_TX_BYTES] = io.l4[(size_t)i * 3 + 2];
  row[V_RX_BYTES] = 0u;
  row[V_PROXY] = io.proxy_port[i];
}

// whether row w's key (the slot's writer) is row i's
__device__ __forceinline__ bool same_key(const CtUpdateIO& io, int32_t w,
                                         int32_t i) {
  const uint32_t* a = io.fwd + (size_t)w * KEY_WORDS;
  const uint32_t* b = io.fwd + (size_t)i * KEY_WORDS;
#pragma unroll
  for (int q = 0; q < KEY_WORDS; ++q)
    if (a[q] != b[q]) return false;
  return true;
}

// Round r's try for pending row i: the slot of the round (a candidate,
// then the window in order) if claimable; atomicMax of i into its claim
// word.
__device__ void try_round(const CtView& ct, const CtUpdateIO& io,
                          int32_t i, int r) {
  int32_t base;
  const CtView sv = row_shard(ct, io, i, &base);
  uint32_t mask = (uint32_t)sv.capacity - 1u;
  int32_t s = r < N_CAND_INS
                  ? __ldcg(&io.cand[(size_t)i * N_CAND_INS + r])
                  : (int32_t)((__ldcg(&io.hash[i]) +
                               (uint32_t)(r - N_CAND_INS)) & mask);
  int32_t tried = -1;
  if (s >= 0 && claimable(sv.table + (size_t)s * ROW_WORDS,
                          io.fwd + (size_t)i * KEY_WORDS, io.now)) {
    tried = s;
    atomicMax(claim_word(ct, io, r & 1, base, s), i);
  }
  io.try_slot[i] = tried;
}

// Round r's write and verdict for row i, pending entering the round:
// the highest row trying a slot writes its row; every row whose key
// equals the writer's has won.  -> 1 if row i is still pending after
// the round.
__device__ int write_and_verify(const CtView& ct, const CtUpdateIO& io,
                                int32_t i, int r) {
  int32_t s = __ldcg(&io.try_slot[i]);
  if (s < 0) return 1;
  int32_t base;
  const CtView sv = row_shard(ct, io, i, &base);
  int32_t w = __ldcg(claim_word(ct, io, r & 1, base, s));
  if (w == i) write_row(sv, io, i, s);
  if (!same_key(io, w, i)) return 1;
  sv.fp[s] = __ldcg(&io.key_fp[i]);
  io.pending[i] = 0;
  return 0;
}

// Row i's claim word of round r, for the slice slot s it tried (-1:
// none), back to -1 (after the barrier that ends the round's reads).
__device__ __forceinline__ void clear_claim(const CtView& ct,
                                            const CtUpdateIO& io, int32_t i,
                                            int r, int32_t s) {
  if (s < 0) return;
  int32_t base;
  row_shard(ct, io, i, &base);
  *claim_word(ct, io, r & 1, base, s) = -1;
}

// Appends the rows i of the warp's lanes that keep them to `list` (when
// not null) at one atomicAdd a warp on *count, which ends as the list's
// length, and adds their number to *also (when not null).  Every lane
// of the warp calls.
__device__ __forceinline__ void warp_append(bool keep, int32_t i,
                                            uint32_t* count, int32_t* list,
                                            uint32_t* also) {
  const unsigned m = __ballot_sync(0xFFFFFFFFu, keep);
  const int lane = threadIdx.x & 31;
  uint32_t at = 0;
  if (lane == 0 && m) {
    at = atomicAdd(count, (uint32_t)__popc(m));
    if (also) atomicAdd(also, (uint32_t)__popc(m));
  }
  at = __shfl_sync(0xFFFFFFFFu, at, 0);
  if (keep && list) list[at + __popc(m & ((1u << lane) - 1u))] = i;
}

// Rounds r0.. for the rows pending entering round r0 (`rows`, nr <=
// K4_TPB of them), by one block: a row a thread, its candidates in
// registers, __syncthreads where the grid barriers stood.  Every claim
// word is -1 when it starts and again when it returns.
__device__ void tail_rounds(const CtView& ct, const CtUpdateIO& io,
                            const int32_t* rows, int32_t nr, int r0,
                            uint32_t* counts) {
  const bool mine = (int32_t)threadIdx.x < nr;
  const int32_t i = mine ? __ldcg(&rows[threadIdx.x]) : 0;
  int32_t base;
  const CtView sv = row_shard(ct, io, i, &base);
  const uint32_t mask = (uint32_t)sv.capacity - 1u;
  int32_t cand[N_CAND_INS] = {-1, -1, -1, -1};
  uint32_t h = 0, kfp = 0;
  if (mine) {
#pragma unroll
    for (int c = 0; c < N_CAND_INS; ++c)
      cand[c] = __ldcg(&io.cand[(size_t)i * N_CAND_INS + c]);
    h = __ldcg(&io.hash[i]);
    kfp = __ldcg(&io.key_fp[i]);
  }
  bool pend = mine;
  for (int r = r0;; ++r) {
    int32_t s = -1;
    if (pend) {
      const int32_t c =
          r >= N_CAND_INS ? (int32_t)((h + (uint32_t)(r - N_CAND_INS)) & mask)
          : r == 0        ? cand[0]
          : r == 1        ? cand[1]
          : r == 2        ? cand[2]
                          : cand[3];
      if (c >= 0 && claimable(sv.table + (size_t)c * ROW_WORDS,
                              io.fwd + (size_t)i * KEY_WORDS, io.now)) {
        s = c;
        atomicMax(claim_word(ct, io, r & 1, base, s), i);
      }
    }
    __syncthreads();
    if (s >= 0) {
      const int32_t w = __ldcg(claim_word(ct, io, r & 1, base, s));
      if (w == i) write_row(sv, io, i, s);
      if (same_key(io, w, i)) {
        sv.fp[s] = kfp;
        io.pending[i] = 0;
        pend = false;
      }
    }
    const int still = __syncthreads_count(pend);
    if (s >= 0) *claim_word(ct, io, r & 1, base, s) = -1;
    const bool last = r + 1 == N_ROUNDS;
    if (threadIdx.x == 0) {
      counts[r + 1] = (uint32_t)still;
      if (last && still) atomicAdd(ct.dropped, (uint32_t)still);
    }
    if (still == 0 || last) return;
  }
}

__global__ void __launch_bounds__(K4_TPB)
    ct_update_kernel(CtView ct, CtUpdateIO io) {
  cg::grid_group grid = cg::this_grid();
  const int32_t first = blockIdx.x * K4_TPB, stride = gridDim.x * K4_TPB;
  const int32_t t = first + threadIdx.x;
  uint32_t* counts = reinterpret_cast<uint32_t*>(io.counts);
  // the rows pending entering round r: list(r), counts[r] long
  auto list = [&io](int r) { return io.plist + (size_t)(r & 1) * io.n; };

  if (t <= N_ROUNDS) counts[t] = 0u;
  for (int32_t i = t; i < io.n; i += stride) refresh_and_prep(ct, io, i);
  grid.sync();

  // trip counts are warp-uniform here and below, so every lane of a
  // warp reaches its ballot
  for (int32_t b = first; b < io.n; b += stride) {
    int32_t i = b + threadIdx.x;
    bool pend = false;
    if (i < io.n) {
      refresh_expiry(ct, io, i);
      pend = io.pending[i];
    }
    warp_append(pend, i, &counts[0], list(0), nullptr);
  }
  grid.sync();

  for (int32_t i = t; i < io.n; i += stride) {
    int32_t base;
    const CtView sv = row_shard(ct, io, i, &base);
    if (ct_hit(sv, io, i)) *refresh_claim(ct, io, base, i) = -1;
  }
  // every block reads the same counts after a barrier, so every branch
  // on them below is taken by the whole grid
  const int32_t np = (int32_t)__ldcg(&counts[0]);
  if (np == 0) return;
  int r0 = 0;  // the round from which one block finishes
  if (np > K4_TPB) {
    for (int32_t j = t; j < np; j += stride)
      try_round(ct, io, __ldcg(&list(0)[j]), 0);
    for (int r = 0;; ++r) {
      grid.sync();
      // round r's writes and verdicts over the rows that tried it; the
      // rows still pending form round r + 1's list
      const int32_t nr = (int32_t)__ldcg(&counts[r]);
      const int32_t* cur = list(r);
      const bool last = r + 1 == N_ROUNDS;
      for (int32_t b = first; b < nr; b += stride) {
        const int32_t j = b + threadIdx.x;
        const int32_t i = j < nr ? __ldcg(&cur[j]) : -1;
        const bool still = i >= 0 && write_and_verify(ct, io, i, r);
        warp_append(still, i, &counts[r + 1],
                    last ? nullptr : list(r + 1),
                    last ? ct.dropped : nullptr);
      }
      grid.sync();
      // round r's claim words back to -1; round r + 1's tries, unless
      // few enough rows are left for one block
      const uint32_t left = __ldcg(&counts[r + 1]);
      const bool stop = last || left == 0u;
      const bool tail = !stop && left <= (uint32_t)K4_TPB;
      for (int32_t j = t; j < nr; j += stride) {
        const int32_t i = __ldcg(&cur[j]);
        const int32_t tried = __ldcg(&io.try_slot[i]);
        const bool pend = !stop && !tail && __ldcg(&io.pending[i]);
        clear_claim(ct, io, i, r, tried);
        if (pend) try_round(ct, io, i, r + 1);
      }
      if (stop) return;
      if (tail) {
        r0 = r + 1;
        break;
      }
    }
  }
  grid.sync();  // every claim word -1 again
  if (blockIdx.x == 0)
    tail_rounds(ct, io, list(r0), (int32_t)__ldcg(&counts[r0]), r0, counts);
}

// The most blocks of ct_update_kernel a launch takes on device `dev`:
// co-resident ones, at most K4_BLOCKS_PER_SM an SM (0: none fit).
static int ct_update_max_blocks(int dev) {
  static int cached[64];
  if (dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ct_update_kernel,
                                                  K4_TPB, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] =
        (per_sm < K4_BLOCKS_PER_SM ? per_sm : K4_BLOCKS_PER_SM) * sms;
  }
  return cached[dev];
}

extern "C" int ct_update_launch(const CtView* ctp, const CtUpdateIO* iop,
                                cudaStream_t stream) {
  CtView ct = *ctp;
  CtUpdateIO io = *iop;
  if (io.n <= 0) return (int)cudaGetLastError();
  int dev = 0;
  cudaGetDevice(&dev);
  int blocks = (io.n + K4_TPB - 1) / K4_TPB, most = ct_update_max_blocks(dev);
  if (most <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (blocks > most) blocks = most;
  void* args[] = {&ct, &io};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(ct_update_kernel), dim3(blocks), dim3(K4_TPB),
      args, 0, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// --- maintenance: aging sweep and occupancy ---------------------------

// Sum of one value per thread over a block of TPB threads, at thread 0.
__device__ __forceinline__ uint32_t block_sum(uint32_t v) {
  __shared__ uint32_t warp_sums[TPB / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0u;
  if (warp == 0) {
    v = lane < TPB / 32 ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v += __shfl_down_sync(0xFFFFFFFFu, v, o);
    }
  }
  return v;
}

__global__ void __launch_bounds__(TPB)
    ct_gc_kernel(CtView ct, uint32_t now, uint32_t* count, uint32_t* sum) {
  uint32_t evicted = 0;
  for (int32_t i = blockIdx.x * TPB + threadIdx.x; i < ct.capacity;
       i += gridDim.x * TPB) {
    if (ct.fp[i] == 0u) continue;
    uint32_t* row = ct.table + (size_t)i * ROW_WORDS;
    const uint32_t state = row[V_STATE], expires = row[V_EXPIRES];
    if (state == ST_FREE || !(expires < now)) continue;
    row[V_STATE] = ST_FREE;
    ct.fp[i] = 0u;
    ++evicted;
  }
  // the blocks' sum, moved into `count` by the last block, which zeroes
  // it and the ticket (sum[1]) for the next launch on the stream
  const uint32_t total = block_sum(evicted);
  if (threadIdx.x == 0) {
    if (total) atomicAdd(sum, total);
    __threadfence();
    if (atomicInc(sum + 1, gridDim.x - 1) == gridDim.x - 1) {
      __threadfence();
      *count = atomicExch(sum, 0u);
    }
  }
}

// `meet`: one 64-bit word of the stream's scratch, zero between calls
__global__ void __launch_bounds__(TPB)
    ct_occupied_kernel(const uint32_t* fp, int32_t n, uint32_t* count,
                       unsigned long long* meet) {
  // slots before the first 16 B boundary, the 4-slot quads, the rest
  const int32_t head =
      min(n, (int32_t)(((16u - ((uintptr_t)fp & 15u)) & 15u) >> 2));
  const int32_t quads = (n - head) >> 2, rest = head + 4 * quads;
  const uint4* q = reinterpret_cast<const uint4*>(fp + head);
  const int32_t nth = gridDim.x * TPB;
  const int32_t tid = blockIdx.x * TPB + threadIdx.x;
  uint32_t c = 0;
  for (int32_t i = tid; i < quads; i += nth * OCC_LOADS) {
    uint4 v[OCC_LOADS];
#pragma unroll
    for (int k = 0; k < OCC_LOADS; ++k) {
      const int32_t j = i + k * nth;
      v[k] = j < quads ? q[j] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < OCC_LOADS; ++k) {
      c += (v[k].x != 0u) + (v[k].y != 0u) + (v[k].z != 0u) +
           (v[k].w != 0u);
    }
  }
  if (tid < head) c += fp[tid] != 0u;
  if (tid < n - rest) c += fp[rest + tid] != 0u;
  const uint32_t total = block_sum(c);
  if (threadIdx.x == 0) {
    // high word: the blocks that have added; low word: their count (at
    // most n < 2^31, so it never carries into the high word)
    const unsigned long long old =
        atomicAdd(meet, (1ull << 32) | (unsigned long long)total);
    if ((uint32_t)(old >> 32) == gridDim.x - 1) {
      *count = (uint32_t)old + total;
      *meet = 0ull;
    }
  }
}

extern "C" int ct_gc_launch(const CtView* ctp, uint32_t now, uint32_t* count,
                            uint32_t* sum, cudaStream_t stream) {
  const CtView ct = *ctp;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // a slot a thread, at least one block (its last block writes the
  // count), at most GC_BLOCKS_PER_SM an SM
  const int64_t want = ((int64_t)ct.capacity + TPB - 1) / TPB;
  const int most = GC_BLOCKS_PER_SM * sms;
  const int blocks = want < 1 ? 1 : (want < most ? (int)want : most);
  ct_gc_kernel<<<blocks, TPB, 0, stream>>>(ct, now, count, sum);
  return (int)cudaGetLastError();
}

extern "C" int ct_occupied_launch(const uint32_t* fp, int32_t n,
                                  uint32_t* count, unsigned long long* meet,
                                  cudaStream_t stream) {
  if (n < 0 || ((uintptr_t)fp & 3u) || ((uintptr_t)meet & 7u))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // OCC_LOADS quads a thread, at least one block (the last block writes
  // the count), at most OCC_BLOCKS_PER_SM an SM
  const int64_t want = ((int64_t)n / 4 + TPB * OCC_LOADS - 1) /
                       (TPB * OCC_LOADS);
  const int most = OCC_BLOCKS_PER_SM * sms;
  const int blocks = want < 1 ? 1 : (want < most ? (int)want : most);
  ct_occupied_kernel<<<blocks, TPB, 0, stream>>>(fp, n, count, meet);
  return (int)cudaGetLastError();
}

extern "C" size_t ct_abi_size(int which) {
  return which == 0 ? sizeof(CtView) : which == 1 ? sizeof(CtUpdateIO) : 0;
}
