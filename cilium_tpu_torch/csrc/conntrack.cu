// K3 ct_lookup_kernel and K4 ct_update.
//
// K3 replaces cilium_tpu/datapath/conntrack.py ct_lookup (:288), the
// jitted ct_lookup_jit.  On the serving path the same device functions
// (conntrack.cuh) run inside datapath_kernel; this launcher serves the
// module-level datapath/conntrack.py ct_lookup.
//
// K4 replaces conntrack.py ct_update (:322-438): a fixed sequence of
// launches on one stream, never a host sync.
// Bound: latency of scattered 68 B row reads and writes into the 68 MB
// table, and on the insert side the launches themselves: the claim runs
// 20 lockstep rounds whether or not a row is still pending.
// Design:
// - refresh: (a) every hit row computes its upgraded state from the
//   table as it stood, (b) atomicMax into the state word (upgrades are
//   monotone, so the max is the sequential result) and atomicMax its
//   row index into the slot's claim word, (c) every hit row atomicAdds
//   its packet and byte counters (u32, wrapping at 2^32) and the
//   highest row writes the expiry from the post-max state.  Rows of one
//   slot agree on the expiry unless a forged protocol number (> 255)
//   aliases the key's proto|dir word; then the highest row's value
//   stands, as XLA's scatter leaves it on the reference;
// - insert: candidate slots come from the fingerprint window BEFORE
//   any claim; pending rows are compacted into a list so the rounds
//   touch only them.  4 candidate rounds then 16 full-window rounds, in
//   lockstep across the batch: rows judge `claimable` against the table
//   as the previous round left it, atomicMax their row index into a
//   per-slot claim word, the highest index writes its whole row (XLA's
//   scatter order on the reference: the last duplicate wins), and every
//   row whose key the slot then holds has won and sets the fingerprint.
//   Claim words alternate between two arrays by round parity, so one
//   kernel verifies round r (clearing its words) and tries round r+1.
//   Every claim word a call sets is back at -1 when it ends (the
//   refresh's in ct_insert_prep, each round's in its verify), so the
//   claim array lives with the table and is set to -1 only once.
//
// K7 ct_gc replaces conntrack.py ct_gc (:441), the CT aging sweep:
// every live slot whose expiry lies before `now` (an UNSIGNED compare:
// expiries at or above 2^31 are late, not early) becomes free, state
// and fingerprint zeroed, and the evictions are counted.
// Bound: bytes.  Each slot's state and expiry words (8 B, one 32 B
// sector of its 68 B row) are read; an expired slot writes its state
// and fingerprint.  Design: one thread per slot, rewriting in place; a
// warp ballot and a block sum leave one atomicAdd per block.
//
// K8 ct_occupied replaces loader.py _ct_occupied (:76), the map-
// pressure sample: the count of slots whose fingerprint is not 0.
// Bound: bytes, the 4 B fingerprint of every slot.  Design: a grid of a
// few blocks per SM strides over the slots, counting in registers, then
// a warp and block sum and one atomicAdd per block.
#include "conntrack.cuh"

constexpr int N_ROUNDS = N_CAND_INS + N_PROBE;
constexpr int TPB = 256;

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

// --- refresh -----------------------------------------------------------

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

__global__ void ct_refresh_state(CtView ct, CtUpdateIO io) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  int32_t base;
  const CtView sv = row_shard(ct, io, i, &base);
  if (!ct_hit(sv, io, i)) return;
  uint32_t proto = io.l4[(size_t)i * 3], flags = io.l4[(size_t)i * 3 + 1];
  bool closing = proto == 6 && (flags & (TCP_FIN | TCP_RST)) != 0;
  uint32_t st = sv.table[(size_t)io.slot[i] * ROW_WORDS + V_STATE];
  if (io.is_reply[i] && st == ST_SYN_SENT) st = ST_ESTABLISHED;
  io.new_state[i] = closing ? ST_CLOSING : st;
}

// a claim word of round parity `parity` for the slice slot `s`
__device__ __forceinline__ int32_t* claim_word(const CtView& ct,
                                               const CtUpdateIO& io,
                                               int parity, int32_t base,
                                               int32_t s) {
  return &io.claim[(size_t)parity * ct.capacity + base + s];
}

// the refresh uses the parity-1 claim words; ct_insert_prep clears them
// before the insert rounds reach parity 1
__device__ __forceinline__ int32_t* refresh_claim(const CtView& ct,
                                                  const CtUpdateIO& io,
                                                  int32_t base, int32_t i) {
  return claim_word(ct, io, 1, base, io.slot[i]);
}

__global__ void ct_refresh_max(CtView ct, CtUpdateIO io) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  int32_t base;
  const CtView sv = row_shard(ct, io, i, &base);
  if (!ct_hit(sv, io, i)) return;
  atomicMax(&sv.table[(size_t)io.slot[i] * ROW_WORDS + V_STATE],
            io.new_state[i]);
  atomicMax(refresh_claim(ct, io, base, i), i);
}

__global__ void ct_refresh_rest(CtView ct, CtUpdateIO io) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  int32_t base;
  const CtView sv = row_shard(ct, io, i, &base);
  if (!ct_hit(sv, io, i)) return;
  uint32_t* row = sv.table + (size_t)io.slot[i] * ROW_WORDS;
  if (*refresh_claim(ct, io, base, i) == i) {
    bool is_tcp = io.l4[(size_t)i * 3] == 6;
    uint32_t st = row[V_STATE];
    uint32_t life = st == ST_CLOSING
                        ? LIFETIME_CLOSE
                        : (is_tcp ? (st >= ST_ESTABLISHED ? LIFETIME_TCP
                                                          : LIFETIME_SYN)
                                  : LIFETIME_NONTCP);
    row[V_EXPIRES] = io.now + life;
  }
  bool rep = io.is_reply[i];
  atomicAdd(&row[rep ? V_RX_PKTS : V_TX_PKTS], 1u);
  atomicAdd(&row[rep ? V_RX_BYTES : V_TX_BYTES], io.l4[(size_t)i * 3 + 2]);
}

// --- insert ------------------------------------------------------------

__global__ void ct_insert_prep(CtView ct, CtUpdateIO io) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  int32_t base;
  const CtView sv = row_shard(ct, io, i, &base);
  if (ct_hit(sv, io, i)) *refresh_claim(ct, io, base, i) = -1;
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
  // slots of the window, in window order
  uint32_t mask = (uint32_t)sv.capacity - 1u;
  int c = 0;
  for (int step = 0; step < N_PROBE && c < N_CAND_INS; ++step) {
    uint32_t s = (h + (uint32_t)step) & mask;
    uint32_t f = sv.fp[s];
    if (f == 0 || f == kfp) io.cand[(size_t)i * N_CAND_INS + c++] = (int32_t)s;
  }
  for (; c < N_CAND_INS; ++c) io.cand[(size_t)i * N_CAND_INS + c] = -1;
  io.plist[atomicAdd(io.npend, 1)] = i;
}

__device__ __forceinline__ bool key_eq(const uint32_t* row,
                                       const uint32_t* k) {
#pragma unroll
  for (int w = 0; w < KEY_WORDS; ++w)
    if (row[w] != k[w]) return false;
  return true;
}

// Verify round `rv` (rv >= 0) for every pending row, then try round
// `rt` (rt < N_ROUNDS) for the rows still pending.  After the last
// round (rt == N_ROUNDS) a row still pending is a dropped insert.
__global__ void ct_claim_verify_try(CtView ct, CtUpdateIO io, int rv,
                                    int rt) {
  int32_t np = *io.npend;
  for (int32_t j = blockIdx.x * blockDim.x + threadIdx.x; j < np;
       j += gridDim.x * blockDim.x) {
    int32_t i = io.plist[j];
    if (!io.pending[i]) continue;
    int32_t base;
    const CtView sv = row_shard(ct, io, i, &base);
    uint32_t mask = (uint32_t)sv.capacity - 1u;
    const uint32_t* k = io.fwd + (size_t)i * KEY_WORDS;
    if (rv >= 0) {
      int32_t s = io.try_slot[i];
      if (s >= 0) {
        *claim_word(ct, io, rv & 1, base, s) = -1;
        if (key_eq(sv.table + (size_t)s * ROW_WORDS, k)) {
          sv.fp[s] = io.key_fp[i];
          io.pending[i] = 0;
          continue;
        }
      }
    }
    if (rt >= N_ROUNDS) {
      atomicAdd(ct.dropped, 1u);
      continue;
    }
    int32_t s = rt < N_CAND_INS
                    ? io.cand[(size_t)i * N_CAND_INS + rt]
                    : (int32_t)((io.hash[i] + (uint32_t)(rt - N_CAND_INS)) &
                                mask);
    int32_t tried = -1;
    if (s >= 0) {
      const uint32_t* row = sv.table + (size_t)s * ROW_WORDS;
      if (row[V_STATE] == ST_FREE || row[V_EXPIRES] < io.now ||
          key_eq(row, k)) {
        tried = s;
        atomicMax(claim_word(ct, io, rt & 1, base, s), i);
      }
    }
    io.try_slot[i] = tried;
  }
}

// Round r's write: the highest row index trying a slot writes its row.
__global__ void ct_claim_write(CtView ct, CtUpdateIO io, int r) {
  int32_t np = *io.npend;
  for (int32_t j = blockIdx.x * blockDim.x + threadIdx.x; j < np;
       j += gridDim.x * blockDim.x) {
    int32_t i = io.plist[j];
    int32_t s = io.try_slot[i];
    if (!io.pending[i] || s < 0) continue;
    int32_t base;
    const CtView sv = row_shard(ct, io, i, &base);
    if (*claim_word(ct, io, r & 1, base, s) != i) continue;
    uint32_t* row = sv.table + (size_t)s * ROW_WORDS;
#pragma unroll
    for (int w = 0; w < KEY_WORDS; ++w)
      row[w] = io.fwd[(size_t)i * KEY_WORDS + w];
    bool is_tcp = io.l4[(size_t)i * 3] == 6;
    row[V_STATE] = is_tcp ? ST_SYN_SENT : ST_ESTABLISHED;
    row[V_EXPIRES] = io.now + (is_tcp ? LIFETIME_SYN : LIFETIME_NONTCP);
    row[V_TX_PKTS] = 1u;
    row[V_RX_PKTS] = 0u;
    row[V_TX_BYTES] = io.l4[(size_t)i * 3 + 2];
    row[V_RX_BYTES] = 0u;
    row[V_PROXY] = io.proxy_port[i];
  }
}

extern "C" int ct_update_launch(const CtView* ctp, const CtUpdateIO* iop,
                                cudaStream_t stream) {
  const CtView ct = *ctp;
  const CtUpdateIO io = *iop;
  if (io.n <= 0) return (int)cudaGetLastError();
  int blocks = (io.n + TPB - 1) / TPB;
  cudaMemsetAsync(io.npend, 0, sizeof(int32_t), stream);
  ct_refresh_state<<<blocks, TPB, 0, stream>>>(ct, io);
  ct_refresh_max<<<blocks, TPB, 0, stream>>>(ct, io);
  ct_refresh_rest<<<blocks, TPB, 0, stream>>>(ct, io);
  ct_insert_prep<<<blocks, TPB, 0, stream>>>(ct, io);
  // the rounds walk only the compacted pending rows: a grid of at most
  // a few blocks per SM, striding over the device-side count
  int rblocks = blocks < 1056 ? blocks : 1056;
  ct_claim_verify_try<<<rblocks, TPB, 0, stream>>>(ct, io, -1, 0);
  for (int r = 0; r < N_ROUNDS; ++r) {
    ct_claim_write<<<rblocks, TPB, 0, stream>>>(ct, io, r);
    ct_claim_verify_try<<<rblocks, TPB, 0, stream>>>(ct, io, r, r + 1);
  }
  return (int)cudaGetLastError();
}

// --- maintenance: aging sweep and occupancy ---------------------------

// Sum of one value per thread over a block of TPB threads; thread 0
// adds the block's total to *count (when not 0).
__device__ __forceinline__ void block_count_add(uint32_t v,
                                                uint32_t* count) {
  __shared__ uint32_t warp_sums[TPB / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < TPB / 32 ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v += __shfl_down_sync(0xFFFFFFFFu, v, o);
    }
    if (lane == 0 && v) atomicAdd(count, v);
  }
}

__global__ void __launch_bounds__(TPB) ct_gc_kernel(CtView ct, uint32_t now,
                                                    uint32_t* count) {
  int32_t i = blockIdx.x * TPB + threadIdx.x;
  bool expired = false;
  if (i < ct.capacity) {
    uint32_t* row = ct.table + (size_t)i * ROW_WORDS;
    expired = row[V_STATE] != ST_FREE && row[V_EXPIRES] < now;
    if (expired) {
      row[V_STATE] = ST_FREE;
      ct.fp[i] = 0;
    }
  }
  block_count_add(expired ? 1u : 0u, count);
}

__global__ void __launch_bounds__(TPB) ct_occupied_kernel(const uint32_t* fp,
                                                          int32_t n,
                                                          uint32_t* count) {
  uint32_t c = 0;
  for (int32_t i = blockIdx.x * TPB + threadIdx.x; i < n;
       i += gridDim.x * TPB) {
    c += fp[i] != 0 ? 1u : 0u;
  }
  block_count_add(c, count);
}

extern "C" int ct_gc_launch(const CtView* ctp, uint32_t now, uint32_t* count,
                            cudaStream_t stream) {
  const CtView ct = *ctp;
  cudaMemsetAsync(count, 0, sizeof(uint32_t), stream);
  if (ct.capacity > 0) {
    ct_gc_kernel<<<(ct.capacity + TPB - 1) / TPB, TPB, 0, stream>>>(ct, now,
                                                                   count);
  }
  return (int)cudaGetLastError();
}

extern "C" int ct_occupied_launch(const uint32_t* fp, int32_t n,
                                  uint32_t* count, cudaStream_t stream) {
  cudaMemsetAsync(count, 0, sizeof(uint32_t), stream);
  if (n > 0) {
    int blocks = (n + TPB - 1) / TPB;
    blocks = blocks < 132 * 8 ? blocks : 132 * 8;
    ct_occupied_kernel<<<blocks, TPB, 0, stream>>>(fp, n, count);
  }
  return (int)cudaGetLastError();
}

extern "C" size_t ct_abi_size(int which) {
  return which == 0 ? sizeof(CtView) : which == 1 ? sizeof(CtUpdateIO) : 0;
}
