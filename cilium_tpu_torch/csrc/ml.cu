// K18 flow_features and K19 anomaly_score: the anomaly scorer's two
// device programs.
//
// K18 replaces cilium_tpu/ml/features.py _bucket (:50), _seg_count (:60)
// and flow_features (:66); its plain version is cilium_tpu_torch/ml/
// features.py flow_features_plain.  K19 replaces cilium_tpu/ml/model.py
// forward (:112), novelty_d2 (:135) and score_packets (:141), jitted at
// ml/scorer.py:33 and fused with flow_features at ml/evaluate.py:139; its
// plain version is cilium_tpu_torch/ml/model.py score_packets_plain.
//
// K18 (bound: bytes, ~48 B read and 112 B written a row).  The reference
// hashes five traffic keys a row into 4096 buckets and takes eight segment
// sums of 0/1 weights (1, syn, is_new, syn * is_new), then gathers them
// back.  ONE kernel a call, which reads each row once: a thread keeps its
// rows' five 12-bit keys, flag bits and the four words the columns
// convert in registers (7 words a row, HELD rows) from the count to the
// columns.  A warp adds a key all its lanes share once, from lane 0, as
// the popcount of each set's weight ballot (serving traffic sends nearly
// every row to one service), any other key a lane at a time, into the
// block's shared histogram (8 x 4096 u32).  What sets the time is merging
// the blocks' histograms and reading the counts back: global atomics from
// 132 blocks (one per entry a block touched) cost ~0.015 ms at 2^18 rows
// and gathers from L2 ~0.014 (measured on the H100), so:
//   - up to SMALL_ROWS rows: one cluster of 16 blocks (a non-portable
//     size), whose hardware barrier costs ~0.4 us where a grid barrier
//     costs ~1.2; each block zeroes a 16th of the global table and the
//     entries of its own histogram its rows touch, counts, and after the
//     first cluster barrier adds each touched entry to the table once
//     (atomicExch hands a block total to one lane); after the second it
//     gathers from L2 (__ldcg: other blocks wrote the table);
//   - past it: one cooperative kernel (cudaLaunchCooperativeKernel, a
//     block of FTB threads an SM, as many as the rows ask for), no
//     atomic in global memory: each block writes its histogram out as a
//     partial table (two 16-bit counts a word while no block counts more
//     than 65535 rows); after a grid barrier block b sums slice b of the
//     partials into the finished table; after the second every block
//     copies the whole table into shared memory and gathers from there.
//     Rows past the resident grid's HELD a thread count and are read
//     again a chunk at a time.
// Both write the 27 columns in the reference's order (features.py:107-137)
// through a shared tile, so a chunk's [rows, 27] float32 slab leaves in
// coalesced 16-byte stores, and write id_row.  The counts are exact
// integers in any order, and float(count) equals the reference's float32
// sum of 0/1 weights below 2^24 rows.  Floats follow the reference's order
// of operations (count / svc_n, count / max(scan_count, 1), log1pf(x) /
// 12); build.py compiles without --use_fast_math, so '/' is IEEE and
// log1pf is libdevice's.  There is no valid mask: pad rows count in the
// aggregates, as on the reference.
//
// K19 (bound: bytes, ~244 B a row: id_row, feats, a 128 B embedding row,
// the score; its ~15.9 kFLOP a row of products on bf16 tensor cores, d2's
// ~1.5 kFLOP on CUDA cores).  A warp takes tiles of 32 rows, in a
// grid-stride loop over a grid of co-resident blocks of SW warps, each of
// which first stages w1 and w2 as bf16, transposed ([n][k], k padded to
// 64 with zeros, rows 72 wide so ldmatrix's eight rows fall on distinct
// banks), w3 and the biases bf16-rounded as float32, feat_mean and
// feat_prec (transposed, for float4 reads).  A tile: clamp id_row into
// [0, V) as XLA's gather does (a negative index counts from the end
// once), gather the embedding rows 16 bytes a lane and the features
// coalesced, and write x = bf16(concat(e, feats)) into the warp's [32, 72]
// tile; each lane computes its row's d2 on CUDA cores in the plain
// version's order with no contraction (bit-exact).  Layers 1 and 2 run on
// the tensor cores, mma.sync m16n8k16 bf16 with float32 sums, an m16 half
// of the tile at a time: A from the tile by ldmatrix, B from the staged
// weights by ldmatrix; layer 1's float32 sums rounded to bf16, + bf16(b1)
// (a float32 add rounded to bf16, as torch adds bf16), ReLU, become layer
// 2's A fragments in registers (the m16n8 accumulator pairs are the
// m16n8k16 A layout); layer 2's go back into the tile.  Layer 3 (64 -> 1)
// is a lane's k-order FMA chain over its row; the logit to bf16, + b3 in
// bf16, then float32; the sigmoid, the novelty sigmoid (exactly 0 when
// nov_thresh >= NOV_DISABLED) and max(p, nov) in float32, as before.  The
// tensor cores sum a layer's products in their own order, not the plain
// version's k order: a hidden value's bf16 rounding may move by an ulp,
// so the scores hold to the plain version within 2e-3, at least 99.9%
// of them bit-identical, and the logits within 1e-2; d2 stays bit-exact,
// and the kernel is deterministic (a fixed instruction sequence a row).
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "views.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int N_COLS = 16;
constexpr int OUT_WORDS = 6;
constexpr int FEAT_DIM = 27;
constexpr int N_BUCKETS = 4096;
constexpr int N_SETS = 8;
constexpr uint32_t NO_KEY = 0xFFFFFFFFu;

// out columns (datapath/verdict.py OUT_*)
constexpr int O_VERDICT = 0, O_CT = 2, O_ID_ROW = 3, O_REASON = 4;

// the eight counter sets: (key, weight)
constexpr int S_SVC_ONE = 0, S_SVC_SYN = 1, S_SVC_NEW = 2, S_SRC_ONE = 3,
              S_SPORT_ONE = 4, S_SCAN_NEWSYN = 5, S_SCAN_ONE = 6,
              S_DPORT_ONE = 7;

// ---- K18 ---------------------------------------------------------------

constexpr int FTB = 512;    // the cooperative kernel's threads a block
constexpr int CTB = 256;    // the one-cluster kernel's
constexpr int CLUSTER = 16;  // its blocks (a non-portable cluster size)
constexpr int HELD = 4;     // rows a thread keeps in registers across phases
constexpr int TABLE = N_SETS * N_BUCKETS;  // counters, u32
// the one-cluster kernel takes batches up to this many rows, every row
// held in registers
constexpr int32_t SMALL_ROWS = CLUSTER * CTB * HELD;
// a block's shared memory: its histogram (the cooperative kernel: later
// the finished table), then a tile of a chunk's columns
constexpr size_t feat_smem(int threads) {
  return sizeof(uint32_t) * TABLE + sizeof(float) * threads * FEAT_DIM;
}

__device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t w, uint32_t i) {
  return (h ^ (w * (0x9E3779B1u + 2u * i))) * 0x85EBCA77u;
}

__device__ __forceinline__ uint32_t fold(uint32_t h) {
  return (h ^ (h >> 15)) & (N_BUCKETS - 1);
}

// What phase 3 needs of a row, from its header words 3 (src), 7 (dst),
// 8-12 (sport, dport, proto, flags, len) and 15 (dir) and out words 0, 2
// and 4: the five bucket keys, svc (dst, dport, proto), src (+ src), sport
// (+ sport), scan (src, proto) and dport (src, proto, dport), 12 bits
// each; the flag bits the columns test; the words they convert.
struct Held {
  uint32_t k01;  // k0 | k1 << 12
  uint32_t k23;  // k2 | k3 << 12
  uint32_t k4b;  // k4 | the bits below
  uint32_t sport, dport, len, dirn;
};

// bits of Held::k4b above the key
constexpr int B_FLAGS = 12;    // flags & 31: FIN, SYN, RST, PSH, ACK
constexpr int B_CT = 17;       // min(ct, 3), 2 bits
constexpr int B_ALLOWED = 19;  // verdict == 1
constexpr int B_DENY = 20;     // reason == 2 (default deny)
constexpr int B_TCP = 21, B_UDP = 22, B_ICMP = 23, B_ICMP6 = 24;

__device__ __forceinline__ uint32_t key_of(const Held& h, int k) {
  const uint32_t w = k < 2 ? h.k01 : k < 4 ? h.k23 : h.k4b;
  return (w >> (12 * (k & 1))) & (N_BUCKETS - 1);
}

__device__ __forceinline__ bool bit(const Held& h, int b) {
  return (h.k4b >> b) & 1u;
}

// Row i's keys and words (i < n); writes its id_row
__device__ __forceinline__ Held load_row(const FeatIO& io, int32_t i) {
  const uint4* r = reinterpret_cast<const uint4*>(io.hdr + (size_t)i * N_COLS);
  const uint4 a = r[0], b = r[1], c = r[2], d = r[3];
  const uint32_t* o = io.out + (size_t)i * OUT_WORDS;
  const uint32_t ct = o[O_CT], verdict = o[O_VERDICT], reason = o[O_REASON];
  io.id_row[i] = (int32_t)o[O_ID_ROW];
  const uint32_t src = a.w, dst = b.w, sport = c.x, dport = c.y,
                 proto = c.z, flags = c.w;
  const uint32_t svc3 = mix(mix(mix(0u, dst, 0), dport, 1), proto, 2);
  const uint32_t scan2 = mix(mix(0u, src, 0), proto, 1);
  Held h;
  h.k01 = fold(svc3) | fold(mix(svc3, src, 3)) << 12;
  h.k23 = fold(mix(svc3, sport, 3)) | fold(scan2) << 12;
  h.k4b = fold(mix(scan2, dport, 2)) | (flags & 31u) << B_FLAGS |
          min(ct, 3u) << B_CT | (uint32_t)(verdict == 1u) << B_ALLOWED |
          (uint32_t)(reason == 2u) << B_DENY |
          (uint32_t)(proto == 6u) << B_TCP |
          (uint32_t)(proto == 17u) << B_UDP |
          (uint32_t)(proto == 1u) << B_ICMP |
          (uint32_t)(proto == 58u) << B_ICMP6;
  h.sport = sport;
  h.dport = dport;
  h.len = d.x;
  h.dirn = d.w;
  return h;
}

// the key (0-4) each of the eight counter sets counts over
__device__ __forceinline__ int key_index(int set) {
  return set < 3 ? 0 : set == 3 ? 1 : set == 4 ? 2 : set < 7 ? 3 : 4;
}

// a row's weight in counter set s: 1, syn, is_new or syn * is_new
__device__ __forceinline__ bool weight(const Held& h, int set) {
  const bool syn = bit(h, B_FLAGS + 1), fresh = ((h.k4b >> B_CT) & 3u) == 0u;
  return set == S_SVC_SYN ? syn : set == S_SVC_NEW ? fresh
       : set == S_SCAN_NEWSYN ? syn && fresh : true;
}

// One row slot of the warp into counters ``at(set, key)`` (a pointer into
// the block's shared histogram or the global table).  A key the whole warp
// shares (a service every row goes to) is added once, by lane 0, as the
// popcount of each set's weight ballot; any other key a lane at a time.
// -> the keys (bit k: key k) the warp shares
template <class At>
__device__ __forceinline__ unsigned count_slot(const Held& h, bool live,
                                               int lane, At at) {
  const unsigned full = 0xFFFFFFFFu;
  unsigned ballot[N_SETS];
#pragma unroll
  for (int s = 0; s < N_SETS; ++s)
    ballot[s] = __ballot_sync(full, live && weight(h, s));
  unsigned shared = 0u;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const uint32_t key = live ? key_of(h, k) : NO_KEY;
    const bool same = __all_sync(full, key == __shfl_sync(full, key, 0));
    shared |= (unsigned)same << k;
    if (key == NO_KEY || (same && lane != 0)) continue;
#pragma unroll
    for (int s = 0; s < N_SETS; ++s) {
      if (key_index(s) != k) continue;
      const unsigned c = same ? __popc(ballot[s]) : weight(h, s);
      if (c) atomicAdd(at(s, key), c);
    }
  }
  return shared;
}

__device__ __forceinline__ float flag(bool b) { return b ? 1.0f : 0.0f; }

// A row's 27 columns into its place in a tile; ``count(set, key)`` reads
// a finished counter
template <class Count>
__device__ __forceinline__ void columns(const Held& h, Count count,
                                        float* t) {
  const uint32_t k0 = key_of(h, 0), k3 = key_of(h, 3);
  auto cnt = [&](int set, uint32_t key) {
    return __uint2float_rn(count(set, key));
  };
  const float svc_n = cnt(S_SVC_ONE, k0);
  const float svc_syn = cnt(S_SVC_SYN, k0), svc_new = cnt(S_SVC_NEW, k0);
  const float src_n = cnt(S_SRC_ONE, key_of(h, 1));
  const float sport_n = cnt(S_SPORT_ONE, key_of(h, 2));
  const float scan_ns = cnt(S_SCAN_NEWSYN, k3), scan_n = cnt(S_SCAN_ONE, k3);
  const float dport_n = cnt(S_DPORT_ONE, key_of(h, 4));
  const float dport = __uint2float_rn(h.dport);
  const float sport = __uint2float_rn(h.sport);
  const float length = __uint2float_rn(h.len);
  const uint32_t ct = (h.k4b >> B_CT) & 3u;
  t[0] = flag(bit(h, B_TCP));
  t[1] = flag(bit(h, B_UDP));
  t[2] = flag(bit(h, B_ICMP)) + flag(bit(h, B_ICMP6));
  t[3] = log1pf(dport) / 12.0f;
  t[4] = log1pf(sport) / 12.0f;
  t[5] = flag(dport < 1024.0f);
  t[6] = log1pf(length) / 12.0f;
  t[7] = flag(length < 100.0f);
#pragma unroll
  for (int b = 0; b < 5; ++b) t[8 + b] = flag(bit(h, B_FLAGS + b));
  t[13] = __uint2float_rn(h.dirn);
  t[14] = flag(ct == 0u);
  t[15] = flag(ct == 1u);
  t[16] = flag(ct == 2u);
  t[17] = flag(bit(h, B_ALLOWED));
  t[18] = flag(bit(h, B_DENY));
  t[19] = log1pf(svc_n) / 12.0f;
  t[20] = svc_syn / svc_n;
  t[21] = svc_new / svc_n;
  t[22] = src_n / svc_n;
  t[23] = sport_n / svc_n;
  t[24] = log1pf(scan_ns) / 12.0f;
  t[25] = dport_n / fmaxf(scan_n, 1.0f);
  t[26] = 1.0f;
}

// A chunk's rows out of its tile, 16 bytes a store (the chunk's slab
// starts 16-byte aligned: TB * 27 * 4 is a multiple of 16 and feats is
// the launcher's allocation)
template <int TB>
__device__ __forceinline__ void store_chunk(const FeatIO& io,
                                            const float* tile,
                                            int32_t base) {
  const int32_t m = min(TB, io.n - base) * FEAT_DIM;
  float* dst = io.feats + (size_t)base * FEAT_DIM;
  for (int32_t j = threadIdx.x; j < m / 4; j += TB)
    reinterpret_cast<float4*>(dst)[j] =
        reinterpret_cast<const float4*>(tile)[j];
  for (int32_t j = (m & ~3) + threadIdx.x; j < m; j += TB) dst[j] = tile[j];
}

// Zero a row's entries in the block's shared histogram (before it counts)
__device__ __forceinline__ void zero_slot(uint32_t* sc, const Held& h,
                                          bool live) {
  if (!live) return;
#pragma unroll
  for (int s = 0; s < N_SETS; ++s)
    sc[s * N_BUCKETS + key_of(h, key_index(s))] = 0u;
}

// Move a row's block totals to the global table: atomicExch gives an
// entry's whole total to the first lane that asks (lane 0 alone where the
// warp shared the key), 0 to the rest, so each entry the block touched
// takes one global atomic
__device__ __forceinline__ void flush_slot(uint32_t* sc, uint32_t* counts,
                                           const Held& h, bool live,
                                           unsigned shared, int lane) {
  if (!live) return;
#pragma unroll
  for (int s = 0; s < N_SETS; ++s) {
    if ((shared >> key_index(s)) & 1u && lane != 0) continue;
    const int e = s * N_BUCKETS + key_of(h, key_index(s));
    const uint32_t v = atomicExch(sc + e, 0u);
    if (v) atomicAdd(counts + e, v);
  }
}

// The one-cluster kernel, for batches up to SMALL_ROWS: CLUSTER blocks,
// chunk r of block b is b + r * CLUSTER.  Each block counts its rows in
// its shared histogram (only the entries its rows touch zeroed), then
// adds each touched entry to the global table once; the cluster's
// hardware barrier (~0.4 us) takes the place of the grid's (~1.2 us).
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(CTB)
    flow_features_small(FeatIO io) {
  extern __shared__ __align__(16) uint32_t sc[];  // [8][4096], a tile
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int32_t n = io.n, chunks = (n + CTB - 1) / CTB;
  const int32_t b = (int32_t)cluster.block_rank();
  auto chunk = [&](int r) { return b + r * CLUSTER; };
  auto row = [&](int r) { return chunk(r) * CTB + (int32_t)threadIdx.x; };
  auto local = [&](int set, uint32_t key) {
    return sc + set * N_BUCKETS + key;
  };

  uint4* c4 = reinterpret_cast<uint4*>(io.counts);
  for (int j = b * CTB + threadIdx.x; j < TABLE / 4; j += CLUSTER * CTB)
    c4[j] = make_uint4(0u, 0u, 0u, 0u);
  Held h[HELD];
  unsigned shared[HELD];
#pragma unroll
  for (int r = 0; r < HELD; ++r) {
    h[r] = {};
    shared[r] = 0u;
    if (row(r) < n) h[r] = load_row(io, row(r));
    zero_slot(sc, h[r], row(r) < n);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < HELD; ++r)
    if (chunk(r) < chunks)
      shared[r] = count_slot(h[r], row(r) < n, lane, local);
  cluster.sync();  // the global table zero, the block's rows counted
#pragma unroll
  for (int r = 0; r < HELD; ++r)
    flush_slot(sc, io.counts, h[r], row(r) < n, shared[r], lane);
  cluster.sync();  // every row in the global table
  auto read = [&](int set, uint32_t key) {
    return __ldcg(io.counts + set * N_BUCKETS + key);
  };
  float* tile = reinterpret_cast<float*>(sc + TABLE);
#pragma unroll
  for (int r = 0; r < HELD; ++r) {
    if (chunk(r) >= chunks) break;
    if (row(r) < n) columns(h[r], read, tile + threadIdx.x * FEAT_DIM);
    __syncthreads();
    store_chunk<CTB>(io, tile, chunk(r) * CTB);
    __syncthreads();
  }
}

__device__ __forceinline__ uint4 operator+(uint4 a, uint4 b) {
  return make_uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The cooperative kernel, for batches past SMALL_ROWS: chunk r of block b
// is b + r * gridDim.x.  io.counts holds the finished table, then one
// partial table a block.
__global__ void __launch_bounds__(FTB, 1) flow_features_wide(FeatIO io) {
  extern __shared__ __align__(16) uint32_t sc[];  // [8][4096], a tile
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int32_t n = io.n, chunks = (n + FTB - 1) / FTB;
  const int blocks = gridDim.x;
  auto chunk = [&](int r) { return (int32_t)(blockIdx.x + r * blocks); };
  auto row = [&](int r) { return chunk(r) * FTB + (int32_t)threadIdx.x; };
  auto local = [&](int set, uint32_t key) {
    return sc + set * N_BUCKETS + key;
  };
  uint4* s4 = reinterpret_cast<uint4*>(sc);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4* table = reinterpret_cast<uint4*>(io.counts);  // the finished one
  auto part = [&](int b) { return table + (size_t)(1 + b) * (TABLE / 4); };
  // a partial table holds its counts in 16 bits, two a word, where no
  // block counts more than 65535 rows; else in 32
  const bool narrow = (chunks + blocks - 1) / blocks * FTB <= 0xFFFF;

  // 1. the block's rows into its shared histogram (the held ones loaded
  //    once, the rest a round at a time), then out as its partial table
  for (int j = threadIdx.x; j < TABLE / 4; j += FTB) s4[j] = zero;
  Held h[HELD];
#pragma unroll
  for (int r = 0; r < HELD; ++r) {
    h[r] = {};
    if (row(r) < n) h[r] = load_row(io, row(r));
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < HELD; ++r)
    if (chunk(r) < chunks) count_slot(h[r], row(r) < n, lane, local);
  for (int r = HELD; chunk(r) < chunks; ++r) {
    Held x = {};
    if (row(r) < n) x = load_row(io, row(r));
    count_slot(x, row(r) < n, lane, local);
  }
  __syncthreads();
  // eight counts a unit: one 16-byte word narrow, two wide
  for (int u = threadIdx.x; u < TABLE / 8; u += FTB) {
    const uint4 lo = s4[2 * u], hi = s4[2 * u + 1];
    if (narrow) {
      part(blockIdx.x)[u] = make_uint4(lo.x | lo.y << 16, lo.z | lo.w << 16,
                                       hi.x | hi.y << 16, hi.z | hi.w << 16);
    } else {
      part(blockIdx.x)[2 * u] = lo;
      part(blockIdx.x)[2 * u + 1] = hi;
    }
  }
  grid.sync();

  // 2. block b sums its slice of the partial tables' units (``groups``
  //    threads a unit, their sums added in order) into the finished table
  const int per = (TABLE / 8 + blocks - 1) / blocks;
  const int u0 = blockIdx.x * per, nu = max(0, min(TABLE / 8, u0 + per) - u0);
  const int groups = nu ? max(1, FTB / nu) : 1;
  for (int w = threadIdx.x; w < groups * nu; w += FTB) {
    const int u = u0 + w % nu, g0 = w / nu;
    uint4 lo = zero, hi = zero;
    for (int g = g0; g < blocks; g += groups) {
      if (narrow) {
        const uint4 v = __ldcg(part(g) + u);
        const uint32_t m = 0xFFFFu;
        lo = lo + make_uint4(v.x & m, v.x >> 16, v.y & m, v.y >> 16);
        hi = hi + make_uint4(v.z & m, v.z >> 16, v.w & m, v.w >> 16);
      } else {
        lo = lo + __ldcg(part(g) + 2 * u);
        hi = hi + __ldcg(part(g) + 2 * u + 1);
      }
    }
    s4[2 * w] = lo;
    s4[2 * w + 1] = hi;
  }
  __syncthreads();
  for (int u = threadIdx.x; u < nu; u += FTB) {
    uint4 lo = s4[2 * u], hi = s4[2 * u + 1];
    for (int g0 = 1; g0 < groups; ++g0) {
      lo = lo + s4[2 * (g0 * nu + u)];
      hi = hi + s4[2 * (g0 * nu + u) + 1];
    }
    table[2 * (u0 + u)] = lo;
    table[2 * (u0 + u) + 1] = hi;
  }
  grid.sync();

  // 3. the finished table into shared memory; the columns a chunk at a
  //    time, the held rows from registers, the rest read again
  for (int j = threadIdx.x; j < TABLE / 4; j += FTB)
    s4[j] = __ldcg(table + j);
  __syncthreads();
  auto read = [&](int set, uint32_t key) { return *local(set, key); };
  float* tile = reinterpret_cast<float*>(sc + TABLE);
#pragma unroll
  for (int r = 0; r < HELD; ++r) {
    if (chunk(r) >= chunks) break;
    if (row(r) < n) columns(h[r], read, tile + threadIdx.x * FEAT_DIM);
    __syncthreads();
    store_chunk<FTB>(io, tile, chunk(r) * FTB);
    __syncthreads();
  }
  for (int r = HELD; chunk(r) < chunks; ++r) {
    if (row(r) < n)
      columns(load_row(io, row(r)), read, tile + threadIdx.x * FEAT_DIM);
    __syncthreads();
    store_chunk<FTB>(io, tile, chunk(r) * FTB);
    __syncthreads();
  }
}

// ---- K19 ---------------------------------------------------------------

constexpr int EMB = 32;             // D, the reference default
constexpr int HID = 64;             // H
constexpr int IN = EMB + FEAT_DIM;  // 59, padded to HID for the products
constexpr int SW = 4;               // K19's warps a block
constexpr int STB = SW * 32;
constexpr int TILE = 32;            // rows a warp tile: a row a lane
constexpr int XS = HID + 8;         // bf16 stride of tile and weight rows
constexpr int PS = 28;              // float stride of feat_prec's columns
constexpr float NOV_DISABLED = 1e9f;

// K19's dynamic shared memory, in bytes: w1 and w2 transposed as bf16
// [n][k]; w3, b1, b2 (bf16-rounded) and feat_mean as float32; feat_prec
// transposed [g][f]; then each warp's x tile (bf16 [32][XS]) and feature
// tile (float32 [32 * 27], the rows as they lie in feats)
constexpr int OFF_W1T = 0;
constexpr int OFF_W2T = OFF_W1T + 2 * HID * XS;
constexpr int OFF_W3 = OFF_W2T + 2 * HID * XS;
constexpr int OFF_B1 = OFF_W3 + 4 * HID;
constexpr int OFF_B2 = OFF_B1 + 4 * HID;
constexpr int OFF_MEAN = OFF_B2 + 4 * HID;
constexpr int OFF_PREC = OFF_MEAN + 4 * PS;
constexpr int OFF_WARPS = OFF_PREC + 4 * FEAT_DIM * PS;
constexpr int X_BYTES = 2 * TILE * XS;
constexpr int F_BYTES = 4 * TILE * FEAT_DIM;
constexpr size_t SCORE_SMEM = OFF_WARPS + SW * (X_BYTES + F_BYTES);
static_assert(OFF_PREC % 16 == 0 && OFF_WARPS % 16 == 0 && X_BYTES % 16 == 0
              && F_BYTES % 16 == 0, "16-byte alignment");

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// torch.sigmoid's float32 formula on the card, 1 / (1 + exp(-x)): IEEE
// division, libdevice expf
__device__ __forceinline__ float sigmoidf(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a . b, one m16n8k16 tile: bf16 inputs, float32 sums
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two neighbouring outputs of a layer: bf16(sum) + bf16(b), the float32
// add rounded to bf16 (torch's bf16 add), then ReLU; packed as bf16x2
__device__ __forceinline__ uint32_t hidden2(float c0, float c1,
                                            const float* b) {
  const float2 s = __bfloat1622float2(__floats2bfloat162_rn(c0, c1));
  const __nv_bfloat162 v = __floats2bfloat162_rn(s.x + b[0], s.y + b[1]);
  return bits(__hmax2(v, __floats2bfloat162_rn(0.0f, 0.0f)));
}

// acc[nt] (n-tile nt = 8 outputs) = A . W for one m16 half: A's four
// k-steps in a[ks], W's transposed bf16 rows in wt
__device__ __forceinline__ void layer(uint32_t (*a)[4],
                                      const __nv_bfloat16* wt, int lane,
                                      float (*acc)[4]) {
#pragma unroll
  for (int nt = 0; nt < HID / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  // lane's ldmatrix row: n-tiles 2 np (lanes 0-15) and 2 np + 1 (16-31),
  // k-step halves 0-7 (lanes 0-7, 16-23) and 8-15
  const __nv_bfloat16* base =
      wt + ((lane & 7) + ((lane >> 4) & 1) * 8) * XS + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < HID / 16; ++ks) {
#pragma unroll
    for (int np = 0; np < HID / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, base + np * 16 * XS + ks * 16);
      mma_bf16(acc[2 * np], a[ks], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[ks], b[2], b[3]);
    }
  }
}

__global__ void __launch_bounds__(STB, 4) anomaly_score_kernel(ScoreIO io) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_w1t = reinterpret_cast<__nv_bfloat16*>(smem + OFF_W1T);
  __nv_bfloat16* s_w2t = reinterpret_cast<__nv_bfloat16*>(smem + OFF_W2T);
  float* s_w3 = reinterpret_cast<float*>(smem + OFF_W3);
  float* s_b1 = reinterpret_cast<float*>(smem + OFF_B1);
  float* s_b2 = reinterpret_cast<float*>(smem + OFF_B2);
  float* s_mean = reinterpret_cast<float*>(smem + OFF_MEAN);
  float* s_prect = reinterpret_cast<float*>(smem + OFF_PREC);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __nv_bfloat16* xt = reinterpret_cast<__nv_bfloat16*>(
      smem + OFF_WARPS + warp * (X_BYTES + F_BYTES));
  float* ft = reinterpret_cast<float*>(smem + OFF_WARPS +
                                       warp * (X_BYTES + F_BYTES) + X_BYTES);

  // the weights, once a block
  for (int j = threadIdx.x; j < HID * HID; j += STB) {
    const int k = j / HID, c = j % HID;
    s_w1t[c * XS + k] = __float2bfloat16_rn(k < IN ? io.w1[j] : 0.0f);
    s_w2t[c * XS + k] = __float2bfloat16_rn(io.w2[j]);
  }
  for (int j = threadIdx.x; j < HID; j += STB) {
    s_w3[j] = bf16r(io.w3[j]);
    s_b1[j] = bf16r(io.b1[j]);
    s_b2[j] = bf16r(io.b2[j]);
  }
  for (int j = threadIdx.x; j < PS; j += STB)
    s_mean[j] = j < FEAT_DIM ? io.feat_mean[j] : 0.0f;
  for (int j = threadIdx.x; j < FEAT_DIM * PS; j += STB) {
    const int g = j / PS, f = j % PS;
    s_prect[j] = f < FEAT_DIM ? io.feat_prec[f * FEAT_DIM + g] : 0.0f;
  }
  __syncthreads();
  const float b3 = bf16r(io.b3[0]);
  const float thresh = io.nov_thresh[0];
  const int g8 = lane >> 2, t2 = 2 * (lane & 3);  // accumulator row, column

  const int32_t n = io.n, tiles = (n + TILE - 1) / TILE;
  for (int32_t tile = blockIdx.x * SW + warp; tile < tiles;
       tile += gridDim.x * SW) {
    const int32_t r0 = tile * TILE, i = r0 + lane;
    const int live_rows = min(TILE, n - r0);
    const bool live = lane < live_rows;
    const int64_t e_row = live ? xla_index(io.id_row[i], io.v) : 0;
    // the tile's features as they lie (rows past n: zeros), then each
    // 8 lanes one embedding row, 16 bytes a lane
    const float* fsrc = io.feats + (size_t)r0 * FEAT_DIM;
#pragma unroll
    for (int q = 0; q < FEAT_DIM; ++q) {
      const int j = q * 32 + lane;
      ft[j] = j < live_rows * FEAT_DIM ? fsrc[j] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < TILE / 4; ++q) {
      const int rr = q * 4 + (lane >> 3), c4 = lane & 7;
      const int64_t er = __shfl_sync(0xFFFFFFFFu, e_row, rr);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (rr < live_rows)
        v = reinterpret_cast<const float4*>(io.embed + er * EMB)[c4];
      uint2 p;
      p.x = bits(__floats2bfloat162_rn(v.x, v.y));
      p.y = bits(__floats2bfloat162_rn(v.z, v.w));
      *reinterpret_cast<uint2*>(xt + rr * XS + 4 * c4) = p;
    }
    __syncwarp();
    // the lane's row: x's feature half (columns 59-63 zero) and d
    float d[FEAT_DIM];
#pragma unroll
    for (int f = 0; f < FEAT_DIM; ++f) d[f] = ft[lane * FEAT_DIM + f];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint4 p;
      uint32_t* w = &p.x;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = q * 8 + 2 * e;
        w[e] = bits(__floats2bfloat162_rn(f < FEAT_DIM ? d[f] : 0.0f,
                                          f + 1 < FEAT_DIM ? d[f + 1] : 0.0f));
      }
      *reinterpret_cast<uint4*>(xt + lane * XS + EMB + 8 * q) = p;
    }
    // novelty: d2 = sum_g (sum_f d_f P_fg) d_g, a rounded product and a
    // rounded add a term in the plain version's order (no FMA: its terms
    // cancel, so contraction would move d2's last bits)
#pragma unroll
    for (int f = 0; f < FEAT_DIM; ++f) d[f] = __fsub_rn(d[f], s_mean[f]);
    float d2 = 0.0f;
#pragma unroll
    for (int g = 0; g < FEAT_DIM; ++g) {
      const float4* pg = reinterpret_cast<const float4*>(s_prect + g * PS);
      float t = 0.0f;
#pragma unroll
      for (int q = 0; q < PS / 4; ++q) {
        const float4 p = pg[q];
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * q + e < FEAT_DIM)
            t = __fadd_rn(t, __fmul_rn(d[4 * q + e], pv[e]));
      }
      d2 = __fadd_rn(d2, __fmul_rn(t, d[g]));
    }
    __syncwarp();

    // layers 1 and 2 on the tensor cores, an m16 half at a time; layer
    // 2's outputs back into the tile's rows
#pragma unroll 1
    for (int mt = 0; mt < TILE / 16; ++mt) {
      uint32_t a[HID / 16][4];
      const __nv_bfloat16* arow =
          xt + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * XS +
          (lane >> 4) * 8;
#pragma unroll
      for (int ks = 0; ks < HID / 16; ++ks) ldmatrix_x4(a[ks], arow + ks * 16);
      float acc[HID / 8][4];
      layer(a, s_w1t, lane, acc);
#pragma unroll
      for (int kk = 0; kk < HID / 16; ++kk) {
        const float* b0 = s_b1 + 16 * kk + t2;
        a[kk][0] = hidden2(acc[2 * kk][0], acc[2 * kk][1], b0);
        a[kk][1] = hidden2(acc[2 * kk][2], acc[2 * kk][3], b0);
        a[kk][2] = hidden2(acc[2 * kk + 1][0], acc[2 * kk + 1][1], b0 + 8);
        a[kk][3] = hidden2(acc[2 * kk + 1][2], acc[2 * kk + 1][3], b0 + 8);
      }
      layer(a, s_w2t, lane, acc);
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < HID / 8; ++nt) {
        const float* b = s_b2 + 8 * nt + t2;
        __nv_bfloat16* h = xt + (mt * 16 + g8) * XS + 8 * nt + t2;
        *reinterpret_cast<uint32_t*>(h) = hidden2(acc[nt][0], acc[nt][1], b);
        *reinterpret_cast<uint32_t*>(h + 8 * XS) =
            hidden2(acc[nt][2], acc[nt][3], b);
      }
    }
    __syncwarp();

    // layer 3: the lane's row, a k-order FMA chain
    float lacc = 0.0f;
    const uint4* hrow = reinterpret_cast<const uint4*>(xt + lane * XS);
#pragma unroll
    for (int q = 0; q < HID / 8; ++q) {
      const uint4 p = hrow[q];
      const uint32_t w[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 hv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        lacc = fmaf(hv.x, s_w3[8 * q + 2 * e], lacc);
        lacc = fmaf(hv.y, s_w3[8 * q + 2 * e + 1], lacc);
      }
    }
    __syncwarp();
    if (live) {
      const float logit = bf16r(bf16r(lacc) + b3);
      const float p = sigmoidf(logit);
      float nov = 0.0f;
      if (!(thresh >= NOV_DISABLED))
        nov = sigmoidf(__fdiv_rn(__fsub_rn(d2, thresh),
                                 __fadd_rn(__fmul_rn(thresh, 0.25f), 1e-6f)));
      io.score[i] = fmaxf(p, nov);
      if (io.logit) io.logit[i] = logit;
      if (io.d2) io.d2[i] = d2;
    }
  }
}

// The most co-resident blocks of `kernel` (threads, dynamic shared
// memory) on device `dev`, cached (0: none fit)
template <int SLOT>
int max_blocks(const void* kernel, int threads, size_t smem, int dev) {
  static int cached[64];
  if (dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  smem);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

}  // namespace

// The cooperative kernel's blocks for a batch of n rows (0: the batch goes
// to the one-cluster kernel, or no block fits): the launcher's scratch
// holds one partial table for each
extern "C" int flow_features_blocks(int n) {
  if (n <= SMALL_ROWS) return 0;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      flow_features_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)feat_smem(FTB));
  if (opt_in != cudaSuccess) return 0;
  int dev = 0;
  cudaGetDevice(&dev);
  const int most = max_blocks<0>(
      reinterpret_cast<const void*>(flow_features_wide), FTB, feat_smem(FTB),
      dev);
  return min((n + FTB - 1) / FTB, most);
}

extern "C" int flow_features_launch(const FeatIO* iop, cudaStream_t stream) {
  FeatIO io = *iop;
  if (io.n <= 0) return (int)cudaGetLastError();
  if (io.n <= SMALL_ROWS) {
    // above 48 KB of shared memory a block needs the opt-in, and a
    // cluster of 16 the non-portable size, once
    static const cudaError_t opt_in = [] {
      const cudaError_t e = cudaFuncSetAttribute(
          flow_features_small, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)feat_smem(CTB));
      return e != cudaSuccess ? e : cudaFuncSetAttribute(
          flow_features_small,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }();
    if (opt_in != cudaSuccess) return (int)opt_in;
    flow_features_small<<<CLUSTER, CTB, feat_smem(CTB), stream>>>(io);
    return (int)cudaGetLastError();
  }
  const int blocks = flow_features_blocks(io.n);
  if (blocks <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (blocks > io.partials) return (int)cudaErrorInvalidValue;
  void* args[] = {&io};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(flow_features_wide), dim3(blocks), dim3(FTB),
      args, feat_smem(FTB), stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int anomaly_score_launch(const ScoreIO* io, cudaStream_t stream) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      anomaly_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SCORE_SMEM);
  if (opt_in != cudaSuccess) return (int)opt_in;
  if (io->n > 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    const int most = max_blocks<1>(
        reinterpret_cast<const void*>(anomaly_score_kernel), STB, SCORE_SMEM,
        dev);
    if (most <= 0) return (int)cudaErrorInvalidConfiguration;
    const int tiles = (io->n + TILE - 1) / TILE;
    const int blocks = min((tiles + SW - 1) / SW, most);
    anomaly_score_kernel<<<blocks, STB, SCORE_SMEM, stream>>>(*io);
  }
  return (int)cudaGetLastError();
}

extern "C" size_t ml_abi_size(int which) {
  return which == 0 ? sizeof(FeatIO) : which == 1 ? sizeof(ScoreIO) : 0;
}
