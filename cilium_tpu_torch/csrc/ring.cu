// K5: ring_append, event compaction into the device ring.
//
// Replaces: cilium_tpu/monitor/ring.py ring_append (:100-164).
// Bound: bytes.  It reads the 24 B out row of every packet (the event
// word decides) and writes 8 B per kept event, a few percent of a
// steady batch; at the daemon's 2^16 rows that is ~0.0005 ms, under the
// ~0.002 ms floor of a launch, so what the design can cut is launches,
// barriers and second reads.
// Design: ONE cooperative kernel a call (cudaLaunchCooperativeKernel),
// grid (blocks a shard, shards), capped at RING_BLOCKS_PER_SM blocks an
// SM and at the co-resident blocks.  Each
// thread holds R rows, base + r * RING_TPB + t of its block, so that a
// warp's loads stay neighbours; R is a template parameter (1, 2, 4, 8, 16
// or 32, enough for 2^19 rows a shard over 8 shards on the H100), the
// fewest the grid allows, so a thread's keep bits and packed words stay
// in registers.  Before the one grid barrier a block reads the keep
// inputs of its rows once (the event word, the trace sample by
// shard-local index, valid), keeps the warps' ballots in shared memory
// (r-major: row order), scans their counts into each (r, warp)'s offset
// in the block (R * 16 warps <= 512 entries: one block scan), publishes
// its kept count and reads its shard's cursor.  After the barrier a block
// loads its shard's block counts (at most a few hundred, from L2) and, in
// the same round trip, the rest of its kept rows, then sums the counts
// into its offset and the shard's total.  Newest-wins needs the total:
// when one batch keeps more than the ring holds, only the newest
// `capacity` kept rows write, so no two rows share a slot.  Each kept row
// then writes its packed word pair (8 B, one store), and block 0 of each
// shard moves the 64-bit cursor (lo, hi) with its carry.  The proxy
// port's listener index is the first match in the table, like the
// reference's argmax.  An empty batch still launches (one block a shard):
// its cursor carry runs, as the reference's does.  The block counts live
// in a scratch the wrapper keeps a (device, kernel, stream); every launch
// writes its entries before the barrier and reads them after, so no
// launch clears it and none allocates.  Scalars pass by value and nothing
// syncs the host, so the launch can be captured in a CUDA graph.
// Sharded serving (P16a: cilium_tpu/parallel/mesh.py:234, 259): the
// batch is S flow-routed blocks of `block` rows and the ring S private
// rings of `capacity` slots in one [S * capacity, 2] buffer with an
// [S, 2] cursor (make_sharded_ring's layout).  The grid's y dimension is
// the shard: each shard counts, sums and writes its own block into its
// own ring at its own cursor, with its own newest-wins overflow, and
// the packet index and the trace sample are shard-local (i - s *
// block), as the reference's ring_append sees them inside shard_map.
// One shard: block == n, the single ring.
//
// K6: ring_gather, the occupancy-bounded drain.
//
// Replaces: cilium_tpu/monitor/ring.py ring_gather (:344-366).
// Bound: bytes, one 8 B row read and one written per gathered slot (the
// rung, a power of two at least as large as the window's events): at
// the daemon's rung 2^18, 2 MB each way, ~1.25 us at 3.35 TB/s, under
// the ~1.9 us of a launch.
// Design (it was one thread an 8 B row over a block per 256 rows, at 0.65
// TB/s): a thread copies 16-byte units, two output rows a unit, a unit a
// thread a step, over a grid of at most GATHER_BLOCKS_PER_SM blocks an SM (the
// SM count read from the device) that strides over the (shard, unit) pairs, so
// that a warp's loads and stores stay neighbours.  Small rungs launch only the
// blocks they need.  A shard's window is at most two runs of its ring (from
// `start` to the end, then from slot 0); `capacity` is a power of two, so the
// wrap falls between two aligned source pairs.  With an even `start` a unit is
// one aligned 16 B load; with an odd one its rows lie in two pairs and load as
// two 8 B rows (measured as fast as realigning 16 B loads across lanes with
// __shfl_down_sync, PERF.md).  An odd rung or a buffer not 16-byte aligned
// takes the row path: a row a thread a step over the same grid.  The per-shard
// starts ride in the argument block by value; the host computed them from the
// cursor it had just read.
#include <cooperative_groups.h>

#include "views.cuh"

namespace cg = cooperative_groups;

constexpr int RING_TPB = 512;
constexpr int RING_WARPS = RING_TPB / 32;
constexpr int MAX_ROWS = RING_TPB / RING_WARPS;  // R: (r, warp) counts
                                                 // fill one block scan
// The grid, over all shards, at most this many blocks an SM (2^19 rows a
// shard over 8 shards needs 32 blocks a shard at 32 rows a thread; 2 an
// SM gives the H100's 132 SMs 33).  On the H100 (PERF.md)
// 2 was as fast as 4 and faster than 1 at 2^18 rows: 256 blocks of 2
// rows a thread against 128 of 4
constexpr int RING_BLOCKS_PER_SM = 2;
constexpr int N_OUT = 6;
constexpr int OUT_VERDICT = 0, OUT_PROXY = 1, OUT_CT = 2, OUT_ID_ROW = 3,
              OUT_REASON = 4, OUT_EVENT = 5;
constexpr uint32_t EV_TRACE = 0;

struct RingIO {
  const uint32_t* out;          // [n, 6], n = n_shards * block
  const bool* valid;            // [n] or null
  const uint32_t* proxy_ports;  // [n_proxy] or null
  uint32_t* buf;                // [n_shards * capacity, 2]
  uint32_t* cursor;             // [n_shards, 2] lo, hi
  uint32_t* block_counts;       // [counts_cap] scratch: kept rows a block
  int32_t n;
  int32_t n_proxy;
  int32_t capacity;  // slots per shard
  uint32_t trace_sample;
  uint32_t batch_id;
  int32_t n_shards;
  int32_t block;       // rows per shard
  int32_t counts_cap;  // entries of block_counts
};

// Whether shard s keeps its local row li (li = i - s * block).
__device__ __forceinline__ bool ring_keep(const RingIO& io, int32_t s,
                                          int32_t li) {
  if (li >= io.block) return false;
  size_t i = (size_t)s * io.block + li;
  bool keep = __ldg(&io.out[i * N_OUT + OUT_EVENT]) != EV_TRACE;
  if (io.trace_sample) keep |= ((uint32_t)li % io.trace_sample) == 0;
  if (io.valid) keep &= io.valid[i];
  return keep;
}

// Exclusive scan of one value a thread over the block; returns the
// thread's prefix and sets *total (the same in every thread).
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v,
                                                         uint32_t* total) {
  __shared__ uint32_t warp_sums[RING_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < RING_WARPS ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < RING_WARPS; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < RING_WARPS) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const uint32_t before = warp == 0 ? 0u : warp_sums[warp - 1];
  *total = warp_sums[RING_WARPS - 1];
  return before + x - v;
}

// Sums of two values a thread over the block, in every thread.
__device__ __forceinline__ void block_sum2(uint32_t& a, uint32_t& b) {
  __shared__ uint32_t sums[2][RING_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xFFFFFFFFu, a, o);
    b += __shfl_xor_sync(0xFFFFFFFFu, b, o);
  }
  if (lane == 0) {
    sums[0][warp] = a;
    sums[1][warp] = b;
  }
  __syncthreads();
  a = 0u;
  b = 0u;
#pragma unroll
  for (int w = 0; w < RING_WARPS; ++w) {
    a += sums[0][w];
    b += sums[1][w];
  }
}

// The packed first word of the out row at `o`: verdict, event, reason,
// CT state, the listener index (the first match, 1-based; 0 for none)
// and id_row.
__device__ __forceinline__ uint32_t ring_word0(const RingIO& io,
                                               const uint32_t* o) {
  const uint32_t port = __ldg(&o[OUT_PROXY]);
  uint32_t pidx = 0;
  if (port != 0) {
    for (int32_t k = 0; k < io.n_proxy; ++k) {
      if (__ldg(&io.proxy_ports[k]) == port) {
        pidx = (uint32_t)k + 1;
        break;
      }
    }
  }
  return (__ldg(&o[OUT_VERDICT]) & 0x7) |
         ((__ldg(&o[OUT_EVENT]) & 0x3) << 3) |
         ((__ldg(&o[OUT_REASON]) & 0xF) << 5) |
         ((__ldg(&o[OUT_CT]) & 0x7) << 9) | (pidx << 12) |
         ((__ldg(&o[OUT_ID_ROW]) & 0xFFFF) << 16);
}

// grid (blocks a shard, n_shards), R rows a thread
template <int R>
__global__ void __launch_bounds__(RING_TPB, 2)
    ring_append_kernel(RingIO io) {
  static_assert(R >= 1 && R <= MAX_ROWS, "rows a thread");
  cg::grid_group grid = cg::this_grid();
  __shared__ uint32_t ballots[R * RING_WARPS];  // [r][warp]: row order
  __shared__ uint32_t offsets[R * RING_WARPS];  // in the block
  __shared__ uint32_t s_lo, s_hi;
  const int32_t s = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t base = blockIdx.x * RING_TPB * R;  // shard-local row
  uint32_t* counts = io.block_counts + (size_t)s * gridDim.x;

  // before the barrier: each row's keep inputs read once, its bit kept
  uint32_t mine = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool keep = ring_keep(io, s, base + r * RING_TPB + threadIdx.x);
    const uint32_t b = __ballot_sync(0xFFFFFFFFu, keep);
    if (lane == 0) ballots[r * RING_WARPS + warp] = b;
    mine |= (uint32_t)keep << r;
  }
  if (threadIdx.x == 0) {
    s_lo = __ldcg(&io.cursor[2 * s]);
    s_hi = __ldcg(&io.cursor[2 * s + 1]);
  }
  __syncthreads();
  const int e = threadIdx.x;  // (r, warp) entry, in row order
  uint32_t kept;
  const uint32_t off = block_exclusive_scan(
      e < R * RING_WARPS ? (uint32_t)__popc(ballots[e]) : 0u, &kept);
  if (e < R * RING_WARPS) offsets[e] = off;
  if (threadIdx.x == 0) counts[blockIdx.x] = kept;
  grid.sync();

  // after it: the shard's block counts (two a thread cover 1024 blocks)
  // and the kept rows' words go out together, then the block's offset
  // and the shard's total
  const int32_t bx = gridDim.x, me = blockIdx.x;
  const int32_t j0 = threadIdx.x, j1 = threadIdx.x + RING_TPB;
  const uint32_t c0 = j0 < bx ? __ldcg(&counts[j0]) : 0u;
  const uint32_t c1 = j1 < bx ? __ldcg(&counts[j1]) : 0u;
  uint32_t w0[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    w0[r] = 0u;
    if ((mine >> r) & 1u) {
      const int32_t li = base + r * RING_TPB + threadIdx.x;
      w0[r] = ring_word0(io, io.out + ((size_t)s * io.block + li) * N_OUT);
    }
  }
  uint32_t total = c0 + c1;
  uint32_t before = (j0 < me ? c0 : 0u) + (j1 < me ? c1 : 0u);
  for (int32_t j = j1 + RING_TPB; j < bx; j += RING_TPB) {
    const uint32_t c = __ldcg(&counts[j]);
    total += c;
    if (j < me) before += c;
  }
  block_sum2(before, total);
  const uint32_t lo = s_lo, cap = (uint32_t)io.capacity;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const uint32_t new_lo = lo + total;
    io.cursor[2 * s] = new_lo;
    io.cursor[2 * s + 1] = s_hi + (new_lo < lo ? 1u : 0u);  // carry
  }
  const uint32_t below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!((mine >> r) & 1u)) continue;
    const uint32_t b = ballots[r * RING_WARPS + warp];
    const uint32_t pos =
        before + offsets[r * RING_WARPS + warp] + __popc(b & below);
    if (pos + cap < total) continue;  // older than the newest `capacity`
    const int32_t li = base + r * RING_TPB + threadIdx.x;
    const uint32_t w1 = (uint32_t)li | ((io.batch_id & 0x1FFF) << 19);
    const size_t slot = (size_t)s * cap + ((lo + pos) & (cap - 1));
    reinterpret_cast<uint2*>(io.buf)[slot] = make_uint2(w0[r], w1);
  }
}

// The most co-resident blocks of ring_append_kernel<R> on device `dev`,
// cached (0: none fit).
template <int R>
static int ring_max_blocks(int dev) {
  static int cached[64];
  if (dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ring_append_kernel<R>, RING_TPB, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

// Launch ring_append_kernel<R> if a grid of at most `most` blocks (and
// its co-resident blocks) holds the batch at R rows a thread; *fits
// false (and nothing launched) if not.
template <int R>
static cudaError_t ring_try(RingIO& io, int dev, int most,
                            cudaStream_t stream, bool* fits) {
  const int co = ring_max_blocks<R>(dev);
  const int per_shard = (most < co ? most : co) / io.n_shards;
  const int64_t want = ((int64_t)io.block + RING_TPB * R - 1) /
                       (RING_TPB * R);
  const int blocks = want < 1 ? 1 : (int)want;
  *fits = blocks <= per_shard &&
          (int64_t)blocks * io.n_shards <= io.counts_cap;
  if (!*fits) return cudaSuccess;
  void* args[] = {&io};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(ring_append_kernel<R>),
      dim3(blocks, io.n_shards), dim3(RING_TPB), args, 0, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

extern "C" int ring_append_launch(const RingIO* iop, cudaStream_t stream) {
  RingIO io = *iop;
  if (io.n_shards < 1 || io.block < 0 ||
      (int64_t)io.n_shards * io.block != io.n)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the fewest rows a thread that a grid of RING_BLOCKS_PER_SM blocks
  // an SM (and no more than co-reside) allows
  const int most = RING_BLOCKS_PER_SM * sms;
  bool fits = false;
  cudaError_t err = ring_try<1>(io, dev, most, stream, &fits);
  if (!fits) err = ring_try<2>(io, dev, most, stream, &fits);
  if (!fits) err = ring_try<4>(io, dev, most, stream, &fits);
  if (!fits) err = ring_try<8>(io, dev, most, stream, &fits);
  if (!fits) err = ring_try<16>(io, dev, most, stream, &fits);
  if (!fits) err = ring_try<MAX_ROWS>(io, dev, most, stream, &fits);
  if (!fits) return (int)cudaErrorCooperativeLaunchTooLarge;
  return (int)err;
}

constexpr int GATHER_TPB = 256;
constexpr int MAX_GATHER_SHARDS = 8;
// At most this many blocks of GATHER_TPB an SM (measured on the H100:
// PERF.md, the K6 redesign)
constexpr int GATHER_BLOCKS_PER_SM = 4;

struct GatherIO {
  const uint2* buf;  // [n_shards * capacity] rows of 2 u32
  uint2* out;        // [n_shards * rung]
  int32_t n_shards;
  int32_t rung;
  int32_t capacity;  // 2^k
  int32_t pad;
  uint32_t starts[MAX_GATHER_SHARDS];  // oldest surviving slot per shard
};

// Units: two output rows each (PAIRS, an even rung), or one; a unit a
// thread a step.  The argument block is read in place: it is indexed by
// shard, which may otherwise copy it to each thread's local memory.
template <bool PAIRS>
__global__ void __launch_bounds__(GATHER_TPB)
    ring_gather_kernel(const __grid_constant__ GatherIO io) {
  const uint32_t mask = (uint32_t)io.capacity - 1u;
  const uint32_t per = PAIRS ? (uint32_t)io.rung >> 1 : (uint32_t)io.rung;
  const uint32_t total = (uint32_t)io.n_shards * per;
  const uint32_t nth = gridDim.x * GATHER_TPB;
  for (uint32_t g = blockIdx.x * GATHER_TPB + threadIdx.x; g < total;
       g += nth) {
    const uint32_t s = g / per, u = g - s * per;
    const uint2* ring = io.buf + (size_t)s * io.capacity;
    if (!PAIRS) {
      io.out[g] = ring[(io.starts[s] + u) & mask];
      continue;
    }
    const uint32_t first = (io.starts[s] + 2u * u) & mask;
    uint4 w;
    if (!(first & 1u)) {
      w = reinterpret_cast<const uint4*>(ring)[first >> 1];
    } else {  // the rows lie in two pairs (the second maybe across the wrap)
      const uint2 a = ring[first], b = ring[(first + 1u) & mask];
      w = make_uint4(a.x, a.y, b.x, b.y);
    }
    reinterpret_cast<uint4*>(io.out)[g] = w;
  }
}

extern "C" int ring_gather_launch(const GatherIO* iop, cudaStream_t stream) {
  const GatherIO io = *iop;
  if (io.n_shards < 1 || io.n_shards > MAX_GATHER_SHARDS || io.rung < 1 ||
      io.capacity < io.rung || (io.capacity & (io.capacity - 1)))
    return (int)cudaErrorInvalidValue;
  const bool pairs =
      (io.rung & 1) == 0 && ((uintptr_t)io.buf & 15u) == 0 &&
      ((uintptr_t)io.out & 15u) == 0;
  const int64_t units =
      (int64_t)io.n_shards * (pairs ? io.rung >> 1 : io.rung);
  if (units > INT32_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // a unit a thread, at most GATHER_BLOCKS_PER_SM blocks an SM
  const int64_t want = (units + GATHER_TPB - 1) / GATHER_TPB;
  const int most = GATHER_BLOCKS_PER_SM * sms;
  const int blocks = want < most ? (int)want : most;
  if (pairs)
    ring_gather_kernel<true><<<blocks, GATHER_TPB, 0, stream>>>(io);
  else
    ring_gather_kernel<false><<<blocks, GATHER_TPB, 0, stream>>>(io);
  return (int)cudaGetLastError();
}

extern "C" size_t ring_abi_size(int which) {
  return which == 0 ? sizeof(RingIO) : which == 1 ? sizeof(GatherIO) : 0;
}
