// K5: ring_append, event compaction into the device ring.
//
// Replaces: cilium_tpu/monitor/ring.py ring_append (:100-164).
// Bound: bytes.  It reads the 24 B out row of every packet (the event
// word decides) and writes 8 B per kept event, a few percent of the
// batch; the cross-block prefix sum adds two more launches.
// Design: the exclusive prefix sum is written out as three kernels:
// (1) each block of 1024 rows counts its kept rows, (2) one block scans
// the block counts, fixes the batch's base slot from the cursor and
// carries the 64-bit cursor (lo, hi) on the device, (3) each block
// rescans its rows with warp shuffles and writes its kept rows at
// base + block offset + rank.  Newest-wins when one batch keeps more
// than the ring holds: only the last `capacity` kept rows write, so no
// two rows share a slot.  The proxy port's listener index is the first
// match in the table, like the reference's argmax.
// Sharded serving (P16a: cilium_tpu/parallel/mesh.py:234, 259): the
// batch is S flow-routed blocks of `block` rows and the ring S private
// rings of `capacity` slots in one [S * capacity, 2] buffer with an
// [S, 2] cursor (make_sharded_ring's layout).  The grid's y dimension is
// the shard in all three passes: each shard counts, scans and writes
// its own block into its own ring at its own cursor, with its own
// newest-wins overflow, and the packet index and the trace sample are
// shard-local (i - s * block), as the reference's ring_append sees them
// inside shard_map.  One shard: block == n, today's single ring.
//
// K6: ring_gather, the occupancy-bounded drain.
//
// Replaces: cilium_tpu/monitor/ring.py ring_gather (:344-366).
// Bound: bytes, one 8 B row read and one written per gathered slot (the
// rung, a power of two at least as large as the window's events).
// Design: one thread per output row of a 2-D grid (x: rows, y: shard),
// each copying one 8 B row from slot (start + i) & (capacity - 1) of its
// shard's ring.  The per-shard starts ride in the argument block by
// value; the host computed them from the cursor it had just read.
#include "views.cuh"

constexpr int RING_TPB = 1024;
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
  uint32_t* block_counts;       // [n_shards, n_blocks] scratch
  uint32_t* meta;               // [n_shards, 2] scratch: base lo, kept
  int32_t n;
  int32_t n_proxy;
  int32_t capacity;  // slots per shard
  uint32_t trace_sample;
  uint32_t batch_id;
  int32_t n_shards;
  int32_t block;  // rows per shard
  int32_t pad;
};

// Whether shard s keeps its local row li (li = i - s * block).
__device__ __forceinline__ bool ring_keep(const RingIO& io, int32_t s,
                                          int32_t li) {
  if (li >= io.block) return false;
  size_t i = (size_t)s * io.block + li;
  bool keep = io.out[i * N_OUT + OUT_EVENT] != EV_TRACE;
  if (io.trace_sample) keep |= ((uint32_t)li % io.trace_sample) == 0;
  if (io.valid) keep &= io.valid[i];
  return keep;
}

// Exclusive scan of one value per thread over a block of RING_TPB
// threads; returns the thread's prefix and sets *total.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v,
                                                         uint32_t* total) {
  __shared__ uint32_t warp_sums[RING_TPB / 32];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      uint32_t y = __shfl_up_sync(0xFFFFFFFFu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  uint32_t before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[RING_TPB / 32 - 1];
  __syncthreads();  // warp_sums is reused by the caller's next scan
  return before + x - v;
}

// grid (n_blocks, n_shards): block x of shard y counts its kept rows
__global__ void __launch_bounds__(RING_TPB) ring_count(RingIO io) {
  int32_t s = blockIdx.y;
  int32_t li = blockIdx.x * RING_TPB + threadIdx.x;
  uint32_t total;
  block_exclusive_scan(ring_keep(io, s, li) ? 1u : 0u, &total);
  if (threadIdx.x == 0)
    io.block_counts[(size_t)s * gridDim.x + blockIdx.x] = total;
}

// grid (1, n_shards): each shard scans its block counts into offsets
// and moves its own cursor
__global__ void __launch_bounds__(RING_TPB) ring_scan_blocks(RingIO io,
                                                             int32_t n_blocks) {
  int32_t s = blockIdx.y;
  uint32_t* counts = io.block_counts + (size_t)s * n_blocks;
  uint32_t running = 0;
  for (int32_t base = 0; base < n_blocks; base += RING_TPB) {
    int32_t b = base + threadIdx.x;
    uint32_t v = b < n_blocks ? counts[b] : 0u, total;
    uint32_t pre = block_exclusive_scan(v, &total);
    if (b < n_blocks) counts[b] = running + pre;  // now offsets
    running += total;
  }
  if (threadIdx.x == 0) {
    uint32_t* cur = io.cursor + 2 * s;
    uint32_t lo = cur[0], hi = cur[1];
    uint32_t new_lo = lo + running;
    io.meta[2 * s] = lo;
    io.meta[2 * s + 1] = running;
    cur[0] = new_lo;
    cur[1] = hi + (new_lo < lo ? 1u : 0u);  // carry
  }
}

__global__ void __launch_bounds__(RING_TPB) ring_write(RingIO io) {
  int32_t s = blockIdx.y;
  int32_t li = blockIdx.x * RING_TPB + threadIdx.x;
  bool keep = ring_keep(io, s, li);
  uint32_t total;
  uint32_t rank = block_exclusive_scan(keep ? 1u : 0u, &total);
  if (!keep) return;
  uint32_t pos = io.block_counts[(size_t)s * gridDim.x + blockIdx.x] + rank;
  uint32_t lo = io.meta[2 * s], count = io.meta[2 * s + 1];
  uint32_t cap = (uint32_t)io.capacity;
  if (pos + cap < count) return;  // older than the newest `capacity`
  const uint32_t* o = io.out + ((size_t)s * io.block + li) * N_OUT;
  uint32_t port = o[OUT_PROXY], pidx = 0;
  if (port != 0) {
    for (int32_t k = 0; k < io.n_proxy; ++k) {
      if (io.proxy_ports[k] == port) {
        pidx = (uint32_t)k + 1;
        break;
      }
    }
  }
  uint32_t w0 = (o[OUT_VERDICT] & 0x7) | ((o[OUT_EVENT] & 0x3) << 3) |
                ((o[OUT_REASON] & 0xF) << 5) | ((o[OUT_CT] & 0x7) << 9) |
                (pidx << 12) | ((o[OUT_ID_ROW] & 0xFFFF) << 16);
  uint32_t w1 = (uint32_t)li | ((io.batch_id & 0x1FFF) << 19);
  size_t slot = (size_t)s * cap + ((lo + pos) & (cap - 1));
  io.buf[slot * 2] = w0;
  io.buf[slot * 2 + 1] = w1;
}

extern "C" int ring_append_launch(const RingIO* iop, cudaStream_t stream) {
  const RingIO io = *iop;
  if (io.n_shards < 1) return (int)cudaErrorInvalidValue;
  int32_t n_blocks = (io.block + RING_TPB - 1) / RING_TPB;
  if (n_blocks > 0) {
    ring_count<<<dim3(n_blocks, io.n_shards), RING_TPB, 0, stream>>>(io);
  }
  // the cursor carry runs even for an empty batch, like the reference
  ring_scan_blocks<<<dim3(1, io.n_shards), RING_TPB, 0, stream>>>(io,
                                                                 n_blocks);
  if (n_blocks > 0) {
    ring_write<<<dim3(n_blocks, io.n_shards), RING_TPB, 0, stream>>>(io);
  }
  return (int)cudaGetLastError();
}

constexpr int GATHER_TPB = 256;
constexpr int MAX_GATHER_SHARDS = 8;

struct GatherIO {
  const uint2* buf;  // [n_shards * capacity] rows of 2 u32
  uint2* out;        // [n_shards * rung]
  int32_t n_shards;
  int32_t rung;
  int32_t capacity;  // 2^k
  int32_t pad;
  uint32_t starts[MAX_GATHER_SHARDS];  // oldest surviving slot per shard
};

__global__ void __launch_bounds__(GATHER_TPB) ring_gather_kernel(GatherIO io) {
  int32_t s = blockIdx.y;
  int32_t i = blockIdx.x * GATHER_TPB + threadIdx.x;
  if (i >= io.rung) return;
  uint32_t slot = (io.starts[s] + (uint32_t)i) & (uint32_t)(io.capacity - 1);
  io.out[(size_t)s * io.rung + i] = io.buf[(size_t)s * io.capacity + slot];
}

extern "C" int ring_gather_launch(const GatherIO* iop, cudaStream_t stream) {
  const GatherIO io = *iop;
  if (io.rung > 0 && io.n_shards > 0) {
    dim3 grid((io.rung + GATHER_TPB - 1) / GATHER_TPB, io.n_shards);
    ring_gather_kernel<<<grid, GATHER_TPB, 0, stream>>>(io);
  }
  return (int)cudaGetLastError();
}

extern "C" size_t ring_abi_size(int which) {
  return which == 0 ? sizeof(RingIO) : which == 1 ? sizeof(GatherIO) : 0;
}
