// K13 bw_stage: per-endpoint egress policing by token buckets.
//
// Replaces: cilium_tpu/datapath/bandwidth.py bw_stage (:60), the jitted
// bw_stage_jit.  The plain version is cilium_tpu_torch/datapath/
// bandwidth.py bw_stage_plain.
//
// Bound: bytes, and at the daemon's batches the launch: each row's
// source, source port, length, endpoint and direction lie in both 32 B
// sectors of its 64 B row (bytes 12-15, 32-35, 48-63), so the least read
// is the whole row, and its reason (4 B) is written; the 4096 buckets
// and rates are 48 KB.  At 2^16 rows that is ~4.5 MB, ~1.3 us at HBM's
// rate, under the floors of a launch and two grid barriers.
//
// Design: ONE cooperative kernel a call (cudaLaunchCooperativeKernel), a
// grid of at most BW_BLOCKS_PER_SM blocks an SM, three phases around two
// grid barriers, because each phase reads sums over the whole batch that
// the one before it builds:
//   1. each thread loads its rows once (row base + r * grid threads,
//      so a warp's loads stay neighbours) and keeps what the decision
//      needs in registers: the clamped endpoint with a policed bit
//      (egress rows of limited endpoints), the length and the per-flow
//      hash.  The policed lengths go into a shared-memory histogram of
//      the 4096 buckets; the block then adds each non-zero entry to
//      batch_bytes with one atomicAdd (a block's rows touch a few dozen
//      endpoints, so the global atomics are few and spread);
//   2. after barrier 1, each policed row computes its endpoint's
//      keep-fraction in place, tokens / batch_bytes with the accrual
//      (dt clamped to the burst window first, u32 wrapping as on the
//      reference, capped at the burst) read from the untouched buckets,
//      divided IEEE round-to-nearest (__fdiv_rn; build.py compiles
//      without --use_fast_math), then u = (h >> 8) / 2^24 in f32 and the
//      drop decision u >= frac; the reason is written and the kept
//      lengths summed through the same histogram into consumed;
//   3. after barrier 2, the grid (at least BW_MIN_BLOCKS blocks: a
//      thread a bucket; one block settling all 4096 took ~3.5 us) settles
//      the buckets: the accrual again, min(consumed, tokens) taken off,
//      last = now (every thread read last into a register before the
//      first barrier), and batch_bytes and consumed zeroed behind.
// The two sums live in a scratch the wrapper keeps a (device, stream):
// the kernel leaves their words zero, so no call fills them and a
// captured call is one graph node.  An empty batch still accrues and
// settles, as the reference does, after one grid barrier (it has no
// sums; the barrier keeps the write of last behind every read).  A
// thread keeps BW_ROWS rows (the main paths' 2^16 fill 128 blocks at 2);
// past them (more rows than the co-resident grid keeps) it reads its
// further rows again in phase 2.  u32 atomicAdd commutes and wraps at
// 2^32 as XLA's segment_sum does, so the sums are bit-exact in any
// order.  On the H100 (PERF.md) 1 block an SM of 2 rows a thread was
// faster at 2^16 rows than 2 or 4 of 1 row, and than one grid-stride
// path that reads every row again in phase 2 (by 0.5-0.7 us).
#include <cooperative_groups.h>

#include "views.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int N_COLS = 16;
constexpr int BW_TPB = 256;
constexpr int BW_BLOCKS_PER_SM = 1;
constexpr int BW_ROWS = 2;  // rows a thread keeps in registers
constexpr uint32_t MAX_ENDPOINTS = 4096;
constexpr uint32_t EP_MASK = MAX_ENDPOINTS - 1;
constexpr int BW_MIN_BLOCKS = MAX_ENDPOINTS / BW_TPB;  // a thread a bucket
constexpr uint32_t POLICED = 1u << 31;  // in a row's key, over its endpoint
constexpr uint32_t BURST_SECONDS = 1;
constexpr uint32_t REASON_BANDWIDTH = 6;

// What one row's decision needs: its endpoint (clamped) | POLICED, its
// length and its per-flow hash.
struct BwRow {
  uint32_t key, len, hash;
};

// Row i's words: source, source port, then length, family, endpoint
// and direction (rows 16-byte aligned).
struct BwWords {
  uint32_t src, sport;
  uint4 d;
};

__device__ __forceinline__ BwWords load_bw_words(const BwIO& io, int32_t i) {
  const uint32_t* r = io.rows + (size_t)i * N_COLS;
  return BwWords{__ldg(r + 3), __ldg(r + 8),
                 __ldg(reinterpret_cast<const uint4*>(r + 12))};
}

__device__ __forceinline__ uint32_t clamp_ep(const BwWords& w) {
  return w.d.z < EP_MASK ? w.d.z : EP_MASK;
}

// The row from its words and its endpoint's rate.
__device__ __forceinline__ BwRow bw_row(const BwWords& w, uint32_t rate) {
  const uint32_t ep = clamp_ep(w);
  uint32_t h = (w.src * 0x9E3779B1u) ^ (w.sport * 0x85EBCA6Bu) ^
               (ep * 0xC2B2AE35u);
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  const bool policed = w.d.w == 1 && rate > 0;
  return BwRow{ep | (policed ? POLICED : 0u), w.d.x, h};
}

__device__ __forceinline__ BwRow load_bw_row(const BwIO& io, int32_t i) {
  const BwWords w = load_bw_words(io, i);
  return bw_row(w, __ldg(io.rates + clamp_ep(w)));
}

// Endpoint e's tokens after this call's accrual (not written back).
__device__ __forceinline__ uint32_t accrued(const BwIO& io, uint32_t e,
                                            uint32_t dt) {
  const uint32_t rate = __ldg(io.rates + e);
  const uint32_t burst = rate * BURST_SECONDS;
  const uint32_t tok = io.tokens[e] + rate * dt;
  return tok < burst ? tok : burst;
}

// Whether policed row b drops: its endpoint's keep-fraction from the
// batch's policed bytes (summed before barrier 1) against its hash.
__device__ __forceinline__ bool bw_drop(const BwIO& io, const BwRow& b,
                                        uint32_t dt) {
  const uint32_t e = b.key & EP_MASK;
  const uint32_t bb = __ldcg(io.batch_bytes + e);
  const float frac =
      bb > 0 ? fminf(__fdiv_rn(__uint2float_rn(accrued(io, e, dt)),
                               __uint2float_rn(bb)), 1.0f)
             : 1.0f;
  const float u = __fdiv_rn(__uint2float_rn(b.hash >> 8), 16777216.0f);
  return u >= frac;  // u in [0, 1)
}

// Adds the block's non-zero histogram entries to `sums` and zeroes them
// for the next use.  Every thread of the block calls.
__device__ __forceinline__ void flush(uint32_t* hist, uint32_t* sums) {
  __syncthreads();
  for (uint32_t e = threadIdx.x; e < MAX_ENDPOINTS; e += BW_TPB) {
    const uint32_t v = hist[e];
    if (v) {
      atomicAdd(sums + e, v);
      hist[e] = 0u;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(BW_TPB) bw_stage_kernel(BwIO io) {
  __shared__ uint32_t hist[MAX_ENDPOINTS];
  cg::grid_group grid = cg::this_grid();
  Stamps stamps{io.meta, 0};
  stamps.mark();
  const uint32_t gap = io.now - *io.last;  // phase 3 writes last
  const uint32_t dt = gap < BURST_SECONDS ? gap : BURST_SECONDS;
  const int32_t stride = gridDim.x * BW_TPB;
  const int32_t base = blockIdx.x * BW_TPB + threadIdx.x;
  if (io.n > 0) {  // an empty batch has no sums: it only settles
    for (uint32_t e = threadIdx.x; e < MAX_ENDPOINTS; e += BW_TPB)
      hist[e] = 0u;
    __syncthreads();

    // 1. the policed bytes of each endpoint: every row's words, then
    // every rate, in flight together
    BwWords w[BW_ROWS];
    uint32_t rate[BW_ROWS];
    BwRow row[BW_ROWS];
#pragma unroll
    for (int r = 0; r < BW_ROWS; ++r)
      if (base + r * stride < io.n)
        w[r] = load_bw_words(io, base + r * stride);
#pragma unroll
    for (int r = 0; r < BW_ROWS; ++r)
      rate[r] =
          base + r * stride < io.n ? __ldg(io.rates + clamp_ep(w[r])) : 0u;
#pragma unroll
    for (int r = 0; r < BW_ROWS; ++r) {
      row[r] = base + r * stride < io.n ? bw_row(w[r], rate[r])
                                        : BwRow{0u, 0u, 0u};
      if (row[r].key & POLICED)
        atomicAdd(&hist[row[r].key & EP_MASK], row[r].len);
    }
    for (int32_t i = base + BW_ROWS * stride; i < io.n; i += stride) {
      const BwRow b = load_bw_row(io, i);
      if (b.key & POLICED) atomicAdd(&hist[b.key & EP_MASK], b.len);
    }
    flush(hist, io.batch_bytes);
    grid.sync();
    stamps.mark();

    // 2. each row's decision; the kept bytes of each endpoint
#pragma unroll
    for (int r = 0; r < BW_ROWS; ++r) {
      const int32_t i = base + r * stride;
      if (i >= io.n) continue;
      const bool drop = (row[r].key & POLICED) && bw_drop(io, row[r], dt);
      io.reasons[i] = drop ? REASON_BANDWIDTH : 0u;
      if ((row[r].key & POLICED) && !drop)
        atomicAdd(&hist[row[r].key & EP_MASK], row[r].len);
    }
    for (int32_t i = base + BW_ROWS * stride; i < io.n; i += stride) {
      const BwRow b = load_bw_row(io, i);
      const bool drop = (b.key & POLICED) && bw_drop(io, b, dt);
      io.reasons[i] = drop ? REASON_BANDWIDTH : 0u;
      if ((b.key & POLICED) && !drop)
        atomicAdd(&hist[b.key & EP_MASK], b.len);
    }
    flush(hist, io.consumed);
    grid.sync();
    stamps.mark();
  } else {
    grid.sync();  // every thread's read of last before it is written
  }

  // 3. settle the buckets (the grid has a thread for each); the sums'
  // words back to zero
  for (uint32_t e = base; e < MAX_ENDPOINTS; e += stride) {
    const uint32_t tok = accrued(io, e, dt);
    const uint32_t used = __ldcg(io.consumed + e);
    io.tokens[e] = tok - (used < tok ? used : tok);
    io.batch_bytes[e] = 0u;
    io.consumed[e] = 0u;
  }
  if (base == 0) *io.last = io.now;
  stamps.mark();
}

}  // namespace

extern "C" int bw_stage_launch(const BwIO* iop, cudaStream_t stream) {
  BwIO io = *iop;
  if (io.n < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bw_stage_kernel,
                                                BW_TPB, 0);
  // the fewest blocks that hold the batch at BW_ROWS rows a thread, at
  // least BW_MIN_BLOCKS, at most BW_BLOCKS_PER_SM an SM and the
  // co-resident ones
  const int cap = (per_sm < BW_BLOCKS_PER_SM ? per_sm : BW_BLOCKS_PER_SM) *
                  sms;
  if (cap < BW_MIN_BLOCKS) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int64_t want = ((int64_t)io.n + BW_TPB * BW_ROWS - 1) /
                       (BW_TPB * BW_ROWS);
  const int blocks = want < BW_MIN_BLOCKS ? BW_MIN_BLOCKS
                                          : (want < cap ? (int)want : cap);
  void* args[] = {&io};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(bw_stage_kernel), dim3(blocks), dim3(BW_TPB),
      args, 0, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" size_t bandwidth_abi_size(int which) {
  return which == 0 ? sizeof(BwIO) : 0;
}
