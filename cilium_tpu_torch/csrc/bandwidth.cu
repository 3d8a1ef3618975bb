// K13 bw_stage: per-endpoint egress policing by token buckets.
//
// Replaces: cilium_tpu/datapath/bandwidth.py bw_stage (:60), the jitted
// bw_stage_jit.  The plain version is cilium_tpu_torch/datapath/
// bandwidth.py bw_stage_plain.
//
// Bound: bytes, and at the daemon's batches the launches: each row's
// endpoint, direction, length, source and source port (64 B wide rows)
// are read twice and its reason (4 B) written once; the 4096 buckets and
// rates are 48 KB.
//
// Design: four short launches on the stream, because each reads sums
// over the whole batch that the one before it builds:
//   1. bw_bytes, a thread per row: atomicAdd of the policed length
//      (egress rows of limited endpoints) into batch_bytes[ep];
//   2. bw_accrue, a thread per endpoint: the token accrual (dt clamped
//      to the burst window first, u32 wrapping as on the reference),
//      capped at the burst, written back in place, and the f32
//      keep-fraction tokens / batch_bytes, divided IEEE round-to-nearest
//      (__fdiv_rn; build.py compiles without --use_fast_math);
//   3. bw_police, a thread per row: the per-flow hash, u = (h >> 8) /
//      2^24 in f32, the drop decision u >= frac[ep], the reason, and an
//      atomicAdd of the kept length into consumed[ep];
//   4. bw_settle, a thread per endpoint: tokens -= min(consumed, tokens)
//      and last = now.
// u32 atomicAdd commutes and wraps at 2^32 as XLA's segment_sum does,
// so the sums are bit-exact in any order.
#include "views.cuh"

namespace {

constexpr int N_COLS = 16;
constexpr int TPB = 256;
constexpr uint32_t MAX_ENDPOINTS = 4096;
constexpr uint32_t BURST_SECONDS = 1;
constexpr uint32_t REASON_BANDWIDTH = 6;

struct BwRow {
  uint32_t src, sport, len, ep, dirn;
};

__device__ __forceinline__ BwRow load_bw_row(const uint32_t* rows, int32_t i) {
  const uint4* r = reinterpret_cast<const uint4*>(rows + (size_t)i * N_COLS);
  uint4 a = r[0], c = r[2], d = r[3];
  BwRow b;
  b.src = a.w;
  b.sport = c.x;
  b.len = d.x;
  b.ep = d.z < MAX_ENDPOINTS - 1 ? d.z : MAX_ENDPOINTS - 1;
  b.dirn = d.w;
  return b;
}

__global__ void bw_bytes(BwIO io) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  BwRow b = load_bw_row(io.rows, i);
  if (io.rates[b.ep] > 0 && b.dirn == 1) atomicAdd(&io.batch_bytes[b.ep], b.len);
}

__global__ void bw_accrue(BwIO io) {
  uint32_t e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= MAX_ENDPOINTS) return;
  uint32_t gap = io.now - *io.last;
  uint32_t dt = gap < BURST_SECONDS ? gap : BURST_SECONDS;
  uint32_t rate = io.rates[e];
  uint32_t burst = rate * BURST_SECONDS;
  uint32_t tok = io.tokens[e] + rate * dt;
  tok = tok < burst ? tok : burst;
  io.tokens[e] = tok;
  uint32_t bb = io.batch_bytes[e];
  io.frac[e] = bb > 0 ? fminf(__fdiv_rn(__uint2float_rn(tok),
                                        __uint2float_rn(bb)), 1.0f)
                      : 1.0f;
}

__global__ void bw_police(BwIO io) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  BwRow b = load_bw_row(io.rows, i);
  bool policed = io.rates[b.ep] > 0 && b.dirn == 1;
  uint32_t h = (b.src * 0x9E3779B1u) ^ (b.sport * 0x85EBCA6Bu) ^
               (b.ep * 0xC2B2AE35u);
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  float u = __fdiv_rn(__uint2float_rn(h >> 8), 16777216.0f);  // [0, 1)
  bool drop = policed && u >= io.frac[b.ep];
  io.reasons[i] = drop ? REASON_BANDWIDTH : 0u;
  if (policed && !drop) atomicAdd(&io.consumed[b.ep], b.len);
}

__global__ void bw_settle(BwIO io) {
  uint32_t e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= MAX_ENDPOINTS) return;
  uint32_t tok = io.tokens[e], used = io.consumed[e];
  io.tokens[e] = tok - (used < tok ? used : tok);
  if (e == 0) *io.last = io.now;
}

}  // namespace

extern "C" int bw_stage_launch(const BwIO* io, cudaStream_t stream) {
  int eb = (MAX_ENDPOINTS + TPB - 1) / TPB;
  int rb = (io->n + TPB - 1) / TPB;
  if (io->n > 0) bw_bytes<<<rb, TPB, 0, stream>>>(*io);
  bw_accrue<<<eb, TPB, 0, stream>>>(*io);
  if (io->n > 0) bw_police<<<rb, TPB, 0, stream>>>(*io);
  bw_settle<<<eb, TPB, 0, stream>>>(*io);
  return (int)cudaGetLastError();
}

extern "C" size_t bandwidth_abi_size(int which) {
  return which == 0 ? sizeof(BwIO) : 0;
}
