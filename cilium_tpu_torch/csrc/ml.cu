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
// back.  Three steps on the stream:
//   1. the launcher zeroes 8 x 4096 u32 counters;
//   2. feat_count, a thread a row: its five bucket keys in native u32
//      arithmetic, and the counts added with INTEGER atomics, aggregated
//      per warp first (__match_any_sync groups the lanes that share a key,
//      the group's lowest lane adds the __popc of its weight ballot once).
//      Serving traffic sends nearly every row to one service, so without
//      the warp step one bucket would take ~2^18 atomics in series.  The
//      counts are exact integers in any order, and float(count) equals
//      the reference's float32 sum of 0/1 weights below 2^24 rows;
//   3. feat_write, a thread a row: gathers its counts, writes the 27
//      columns in the reference's order (features.py:107-137) through a
//      shared-memory tile, so the block's [rows, 27] float32 slab leaves
//      in coalesced stores, and writes id_row.
// Floats follow the reference's order of operations (count / svc_n,
// count / max(scan_count, 1), log1pf(x) / 12); build.py compiles without
// --use_fast_math, so '/' is IEEE and log1pf is libdevice's.  There is no
// valid mask: pad rows count in the aggregates, as on the reference.
//
// K19 (bound: bytes, ~244 B a row: id_row, feats, a 128 B embedding row,
// the score; its ~15.9 kFLOP a row would take less on bf16 tensor cores).
// A thread a row, in a grid-stride loop over blocks of 128; each block
// first stages w1 [59, 64], w2 [64, 64], w3 [64] and the biases, rounded
// to bf16 and kept as float32, with feat_mean [27] and feat_prec [27, 27]
// (35 KB), in dynamic shared memory beside a bf16 column a thread (16 KB).
// Each row: clamp id_row into [0, V) as XLA's gather does (a negative
// index counts from the end once), gather its embedding row, write x =
// bf16(concat(e, feats)) into its column; d2; then each layer keeps its
// 64 float32 sums in registers and walks its inputs from the column, the
// weight row a broadcast shared-memory read, rounding where the
// reference does: each product to bf16, + b in bf16, ReLU (the hidden
// layer goes back into the column); the logit to bf16, + b3 in bf16,
// then float32.  Then the sigmoid, the novelty sigmoid (exactly 0 when
// nov_thresh >= NOV_DISABLED) and max(p, nov), all in float32; d2 and
// the sigmoids in the plain version's order with no contraction, so
// those agree bit for bit.  No library product runs: the three products
// are this kernel's FMAs (tensor cores are later work).  x and h live
// in the shared-memory column, not in register arrays: unrolling both
// layers over register-resident x and h spills (ptxas: 49 KB a thread).
#include <cuda_bf16.h>

#include "views.cuh"

namespace {

constexpr int N_COLS = 16;
constexpr int OUT_WORDS = 6;
constexpr int FEAT_DIM = 27;
constexpr int N_BUCKETS = 4096;
constexpr int N_SETS = 8;
constexpr int TPB = 256;
constexpr uint32_t NO_KEY = 0xFFFFFFFFu;

// out columns (datapath/verdict.py OUT_*)
constexpr int O_VERDICT = 0, O_CT = 2, O_ID_ROW = 3, O_REASON = 4;

// the eight counter sets: (key, weight)
constexpr int S_SVC_ONE = 0, S_SVC_SYN = 1, S_SVC_NEW = 2, S_SRC_ONE = 3,
              S_SPORT_ONE = 4, S_SCAN_NEWSYN = 5, S_SCAN_ONE = 6,
              S_DPORT_ONE = 7;

// the header words K18 reads (core/packets.py COL_*): src 3, dst 7,
// sport 8, dport 9, proto 10, flags 11, len 12, dir 15
struct FeatRow {
  uint32_t src, dst, sport, dport, proto, flags, len, dirn;
};

__device__ __forceinline__ FeatRow load_row(const uint32_t* hdr, int32_t i) {
  const uint4* r = reinterpret_cast<const uint4*>(hdr + (size_t)i * N_COLS);
  const uint4 a = r[0], b = r[1], c = r[2], d = r[3];
  FeatRow f;
  f.src = a.w;
  f.dst = b.w;
  f.sport = c.x;
  f.dport = c.y;
  f.proto = c.z;
  f.flags = c.w;
  f.len = d.x;
  f.dirn = d.w;
  return f;
}

__device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t w, uint32_t i) {
  return (h ^ (w * (0x9E3779B1u + 2u * i))) * 0x85EBCA77u;
}

__device__ __forceinline__ uint32_t fold(uint32_t h) {
  return (h ^ (h >> 15)) & (N_BUCKETS - 1);
}

// the five keys: svc (dst, dport, proto), src (+ src), sport (+ sport),
// scan (src, proto), dport (src, proto, dport)
__device__ __forceinline__ void bucket_keys(const FeatRow& f, uint32_t* k) {
  const uint32_t svc3 = mix(mix(mix(0u, f.dst, 0), f.dport, 1), f.proto, 2);
  k[0] = fold(svc3);
  k[1] = fold(mix(svc3, f.src, 3));
  k[2] = fold(mix(svc3, f.sport, 3));
  const uint32_t scan2 = mix(mix(0u, f.src, 0), f.proto, 1);
  k[3] = fold(scan2);
  k[4] = fold(mix(scan2, f.dport, 2));
}

__device__ __forceinline__ bool syn_of(const FeatRow& f) {
  return (f.flags >> 1) & 1u;
}

// warp-aggregated add: the lanes sharing ``key`` add the popcount of
// ``mask`` over their group once, from the group's lowest lane
__device__ __forceinline__ void warp_add(uint32_t* counts, uint32_t key,
                                         unsigned peers, unsigned mask,
                                         int lane) {
  if (key == NO_KEY || lane != __ffs(peers) - 1) return;
  const unsigned c = __popc(peers & mask);
  if (c) atomicAdd(counts + key, c);
}

__global__ void __launch_bounds__(TPB) feat_count(FeatIO io) {
  const int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = i < io.n;
  uint32_t k[5] = {NO_KEY, NO_KEY, NO_KEY, NO_KEY, NO_KEY};
  bool syn = false, is_new = false;
  if (live) {
    const FeatRow f = load_row(io.hdr, i);
    bucket_keys(f, k);
    syn = syn_of(f);
    is_new = io.out[(size_t)i * OUT_WORDS + O_CT] == 0u;
  }
  const unsigned full = 0xFFFFFFFFu;
  const unsigned m_one = __ballot_sync(full, live);
  const unsigned m_syn = __ballot_sync(full, live && syn);
  const unsigned m_new = __ballot_sync(full, live && is_new);
  const unsigned m_sn = __ballot_sync(full, live && syn && is_new);
  uint32_t* c = io.counts;
  unsigned p = __match_any_sync(full, k[0]);
  warp_add(c + S_SVC_ONE * N_BUCKETS, k[0], p, m_one, lane);
  warp_add(c + S_SVC_SYN * N_BUCKETS, k[0], p, m_syn, lane);
  warp_add(c + S_SVC_NEW * N_BUCKETS, k[0], p, m_new, lane);
  p = __match_any_sync(full, k[1]);
  warp_add(c + S_SRC_ONE * N_BUCKETS, k[1], p, m_one, lane);
  p = __match_any_sync(full, k[2]);
  warp_add(c + S_SPORT_ONE * N_BUCKETS, k[2], p, m_one, lane);
  p = __match_any_sync(full, k[3]);
  warp_add(c + S_SCAN_NEWSYN * N_BUCKETS, k[3], p, m_sn, lane);
  warp_add(c + S_SCAN_ONE * N_BUCKETS, k[3], p, m_one, lane);
  p = __match_any_sync(full, k[4]);
  warp_add(c + S_DPORT_ONE * N_BUCKETS, k[4], p, m_one, lane);
}

__device__ __forceinline__ float cnt(const uint32_t* c, int set,
                                     uint32_t key) {
  return __uint2float_rn(c[set * N_BUCKETS + key]);
}

__device__ __forceinline__ float flag(bool b) { return b ? 1.0f : 0.0f; }

__global__ void __launch_bounds__(TPB) feat_write(FeatIO io) {
  __shared__ float tile[TPB * FEAT_DIM];
  const int32_t base = blockIdx.x * TPB;
  const int32_t i = base + threadIdx.x;
  if (i < io.n) {
    const FeatRow f = load_row(io.hdr, i);
    const uint32_t* o = io.out + (size_t)i * OUT_WORDS;
    uint32_t k[5];
    bucket_keys(f, k);
    const uint32_t* c = io.counts;
    const float proto = __uint2float_rn(f.proto);
    const float dport = __uint2float_rn(f.dport);
    const float sport = __uint2float_rn(f.sport);
    const float length = __uint2float_rn(f.len);
    const float ct = __uint2float_rn(o[O_CT]);
    const float syn = flag(syn_of(f));
    const float is_new = flag(ct == 0.0f);
    const float svc_n = cnt(c, S_SVC_ONE, k[0]);
    float* t = tile + threadIdx.x * FEAT_DIM;
    t[0] = flag(proto == 6.0f);
    t[1] = flag(proto == 17.0f);
    t[2] = flag(proto == 1.0f) + flag(proto == 58.0f);
    t[3] = log1pf(dport) / 12.0f;
    t[4] = log1pf(sport) / 12.0f;
    t[5] = flag(dport < 1024.0f);
    t[6] = log1pf(length) / 12.0f;
    t[7] = flag(length < 100.0f);
    t[8] = flag(f.flags & 1u);
    t[9] = syn;
    t[10] = flag((f.flags >> 2) & 1u);
    t[11] = flag((f.flags >> 3) & 1u);
    t[12] = flag((f.flags >> 4) & 1u);
    t[13] = __uint2float_rn(f.dirn);
    t[14] = is_new;
    t[15] = flag(ct == 1.0f);
    t[16] = flag(ct == 2.0f);
    t[17] = flag(o[O_VERDICT] == 1u);
    t[18] = flag(o[O_REASON] == 2u);
    t[19] = log1pf(svc_n) / 12.0f;
    t[20] = cnt(c, S_SVC_SYN, k[0]) / svc_n;
    t[21] = cnt(c, S_SVC_NEW, k[0]) / svc_n;
    t[22] = cnt(c, S_SRC_ONE, k[1]) / svc_n;
    t[23] = cnt(c, S_SPORT_ONE, k[2]) / svc_n;
    t[24] = log1pf(cnt(c, S_SCAN_NEWSYN, k[3])) / 12.0f;
    t[25] = cnt(c, S_DPORT_ONE, k[4]) / fmaxf(cnt(c, S_SCAN_ONE, k[3]), 1.0f);
    t[26] = 1.0f;
    io.id_row[i] = (int32_t)o[O_ID_ROW];
  }
  __syncthreads();
  const int32_t m = min(TPB, io.n - base);
  float* dst = io.feats + (size_t)base * FEAT_DIM;
  for (int32_t j = threadIdx.x; j < m * FEAT_DIM; j += TPB) dst[j] = tile[j];
}

// ---- K19 ---------------------------------------------------------------

constexpr int EMB = 32;             // D, the reference default
constexpr int HID = 64;             // H
constexpr int IN = EMB + FEAT_DIM;  // 59
constexpr int STB = 128;            // K19's threads a block
constexpr float NOV_DISABLED = 1e9f;
constexpr int SCORE_BLOCKS_MAX = 132 * 4;

// K19's dynamic shared memory: the weights as float32 (bf16-rounded),
// then a [HID, STB] bf16 column a thread for its x, later its hidden
// layer (each thread reads and writes only its own column)
constexpr int OFF_W1 = 0;
constexpr int OFF_W2 = OFF_W1 + IN * HID;
constexpr int OFF_W3 = OFF_W2 + HID * HID;
constexpr int OFF_B1 = OFF_W3 + HID;
constexpr int OFF_B2 = OFF_B1 + HID;
constexpr int OFF_MEAN = OFF_B2 + HID;
constexpr int OFF_PREC = OFF_MEAN + FEAT_DIM;
constexpr int N_FLOATS = OFF_PREC + FEAT_DIM * FEAT_DIM;
constexpr size_t SCORE_SMEM =
    sizeof(float) * N_FLOATS + sizeof(__nv_bfloat16) * HID * STB;
static_assert((sizeof(float) * N_FLOATS) % 16 == 0, "bf16 column alignment");
static_assert((sizeof(float) * OFF_W2) % 16 == 0, "w2 alignment");

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// torch.sigmoid's float32 formula on the card, 1 / (1 + exp(-x)): IEEE
// division, libdevice expf
__device__ __forceinline__ float sigmoidf(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// acc[j] = sum_k col[k] * w[k, j] for j < HID, float32 FMAs in k order;
// col is the thread's bf16 column (stride STB), w a [k_n, HID] row-major
// block in shared memory, read by all lanes at once (a broadcast)
__device__ __forceinline__ void layer(const __nv_bfloat16* col,
                                      const float* w, int k_n, float* acc) {
#pragma unroll
  for (int j = 0; j < HID; ++j) acc[j] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < k_n; ++k) {
    const float xk = __bfloat162float(col[k * STB]);
    const float4* wr = reinterpret_cast<const float4*>(w + k * HID);
#pragma unroll
    for (int q = 0; q < HID / 4; ++q) {
      const float4 v = wr[q];
      acc[4 * q] = fmaf(xk, v.x, acc[4 * q]);
      acc[4 * q + 1] = fmaf(xk, v.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(xk, v.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(xk, v.w, acc[4 * q + 3]);
    }
  }
}

// bf16(product) + bf16(b) in bf16, then ReLU
__device__ __forceinline__ float hidden(float acc, float b) {
  return fmaxf(bf16r(bf16r(acc) + b), 0.0f);
}

__global__ void __launch_bounds__(STB, 4) anomaly_score_kernel(ScoreIO io) {
  extern __shared__ __align__(16) float smem[];
  float* s_w1 = smem + OFF_W1;
  float* s_w2 = smem + OFF_W2;
  float* s_w3 = smem + OFF_W3;
  float* s_b1 = smem + OFF_B1;
  float* s_b2 = smem + OFF_B2;
  float* s_mean = smem + OFF_MEAN;
  float* s_prec = smem + OFF_PREC;
  __nv_bfloat16* col =
      reinterpret_cast<__nv_bfloat16*>(smem + N_FLOATS) + threadIdx.x;
  for (int j = threadIdx.x; j < IN * HID; j += STB) s_w1[j] = bf16r(io.w1[j]);
  for (int j = threadIdx.x; j < HID * HID; j += STB) s_w2[j] = bf16r(io.w2[j]);
  for (int j = threadIdx.x; j < HID; j += STB) {
    s_w3[j] = bf16r(io.w3[j]);
    s_b1[j] = bf16r(io.b1[j]);
    s_b2[j] = bf16r(io.b2[j]);
  }
  for (int j = threadIdx.x; j < FEAT_DIM; j += STB) s_mean[j] = io.feat_mean[j];
  for (int j = threadIdx.x; j < FEAT_DIM * FEAT_DIM; j += STB)
    s_prec[j] = io.feat_prec[j];
  __syncthreads();
  const float b3 = bf16r(io.b3[0]);
  const float thresh = io.nov_thresh[0];

  for (int32_t i = blockIdx.x * STB + threadIdx.x; i < io.n;
       i += gridDim.x * STB) {
    // x = bf16(concat(embed[id_row], feats)) into the thread's column
    const int64_t r = xla_index(io.id_row[i], io.v);
    const float4* e = reinterpret_cast<const float4*>(io.embed + r * EMB);
#pragma unroll
    for (int q = 0; q < EMB / 4; ++q) {
      const float4 v = e[q];
      col[(4 * q) * STB] = __float2bfloat16_rn(v.x);
      col[(4 * q + 1) * STB] = __float2bfloat16_rn(v.y);
      col[(4 * q + 2) * STB] = __float2bfloat16_rn(v.z);
      col[(4 * q + 3) * STB] = __float2bfloat16_rn(v.w);
    }
    const float* fr = io.feats + (size_t)i * FEAT_DIM;
    float d[FEAT_DIM];
#pragma unroll
    for (int f = 0; f < FEAT_DIM; ++f) {
      d[f] = fr[f];
      col[(EMB + f) * STB] = __float2bfloat16_rn(d[f]);
    }
    // novelty: d2 = sum_g (sum_f d_f P_fg) d_g, a rounded product and a
    // rounded add a term in the plain version's order (no FMA: its terms
    // cancel, so contraction would move d2's last bits)
#pragma unroll
    for (int f = 0; f < FEAT_DIM; ++f) d[f] = __fsub_rn(d[f], s_mean[f]);
    float d2 = 0.0f;
#pragma unroll 1
    for (int g = 0; g < FEAT_DIM; ++g) {
      float t = 0.0f;
#pragma unroll
      for (int f = 0; f < FEAT_DIM; ++f)
        t = __fadd_rn(t, __fmul_rn(d[f], s_prec[f * FEAT_DIM + g]));
      // d[g] by a shared-memory-free select keeps d in registers
      float dg = 0.0f;
#pragma unroll
      for (int f = 0; f < FEAT_DIM; ++f) dg = f == g ? d[f] : dg;
      d2 = __fadd_rn(d2, __fmul_rn(t, dg));
    }
    float acc[HID];
    layer(col, s_w1, IN, acc);
#pragma unroll
    for (int j = 0; j < HID; ++j)
      col[j * STB] = __float2bfloat16_rn(hidden(acc[j], s_b1[j]));
    layer(col, s_w2, HID, acc);
    float lacc = 0.0f;
#pragma unroll
    for (int j = 0; j < HID; ++j)
      lacc = fmaf(hidden(acc[j], s_b2[j]), s_w3[j], lacc);
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

}  // namespace

extern "C" int flow_features_launch(const FeatIO* io, cudaStream_t stream) {
  if (io->n > 0) {
    cudaError_t err = cudaMemsetAsync(
        io->counts, 0, sizeof(uint32_t) * N_SETS * N_BUCKETS, stream);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (io->n + TPB - 1) / TPB;
    feat_count<<<blocks, TPB, 0, stream>>>(*io);
    feat_write<<<blocks, TPB, 0, stream>>>(*io);
  }
  return (int)cudaGetLastError();
}

extern "C" int anomaly_score_launch(const ScoreIO* io, cudaStream_t stream) {
  // above 48 KB of shared memory a block needs the opt-in, once
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      anomaly_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SCORE_SMEM);
  if (opt_in != cudaSuccess) return (int)opt_in;
  if (io->n > 0) {
    const int blocks = min((io->n + STB - 1) / STB, SCORE_BLOCKS_MAX);
    anomaly_score_kernel<<<blocks, STB, SCORE_SMEM, stream>>>(*io);
  }
  return (int)cudaGetLastError();
}

extern "C" size_t ml_abi_size(int which) {
  return which == 0 ? sizeof(FeatIO) : which == 1 ? sizeof(ScoreIO) : 0;
}
