// K20 anomaly_train_fwd, K21 anomaly_train_bwd and K22 adam_update: the
// anomaly model's train step.
//
// All three replace the reference's jitted train step, cilium_tpu/ml/
// train.py make_train_step's _step (:124): jax.value_and_grad(bce_loss)
// (ml/model.py bce_loss :127 over forward :112), then optax.adam's
// update and apply_updates.  K20 is the forward half (the loss), K21 the
// gradient half, K22 the optimizer; their plain versions are
// cilium_tpu_torch/ml/model.py train_forward_plain / train_backward_plain
// and ml/train.py adam_update_plain.
//
// K20s and K21s (the same entry points with n_shards > 1) replace the
// mesh branch, the shard_map of _step over the batch axis (:138) and
// its pmean of the loss and the gradients (:127-130).  The batch is S
// contiguous blocks of B / S rows; each shard's loss and gradients are
// what K20/K21 give on its block alone (g = gloss / (B / S), each weight
// gradient rounded to bf16 once a shard), and the pmean is the first
// shard's value, the others added in shard order, divided by S.  So the
// sharded launch equals S unsharded launches on the blocks followed by
// that mean, bit for bit, and S = 1 is the unsharded step.  (The
// reference's mesh gradient under jax 0.9.0 is S times that mean: the
// gradient of a replicated leaf inside shard_map comes back psum-ed, and
// the pmean leaves the sum.  The port computes the mean its code asks
// for; ROADMAP C4.)
//
// Roundings (what jax.grad gives the reference, confirmed leaf by leaf
// by tests/test_torch_train.py): the forward is K19's (x = bf16(concat(
// embed[id_row], feats)), each product accumulated in float32 and rounded
// to bf16, + b in bf16, ReLU); the logit's cotangent is rounded to bf16
// where it crosses the logit's cast; each layer's input cotangent is a
// bf16 dot (float32 sums, one rounding); a weight's gradient is a float32
// sum over the batch rounded to bf16 once, then widened; the ReLU passes
// the gradient where its input was > 0.  A bf16 x bf16 product is exact
// in float32, so every FMA below equals the plain version's product-
// then-add, and the plain versions sum in the same order: on the same
// inputs K20's logits and saved activations, K21's weight and bias
// gradients and K22's outputs equal theirs bit for bit.  The embedding's
// gradient sums in K21's own grouping (below), which ml/model.py
// embed_grad_sorted_plain repeats bit for bit; it and K20's loss are
// within float32 rounding of the plain versions' index_add_ and sum.
//
// K20 (bound: bytes at the trainer's B = 4096, V = 16384, ~624 B a row:
// id_row, feats, label, the 128 B embedding row read; x, h1, h2 in bf16
// and the logit written; its ~15.9 kFLOP a row would take less on the
// bf16 tensor cores).  What held the one-thread-a-row kernel of PRs
// 10-14 back was latency, not bytes: 64 blocks of 2 warps on 132 SMs,
// 64 threads staging 7,936 weights with scalar loads, and a row's whole
// 7,936-FMA chain on one thread.  One launch, `fwd_rows`, grid (ceil(B /
// S / FR), S) so that no block straddles a shard (128 blocks of 8 warps
// at B = 4096):
//   - a row spreads over FG = 8 threads, a warp each (thread t: row
//     t % FR, warp g = t / FR), each owning 8 of h1's and of h2's 64
//     outputs in registers.  Each output is still one float32 FMA chain
//     in k order, so the bits are those of the thread-a-row kernel;
//   - every thread stages the weights with 16-byte loads, all in flight
//     at once, rounded to bf16 as they land in shared memory ([k][64]
//     bf16, 15.5 KB for w1 and w2), so a thread reads its 8 outputs'
//     weights of one k as one 16-byte load (a broadcast in its warp);
//   - the block's feats slab ([FR, 27] float32) is loaded coalesced into
//     shared memory and its embedding rows 16 bytes a thread; x, h1 and
//     h2 sit in bf16 columns ([feature][FR]) that the row's threads read,
//     and leave feature-major ([59 or 64, B] bf16 for K21) 16 bytes a
//     store, whole 32-byte sectors;
//   - the logit's 64-term chain (h2 . w3, in j order) runs on one thread
//     a row, over the h2 column, while the other warps store.
// The loss: each row's term lands in `partial`; the last block to finish
// (a ticket: __threadfence, then an atomicInc that wraps the counter
// back to 0, so no memset runs a call) sums each 64-row group in the
// fixed tree of the thread-a-row kernel (t[i] + t[i + 32], then halving),
// each shard's groups in order, divides by B / S and takes the shards'
// mean.  No float atomics: two runs give the same bits.  The ticket's
// counter belongs to the wrapper, one a (device, kind, stream): launches
// that share one run in stream order.  On the H100 (PERF.md, P15c) a
// launch at B = 4096 takes ~0.012 ms against the thread-a-row kernel's
// ~0.027: ~0.003 the launch, loads and staging, ~0.005 the rows, ~0.004
// the ticket and the last block's sums (a fence, an atomic and the L2
// loads in series).  Weights kept as float32 in shared memory were no
// faster, 16 rows a block slower.  Tensor cores (mma.sync / wgmma)
// would sum each output in another order and turn the bit-exact contract
// that K21's tests, the mesh equality and chip_smoke rest on into a
// tolerance, for ~1 us of arithmetic that is not where the time goes.
//
// K21 (bound: bytes, mostly d_embed's [V, 32] float32 written; ~2x K20's
// FLOPs).  Seven launches, in stream order, no memset; each pass's own
// bound at the trainer's B = 4096, V = 16384 is named with it:
//   1. bwd_rows, 8 threads a row and 16 rows a block (256 blocks of 4
//      warps at B = 4096): dlogit by the reference's autodiff rules with
//      g = gloss / (B / S); each thread takes 8 of dz2's and dh1's 64
//      outputs and 4 of dx[:, :32]'s, so a row's work spreads over the
//      SMs and a thread carries 8 sums, not 96.  dz2 = relu'(h2) bf16(dz3
//      w3), dh1 = dz2 W2^T, dz1, dx[:, :32] = dz1 W1[:32]^T: each output a
//      float32 FMA chain in k order over a bf16 column in shared memory.
//      W2^T and W1[:32]^T are staged bf16-rounded through a padded
//      transpose (coalesced global reads, conflict-free shared stores),
//      each thread reading its 8 (or 4) outputs' weights as one 16-byte
//      (8-byte) load.  Out: dz1, dz2 feature-major, dz3, and de =
//      bf16(dx[:, :32]) as float32 rows for the scatter.  Bound: ~650
//      B a row moved (~0.8 us) and 6144 FMAs a row (~0.75 us at 67
//      TFLOP/s);
//   2. wgrad_partial, one block a 64-row chunk of a shard's block and a
//      layer (grid (chunks a shard, 3, S), a shard's last chunk short):
//      every (input, output) pair's float32 sum over the chunk's rows in
//      row order, the bias as the sum against an input of ones (the
//      chunk staged in shared memory, an output's partial sum in a
//      register).  Bound: ~8065 FMAs a row (~1 us);
//   3. wgrad_reduce, the pmean: a thread an output; each shard's chunk
//      partials summed in chunk order and rounded to bf16, the shards'
//      values added in shard order, divided by S.  Fixed order, no
//      atomics: deterministic.  Bound: the 3.2 MB of partials (~1 us);
//   4-5. embed_radix, one pass a digit of 8 bits (the passes cover the
//      bits of V: two at V = 16384): a stable LSD radix sort of every
//      shard's block by its clamped key, over tiles of 256 rows (grid
//      (tiles a shard, S); tiles grow past 16384 rows a shard so a shard
//      has at most 64).  A block counts the digits of its shard in
//      shared memory (warp-aggregated integer atomics: exact in any
//      order), those of the tiles before its own apart, scans the
//      shard's counts, and scatters its tile 256 rows at a time, a row's
//      rank from __match_any_sync and a per-warp prefix.  The reference's
//      gather clamps an index, but its transpose, a scatter-add, drops
//      an index that is negative after one wrap or past the table: such
//      rows take the key V and sort last.  The first pass also marks
//      every (shard, key) absent.  Out: each shard's block sorted by
//      (key, row), as a sort of the block alone orders it, over the
//      whole card.  Bound: 16 B a row read and written (~0.02 us); a
//      block reads its shard's keys once more for the counts, so the
//      launch, not bytes, sets its time;
//   6. embed_piece, a warp per 32 sorted rows of a shard's block (a lane
//      a column): each segment's (key's) rows summed in row order; a
//      segment's sum over its first piece lands at its first sorted
//      position (seg), with that position in first[shard][key], and
//      each piece a segment runs on into leaves its part in head.
//      Bound: de's 128 B a row read, seg written (~0.3 us);
//   7. embed_finish, the pmean and the dense write: a warp per key of
//      [V, 32]; for each shard in order, the segment's first-piece sum
//      plus the heads of the pieces it runs into (found 32 at a time by
//      a ballot over the pieces' first keys, then added in order), a
//      shard's sum being 0 plus that, the shards' sums added in shard
//      order, divided by S; absent keys write 0.  One writer a key and
//      a fixed order: two runs give the same bits, S = 1 is the
//      unsharded launch, and a sharded launch equals its blocks'
//      unsharded launches and their mean bit for bit.  Bound: d_embed's
//      2 MB written (~0.6 us).
//
// K22 (bound: bytes, 28 B a parameter: p, g, mu, nu read, p, mu, nu
// written; 532,353 parameters at V = 16384, 0.0044 ms).  ONE launch a
// step: one fused pass over every trainable leaf, densely as optax does
// (every embedding row's moments decay every step).  The launcher
// flattens the leaf table into work units: 16-byte units (four
// parameters, float4 loads and stores) where a leaf's four pointers are
// 16-byte aligned, then one unit a parameter for its tail (and for a leaf
// that is not, such as a view at a 4-byte offset or b3's one element).  A
// grid of at most ADAM_BLOCKS_PER_SM blocks an SM strides over the units,
// a thread's leaf found by a search that only moves forward.  Thread 0 of
// each block reads count (on the card, so a step never syncs with the
// host), computes the bias corrections 1 - b^(count+1) once for its
// block, and takes a last-block ticket (the per-(device, kernel, stream)
// counter K20 uses; atomicInc wraps it back to 0): every block has read
// count before the last ticket is taken, so the last block alone adds one
// to it, saturating at INT_MAX, as optax's safe_int32_increment does.
// Each thread starts its first unit's loads before it waits for thread
// 0's bias corrections.  The element arithmetic is the plain version's
// sequence of __fmul_rn, __fadd_rn, __fdiv_rn and __fsqrt_rn in the same
// order, and powf gives the same bias corrections, so the outputs are the
// same bits.  Nothing a step changes passes by value: the launch can be
// captured in a CUDA graph.  On the H100 (PERF.md) a step takes ~0.0077
// ms: the 14.9 MB move at ~2.2 TB/s in one wave, reads and then writes;
// fewer blocks holding several units a thread were slower.
//
// No library product runs: every product is this file's FMA chain.
// Tensor cores (mma.sync / wgmma on bf16 tiles) are later work.
#include <cuda_bf16.h>
#include <climits>

#include "views.cuh"

namespace {

constexpr int EMB = 32;             // D
constexpr int HID = 64;             // H
constexpr int FEAT_DIM = 27;
constexpr int IN = EMB + FEAT_DIM;  // 59
constexpr int FR = 32;              // rows a block of fwd_rows
constexpr int FG = 8;               // threads (a warp each) a row of fwd_rows
constexpr int FT = FR * FG;         // threads of fwd_rows
constexpr int LOSS_GROUP = 64;      // rows a partial loss sum (its tree)
constexpr int LOSS_PASS = 64;       // loss groups summed a pass of the tail
constexpr int W4 = (IN * HID + HID * HID) / 4;  // w1, w2 in 16-byte loads
constexpr int CHUNK = 64;           // rows a block of wgrad_partial (the
                                    // plain version's WGRAD_CHUNK)
constexpr int WTB = 256;            // threads of the wgrad and scatter blocks
constexpr int BR = 16;              // rows a block of bwd_rows
constexpr int BG = 8;               // threads a row of bwd_rows
constexpr int SORT_TB = 256;        // threads and rows a pass of embed_radix
constexpr int RADIX = 256;          // 8-bit digits
constexpr int MAX_TILES = 64;       // embed_radix's tiles a shard, at most
constexpr int HIST_BATCH = 8;      // embed_radix's sub-tiles a load batch
constexpr int PIECE = 32;           // sorted rows a warp of embed_piece
constexpr int MAX_LEAVES = 8;
constexpr int ATB = 256;            // threads of adam_kernel
constexpr int ADAM_BLOCKS_PER_SM = 4;  // its grid, at most
static_assert(SORT_TB == RADIX, "embed_radix: a thread a digit");
static_assert(HID / BG == 8 && EMB / BG == 4,
              "bwd_rows: a thread's outputs are one 16-byte (8-byte) load");
static_assert(HID / FG == 8 && FR % 8 == 0 && FR <= 32 &&
                  (IN * HID) % 8 == 0,
              "fwd_rows: a thread's outputs of a k are one 16-byte load, "
              "a column's rows whole 16-byte stores");
static_assert(FT == EMB / 4 * FR && LOSS_GROUP == 64 &&
                  LOSS_PASS % (FT / 32) == 0,
              "fwd_rows: an embedding float4 a thread; the loss tree "
              "takes a group as two halves of a warp's lanes, a pass's "
              "groups spread evenly over the warps");
constexpr int W_PER = (W4 + FT - 1) / FT;               // weight float4s
constexpr int F_PER = (FR * FEAT_DIM + FT - 1) / FT;    // feats a thread
// K22: optax.adam's defaults (eps_root 0), as ml/train.py's B1, B2, EPS;
// 1 - b is taken in double and rounded once, as the reference's is
constexpr float ADAM_B1 = 0.9f;
constexpr float ADAM_B2 = 0.999f;
constexpr float ADAM_OMB1 = (float)(1.0 - 0.9);
constexpr float ADAM_OMB2 = (float)(1.0 - 0.999);
constexpr float ADAM_EPS = 1e-8f;

}  // namespace

// K20's arguments: the batch, the trainable leaves (float32), what the
// backward keeps, the loss.
struct TrainFwdIO {
  const int32_t* id_row;  // [n]
  const float* feats;     // [n, 27]
  const float* labels;    // [n]
  const float* embed;     // [v, 32]
  const float* w1;        // [59, 64]
  const float* b1;        // [64]
  const float* w2;        // [64, 64]
  const float* b2;        // [64]
  const float* w3;        // [64, 1]
  const float* b3;        // [1]
  __nv_bfloat16* xT;      // [59, n] x, feature-major
  __nv_bfloat16* h1T;     // [64, n]
  __nv_bfloat16* h2T;     // [64, n]
  float* logit;           // [n]
  float* partial;         // [n] each row's loss term
  float* loss;            // [1]
  uint32_t* ticket;       // [1] the blocks done; 0 between launches
  int32_t n;
  int32_t v;
  int32_t n_shards;  // n rows in n_shards blocks of block rows (1 and n:
  int32_t block;     // the unsharded step)
};

// K21's arguments: the batch, K20's saved activations, the weights, the
// scratch and the gradients.
struct TrainBwdIO {
  const int32_t* id_row;       // [n]
  const float* labels;         // [n]
  const float* gloss;          // [1] the loss's cotangent (on the card)
  const float* logit;          // [n]
  const __nv_bfloat16* xT;     // [59, n]
  const __nv_bfloat16* h1T;    // [64, n]
  const __nv_bfloat16* h2T;    // [64, n]
  const float* w1;             // [59, 64]
  const float* w2;             // [64, 64]
  const float* w3;             // [64, 1]
  __nv_bfloat16* dz1T;         // [64, n] scratch
  __nv_bfloat16* dz2T;         // [64, n] scratch
  __nv_bfloat16* dz3;          // [n] scratch
  float* de;                   // [n, 32] scratch
  float* wpart;                // [3, S * chunks a shard, 65 * 64] scratch
  int32_t* key_tmp;            // [n] scratch: the radix passes' ping-pong
  int32_t* row_tmp;            // [n] scratch
  int32_t* sorted_key;         // [n] scratch: each shard's block by (key,
  int32_t* sorted_row;         // [n] row), dropped rows last (key v)
  int32_t* first;              // [S, v] scratch: a segment's first sorted
                               // position in its block, or -1
  float* seg;                  // [n, 32] scratch: a segment's sum over its
                               // first piece, at its first position
  float* head;                 // [S * pieces a shard, 32] scratch: a piece's
                               // part of a segment begun before it
  float* dw1;                  // [59, 64] out
  float* db1;                  // [64]
  float* dw2;                  // [64, 64]
  float* db2;                  // [64]
  float* dw3;                  // [64, 1]
  float* db3;                  // [1]
  float* d_embed;              // [v, 32] out
  int32_t n;
  int32_t v;
  int32_t n_shards;  // n rows in n_shards blocks of block rows (1 and n:
  int32_t block;     // the unsharded step)
};

// K22: one leaf of the update; its blocks start at block0.
struct AdamLeaf {
  float* p;
  const float* g;
  float* mu;
  float* nu;
  int64_t n;
  int64_t n4;     // the launcher's: 16-byte units (0: the leaf unaligned)
  int64_t unit0;  // the launcher's: the leaf's first unit
};

struct AdamIO {
  AdamLeaf leaf[MAX_LEAVES];
  int32_t* count;    // [] on the card
  uint32_t* ticket;  // [1] the blocks done; 0 between launches
  int64_t units;     // the launcher's: the units of every leaf
  int32_t n_leaves;
  float neg_lr;      // -lr
};

namespace {

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf2f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 8 bf16 (or 4) from shared memory as floats (a bf16 is the high half
// of its float)
__device__ __forceinline__ void unpack_bf16x2(unsigned u, float& lo,
                                              float& hi) {
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xFFFF0000u);
}

// bf16(product) + bf16(b) in bf16, then ReLU (K19's rounding points)
__device__ __forceinline__ float hidden(float acc, float b) {
  return fmaxf(bf16r(bf16r(acc) + b), 0.0f);
}

// ---- K20 ---------------------------------------------------------------

// acc[e] = sum_k col[k] * w[k][8g + e], float32 FMAs in k order; col is
// the thread's row in a bf16 column of the block ([k][FR]), w a [k_n, 64]
// bf16 block in shared memory whose 8 weights of a k are one 16-byte
// load, the same address across the warp (a broadcast)
__device__ __forceinline__ void layer8(const __nv_bfloat16* col,
                                       const __nv_bfloat16* w, int k_n,
                                       int g, float* acc) {
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < k_n; ++k) {
    const float xk = bf2f(col[k * FR]);
    const uint4 wv = *reinterpret_cast<const uint4*>(w + k * HID + 8 * g);
    float wk[8];
    unpack_bf16x2(wv.x, wk[0], wk[1]);
    unpack_bf16x2(wv.y, wk[2], wk[3]);
    unpack_bf16x2(wv.z, wk[4], wk[5]);
    unpack_bf16x2(wv.w, wk[6], wk[7]);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = fmaf(xk, wk[e], acc[e]);
  }
}

// The last block of the grid to get here returns true, the counter then
// back at 0.  The block's terms were written by its first FR threads
// (its logit warp): they alone fence before the ticket, so the other
// warps' stores of x, h1 and h2 need not land first.
__device__ __forceinline__ bool last_block(const TrainFwdIO& io) {
  __shared__ bool s_last;
  if (threadIdx.x < FR) {
    __threadfence();
    __syncwarp(FR == 32 ? 0xFFFFFFFFu : (1u << FR) - 1u);
    if (threadIdx.x == 0) {
      const unsigned blocks = gridDim.x * gridDim.y;
      s_last = atomicInc(io.ticket, blocks - 1) == blocks - 1;
      // the other blocks' terms before this block reads them (the
      // barrier below carries the order to its other threads, whose own
      // stores need not land first)
      if (s_last) __threadfence();
    }
  }
  __syncthreads();
  return s_last;
}

// The loss from the row terms, by one block: each 64-row group of a
// shard in the thread-a-row kernel's tree (t[i] + t[i + 32], then
// halving: a warp a group), each shard's groups in order from 0, over B
// / S, then the shards' mean.  Rows past a shard's block count 0.  The
// groups of all shards go LOSS_PASS at a time, every term of a pass
// loaded at once (a warp's LOSS_PASS / 8 groups in flight together).
__device__ __forceinline__ void loss_tail(const TrainFwdIO& io) {
  __shared__ float s_grp[LOSS_PASS];
  constexpr int per_warp = LOSS_PASS / (FT / 32);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t block = io.block;
  const int32_t groups = (block + LOSS_GROUP - 1) / LOSS_GROUP;  // a shard's
  const int32_t all = groups * io.n_shards;  // < 2^31: at most n / 64 + S
  float sum = 0.0f, total = 0.0f;  // thread 0's: this shard's, the mean's
  int32_t m_next = 0, z_next = 0;  // thread 0's: the next group's place
  for (int32_t g0 = 0; g0 < all; g0 += LOSS_PASS) {
    float x[per_warp];
#pragma unroll
    for (int u = 0; u < per_warp; ++u) {
      const int32_t gi = g0 + warp + u * (FT / 32);
      x[u] = 0.0f;
      if (gi < all) {
        const int32_t z = gi / groups, m = gi - z * groups;
        const float* t = io.partial + (size_t)z * block;
        const int32_t a = m * LOSS_GROUP + lane, b = a + 32;
        x[u] = __fadd_rn(a < block ? __ldcg(t + a) : 0.0f,
                         b < block ? __ldcg(t + b) : 0.0f);
      }
    }
#pragma unroll
    for (int u = 0; u < per_warp; ++u) {
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        x[u] = __fadd_rn(x[u], __shfl_down_sync(0xFFFFFFFFu, x[u], s));
      if (lane == 0) s_grp[warp + u * (FT / 32)] = x[u];
    }
    __syncthreads();
    if (tid == 0) {
      const int cnt = all - g0 < LOSS_PASS ? all - g0 : LOSS_PASS;
      for (int u = 0; u < cnt;) {
        // the pass's groups of one shard, then that shard's end
        const int take = min(cnt - u, groups - m_next);
#pragma unroll 8
        for (int e = u + take; u < e; ++u) sum = __fadd_rn(sum, s_grp[u]);
        m_next += take;
        if (m_next == groups) {
          const float ls = __fdiv_rn(sum, (float)block);
          total = z_next == 0 ? ls : __fadd_rn(total, ls);
          sum = 0.0f;
          m_next = 0;
          ++z_next;
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) io.loss[0] = __fdiv_rn(total, (float)io.n_shards);
}

// a block: FR rows of one shard, FG threads a row (thread t: row t % FR,
// warp t / FR)
__global__ void __launch_bounds__(FT) fwd_rows(TrainFwdIO io) {
  __shared__ __align__(16) __nv_bfloat16 s_w[IN * HID + HID * HID];
  __shared__ float s_b1[HID], s_b2[HID], s_w3[HID];
  __shared__ float s_feat[FR * FEAT_DIM];
  __shared__ __align__(16) __nv_bfloat16 s_x[IN * FR];   // [k][row]
  __shared__ __align__(16) __nv_bfloat16 s_h1[HID * FR];
  __shared__ __align__(16) __nv_bfloat16 s_h2[HID * FR];
  const int tid = threadIdx.x, r = tid % FR, g = tid / FR;
  const int32_t n = io.n, local0 = blockIdx.x * FR;
  const int32_t rows = min(FR, io.block - local0);  // of this block
  const int32_t i0 = blockIdx.y * io.block + local0;
  // every load in flight at once: the weights 16 bytes a load, the feats
  // slab coalesced, a float4 of an embedding row a thread
  float4 wv[W_PER];
#pragma unroll
  for (int u = 0; u < W_PER; ++u) {
    const int q = tid + u * FT;
    if (q < W4)
      wv[u] = q < IN * HID / 4
                  ? reinterpret_cast<const float4*>(io.w1)[q]
                  : reinterpret_cast<const float4*>(io.w2)[q - IN * HID / 4];
  }
  float fv[F_PER];
#pragma unroll
  for (int u = 0; u < F_PER; ++u) {
    const int q = tid + u * FT;
    fv[u] = q < rows * FEAT_DIM ? io.feats[(size_t)i0 * FEAT_DIM + q] : 0.0f;
  }
  const int er = tid / (EMB / 4), eq = tid % (EMB / 4);
  float4 ev = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (er < rows) {
    const int64_t row = xla_index(io.id_row[i0 + er], io.v);
    ev = reinterpret_cast<const float4*>(io.embed + row * EMB)[eq];
  }
  float b1 = 0.0f, b2 = 0.0f, w3 = 0.0f;
  if (tid < HID) {
    b1 = io.b1[tid];
    b2 = io.b2[tid];
    w3 = io.w3[tid];
  }
#pragma unroll
  for (int u = 0; u < W_PER; ++u) {
    const int q = tid + u * FT;
    if (q < W4) {
      const __nv_bfloat162 lo =
          __float22bfloat162_rn(make_float2(wv[u].x, wv[u].y));
      const __nv_bfloat162 hi =
          __float22bfloat162_rn(make_float2(wv[u].z, wv[u].w));
      uint2 p;
      p.x = *reinterpret_cast<const unsigned*>(&lo);
      p.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(s_w + 4 * q) = p;
    }
  }
#pragma unroll
  for (int u = 0; u < F_PER; ++u) {
    const int q = tid + u * FT;
    if (q < FR * FEAT_DIM) s_feat[q] = fv[u];
  }
  s_x[(4 * eq) * FR + er] = __float2bfloat16_rn(ev.x);
  s_x[(4 * eq + 1) * FR + er] = __float2bfloat16_rn(ev.y);
  s_x[(4 * eq + 2) * FR + er] = __float2bfloat16_rn(ev.z);
  s_x[(4 * eq + 3) * FR + er] = __float2bfloat16_rn(ev.w);
  if (tid < HID) {
    s_b1[tid] = bf16r(b1);
    s_b2[tid] = bf16r(b2);
    s_w3[tid] = bf16r(w3);
  }
  __syncthreads();
  // x's feature columns from the slab (a stride of 27 words: no bank
  // conflict); rows past the block's end are zeros
  for (int f = g; f < FEAT_DIM; f += FG)
    s_x[(EMB + f) * FR + r] = __float2bfloat16_rn(s_feat[r * FEAT_DIM + f]);
  __syncthreads();
  float acc[8];
  layer8(s_x + r, s_w, IN, g, acc);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int j = 8 * g + e;
    s_h1[j * FR + r] = __float2bfloat16_rn(hidden(acc[e], s_b1[j]));
  }
  __syncthreads();
  layer8(s_h1 + r, s_w + IN * HID, HID, g, acc);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int j = 8 * g + e;
    s_h2[j * FR + r] = __float2bfloat16_rn(hidden(acc[e], s_b2[j]));
  }
  __syncthreads();
  if (g == 0) {
    // the logit, one thread a row: h2 . w3 in j order (h2 is bf16 exact)
    float lacc = 0.0f;
#pragma unroll 16
    for (int j = 0; j < HID; ++j)
      lacc = fmaf(bf2f(s_h2[j * FR + r]), s_w3[j], lacc);
    if (r < rows) {
      const int32_t i = i0 + r;
      const float logit = bf16r(bf16r(lacc) + bf16r(io.b3[0]));
      io.logit[i] = logit;
      // max(l, 0) - l * y + log1p(exp(-|l|)), the reference's order
      io.partial[i] = __fadd_rn(__fsub_rn(fmaxf(logit, 0.0f),
                                          __fmul_rn(logit, io.labels[i])),
                                log1pf(expf(-fabsf(logit))));
    }
  } else {
    // x, h1, h2 feature-major, 8 rows (16 bytes) a store where the batch
    // and the block's rows allow
    const bool vec = io.block % 8 == 0;
    constexpr int parts = FR / 8;
    for (int c = tid - FR; c < (IN + 2 * HID) * parts; c += FT - FR) {
      const int f = c / parts, r0 = (c % parts) * 8;
      const __nv_bfloat16* src;
      __nv_bfloat16* dst;
      if (f < IN) {
        src = s_x + f * FR;
        dst = io.xT + (size_t)f * n;
      } else if (f < IN + HID) {
        src = s_h1 + (f - IN) * FR;
        dst = io.h1T + (size_t)(f - IN) * n;
      } else {
        src = s_h2 + (f - IN - HID) * FR;
        dst = io.h2T + (size_t)(f - IN - HID) * n;
      }
      if (vec && r0 + 8 <= rows) {
        *reinterpret_cast<uint4*>(dst + i0 + r0) =
            *reinterpret_cast<const uint4*>(src + r0);
      } else {
        for (int u = r0; u < min(r0 + 8, rows); ++u) dst[i0 + u] = src[u];
      }
    }
  }
  if (!last_block(io)) return;
  loss_tail(io);
}

// ---- K21 ---------------------------------------------------------------

// a block: BR rows, BG threads a row (thread t: row t % BR, group t / BR)
__global__ void __launch_bounds__(BR * BG) bwd_rows(TrainBwdIO io) {
  __shared__ float s_tmp[HID * (HID + 1)];  // a padded transpose
  __shared__ __align__(16) __nv_bfloat16 s_w2t[HID * HID];  // [j][k] = W2[k][j]
  __shared__ __align__(16) __nv_bfloat16 s_w1t[HID * EMB];  // [k][m] = W1[m][k]
  __shared__ float s_w3[HID];
  __shared__ __nv_bfloat16 s_dz2[HID * BR];  // [j][row]
  __shared__ __nv_bfloat16 s_dz1[HID * BR];  // [k][row]
  const int tid = threadIdx.x;
  // W2 and W1[:32] read along their rows, all loads in flight at once,
  // then written transposed: the padded row of 65 puts a column's 32
  // reads in 32 banks
  constexpr int kW2 = HID * HID / (BR * BG), kW1 = EMB * HID / (BR * BG);
  float w2r[kW2], w1r[kW1];
#pragma unroll
  for (int u = 0; u < kW2; ++u) w2r[u] = io.w2[tid + u * BR * BG];
#pragma unroll
  for (int u = 0; u < kW1; ++u) w1r[u] = io.w1[tid + u * BR * BG];
  for (int j = tid; j < HID; j += BR * BG) s_w3[j] = bf16r(io.w3[j]);
#pragma unroll
  for (int u = 0; u < kW2; ++u) {
    const int f = tid + u * BR * BG;  // W2[k][j], k = f / 64
    s_tmp[(f >> 6) * (HID + 1) + (f & 63)] = w2r[u];
  }
  __syncthreads();
#pragma unroll 8
  for (int f = tid; f < HID * HID; f += BR * BG)
    s_w2t[f] = __float2bfloat16_rn(s_tmp[(f & 63) * (HID + 1) + (f >> 6)]);
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kW1; ++u) {
    const int f = tid + u * BR * BG;  // W1[m][k], m = f / 64
    s_tmp[(f >> 6) * (HID + 1) + (f & 63)] = w1r[u];
  }
  __syncthreads();
#pragma unroll 8
  for (int f = tid; f < HID * EMB; f += BR * BG)
    s_w1t[f] = __float2bfloat16_rn(s_tmp[(f & 31) * (HID + 1) + (f >> 5)]);
  const int r = tid % BR, g = tid / BR;
  const int32_t n = io.n;
  const int32_t i = blockIdx.x * BR + r;
  const bool live = i < n;
  // dlogit: with g = gloss / (B / S) and t = exp(-|l|), the rules
  // jax.grad derives from bce_loss: maximum splits its tie (1/2 at l ==
  // 0), abs takes the + branch at 0
  float dz3f = 0.0f;
  if (live) {
    const float gl = __fdiv_rn(io.gloss[0], (float)io.block);
    const float l = io.logit[i];
    const float t = expf(-fabsf(l));
    const float ct = __fmul_rn(__fdiv_rn(gl, __fadd_rn(t, 1.0f)), t);
    const float cz = l >= 0.0f ? -ct : ct;
    const float cf = l > 0.0f ? 1.0f : (l == 0.0f ? 0.5f : 0.0f);
    const float dl = __fadd_rn(__fadd_rn(cz, __fmul_rn(-gl, io.labels[i])),
                               __fmul_rn(gl, cf));
    const __nv_bfloat16 dz3 = __float2bfloat16_rn(dl);
    dz3f = bf2f(dz3);
    if (g == 0) io.dz3[i] = dz3;
  }
#pragma unroll
  for (int e = 0; e < HID / BG; ++e) {
    const int j = g * (HID / BG) + e;
    const bool on = live && bf2f(io.h2T[(size_t)j * n + i]) > 0.0f;
    const __nv_bfloat16 d =
        __float2bfloat16_rn(on ? __fmul_rn(dz3f, s_w3[j]) : 0.0f);
    s_dz2[j * BR + r] = d;
    if (live) io.dz2T[(size_t)j * n + i] = d;
  }
  __syncthreads();
  // dh1[k] = sum_j dz2[j] W2[k][j], k = 8g .. 8g + 7
  float acc[HID / BG];
#pragma unroll
  for (int e = 0; e < HID / BG; ++e) acc[e] = 0.0f;
#pragma unroll 8
  for (int j = 0; j < HID; ++j) {
    const float x = bf2f(s_dz2[j * BR + r]);
    const uint4 wv =
        *reinterpret_cast<const uint4*>(s_w2t + j * HID + g * (HID / BG));
    float w[8];
    unpack_bf16x2(wv.x, w[0], w[1]);
    unpack_bf16x2(wv.y, w[2], w[3]);
    unpack_bf16x2(wv.z, w[4], w[5]);
    unpack_bf16x2(wv.w, w[6], w[7]);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = fmaf(x, w[e], acc[e]);
  }
#pragma unroll
  for (int e = 0; e < HID / BG; ++e) {
    const int k = g * (HID / BG) + e;
    const bool on = live && bf2f(io.h1T[(size_t)k * n + i]) > 0.0f;
    const __nv_bfloat16 d = __float2bfloat16_rn(on ? acc[e] : 0.0f);
    s_dz1[k * BR + r] = d;
    if (live) io.dz1T[(size_t)k * n + i] = d;
  }
  __syncthreads();
  // dx[:, m] = sum_k dz1[k] W1[m][k], m = 4g .. 4g + 3
  float de[EMB / BG];
#pragma unroll
  for (int e = 0; e < EMB / BG; ++e) de[e] = 0.0f;
#pragma unroll 8
  for (int k = 0; k < HID; ++k) {
    const float x = bf2f(s_dz1[k * BR + r]);
    const uint2 wv =
        *reinterpret_cast<const uint2*>(s_w1t + k * EMB + g * (EMB / BG));
    float w[4];
    unpack_bf16x2(wv.x, w[0], w[1]);
    unpack_bf16x2(wv.y, w[2], w[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) de[e] = fmaf(x, w[e], de[e]);
  }
  if (live)
    *reinterpret_cast<float4*>(io.de + (size_t)i * EMB + g * (EMB / BG)) =
        make_float4(bf16r(de[0]), bf16r(de[1]), bf16r(de[2]), bf16r(de[3]));
}

// layer y's (inputs A, cotangents D) for the weight gradients: y = 0 is
// (x, dz1) -> w1/b1, 1 (h1, dz2) -> w2/b2, 2 (h2, dz3) -> w3/b3
struct WgradJob {
  const __nv_bfloat16* a;
  const __nv_bfloat16* d;
  float* dw;
  float* db;
  int ka;
  int nd;
};

__device__ __forceinline__ WgradJob wgrad_job(const TrainBwdIO& io, int y) {
  if (y == 0) return {io.xT, io.dz1T, io.dw1, io.db1, IN, HID};
  if (y == 1) return {io.h1T, io.dz2T, io.dw2, io.db2, HID, HID};
  return {io.h2T, io.dz3, io.dw3, io.db3, HID, 1};
}

constexpr int WOUT = (HID + 1) * HID;  // a job's outputs, at most

// grid (chunks a shard, 3, S): chunk x of shard z's block; rows past
// the block's end are zeros
__global__ void __launch_bounds__(WTB) wgrad_partial(TrainBwdIO io,
                                                     int chunks) {
  __shared__ float s_a[(HID + 1) * CHUNK];  // [input][row], ones last
  __shared__ float s_d[CHUNK * (HID + 1)];  // [row][output], padded
  const WgradJob job = wgrad_job(io, blockIdx.y);
  const int32_t n = io.n;
  const int32_t local0 = blockIdx.x * CHUNK;
  const int32_t row0 = blockIdx.z * io.block + local0;
  const int32_t end = io.block - local0;  // rows of the chunk in the block
  const int tid = threadIdx.x;
  for (int idx = tid; idx < job.ka * CHUNK; idx += WTB) {
    const int a = idx / CHUNK, r = idx % CHUNK;
    s_a[idx] = r < end ? bf2f(job.a[(size_t)a * n + row0 + r]) : 0.0f;
  }
  for (int r = tid; r < CHUNK; r += WTB)
    s_a[job.ka * CHUNK + r] = r < end ? 1.0f : 0.0f;
  for (int idx = tid; idx < job.nd * CHUNK; idx += WTB) {
    const int dd = idx / CHUNK, r = idx % CHUNK;
    s_d[r * (HID + 1) + dd] =
        r < end ? bf2f(job.d[(size_t)dd * n + row0 + r]) : 0.0f;
  }
  __syncthreads();
  const int outs = (job.ka + 1) * job.nd;
  float* part = io.wpart +
                (((size_t)blockIdx.y * io.n_shards + blockIdx.z) * chunks +
                 blockIdx.x) * WOUT;
  for (int o = tid; o < outs; o += WTB) {
    const int a = o / job.nd, dd = o % job.nd;
    const float* sa = s_a + a * CHUNK;
    float acc = 0.0f;
#pragma unroll 8
    for (int r = 0; r < CHUNK; ++r)
      acc = fmaf(sa[r], s_d[r * (HID + 1) + dd], acc);
    part[o] = acc;
  }
}

// the pmean: each shard's chunks in chunk order, rounded to bf16 (the
// unsharded gradient of its block), the shards added in shard order,
// divided by S
__global__ void __launch_bounds__(WTB) wgrad_reduce(TrainBwdIO io,
                                                    int chunks) {
  const WgradJob job = wgrad_job(io, blockIdx.y);
  const int outs = (job.ka + 1) * job.nd;
  const int o = blockIdx.x * WTB + threadIdx.x;
  if (o >= outs) return;
  const int n_shards = io.n_shards;
  const float* part =
      io.wpart + (size_t)blockIdx.y * n_shards * chunks * WOUT + o;
  float total = 0.0f;
  for (int z = 0; z < n_shards; ++z) {
    float s = 0.0f;
    for (int c = 0; c < chunks; ++c)
      s = __fadd_rn(s, part[((size_t)z * chunks + c) * WOUT]);
    const float g = bf16r(s);
    total = z == 0 ? g : __fadd_rn(total, g);
  }
  const float v = __fdiv_rn(total, (float)n_shards);
  if (o / job.nd < job.ka)
    job.dw[o] = v;
  else
    job.db[o % job.nd] = v;
}

// ---- K21's embedding scatter ----------------------------------------

// the table row the scatter-add writes for batch row `row`, or v where
// it drops the row
__device__ __forceinline__ int32_t scatter_key(const TrainBwdIO& io,
                                               int32_t row) {
  int64_t key = io.id_row[row];
  if (key < 0) key += io.v;
  return key >= 0 && key < io.v ? (int32_t)key : io.v;
}

// One LSD pass over digit (key >> shift) & 255: grid (tiles a shard, S),
// a tile `subs` sub-tiles of SORT_TB rows.  in_key is null on the first
// pass (keys from id_row, rows in batch order).  Stable: a shard's rows
// keep their order within a digit.
__global__ void __launch_bounds__(SORT_TB) embed_radix(
    TrainBwdIO io, const int32_t* in_key, const int32_t* in_row,
    int32_t* out_key, int32_t* out_row, int shift, int subs) {
  __shared__ int32_t s_total[RADIX];   // the shard's rows a digit
  __shared__ int32_t s_next[RADIX];    // rows before this tile, then the
                                       // digit's next position
  __shared__ int32_t s_warp[SORT_TB / 32][RADIX];
  __shared__ int32_t s_wsum[SORT_TB / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t block = io.block, base = blockIdx.y * block;
  const int32_t k0 = blockIdx.x * subs;        // this tile's first sub-tile
  const int32_t n_sub = (block + SORT_TB - 1) / SORT_TB;  // a shard's
  const bool first_pass = in_key == nullptr;
  if (first_pass) {
    const int64_t all = (int64_t)io.n_shards * io.v;
    for (int64_t x = ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) *
                         SORT_TB + tid;
         x < all; x += (int64_t)gridDim.x * gridDim.y * SORT_TB)
      io.first[x] = -1;
  }
  s_total[tid] = 0;
  s_next[tid] = 0;
  __syncthreads();
  // the shard's digits, HIST_BATCH sub-tiles' loads in flight at once
  for (int32_t kb = 0; kb < n_sub; kb += HIST_BATCH) {
    int d[HIST_BATCH];
#pragma unroll
    for (int u = 0; u < HIST_BATCH; ++u) {
      const int32_t j = (kb + u) * SORT_TB + tid;
      d[u] = -1;
      if (kb + u < n_sub && j < block) {
        const int32_t key =
            first_pass ? scatter_key(io, base + j) : in_key[base + j];
        d[u] = (key >> shift) & (RADIX - 1);
      }
    }
#pragma unroll
    for (int u = 0; u < HIST_BATCH; ++u) {
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, d[u]);
      if (d[u] >= 0 && lane == __ffs(peers) - 1) {
        atomicAdd(&s_total[d[u]], __popc(peers));
        if (kb + u < k0) atomicAdd(&s_next[d[u]], __popc(peers));
      }
    }
  }
  __syncthreads();
  {  // exclusive scan of the shard's counts over the digits
    const int32_t c = s_total[tid];
    int32_t x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_wsum[warp] = x;
    __syncthreads();
    int32_t below = 0;
    for (int w = 0; w < warp; ++w) below += s_wsum[w];
    s_next[tid] += base + below + x - c;
  }
  const int32_t k_end = min(k0 + subs, n_sub);
  for (int32_t k = k0; k < k_end; ++k) {
    const int32_t j = k * SORT_TB + tid;
    int d = -1;
    int32_t key = 0, row = 0;
    if (j < block) {
      key = first_pass ? scatter_key(io, base + j) : in_key[base + j];
      row = first_pass ? base + j : in_row[base + j];
      d = (key >> shift) & (RADIX - 1);
    }
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    for (int x = tid; x < (SORT_TB / 32) * RADIX; x += SORT_TB)
      (&s_warp[0][0])[x] = 0;
    __syncthreads();
    if (d >= 0 && rank == 0) s_warp[warp][d] = __popc(peers);
    __syncthreads();
    {  // a thread a digit: the warps' exclusive prefix from its position
      int32_t at = s_next[tid];
      for (int w = 0; w < SORT_TB / 32; ++w) {
        const int32_t c = s_warp[w][tid];
        s_warp[w][tid] = at;
        at += c;
      }
      s_next[tid] = at;
    }
    __syncthreads();
    if (d >= 0) {
      const int32_t at = s_warp[warp][d] + rank;
      out_key[at] = key;
      out_row[at] = row;
    }
    __syncthreads();
  }
}

// grid (ceil(pieces / warps a block), S): a warp per PIECE sorted rows
// of shard blockIdx.y's block, a lane per column; each segment's rows
// summed in row order.  A segment that starts in the piece leaves its sum
// over the piece at seg[its first position] and that position in
// first[shard][key]; one begun in an earlier piece leaves its part in
// head[piece].
__global__ void __launch_bounds__(WTB) embed_piece(TrainBwdIO io,
                                                   int pieces) {
  const int q = blockIdx.x * (WTB / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= pieces) return;
  const int z = blockIdx.y;
  const int32_t base = z * io.block, p0 = q * PIECE;
  const int cnt = min(PIECE, io.block - p0);
  const int32_t* sk = io.sorted_key + base;
  const int32_t* sr = io.sorted_row + base;
  const int32_t my_key = lane < cnt ? sk[p0 + lane] : io.v;
  const int32_t my_row = lane < cnt ? sr[p0 + lane] : 0;
  float val[PIECE];
#pragma unroll
  for (int t = 0; t < PIECE; ++t) {
    const int32_t rr = __shfl_sync(0xFFFFFFFFu, my_row, t);
    val[t] = t < cnt ? io.de[(size_t)rr * EMB + lane] : 0.0f;
  }
  int32_t cur = __shfl_sync(0xFFFFFFFFu, my_key, 0);
  if (cur == io.v) return;  // dropped rows from here to the block's end
  bool from_left = p0 > 0 && sk[p0 - 1] == cur;
  int32_t start = p0;
  float acc = 0.0f;
  const size_t hq = ((size_t)z * pieces + q) * EMB + lane;
#pragma unroll
  for (int t = 0; t < PIECE; ++t) {
    if (t >= cnt) break;
    const int32_t k = __shfl_sync(0xFFFFFFFFu, my_key, t);
    if (k != cur) {
      if (from_left) {
        io.head[hq] = acc;
      } else {
        io.seg[((size_t)base + start) * EMB + lane] = acc;
        if (lane == 0) io.first[(size_t)z * io.v + cur] = start;
      }
      if (k == io.v) return;
      from_left = false;
      cur = k;
      start = p0 + t;
      acc = 0.0f;
    }
    acc = __fadd_rn(acc, val[t]);
  }
  if (from_left) {
    io.head[hq] = acc;
  } else {
    io.seg[((size_t)base + start) * EMB + lane] = acc;
    if (lane == 0) io.first[(size_t)z * io.v + cur] = start;
  }
}

// the heads of the `cnt` pieces from q on that key's segment in shard z
// runs into, added to acc in piece order (then 32 pieces more while all
// 32 probed continue it)
__device__ __forceinline__ float add_heads(const TrainBwdIO& io, int pieces,
                                           int z, int32_t key, int32_t q,
                                           int cnt, float acc) {
  const int lane = threadIdx.x & 31;
  const int32_t base = z * io.block;
  const float* head = io.head + (size_t)z * pieces * EMB + lane;
  for (;;) {
    float h[32];
#pragma unroll
    for (int t = 0; t < 32; ++t)
      h[t] = t < cnt ? head[(size_t)(q + t) * EMB] : 0.0f;
#pragma unroll
    for (int t = 0; t < 32; ++t)
      if (t < cnt) acc = __fadd_rn(acc, h[t]);
    if (cnt < 32) return acc;
    q += 32;
    const int32_t at = (q + lane) * PIECE;
    const int32_t next = at < io.block ? io.sorted_key[base + at] : -1;
    cnt = __popc(__ballot_sync(0xFFFFFFFFu, next == key));
  }
}

// a warp per key of d_embed, a lane per column: each shard's segment sum
// (its first piece's, then the heads of the pieces it runs into, in
// order), 0 plus that, the shards added in shard order, over S.  The
// key's first positions in 32 shards load at once, a lane a shard; a
// present segment's first-piece sum and its probe of the 32 pieces after
// it load together, ahead of the ballot.
__global__ void __launch_bounds__(WTB) embed_finish(TrainBwdIO io,
                                                    int pieces) {
  const int32_t key = blockIdx.x * (WTB / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (key >= io.v) return;
  float total = 0.0f;
  for (int z0 = 0; z0 < io.n_shards; z0 += 32) {
    const int nz = min(32, io.n_shards - z0);
    const int32_t my_p =
        lane < nz ? io.first[(size_t)(z0 + lane) * io.v + key] : -1;
    for (int u = 0; u < nz; ++u) {
      const int z = z0 + u;
      const int32_t p = __shfl_sync(0xFFFFFFFFu, my_p, u);
      float shard = 0.0f;
      if (p >= 0) {
        const int32_t base = z * io.block, q = p / PIECE + 1;
        const int32_t at = (q + lane) * PIECE;
        const int32_t next = at < io.block ? io.sorted_key[base + at] : -1;
        const float acc = io.seg[((size_t)base + p) * EMB + lane];
        const int cnt = __popc(__ballot_sync(0xFFFFFFFFu, next == key));
        shard = __fadd_rn(0.0f, add_heads(io, pieces, z, key, q, cnt, acc));
      }
      total = z == 0 ? shard : __fadd_rn(total, shard);
    }
  }
  io.d_embed[(size_t)key * EMB + lane] =
      __fdiv_rn(total, (float)io.n_shards);
}

// ---- K22 ---------------------------------------------------------------

// One parameter's step, optax.adam's arithmetic in the plain version's
// order: mu, nu, then p += -lr * mu_hat / (sqrt(nu_hat) + eps).
__device__ __forceinline__ void adam_step(float g, float& p, float& m,
                                          float& v, float bc1, float bc2,
                                          float neg_lr) {
  m = __fadd_rn(__fmul_rn(ADAM_OMB1, g), __fmul_rn(ADAM_B1, m));
  v = __fadd_rn(__fmul_rn(ADAM_OMB2, __fmul_rn(g, g)),
                __fmul_rn(ADAM_B2, v));
  const float u = __fdiv_rn(
      __fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), ADAM_EPS));
  p = __fadd_rn(p, __fmul_rn(neg_lr, u));
}

// One work unit's operands: four parameters (a 16-byte unit) or one
// (in .x).
struct AdamUnit {
  float4 p, m, v, g;
};

// Load unit u, its leaf L found by a search that only moves forward;
// false past the last unit.
__device__ __forceinline__ bool adam_load(const AdamIO& io, int64_t u,
                                          int& L, AdamUnit& x) {
  if (u >= io.units) return false;
  while (L + 1 < io.n_leaves && u >= io.leaf[L + 1].unit0) ++L;
  const AdamLeaf& lf = io.leaf[L];
  const int64_t k = u - lf.unit0;
  if (k < lf.n4) {
    x.g = __ldg(reinterpret_cast<const float4*>(lf.g) + k);
    x.p = reinterpret_cast<const float4*>(lf.p)[k];
    x.m = reinterpret_cast<const float4*>(lf.mu)[k];
    x.v = reinterpret_cast<const float4*>(lf.nu)[k];
  } else {
    const int64_t i = k + 3 * lf.n4;
    x.g.x = __ldg(&lf.g[i]);
    x.p.x = lf.p[i];
    x.m.x = lf.mu[i];
    x.v.x = lf.nu[i];
  }
  return true;
}

// Step unit u of leaf L and store it.
__device__ __forceinline__ void adam_store(const AdamIO& io, int64_t u,
                                           int L, AdamUnit& x, float bc1,
                                           float bc2) {
  const AdamLeaf& lf = io.leaf[L];
  const int64_t k = u - lf.unit0;
  const float nl = io.neg_lr;
  if (k < lf.n4) {
    adam_step(x.g.x, x.p.x, x.m.x, x.v.x, bc1, bc2, nl);
    adam_step(x.g.y, x.p.y, x.m.y, x.v.y, bc1, bc2, nl);
    adam_step(x.g.z, x.p.z, x.m.z, x.v.z, bc1, bc2, nl);
    adam_step(x.g.w, x.p.w, x.m.w, x.v.w, bc1, bc2, nl);
    reinterpret_cast<float4*>(lf.p)[k] = x.p;
    reinterpret_cast<float4*>(lf.mu)[k] = x.m;
    reinterpret_cast<float4*>(lf.nu)[k] = x.v;
  } else {
    const int64_t i = k + 3 * lf.n4;
    adam_step(x.g.x, x.p.x, x.m.x, x.v.x, bc1, bc2, nl);
    lf.p[i] = x.p.x;
    lf.mu[i] = x.m.x;
    lf.nu[i] = x.v.x;
  }
}

__global__ void __launch_bounds__(ATB) adam_kernel(AdamIO io) {
  __shared__ float s_bc[2];
  const int64_t stride = (int64_t)gridDim.x * ATB;
  int64_t u = (int64_t)blockIdx.x * ATB + threadIdx.x;
  int L = 0;
  AdamUnit x;
  // the first unit's loads go out before the block waits for thread 0's
  // bias corrections
  bool more = adam_load(io, u, L, x);
  int32_t c = 0;
  if (threadIdx.x == 0) {
    const int32_t c0 = __ldcg(io.count);
    c = c0 < INT_MAX ? c0 + 1 : c0;
    const float cf = (float)c;
    s_bc[0] = __fsub_rn(1.0f, powf(ADAM_B1, cf));
    s_bc[1] = __fsub_rn(1.0f, powf(ADAM_B2, cf));
  }
  __syncthreads();
  const float bc1 = s_bc[0], bc2 = s_bc[1];
  if (threadIdx.x == 0) {
    // this block has read count: the last block to get here moves it
    __threadfence();
    if (atomicInc(io.ticket, gridDim.x - 1) == gridDim.x - 1) *io.count = c;
  }
  while (more) {
    adam_store(io, u, L, x, bc1, bc2);
    u += stride;
    more = adam_load(io, u, L, x);
  }
}

}  // namespace

extern "C" int anomaly_train_fwd_launch(const TrainFwdIO* io,
                                        cudaStream_t stream) {
  if (io->n_shards < 1 || io->block < 1 ||
      (int64_t)io->n_shards * io->block != io->n)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((io->block + FR - 1) / FR, io->n_shards);
  fwd_rows<<<grid, FT, 0, stream>>>(*io);
  return (int)cudaGetLastError();
}

extern "C" int anomaly_train_bwd_launch(const TrainBwdIO* io,
                                        cudaStream_t stream) {
  const int32_t n = io->n, block = io->block, n_shards = io->n_shards;
  if (n_shards < 1 || block < 1 || (int64_t)n_shards * block != n ||
      io->v < 1)
    return (int)cudaErrorInvalidValue;
  const int chunks = (block + CHUNK - 1) / CHUNK;  // a shard's
  bwd_rows<<<(n + BR - 1) / BR, BR * BG, 0, stream>>>(*io);
  wgrad_partial<<<dim3(chunks, 3, n_shards), WTB, 0, stream>>>(*io, chunks);
  wgrad_reduce<<<dim3((WOUT + WTB - 1) / WTB, 3), WTB, 0, stream>>>(*io,
                                                                     chunks);
  // the radix passes: 8 bits a pass over the keys 0 .. v (v: dropped),
  // the last pass into sorted_key / sorted_row
  int bits = 0;
  while (bits < 31 && (io->v >> bits) != 0) ++bits;
  const int passes = (bits + 7) / 8;
  const int n_sub = (block + SORT_TB - 1) / SORT_TB;
  const int subs = (n_sub + MAX_TILES - 1) / MAX_TILES;  // a tile's
  const dim3 sgrid((n_sub + subs - 1) / subs, n_shards);
  const int32_t* in_key = nullptr;
  const int32_t* in_row = nullptr;
  for (int p = 0; p < passes; ++p) {
    const bool last = (passes - 1 - p) % 2 == 0;
    int32_t* out_key = last ? io->sorted_key : io->key_tmp;
    int32_t* out_row = last ? io->sorted_row : io->row_tmp;
    embed_radix<<<sgrid, SORT_TB, 0, stream>>>(*io, in_key, in_row, out_key,
                                               out_row, 8 * p, subs);
    in_key = out_key;
    in_row = out_row;
  }
  const int warps_per_block = WTB / 32;
  const int pieces = (block + PIECE - 1) / PIECE;  // a shard's
  embed_piece<<<dim3((pieces + warps_per_block - 1) / warps_per_block,
                     n_shards),
                WTB, 0, stream>>>(*io, pieces);
  embed_finish<<<(io->v + warps_per_block - 1) / warps_per_block, WTB, 0,
                 stream>>>(*io, pieces);
  return (int)cudaGetLastError();
}

extern "C" int adam_update_launch(const AdamIO* iop, cudaStream_t stream) {
  AdamIO io = *iop;
  if (io.n_leaves < 1 || io.n_leaves > MAX_LEAVES)
    return (int)cudaErrorInvalidValue;
  int64_t units = 0;
  for (int i = 0; i < io.n_leaves; ++i) {
    AdamLeaf& lf = io.leaf[i];
    const uintptr_t any = reinterpret_cast<uintptr_t>(lf.p) |
                          reinterpret_cast<uintptr_t>(lf.g) |
                          reinterpret_cast<uintptr_t>(lf.mu) |
                          reinterpret_cast<uintptr_t>(lf.nu);
    if (lf.n < 0) return (int)cudaErrorInvalidValue;
    lf.n4 = any % 16 == 0 ? lf.n / 4 : 0;
    lf.unit0 = units;
    units += lf.n - 3 * lf.n4;
  }
  io.units = units;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (units + ATB - 1) / ATB;
  const int most = ADAM_BLOCKS_PER_SM * sms;
  if (most <= 0) return (int)cudaErrorInvalidConfiguration;
  // one block at least: the count moves even with no parameter
  const int blocks = (int)(want < 1 ? 1 : want < most ? want : most);
  adam_kernel<<<blocks, ATB, 0, stream>>>(io);
  return (int)cudaGetLastError();
}

extern "C" size_t mltrain_abi_size(int which) {
  return which == 0   ? sizeof(TrainFwdIO)
         : which == 1 ? sizeof(TrainBwdIO)
         : which == 2 ? sizeof(AdamIO)
                      : 0;
}
