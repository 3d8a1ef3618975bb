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
// gradient (and K20's loss) sum in another grouping than the plain
// version's index_add_ (and sum), within float32 rounding.
//
// K20 (bound: bytes at the trainer's B = 4096, V = 16384, ~624 B a row:
// id_row, feats, label, the 128 B embedding row read; x, h1, h2 in bf16
// and the logit written; its ~15.9 kFLOP a row would take less on the
// bf16 tensor cores).  A thread a row, 64 rows a block, grid (ceil(B /
// S / 64), S) so that no block straddles a shard (64 blocks at B = 4096):
// K19's arithmetic, the weights bf16-rounded in shared memory, x and
// then h1 in a bf16 column a thread; x, h1 and h2 leave feature-major
// ([59 or 64, B] bf16, so a warp's stores coalesce) for K21.  The loss:
// each block sums its rows' terms in a fixed tree; one thread sums each
// shard's blocks in block order and divides by B / S, then takes the
// shards' mean.  No float atomics: two runs give the same bits.
//
// K21 (bound: bytes, mostly d_embed's [V, 32] float32 written; ~2x K20's
// FLOPs).  Seven launches and a memset, in stream order:
//   1. d_embed zeroed (the dense gradient adam reads);
//   2. bwd_rows, a thread a row: dlogit by the reference's autodiff
//      rules with g = gloss / (B / S), dz2 = relu'(h2) bf16(dz3 w3), dh1
//      = dz2 W2^T, dz1, dx[:, :32] = dz1 W1[:32]^T (the rows' 64 float32
//      sums in registers, the cotangent in a bf16 shared-memory column);
//      dz1, dz2 feature-major, dz3, and de = bf16(dx[:, :32]) as float32
//      rows for the scatter;
//   3. wgrad_partial, one block a 64-row chunk of a shard's block and a
//      layer (grid (chunks a shard, 3, S), a shard's last chunk short):
//      every (input, output) pair's float32 sum over the chunk's rows in
//      row order, the bias as the sum against an input of ones (the
//      chunk staged in shared memory, an output's partial sum in a
//      register);
//   4. wgrad_reduce, the pmean: a thread an output; each shard's chunk
//      partials summed in chunk order and rounded to bf16, the shards'
//      values added in shard order, divided by S.  Fixed order, no
//      atomics: deterministic;
//   5. embed_sort, a block a list: a list is a shard's block, or a slice
//      of 16384 rows of it when the block is larger; its rows sorted by
//      (clamped key, row) in shared memory (a bitonic sort of 64-bit
//      keys).  The reference's gather clamps an index, but its
//      transpose, a scatter-add, drops an index that is negative after
//      one wrap or past the table: such rows sort last and are not
//      summed;
//   6. embed_piece, a warp per 32 sorted rows of a list (a lane a
//      column): each key's rows summed in row order; a key whose rows lie
//      inside the piece leaves its sum at its first sorted position
//      (seg), a key that crosses a piece boundary its head or tail sum;
//   7. embed_join, a warp per piece where a crossing key starts: its
//      tail plus the next pieces' heads, in order, into seg.  A hot
//      identity (half the batch on one row) costs a 32-row sum and a
//      walk of B / 64 heads, not B serialized atomics;
//   8. embed_merge, the pmean: a warp per key, in the first list that
//      holds it (binary searches of the other lists): a shard's sum is
//      0 plus its lists' seg values in list order (what the unsharded
//      launch's memset and slice-by-slice adds give), the shards' sums
//      added in shard order, divided by S, written to d_embed.  One
//      writer a key and a fixed order: two runs give the same bits, and
//      d_embed stays sparse (no [S, V, 32] partial).
//
// K22 (bound: bytes, 28 B a parameter: p, g, mu, nu read, p, mu, nu
// written; 532,353 parameters at V = 16384).  One fused pass over every
// trainable leaf, densely as optax does (every embedding row's moments
// decay every step): a thread a parameter, the leaf found from its
// block; count stays on the card (the bias corrections 1 - b^(count+1)
// are computed from it in the kernel, then a one-thread launch
// increments it), so a step never syncs with the host.
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
constexpr int TB = 64;              // rows a block of the row passes
constexpr int CHUNK = 64;           // rows a block of wgrad_partial (the
                                    // plain version's WGRAD_CHUNK)
constexpr int WTB = 256;            // threads of the wgrad and adam blocks
constexpr int SORT_TB = 1024;
constexpr int MAX_SORT = 1 << 14;   // embed_sort's rows (128 KB of keys)
constexpr int PIECE = 32;           // sorted rows a warp of embed_piece
constexpr int MAX_LEAVES = 8;
// K22: optax.adam's defaults (eps_root 0), as ml/train.py's B1, B2, EPS;
// 1 - b is taken in double and rounded once, as the reference's is
constexpr float ADAM_B1 = 0.9f;
constexpr float ADAM_B2 = 0.999f;
constexpr float ADAM_OMB1 = (float)(1.0 - 0.9);
constexpr float ADAM_OMB2 = (float)(1.0 - 0.999);
constexpr float ADAM_EPS = 1e-8f;
constexpr unsigned long long NO_KEY = 0xFFFFFFFFull << 32;

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
  float* partial;         // [S * ceil(block / 64)] the blocks' loss sums
  float* loss;            // [1]
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
  int32_t* sorted_key;         // [n] scratch, each list at its first row
  int32_t* sorted_row;         // [n] scratch
  int32_t* nvalid;             // [lists] scratch
  float* head;                 // [lists * pieces a list, 32] scratch
  float* tail;                 // [lists * pieces a list, 32] scratch
  float* seg;                  // [n, 32] scratch: a key's sum in a list
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
  int64_t block0;
};

struct AdamIO {
  AdamLeaf leaf[MAX_LEAVES];
  int32_t* count;  // [] on the card
  int32_t n_leaves;
  float neg_lr;    // -lr
};

namespace {

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf2f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// acc[j] = sum_k col[k] * w[k, j] for j < N, float32 FMAs in k order;
// col is the thread's bf16 column (stride TB), w a [k_n, N] row-major
// block in shared memory read by all lanes at once (a broadcast)
template <int N>
__device__ __forceinline__ void layer(const __nv_bfloat16* col,
                                      const float* w, int k_n, float* acc) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < k_n; ++k) {
    const float xk = bf2f(col[k * TB]);
    const float4* wr = reinterpret_cast<const float4*>(w + k * N);
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 u = wr[q];
      acc[4 * q] = fmaf(xk, u.x, acc[4 * q]);
      acc[4 * q + 1] = fmaf(xk, u.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(xk, u.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(xk, u.w, acc[4 * q + 3]);
    }
  }
}

// bf16(product) + bf16(b) in bf16, then ReLU (K19's rounding points)
__device__ __forceinline__ float hidden(float acc, float b) {
  return fmaxf(bf16r(bf16r(acc) + b), 0.0f);
}

// ---- K20 ---------------------------------------------------------------

__global__ void __launch_bounds__(TB) fwd_rows(TrainFwdIO io) {
  __shared__ __align__(16) float s_w1[IN * HID];
  __shared__ __align__(16) float s_w2[HID * HID];
  __shared__ float s_w3[HID];
  __shared__ float s_b1[HID];
  __shared__ float s_b2[HID];
  __shared__ __align__(16) __nv_bfloat16 s_col[HID * TB];
  __shared__ float s_red[TB];
  const int tid = threadIdx.x;
  for (int j = tid; j < IN * HID; j += TB) s_w1[j] = bf16r(io.w1[j]);
  for (int j = tid; j < HID * HID; j += TB) s_w2[j] = bf16r(io.w2[j]);
  for (int j = tid; j < HID; j += TB) {
    s_w3[j] = bf16r(io.w3[j]);
    s_b1[j] = bf16r(io.b1[j]);
    s_b2[j] = bf16r(io.b2[j]);
  }
  __syncthreads();
  const int32_t n = io.n;
  const int32_t local = blockIdx.x * TB + tid;  // row within the shard
  const int32_t i = blockIdx.y * io.block + local;
  float term = 0.0f;
  if (local < io.block) {
    __nv_bfloat16* col = s_col + tid;
    const int64_t r = xla_index(io.id_row[i], io.v);
    const float4* e = reinterpret_cast<const float4*>(io.embed + r * EMB);
#pragma unroll
    for (int q = 0; q < EMB / 4; ++q) {
      const float4 u = e[q];
      const float c[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const __nv_bfloat16 b = __float2bfloat16_rn(c[t]);
        col[(4 * q + t) * TB] = b;
        io.xT[(size_t)(4 * q + t) * n + i] = b;
      }
    }
    const float* fr = io.feats + (size_t)i * FEAT_DIM;
#pragma unroll
    for (int f = 0; f < FEAT_DIM; ++f) {
      const __nv_bfloat16 b = __float2bfloat16_rn(fr[f]);
      col[(EMB + f) * TB] = b;
      io.xT[(size_t)(EMB + f) * n + i] = b;
    }
    float acc[HID];
    layer<HID>(col, s_w1, IN, acc);
#pragma unroll
    for (int j = 0; j < HID; ++j) {
      const __nv_bfloat16 b = __float2bfloat16_rn(hidden(acc[j], s_b1[j]));
      col[j * TB] = b;
      io.h1T[(size_t)j * n + i] = b;
    }
    layer<HID>(col, s_w2, HID, acc);
    float lacc = 0.0f;
#pragma unroll
    for (int j = 0; j < HID; ++j) {
      const float h = hidden(acc[j], s_b2[j]);
      io.h2T[(size_t)j * n + i] = __float2bfloat16_rn(h);
      lacc = fmaf(h, s_w3[j], lacc);
    }
    const float logit = bf16r(bf16r(lacc) + bf16r(io.b3[0]));
    io.logit[i] = logit;
    // max(l, 0) - l * y + log1p(exp(-|l|)), the reference's order
    term = __fadd_rn(__fsub_rn(fmaxf(logit, 0.0f),
                               __fmul_rn(logit, io.labels[i])),
                     log1pf(expf(-fabsf(logit))));
  }
  s_red[tid] = term;
  __syncthreads();
  for (int s = TB / 2; s > 0; s >>= 1) {
    if (tid < s) s_red[tid] = __fadd_rn(s_red[tid], s_red[tid + s]);
    __syncthreads();
  }
  if (tid == 0) io.partial[blockIdx.y * gridDim.x + blockIdx.x] = s_red[0];
}

// each shard's blocks in block order over B / S, then the shards' mean
__global__ void loss_reduce(TrainFwdIO io, int blocks) {
  float total = 0.0f;
  for (int s = 0; s < io.n_shards; ++s) {
    float sum = 0.0f;
    for (int b = 0; b < blocks; ++b)
      sum = __fadd_rn(sum, io.partial[s * blocks + b]);
    const float ls = __fdiv_rn(sum, (float)io.block);
    total = s == 0 ? ls : __fadd_rn(total, ls);
  }
  io.loss[0] = __fdiv_rn(total, (float)io.n_shards);
}

// ---- K21 ---------------------------------------------------------------

__global__ void __launch_bounds__(TB) bwd_rows(TrainBwdIO io) {
  __shared__ __align__(16) float s_w2t[HID * HID];  // [j][k] = W2[k][j]
  __shared__ __align__(16) float s_w1t[HID * EMB];  // [k][m] = W1[m][k]
  __shared__ float s_w3[HID];
  __shared__ __align__(16) __nv_bfloat16 s_col[HID * TB];
  const int tid = threadIdx.x;
  for (int j = tid; j < HID * HID; j += TB)
    s_w2t[(j % HID) * HID + j / HID] = bf16r(io.w2[j]);
  for (int j = tid; j < HID * EMB; j += TB)
    s_w1t[j] = bf16r(io.w1[(j % EMB) * HID + j / EMB]);
  for (int j = tid; j < HID; j += TB) s_w3[j] = bf16r(io.w3[j]);
  __syncthreads();
  const int32_t n = io.n;
  const int32_t i = blockIdx.x * TB + tid;
  if (i >= n) return;
  // dlogit: with g = gloss / (B / S) and t = exp(-|l|), the rules
  // jax.grad derives from bce_loss: maximum splits its tie (1/2 at l ==
  // 0), abs takes the + branch at 0
  const float g = __fdiv_rn(io.gloss[0], (float)io.block);
  const float l = io.logit[i];
  const float t = expf(-fabsf(l));
  const float ct = __fmul_rn(__fdiv_rn(g, __fadd_rn(t, 1.0f)), t);
  const float cz = l >= 0.0f ? -ct : ct;
  const float cf = l > 0.0f ? 1.0f : (l == 0.0f ? 0.5f : 0.0f);
  const float dl = __fadd_rn(__fadd_rn(cz, __fmul_rn(-g, io.labels[i])),
                             __fmul_rn(g, cf));
  const __nv_bfloat16 dz3 = __float2bfloat16_rn(dl);
  io.dz3[i] = dz3;
  __nv_bfloat16* col = s_col + tid;
#pragma unroll
  for (int j = 0; j < HID; ++j) {
    const bool on = bf2f(io.h2T[(size_t)j * n + i]) > 0.0f;
    const __nv_bfloat16 d = __float2bfloat16_rn(
        on ? __fmul_rn(bf2f(dz3), s_w3[j]) : 0.0f);
    col[j * TB] = d;
    io.dz2T[(size_t)j * n + i] = d;
  }
  float acc[HID];
  layer<HID>(col, s_w2t, HID, acc);  // dh1 = dz2 W2^T
#pragma unroll
  for (int k = 0; k < HID; ++k) {
    const bool on = bf2f(io.h1T[(size_t)k * n + i]) > 0.0f;
    const __nv_bfloat16 d = __float2bfloat16_rn(on ? acc[k] : 0.0f);
    col[k * TB] = d;
    io.dz1T[(size_t)k * n + i] = d;
  }
  float de[EMB];
  layer<EMB>(col, s_w1t, HID, de);  // dx[:, :32] = dz1 W1[:32]^T
  float4* out = reinterpret_cast<float4*>(io.de + (size_t)i * EMB);
#pragma unroll
  for (int q = 0; q < EMB / 4; ++q)
    out[q] = make_float4(bf16r(de[4 * q]), bf16r(de[4 * q + 1]),
                         bf16r(de[4 * q + 2]), bf16r(de[4 * q + 3]));
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

// K21's lists: shard z's block split into slices of MAX_SORT rows (one
// slice when the block is that small); list l = z * lists_a_shard + j
struct EmbedList {
  int32_t row0;  // its first row in the batch
  int32_t m;     // its rows
};

__device__ __forceinline__ int lists_a_shard(const TrainBwdIO& io) {
  return (io.block + MAX_SORT - 1) / MAX_SORT;
}

__device__ __forceinline__ EmbedList embed_list(const TrainBwdIO& io,
                                                int l) {
  const int per = lists_a_shard(io);
  const int32_t j0 = (l % per) * MAX_SORT;
  return {(l / per) * io.block + j0, min(MAX_SORT, io.block - j0)};
}

// a block a list: its m rows sorted by (key, row) with key the table row
// the scatter-add writes; rows it drops sort last (key 0xFFFFFFFF)
__global__ void __launch_bounds__(SORT_TB) embed_sort(TrainBwdIO io,
                                                      int p2) {
  extern __shared__ unsigned long long s_keys[];
  const EmbedList L = embed_list(io, blockIdx.x);
  const int tid = threadIdx.x;
  int valid = 0;
  for (int base = 0; base < p2; base += SORT_TB) {
    const int i = base + tid;
    bool ok = false;
    if (i < p2) {
      const unsigned row = (unsigned)(L.row0 + i);
      unsigned long long k = NO_KEY | row;
      if (i < L.m) {
        int64_t key = io.id_row[row];
        if (key < 0) key += io.v;
        ok = key >= 0 && key < io.v;
        if (ok) k = ((unsigned long long)key << 32) | row;
      }
      s_keys[i] = k;
    }
    valid += __syncthreads_count(ok);
  }
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < p2; i += SORT_TB) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = s_keys[i], b = s_keys[ixj];
          if ((a > b) == ((i & k) == 0)) {
            s_keys[i] = b;
            s_keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < L.m; i += SORT_TB) {
    io.sorted_key[L.row0 + i] = (int32_t)(s_keys[i] >> 32);
    io.sorted_row[L.row0 + i] = (int32_t)(s_keys[i] & 0xFFFFFFFFull);
  }
  if (tid == 0) io.nvalid[blockIdx.x] = valid;
}

// grid (lists, pieces a list / warps a block): a warp per PIECE sorted
// rows of list blockIdx.x, a lane per column; each key's rows summed in
// row order; a key inside the piece leaves its sum in seg at its first
// sorted position, one that crosses the piece's start its head sum, one
// that crosses its end (and starts in it) its tail sum
__global__ void __launch_bounds__(WTB) embed_piece(TrainBwdIO io,
                                                   int pieces) {
  const int q = (blockIdx.y * WTB + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const EmbedList L = embed_list(io, blockIdx.x);
  const int32_t nv = io.nvalid[blockIdx.x];
  const int32_t p0 = q * PIECE;
  if (p0 >= nv) return;
  const int32_t p1 = min(p0 + PIECE, nv);
  const int32_t* sk = io.sorted_key + L.row0;
  const int32_t* sr = io.sorted_row + L.row0;
  const size_t hq = ((size_t)blockIdx.x * pieces + q) * EMB + lane;
  int32_t cur = sk[p0], start = p0;
  bool from_left = p0 > 0 && sk[p0 - 1] == cur;
  float acc = 0.0f;
  for (int32_t p = p0; p < p1; ++p) {
    const int32_t k = sk[p];
    if (k != cur) {
      if (from_left)
        io.head[hq] = acc;
      else
        io.seg[((size_t)L.row0 + start) * EMB + lane] = acc;
      from_left = false;
      cur = k;
      start = p;
      acc = 0.0f;
    }
    acc = __fadd_rn(acc, io.de[(size_t)sr[p] * EMB + lane]);
  }
  const bool to_right = p1 < nv && sk[p1] == cur;
  if (from_left)
    io.head[hq] = acc;
  else if (to_right)
    io.tail[hq] = acc;
  else
    io.seg[((size_t)L.row0 + start) * EMB + lane] = acc;
}

// a warp per piece whose last key starts in it and crosses its end: the
// tail plus the following pieces' heads, in order, into seg at the key's
// first sorted position
__global__ void __launch_bounds__(WTB) embed_join(TrainBwdIO io,
                                                  int pieces) {
  const int q = (blockIdx.y * WTB + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const EmbedList L = embed_list(io, blockIdx.x);
  const int32_t nv = io.nvalid[blockIdx.x];
  const int32_t p0 = q * PIECE;
  if (p0 >= nv) return;
  const int32_t p1 = min(p0 + PIECE, nv);
  const int32_t* sk = io.sorted_key + L.row0;
  const int32_t key = sk[p1 - 1];
  if (!(p1 < nv && sk[p1] == key)) return;  // ends in this piece
  if (p0 > 0 && sk[p0 - 1] == key) return;  // starts in an earlier one
  int32_t start = p1 - 1;
  while (start > p0 && sk[start - 1] == key) --start;
  const float* head = io.head + (size_t)blockIdx.x * pieces * EMB + lane;
  float acc = io.tail[((size_t)blockIdx.x * pieces + q) * EMB + lane];
  for (int qq = q + 1;; ++qq) {
    acc = __fadd_rn(acc, head[(size_t)qq * EMB]);
    const int32_t pe = min((qq + 1) * PIECE, nv);
    if (!(pe < nv && sk[pe] == key)) break;
  }
  io.seg[((size_t)L.row0 + start) * EMB + lane] = acc;
}

// key's first sorted position in list l, or -1
__device__ __forceinline__ int32_t find_key(const TrainBwdIO& io, int l,
                                            int32_t key) {
  const EmbedList L = embed_list(io, l);
  const int32_t* sk = io.sorted_key + L.row0;
  int32_t lo = 0, hi = io.nvalid[l];
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (sk[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < io.nvalid[l] && sk[lo] == key ? lo : -1;
}

// the pmean of d_embed: grid (lists, positions a list / warps a block),
// a warp per key at its first position in the first list that holds it
__global__ void __launch_bounds__(WTB) embed_merge(TrainBwdIO io) {
  const int32_t p = (blockIdx.y * WTB + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.x;
  if (p >= io.nvalid[l]) return;
  const int32_t* sk = io.sorted_key + embed_list(io, l).row0;
  const int32_t key = sk[p];
  if (p > 0 && sk[p - 1] == key) return;
  for (int l2 = 0; l2 < l; ++l2)
    if (find_key(io, l2, key) >= 0) return;  // an earlier list's key
  const int per = lists_a_shard(io);
  float total = 0.0f;
  for (int z = 0; z < io.n_shards; ++z) {
    // the unsharded launch on shard z's block: d_embed zeroed, then each
    // of its lists' sums added in list order
    float shard = 0.0f;
    for (int l2 = z * per; l2 < (z + 1) * per; ++l2) {
      const int32_t at = l2 == l ? p : l2 < l ? -1 : find_key(io, l2, key);
      if (at >= 0)
        shard = __fadd_rn(
            shard,
            io.seg[((size_t)embed_list(io, l2).row0 + at) * EMB + lane]);
    }
    total = z == 0 ? shard : __fadd_rn(total, shard);
  }
  io.d_embed[(size_t)key * EMB + lane] =
      __fdiv_rn(total, (float)io.n_shards);
}

// ---- K22 ---------------------------------------------------------------

__global__ void __launch_bounds__(WTB) adam_kernel(AdamIO io) {
  int L = 0;
  while (L + 1 < io.n_leaves && blockIdx.x >= io.leaf[L + 1].block0) ++L;
  const AdamLeaf lf = io.leaf[L];
  const int64_t i = (int64_t)(blockIdx.x - lf.block0) * WTB + threadIdx.x;
  if (i >= lf.n) return;
  int32_t c = io.count[0];
  c = c < INT_MAX ? c + 1 : c;
  const float cf = (float)c;
  const float bc1 = __fsub_rn(1.0f, powf(ADAM_B1, cf));
  const float bc2 = __fsub_rn(1.0f, powf(ADAM_B2, cf));
  const float g = lf.g[i];
  const float m = __fadd_rn(__fmul_rn(ADAM_OMB1, g),
                            __fmul_rn(ADAM_B1, lf.mu[i]));
  const float v = __fadd_rn(__fmul_rn(ADAM_OMB2, __fmul_rn(g, g)),
                            __fmul_rn(ADAM_B2, lf.nu[i]));
  const float u = __fdiv_rn(
      __fdiv_rn(m, bc1),
      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), ADAM_EPS));
  lf.p[i] = __fadd_rn(lf.p[i], __fmul_rn(io.neg_lr, u));
  lf.mu[i] = m;
  lf.nu[i] = v;
}

__global__ void adam_count(int32_t* count) {
  const int32_t c = count[0];
  count[0] = c < INT_MAX ? c + 1 : c;
}

}  // namespace

extern "C" int anomaly_train_fwd_launch(const TrainFwdIO* io,
                                        cudaStream_t stream) {
  if (io->n_shards < 1 || io->block < 1 ||
      (int64_t)io->n_shards * io->block != io->n)
    return (int)cudaErrorInvalidValue;
  const int blocks = (io->block + TB - 1) / TB;  // a shard's
  fwd_rows<<<dim3(blocks, io->n_shards), TB, 0, stream>>>(*io);
  loss_reduce<<<1, 1, 0, stream>>>(*io, blocks);
  return (int)cudaGetLastError();
}

extern "C" int anomaly_train_bwd_launch(const TrainBwdIO* io,
                                        cudaStream_t stream) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      embed_sort, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(unsigned long long) * MAX_SORT));
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int32_t n = io->n, block = io->block, n_shards = io->n_shards;
  if (n_shards < 1 || block < 1 || (int64_t)n_shards * block != n)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      io->d_embed, 0, sizeof(float) * EMB * (size_t)io->v, stream);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (block + CHUNK - 1) / CHUNK;  // a shard's
  bwd_rows<<<(n + TB - 1) / TB, TB, 0, stream>>>(*io);
  wgrad_partial<<<dim3(chunks, 3, n_shards), WTB, 0, stream>>>(*io, chunks);
  wgrad_reduce<<<dim3((WOUT + WTB - 1) / WTB, 3), WTB, 0, stream>>>(*io,
                                                                     chunks);
  const int lists = n_shards * ((block + MAX_SORT - 1) / MAX_SORT);
  const int m = min(MAX_SORT, block);  // the longest list's rows
  int p2 = 2;
  while (p2 < m) p2 <<= 1;
  embed_sort<<<lists, SORT_TB, sizeof(unsigned long long) * p2, stream>>>(
      *io, p2);
  const int warps_per_block = WTB / 32;
  const int pieces = (m + PIECE - 1) / PIECE;  // a list's, at most
  const dim3 pgrid(lists, (pieces + warps_per_block - 1) / warps_per_block);
  embed_piece<<<pgrid, WTB, 0, stream>>>(*io, pieces);
  embed_join<<<pgrid, WTB, 0, stream>>>(*io, pieces);
  embed_merge<<<dim3(lists, (m + warps_per_block - 1) / warps_per_block),
                WTB, 0, stream>>>(*io);
  return (int)cudaGetLastError();
}

extern "C" int adam_update_launch(const AdamIO* io, int blocks,
                                  cudaStream_t stream) {
  if (blocks > 0) adam_kernel<<<blocks, WTB, 0, stream>>>(*io);
  adam_count<<<1, 1, 0, stream>>>(io->count);
  return (int)cudaGetLastError();
}

extern "C" size_t mltrain_abi_size(int which) {
  return which == 0   ? sizeof(TrainFwdIO)
         : which == 1 ? sizeof(TrainBwdIO)
         : which == 2 ? sizeof(AdamIO)
                      : 0;
}
