// K9: the L7 request verdict -- does any rule of the listener table
// admit each request?
//
// Replaces: cilium_tpu/proxy/l7policy.py l7_verdict (:325), the jitted
// l7_verdict_jit that the reference proxy runs per request batch.  The
// plain version is proxy/l7policy.py l7_verdict_plain.
//
// A request row is 8 u32 words (port, kind, method, path hash lo/hi,
// host hash lo/hi, source row); a rule row 7 (port, kind, method, path
// lo/hi, host lo/hi).  A request is admitted iff some rule matches on
// every field it constrains (0 = any).  A KIND_HTTP_PREFIX rule matches
// HTTP requests whose rolling path hash at the rule's prefix length
// (pref[n, col]) equals the rule's hash; a ".+" rule (method bit 16)
// also needs a non-zero hash one byte further (pref[n, ncol]).  The
// columns come per rule from the wrapper (prefix_columns, computed once
// per policy update), never per request.
//
// Bound: operations at config #4 (4096 requests x 208 rules, K = 2: ~16
// integer operations a (request, rule), 0.0008 ms); at the daemon's shape
// (1-2 requests x 1 rule) the launch itself.  The one-thread-a-request
// kernel it replaced filled 16 of 132 SMs at config #4, walked a denied
// request's 208 rules in series, waited in each warp for its slowest lane
// and re-read the request's prefix hashes from global memory a rule.
//
// Design: a warp a request, its lanes striding over the rules, a block
// of 8 warps (one a request where there are fewer: the daemon's 1-2),
// ceil(n / 8) blocks.  A warp reads its request's 8 words once (a
// broadcast load into every lane's registers) and its K x 2 prefix
// hashes once into its own shared row, tests 32 rules a pass, one a
// lane, and stops after the first pass in which `__any_sync` sees a hit.
// Each block stages the rule table and its prefix columns in shared
// memory, 256 rules (9 KB) a tile, once for the launch where the table
// fits one tile.  A table of at most 32 rules is one pass: each lane
// loads its rule into registers with the request's words, and the block
// has no barrier, so the daemon's one-rule launch waits on one round of
// loads.  `rule_hit` is the thread-a-request
// kernel's, so `out` is the same any.
// On the H100 (PERF.md, the kernel table's P14): ~0.006 ms at config #4 against ~0.039;
// at the daemon's shape the launch floor.
#include "views.cuh"

namespace {

constexpr int kWarps = 8;  // requests a block at once at most, a warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 256;  // rules a staged tile
constexpr int kRuleWords = 7;
constexpr int kRowWords = 8;
constexpr size_t kStaticSmem = kTile * (kRuleWords + 2) * sizeof(uint32_t);

// request row columns (proxy/featurize.py L7_*)
constexpr int kPort = 0, kKind = 1, kMethod = 2, kPath0 = 3, kPath1 = 4,
              kHost0 = 5, kHost1 = 6;
// rule columns (proxy/l7policy.py R_*)
constexpr int rPort = 0, rKind = 1, rMethod = 2, rPath0 = 3, rPath1 = 4,
              rHost0 = 5, rHost1 = 6;
constexpr uint32_t kKindHttp = 0, kKindHttpPrefix = 3;

__device__ __forceinline__ bool rule_hit(const uint32_t* r, const int32_t* c,
                                         const uint32_t* q,
                                         const uint32_t* pref_row, int k) {
  if (q[kPort] != r[rPort]) return false;
  const bool is_pref = r[rKind] == kKindHttpPrefix;
  if (q[kKind] != (is_pref ? kKindHttp : r[rKind])) return false;
  const uint32_t meth = is_pref ? (r[rMethod] & 0xFFu) : r[rMethod];
  if (meth != 0 && q[kMethod] != meth) return false;
  if ((r[rHost0] | r[rHost1]) != 0 &&
      (q[kHost0] != r[rHost0] || q[kHost1] != r[rHost1]))
    return false;
  if (is_pref) {
    if (k == 0) return false;  // no prefix tensor: prefix rows never match
    const uint32_t* at = pref_row + 2 * c[0];
    if (at[0] != r[rPath0] || at[1] != r[rPath1]) return false;
    if ((r[rMethod] >> 16) & 1u) {
      const uint32_t* beyond = pref_row + 2 * c[1];
      return (beyond[0] | beyond[1]) != 0;
    }
    return true;
  }
  return ((r[rPath0] | r[rPath1]) == 0) ||
         (q[kPath0] == r[rPath0] && q[kPath1] == r[rPath1]);
}

// rules [t0, t0 + m) and their prefix columns into shared memory
__device__ __forceinline__ void stage_rules(const L7IO& io, int32_t t0,
                                            int32_t m, uint32_t* s_rule,
                                            int32_t* s_col) {
  for (int32_t j = threadIdx.x; j < m * kRuleWords; j += blockDim.x)
    s_rule[j] = io.rules[(size_t)t0 * kRuleWords + j];
  if (io.k > 0)
    for (int32_t j = threadIdx.x; j < m * 2; j += blockDim.x)
      s_col[j] = io.rule_cols[(size_t)t0 * 2 + j];
}

// request i's 8 words into q (every lane: one broadcast load) and its K
// x 2 prefix hashes into the warp's shared row
__device__ __forceinline__ void fetch_request(const L7IO& io, int32_t i,
                                              uint32_t* q,
                                              uint32_t* pref_row) {
  const int32_t k2 = 2 * io.k;
  const uint4* src = reinterpret_cast<const uint4*>(io.rows) + 2 * (size_t)i;
  const uint4 a = src[0], b = src[1];
  q[0] = a.x; q[1] = a.y; q[2] = a.z; q[3] = a.w;
  q[4] = b.x; q[5] = b.y; q[6] = b.z; q[7] = b.w;
  for (int32_t j = threadIdx.x & 31; j < k2; j += 32)
    pref_row[j] = io.pref[(size_t)i * k2 + j];
}

__global__ void __launch_bounds__(kThreads) l7_verdict_kernel(L7IO io) {
  __shared__ uint32_t s_rule[kTile * kRuleWords];
  __shared__ int32_t s_col[kTile * 2];
  extern __shared__ uint32_t s_pref[];  // [warps][2K] a warp's request's
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t n_rules = io.n_rules;
  const int32_t i = blockIdx.x * (blockDim.x >> 5) + warp;
  const bool live = i < io.n;  // warp-uniform
  uint32_t* pref_row = s_pref + warp * 2 * io.k;
  uint32_t q[kRowWords] = {};
  if (live) fetch_request(io, i, q, pref_row);
  bool hit = false;
  if (n_rules <= 32) {
    // one pass: each lane loads its rule's words at once into registers,
    // and the block needs no barrier (the daemon's table of one rule)
    if (!live) return;
    uint32_t r[kRuleWords] = {};
    int32_t c[2] = {};
    if (lane < n_rules) {
      for (int w = 0; w < kRuleWords; ++w)
        r[w] = io.rules[lane * kRuleWords + w];
      if (io.k > 0) {
        c[0] = io.rule_cols[2 * lane];
        c[1] = io.rule_cols[2 * lane + 1];
      }
    }
    __syncwarp();  // the warp's prefix row is in place
    hit = __any_sync(0xFFFFFFFFu,
                     lane < n_rules && rule_hit(r, c, q, pref_row, io.k));
  } else {
    // the first tile's loads go out with the request's
    const bool one_tile = n_rules <= kTile;
    if (one_tile) stage_rules(io, 0, n_rules, s_rule, s_col);
    __syncthreads();
    for (int32_t t0 = 0; t0 < n_rules; t0 += kTile) {
      const int32_t m = min(kTile, n_rules - t0);
      if (!one_tile) {
        __syncthreads();  // the previous tile is no longer read
        stage_rules(io, t0, m, s_rule, s_col);
        __syncthreads();
      }
      if (!live || hit) continue;  // warp-uniform
      for (int32_t p = 0; p < m; p += 32) {
        const int32_t r = p + lane;
        const bool h = r < m && rule_hit(s_rule + r * kRuleWords,
                                         s_col + r * 2, q, pref_row, io.k);
        if (__any_sync(0xFFFFFFFFu, h)) {
          hit = true;
          break;
        }
      }
    }
  }
  if (live && lane == 0) io.out[i] = hit;
}

}  // namespace

extern "C" int l7_verdict_launch(const L7IO* io, cudaStream_t stream) {
  if (io->n <= 0) return (int)cudaGetLastError();
  // a warp a request: fewer warps a block than kWarps only when there are
  // fewer requests; each warp's prefix row, and past 48 KB in all a block
  // needs the opt-in
  const int warps = io->n < kWarps ? io->n : kWarps;
  const size_t pref_bytes = (size_t)warps * 2 * io->k * sizeof(uint32_t);
  if (pref_bytes + kStaticSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        l7_verdict_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)pref_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  l7_verdict_kernel<<<(io->n + warps - 1) / warps, 32 * warps, pref_bytes,
                      stream>>>(*io);
  return (int)cudaGetLastError();
}

extern "C" size_t l7_abi_size(int which) {
  return which == 0 ? sizeof(L7IO) : 0;
}
