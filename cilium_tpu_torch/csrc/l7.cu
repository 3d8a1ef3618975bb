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
// Design: one thread per request; each block stages the rule table in
// shared memory, 256 rules (9 KB with their columns) a pass, so a
// larger table loops over tiles.  A thread stops testing rules at its
// first hit.  At the proxy's sizes (a few hundred rules, batches of a
// few thousand requests) the work is microseconds: the kernel is bound
// by its launch and the host around it, not by bytes or operations.
#include "views.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;
constexpr int kRuleWords = 7;
constexpr int kRowWords = 8;

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

__global__ void __launch_bounds__(kThreads)
    l7_verdict_kernel(L7IO io) {
  __shared__ uint32_t s_rule[kTile * kRuleWords];
  __shared__ int32_t s_col[kTile * 2];
  const int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < io.n;
  uint32_t q[kRowWords];
  const uint32_t* pref_row = nullptr;
  if (live) {
    const uint4* src = reinterpret_cast<const uint4*>(io.rows) + 2 * (size_t)i;
    const uint4 a = src[0], b = src[1];
    q[0] = a.x; q[1] = a.y; q[2] = a.z; q[3] = a.w;
    q[4] = b.x; q[5] = b.y; q[6] = b.z; q[7] = b.w;
    if (io.k > 0) pref_row = io.pref + (size_t)i * io.k * 2;
  }
  bool hit = false;
  for (int32_t base = 0; base < io.n_rules; base += kTile) {
    const int32_t m = min(kTile, io.n_rules - base);
    __syncthreads();  // the previous tile is no longer read
    for (int32_t j = threadIdx.x; j < m * kRuleWords; j += blockDim.x)
      s_rule[j] = io.rules[(size_t)base * kRuleWords + j];
    if (io.k > 0)
      for (int32_t j = threadIdx.x; j < m * 2; j += blockDim.x)
        s_col[j] = io.rule_cols[(size_t)base * 2 + j];
    __syncthreads();
    if (live && !hit) {
      for (int32_t r = 0; r < m && !hit; ++r)
        hit = rule_hit(s_rule + r * kRuleWords, s_col + r * 2, q, pref_row,
                       io.k);
    }
  }
  if (live) io.out[i] = hit;
}

}  // namespace

extern "C" int l7_verdict_launch(const L7IO* io, cudaStream_t stream) {
  if (io->n > 0) {
    l7_verdict_kernel<<<(io->n + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(*io);
  }
  return (int)cudaGetLastError();
}

extern "C" size_t l7_abi_size(int which) {
  return which == 0 ? sizeof(L7IO) : 0;
}
