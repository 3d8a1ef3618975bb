// Argument blocks the Python wrappers fill (cilium_tpu_torch/kernels/
// abi.py mirrors each struct field for field).  u32 words arrive as
// int32 torch tensors and are read here as uint32_t.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

// The compiled ipcache LPM (datapath/lpm.py DeviceLPM).  The v6 TCAM's
// index (datapath/lpm.py lpm6_index) is what the kernels read of v6.
struct LpmView {
  const int32_t* l1;         // [65536]
  const int32_t* l2;         // [n_l2, 256]
  const int32_t* l3;         // [n_l3, 256]
  const uint32_t* v6_net;    // [n_v6, 4]
  const uint32_t* v6_mask;   // [n_v6, 4]
  const int32_t* v6_value;   // [n_v6]
  const int32_t* v6_plen;    // [n_v6]
  const int32_t* v6_groups;  // [n_groups, 8]: mask[4], top plen, 0, 0, 0
  const int32_t* v6_index;   // [index_cap, 8]: net[4], group (-1 free),
                             // entry, plen, value; 32-byte aligned
  int32_t n_l2;
  int32_t n_l3;
  int32_t n_v6;
  int32_t dflt;
  int32_t n_groups;   // in descending order of their top plen
  int32_t index_cap;  // 2^k, at least half of it free
};

// The policy tensors (datapath/verdict.py DevicePolicy).
struct PolicyView {
  const int32_t* proto_table;  // [n_proto_table]
  const int32_t* port_class;   // [n_proto, n_port]
  const int32_t* class_map;    // [n_pol, n_cls]
  const int32_t* verdict;      // [n_pol, 2, n_rows, n_local]
  const int32_t* ep_policy;    // [n_ep]
  const uint32_t* auth;        // [n_pol, n_rows]
  int32_t n_proto_table;
  int32_t n_proto;
  int32_t n_port;
  int32_t n_pol;
  int32_t n_cls;
  int32_t n_rows;
  int32_t n_local;
  int32_t n_ep;
};

// The conntrack table (datapath/conntrack.py CTTable).
struct CtView {
  uint32_t* table;    // [capacity, ROW_WORDS]
  uint32_t* fp;       // [capacity]
  uint32_t* dropped;  // [1]
  int32_t capacity;   // 2^k
  int32_t pad;
};

// One batch through the verdict stage (datapath/verdict.py
// verdict_stage): inputs, optional channels (null when absent) and the
// outputs, including what ct_update reads.
struct DatapathIO {
  const uint32_t* rows;             // [n, 16] wide or [n, 4] packed
  const bool* valid;                // [n] or null
  const bool* pre_drop;             // [n] or null
  const uint32_t* pre_drop_reason;  // [n] or null
  const bool* lb_drop;              // [n] or null
  uint32_t* out;                    // [n, 6]
  uint32_t* fwd;                    // [n, 10]
  int32_t* ct_result;               // [n] after the untouched rewrite
  int32_t* slot;                    // [n]
  bool* is_reply;                   // [n]
  bool* do_create;                  // [n]
  uint32_t* proxy;                  // [n]
  uint32_t* l4;                     // [n, 3] proto, flags, length
  uint32_t* metrics;                // [13, 2], counts added atomically
  int32_t n;
  uint32_t now;
  uint32_t ep;    // packed rows only: stream endpoint
  uint32_t dirn;  // packed rows only: stream direction
  int32_t audit;
  // sharded serving: row i belongs to shard i / block and probes that
  // shard's CT slice (conntrack.cuh ct_shard); 1 shard: block == n
  int32_t n_shards;
  int32_t block;
  int32_t pad;
};

// One batch of ct_update inputs (datapath/conntrack.py ct_update).
struct CtUpdateIO {
  const uint32_t* l4;          // [n, 3]
  const uint32_t* fwd;         // [n, 10]
  const int32_t* result;       // [n]
  const int32_t* slot;         // [n]
  const bool* is_reply;        // [n]
  const bool* do_create;       // [n]
  const uint32_t* proxy_port;  // [n]
  const bool* valid;           // [n] or null
  // scratch, allocated by the wrapper
  uint32_t* hash;       // [n] key hash
  uint32_t* key_fp;     // [n] key fingerprint
  int32_t* cand;        // [n, 4] candidate slots, -1 = none
  int32_t* try_slot;    // [n] slot tried this round, -1 = none
  int32_t* plist;       // [2, n] the rows pending entering a round,
                        // compacted, for two rounds at a time
  int32_t* counts;      // [21] rows pending entering round r (r < 20;
                        // the length of its list) and, last, the rows
                        // dropped; zeroed by the kernel
  int32_t* claim;       // [2, capacity] per-round-parity claim words,
                        // -1 between calls (kept by the CT table)
  uint8_t* pending;     // [n]
  int32_t n;
  uint32_t now;
  // sharded serving, as in DatapathIO: slot, cand and try_slot hold
  // slots local to the row's CT slice; claim words are indexed globally
  int32_t n_shards;
  int32_t block;
};

// One batch of L7 requests against a listener table (proxy/l7policy.py
// l7_verdict).
struct L7IO {
  const uint32_t* rules;     // [n_rules, 7]
  const int32_t* rule_cols;  // [n_rules, 2] prefix columns; null if k == 0
  const uint32_t* rows;      // [n, 8], 16-byte aligned
  const uint32_t* pref;      // [n, k, 2] rolling path hashes; null if k == 0
  bool* out;                 // [n]
  int32_t n;
  int32_t n_rules;
  int32_t k;  // prefix columns sampled (0: no prefix tensor)
  int32_t pad;
};

// One in-place update of a contiguous int32 tensor (datapath/loader.py
// _dus), as the runs of datapath/loader.py _dus_runs: c0 c1 c2 runs of
// ``run`` words, run (q0, q1, q2) the update's ((q0 c1 + q1) c2 + q2)-th,
// landing at base + q0 t0 + q1 t1 + q2 t2.
struct DusIO {
  int32_t* dst;            // the table, written in place
  const int32_t* upd;      // the update, contiguous
  int64_t base;            // words: the first run's offset in dst
  int64_t stride[3];       // words: dst strides of the runs' outer dims
  int32_t count[3];        // the runs' outer dims, outermost first
  int32_t run;             // words a run
  int32_t vec;             // 1: run, base, strides, pointers 16-byte whole
  int32_t pad;
};

// The NAT configuration (service/nat.py NATTensors): the non-masquerade
// networks and the egress-gateway rules, each padded to at least one
// unsatisfiable row.
struct NatView {
  const uint32_t* net;       // [k]
  const uint32_t* mask;      // [k]
  const uint32_t* egw_src;   // [g]
  const uint32_t* egw_net;   // [g]
  const uint32_t* egw_mask;  // [g]
  const uint32_t* egw_ip;    // [g]
  int32_t k;
  int32_t g;
  uint32_t node_ip;
  int32_t pad;
};

// One batch of snat_egress (service/nat.py): the rows, the NAT table
// updated in place, the outputs and the per-row scratch.
struct SnatIO {
  const uint32_t* rows;  // [n, 16], 16-byte aligned
  uint32_t* out;         // [n, 16] rewritten rows
  bool* drop;            // [n] pool exhausted
  uint32_t* table;       // [capacity, 6]
  uint32_t* failed;      // [1] allocation failures, added to
  int32_t* claim;        // [3, capacity] the table's claim words,
                         // CLAIM_FREE between calls
  // scratch, allocated by the wrapper
  uint32_t* key;     // [n, 4] src, sport, dst, dport << 8 | proto
  uint32_t* aux;     // [n, 4] hash, rewrite IP, expiry, flags
  int32_t* slot;     // [n] the mapping's slot
  int32_t* plist;    // [3, n] the rows pending entering a step, in turn
  uint32_t* counts;  // [64 + 1024] counters, phase stamps and block
                     // words, set inside the launch (nat.cu)
  int32_t n;
  int32_t capacity;  // 2^k
  uint32_t now;
  int32_t pad;
};

// One batch of snat_reverse (service/nat.py).
struct SnatRevIO {
  const uint32_t* rows;  // [n, 16], 16-byte aligned
  uint32_t* out;         // [n, 16] restored rows
  uint32_t* table;       // [capacity, 6], expiries refreshed in place
  int32_t* claim;        // [capacity] the first row of the table's claim
                         // words, CLAIM_FREE between calls
  uint32_t* meta;        // [64] phase stamps (Stamps), in the per-stream
                         // scratch
  int32_t n;
  int32_t capacity;
  uint32_t now;
  int32_t pad;
};

// One batch of the stateless masquerade (datapath/verdict.py
// apply_masquerade with the CT probe, service/nat.py snat_stage
// without).
struct MasqIO {
  const uint32_t* rows;  // [n, 16] (16-byte aligned: vector loads)
  uint32_t* out;         // [n, 16]
  bool* masq;            // [n]
  int32_t n;
  uint32_t now;
  int32_t probe;  // 1: rows whose reverse CT entry is live keep their source
  int32_t pad;
};

// One batch through the bandwidth policer (datapath/bandwidth.py).
struct BwIO {
  const uint32_t* rows;   // [n, 16], 16-byte aligned
  const uint32_t* rates;  // [MAX_ENDPOINTS] bytes/s, 0 = unlimited
  uint32_t* tokens;       // [MAX_ENDPOINTS] updated in place
  uint32_t* last;         // [1] updated in place
  uint32_t* reasons;      // [n] out
  // the per-stream scratch: the kernel leaves both sums zero
  uint32_t* batch_bytes;  // [MAX_ENDPOINTS] the policed bytes
  uint32_t* consumed;     // [MAX_ENDPOINTS] the kept bytes
  uint32_t* meta;         // [64] phase stamps (Stamps)
  int32_t n;
  uint32_t now;
};

// The compiled v4 frontends (service/__init__.py LBTensors).
struct LbView {
  const uint32_t* svc_ip;        // [s]
  const uint32_t* svc_port;      // [s]
  const uint32_t* svc_proto;     // [s]
  const int32_t* maglev;         // [s, m] backend row, -1 none
  const uint32_t* backend_ip;    // [b]
  const uint32_t* backend_port;  // [b]
  const uint32_t* svc_aff;       // [s] ClientIP affinity TTL, 0 off
  const uint32_t* index;  // [index_cap, 4]: address, port, protocol, the
                          // lowest frontend of that key (-1 free)
  int32_t s;
  int32_t b;
  int32_t m;
  int32_t index_cap;  // 2^k > s
};

// The compiled v6 frontends (service/__init__.py LBTensors6).
struct Lb6View {
  const uint32_t* svc_ip;        // [s, 4], 16-byte aligned
  const uint32_t* svc_port;      // [s]
  const uint32_t* svc_proto;     // [s]
  const int32_t* maglev;         // [s, m]
  const uint32_t* backend_ip;    // [b, 4], 16-byte aligned
  const uint32_t* backend_port;  // [b]
  const int32_t* index;          // [index_cap] lowest frontend a key, -1
  int32_t s;
  int32_t b;
  int32_t m;
  int32_t index_cap;  // 2^k > s
};

// One batch through lb_stage or lb6_stage.
struct LbIO {
  const uint32_t* rows;  // [n, 16], 16-byte aligned
  uint32_t* out;         // [n, 16] rewritten rows
  bool* have_backend;    // [n]
  bool* no_backend;      // [n]
  int32_t n;
  int32_t pad;
};

// One batch through socklb_stage (service/socklb.py): the rows, the
// flow cache and its affinity pins updated in place, the outputs and the
// per-row scratch.
struct SockIO {
  const uint32_t* rows;  // [n, 16], 16-byte aligned
  uint32_t* out;         // [n, 16] rewritten rows
  bool* svc_hit;         // [n]
  bool* no_backend;      // [n]
  uint32_t* table;       // [capacity, 8]
  uint32_t* fp;          // [capacity]
  uint32_t* aff;         // [aff_capacity, 8]
  int32_t* claim;        // [3, capacity] the table's claim words,
                         // CLAIM_FREE between calls
  int32_t* aclaim;       // [3, aff_capacity] the same for the pins
  // scratch, allocated by the wrapper
  uint32_t* key;    // [n, 4] src, sport, vip, dport << 8 | proto
  uint32_t* aux;    // [n, 8] see socklb.cu
  int32_t* list;    // [n] the misses, in their blocks' segments
  int32_t* plist;   // [3, n] the rows pending entering a step, in turn
  uint32_t* meta;   // [64 + 2 * blocks_cap] counters, phase stamps and
                    // block words, set inside the launch (socklb.cu)
  int32_t n;
  int32_t capacity;      // 2^k
  int32_t aff_capacity;  // 2^k
  uint32_t now;
  int32_t blocks_cap;     // blocks `meta` has words for
  int32_t rows_a_thread;  // set by the launcher
};

// K18: one batch's flow features (ml/features.py flow_features).
struct FeatIO {
  const uint32_t* hdr;  // [n, 16] header rows
  const uint32_t* out;  // [n, 6] the datapath step's out rows
  int32_t* id_row;      // [n]
  float* feats;         // [n, 27]
  uint32_t* counts;     // [1 + partials, 8, 4096] scratch: the counters,
                        // then a partial table a block (big batches)
  int32_t n;
  int32_t partials;     // flow_features_blocks(n)
};

// K19: one batch's anomaly scores (ml/model.py score_packets); the model
// is float32, D = 32, H = 64.
struct ScoreIO {
  const int32_t* id_row;    // [n]
  const float* feats;       // [n, 27]
  const float* embed;       // [v, 32]
  const float* w1;          // [59, 64]
  const float* b1;          // [64]
  const float* w2;          // [64, 64]
  const float* b2;          // [64]
  const float* w3;          // [64, 1]
  const float* b3;          // [1]
  const float* feat_mean;   // [27]
  const float* feat_prec;   // [27, 27]
  const float* nov_thresh;  // [] on the card: no host sync
  float* score;             // [n]
  float* logit;             // [n] or null
  float* d2;                // [n] or null
  int32_t n;
  int32_t v;
};

// The XLA gather index rule: a negative index counts from the end once,
// then the index clamps into [0, n).  Gathers in the JAX reference
// follow it, so forged ids read the same cells on both sides.
__device__ __forceinline__ int64_t xla_index(int64_t i, int64_t n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// The name of a CUDA error code, for the wrappers' exceptions.
// Appends the rows i of the block's threads that keep them to `list`
// (when not null) at one atomicAdd a block on *count, and adds their
// number to *also (when not null): one atomicAdd a warp would queue a
// thousand at one address.  Every thread of the block calls; `sh` is two
// words of the block's shared memory.
__device__ __forceinline__ void block_append(bool keep, int32_t i,
                                             uint32_t* count, int32_t* list,
                                             uint32_t* also, uint32_t* sh) {
  const unsigned m = __ballot_sync(0xFFFFFFFFu, keep);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) sh[0] = 0u;
  __syncthreads();
  uint32_t at = 0;
  if (lane == 0 && m) at = atomicAdd(&sh[0], (uint32_t)__popc(m));
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t c = sh[0];
    sh[1] = c ? atomicAdd(count, c) : 0u;
    if (also && c) atomicAdd(also, c);
  }
  __syncthreads();
  at = __shfl_sync(0xFFFFFFFFu, at, 0) + sh[1];
  if (keep && list) list[at + __popc(m & ((1u << lane) - 1u))] = i;
}

// Adds the number of the block's threads whose `flag` is set to *count
// and to *also (when not null), one atomicAdd each a block.  Every thread
// of the block calls.
__device__ __forceinline__ void block_count(bool flag, uint32_t* count,
                                            uint32_t* also) {
  const int c = __syncthreads_count(flag);
  if (threadIdx.x == 0 && c) {
    atomicAdd(count, (uint32_t)c);
    if (also) atomicAdd(also, (uint32_t)c);
  }
}

// Phase stamps of a cooperative kernel (K11, K12, K13, K17): thread 0 of
// block 0 writes the global timer's low word (ns) into words[STAMP_AT +
// k] at the k-th mark, and k + 1 into words[STAMP_AT - 1], so that a
// reader sees how long each phase between two grid barriers took.  One
// timer read and two stores a barrier.
constexpr int STAMP_AT = 16;
constexpr int STAMPS = 48;

struct Stamps {
  uint32_t* words;
  int k;
  __device__ __forceinline__ void mark() {
    if (blockIdx.x != 0 || threadIdx.x != 0 || k >= STAMPS) return;
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    words[STAMP_AT + k] = (uint32_t)t;
    words[STAMP_AT - 1] = (uint32_t)++k;
  }
};

extern "C" const char* cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
