// Argument blocks the Python wrappers fill (cilium_tpu_torch/kernels/
// abi.py mirrors each struct field for field).  u32 words arrive as
// int32 torch tensors and are read here as uint32_t.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

// The compiled ipcache LPM (datapath/lpm.py DeviceLPM).
struct LpmView {
  const int32_t* l1;        // [65536]
  const int32_t* l2;        // [n_l2, 256]
  const int32_t* l3;        // [n_l3, 256]
  const uint32_t* v6_net;   // [n_v6, 4]
  const uint32_t* v6_mask;  // [n_v6, 4]
  const int32_t* v6_value;  // [n_v6]
  const int32_t* v6_plen;   // [n_v6]
  int32_t n_l2;
  int32_t n_l3;
  int32_t n_v6;
  int32_t dflt;
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
  uint32_t* new_state;  // [n] refreshed state before the max
  uint32_t* hash;       // [n] key hash
  uint32_t* key_fp;     // [n] key fingerprint
  int32_t* cand;        // [n, 4] candidate slots, -1 = none
  int32_t* try_slot;    // [n] slot tried this round, -1 = none
  int32_t* plist;       // [n] compacted pending rows
  int32_t* npend;       // [1] their count
  int32_t* claim;       // [2, capacity] per-round-parity claim words,
                        // -1 between calls (kept by the CT table)
  uint8_t* pending;     // [n]
  int32_t n;
  uint32_t now;
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

// The XLA gather index rule: a negative index counts from the end once,
// then the index clamps into [0, n).  Gathers in the JAX reference
// follow it, so forged ids read the same cells on both sides.
__device__ __forceinline__ int64_t xla_index(int64_t i, int64_t n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// The name of a CUDA error code, for the wrappers' exceptions.
extern "C" const char* cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
