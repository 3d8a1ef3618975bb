"""ctypes mirrors of the argument blocks in ``csrc/views.cuh`` and
``csrc/ring.cu``, field for field (checked against the compiled
``sizeof`` when a library loads)."""

from __future__ import annotations

import ctypes

P = ctypes.c_void_p
I32 = ctypes.c_int32
U32 = ctypes.c_uint32


class LpmView(ctypes.Structure):
    _fields_ = [("l1", P), ("l2", P), ("l3", P), ("v6_net", P),
                ("v6_mask", P), ("v6_value", P), ("v6_plen", P),
                ("n_l2", I32), ("n_l3", I32), ("n_v6", I32), ("dflt", I32)]


class PolicyView(ctypes.Structure):
    _fields_ = [("proto_table", P), ("port_class", P), ("class_map", P),
                ("verdict", P), ("ep_policy", P), ("auth", P),
                ("n_proto_table", I32), ("n_proto", I32), ("n_port", I32),
                ("n_pol", I32), ("n_cls", I32), ("n_rows", I32),
                ("n_local", I32), ("n_ep", I32)]


class CtView(ctypes.Structure):
    _fields_ = [("table", P), ("fp", P), ("dropped", P),
                ("capacity", I32), ("pad", I32)]


class DatapathIO(ctypes.Structure):
    _fields_ = [("rows", P), ("valid", P), ("pre_drop", P),
                ("pre_drop_reason", P), ("lb_drop", P), ("out", P),
                ("fwd", P), ("ct_result", P), ("slot", P),
                ("is_reply", P), ("do_create", P), ("proxy", P),
                ("l4", P), ("metrics", P),
                ("n", I32), ("now", U32), ("ep", U32), ("dirn", U32),
                ("audit", I32), ("pad", I32)]


class CtUpdateIO(ctypes.Structure):
    _fields_ = [("l4", P), ("fwd", P), ("result", P), ("slot", P),
                ("is_reply", P), ("do_create", P), ("proxy_port", P),
                ("valid", P),
                ("new_state", P), ("hash", P), ("key_fp", P), ("cand", P),
                ("try_slot", P), ("plist", P), ("npend", P), ("claim", P),
                ("pending", P),
                ("n", I32), ("now", U32)]


class RingIO(ctypes.Structure):
    _fields_ = [("out", P), ("valid", P), ("proxy_ports", P), ("buf", P),
                ("cursor", P), ("block_counts", P), ("meta", P),
                ("n", I32), ("n_proxy", I32), ("capacity", I32),
                ("trace_sample", U32), ("batch_id", U32), ("pad", I32)]


MAX_GATHER_SHARDS = 8


class GatherIO(ctypes.Structure):
    _fields_ = [("buf", P), ("out", P), ("n_shards", I32), ("rung", I32),
                ("capacity", I32), ("pad", I32),
                ("starts", U32 * MAX_GATHER_SHARDS)]


class L7IO(ctypes.Structure):
    _fields_ = [("rules", P), ("rule_cols", P), ("rows", P), ("pref", P),
                ("out", P), ("n", I32), ("n_rules", I32), ("k", I32),
                ("pad", I32)]


# per library: (symbol reporting sizeof, [structs in its index order])
ABI = {
    "verdict": ("verdict_abi_size", [LpmView, PolicyView, CtView,
                                     DatapathIO]),
    "conntrack": ("ct_abi_size", [CtView, CtUpdateIO]),
    "lpm": ("lpm_abi_size", [LpmView]),
    "ring": ("ring_abi_size", [RingIO, GatherIO]),
    "l7": ("l7_abi_size", [L7IO]),
}

# per library: {symbol: argtypes}; every launcher returns cudaError_t
SIGNATURES = {
    "verdict": {"datapath_launch": [P, P, P, P, ctypes.c_int, P]},
    "conntrack": {"ct_lookup_launch": [P, P, P, U32, P, P, P, I32, P],
                  "ct_update_launch": [P, P, P],
                  "ct_gc_launch": [P, U32, P, P],
                  "ct_occupied_launch": [P, I32, P, P]},
    "lpm": {"lpm_lookup_launch": [P, P, P, P, I32, P]},
    "ring": {"ring_append_launch": [P, P], "ring_gather_launch": [P, P]},
    "l7": {"l7_verdict_launch": [P, P]},
}
