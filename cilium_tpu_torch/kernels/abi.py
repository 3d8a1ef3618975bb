"""ctypes mirrors of the argument blocks in ``csrc/views.cuh`` and
``csrc/ring.cu``, field for field (checked against the compiled
``sizeof`` when a library loads)."""

from __future__ import annotations

import ctypes

P = ctypes.c_void_p
I32 = ctypes.c_int32
U32 = ctypes.c_uint32
F32 = ctypes.c_float


class LpmView(ctypes.Structure):
    _fields_ = [("l1", P), ("l2", P), ("l3", P), ("v6_net", P),
                ("v6_mask", P), ("v6_value", P), ("v6_plen", P),
                ("v6_groups", P), ("v6_index", P),
                ("n_l2", I32), ("n_l3", I32), ("n_v6", I32), ("dflt", I32),
                ("n_groups", I32), ("index_cap", I32)]


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
                ("audit", I32), ("n_shards", I32), ("block", I32),
                ("pad", I32)]


class CtUpdateIO(ctypes.Structure):
    _fields_ = [("l4", P), ("fwd", P), ("result", P), ("slot", P),
                ("is_reply", P), ("do_create", P), ("proxy_port", P),
                ("valid", P),
                ("hash", P), ("key_fp", P), ("cand", P),
                ("try_slot", P), ("plist", P), ("counts", P), ("claim", P),
                ("pending", P),
                ("n", I32), ("now", U32), ("n_shards", I32), ("block", I32)]


class RingIO(ctypes.Structure):
    _fields_ = [("out", P), ("valid", P), ("proxy_ports", P), ("buf", P),
                ("cursor", P), ("block_counts", P),
                ("n", I32), ("n_proxy", I32), ("capacity", I32),
                ("trace_sample", U32), ("batch_id", U32), ("n_shards", I32),
                ("block", I32), ("counts_cap", I32)]


MAX_GATHER_SHARDS = 8


class GatherIO(ctypes.Structure):
    _fields_ = [("buf", P), ("out", P), ("n_shards", I32), ("rung", I32),
                ("capacity", I32), ("pad", I32),
                ("starts", U32 * MAX_GATHER_SHARDS)]


class L7IO(ctypes.Structure):
    _fields_ = [("rules", P), ("rule_cols", P), ("rows", P), ("pref", P),
                ("out", P), ("n", I32), ("n_rules", I32), ("k", I32),
                ("pad", I32)]


I64 = ctypes.c_int64


class DusIO(ctypes.Structure):
    _fields_ = [("dst", P), ("upd", P), ("base", I64), ("stride", I64 * 3),
                ("count", I32 * 3), ("run", I32), ("vec", I32),
                ("pad", I32)]


class NatView(ctypes.Structure):
    _fields_ = [("net", P), ("mask", P), ("egw_src", P), ("egw_net", P),
                ("egw_mask", P), ("egw_ip", P), ("k", I32), ("g", I32),
                ("node_ip", U32), ("pad", I32)]


class SnatIO(ctypes.Structure):
    _fields_ = [("rows", P), ("out", P), ("drop", P), ("table", P),
                ("failed", P), ("claim", P), ("key", P), ("aux", P),
                ("slot", P), ("plist", P), ("counts", P), ("n", I32),
                ("capacity", I32), ("now", U32), ("pad", I32)]


class SnatRevIO(ctypes.Structure):
    _fields_ = [("rows", P), ("out", P), ("table", P), ("claim", P),
                ("meta", P), ("n", I32), ("capacity", I32),
                ("now", U32), ("pad", I32)]


class MasqIO(ctypes.Structure):
    _fields_ = [("rows", P), ("out", P), ("masq", P), ("n", I32),
                ("now", U32), ("probe", I32), ("pad", I32)]


class BwIO(ctypes.Structure):
    _fields_ = [("rows", P), ("rates", P), ("tokens", P), ("last", P),
                ("reasons", P), ("batch_bytes", P), ("consumed", P),
                ("meta", P), ("n", I32), ("now", U32)]


class LbView(ctypes.Structure):
    _fields_ = [("svc_ip", P), ("svc_port", P), ("svc_proto", P),
                ("maglev", P), ("backend_ip", P), ("backend_port", P),
                ("svc_aff", P), ("index", P), ("s", I32), ("b", I32),
                ("m", I32), ("index_cap", I32)]


class Lb6View(ctypes.Structure):
    _fields_ = [("svc_ip", P), ("svc_port", P), ("svc_proto", P),
                ("maglev", P), ("backend_ip", P), ("backend_port", P),
                ("index", P), ("s", I32), ("b", I32), ("m", I32),
                ("index_cap", I32)]


class LbIO(ctypes.Structure):
    _fields_ = [("rows", P), ("out", P), ("have_backend", P),
                ("no_backend", P), ("n", I32), ("pad", I32)]


class SockIO(ctypes.Structure):
    _fields_ = [("rows", P), ("out", P), ("svc_hit", P), ("no_backend", P),
                ("table", P), ("fp", P), ("aff", P), ("claim", P),
                ("aclaim", P), ("key", P), ("aux", P), ("list", P),
                ("plist", P), ("meta", P), ("n", I32), ("capacity", I32),
                ("aff_capacity", I32), ("now", U32), ("blocks_cap", I32),
                ("rows_a_thread", I32)]


class FeatIO(ctypes.Structure):
    _fields_ = [("hdr", P), ("out", P), ("id_row", P), ("feats", P),
                ("counts", P), ("n", I32), ("partials", I32)]


class ScoreIO(ctypes.Structure):
    _fields_ = [("id_row", P), ("feats", P), ("embed", P), ("w1", P),
                ("b1", P), ("w2", P), ("b2", P), ("w3", P), ("b3", P),
                ("feat_mean", P), ("feat_prec", P), ("nov_thresh", P),
                ("score", P), ("logit", P), ("d2", P), ("n", I32),
                ("v", I32)]


class TrainFwdIO(ctypes.Structure):
    _fields_ = [("id_row", P), ("feats", P), ("labels", P), ("embed", P),
                ("w1", P), ("b1", P), ("w2", P), ("b2", P), ("w3", P),
                ("b3", P), ("xT", P), ("h1T", P), ("h2T", P), ("logit", P),
                ("partial", P), ("loss", P), ("ticket", P), ("n", I32),
                ("v", I32), ("n_shards", I32), ("block", I32)]


class TrainBwdIO(ctypes.Structure):
    _fields_ = [("id_row", P), ("labels", P), ("gloss", P), ("logit", P),
                ("xT", P), ("h1T", P), ("h2T", P), ("w1", P), ("w2", P),
                ("w3", P), ("dz1T", P), ("dz2T", P), ("dz3", P), ("de", P),
                ("wpart", P), ("key_tmp", P), ("row_tmp", P),
                ("sorted_key", P), ("sorted_row", P), ("first", P),
                ("seg", P), ("head", P),
                ("dw1", P), ("db1", P), ("dw2", P), ("db2", P), ("dw3", P),
                ("db3", P), ("d_embed", P), ("n", I32), ("v", I32),
                ("n_shards", I32), ("block", I32)]


class AdamLeaf(ctypes.Structure):
    # n4 and unit0 are the launcher's (csrc/mltrain.cu), left 0 here
    _fields_ = [("p", P), ("g", P), ("mu", P), ("nu", P),
                ("n", ctypes.c_int64), ("n4", ctypes.c_int64),
                ("unit0", ctypes.c_int64)]


ADAM_MAX_LEAVES = 8


class AdamIO(ctypes.Structure):
    _fields_ = [("leaf", AdamLeaf * ADAM_MAX_LEAVES), ("count", P),
                ("ticket", P), ("units", ctypes.c_int64), ("n_leaves", I32),
                ("neg_lr", F32)]


# per library: (symbol reporting sizeof, [structs in its index order])
ABI = {
    "verdict": ("verdict_abi_size", [LpmView, PolicyView, CtView,
                                     DatapathIO]),
    "conntrack": ("ct_abi_size", [CtView, CtUpdateIO]),
    "lpm": ("lpm_abi_size", [LpmView]),
    "ring": ("ring_abi_size", [RingIO, GatherIO]),
    "l7": ("l7_abi_size", [L7IO]),
    "tables": ("tables_abi_size", [DusIO]),
    "nat": ("nat_abi_size", [NatView, CtView, SnatIO, SnatRevIO, MasqIO]),
    "bandwidth": ("bandwidth_abi_size", [BwIO]),
    "lb": ("lb_abi_size", [LbView, Lb6View, LbIO]),
    "socklb": ("socklb_abi_size", [LbView, SockIO]),
    "ml": ("ml_abi_size", [FeatIO, ScoreIO]),
    "mltrain": ("mltrain_abi_size", [TrainFwdIO, TrainBwdIO, AdamIO]),
}

# per library: {symbol: argtypes}; every launcher returns cudaError_t
SIGNATURES = {
    "verdict": {"datapath_launch": [P, P, P, P, ctypes.c_int, P]},
    "conntrack": {"ct_lookup_launch": [P, P, P, U32, P, P, P, I32, P],
                  "ct_update_launch": [P, P, P],
                  "ct_gc_launch": [P, U32, P, P, P],
                  "ct_occupied_launch": [P, I32, P, P, P]},
    "lpm": {"lpm_lookup_launch": [P, P, P, P, I32, P]},
    "ring": {"ring_append_launch": [P, P], "ring_gather_launch": [P, P]},
    "l7": {"l7_verdict_launch": [P, P]},
    "tables": {"dus_launch": [P, P]},
    "nat": {"snat_egress_launch": [P, P, P, P],
            "snat_reverse_launch": [P, P, P],
            "masq_rewrite_launch": [P, P, P, P]},
    "bandwidth": {"bw_stage_launch": [P, P]},
    "lb": {"lb_stage_launch": [P, P, P], "lb6_stage_launch": [P, P, P]},
    "socklb": {"socklb_stage_launch": [P, P, P]},
    "ml": {"flow_features_launch": [P, P],
           "flow_features_blocks": [ctypes.c_int],
           "anomaly_score_launch": [P, P]},
    "mltrain": {"anomaly_train_fwd_launch": [P, P],
                "anomaly_train_bwd_launch": [P, P],
                "adam_update_launch": [P, P]},
}
