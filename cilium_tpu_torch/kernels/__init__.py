"""The hand-written CUDA kernels of the serving path, the L7 proxy, the
table patches, the service load balancer, the egress stages (NAT
and bandwidth policing), the anomaly scorer and its trainer: their
registry, launch counts and launchers.

Each launcher checks the device, dtype, shape, contiguity and alignment
of every tensor, allocates outputs and scratch with ``torch.empty`` on
the tensors' device, fills the argument block of ``csrc/views.cuh``,
and calls the library's C entry point on the current stream.  The entry
point returns ``cudaGetLastError()`` after its launches; a non-zero code
raises here and the count does not move.  Nothing falls back to a plain
version: the plain versions run only for CPU tensors, in the modules
that own them.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..core.packets import N_COLS
from . import abi

MASK = 0xFFFFFFFF
MAX_RING_BATCH = 1 << 19  # pkt_idx packs into 19 bits
RING_COUNTS = 4096  # K5's block counts: at least its co-resident blocks
MAX_PROXY_PORTS = 15


@dataclass
class Kernel:
    """One kernel of the serving path and the count of its launches."""

    name: str
    source: str  # csrc/<source>.cu
    symbol: str  # its C entry point
    replaces: str  # the JAX device program it replaces (file:line)
    launches: int = 0
    rows: int = 0  # rows its launches took, where the launcher counts them

    def launch(self, *args, rows: int = 0) -> None:
        lib = _library(self.source)
        err = getattr(lib, self.symbol)(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: CUDA error {err} "
                f"({lib.cuda_error_name(err).decode()})")
        self.launches += 1
        self.rows += rows


KERNELS: Dict[str, Kernel] = {k.name: k for k in (
    Kernel("datapath_packed", "verdict", "datapath_launch",
           "cilium_tpu/datapath/verdict.py:408"),
    Kernel("datapath_wide", "verdict", "datapath_launch",
           "cilium_tpu/datapath/verdict.py:180"),
    Kernel("ct_update", "conntrack", "ct_update_launch",
           "cilium_tpu/datapath/conntrack.py:322"),
    Kernel("ring_append", "ring", "ring_append_launch",
           "cilium_tpu/monitor/ring.py:100"),
    Kernel("ring_gather", "ring", "ring_gather_launch",
           "cilium_tpu/monitor/ring.py:344"),
    Kernel("ct_gc", "conntrack", "ct_gc_launch",
           "cilium_tpu/datapath/conntrack.py:441"),
    Kernel("ct_occupied", "conntrack", "ct_occupied_launch",
           "cilium_tpu/datapath/loader.py:76"),
    Kernel("lpm_lookup", "lpm", "lpm_lookup_launch",
           "cilium_tpu/datapath/lpm.py:284"),
    Kernel("ct_lookup", "conntrack", "ct_lookup_launch",
           "cilium_tpu/datapath/conntrack.py:288"),
    Kernel("l7_verdict", "l7", "l7_verdict_launch",
           "cilium_tpu/proxy/l7policy.py:325"),
    Kernel("dus", "tables", "dus_launch",
           "cilium_tpu/datapath/loader.py:56"),
    Kernel("snat_egress", "nat", "snat_egress_launch",
           "cilium_tpu/service/nat.py:225"),
    Kernel("snat_reverse", "nat", "snat_reverse_launch",
           "cilium_tpu/service/nat.py:356"),
    Kernel("bw_stage", "bandwidth", "bw_stage_launch",
           "cilium_tpu/datapath/bandwidth.py:60"),
    Kernel("masq_rewrite", "nat", "masq_rewrite_launch",
           "cilium_tpu/datapath/verdict.py:374"),
    Kernel("lb_stage", "lb", "lb_stage_launch",
           "cilium_tpu/service/__init__.py:391"),
    Kernel("lb6_stage", "lb", "lb6_stage_launch",
           "cilium_tpu/service/__init__.py:435"),
    Kernel("socklb_stage", "socklb", "socklb_stage_launch",
           "cilium_tpu/service/socklb.py:228"),
    Kernel("flow_features", "ml", "flow_features_launch",
           "cilium_tpu/ml/features.py:66"),
    Kernel("anomaly_score", "ml", "anomaly_score_launch",
           "cilium_tpu/ml/model.py:141"),
    Kernel("anomaly_train_fwd", "mltrain", "anomaly_train_fwd_launch",
           "cilium_tpu/ml/model.py:127"),
    Kernel("anomaly_train_bwd", "mltrain", "anomaly_train_bwd_launch",
           "cilium_tpu/ml/train.py:124"),
    Kernel("adam_update", "mltrain", "adam_update_launch",
           "cilium_tpu/ml/train.py:119"),
    # K1s/K4s/K5s: the same launches with the shard as a grid dimension
    # (sharded serving, parallel/mesh.py), counted apart from the
    # single-shard path
    Kernel("datapath_packed_sharded", "verdict", "datapath_launch",
           "cilium_tpu/parallel/mesh.py:259"),
    Kernel("datapath_wide_sharded", "verdict", "datapath_launch",
           "cilium_tpu/parallel/mesh.py:336"),
    Kernel("ct_update_sharded", "conntrack", "ct_update_launch",
           "cilium_tpu/parallel/mesh.py:259"),
    Kernel("ring_append_sharded", "ring", "ring_append_launch",
           "cilium_tpu/parallel/mesh.py:234"),
    # K20s/K21s: K20/K21 over S batch blocks with the shard as a grid
    # dimension and the pmean in the launch (the data-parallel train
    # step, ml/train.py make_train_step(mesh=...))
    Kernel("anomaly_train_fwd_sharded", "mltrain", "anomaly_train_fwd_launch",
           "cilium_tpu/ml/train.py:138"),
    Kernel("anomaly_train_bwd_sharded", "mltrain", "anomaly_train_bwd_launch",
           "cilium_tpu/ml/train.py:128"),
)}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.rows = 0


_READY: set = set()
_READY_LOCK = threading.Lock()


def preload(name: str) -> None:
    """Build and load kernel ``name``'s library now, so that its first
    launch does not pay ``nvcc`` (the table builders call this before
    they take the dispatch lock)."""
    _library(KERNELS[name].source)


def _library(source: str) -> ctypes.CDLL:
    from .build import load

    lib = load(source)
    if source in _READY:
        return lib
    with _READY_LOCK:
        if source in _READY:
            return lib
        size_fn, structs = abi.ABI[source]
        getattr(lib, size_fn).restype = ctypes.c_size_t
        getattr(lib, size_fn).argtypes = [ctypes.c_int]
        for i, st in enumerate(structs):
            got = getattr(lib, size_fn)(i)
            if got != ctypes.sizeof(st):
                raise RuntimeError(
                    f"{source}.cu: sizeof({st.__name__}) is {got}, the "
                    f"ctypes mirror has {ctypes.sizeof(st)}")
        for sym, argtypes in abi.SIGNATURES[source].items():
            fn = getattr(lib, sym)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        _READY.add(source)
    return lib


def _ptr(t: Optional[torch.Tensor], dtype, device, shape=None,
         align: int = 4, name: str = "tensor") -> Optional[int]:
    """Check one kernel argument and return its device address (None
    for an absent optional channel)."""
    if t is None:
        return None
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, kernel runs on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {t.dtype}, kernel takes {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: not {align}-byte aligned")
    return t.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


I32, BOOL = torch.int32, torch.bool


def _index_cap(index, keys: int, what: str) -> int:
    """The slots of a host-built open-addressing index: a power of two
    above ``keys``, so that an empty slot ends every probe."""
    cap = index.shape[0]
    if cap & (cap - 1) or cap <= keys:
        raise ValueError(f"{what} of {cap} slots for {keys} keys: a power "
                         f"of two above them")
    return cap


def lpm_view(t, device) -> abi.LpmView:
    k = t.v6_net.shape[0]
    g = t.v6_groups.shape[0]
    cap = _index_cap(t.v6_index, 1, "LPM v6 index")
    return abi.LpmView(
        l1=_ptr(t.l1, I32, device, (1 << 16,), name="l1"),
        l2=_ptr(t.l2, I32, device, (t.l2.shape[0], 256), name="l2"),
        l3=_ptr(t.l3, I32, device, (t.l3.shape[0], 256), name="l3"),
        v6_net=_ptr(t.v6_net, I32, device, (k, 4), name="v6_net"),
        v6_mask=_ptr(t.v6_mask, I32, device, (k, 4), name="v6_mask"),
        v6_value=_ptr(t.v6_value, I32, device, (k,), name="v6_value"),
        v6_plen=_ptr(t.v6_plen, I32, device, (k,), name="v6_plen"),
        v6_groups=_ptr(t.v6_groups, I32, device, (g, 8), align=16,
                       name="v6_groups"),
        v6_index=_ptr(t.v6_index, I32, device, (cap, 8), align=32,
                      name="v6_index"),
        n_l2=t.l2.shape[0], n_l3=t.l3.shape[0], n_v6=k, dflt=t.default,
        n_groups=g, index_cap=cap)


def policy_view(p, device) -> abi.PolicyView:
    n_pol, two, n_rows, n_local = p.verdict.shape
    assert two == 2, "verdict tensor is [n_pol, 2, n_rows, n_local]"
    n_proto, n_port = p.port_class.shape
    n_cls = p.class_map.shape[1]
    return abi.PolicyView(
        proto_table=_ptr(p.proto_table, I32, device, name="proto_table"),
        port_class=_ptr(p.port_class, I32, device, name="port_class"),
        class_map=_ptr(p.class_map, I32, device, (n_pol, n_cls),
                       name="class_map"),
        verdict=_ptr(p.verdict, I32, device, name="verdict"),
        ep_policy=_ptr(p.ep_policy, I32, device, name="ep_policy"),
        auth=_ptr(p.auth, I32, device, (n_pol, n_rows), name="auth"),
        n_proto_table=p.proto_table.shape[0], n_proto=n_proto,
        n_port=n_port, n_pol=n_pol, n_cls=n_cls, n_rows=n_rows,
        n_local=n_local, n_ep=p.ep_policy.shape[0])


def ct_view(ct, device) -> abi.CtView:
    c = ct.table.shape[0]
    if c & (c - 1):
        raise ValueError(f"CT capacity must be 2^k, got {c}")
    return abi.CtView(
        table=_ptr(ct.table, I32, device, (c, 17), name="ct.table"),
        fp=_ptr(ct.fp, I32, device, (c,), name="ct.fp"),
        dropped=_ptr(ct.dropped, I32, device, (), name="ct.dropped"),
        capacity=c)


def launch_lpm_lookup(t, ip_words: torch.Tensor,
                      family: torch.Tensor) -> torch.Tensor:
    """K2: ``lpm_lookup`` over [N, 4] address words and [N] families."""
    dev, n = ip_words.device, ip_words.shape[0]
    out = torch.empty(n, dtype=I32, device=dev)
    view = lpm_view(t, dev)
    KERNELS["lpm_lookup"].launch(
        ctypes.addressof(view),
        _ptr(ip_words, I32, dev, (n, 4), align=16, name="ip_words"),
        _ptr(family, I32, dev, (n,), name="family"),
        out.data_ptr(), n, _stream(dev))
    return out


def launch_ct_lookup(ct, fwd: torch.Tensor, rev: torch.Tensor, now: int):
    """K3: ``ct_lookup`` over [N, 10] forward and reverse keys."""
    dev, n = fwd.device, fwd.shape[0]
    result = torch.empty(n, dtype=I32, device=dev)
    slot = torch.empty(n, dtype=I32, device=dev)
    is_reply = torch.empty(n, dtype=BOOL, device=dev)
    view = ct_view(ct, dev)
    KERNELS["ct_lookup"].launch(
        ctypes.addressof(view),
        _ptr(fwd, I32, dev, (n, 10), name="fwd"),
        _ptr(rev, I32, dev, (n, 10), name="rev"),
        int(now) & MASK, result.data_ptr(), slot.data_ptr(),
        is_reply.data_ptr(), n, _stream(dev))
    return result, slot, is_reply


def shard_block(n: int, n_shards: Optional[int], what: str,
                capacity: Optional[int] = None) -> int:
    """Rows per shard of an ``n``-row routed batch over ``n_shards``
    (None: the single-shard path, one block of ``n``); checks that the
    batch and the CT ``capacity`` split evenly and that each CT slice is
    2^k slots."""
    if n_shards is None:
        return n
    if n_shards < 1 or n % n_shards:
        raise ValueError(f"{what}: {n} rows do not split into {n_shards} "
                         f"shard blocks")
    if capacity is not None:
        cs = capacity // n_shards
        if capacity % n_shards or cs & (cs - 1):
            raise ValueError(f"{what}: CT capacity {capacity} does not "
                             f"split into {n_shards} slices of 2^k slots")
    return n // n_shards


def launch_ct_update(ct, l4, fwd, result, slot, is_reply, do_create,
                     proxy_port, now: int, valid=None,
                     n_shards: Optional[int] = None,
                     scratch: Optional[dict] = None):
    """K4: one cooperative ``ct_update`` launch; updates ``ct`` in place.
    ``n_shards`` (K4s): a routed batch of that many shard blocks, each
    row working in its shard's CT slice (``slot`` local to it).  A
    ``scratch`` dict gets the kernel's scratch tensors, among them
    ``counts`` ([21]: the rows pending entering each insert round, 0
    from the round the kernel stopped at, then the rows dropped)."""
    from ..datapath.conntrack import N_ROUNDS

    dev, n = fwd.device, fwd.shape[0]
    c = ct.table.shape[0]
    block = shard_block(n, n_shards, "ct_update", c)

    def empty(*shape, dtype=I32):
        return torch.empty(shape, dtype=dtype, device=dev)

    if ct.claim is None:  # the insert rounds' claim words, -1 between calls
        ct.claim = torch.full((2, c), -1, dtype=I32, device=dev)
    s = dict(hash=empty(n), key_fp=empty(n),
             cand=empty(n, 4), try_slot=empty(n), plist=empty(2, n),
             counts=empty(N_ROUNDS + 1), pending=empty(n, dtype=torch.uint8))
    io = abi.CtUpdateIO(
        l4=_ptr(l4, I32, dev, (n, 3), name="l4"),
        fwd=_ptr(fwd, I32, dev, (n, 10), name="fwd"),
        result=_ptr(result, I32, dev, (n,), name="result"),
        slot=_ptr(slot, I32, dev, (n,), name="slot"),
        is_reply=_ptr(is_reply, BOOL, dev, (n,), name="is_reply"),
        do_create=_ptr(do_create, BOOL, dev, (n,), name="do_create"),
        proxy_port=_ptr(proxy_port, I32, dev, (n,), name="proxy_port"),
        valid=_ptr(valid, BOOL, dev, (n,), name="valid"),
        n=n, now=int(now) & MASK, n_shards=n_shards or 1, block=block,
        claim=_ptr(ct.claim, I32, dev, (2, c), name="ct.claim"),
        **{k: v.data_ptr() for k, v in s.items()})
    view = ct_view(ct, dev)
    KERNELS["ct_update" if n_shards is None else "ct_update_sharded"].launch(
        ctypes.addressof(view), ctypes.addressof(io), _stream(dev), rows=n)
    if scratch is not None:
        scratch.update(s)
    return ct


def launch_datapath(state, rows: torch.Tensor, now: int, ep, dirn, valid,
                    pre_drop, pre_drop_reason, lb_drop, audit,
                    n_shards: Optional[int] = None):
    """K1: the verdict stage over packed [N, 4] rows (``ep`` given) or
    wide [N, 16] rows.  Returns (out, CTUpdateInput) and adds the
    batch's metrics to ``state.metrics``.  ``out``, ``fwd`` and ``l4``
    come from ``torch.empty``, 16-byte aligned: the kernel writes them
    16 bytes a store.  ``n_shards`` (K1s): the rows
    are that many flow-routed shard blocks, each probing its shard's CT
    slice; the slots handed to ``ct_update`` are local to the slice."""
    from ..datapath.verdict import CTUpdateInput

    packed = ep is not None
    dev, n = rows.device, rows.shape[0]
    block = shard_block(n, n_shards, "datapath", state.ct.table.shape[0])

    def empty(*shape, dtype=I32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out, fwd, l4 = empty(n, 6), empty(n, 10), empty(n, 3)
    ctin = CTUpdateInput(l4=l4, fwd=fwd, result=empty(n), slot=empty(n),
                         is_reply=empty(n, dtype=BOOL),
                         do_create=empty(n, dtype=BOOL), proxy_port=empty(n))
    io = abi.DatapathIO(
        rows=_ptr(rows, I32, dev, (n, 4 if packed else 16), align=16,
                  name="rows"),
        valid=_ptr(valid, BOOL, dev, (n,), name="valid"),
        pre_drop=_ptr(pre_drop, BOOL, dev, (n,), name="pre_drop"),
        pre_drop_reason=_ptr(pre_drop_reason, I32, dev, (n,),
                             name="pre_drop_reason"),
        lb_drop=_ptr(lb_drop, BOOL, dev, (n,), name="lb_drop"),
        out=out.data_ptr(), fwd=fwd.data_ptr(),
        ct_result=ctin.result.data_ptr(), slot=ctin.slot.data_ptr(),
        is_reply=ctin.is_reply.data_ptr(),
        do_create=ctin.do_create.data_ptr(),
        proxy=ctin.proxy_port.data_ptr(), l4=l4.data_ptr(),
        metrics=_ptr(state.metrics, I32, dev, (13, 2), name="metrics"),
        n=n, now=int(now) & MASK,
        ep=int(ep) & MASK if packed else 0,
        dirn=int(dirn) & MASK if packed else 0,
        audit=int(bool(audit)), n_shards=n_shards or 1, block=block)
    pol = policy_view(state.policy, dev)
    lpm = lpm_view(state.ipcache, dev)
    ct = ct_view(state.ct, dev)
    name = "datapath_packed" if packed else "datapath_wide"
    kernel = KERNELS[name if n_shards is None else name + "_sharded"]
    kernel.launch(ctypes.addressof(io), ctypes.addressof(pol),
                  ctypes.addressof(lpm), ctypes.addressof(ct),
                  int(packed), _stream(dev), rows=n)
    return out, ctin


# Words a kernel keeps between its launches, zeroed once here, one set a
# (device, kernel, stream), so that launches sharing one run in stream
# order: K20's and K22's last-block tickets (the last block of every
# launch leaves its counter at 0 again), K5's block counts (each
# launch writes its entries before it reads them), K13's two sums over
# the 4096 buckets (each launch zeroes them behind itself), then its 64
# words of phase stamps, K7's eviction sum and ticket (its last block
# zeroes both), K12's phase stamps, and K8's 64-bit meeting word (its
# last block zeroes it)
_SCRATCH_WORDS = {"ring_append": RING_COUNTS,
                  "ring_append_sharded": RING_COUNTS,
                  "anomaly_train_fwd": 1, "anomaly_train_fwd_sharded": 1,
                  "adam_update": 1, "bw_stage": 2 * 4096 + 64, "ct_gc": 2,
                  "snat_reverse": 64, "ct_occupied": 2}
_STREAM_SCRATCH: Dict[tuple, torch.Tensor] = {}


def make_stream_scratch(stream) -> None:
    """Make every kernel's scratch for ``stream`` (a torch.cuda.Stream),
    outside a CUDA graph capture, so that a graph captured on that
    stream finds it.  A wrapper's first launch on a stream outside a
    capture makes the stream's scratch itself."""
    for name, n in _SCRATCH_WORDS.items():
        key = (stream.device, name, stream.cuda_stream)
        if key not in _STREAM_SCRATCH:
            _STREAM_SCRATCH[key] = torch.zeros(n, dtype=I32,
                                               device=stream.device)


def _stream_scratch(dev, name: str, stream: int) -> int:
    key = (dev, name, stream)
    t = _STREAM_SCRATCH.get(key)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            # the zero fill would be a graph node, the words unset until
            # the graph runs
            raise RuntimeError(f"{name}: no scratch for the capturing "
                               f"stream; call make_stream_scratch(stream) "
                               f"before the capture")
        t = _STREAM_SCRATCH.setdefault(key, torch.zeros(
            _SCRATCH_WORDS[name], dtype=I32, device=dev))
    return t.data_ptr()


def launch_ring_append(ring, out: torch.Tensor, batch_id: int,
                       trace_sample: int, valid, proxy_ports,
                       n_shards: Optional[int] = None):
    """K5: compact one batch's events into ``ring`` in place.
    ``n_shards`` (K5s): ``out`` is that many shard blocks and ``ring``
    a sharded ring ([S * cap, 2] buffer, [S, 2] cursor); each block
    appends to its own shard's ring with shard-local packet indices."""
    dev, n = out.device, out.shape[0]
    block = shard_block(n, n_shards, "ring_append")
    s = n_shards or 1
    if block > MAX_RING_BATCH:
        raise ValueError(f"ring_append: {block} rows a shard, pkt_idx "
                         f"packs 19 bits")
    n_proxy = 0 if proxy_ports is None else proxy_ports.shape[0]
    if n_proxy > MAX_PROXY_PORTS:
        raise ValueError("listener index packs into 4 bits")
    cap = ring.buf.shape[0] // s
    if cap & (cap - 1) or cap * s != ring.buf.shape[0]:
        raise ValueError(f"ring capacity must be 2^k a shard, got "
                         f"{ring.buf.shape[0]} rows for {s} shards")
    name = "ring_append" if n_shards is None else "ring_append_sharded"
    stream = _stream(dev)
    io = abi.RingIO(
        out=_ptr(out, I32, dev, (n, 6), name="out"),
        valid=_ptr(valid, BOOL, dev, (n,), name="valid"),
        proxy_ports=(_ptr(proxy_ports, I32, dev, (n_proxy,),
                          name="proxy_ports") if n_proxy else None),
        buf=_ptr(ring.buf, I32, dev, (s * cap, 2), align=8,
                 name="ring.buf"),
        cursor=_ptr(ring.cursor, I32, dev,
                    (2,) if n_shards is None else (s, 2),
                    name="ring.cursor"),
        block_counts=_stream_scratch(dev, name, stream),
        n=n, n_proxy=n_proxy, capacity=cap,
        trace_sample=int(trace_sample) & MASK,
        batch_id=int(batch_id) & MASK, n_shards=s, block=block,
        counts_cap=RING_COUNTS)
    KERNELS[name].launch(ctypes.addressof(io), stream)
    return ring


def launch_ring_gather(buf: torch.Tensor, starts, rung: int,
                       cap: int) -> torch.Tensor:
    """K6: each shard's ``rung`` slots from its oldest surviving one, in
    append order, into a fresh [n_shards * rung, 2] tensor."""
    dev = buf.device
    starts = [int(x) & MASK for x in starts]
    n_shards = len(starts)
    if not 0 < n_shards <= abi.MAX_GATHER_SHARDS:
        raise ValueError(f"ring_gather: {n_shards} shards, the kernel "
                         f"takes 1..{abi.MAX_GATHER_SHARDS}")
    if cap & (cap - 1) or not 0 < rung <= cap:
        raise ValueError(f"ring_gather: rung {rung}, capacity {cap}")
    out = torch.empty((n_shards * rung, 2), dtype=I32, device=dev)
    io = abi.GatherIO(
        buf=_ptr(buf, I32, dev, (n_shards * cap, 2), align=8,
                 name="ring.buf"),
        out=out.data_ptr(), n_shards=n_shards, rung=rung, capacity=cap,
        starts=(ctypes.c_uint32 * abi.MAX_GATHER_SHARDS)(*starts))
    KERNELS["ring_gather"].launch(ctypes.addressof(io), _stream(dev))
    return out


def launch_ct_gc(ct, now: int) -> torch.Tensor:
    """K7: the CT aging sweep, in place, one kernel; returns the eviction
    count as a [1] u32 tensor on the card (no host sync).  The blocks
    sum it in the stream's scratch, which the last block leaves zero."""
    dev = ct.table.device
    count = torch.empty(1, dtype=I32, device=dev)
    view = ct_view(ct, dev)
    stream = _stream(dev)
    KERNELS["ct_gc"].launch(ctypes.addressof(view), int(now) & MASK,
                            count.data_ptr(),
                            _stream_scratch(dev, "ct_gc", stream), stream)
    return count


def launch_ct_occupied(fp: torch.Tensor) -> torch.Tensor:
    """K8: occupied CT slots (fingerprint not 0) as a [1] u32 tensor on
    the card, one kernel: the blocks meet in a 64-bit word of the
    stream's scratch, which the last block leaves zero."""
    dev, c = fp.device, fp.shape[0]
    count = torch.empty(1, dtype=I32, device=dev)
    stream = _stream(dev)
    KERNELS["ct_occupied"].launch(_ptr(fp, I32, dev, (c,), name="ct.fp"), c,
                                  count.data_ptr(),
                                  _stream_scratch(dev, "ct_occupied",
                                                  stream), stream)
    return count


def launch_l7_verdict(rules: torch.Tensor, rows: torch.Tensor,
                      pref: Optional[torch.Tensor],
                      rule_cols: Optional[torch.Tensor]) -> torch.Tensor:
    """K9: the L7 verdict of [N, 8] request rows against [R, 7] rules;
    ``pref`` [N, K, 2] with its [R, 2] ``rule_cols`` serves the prefix
    rules (None: they match nothing); ``rule_cols`` must come from
    ``proxy.l7policy.prefix_columns`` for that sampling, which keeps
    every column inside [0, K).  Returns [N] bool."""
    dev, n, n_rules = rows.device, rows.shape[0], rules.shape[0]
    k = 0 if pref is None else pref.shape[1]
    if n_rules == 0:
        raise ValueError("l7_verdict: no rules (the caller answers all "
                         "false without a launch)")
    if k and rule_cols is None:
        raise ValueError("l7_verdict: a prefix tensor needs its rule_cols")
    out = torch.empty(n, dtype=BOOL, device=dev)
    if n == 0:
        return out
    io = abi.L7IO(
        rules=_ptr(rules, I32, dev, (n_rules, 7), name="rules"),
        rule_cols=(_ptr(rule_cols, I32, dev, (n_rules, 2),
                        name="rule_cols") if k else None),
        rows=_ptr(rows, I32, dev, (n, 8), align=16, name="rows"),
        pref=_ptr(pref, I32, dev, (n, k, 2), name="pref") if k else None,
        out=out.data_ptr(), n=n, n_rules=n_rules, k=k)
    KERNELS["l7_verdict"].launch(ctypes.addressof(io), _stream(dev),
                                 rows=n)
    return out


def launch_dus(dst: torch.Tensor, upd: torch.Tensor, starts) -> None:
    """K10: ``upd`` written into ``dst`` in place at ``starts``, taken
    as ``jax.lax.dynamic_update_slice`` takes them (a negative start
    counts from the end once, then XLA's clamp).  Both int32,
    contiguous, of one rank from 1 to 4, ``upd`` no larger than ``dst``
    in any dimension.  The host cuts the update into runs
    (``datapath/loader.py`` ``_dus_runs``); the kernel copies them, 16
    bytes a thread where every run and both pointers are 16-byte
    whole."""
    from ..datapath.loader import _dus_runs

    dev, rank = dst.device, dst.dim()
    if not 1 <= rank <= 4 or upd.dim() != rank or len(starts) != rank:
        raise ValueError(f"dus: ranks dst {rank}, upd {upd.dim()}, starts "
                         f"{len(starts)}; the kernel takes one rank of 1-4")
    if any(u > d for u, d in zip(upd.shape, dst.shape)):
        raise ValueError(f"dus: update {tuple(upd.shape)} larger than "
                         f"{tuple(dst.shape)}")
    if upd.numel() >= 1 << 31:
        raise ValueError(f"dus: an update of {upd.numel()} words; the "
                         f"kernel takes fewer than 2^31")
    d_ptr = _ptr(dst, I32, dev, name="dst")
    u_ptr = _ptr(upd, I32, dev, name="upd")
    r = _dus_runs(dst.shape, upd.shape, starts)
    vec = (r.run % 4 == 0 and r.base % 4 == 0
           and all(t % 4 == 0 for t in r.strides)
           and d_ptr % 16 == 0 and u_ptr % 16 == 0)
    io = abi.DusIO(dst=d_ptr, upd=u_ptr, base=r.base,
                   stride=(ctypes.c_int64 * 3)(*r.strides),
                   count=(ctypes.c_int32 * 3)(*r.counts), run=r.run,
                   vec=int(vec))
    KERNELS["dus"].launch(ctypes.addressof(io), _stream(dev))


def nat_view(t, device) -> abi.NatView:
    k, g = t.net.shape[0], t.egw_src.shape[0]
    return abi.NatView(
        net=_ptr(t.net, I32, device, (k,), name="nat.net"),
        mask=_ptr(t.mask, I32, device, (k,), name="nat.mask"),
        egw_src=_ptr(t.egw_src, I32, device, (g,), name="nat.egw_src"),
        egw_net=_ptr(t.egw_net, I32, device, (g,), name="nat.egw_net"),
        egw_mask=_ptr(t.egw_mask, I32, device, (g,), name="nat.egw_mask"),
        egw_ip=_ptr(t.egw_ip, I32, device, (g,), name="nat.egw_ip"),
        k=k, g=g, node_ip=int(t.node_ip) & MASK)


def _nat_table(tbl, device):
    """The NAT table's pointers: (table, its claim words, capacity)."""
    from ..service.nat import NAT_ROW_WORDS

    p = tbl.table.shape[0]
    if p & (p - 1):
        raise ValueError(f"NAT capacity must be 2^k, got {p}")
    return (_ptr(tbl.table, I32, device, (p, NAT_ROW_WORDS), align=8,
                 name="nat.table"),
            _ptr(tbl.claim, I32, device, (3, p), name="nat.claim"), p)


# K11's and K17's counters (csrc/nat.cu, csrc/socklb.cu): the rows
# pending entering each claim step, then those left pending after the
# last; K17 then its misses; then 1 + the step at which one block took
# over (0: none); word 15 the number of phase stamps that follow it
# (csrc/views.cuh Stamps)
COUNT_WORDS = 64
SOCK_BLOCKS = 1024  # K11's and K17's grids at most: they keep block words


def _stamps(words: torch.Tensor) -> list:
    """The phase stamps of a K11 or K17 call's counters: the ns between
    each grid barrier and the next (block 0's view), from the start."""
    w = words[:COUNT_WORDS].cpu().tolist()
    t = [x & MASK for x in w[16:16 + w[15]]]
    return [(b - a) & MASK for a, b in zip(t, t[1:])]


def launch_snat_egress(tbl, t, ct, hdr: torch.Tensor, now: int,
                       scratch: Optional[dict] = None):
    """K11: egress SNAT with port allocation over wide [N, 16] rows, one
    cooperative kernel; updates ``tbl`` in place, reading ``ct``.
    Returns (rows, tbl, [N] bool drop mask).  A ``scratch`` dict gets
    the kernel's ``counts`` ([10]: the rows pending entering each of the
    8 claim steps, 0 from the step the kernel stopped at, then those
    that failed; then 1 + the step from which one block finished, 0 for
    none) and ``phase_ns`` (a callable: the ns each phase between two
    grid barriers took, read when called)."""
    dev, n = hdr.device, hdr.shape[0]
    table, claim, p = _nat_table(tbl, dev)

    def empty(*shape, dtype=I32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out, drop = empty(n, N_COLS), empty(n, dtype=BOOL)
    s = dict(key=empty(n, 4), aux=empty(n, 4), slot=empty(n),
             plist=empty(3, n), counts=empty(COUNT_WORDS + SOCK_BLOCKS))
    io = abi.SnatIO(
        rows=_ptr(hdr, I32, dev, (n, N_COLS), align=16, name="rows"),
        out=out.data_ptr(), drop=drop.data_ptr(), table=table,
        failed=_ptr(tbl.failed, I32, dev, (), name="nat.failed"),
        claim=claim, n=n, capacity=p, now=int(now) & MASK,
        **{k: v.data_ptr() for k, v in s.items()})
    view, ctv = nat_view(t, dev), ct_view(ct, dev)
    KERNELS["snat_egress"].launch(ctypes.addressof(io),
                                  ctypes.addressof(view),
                                  ctypes.addressof(ctv), _stream(dev))
    if scratch is not None:
        scratch.update(s, counts=s["counts"][:10],
                       phase_ns=lambda: _stamps(s["counts"]))
    return out, tbl, drop


def launch_snat_reverse(tbl, t, hdr: torch.Tensor, now: int,
                        scratch: Optional[dict] = None):
    """K12: reverse translation of replies to allocated node ports over
    wide [N, 16] rows, one cooperative kernel; refreshes ``tbl`` in
    place.  Returns (rows, tbl).  A ``scratch`` dict gets ``phase_ns``
    (as ``launch_snat_egress``'s)."""
    dev, n = hdr.device, hdr.shape[0]
    table, claim, p = _nat_table(tbl, dev)
    out = torch.empty((n, N_COLS), dtype=I32, device=dev)
    stream = _stream(dev)
    meta = _stream_scratch(dev, "snat_reverse", stream)
    io = abi.SnatRevIO(
        rows=_ptr(hdr, I32, dev, (n, N_COLS), align=16, name="rows"),
        out=out.data_ptr(), table=table, claim=claim, meta=meta, n=n,
        capacity=p, now=int(now) & MASK)
    view = nat_view(t, dev)
    KERNELS["snat_reverse"].launch(ctypes.addressof(io),
                                   ctypes.addressof(view), stream)
    if scratch is not None:
        words = _STREAM_SCRATCH[(dev, "snat_reverse", stream)]
        scratch.update(phase_ns=lambda: _stamps(words))
    return out, tbl


def launch_masq_rewrite(t, hdr: torch.Tensor, ct, now: int):
    """K14: the stateless masquerade over wide [N, 16] rows (16-byte
    loads where they start on a 16-byte boundary, word loads where not),
    with the reverse-CT probe when ``ct`` is given.  One kernel a call.
    Returns (rows, [N] bool)."""
    dev, n = hdr.device, hdr.shape[0]
    out = torch.empty((n, N_COLS), dtype=I32, device=dev)
    masq = torch.empty(n, dtype=BOOL, device=dev)
    if n == 0:
        return out, masq
    io = abi.MasqIO(
        rows=_ptr(hdr, I32, dev, (n, N_COLS), name="rows"),
        out=out.data_ptr(), masq=masq.data_ptr(), n=n,
        now=int(now) & MASK, probe=int(ct is not None))
    view = nat_view(t, dev)
    ctv = ct_view(ct, dev) if ct is not None else None
    KERNELS["masq_rewrite"].launch(
        ctypes.addressof(io), ctypes.addressof(view),
        ctypes.addressof(ctv) if ctv is not None else None, _stream(dev))
    return out, masq


def launch_bw_stage(state, hdr: torch.Tensor, now: int,
                    rates: torch.Tensor,
                    scratch: Optional[dict] = None) -> torch.Tensor:
    """K13: police one batch of wide [N, 16] rows against the
    per-endpoint buckets, updated in place; returns [N] int32 reasons.
    One cooperative kernel; its two sums live in the stream's scratch,
    zero between calls.  A ``scratch`` dict gets ``sums`` ([2, 4096]:
    the policed and the kept bytes, zero once the call has run) and
    ``phase_ns`` (as ``launch_snat_egress``'s)."""
    from ..datapath.verdict import MAX_ENDPOINTS

    dev, n = hdr.device, hdr.shape[0]
    reasons = torch.empty(n, dtype=I32, device=dev)
    stream = _stream(dev)
    words = _stream_scratch(dev, "bw_stage", stream)
    io = abi.BwIO(
        rows=_ptr(hdr, I32, dev, (n, N_COLS), align=16, name="rows"),
        rates=_ptr(rates, I32, dev, (MAX_ENDPOINTS,), name="rates"),
        tokens=_ptr(state.tokens, I32, dev, (MAX_ENDPOINTS,),
                    name="bw.tokens"),
        last=_ptr(state.last, I32, dev, (), name="bw.last"),
        reasons=reasons.data_ptr(), batch_bytes=words,
        consumed=words + 4 * MAX_ENDPOINTS,
        meta=words + 8 * MAX_ENDPOINTS, n=n, now=int(now) & MASK)
    KERNELS["bw_stage"].launch(ctypes.addressof(io), stream)
    if scratch is not None:
        t = _STREAM_SCRATCH[(dev, "bw_stage", stream)]
        scratch.update(sums=t[:2 * MAX_ENDPOINTS].view(2, MAX_ENDPOINTS),
                       phase_ns=lambda: _stamps(t[2 * MAX_ENDPOINTS:]))
    return reasons


def lb_view(t, device) -> abi.LbView:
    s, m = t.maglev.shape
    b = t.backend_ip.shape[0]
    if m != t.m:
        raise ValueError(f"maglev table has {m} slots, LBTensors.m is {t.m}")
    cap = _index_cap(t.index, s, "v4 index")
    return abi.LbView(
        svc_ip=_ptr(t.svc_ip, I32, device, (s,), name="lb.svc_ip"),
        svc_port=_ptr(t.svc_port, I32, device, (s,), name="lb.svc_port"),
        svc_proto=_ptr(t.svc_proto, I32, device, (s,), name="lb.svc_proto"),
        maglev=_ptr(t.maglev, I32, device, (s, m), name="lb.maglev"),
        backend_ip=_ptr(t.backend_ip, I32, device, (b,),
                        name="lb.backend_ip"),
        backend_port=_ptr(t.backend_port, I32, device, (b,),
                          name="lb.backend_port"),
        svc_aff=_ptr(t.svc_aff, I32, device, (s,), name="lb.svc_aff"),
        index=_ptr(t.index, I32, device, (cap, 4), align=16,
                   name="lb.index"),
        s=s, b=b, m=m, index_cap=cap)


def lb6_view(t, device) -> abi.Lb6View:
    s, m = t.maglev.shape
    b = t.backend_ip.shape[0]
    if m != t.m:
        raise ValueError(f"maglev table has {m} slots, LBTensors6.m is {t.m}")
    cap = _index_cap(t.index, s, "v6 index")
    return abi.Lb6View(
        svc_ip=_ptr(t.svc_ip, I32, device, (s, 4), align=16,
                    name="lb6.svc_ip"),
        svc_port=_ptr(t.svc_port, I32, device, (s,), name="lb6.svc_port"),
        svc_proto=_ptr(t.svc_proto, I32, device, (s,),
                       name="lb6.svc_proto"),
        maglev=_ptr(t.maglev, I32, device, (s, m), name="lb6.maglev"),
        backend_ip=_ptr(t.backend_ip, I32, device, (b, 4), align=16,
                        name="lb6.backend_ip"),
        backend_port=_ptr(t.backend_port, I32, device, (b,),
                          name="lb6.backend_port"),
        index=_ptr(t.index, I32, device, (cap,), name="lb6.index"),
        s=s, b=b, m=m, index_cap=cap)


def _launch_lb(name: str, view, hdr: torch.Tensor):
    dev, n = hdr.device, hdr.shape[0]
    out = torch.empty((n, N_COLS), dtype=I32, device=dev)
    have = torch.empty(n, dtype=BOOL, device=dev)
    no_be = torch.empty(n, dtype=BOOL, device=dev)
    io = abi.LbIO(
        rows=_ptr(hdr, I32, dev, (n, N_COLS), align=16, name="rows"),
        out=out.data_ptr(), have_backend=have.data_ptr(),
        no_backend=no_be.data_ptr(), n=n)
    KERNELS[name].launch(ctypes.addressof(io), ctypes.addressof(view),
                         _stream(dev))
    return out, have, no_be


def launch_lb_stage(t, hdr: torch.Tensor):
    """K15: the v4 frontend match, Maglev pick and DNAT over wide
    [N, 16] rows.  Returns (rows, [N] have_backend, [N] no_backend)."""
    return _launch_lb("lb_stage", lb_view(t, hdr.device), hdr)


def launch_lb6_stage(t, hdr: torch.Tensor):
    """K16: the same over the v6 frontends."""
    return _launch_lb("lb6_stage", lb6_view(t, hdr.device), hdr)


def launch_socklb_stage(tbl, t, hdr: torch.Tensor, now: int,
                        scratch: Optional[dict] = None):
    """K17: the flow-cached LB over wide [N, 16] rows, one cooperative
    kernel; updates ``tbl`` (flow rows, fingerprints, affinity pins) in
    place.  Returns (rows, [N] svc_hit, [N] no_backend, tbl).  A
    ``scratch`` dict gets the kernel's ``counts`` ([11]: the rows
    pending entering each of the 8 claim steps, 0 from the step the
    kernel stopped at, then those left uncached; the batch's v4 misses;
    1 + the step from which one block finished, 0 for none) and
    ``phase_ns`` (as ``launch_snat_egress``'s)."""
    dev, n = hdr.device, hdr.shape[0]
    p, a = tbl.table.shape[0], tbl.aff.shape[0]
    if p & (p - 1) or a & (a - 1):
        raise ValueError(f"socklb capacities must be 2^k, got {p}, {a}")

    def empty(*shape, dtype=I32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out, hit, no_be = empty(n, N_COLS), empty(n, dtype=BOOL), empty(
        n, dtype=BOOL)
    s = dict(key=empty(n, 4), aux=empty(n, 8), list=empty(n),
             plist=empty(3, n), meta=empty(COUNT_WORDS + 2 * SOCK_BLOCKS))
    io = abi.SockIO(
        rows=_ptr(hdr, I32, dev, (n, N_COLS), align=16, name="rows"),
        out=out.data_ptr(), svc_hit=hit.data_ptr(),
        no_backend=no_be.data_ptr(),
        table=_ptr(tbl.table, I32, dev, (p, 8), align=16,
                   name="socklb.table"),
        fp=_ptr(tbl.fp, I32, dev, (p,), name="socklb.fp"),
        aff=_ptr(tbl.aff, I32, dev, (a, 8), align=16, name="socklb.aff"),
        claim=_ptr(tbl.claim, I32, dev, (3, p), name="socklb.claim"),
        aclaim=_ptr(tbl.aclaim, I32, dev, (3, a), name="socklb.aclaim"),
        n=n, capacity=p, aff_capacity=a, now=int(now) & MASK,
        blocks_cap=SOCK_BLOCKS, **{k: v.data_ptr() for k, v in s.items()})
    view = lb_view(t, dev)
    KERNELS["socklb_stage"].launch(ctypes.addressof(io),
                                   ctypes.addressof(view), _stream(dev))
    if scratch is not None:
        scratch.update(s, counts=s["meta"][:11],
                       phase_ns=lambda: _stamps(s["meta"]))
    return out, hit, no_be, tbl


def launch_flow_features(hdr: torch.Tensor, out: torch.Tensor):
    """K18: [N, 16] header rows and [N, 6] out rows -> (id_row [N]
    int32, feats [N, 27] float32).  One kernel: the one-cluster kernel
    for a small batch, else the cooperative one, whose blocks each leave
    a partial counter table in the scratch."""
    from ..ml.features import _N_BUCKETS, FEAT_DIM

    dev, n = hdr.device, hdr.shape[0]
    id_row = torch.empty(n, dtype=I32, device=dev)
    feats = torch.empty((n, FEAT_DIM), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        partials = _library("ml").flow_features_blocks(n)
    counts = torch.empty((1 + partials, 8, _N_BUCKETS), dtype=I32,
                         device=dev)
    io = abi.FeatIO(
        hdr=_ptr(hdr, I32, dev, (n, N_COLS), align=16, name="hdr"),
        out=_ptr(out, I32, dev, (n, 6), name="out"),
        id_row=id_row.data_ptr(), feats=feats.data_ptr(),
        counts=counts.data_ptr(), n=n, partials=partials)
    KERNELS["flow_features"].launch(ctypes.addressof(io), _stream(dev))
    return id_row, feats


# the shapes K19 is compiled for: the reference's defaults
SCORE_DIM, SCORE_HIDDEN = 32, 64


def launch_anomaly_score(model, id_row: torch.Tensor, feats: torch.Tensor,
                         outputs=("score",)) -> Dict[str, torch.Tensor]:
    """K19: the anomaly scores of [N] embedding rows and [N, 27]
    features under ``model`` (float32 buffers, D = 32, H = 64, on the
    same card); ``outputs`` names what to return among ``"score"``,
    ``"logit"`` and ``"d2"`` (the score is always computed)."""
    from ..ml.features import FEAT_DIM

    dev, n = feats.device, feats.shape[0]
    f32 = torch.float32
    v, d = model.embed.shape
    h = model.w1.shape[1]
    if (d, h) != (SCORE_DIM, SCORE_HIDDEN) or v < 1:
        raise ValueError(f"anomaly_score: V = {v}, D = {d}, H = {h}; the "
                         f"kernel takes V >= 1, D = {SCORE_DIM}, H = "
                         f"{SCORE_HIDDEN}")
    res = {"score": torch.empty(n, dtype=f32, device=dev)}
    for name in outputs:
        res.setdefault(name, torch.empty(n, dtype=f32, device=dev))
    fin = d + FEAT_DIM

    def w(name, shape, align=4):
        return _ptr(getattr(model, name), f32, dev, shape, align=align,
                    name=name)

    io = abi.ScoreIO(
        id_row=_ptr(id_row, I32, dev, (n,), name="id_row"),
        feats=_ptr(feats, f32, dev, (n, FEAT_DIM), name="feats"),
        embed=w("embed", (v, d), 16), w1=w("w1", (fin, h)), b1=w("b1", (h,)),
        w2=w("w2", (h, h)), b2=w("b2", (h,)), w3=w("w3", (h, 1)),
        b3=w("b3", (1,)), feat_mean=w("feat_mean", (FEAT_DIM,)),
        feat_prec=w("feat_prec", (FEAT_DIM, FEAT_DIM)),
        nov_thresh=w("nov_thresh", ()),
        score=res["score"].data_ptr(),
        logit=res["logit"].data_ptr() if "logit" in res else None,
        d2=res["d2"].data_ptr() if "d2" in res else None, n=n, v=v)
    KERNELS["anomaly_score"].launch(ctypes.addressof(io), _stream(dev))
    return res


# the trainer's kernels (csrc/mltrain.cu; K21's sorted rows a piece and
# weight-gradient chunk are ml/model.py's EMBED_PIECE and WGRAD_CHUNK)
BF16, F32 = torch.bfloat16, torch.float32


def _train_shapes(name, leaves, n):
    """Check the seven trainable leaves (float32, D = 32, H = 64, on
    one card) and the batch size; -> (device, V, the leaves' device
    addresses)."""
    from ..ml.features import FEAT_DIM

    embed = leaves[0]
    v, d = embed.shape
    h = leaves[1].shape[1]
    if (d, h) != (SCORE_DIM, SCORE_HIDDEN) or v < 1:
        raise ValueError(f"{name}: V = {v}, D = {d}, H = {h}; the kernel "
                         f"takes V >= 1, D = {SCORE_DIM}, H = "
                         f"{SCORE_HIDDEN}")
    if not 1 <= n < 1 << 31:
        raise ValueError(f"{name}: a batch of {n} rows; the kernel takes "
                         f"1 to 2^31 - 1")
    dev = embed.device
    fin = d + FEAT_DIM
    shapes = ((v, d), (fin, h), (h,), (h, h), (h,), (h, 1), (1,))
    # embed, w1 and w2 are read 16 bytes a load
    ptrs = [_ptr(t, F32, dev, shp, align=16 if i in (0, 1, 3) else 4,
                 name=nm)
            for i, (t, shp, nm) in enumerate(zip(
                leaves, shapes, ("embed", "w1", "b1", "w2", "b2", "w3",
                                 "b3")))]
    return dev, v, ptrs


def launch_anomaly_train_fwd(leaves, id_row: torch.Tensor,
                             feats: torch.Tensor, labels: torch.Tensor,
                             n_shards: Optional[int] = None):
    """K20: the loss of [N] rows, [N, 27] features and [N] labels under
    the trainable ``leaves`` (embed, w1, b1, w2, b2, w3, b3); -> (loss
    [] float32, the activations K21 takes: ``xT`` [59, N], ``h1T``,
    ``h2T`` [64, N] bf16 and ``logit`` [N] float32).  ``n_shards``
    (K20s): the batch is that many blocks of N / S rows and the loss the
    mean of the blocks' losses in shard order."""
    from ..ml.features import FEAT_DIM

    n = feats.shape[0]
    dev, v, w = _train_shapes("anomaly_train_fwd", leaves, n)
    block = shard_block(n, n_shards, "anomaly_train_fwd")
    s = n_shards or 1
    fin = SCORE_DIM + FEAT_DIM
    saved = {"xT": torch.empty((fin, n), dtype=BF16, device=dev),
             "h1T": torch.empty((SCORE_HIDDEN, n), dtype=BF16, device=dev),
             "h2T": torch.empty((SCORE_HIDDEN, n), dtype=BF16, device=dev),
             "logit": torch.empty(n, dtype=F32, device=dev)}
    partial = torch.empty(n, dtype=F32, device=dev)  # the rows' terms
    loss = torch.empty(1, dtype=F32, device=dev)
    name = ("anomaly_train_fwd" if n_shards is None
            else "anomaly_train_fwd_sharded")
    stream = _stream(dev)
    io = abi.TrainFwdIO(
        id_row=_ptr(id_row, I32, dev, (n,), name="id_row"),
        feats=_ptr(feats, F32, dev, (n, FEAT_DIM), name="feats"),
        labels=_ptr(labels, F32, dev, (n,), name="labels"),
        embed=w[0], w1=w[1], b1=w[2], w2=w[3], b2=w[4], w3=w[5], b3=w[6],
        xT=saved["xT"].data_ptr(), h1T=saved["h1T"].data_ptr(),
        h2T=saved["h2T"].data_ptr(), logit=saved["logit"].data_ptr(),
        partial=partial.data_ptr(), loss=loss.data_ptr(),
        ticket=_stream_scratch(dev, name, stream), n=n, v=v, n_shards=s,
        block=block)
    KERNELS[name].launch(ctypes.addressof(io), stream)
    return loss.reshape(()), saved


def launch_anomaly_train_bwd(leaves, saved, id_row: torch.Tensor,
                             labels: torch.Tensor, gloss: torch.Tensor,
                             n_shards: Optional[int] = None,
                             scratch: Optional[dict] = None):
    """K21: the gradients of K20's loss times ``gloss`` ([1] float32 on
    the card) in each trainable leaf, from K20's ``saved`` activations;
    -> (d_embed [V, 32], dW1, db1, dW2, db2, dW3, db3), float32.
    ``n_shards`` (K21s): each block's gradients of its own loss, their
    mean in shard order (the pmean), as K20s's ``saved`` came.
    ``scratch``: a dict that receives the launch's scratch tensors by
    their ``TrainBwdIO`` names (tests read the sort from it)."""
    from ..ml.features import FEAT_DIM
    from ..ml.model import EMBED_PIECE, WGRAD_CHUNK

    n = saved["logit"].shape[0]
    dev, v, w = _train_shapes("anomaly_train_bwd", leaves, n)
    block = shard_block(n, n_shards, "anomaly_train_bwd")
    s = n_shards or 1
    fin, h = SCORE_DIM + FEAT_DIM, SCORE_HIDDEN
    grads = [torch.empty(tuple(t.shape), dtype=F32, device=dev)
             for t in leaves]
    chunks = -(-block // WGRAD_CHUNK)  # a shard's
    pieces = -(-block // EMBED_PIECE)  # a shard's

    def empty(*shape, dtype=F32):
        return torch.empty(shape, dtype=dtype, device=dev)

    # the scratch lives until the launch is enqueued (the allocator then
    # reuses it in stream order)
    tmp = dict(dz1T=empty(h, n, dtype=BF16), dz2T=empty(h, n, dtype=BF16),
               dz3=empty(n, dtype=BF16), de=empty(n, SCORE_DIM),
               wpart=empty(3, s * chunks, (h + 1) * h),
               key_tmp=empty(n, dtype=I32), row_tmp=empty(n, dtype=I32),
               sorted_key=empty(n, dtype=I32), sorted_row=empty(n, dtype=I32),
               first=empty(s, v, dtype=I32), seg=empty(n, SCORE_DIM),
               head=empty(s * pieces, SCORE_DIM))
    io = abi.TrainBwdIO(
        id_row=_ptr(id_row, I32, dev, (n,), name="id_row"),
        labels=_ptr(labels, F32, dev, (n,), name="labels"),
        gloss=_ptr(gloss, F32, dev, (1,), name="gloss"),
        logit=_ptr(saved["logit"], F32, dev, (n,), name="logit"),
        xT=_ptr(saved["xT"], BF16, dev, (fin, n), name="xT"),
        h1T=_ptr(saved["h1T"], BF16, dev, (h, n), name="h1T"),
        h2T=_ptr(saved["h2T"], BF16, dev, (h, n), name="h2T"),
        w1=w[1], w2=w[3], w3=w[5],
        **{k: t.data_ptr() for k, t in tmp.items()},
        dw1=grads[1].data_ptr(), db1=grads[2].data_ptr(),
        dw2=grads[3].data_ptr(), db2=grads[4].data_ptr(),
        dw3=grads[5].data_ptr(), db3=grads[6].data_ptr(),
        d_embed=grads[0].data_ptr(), n=n, v=v, n_shards=s, block=block)
    KERNELS["anomaly_train_bwd" if n_shards is None
            else "anomaly_train_bwd_sharded"].launch(ctypes.addressof(io),
                                                     _stream(dev))
    if scratch is not None:
        scratch.update(tmp)
    return tuple(grads)


def launch_adam_update(params, grads, mu, nu, count: torch.Tensor,
                       lr: float) -> None:
    """K22: one ``optax.adam(lr)`` step over every leaf in place: ``params``,
    ``mu`` and ``nu`` updated, ``count`` ([] int32 on the card)
    incremented, all on the card without a host sync."""
    dev = params[0].device
    if not 1 <= len(params) <= abi.ADAM_MAX_LEAVES:
        raise ValueError(f"adam_update: {len(params)} leaves, the kernel "
                         f"takes 1 to {abi.ADAM_MAX_LEAVES}")
    stream = _stream(dev)
    io = abi.AdamIO(
        count=_ptr(count, I32, dev, (), name="count"),
        ticket=_stream_scratch(dev, "adam_update", stream),
        n_leaves=len(params), neg_lr=-lr)
    for i, (p, g, m, v) in enumerate(zip(params, grads, mu, nu)):
        shape = tuple(p.shape)
        io.leaf[i] = abi.AdamLeaf(
            p=_ptr(p, F32, dev, shape, name=f"param {i}"),
            g=_ptr(g, F32, dev, shape, name=f"grad {i}"),
            mu=_ptr(m, F32, dev, shape, name=f"mu {i}"),
            nu=_ptr(v, F32, dev, shape, name=f"nu {i}"),
            n=p.numel())
    KERNELS["adam_update"].launch(ctypes.addressof(io), stream)
