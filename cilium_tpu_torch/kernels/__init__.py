"""The hand-written CUDA kernels of the serving path and the L7 proxy:
their registry, launch counts and launchers.

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

from . import abi

MASK = 0xFFFFFFFF
MAX_RING_BATCH = 1 << 19  # pkt_idx packs into 19 bits
MAX_PROXY_PORTS = 15


@dataclass
class Kernel:
    """One kernel of the serving path and the count of its launches."""

    name: str
    source: str  # csrc/<source>.cu
    symbol: str  # its C entry point
    replaces: str  # the JAX device program it replaces (file:line)
    launches: int = 0

    def launch(self, *args) -> None:
        lib = _library(self.source)
        err = getattr(lib, self.symbol)(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: CUDA error {err} "
                f"({lib.cuda_error_name(err).decode()})")
        self.launches += 1


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
)}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


_READY: set = set()
_READY_LOCK = threading.Lock()


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


def lpm_view(t, device) -> abi.LpmView:
    k = t.v6_net.shape[0]
    return abi.LpmView(
        l1=_ptr(t.l1, I32, device, (1 << 16,), name="l1"),
        l2=_ptr(t.l2, I32, device, (t.l2.shape[0], 256), name="l2"),
        l3=_ptr(t.l3, I32, device, (t.l3.shape[0], 256), name="l3"),
        v6_net=_ptr(t.v6_net, I32, device, (k, 4), name="v6_net"),
        v6_mask=_ptr(t.v6_mask, I32, device, (k, 4), name="v6_mask"),
        v6_value=_ptr(t.v6_value, I32, device, (k,), name="v6_value"),
        v6_plen=_ptr(t.v6_plen, I32, device, (k,), name="v6_plen"),
        n_l2=t.l2.shape[0], n_l3=t.l3.shape[0], n_v6=k, dflt=t.default)


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


def launch_ct_update(ct, l4, fwd, result, slot, is_reply, do_create,
                     proxy_port, now: int, valid=None):
    """K4: the ``ct_update`` launch sequence; updates ``ct`` in place."""
    dev, n = fwd.device, fwd.shape[0]
    c = ct.table.shape[0]

    def scratch(*shape, dtype=I32):
        return torch.empty(shape, dtype=dtype, device=dev)

    if ct.claim is None:  # the insert rounds' claim words, -1 between calls
        ct.claim = torch.full((2, c), -1, dtype=I32, device=dev)
    s = dict(new_state=scratch(n), hash=scratch(n), key_fp=scratch(n),
             cand=scratch(n, 4), try_slot=scratch(n), plist=scratch(n),
             npend=scratch(1), pending=scratch(n, dtype=torch.uint8))
    io = abi.CtUpdateIO(
        l4=_ptr(l4, I32, dev, (n, 3), name="l4"),
        fwd=_ptr(fwd, I32, dev, (n, 10), name="fwd"),
        result=_ptr(result, I32, dev, (n,), name="result"),
        slot=_ptr(slot, I32, dev, (n,), name="slot"),
        is_reply=_ptr(is_reply, BOOL, dev, (n,), name="is_reply"),
        do_create=_ptr(do_create, BOOL, dev, (n,), name="do_create"),
        proxy_port=_ptr(proxy_port, I32, dev, (n,), name="proxy_port"),
        valid=_ptr(valid, BOOL, dev, (n,), name="valid"),
        n=n, now=int(now) & MASK,
        claim=_ptr(ct.claim, I32, dev, (2, c), name="ct.claim"),
        **{k: v.data_ptr() for k, v in s.items()})
    view = ct_view(ct, dev)
    KERNELS["ct_update"].launch(ctypes.addressof(view),
                                ctypes.addressof(io), _stream(dev))
    return ct


def launch_datapath(state, rows: torch.Tensor, now: int, ep, dirn, valid,
                    pre_drop, pre_drop_reason, lb_drop, audit):
    """K1: the verdict stage over packed [N, 4] rows (``ep`` given) or
    wide [N, 16] rows.  Returns (out, CTUpdateInput) and adds the
    batch's metrics to ``state.metrics``."""
    from ..datapath.verdict import CTUpdateInput

    packed = ep is not None
    dev, n = rows.device, rows.shape[0]

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
        audit=int(bool(audit)))
    pol = policy_view(state.policy, dev)
    lpm = lpm_view(state.ipcache, dev)
    ct = ct_view(state.ct, dev)
    kernel = KERNELS["datapath_packed" if packed else "datapath_wide"]
    kernel.launch(ctypes.addressof(io), ctypes.addressof(pol),
                  ctypes.addressof(lpm), ctypes.addressof(ct),
                  int(packed), _stream(dev))
    return out, ctin


def launch_ring_append(ring, out: torch.Tensor, batch_id: int,
                       trace_sample: int, valid, proxy_ports):
    """K5: compact one batch's events into ``ring`` in place."""
    dev, n = out.device, out.shape[0]
    if n > MAX_RING_BATCH:
        raise ValueError(f"ring_append: {n} rows, pkt_idx packs 19 bits")
    n_proxy = 0 if proxy_ports is None else proxy_ports.shape[0]
    if n_proxy > MAX_PROXY_PORTS:
        raise ValueError("listener index packs into 4 bits")
    cap = ring.buf.shape[0]
    if cap & (cap - 1):
        raise ValueError(f"ring capacity must be 2^k, got {cap}")
    n_blocks = (n + 1023) // 1024
    block_counts = torch.empty(max(n_blocks, 1), dtype=I32, device=dev)
    meta = torch.empty(2, dtype=I32, device=dev)
    io = abi.RingIO(
        out=_ptr(out, I32, dev, (n, 6), name="out"),
        valid=_ptr(valid, BOOL, dev, (n,), name="valid"),
        proxy_ports=(_ptr(proxy_ports, I32, dev, (n_proxy,),
                          name="proxy_ports") if n_proxy else None),
        buf=_ptr(ring.buf, I32, dev, (cap, 2), name="ring.buf"),
        cursor=_ptr(ring.cursor, I32, dev, (2,), name="ring.cursor"),
        block_counts=block_counts.data_ptr(), meta=meta.data_ptr(),
        n=n, n_proxy=n_proxy, capacity=cap,
        trace_sample=int(trace_sample) & MASK,
        batch_id=int(batch_id) & MASK)
    KERNELS["ring_append"].launch(ctypes.addressof(io), _stream(dev))
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
    """K7: the CT aging sweep, in place; returns the eviction count as a
    [1] u32 tensor on the card (no host sync)."""
    dev = ct.table.device
    count = torch.empty(1, dtype=I32, device=dev)
    view = ct_view(ct, dev)
    KERNELS["ct_gc"].launch(ctypes.addressof(view), int(now) & MASK,
                            count.data_ptr(), _stream(dev))
    return count


def launch_ct_occupied(fp: torch.Tensor) -> torch.Tensor:
    """K8: occupied CT slots (fingerprint not 0) as a [1] u32 tensor."""
    dev, c = fp.device, fp.shape[0]
    count = torch.empty(1, dtype=I32, device=dev)
    KERNELS["ct_occupied"].launch(_ptr(fp, I32, dev, (c,), name="ct.fp"), c,
                                  count.data_ptr(), _stream(dev))
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
    KERNELS["l7_verdict"].launch(ctypes.addressof(io), _stream(dev))
    return out
