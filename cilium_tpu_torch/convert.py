"""Carry datapath state across from the JAX package, and back.

The state travels as numpy arrays in nested dicts whose keys are the
dataclass field names both packages share::

    {"policy":  {"proto_table", "port_class", "class_map", "verdict",
                 "ep_policy", "auth"},
     "ipcache": {"l1", "l2", "l3", "v6_net", "v6_mask", "v6_value",
                 "v6_plen", "default"},
     "ct":      {"table", "fp", "dropped"},
     "metrics": array}

The egress stages' state travels the same way: a ``NATTable``'s
``table``/``failed`` and a ``BandwidthState``'s ``tokens``/``last``
(``nat_*`` and ``bandwidth_*`` below); a ``NATTensors``' arrays come
across by ``NATTensors.from_numpy``.  So does the service LB's: a
compiled ``LBTensors``/``LBTensors6`` as a dict of its leaves by field
name plus ``m``, and a ``SockLBTable``'s ``table``/``fp``/``aff``
(``lb_*`` and ``socklb_*`` below).  The anomaly model travels as a
flat dict of float32 arrays by its field names (``embed``, ``w1`` ...
``nov_thresh``), the reference's ``AnomalyModel`` leaves and checkpoint
keys (``anomaly_model_*`` below); an ``optax.adam`` state (its
``ScaleByAdamState``) as ``{"count": int, "mu": {field: array}, "nu":
{field: array}}`` over the same fields (``adam_state_*`` below).

Each array keeps the JAX package's dtype (int32 or uint32); here every
word lands in an int32 tensor as its bit pattern.  A caller holding a
JAX state flattens it with ``np.asarray`` per leaf; this module never
sees a JAX object.
"""

from __future__ import annotations

import ipaddress
from typing import Dict, Iterable, Tuple

import numpy as np

from .datapath.conntrack import CTTable
from .datapath.lpm import DeviceLPM, LPMTensors
from .datapath.verdict import DatapathState, DevicePolicy
from .device import resolve_device
from .datapath.bandwidth import BandwidthState
from .ml.model import _FIELDS as _ANOMALY_FIELDS, TRAINABLE, AnomalyModel
from .ml.train import AdamState
from .monitor.ring import EventRing
from .service import LBTensors, LBTensors6
from .service.nat import NATTable
from .service.socklb import SockLBTable
from .u32 import from_numpy, to_numpy

# the JAX package's dtype of every leaf (the rest are int32)
_U32 = {("policy", "auth"), ("ipcache", "v6_net"), ("ipcache", "v6_mask"),
        ("ct", "table"), ("ct", "fp"), ("ct", "dropped"), ("metrics",)}
_GROUPS = {"policy": DevicePolicy, "ipcache": DeviceLPM, "ct": CTTable}


# fields made here, not carried: the claim words, the LPM's v6 index
_MADE_HERE = ("claim", "v6_groups", "v6_index")


def _field_names(cls) -> Tuple[str, ...]:
    return tuple(n for n in cls.__dataclass_fields__ if n not in _MADE_HERE)


def _group_from_numpy(group: str, arrays: Dict, device) -> object:
    if group == "ipcache":  # the v6 index is built from the leaves
        return DeviceLPM.from_tensors(LPMTensors(**{
            name: arrays[name] for name in _field_names(DeviceLPM)}), device)
    cls = _GROUPS[group]
    return cls(**{name: (int(arrays[name]) if name == "default"
                         else from_numpy(arrays[name], device))
                  for name in _field_names(cls)})


def datapath_state_from_numpy(arrays: Dict, device=None) -> DatapathState:
    """Nested dict of numpy arrays (layout in the module doc) -> a
    :class:`DatapathState` on ``device`` (None: the card)."""
    device = resolve_device(device)
    parts = {g: _group_from_numpy(g, arrays[g], device) for g in _GROUPS}
    return DatapathState(metrics=from_numpy(arrays["metrics"], device),
                         **parts)


def ipcache_from_numpy(arrays: Dict, device=None) -> DeviceLPM:
    """The ``"ipcache"`` group alone -> a :class:`DeviceLPM` (to look
    addresses up in a JAX loader's LPM after churn)."""
    return _group_from_numpy("ipcache", arrays, resolve_device(device))


def lpm_probe_ips(cidrs: Iterable[str]) -> np.ndarray:
    """u32 IPv4 addresses that tell two LPM tables apart by lookups:
    for every v4 prefix, its first, middle and last address and the
    neighbours just outside it, plus 0 and 255.255.255.255.  Two tables
    built differently (``lpm_upsert`` places blocks where a fresh
    ``compile_lpm`` would not) agree on these iff they agree on the
    prefixes they were programmed with."""
    out = [0, 0xFFFFFFFF]
    for cidr in cidrs:
        net = ipaddress.ip_network(cidr, strict=False)
        if net.version != 4:
            continue
        lo = int(net.network_address)
        hi = lo + net.num_addresses - 1
        out += [lo, hi, (lo + hi) // 2, max(lo - 1, 0),
                min(hi + 1, 0xFFFFFFFF)]
    return np.unique(np.asarray(out, dtype=np.uint32))


def datapath_state_to_numpy(state: DatapathState) -> Dict:
    """The inverse of :func:`datapath_state_from_numpy`, with the JAX
    package's dtypes (for comparisons against its state)."""
    def leaf(key, t):
        a = to_numpy(t)
        return a if key in _U32 else a.view(np.int32)

    out: Dict = {}
    for group, cls in _GROUPS.items():
        obj = getattr(state, group)
        out[group] = {
            name: (obj.default if name == "default"
                   else leaf((group, name), getattr(obj, name)))
            for name in _field_names(cls)}
    out["metrics"] = leaf(("metrics",), state.metrics)
    return out


def event_ring_from_numpy(buf: np.ndarray, cursor: np.ndarray,
                          device=None) -> EventRing:
    """JAX ``EventRing`` leaves (u32 ``buf`` [cap, 2], ``cursor`` [2])
    -> an :class:`EventRing` on ``device`` (None: the card)."""
    device = resolve_device(device)
    return EventRing(buf=from_numpy(buf, device),
                     cursor=from_numpy(cursor, device))


def event_ring_to_numpy(ring: EventRing) -> Tuple[np.ndarray, np.ndarray]:
    """-> (buf [cap, 2] u32, cursor [2] u32)."""
    return to_numpy(ring.buf), to_numpy(ring.cursor)



def nat_table_from_numpy(table: np.ndarray, failed, device=None) -> NATTable:
    """JAX ``NATTable`` leaves (u32 ``table`` [P, 6], ``failed``) -> a
    :class:`NATTable` on ``device`` (None: the card)."""
    device = resolve_device(device)
    return NATTable(table=from_numpy(table, device),
                    failed=from_numpy(np.uint32(failed), device).reshape(()))


def nat_table_to_numpy(tbl: NATTable) -> Tuple[np.ndarray, int]:
    """-> (table [P, 6] u32, failed)."""
    return to_numpy(tbl.table), int(to_numpy(tbl.failed))


def bandwidth_state_from_numpy(tokens: np.ndarray, last,
                               device=None) -> BandwidthState:
    """JAX ``BandwidthState`` leaves (u32 ``tokens`` [MAX_ENDPOINTS],
    ``last``) -> a :class:`BandwidthState` on ``device``."""
    device = resolve_device(device)
    return BandwidthState(tokens=from_numpy(tokens, device),
                          last=from_numpy(np.uint32(last), device).reshape(()))


def bandwidth_state_to_numpy(state: BandwidthState
                             ) -> Tuple[np.ndarray, int]:
    """-> (tokens [MAX_ENDPOINTS] u32, last)."""
    return to_numpy(state.tokens), int(to_numpy(state.last))


_LB_FIELDS = ("svc_ip", "svc_port", "svc_proto", "maglev", "backend_ip",
              "backend_port")


def lb_tensors_from_numpy(arrays: Dict, device=None) -> LBTensors:
    """A JAX ``LBTensors``' leaves by field name, with ``m`` -> an
    :class:`LBTensors` on ``device`` (None: the card)."""
    return LBTensors.from_numpy(
        *(arrays[k] for k in _LB_FIELDS + ("svc_aff",)), m=arrays["m"],
        device=device)


def lb6_tensors_from_numpy(arrays: Dict, device=None) -> LBTensors6:
    """The same for a JAX ``LBTensors6``."""
    return LBTensors6.from_numpy(*(arrays[k] for k in _LB_FIELDS),
                                 m=arrays["m"], device=device)


def socklb_table_from_numpy(table: np.ndarray, fp: np.ndarray,
                            aff: np.ndarray, device=None) -> SockLBTable:
    """JAX ``SockLBTable`` leaves (u32 ``table`` [P, 8], ``fp`` [P],
    ``aff`` [A, 8]) -> a :class:`SockLBTable` on ``device``."""
    device = resolve_device(device)
    return SockLBTable(table=from_numpy(table, device),
                       fp=from_numpy(fp, device), aff=from_numpy(aff, device))


def socklb_table_to_numpy(tbl: SockLBTable
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (table [P, 8], fp [P], aff [A, 8]), u32."""
    return to_numpy(tbl.table), to_numpy(tbl.fp), to_numpy(tbl.aff)


def anomaly_model_from_numpy(arrays: Dict, device=None) -> AnomalyModel:
    """A JAX ``AnomalyModel``'s leaves (or a checkpoint's arrays) by
    field name -> an :class:`AnomalyModel` of float32 buffers on
    ``device`` (None: the card)."""
    import torch

    device = resolve_device(device)
    return AnomalyModel(**{
        k: torch.from_numpy(np.array(arrays[k], dtype=np.float32)).to(device)
        for k in _ANOMALY_FIELDS})


def anomaly_model_to_numpy(model: AnomalyModel) -> Dict[str, np.ndarray]:
    """-> {field: float32 array}, the reference's leaves and shapes."""
    return {k: getattr(model, k).detach().to("cpu").numpy().copy()
            for k in _ANOMALY_FIELDS}


def adam_state_from_numpy(arrays: Dict, device=None) -> AdamState:
    """An ``optax.adam`` state's ``count`` and per-field ``mu``/``nu``
    (the reference's ``ScaleByAdamState`` leaves) -> an
    :class:`AdamState` on ``device`` (None: the card).  The novelty
    fields' moments, zero in any state the reference trains (their
    gradients are zero), are not carried."""
    import torch

    device = resolve_device(device)

    def moments(group):
        return {k: torch.from_numpy(np.array(arrays[group][k],
                                             dtype=np.float32)).to(device)
                for k in TRAINABLE}

    return AdamState(
        count=torch.tensor(int(np.asarray(arrays["count"])),
                           dtype=torch.int32, device=device),
        mu=moments("mu"), nu=moments("nu"))


def adam_state_to_numpy(state: AdamState, model: AnomalyModel) -> Dict:
    """-> {"count": int32 array, "mu": {field: float32 array}, "nu":
    ...} over every field of ``model`` (the novelty fields' moments
    zero), the leaves of the reference's ``ScaleByAdamState``."""
    def moments(got):
        out = {}
        for k in _ANOMALY_FIELDS:
            t = got.get(k)
            out[k] = (t.detach().to("cpu").numpy().copy() if t is not None
                      else np.zeros(tuple(getattr(model, k).shape),
                                    np.float32))
        return out

    return {"count": np.asarray(int(state.count.item()), dtype=np.int32),
            "mu": moments(state.mu), "nu": moments(state.nu)}
