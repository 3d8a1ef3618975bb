"""Monitor event vocabulary + vectorized decode of the out tensor.

Reference: upstream cilium ``pkg/monitor/api`` message types and the
event structs emitted by ``bpf/lib/{drop,trace,policy_log}.h``:
``DropNotify``, ``TraceNotify``, ``PolicyVerdictNotify``.  Message
type numbers mirror the reference's (drop=1, trace=4, policy-verdict=9)
so exported streams read familiarly.

Vectorized: the device emits one out-tensor row per packet; the host
keeps the whole batch as a struct-of-arrays :class:`EventBatch` (no
per-event objects on the hot path) and materializes typed per-event
dataclasses only at the API/CLI edge.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator, List, Optional, Union

import numpy as np

from ..core.packets import (
    COL_DIR,
    COL_DPORT,
    COL_DST_IP0,
    COL_EP,
    COL_FAMILY,
    COL_FLAGS,
    COL_LEN,
    COL_PROTO,
    COL_SPORT,
    COL_SRC_IP0,
    words_to_ip,
)
from ..datapath.verdict import (
    EV_DROP,
    EV_TRACE,
    EV_VERDICT,
    OUT_CT,
    OUT_EVENT,
    OUT_ID_ROW,
    OUT_PROXY,
    OUT_REASON,
    OUT_VERDICT,
)

# Reference message type numbers (pkg/monitor/api/types.go).
MSG_DROP = 1
MSG_TRACE = 4
MSG_POLICY_VERDICT = 9

_EVENT_TO_MSG = np.zeros(3, dtype=np.uint8)
_EVENT_TO_MSG[EV_TRACE] = MSG_TRACE
_EVENT_TO_MSG[EV_VERDICT] = MSG_POLICY_VERDICT
_EVENT_TO_MSG[EV_DROP] = MSG_DROP

# Drop reason rendering (reference: bpf/lib/drop.h + monitor/api
# DropReason strings).
DROP_REASON_NAMES = {
    1: "Policy denied",
    2: "Policy denied (default deny)",
    3: "Shard queue overflow",
    4: "No endpoint found",  # lxcmap miss (unregistered endpoint id)
    5: "No mapping for NAT masquerade",  # SNAT port pool exhausted
    6: "Bandwidth limit exceeded",  # egress rate limit (EDT)
    7: "No service backend",  # frontend with no backend
    8: "Authentication required",  # mutual auth missing (pkg/auth)
    9: "Ingress queue overflow",  # serving admission shed (XDP ring)
    10: "Dispatch deadline exceeded",  # watchdog deadlined a hung dispatch
    11: "Recovery drop",  # serving recovery accounted a lost batch
    12: "Cluster router overflow",  # cluster forward queue full (router shed)
}


@dataclass
class EventBatch:
    """One device batch of monitor events as struct-of-arrays.

    Columns are aligned with the header tensor rows that produced
    them.  ``identity`` is the remote NUMERIC identity (row already
    mapped via the IdentityRowMap)."""

    msg_type: np.ndarray  # [N] u8 MSG_*
    verdict: np.ndarray  # [N] final VERDICT_* code
    reason: np.ndarray  # [N] drop reason (0 = forwarded)
    ct_state: np.ndarray  # [N] CT_* result
    identity: np.ndarray  # [N] remote numeric identity
    proxy_port: np.ndarray  # [N]
    hdr: np.ndarray  # [N, N_COLS] the originating header rows
    timestamp: float  # host clock at decode

    def __len__(self) -> int:
        return len(self.msg_type)

    def __iter__(self) -> Iterator["MonitorEvent"]:
        for i in range(len(self)):
            yield materialize(self, i)


@dataclass
class MonitorEvent:
    msg_type: int
    timestamp: float
    src_ip: str
    dst_ip: str
    sport: int
    dport: int
    proto: int
    flags: int
    length: int
    endpoint: int
    direction: int  # 0 ingress / 1 egress
    identity: int  # remote numeric identity
    verdict: int
    ct_state: int
    proxy_port: int
    reason: int

    # wire format (little-endian, fixed 44 bytes):
    # type u8, pad u8, ep u16, verdict u8, ct u8, reason u8, dir u8,
    # identity u32, proxy u16, sport u16, dport u16, proto u8, flags u8,
    # len u32, family u8, pad3, src 16B? -> too big; v4-only compact +
    # full ips as 2x16B extension for v6 is overkill here: we carry
    # src/dst as 4-word each (32B) -> total 76 bytes.
    _FMT = "<BBHBBBBIHHHBBIB3s16s16s"

    def pack(self) -> bytes:
        import ipaddress

        src = int(ipaddress.ip_address(self.src_ip))
        dst = int(ipaddress.ip_address(self.dst_ip))
        return struct.pack(
            self._FMT, self.msg_type, 0, self.endpoint & 0xFFFF,
            self.verdict, self.ct_state, self.reason, self.direction,
            self.identity, self.proxy_port, self.sport, self.dport,
            self.proto, self.flags, self.length,
            4 if ":" not in self.src_ip else 6, b"\x00" * 3,
            src.to_bytes(16, "big"), dst.to_bytes(16, "big"))

    @classmethod
    def unpack(cls, data: bytes, timestamp: float = 0.0) -> "MonitorEvent":
        (mt, _, ep, verdict, ct, reason, dirn, ident, proxy, sport,
         dport, proto, flags, length, fam, _pad, src, dst) = struct.unpack(
            cls._FMT, data)
        import ipaddress

        if fam == 4:
            src_ip = str(ipaddress.IPv4Address(src[-4:]))
            dst_ip = str(ipaddress.IPv4Address(dst[-4:]))
        else:
            src_ip = str(ipaddress.IPv6Address(src))
            dst_ip = str(ipaddress.IPv6Address(dst))
        return cls(msg_type=mt, timestamp=timestamp, src_ip=src_ip,
                   dst_ip=dst_ip, sport=sport, dport=dport, proto=proto,
                   flags=flags, length=length, endpoint=ep,
                   direction=dirn, identity=ident, verdict=verdict,
                   ct_state=ct, proxy_port=proxy, reason=reason)

    WIRE_SIZE = struct.calcsize(_FMT)


def materialize(batch: EventBatch, i: int) -> MonitorEvent:
    """One row of the SoA batch -> typed event (API edge only)."""
    r = batch.hdr[i]
    fam = int(r[COL_FAMILY])
    return MonitorEvent(
        msg_type=int(batch.msg_type[i]),
        timestamp=batch.timestamp,
        src_ip=words_to_ip(r[COL_SRC_IP0:COL_SRC_IP0 + 4], fam),
        dst_ip=words_to_ip(r[COL_DST_IP0:COL_DST_IP0 + 4], fam),
        sport=int(r[COL_SPORT]),
        dport=int(r[COL_DPORT]),
        proto=int(r[COL_PROTO]),
        flags=int(r[COL_FLAGS]),
        length=int(r[COL_LEN]),
        endpoint=int(r[COL_EP]),
        direction=int(r[COL_DIR]),
        identity=int(batch.identity[i]),
        verdict=int(batch.verdict[i]),
        ct_state=int(batch.ct_state[i]),
        proxy_port=int(batch.proxy_port[i]),
        reason=int(batch.reason[i]),
    )


# Typed views mirroring the reference's struct names ------------------


@dataclass
class DropNotify:
    """Reference: monitor/api DropNotify (type=1)."""

    event: MonitorEvent

    @property
    def reason_name(self) -> str:
        return DROP_REASON_NAMES.get(self.event.reason,
                                     f"reason {self.event.reason}")


@dataclass
class TraceNotify:
    """Reference: monitor/api TraceNotify (type=4)."""

    event: MonitorEvent


@dataclass
class PolicyVerdictNotify:
    """Reference: monitor/api PolicyVerdictNotify (type=9)."""

    event: MonitorEvent

    @property
    def allowed(self) -> bool:
        return self.event.reason == 0


def decode_out(out: np.ndarray, hdr: np.ndarray,
               row_to_numeric: np.ndarray, timestamp: float,
               valid: Optional[np.ndarray] = None) -> EventBatch:
    """Vectorized out-tensor -> EventBatch (the perf-reader loop).

    ``out`` and ``hdr`` are host numpy copies of the device tensors;
    ``row_to_numeric`` maps identity rows to numeric identities;
    ``valid`` drops padding rows from routed batches."""
    out = np.asarray(out)
    hdr = np.asarray(hdr)
    if valid is not None:
        keep = np.asarray(valid)
        out = out[keep]
        hdr = hdr[keep]
    return EventBatch(
        msg_type=_EVENT_TO_MSG[out[:, OUT_EVENT]],
        verdict=out[:, OUT_VERDICT].astype(np.uint8),
        reason=out[:, OUT_REASON].astype(np.uint8),
        ct_state=out[:, OUT_CT].astype(np.uint8),
        identity=row_to_numeric[out[:, OUT_ID_ROW]].astype(np.uint32),
        proxy_port=out[:, OUT_PROXY].astype(np.uint16),
        hdr=hdr,
        timestamp=timestamp,
    )


def synth_drop_batch(hdr: np.ndarray, reason: int,
                     timestamp: float) -> EventBatch:
    """Host-synthesized DROP events for rows that never reached the
    device — today the serving plane's admission sheds
    (``REASON_INGRESS_OVERFLOW``).  Identity is 0 (unknown): the shed
    happens BEFORE ipcache resolution, exactly like an XDP-ring drop
    fires before any per-packet program runs."""
    hdr = np.asarray(hdr)
    n = len(hdr)
    return EventBatch(
        msg_type=np.full(n, MSG_DROP, dtype=np.uint8),
        verdict=np.zeros(n, dtype=np.uint8),  # 0 = dropped
        reason=np.full(n, reason, dtype=np.uint8),
        ct_state=np.zeros(n, dtype=np.uint8),
        identity=np.zeros(n, dtype=np.uint32),
        proxy_port=np.zeros(n, dtype=np.uint16),
        hdr=hdr,
        timestamp=timestamp,
    )


def decode_ring_rows(rows: np.ndarray, hdr: np.ndarray,
                     row_to_numeric: np.ndarray,
                     timestamp: float,
                     aligned: bool = False) -> EventBatch:
    # thread-affinity: event-worker, cli, offline -- NEVER the drain
    # thread: per-packet decode on the dispatch path is exactly what
    # removed (the static half of the monkeypatch thread proof)
    """Drained ring rows of ONE batch + that batch's retained host
    header tensor -> EventBatch (the serving-path perf-reader: only
    the compacted events crossed the device->host link; the header
    columns rejoin here via the rows' packet index).

    ``rows`` is a ``ring_drain`` slice whose COL_BATCH all match the
    batch ``hdr`` came from.  ``aligned=True`` means the caller
    already gathered ``hdr`` per row (the packed/sharded serving
    windows reconstruct wide columns for just the kept rows)."""
    from .ring import COL_PKT_IDX

    rows = np.asarray(rows)
    hdr = np.asarray(hdr)
    if not aligned:
        hdr = hdr[rows[:, COL_PKT_IDX].astype(np.int64)]
    return EventBatch(
        msg_type=_EVENT_TO_MSG[rows[:, OUT_EVENT]],
        verdict=rows[:, OUT_VERDICT].astype(np.uint8),
        reason=rows[:, OUT_REASON].astype(np.uint8),
        ct_state=rows[:, OUT_CT].astype(np.uint8),
        identity=row_to_numeric[rows[:, OUT_ID_ROW]].astype(np.uint32),
        proxy_port=rows[:, OUT_PROXY].astype(np.uint16),
        hdr=hdr,
        timestamp=timestamp,
    )
