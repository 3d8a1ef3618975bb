"""threefour parser: monitor events -> flow records.

Reference: upstream cilium ``pkg/hubble/parser/threefour/parser.go`` —
``Parser.Decode`` turns a raw monitor payload (DropNotify/TraceNotify/
PolicyVerdictNotify) into a ``flow.Flow``, enriching with the ipcache/
identity/endpoint getters.  Batches stay vectorized; this
parser is the thin adapter wiring a MonitorAgent to an Observer, plus
a single-event decode path for wire-format payloads (golden tests,
CLI replay).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..monitor.api import EventBatch, MonitorEvent
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
    N_COLS,
    ip_to_words,
)
from .flow import Flow, FlowEndpoint
from .observer import Observer


class ThreeFourParser:
    """Feeds an Observer from a MonitorAgent (batch path) and decodes
    single wire events (compat path)."""

    def __init__(self, observer: Observer):
        self.observer = observer
        self.decoded = 0
        self.errors = 0

    # -- batch path (the hot loop) ----------------------------------
    def consume(self, batch: EventBatch) -> None:
        self.observer.consume(batch)
        self.decoded += len(batch)

    # -- single-event path (wire payloads) --------------------------
    def decode(self, payload: bytes, timestamp: float = 0.0) -> Flow:
        """Wire-format monitor payload -> Flow (pkg/hubble Decode)."""
        if len(payload) != MonitorEvent.WIRE_SIZE:
            self.errors += 1
            raise ValueError(
                f"bad monitor payload size {len(payload)}, "
                f"want {MonitorEvent.WIRE_SIZE}")
        ev = MonitorEvent.unpack(payload, timestamp)
        batch = self._event_to_batch(ev)
        self.observer.consume(batch)
        self.decoded += 1
        return self.observer.get_flows(number=1)[0]

    @staticmethod
    def _event_to_batch(ev: MonitorEvent) -> EventBatch:
        hdr = np.zeros((1, N_COLS), dtype=np.uint32)
        hdr[0, COL_SRC_IP0:COL_SRC_IP0 + 4] = ip_to_words(ev.src_ip)
        hdr[0, COL_DST_IP0:COL_DST_IP0 + 4] = ip_to_words(ev.dst_ip)
        hdr[0, COL_SPORT] = ev.sport
        hdr[0, COL_DPORT] = ev.dport
        hdr[0, COL_PROTO] = ev.proto
        hdr[0, COL_FLAGS] = ev.flags
        hdr[0, COL_LEN] = ev.length
        hdr[0, COL_FAMILY] = 6 if ":" in ev.src_ip else 4
        hdr[0, COL_EP] = ev.endpoint
        hdr[0, COL_DIR] = ev.direction
        return EventBatch(
            msg_type=np.array([ev.msg_type], dtype=np.uint8),
            verdict=np.array([ev.verdict], dtype=np.uint8),
            reason=np.array([ev.reason], dtype=np.uint8),
            ct_state=np.array([ev.ct_state], dtype=np.uint8),
            identity=np.array([ev.identity], dtype=np.uint32),
            proxy_port=np.array([ev.proxy_port], dtype=np.uint16),
            hdr=hdr,
            timestamp=ev.timestamp,
        )
