"""Recorder: capture matching traffic to pcap.

Reference: upstream ``pkg/hubble/recorder`` (cilium 1.10+) — operators
start a recording with filters; matching packets stream into a pcap
file.  The monitor's EventBatches already carry the header
rows; a recording is a FlowFilter-gated sink that re-renders matched
rows as pcap records (core.pcap.write_pcap's wire format).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.packets import HeaderBatch
from ..monitor.api import EventBatch
from .observer import FlowFilter


@dataclass
class Recording:
    recording_id: int
    path: str
    filters: Sequence[FlowFilter]
    max_packets: int
    captured: int = 0
    started: float = field(default_factory=time.time)
    stopped: Optional[float] = None
    rows: List[np.ndarray] = field(default_factory=list)

    @property
    def active(self) -> bool:
        return self.stopped is None

    def to_dict(self) -> dict:
        return {"id": self.recording_id, "path": self.path,
                "captured": self.captured, "active": self.active,
                "max-packets": self.max_packets}


class Recorder:
    """A MonitorAgent consumer gating batches through recordings."""

    def __init__(self):
        self._lock = threading.Lock()
        self._recordings: Dict[int, Recording] = {}
        self._next = 1

    def start(self, path: str, filters: Sequence[FlowFilter] = (),
              max_packets: int = 65536) -> Recording:
        with self._lock:
            rec = Recording(self._next, path, tuple(filters),
                            max_packets)
            self._recordings[self._next] = rec
            self._next += 1
            return rec

    def stop(self, recording_id: int) -> Optional[Recording]:
        """Finalize: write the pcap and return the recording."""
        from ..core.pcap import write_pcap

        with self._lock:
            rec = self._recordings.get(recording_id)
            if rec is None or not rec.active:
                return rec
            rec.stopped = time.time()
            rows = list(rec.rows)
        hdr = (np.stack(rows) if rows
               else np.zeros((0, 16), dtype=np.uint32))
        write_pcap(rec.path, HeaderBatch(hdr))
        return rec

    def list(self) -> List[dict]:
        with self._lock:
            return [r.to_dict() for r in self._recordings.values()]

    def consume(self, batch: EventBatch) -> None:
        if len(batch) == 0:
            return
        with self._lock:
            active = [r for r in self._recordings.values() if r.active]
        if not active:
            return
        for rec in active:
            if rec.filters:
                # whitelist semantics: a packet matching ANY filter is
                # captured (the observer's get_flows contract)
                keep = np.zeros(len(batch), dtype=bool)
                for f in rec.filters:
                    keep |= _mask_batch(f, batch)
            else:
                keep = np.ones(len(batch), dtype=bool)
            idx = np.nonzero(keep)[0]
            with self._lock:
                room = rec.max_packets - rec.captured
                for i in idx[:room]:
                    rec.rows.append(batch.hdr[i].copy())
                rec.captured += min(len(idx), room)


def _mask_batch(f: FlowFilter, batch: EventBatch) -> np.ndarray:
    """FlowFilter over an EventBatch — EVERY FlowFilter field applies
    (the observer ring implements the same contract over its SoA
    arrays; an ignored field would silently widen a capture)."""
    import ipaddress

    from ..core.packets import (COL_DPORT, COL_DST_IP3, COL_PROTO,
                                COL_SPORT, COL_SRC_IP3)
    from ..datapath.conntrack import CT_REPLY

    m = np.ones(len(batch), dtype=bool)
    hdr = batch.hdr
    if f.verdict is not None:
        m &= batch.verdict == f.verdict
    if f.protocol is not None:
        m &= hdr[:, COL_PROTO] == f.protocol
    if f.port is not None:
        m &= ((hdr[:, COL_DPORT] == f.port)
              | (hdr[:, COL_SPORT] == f.port))
    if f.source_ip:
        m &= hdr[:, COL_SRC_IP3] == int(
            ipaddress.IPv4Address(f.source_ip))
    if f.destination_ip:
        m &= hdr[:, COL_DST_IP3] == int(
            ipaddress.IPv4Address(f.destination_ip))
    if f.source_identity is not None or f.destination_identity \
            is not None:
        # identical side-mapping to FlowFilter.mask: the one identity
        # column holds the REMOTE peer, which sits on the src side for
        # ingress non-reply rows (and flips with reply direction)
        from ..core.packets import COL_DIR

        is_reply = batch.ct_state == CT_REPLY
        ingress = hdr[:, COL_DIR] == 0
        remote_is_src = ingress ^ is_reply
        if f.source_identity is not None:
            m &= np.where(remote_is_src,
                          batch.identity == f.source_identity, True)
        if f.destination_identity is not None:
            m &= np.where(~remote_is_src,
                          batch.identity == f.destination_identity,
                          True)
    if f.reply is not None:
        m &= (batch.ct_state == CT_REPLY) == f.reply
    if f.since is not None:
        m &= np.full(len(batch), batch.timestamp >= f.since)
    if f.until is not None:
        m &= np.full(len(batch), batch.timestamp <= f.until)
    return m
