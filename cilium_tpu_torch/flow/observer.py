"""Flow ring buffer + query API (the Hubble observer).

Reference: upstream cilium ``pkg/hubble/observer`` — a fixed-size ring
of the most recent N flows served via the gRPC ``Observer.GetFlows``
API with flow filters.  Vectorized (as in the JAX package's copy): the ring is
struct-of-arrays numpy — one vectorized slice-assign per device batch,
vectorized filter evaluation at query time, Flow objects materialized
only for the rows returned.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

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
    N_COLS,
    ip_to_words,
    words_to_ip,
)
from ..datapath.conntrack import CT_REPLY
from ..monitor.api import EventBatch
from .flow import Flow, FlowEndpoint

IdentityGetter = Callable[[int], Tuple[str, ...]]  # numeric -> labels
EndpointGetter = Callable[[int], Tuple[str, int]]  # ep id -> (pod, id)


@dataclass
class FlowFilter:
    """A subset of flow.proto FlowFilter, vectorized.

    All set conditions AND together (one filter); a request passes a
    list of filters that OR (reference: whitelist semantics)."""

    verdict: Optional[int] = None
    source_ip: Optional[str] = None
    destination_ip: Optional[str] = None
    source_identity: Optional[int] = None
    destination_identity: Optional[int] = None
    # the flow's security identity on WHICHEVER side is remote (the
    # ring stores only the remote numeric identity; the local side
    # is an endpoint, not an identity column).  This is what
    # `--identity` / ?identity= mean: "flows involving identity N" —
    # note that OR-ing source_identity with destination_identity
    # does NOT express this (each wildcards the rows the other
    # constrains, so the union matches everything)
    identity: Optional[int] = None
    port: Optional[int] = None
    protocol: Optional[int] = None
    since: Optional[float] = None
    until: Optional[float] = None
    reply: Optional[bool] = None
    # set by the wire decoder when the filter carried a field this
    # implementation cannot evaluate: such a filter matches NOTHING
    # (conservative for both whitelist and blacklist use)
    unsupported: bool = False

    def mask(self, ring: "Observer", idx: np.ndarray) -> np.ndarray:
        if self.unsupported:
            return np.zeros(len(idx), dtype=bool)
        m = np.ones(len(idx), dtype=bool)
        if self.verdict is not None:
            m &= ring.verdict[idx] == self.verdict
        if self.protocol is not None:
            m &= ring.hdr[idx, COL_PROTO] == self.protocol
        if self.port is not None:
            m &= ((ring.hdr[idx, COL_SPORT] == self.port)
                  | (ring.hdr[idx, COL_DPORT] == self.port))
        if self.source_ip is not None:
            w = ip_to_words(self.source_ip)
            for j in range(4):
                m &= ring.hdr[idx, COL_SRC_IP0 + j] == w[j]
        if self.destination_ip is not None:
            w = ip_to_words(self.destination_ip)
            for j in range(4):
                m &= ring.hdr[idx, COL_DST_IP0 + j] == w[j]
        if self.since is not None:
            m &= ring.time[idx] >= self.since
        if self.until is not None:
            m &= ring.time[idx] <= self.until
        if self.reply is not None:
            m &= (ring.ct_state[idx] == CT_REPLY) == self.reply
        if self.identity is not None:
            m &= ring.identity[idx] == self.identity
        if self.source_identity is not None or \
                self.destination_identity is not None:
            is_reply = ring.ct_state[idx] == CT_REPLY
            ingress = ring.hdr[idx, COL_DIR] == 0
            remote_is_src = ingress ^ is_reply
            # remote identity sits on src side for ingress non-reply
            if self.source_identity is not None:
                m &= np.where(remote_is_src,
                              ring.identity[idx] == self.source_identity,
                              True)
            if self.destination_identity is not None:
                m &= np.where(~remote_is_src,
                              ring.identity[idx]
                              == self.destination_identity, True)
        return m


class Observer:
    """Fixed-capacity SoA flow ring (power-of-two capacity).

    Thread-safety contract (audited for the async event plane):
    under live serving ``consume`` runs on the EVENT-JOIN WORKER
    (monitor fan-out), ``append_l7`` on proxy threads, and
    ``get_flows`` on API handler threads — concurrently.  Every ring
    mutation (the vectorized slice-assign + the ``seq`` bump) and
    every read (the oldest-pointer computation, filter masks, and
    row materialization) happens under ``_lock``, so a query
    observes either ALL of a batch's rows or none of them: no torn
    rows (a row whose columns mix two different flows), and ``seq``
    is monotonic across queries.  The seq bump deliberately happens
    LAST inside the locked block, after every column landed.
    ``tests/test_flow_analytics.py`` pins this with a concurrent
    query-during-live-consume test."""

    def __init__(self, capacity: int = 4096,
                 identity_getter: Optional[IdentityGetter] = None,
                 endpoint_getter: Optional[EndpointGetter] = None):
        assert capacity & (capacity - 1) == 0
        self.capacity = capacity
        self.time = np.zeros(capacity, dtype=np.float64)
        self.verdict = np.zeros(capacity, dtype=np.uint8)
        self.reason = np.zeros(capacity, dtype=np.uint8)
        self.ct_state = np.zeros(capacity, dtype=np.uint8)
        self.msg_type = np.zeros(capacity, dtype=np.uint8)
        self.identity = np.zeros(capacity, dtype=np.uint32)
        self.proxy = np.zeros(capacity, dtype=np.uint16)
        self.hdr = np.zeros((capacity, N_COLS), dtype=np.uint32)
        self.flow_seq = np.zeros(capacity, dtype=np.int64)
        # L7 payloads (seven-parser flows); None for L3/L4 rows
        self.l7 = np.empty(capacity, dtype=object)
        self.seq = 0  # total flows ever written
        self.identity_getter = identity_getter or (lambda n: ())
        self.endpoint_getter = endpoint_getter or (lambda e: ("", e))
        self._lock = threading.Lock()
        # guarded-by: _lock: time, verdict, reason, ct_state, msg_type,
        # guarded-by: _lock: identity, proxy, hdr, flow_seq, l7, seq

    def __len__(self) -> int:
        # holds: _lock -- get_flows reads it inside its locked region;
        # external callers use the locked server_status()
        return min(self.seq, self.capacity)

    def server_status(self) -> dict:
        # thread-affinity: any
        """Locked num/seen/max counts (hubble ServerStatus shape).
        The gRPC server and relay prefer this over their fallback
        ``len(obs)``/``obs.seq`` reads, which raced a live consume."""
        with self._lock:
            return {"num_flows": len(self), "seen_flows": self.seq,
                    "max_flows": self.capacity}

    def consume(self, batch: EventBatch) -> None:
        # thread-affinity: any -- publish() fans out on whichever
        # thread published (event-join worker for ring joins, drain
        # thread for host-synthesized shed/recovery drops)
        """Vectorized ring append (a MonitorAgent consumer)."""
        n = len(batch)
        if n == 0:
            return
        with self._lock:
            if n >= self.capacity:  # keep the newest capacity rows
                sl = slice(n - self.capacity, n)
                # land each kept row where a sequential append of all n
                # rows would have put it, so get_flows' oldest-pointer
                # ((seq + n) % capacity) stays meaningful for any n
                pos = (self.seq + n - self.capacity
                       + np.arange(self.capacity)) % self.capacity
            else:
                start = self.seq % self.capacity
                pos = (start + np.arange(n)) % self.capacity
                sl = slice(0, n)
            self.time[pos] = batch.timestamp
            self.verdict[pos] = batch.verdict[sl]
            self.reason[pos] = batch.reason[sl]
            self.ct_state[pos] = batch.ct_state[sl]
            self.msg_type[pos] = batch.msg_type[sl]
            self.identity[pos] = batch.identity[sl]
            self.proxy[pos] = batch.proxy_port[sl]
            self.hdr[pos] = batch.hdr[sl]
            self.flow_seq[pos] = self.seq + np.arange(n)[sl]
            self.l7[pos] = None
            self.seq += n

    def append_l7(self, hdr_row: np.ndarray, l7: dict, verdict: int,
                  identity: int, timestamp: float) -> None:
        # thread-affinity: any
        """One seven-parser flow (proxy access record) into the ring."""
        from ..flow.seven import MSG_L7

        with self._lock:
            pos = self.seq % self.capacity
            self.time[pos] = timestamp
            self.verdict[pos] = verdict
            self.reason[pos] = 0
            self.ct_state[pos] = 0
            self.msg_type[pos] = MSG_L7
            self.identity[pos] = identity
            self.proxy[pos] = 0
            self.hdr[pos] = hdr_row
            self.flow_seq[pos] = self.seq
            self.l7[pos] = l7
            self.seq += 1

    def get_flows(self, filters: Sequence[FlowFilter] = (),
                  number: int = 100, oldest_first: bool = False,
                  blacklist: Sequence[FlowFilter] = ()
                  ) -> List[Flow]:
        # thread-affinity: api, cli, capture, offline
        """The Observer.GetFlows equivalent: ``filters`` (whitelist)
        OR together; ``blacklist`` filters then EXCLUDE (reference:
        GetFlowsRequest whitelist/blacklist semantics)."""
        with self._lock:
            n = len(self)
            if n == 0:
                return []
            # oldest -> newest ring order
            if self.seq <= self.capacity:
                idx = np.arange(n)
            else:
                start = self.seq % self.capacity
                idx = (start + np.arange(self.capacity)) % self.capacity
            if filters:
                keep = np.zeros(len(idx), dtype=bool)
                for f in filters:
                    keep |= f.mask(self, idx)
                idx = idx[keep]
            for f in blacklist:
                idx = idx[~f.mask(self, idx)]
            if not oldest_first:
                idx = idx[::-1]
            idx = idx[:number]
            return [self._materialize(i) for i in idx]

    def flows_since(self, cursor: int, limit: int = 512
                    ) -> Tuple[List[Flow], int]:
        # thread-affinity: api, cli, capture, offline
        """The since-cursor ring TAIL (the cluster relay's): every
        flow whose ``flow_seq`` is >= ``cursor``, oldest first,
        newest ``limit`` kept when the tail outgrew it, plus the new
        cursor (``seq`` high-water — pass it back next time).  Flows
        that lapped out of the ring between scrapes are simply gone
        (the ring's standing newest-wins contract); the cursor jump
        makes the gap visible to the caller."""
        with self._lock:
            new_cursor = self.seq
            n = len(self)
            if n == 0 or cursor >= new_cursor:
                return [], new_cursor
            if self.seq <= self.capacity:
                idx = np.arange(n)
            else:
                start = self.seq % self.capacity
                idx = (start + np.arange(self.capacity)) \
                    % self.capacity
            keep = self.flow_seq[idx] >= cursor
            idx = idx[keep]
            if limit and len(idx) > limit:
                idx = idx[-limit:]  # the newest `limit`, time order
            return [self._materialize(i) for i in idx], new_cursor

    def _materialize(self, i: int) -> Flow:
        # holds: _lock -- called from get_flows' locked region only
        f = materialize_flow(
            self.hdr[i], float(self.time[i]), int(self.flow_seq[i]),
            int(self.verdict[i]), int(self.reason[i]),
            int(self.ct_state[i]), int(self.msg_type[i]),
            int(self.identity[i]), self.identity_getter,
            self.endpoint_getter, proxy_port=int(self.proxy[i]))
        if self.l7[i] is not None:
            f.l7 = self.l7[i]
        return f


def materialize_flow(r: np.ndarray, time: float, seq: int, verdict: int,
                     reason: int, ct_state: int, msg_type: int,
                     remote_ident: int, identity_getter: IdentityGetter,
                     endpoint_getter: EndpointGetter,
                     proxy_port: int = 0) -> Flow:
    """One header row + event fields -> enriched Flow (shared by the
    observer ring and the exporter's direct batch path)."""
    fam = int(r[COL_FAMILY])
    src_ip = words_to_ip(r[COL_SRC_IP0:COL_SRC_IP0 + 4], fam)
    dst_ip = words_to_ip(r[COL_DST_IP0:COL_DST_IP0 + 4], fam)
    is_reply = ct_state == CT_REPLY
    ingress = int(r[COL_DIR]) == 0
    pod, epid = endpoint_getter(int(r[COL_EP]))
    # the LOCAL endpoint sits on dst side for ingress, src for egress
    # (reference: threefour parser's endpoint resolution)
    src = FlowEndpoint(ip=src_ip, port=int(r[COL_SPORT]))
    dst = FlowEndpoint(ip=dst_ip, port=int(r[COL_DPORT]))
    local, remote = (dst, src) if ingress else (src, dst)
    remote.identity = remote_ident
    remote.labels = tuple(identity_getter(remote_ident))
    local.pod_name = pod
    local.endpoint_id = epid
    return Flow(
        time=time,
        uuid=seq,
        verdict=verdict,
        drop_reason=reason,
        event_type=msg_type,
        is_reply=is_reply,
        traffic_direction=int(r[COL_DIR]),
        proto=int(r[COL_PROTO]),
        flags=int(r[COL_FLAGS]),
        length=int(r[COL_LEN]),
        source=src,
        destination=dst,
        proxy_port=proxy_port,
    )
