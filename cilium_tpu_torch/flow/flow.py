"""The Flow record — the output schema kept from the reference (a copy
of the JAX package's ``flow/flow.py``).

Reference: upstream cilium ``api/v1/flow/flow.proto`` (``Flow``
message).  Field names in :meth:`Flow.to_dict` mirror the proto's JSON
rendering (camelCase keys as produced by hubble's JSON exporter) so
downstream consumers of hubble JSON can switch over unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..policy.mapstate import (
    VERDICT_ALLOW,
    VERDICT_DEFAULT_DENY,
    VERDICT_DENY,
    VERDICT_REDIRECT,
)

# flow.proto Verdict enum names
VERDICT_NAMES = {
    VERDICT_ALLOW: "FORWARDED",
    VERDICT_REDIRECT: "REDIRECTED",
    VERDICT_DENY: "DROPPED",
    VERDICT_DEFAULT_DENY: "DROPPED",
}

PROTO_NAMES = {6: "TCP", 17: "UDP", 1: "ICMPv4", 58: "ICMPv6",
               132: "SCTP"}

EVENT_TYPE_NAMES = {1: "DropNotify", 4: "TraceNotify",
                    9: "PolicyVerdictNotify", 129: "L7"}

# flow.proto DropReason enum-style names (hubble JSON renders strings)
DROP_REASON_DESC = {
    1: "POLICY_DENIED",
    2: "POLICY_DENY_DEFAULT",
    3: "QUEUE_OVERFLOW",
    4: "UNKNOWN_ENDPOINT",  # lxcmap miss (unregistered endpoint id)
    5: "NO_MAPPING_FOR_NAT_MASQUERADING",  # SNAT pool exhausted
    6: "BANDWIDTH_LIMITED",  # egress rate limit (EDT analogue)
    7: "NO_SERVICE",  # frontend with no backend (DROP_NO_SERVICE)
    8: "AUTH_REQUIRED",  # mutual auth missing (pkg/auth)
    9: "INGRESS_QUEUE_OVERFLOW",  # serving admission shed (XDP ring)
    10: "DISPATCH_TIMEOUT",  # serving watchdog deadlined a hung dispatch
    11: "RECOVERY_DROP",  # serving recovery accounted a lost batch
    12: "CLUSTER_ROUTER_OVERFLOW",  # cluster forward queue full
}


@dataclass
class FlowEndpoint:
    """flow.proto Endpoint: one side of a flow."""

    ip: str = ""
    port: int = 0
    identity: int = 0
    labels: Tuple[str, ...] = ()
    pod_name: str = ""
    endpoint_id: int = 0

    def to_dict(self) -> dict:
        d: dict = {"identity": self.identity}
        if self.labels:
            d["labels"] = list(self.labels)
        if self.pod_name:
            d["podName"] = self.pod_name
        if self.endpoint_id:
            d["ID"] = self.endpoint_id
        return d


@dataclass
class Flow:
    time: float
    uuid: int  # monotonically increasing sequence number
    verdict: int
    drop_reason: int
    event_type: int  # monitor MSG_* number
    is_reply: bool
    traffic_direction: int  # 0 ingress / 1 egress
    proto: int
    flags: int
    length: int
    source: FlowEndpoint
    destination: FlowEndpoint
    l7: Optional[dict] = None  # L7 record when proxy-parsed
    # flow.proto proxy_port: the listener a REDIRECTED flow detoured
    # to (0 = no redirect) — without it a redirect row renders
    # indistinguishably from plain ALLOW
    proxy_port: int = 0

    @property
    def verdict_name(self) -> str:
        return VERDICT_NAMES.get(self.verdict, "VERDICT_UNKNOWN")

    def summary(self) -> str:
        p = PROTO_NAMES.get(self.proto, str(self.proto))
        arrow = "<-" if self.is_reply else "->"
        to_proxy = (f" to-proxy:{self.proxy_port}"
                    if self.verdict == VERDICT_REDIRECT
                    and self.proxy_port else "")
        return (f"{self.source.ip}:{self.source.port} {arrow} "
                f"{self.destination.ip}:{self.destination.port} "
                f"{p} {self.verdict_name}{to_proxy}")

    def to_dict(self) -> dict:
        """hubble-JSON-shaped rendering (flow.proto JSON)."""
        d = {
            "time": self.time,
            "uuid": str(self.uuid),
            "verdict": self.verdict_name,
            "IP": {
                "source": self.source.ip,
                "destination": self.destination.ip,
            },
            "l4": self._l4_dict(),
            "source": self.source.to_dict(),
            "destination": self.destination.to_dict(),
            "Type": "L7" if self.l7 else "L3_L4",
            "event_type": {"type": int(self.event_type)},
            "traffic_direction": ("INGRESS" if self.traffic_direction == 0
                                  else "EGRESS"),
            "is_reply": self.is_reply,
        }
        if self.drop_reason:
            d["drop_reason_desc"] = DROP_REASON_DESC.get(
                self.drop_reason, f"DROP_REASON_{self.drop_reason}")
            d["drop_reason"] = self.drop_reason
            if self.verdict in (VERDICT_ALLOW, VERDICT_REDIRECT):
                # forwarded WITH a would-be deny reason: the
                # policy-audit-mode signature (upstream renders
                # verdict AUDIT)
                d["policy_audit"] = True
        if self.proxy_port:
            d["proxy_port"] = self.proxy_port
        if self.l7:
            d["l7"] = self.l7
        d["Summary"] = self.summary()
        return d

    def _l4_dict(self) -> dict:
        if self.proto == 6:
            return {"TCP": {"source_port": self.source.port,
                            "destination_port": self.destination.port,
                            "flags": self._tcp_flags()}}
        if self.proto == 17:
            return {"UDP": {"source_port": self.source.port,
                            "destination_port": self.destination.port}}
        if self.proto in (1, 58):
            key = "ICMPv4" if self.proto == 1 else "ICMPv6"
            return {key: {"type": self.destination.port}}
        if self.proto == 132:
            return {"SCTP": {"source_port": self.source.port,
                             "destination_port": self.destination.port}}
        return {"proto": self.proto}

    def _tcp_flags(self) -> dict:
        f = self.flags
        out = {}
        for name, bit in (("FIN", 0x01), ("SYN", 0x02), ("RST", 0x04),
                          ("PSH", 0x08), ("ACK", 0x10), ("URG", 0x20)):
            if f & bit:
                out[name] = True
        return out
