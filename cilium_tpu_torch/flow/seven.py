"""The "seven" parser: L7 proxy access records -> Flow records.

Reference: upstream cilium ``pkg/hubble/parser/seven`` — Envoy access
logs become ``flow.Flow`` messages with the ``l7`` field set
(``flow.proto`` Layer7: HTTP/DNS/Kafka) and event type L7 (129).
The proxy's featurizer already produced the structured
record; this parser enriches it (identity labels, endpoint info) and
lands it in the same Observer ring as the threefour flows.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..core.packets import N_COLS, COL_DPORT, COL_PROTO
from ..proxy.featurize import KIND_DNS, KIND_HTTP
from ..proxy.proxy import L7Record
from .flow import VERDICT_ALLOW, VERDICT_DENY

MSG_L7 = 129  # flow event type for proxy records (hubble: L7)


class SevenParser:
    """proxy.on_record consumer -> Observer ring (the seven parser)."""

    def __init__(self, observer,
                 numeric_of_row: Optional[Callable[[int], int]] = None):
        """``numeric_of_row``: identity ROW -> numeric identity (the
        loader row map); rows are what the proxy carries."""
        self.observer = observer
        self.numeric_of_row = numeric_of_row or (lambda r: 0)
        self.parsed = 0

    def consume(self, rec: L7Record) -> None:
        l7 = self._layer7(rec)
        hdr = np.zeros(N_COLS, dtype=np.uint32)
        hdr[COL_PROTO] = 17 if rec.kind == KIND_DNS else 6
        hdr[COL_DPORT] = rec.proxy_port
        verdict = VERDICT_ALLOW if rec.verdict else VERDICT_DENY
        self.observer.append_l7(
            hdr_row=hdr, l7=l7, verdict=verdict,
            identity=self.numeric_of_row(rec.src_row),
            timestamp=rec.timestamp)
        self.parsed += 1

    def _layer7(self, rec: L7Record) -> dict:
        # flow.proto Layer7 JSON shape
        if rec.kind == KIND_HTTP:
            return {
                "type": "REQUEST",
                "http": {
                    "method": rec.method,
                    "url": rec.path,
                    **({"host": rec.host} if rec.host else {}),
                    "protocol": "HTTP/1.1",
                    "code": rec.status,
                },
            }
        if rec.kind == KIND_DNS:
            return {
                "type": "REQUEST",
                "dns": {
                    "query": rec.qname,
                    "rcode": 0 if rec.verdict else 5,  # REFUSED
                },
            }
        return {
            "type": "REQUEST",
            "kafka": {
                "api_key": rec.method,
                "topic": rec.path,
                # 29 = TOPIC_AUTHORIZATION_FAILED (kafka error code)
                "error_code": 0 if rec.verdict else 29,
            },
        }
