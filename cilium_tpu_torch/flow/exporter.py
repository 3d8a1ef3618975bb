"""Flow exporter: JSON-lines flow log files.

Reference: upstream cilium ``pkg/hubble/exporter`` — writes flows as
one JSON object per line ({"flow": {...}, "node_name", "time"}), with
size-based rotation.
"""

from __future__ import annotations

import json
import os
from typing import IO, Optional

from ..monitor.api import EventBatch
from .observer import Observer


class FlowExporter:
    """Writes flows from an observer-shaped batch stream to JSONL.

    Registered as a MonitorAgent consumer; uses a private single-batch
    Observer for materialization so enrichment getters apply."""

    def __init__(self, path: str, node_name: str = "node0",
                 max_bytes: int = 64 << 20,
                 identity_getter=None, endpoint_getter=None):
        self.path = path
        self.node_name = node_name
        self.max_bytes = max_bytes
        self._identity_getter = identity_getter
        self._endpoint_getter = endpoint_getter
        self._seq = 0
        self._fh: Optional[IO[str]] = None
        self.written = 0

    def _file(self) -> IO[str]:
        if self._fh is None:
            self._fh = open(self.path, "a", encoding="utf-8")
        return self._fh

    def consume(self, batch: EventBatch) -> None:
        if len(batch) == 0:
            return
        from .observer import materialize_flow

        ident_get = self._identity_getter or (lambda n: ())
        ep_get = self._endpoint_getter or (lambda e: ("", e))
        fh = self._file()
        for i in range(len(batch)):
            fl = materialize_flow(
                batch.hdr[i], batch.timestamp, self._seq + i,
                int(batch.verdict[i]), int(batch.reason[i]),
                int(batch.ct_state[i]), int(batch.msg_type[i]),
                int(batch.identity[i]), ident_get, ep_get,
                proxy_port=int(batch.proxy_port[i]))
            rec = {"flow": fl.to_dict(), "node_name": self.node_name,
                   "time": fl.time}
            fh.write(json.dumps(rec) + "\n")
            self.written += 1
        self._seq += len(batch)
        fh.flush()
        if os.path.getsize(self.path) > self.max_bytes:
            self._rotate()

    def _rotate(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        os.replace(self.path, self.path + ".1")

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
