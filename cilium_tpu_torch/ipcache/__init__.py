"""IPCache: the IP/CIDR -> identity metadata store (host side).

Reference: upstream cilium ``pkg/ipcache`` — the authoritative map of
prefix -> security identity (+ metadata source tracking), mirrored into
the kernel LPM map.  Here it mirrors into the datapath's DIR-16-8-8
LPM tensors on every sync (the loader swap).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class IPCacheEntry:
    cidr: str
    identity: int  # numeric
    source: str = "custom"  # k8s | kvstore | custom (metadata source)


class IPCache:
    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, IPCacheEntry] = {}
        self._listeners: List[Callable[[], None]] = []

    def upsert(self, cidr: str, identity: int,
               source: str = "custom") -> None:
        with self._lock:
            self._entries[cidr] = IPCacheEntry(cidr, identity, source)
        self._changed()

    def delete(self, cidr: str) -> bool:
        with self._lock:
            found = self._entries.pop(cidr, None) is not None
        if found:
            self._changed()
        return found

    def get(self, cidr: str) -> Optional[IPCacheEntry]:
        with self._lock:
            return self._entries.get(cidr)

    def to_identity_map(self) -> Dict[str, int]:
        """cidr -> numeric identity (the loader's attach input)."""
        with self._lock:
            return {c: e.identity for c, e in self._entries.items()}

    def entries(self) -> List[IPCacheEntry]:
        with self._lock:
            return list(self._entries.values())

    def on_change(self, fn: Callable[[], None]) -> None:
        self._listeners.append(fn)

    def _changed(self) -> None:
        for fn in list(self._listeners):
            fn()
