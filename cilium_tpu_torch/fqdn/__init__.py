"""fqdn: DNS-aware policy — observed names become identities.

Reference: upstream cilium ``pkg/fqdn`` — the DNS proxy snoops
responses, the NameManager maps name->IPs with TTLs, IPs get
CIDR-derived identities carrying fqdn metadata, the ipcache learns the
mapping, and ``toFQDNs`` selectors start matching.  The reference
package patches one verdict row and one /32 LPM slot per answer; the
port has no incremental patch path yet (ROADMAP A2/A3), so each minted
identity costs a full regeneration, which computes the same tables.

Identity shape: one identity per IP, labeled with EVERY name observed
for that IP (``fqdn:<name>``), ``cidr:<ip>/32``, and
``reserved:world`` — so exact ``toFQDNs`` selectors match by label,
``matchPattern`` globs match via the contribution's fqdn_patterns, and
the daemon's CIDR hook feeds the ipcache automatically.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..identity import Identity
from ..labels import Label, LabelSet


@dataclass
class _IPEntry:
    names: Dict[str, float]  # name -> expiry (unix time)
    identity: Identity


class NameManager:
    def __init__(self, allocator, delete_ipcache: Callable[[str], None],
                 min_ttl: int = 60):
        """``allocator`` allocates/releases identities (the daemon's);
        ``delete_ipcache(cidr)`` removes an expired mapping (the add
        side happens automatically through the daemon's CIDR-label
        hook on identity allocation)."""
        self._lock = threading.Lock()
        self._allocator = allocator
        self._delete_ipcache = delete_ipcache
        self.min_ttl = min_ttl
        self._by_ip: Dict[str, _IPEntry] = {}

    # -- the observe loop (DNS proxy -> here) -------------------------
    def observe(self, name: str, ips: Sequence[str],
                ttl: int = 60) -> None:
        """One observed DNS answer: name resolved to ips with ttl."""
        name = name.rstrip(".").lower()
        expires = time.time() + max(int(ttl), self.min_ttl)
        for ip in ips:
            self._observe_ip(name, ip, expires)

    def _observe_ip(self, name: str, ip: str, expires: float) -> None:
        with self._lock:
            e = self._by_ip.get(ip)
            if e is not None and name in e.names:
                e.names[name] = max(e.names[name], expires)
                return
            names = dict(e.names) if e else {}
            names[name] = expires
            old = e.identity if e else None
            ident = self._allocate(ip, names)
            self._by_ip[ip] = _IPEntry(names=names, identity=ident)
        # release OUTSIDE the lock: the allocator observer chain runs
        # a regeneration that must not nest under our lock
        if old is not None:
            self._allocator.release(old)

    def _allocate(self, ip: str, names: Dict[str, float]) -> Identity:
        from ..identity.allocator import cidr_labels

        suffix = "/128" if ":" in ip else "/32"
        # full parent-prefix label set (r05): a fromCIDR range
        # label-selects fqdn-minted /32s inside it
        labels = LabelSet(
            [Label("fqdn", n) for n in sorted(names)]
            + cidr_labels(ip + suffix) + [Label("reserved", "world")])
        return self._allocator.allocate(labels)

    # -- TTL expiry (controller cadence) ------------------------------
    def gc(self, now: Optional[float] = None) -> int:
        """Expire stale names; returns the number of IPs released.

        Reference: pkg/fqdn TTL GC — expired name->IP associations are
        dropped; an IP with no live names loses its identity and its
        ipcache entry."""
        now = time.time() if now is None else now
        released: List[Tuple[str, Identity, Dict[str, float]]] = []
        with self._lock:
            for ip, e in list(self._by_ip.items()):
                live = {n: exp for n, exp in e.names.items() if exp > now}
                if len(live) == len(e.names):
                    continue
                if live:
                    ident = self._allocate(ip, live)
                    old = e.identity
                    self._by_ip[ip] = _IPEntry(names=live, identity=ident)
                    released.append(("", old, {}))
                else:
                    del self._by_ip[ip]
                    released.append((ip, e.identity, e.names))
        n_dropped = 0
        for ip, ident, _names in released:
            if ip:
                suffix = "/128" if ":" in ip else "/32"
                self._delete_ipcache(ip + suffix)
                n_dropped += 1
            self._allocator.release(ident)
        return n_dropped

    # -- introspection (cilium fqdn cache list) -----------------------
    def entries(self) -> List[dict]:
        with self._lock:
            return [{
                "ip": ip,
                "names": sorted(e.names),
                "identity": e.identity.numeric_id,
                "expires": max(e.names.values()),
            } for ip, e in sorted(self._by_ip.items())]
