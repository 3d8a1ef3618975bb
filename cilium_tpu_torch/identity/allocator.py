"""Identity allocation: label set -> cluster-unique numeric identity.

Reference: upstream cilium ``pkg/identity/cache``
(``CachingIdentityAllocator``) on top of ``pkg/allocator`` — ref-counted,
kvstore-backed, collision-free allocation with reserved identities
pre-registered and CIDR identities allocated from a node-local scope.

The kvstore backend is optional: any object with the allocator's
``allocate``/``ref`` interface.  This package ships none; without one,
allocation is node-local.

Observers (e.g. the policy SelectorCache and the datapath's
IdentityRowMap) register callbacks fired on add/remove so incremental
identity churn propagates to device tensors without a full recompile.
"""

from __future__ import annotations

import ipaddress
import threading
from typing import Callable, Dict, List, Optional

from ..labels import Label, LabelSet, SOURCE_CIDR


def cidr_labels(cidr: str) -> list:
    """``cidr:`` labels for a prefix and every parent prefix
    (reference: pkg/labels GetCIDRLabels — 33 labels for a v4 /32,
    129 for a v6 /128), so CIDR rules select by LABEL, not by
    happening to share an exact prefix."""
    net = ipaddress.ip_network(cidr, strict=False)
    out = [Label(SOURCE_CIDR, str(net))]
    for plen in range(net.prefixlen):
        out.append(Label(SOURCE_CIDR, str(net.supernet(
            new_prefix=plen))))
    return out
from .identity import (
    Identity,
    LOCAL_IDENTITY_FLAG,
    MIN_ALLOCATED,
    MAX_ALLOCATED,
    RESERVED_BY_LABELS,
    RESERVED_LABELSETS,
)

IdentityChangeFn = Callable[[str, Identity], None]  # kind: "add"|"remove"


class CachingIdentityAllocator:
    """Ref-counted label-set -> identity allocator with observers."""

    def __init__(self, backend=None, min_id: int = MIN_ALLOCATED,
                 max_id: int = MAX_ALLOCATED):
        # backend: optional kvstore-like .allocate(key)->int shared across
        # "nodes"; None = purely local allocation.
        self._backend = backend
        self._lock = threading.RLock()
        self._by_labels: Dict[str, Identity] = {}
        self._by_id: Dict[int, Identity] = {}
        self._refcount: Dict[int, int] = {}
        self._observers: List[IdentityChangeFn] = []
        self._next_id = min_id
        self._max_id = max_id
        self._next_local = LOCAL_IDENTITY_FLAG | 1
        for num, ls in RESERVED_LABELSETS.items():
            ident = Identity(num, ls)
            self._by_labels[ls.sorted_key()] = ident
            self._by_id[num] = ident
            self._refcount[num] = 1  # pinned

    # -- observer fan-out (reference: identity Observer / events) --------
    def observe(self, fn: IdentityChangeFn) -> None:
        with self._lock:
            self._observers.append(fn)
            for ident in self._by_id.values():
                fn("add", ident)

    def _notify(self, kind: str, ident: Identity) -> None:
        for fn in list(self._observers):
            fn(kind, ident)

    # -- allocation ------------------------------------------------------
    def allocate(self, labels: LabelSet) -> Identity:
        """Allocate (or ref) the identity for a label set."""
        key = labels.sorted_key()
        with self._lock:
            if key in RESERVED_BY_LABELS:
                return self._by_labels[key]
            ident = self._by_labels.get(key)
            if ident is not None:
                prev = self._refcount.get(ident.numeric_id, 0)
                self._refcount[ident.numeric_id] = prev + 1
                if (prev == 0 and self._backend is not None
                        and hasattr(self._backend, "ref")
                        and not (ident.numeric_id & LOCAL_IDENTITY_FLAG)
                        and ident.numeric_id not in RESERVED_LABELSETS):
                    # first local use of a watch-replayed identity:
                    # take this node's kvstore reference so identity
                    # GC sees the id as live
                    self._backend.ref(key, ident.numeric_id)
                return ident
            local = any(l.source == SOURCE_CIDR for l in labels)
            if local:
                num = self._next_local
                self._next_local += 1
            elif self._backend is not None:
                num = self._backend.allocate(key)
            else:
                if self._next_id >= self._max_id:
                    raise RuntimeError("identity space exhausted")
                num = self._next_id
                self._next_id += 1
            ident = Identity(num, labels)
            self._by_labels[key] = ident
            self._by_id[num] = ident
            self._refcount[num] = 1
            self._notify("add", ident)
            return ident

    def allocate_cidr(self, cidr: str) -> Identity:
        """Allocate a node-local identity for a CIDR (toCIDR / fqdn flows).

        Reference: pkg/identity CIDR-derived local identities; labels
        are ``cidr:<prefix>`` for the prefix AND every parent prefix
        (pkg/labels GetCIDRLabels), plus ``reserved:world`` — so a
        ``fromCIDR 10.0.0.0/8`` rule label-selects a later-minted
        ``10.1.2.3/32`` identity (DIVERGENCES #8, closed r05).
        """
        labels = LabelSet(cidr_labels(cidr)
                          + [Label("reserved", "world")])
        return self.allocate(labels)

    def release(self, ident: Identity) -> bool:
        """Deref; returns True when the identity was freed."""
        with self._lock:
            num = ident.numeric_id
            if num in RESERVED_LABELSETS:
                return False
            if num not in self._refcount:
                return False  # unknown or already freed — no-op
            cnt = self._refcount[num] - 1
            if cnt > 0:
                self._refcount[num] = cnt
                return False
            self._refcount.pop(num, None)
            self._by_id.pop(num, None)
            # pop the labels index only when it still maps to THIS
            # identity — a stale release must not remove a newer
            # identity that re-bound the same label set
            cur = self._by_labels.get(ident.labels.sorted_key())
            if cur is not None and cur.numeric_id == num:
                self._by_labels.pop(ident.labels.sorted_key(), None)
            if self._backend is not None and hasattr(self._backend,
                                                     "release"):
                # drop this node's kvstore reference; the master key
                # stays until identity GC sweeps orphans (operator)
                self._backend.release(ident.labels.sorted_key())
            self._notify("remove", ident)
            return True

    # -- restore (checkpoint/resume) -------------------------------------
    def restore_identity(self, numeric_id: int,
                         labels: LabelSet) -> Identity:
        """Re-register a checkpointed identity under its old numeric id
        (reference: identities restored from the state dir / CRDs keep
        their numbers so policy maps stay valid across restarts)."""
        key = labels.sorted_key()
        with self._lock:
            if key in RESERVED_BY_LABELS:
                return self._by_labels[key]
            existing = self._by_id.get(numeric_id)
            if existing is not None:
                if existing.labels.sorted_key() != key:
                    raise ValueError(
                        f"identity {numeric_id} already bound to "
                        f"{existing.labels}")
                return existing  # idempotent, holds no ref
            ident = Identity(numeric_id, labels)
            self._by_labels[key] = ident
            self._by_id[numeric_id] = ident
            # the restore itself holds NO reference: restored endpoints
            # re-allocate (ref 1 each) as they register, so deleting
            # them later frees the identity instead of leaking it.
            # Orphans (refcount 0, e.g. CIDR identities whose rules are
            # gone) are swept by identity GC (the operator's job in the
            # reference).
            self._refcount[numeric_id] = 0
            if numeric_id & LOCAL_IDENTITY_FLAG:
                self._next_local = max(self._next_local, numeric_id + 1)
            else:
                self._next_id = max(self._next_id, numeric_id + 1)
            self._notify("add", ident)
            return ident

    # -- watch replay (ClusterIdentitySync) ------------------------------
    def watch_update(self, numeric_id: int, labels: LabelSet) -> Identity:
        """Apply a watched ``id/<num>`` create: register the identity,
        or RE-BIND a GC'd-and-reused numeric (the ABA case hole-reuse
        makes common: k1 -> N is released cluster-wide, identity GC
        sweeps id/N, another node mints k2 -> N).  A locally-referenced
        identity is never re-bound — live refs imply a kvstore ref
        that keeps GC away, so a conflicting create for a referenced
        numeric means a lease blip; keeping local state is the safe
        side."""
        key = labels.sorted_key()
        with self._lock:
            existing = self._by_id.get(numeric_id)
            if existing is not None:
                if existing.labels.sorted_key() == key:
                    return existing
                if self._refcount.get(numeric_id, 0) > 0:
                    return existing
                self._drop(existing)
            return self.restore_identity(numeric_id, labels)

    def watch_remove(self, numeric_id: int) -> bool:
        """Apply a watched ``id/<num>`` delete (identity GC swept the
        master).  Only unreferenced identities drop — local release
        stays refcount-driven."""
        with self._lock:
            if numeric_id in RESERVED_LABELSETS:
                return False
            existing = self._by_id.get(numeric_id)
            if existing is None or self._refcount.get(numeric_id, 0) > 0:
                return False
            self._drop(existing)
            return True

    def _drop(self, ident: Identity) -> None:
        num = ident.numeric_id
        self._refcount.pop(num, None)
        self._by_id.pop(num, None)
        cur = self._by_labels.get(ident.labels.sorted_key())
        if cur is not None and cur.numeric_id == num:
            self._by_labels.pop(ident.labels.sorted_key(), None)
        self._notify("remove", ident)

    def close(self) -> None:
        """Release backend resources (kvstore watch subscription)."""
        if self._backend is not None and hasattr(self._backend, "close"):
            self._backend.close()

    # -- lookup ----------------------------------------------------------
    def lookup_by_id(self, numeric_id: int) -> Optional[Identity]:
        with self._lock:
            return self._by_id.get(numeric_id)

    def lookup_by_labels(self, labels: LabelSet) -> Optional[Identity]:
        with self._lock:
            return self._by_labels.get(labels.sorted_key())

    def all_identities(self) -> List[Identity]:
        with self._lock:
            return list(self._by_id.values())
