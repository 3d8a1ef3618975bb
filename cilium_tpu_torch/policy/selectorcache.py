"""SelectorCache: label selectors -> live sets of numeric identities.

Reference: upstream cilium ``pkg/policy/selectorcache.go``
(``SelectorCache``, ``CachedSelector``, identity-notification fan-out).
Policy rules reference selectors; identities churn as workloads come and
go.  The cache incrementally maintains, per selector, the set of numeric
identities whose labels match, and notifies users (resolved endpoint
policies, and the datapath compiler) of deltas so device tensors can be
patched without recompilation.

Per BASELINE.md's north star, this cache is also what seeds the learned
model's identity-embedding table (identity -> label multi-hot).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Set

from ..identity import Identity
from ..identity.allocator import CachingIdentityAllocator
from .api import EndpointSelector

# (selector, added_ids, removed_ids)
SelectorChangeFn = Callable[[EndpointSelector, Set[int], Set[int]], None]


class CachedSelector:
    """A selector plus its current identity selection."""

    def __init__(self, selector: EndpointSelector):
        self.selector = selector
        self.selections: Set[int] = set()
        self.refcount = 0

    def matches(self, numeric_id: int) -> bool:
        return numeric_id in self.selections


class SelectorCache:
    def __init__(self, allocator: CachingIdentityAllocator):
        self._lock = threading.RLock()
        # guarded-by: _lock: _selectors, _identities, _users
        self._allocator = allocator
        self._selectors: Dict[EndpointSelector, CachedSelector] = {}
        self._identities: Dict[int, Identity] = {}
        self._users: List[SelectorChangeFn] = []
        allocator.observe(self._on_identity_change)

    # -- identity events (from the allocator) ----------------------------
    # Runs on whatever thread mints/releases the identity (API, DNS
    # proxy, kvstore watch dispatcher, the churn scenario driver) —
    # and the user callbacks it fans into end in the loader's table
    # publish, so the lock ORDER here is selectorcache -> (user) ->
    # table-builder -> datapath-loader; nothing may call back into
    # this cache while holding either loader lock.
    def _on_identity_change(self, kind: str, ident: Identity) -> None:
        with self._lock:
            if kind == "add":
                self._identities[ident.numeric_id] = ident
                for cs in self._selectors.values():
                    if cs.selector.matches(ident.labels):
                        cs.selections.add(ident.numeric_id)
                        self._notify(cs.selector, {ident.numeric_id}, set())
            else:
                self._identities.pop(ident.numeric_id, None)
                for cs in self._selectors.values():
                    if ident.numeric_id in cs.selections:
                        cs.selections.discard(ident.numeric_id)
                        self._notify(cs.selector, set(), {ident.numeric_id})

    def _notify(self, sel: EndpointSelector, added: Set[int],
                removed: Set[int]) -> None:
        # holds: _lock -- only _on_identity_change calls this (RLock:
        # user callbacks may re-enter queries, not mutations)
        for fn in list(self._users):
            fn(sel, added, removed)

    # -- selector registration ------------------------------------------
    def add_selector(self, selector: EndpointSelector) -> CachedSelector:
        with self._lock:
            cs = self._selectors.get(selector)
            if cs is None:
                cs = CachedSelector(selector)
                for num, ident in self._identities.items():
                    if selector.matches(ident.labels):
                        cs.selections.add(num)
                self._selectors[selector] = cs
            cs.refcount += 1
            return cs

    def remove_selector(self, selector: EndpointSelector) -> None:
        with self._lock:
            cs = self._selectors.get(selector)
            if cs is None:
                return
            cs.refcount -= 1
            if cs.refcount <= 0:
                del self._selectors[selector]

    def subscribe(self, fn: SelectorChangeFn) -> None:
        with self._lock:
            self._users.append(fn)

    # -- queries ---------------------------------------------------------
    def selections(self, selector: EndpointSelector) -> Set[int]:
        with self._lock:
            cs = self._selectors.get(selector)
            if cs is not None:
                return set(cs.selections)
            # uncached one-shot evaluation
            return {
                num for num, ident in self._identities.items()
                if selector.matches(ident.labels)
            }

    def identity(self, numeric_id: int) -> Optional[Identity]:
        with self._lock:
            return self._identities.get(numeric_id)

    def known_identities(self) -> List[Identity]:
        with self._lock:
            return list(self._identities.values())
