"""Policy repository: the rule list + revision counter + resolve cache.

Reference: upstream cilium ``pkg/policy/repository.go`` (``Repository``,
``AddList``/``DeleteByLabels``, revision bump on every mutation) and
``pkg/policy/distillery.go`` (``PolicyCache`` sharing one resolved
``SelectorPolicy`` across all endpoints with the same identity).

Mutations notify listeners (the endpoint manager) so affected endpoints
regenerate — the 3.3 call stack in SURVEY.md.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

from ..labels import LabelSet
from ..identity.allocator import CachingIdentityAllocator
from .api import Rule, rules_from_obj
from .resolve import EndpointPolicy, resolve_policy
from .selectorcache import SelectorCache


class PolicyRepository:
    def __init__(self, allocator: CachingIdentityAllocator,
                 selector_cache: Optional[SelectorCache] = None):
        self._lock = threading.RLock()
        self.allocator = allocator
        self.selector_cache = selector_cache or SelectorCache(allocator)
        self._rules: List[Rule] = []
        self._revision = 1
        # distillery: subject labels key -> resolved policy @ revision
        self._cache: Dict[str, EndpointPolicy] = {}
        self._listeners: List[Callable[[int], None]] = []
        # node-wide named-port MULTIMAP (name -> set of numbers) for
        # EGRESS rules, where the named port is the destination pod's
        # (reference: NamedPortMultiMap).  Endpoint churn that changes
        # bindings calls invalidate(), so cached resolutions never
        # outlive the map they resolved against.
        self.peer_named_ports_getter: Optional[
            Callable[[], Dict[str, frozenset]]] = None

    # -- mutation --------------------------------------------------------
    def add_list(self, rules: Sequence[Rule]) -> int:
        with self._lock:
            self._rules.extend(rules)
            return self._bump()

    def add_obj(self, obj) -> int:
        """Accept cilium policy-import JSON (list or single rule dict)."""
        return self.add_list(rules_from_obj(obj))

    def delete_by_labels(self, labels: Sequence[str]) -> int:
        """Delete all rules carrying every given label string."""
        want = set(labels)
        with self._lock:
            self._rules = [r for r in self._rules
                           if not want.issubset(set(r.labels))]
            return self._bump()

    def replace_all(self, rules: Sequence[Rule]) -> int:
        with self._lock:
            self._rules = list(rules)
            return self._bump()

    def _bump(self) -> int:
        self._revision += 1
        self._cache.clear()
        rev = self._revision
        for fn in list(self._listeners):
            fn(rev)
        return rev

    def invalidate(self) -> int:
        """Bump the revision without a rule change — identity churn
        makes cached resolutions stale because peer sets are frozen at
        resolve time (reference: SelectorCache identity notifications
        trigger incremental policy-map updates; here the daemon calls
        this and regenerates)."""
        with self._lock:
            return self._bump()

    def invalidate_cache(self) -> None:
        """Drop cached resolutions WITHOUT bumping the revision or
        firing listeners.  For identity churn before the daemon
        starts: the caller's own regeneration (add_endpoint triggers
        one) re-resolves with fresh peer sets, and firing listeners
        here would run one full regeneration per replayed identity at
        startup."""
        with self._lock:
            self._cache.clear()

    # -- queries ---------------------------------------------------------
    @property
    def revision(self) -> int:
        with self._lock:
            return self._revision

    def rules(self) -> List[Rule]:
        with self._lock:
            return list(self._rules)

    def on_change(self, fn: Callable[[int], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def resolve(self, subject_labels: LabelSet,
                named_ports: Optional[Dict[str, int]] = None
                ) -> EndpointPolicy:
        """Resolve (cached per subject label-set + named-port bindings
        + revision).

        ``named_ports`` is the ENDPOINT's own name->number map
        (reference: named ports resolve against the pod's container
        ports, strictly per endpoint — two endpoints naming the same
        port differently each get their own resolution); the distillery
        cache keys on it so label-identical endpoints with identical
        bindings still share one resolve."""
        key = subject_labels.sorted_key()
        if named_ports:
            key += "|np:" + ",".join(
                f"{n}={p}" for n, p in sorted(named_ports.items()))
        with self._lock:
            pol = self._cache.get(key)
            if pol is not None and pol.revision == self._revision:
                return pol
            peer_np = (self.peer_named_ports_getter()
                       if self.peer_named_ports_getter else None)
            pol = resolve_policy(self._rules, subject_labels,
                                 self.selector_cache, self.allocator,
                                 revision=self._revision,
                                 named_ports=named_ports,
                                 peer_named_ports=peer_np)
            self._cache[key] = pol
            return pol
