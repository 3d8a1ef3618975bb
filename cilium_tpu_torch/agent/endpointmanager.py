"""EndpointManager: registry + the regeneration pipeline.

Reference: upstream cilium ``pkg/endpointmanager`` (registry, bulk
regeneration triggers) + the regeneration flow of
``pkg/endpoint/bpf.go`` (SURVEY.md §3.3): policy resolve ->
policy-map/datapath update.

All endpoints on the node share one compiled tensor set, so
regeneration is: resolve one EndpointPolicy per DISTINCT subject
identity (the distillery/PolicyCache sharing), assemble the policy
list + endpoint->row map + ipcache view, and swap via the Loader.
Bursts coalesce through a Trigger.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ..datapath.loader import Loader
from ..infra.trigger import Trigger
from ..ipcache import IPCache
from ..labels import LabelSet
from ..policy.compiler import IdentityRowMap
from ..policy.repository import PolicyRepository
from .endpoint import Endpoint, EndpointState


class EndpointManager:
    def __init__(self, repo: PolicyRepository, ipcache: IPCache,
                 loader: Loader, row_capacity: int = 1 << 14):
        self._lock = threading.RLock()
        self._endpoints: Dict[int, Endpoint] = {}
        self._next_id = 1
        self.repo = repo
        self.ipcache = ipcache
        self.loader = loader
        self.row_capacity = row_capacity
        self.regenerations = 0
        repo.peer_named_ports_getter = self.named_ports_multimap
        # persistent identity->row map: rows are stable across identity
        # churn so incremental tensor patches address the same row the
        # attached tensors were compiled with (rows are never reused;
        # released identities leave unreferenced rows behind)
        self.row_map = IdentityRowMap(capacity=row_capacity)
        self._attached_policies: List = []
        self._attach_hooks: List = []  # fn(policies) after every attach
        self._ep_hooks: List = []  # fn(kind, ep) on add/remove
        self._regen_trigger = Trigger(self._regenerate_all,
                                      name="endpoint-regeneration")
        self._event_options_cache: Optional[Dict] = None

    def named_ports_multimap(self) -> Dict[str, frozenset]:
        """name -> EVERY port number bound to that name by any
        endpoint (the NamedPortMultiMap analogue).  Egress rules with
        named ports expand over all bindings — the destination could
        be any pod, and last-registered-wins would silently judge one
        endpoint under another's port."""
        out: Dict[str, set] = {}
        with self._lock:
            for ep in self._endpoints.values():
                for name, port in ep.named_ports.items():
                    out.setdefault(name, set()).add(int(port))
        return {n: frozenset(s) for n, s in out.items()}

    def on_attach(self, fn) -> None:
        """Register fn(policies), called after every successful attach
        (the L7 proxy re-syncs its listeners here, the way pkg/proxy
        updates redirects on endpoint regeneration)."""
        self._attach_hooks.append(fn)

    def on_endpoint_change(self, fn) -> None:
        """Register fn(kind, ep) for endpoint add/remove (clustermesh
        publishes endpoint IPs here)."""
        self._ep_hooks.append(fn)

    def _fire_ep(self, kind: str, ep: Endpoint) -> None:
        for fn in list(self._ep_hooks):
            fn(kind, ep)

    # -- registry ----------------------------------------------------
    def add(self, name: str, ips: Tuple[str, ...], labels: LabelSet,
            ep_id: Optional[int] = None,
            named_ports: Optional[Dict[str, int]] = None,
            restoring: bool = False,
            defer_regen: bool = False,
            enforcement: str = "default",
            options: Optional[Dict[str, bool]] = None) -> Endpoint:
        """``ep_id`` pins a checkpointed id on restore so COL_EP
        tagging, policy rows, and the CT snapshot stay coherent.
        ``named_ports`` (name -> number) feeds the policy resolver's
        named-port registry.  ``restoring`` marks checkpoint-restore
        endpoints (state RESTORING until their first regeneration);
        ``defer_regen`` lets the restore loop batch one regeneration
        for all endpoints instead of one each.  ``enforcement`` /
        ``options`` restore per-endpoint config (checkpoint round
        trip)."""
        from ..datapath.verdict import MAX_ENDPOINTS
        from ..policy.resolve import ENFORCEMENT_MODES

        if enforcement not in ENFORCEMENT_MODES:
            raise ValueError(f"enforcement mode {enforcement!r} not "
                             f"in {ENFORCEMENT_MODES}")
        with self._lock:
            if ep_id is None:
                ep_id = self._next_id
            elif ep_id in self._endpoints:
                raise ValueError(f"endpoint id {ep_id} already in use")
            if not 0 < ep_id < MAX_ENDPOINTS:
                raise ValueError(
                    f"endpoint id {ep_id} out of range (1.."
                    f"{MAX_ENDPOINTS - 1}); the ep_policy table is "
                    f"fixed at {MAX_ENDPOINTS} rows")
            self._next_id = max(self._next_id, ep_id + 1)
            ep = Endpoint(id=ep_id, name=name, ips=tuple(ips),
                          labels=labels,
                          named_ports=dict(named_ports or {}),
                          enforcement=enforcement)
            if options:
                ep.options.update({k: bool(v)
                                   for k, v in options.items()
                                   if k in ep.options})
            if restoring:
                ep.state = EndpointState.RESTORING
            self._endpoints[ep_id] = ep
            self._event_options_cache = None
        try:
            ident = self.repo.allocator.allocate(labels)
        except Exception:
            # kvstore outage / id-space pressure: the endpoint exists
            # but cannot enforce yet — it waits (reference: the
            # waiting-for-identity endpoint state) and the retry
            # controller re-attempts until allocation succeeds
            ep.state = EndpointState.WAITING_FOR_IDENTITY
            return ep
        self._bind_identity(ep, ident)
        self._fire_ep("add", ep)
        if not defer_regen:
            self.regenerate()
        return ep

    def _bind_identity(self, ep: Endpoint, ident) -> None:
        ep.identity = ident
        for ip in ep.ips:
            suffix = "/128" if ":" in ip else "/32"
            self.ipcache.upsert(ip + suffix, ident.numeric_id,
                                source="endpoint")
        if ep.named_ports:
            # named-port bindings change what rules resolve to; cached
            # resolutions at the current revision are stale
            self.repo.invalidate()

    def retry_pending_identities(self) -> int:
        """Re-attempt allocation for waiting-for-identity endpoints;
        returns how many advanced (controller-driven)."""
        with self._lock:
            pending = [ep for ep in self._endpoints.values()
                       if ep.identity is None
                       and ep.state == EndpointState.WAITING_FOR_IDENTITY]
        advanced = 0
        for ep in pending:
            try:
                ident = self.repo.allocator.allocate(ep.labels)
            except Exception:
                continue
            self._bind_identity(ep, ident)
            # the add-time hook was skipped while waiting (no identity
            # to publish); fire it now so clustermesh/watchers see the
            # endpoint exactly once it can enforce
            self._fire_ep("add", ep)
            advanced += 1
        if advanced:
            self.regenerate()
        return advanced

    def remove(self, ep_id: int) -> bool:
        with self._lock:
            ep = self._endpoints.pop(ep_id, None)
            self._event_options_cache = None
        if ep is None:
            return False
        ep.state = EndpointState.DISCONNECTING
        for ip in ep.ips:
            suffix = "/128" if ":" in ip else "/32"
            self.ipcache.delete(ip + suffix)
        if ep.identity is not None:
            self.repo.allocator.release(ep.identity)
        if ep.named_ports:
            self.repo.invalidate()
        self._fire_ep("remove", ep)
        self.regenerate()
        return True

    def update_config(self, ep_id: int,
                      enforcement: Optional[str] = None,
                      options: Optional[Dict[str, bool]] = None) -> bool:
        """PATCH /endpoint/{id}/config: change the enforcement mode
        and/or runtime options.  A mode change regenerates through
        the shared trigger (synchronous when idle; folded into the
        in-flight run otherwise — never two interleaved
        regenerations); option changes are host-side event filters
        and need no regen."""
        from ..policy.resolve import ENFORCEMENT_MODES

        # validate EVERYTHING before applying anything: a bad mode
        # must not leave options half-applied behind a 400 (same
        # stage-then-apply rule as Daemon.patch_config)
        if enforcement is not None and enforcement not in \
                ENFORCEMENT_MODES:
            raise ValueError(f"enforcement mode {enforcement!r} not "
                             f"in {ENFORCEMENT_MODES}")
        with self._lock:
            ep = self._endpoints.get(ep_id)
            if ep is None:
                return False
            if options:
                unknown = set(options) - set(ep.options)
                if unknown:
                    raise ValueError(f"unknown endpoint options "
                                     f"{sorted(unknown)}")
                ep.options.update({k: bool(v) for k, v in options.items()})
            mode_changed = (enforcement is not None
                            and enforcement != ep.enforcement)
            if mode_changed:
                ep.enforcement = enforcement
            self._event_options_cache = None
        if mode_changed:
            self._regen_trigger.trigger()
        return True

    def event_options(self) -> Dict[int, Dict[str, bool]]:
        """{ep_id: options} for endpoints with NON-DEFAULT options —
        the monitor's per-endpoint event filter input.  Cached (and
        invalidated on add/remove/update_config) so the per-batch hot
        path is one attribute read in the all-default case."""
        cached = self._event_options_cache
        if cached is not None:
            return cached
        out: Dict[int, Dict[str, bool]] = {}
        with self._lock:
            for ep in self._endpoints.values():
                if (ep.options.get("Debug")
                        or not ep.options.get("DropNotification", True)
                        or not ep.options.get("TraceNotification", True)):
                    out[ep.id] = dict(ep.options)
            self._event_options_cache = out
        return out

    def get(self, ep_id: int) -> Optional[Endpoint]:
        with self._lock:
            return self._endpoints.get(ep_id)

    def list(self) -> List[Endpoint]:
        with self._lock:
            return sorted(self._endpoints.values(), key=lambda e: e.id)

    def lookup_by_ip(self, ip: str) -> Optional[Endpoint]:
        with self._lock:
            for ep in self._endpoints.values():
                if ip in ep.ips:
                    return ep
        return None

    # -- regeneration ------------------------------------------------
    def regenerate(self) -> None:
        """Trigger regeneration (coalesces bursts)."""
        self._regen_trigger.trigger()

    def _regenerate_all(self) -> None:
        with self._lock:
            # endpoints without an identity cannot enforce yet: they
            # keep waiting (their state machine advances when the
            # retry controller lands an allocation)
            eps = [ep for ep in self._endpoints.values()
                   if ep.identity is not None]
        for ep in eps:
            ep.state = EndpointState.REGENERATING
        revision = self.repo.revision
        # distillery: one resolved policy per distinct (subject
        # identity, enforcement mode) — non-default modes derive their
        # own variant from the shared resolve (pkg/policy distillery +
        # pkg/option per-endpoint enforcement)
        from ..policy.resolve import with_enforcement

        policies = []
        row_of: Dict[tuple, int] = {}
        ep_policy: Dict[int, int] = {}
        resolved: Dict[tuple, object] = {}
        for ep in eps:
            # named ports resolve PER ENDPOINT (reference: container
            # ports belong to the pod) — the distillery key carries the
            # bindings, so only endpoints that actually differ split
            np_key = tuple(sorted(ep.named_ports.items()))
            lkey = (ep.labels.sorted_key(), np_key)
            key = (lkey, ep.enforcement)
            if key not in row_of:
                if lkey not in resolved:
                    resolved[lkey] = self.repo.resolve(
                        ep.labels, named_ports=ep.named_ports)
                row_of[key] = len(policies)
                policies.append(with_enforcement(resolved[lkey],
                                                 ep.enforcement))
            ep_policy[ep.id] = row_of[key]
            ep.policy_row = row_of[key]
        if not policies:
            # no endpoints: an empty permissive policy keeps the
            # datapath well-formed
            policies = [self.repo.resolve(LabelSet.parse("reserved:init"))]
        for ident in self.repo.allocator.all_identities():
            self.row_map.add(ident.numeric_id)
        self.loader.attach(policies, self.ipcache.to_identity_map(),
                           ep_policy, self.row_map)
        with self._lock:
            self._attached_policies = policies
        for fn in list(self._attach_hooks):
            fn(policies)
        for ep in eps:
            ep.state = EndpointState.READY
            ep.policy_revision = revision
        self.regenerations += 1

    # -- incremental identity churn (SURVEY.md §7 hard part #3) -------
    def patch_identity(self, kind: str, ident) -> bool:
        """Apply one identity add/remove as an in-place tensor patch
        (no re-resolve, no recompile, no re-attach).  Returns False
        when the caller must fall back to full regeneration."""
        from ..policy.incremental import update_contributions

        with self._lock:
            policies = self._attached_policies
        if not policies:
            return False
        # peer sets first (keeps the MapState view and any later full
        # recompile consistent with the patched tensors) ...
        update_contributions(policies, kind, ident.numeric_id,
                             ident.labels)
        # ... then the device row
        return self.loader.patch_identity(kind, ident.numeric_id,
                                          policies)

    def patch_ipcache(self, cidr: str, numeric_id: int) -> bool:
        return self.loader.patch_ipcache(cidr, numeric_id)
