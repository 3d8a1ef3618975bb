"""Policy resolution: repository rules + subject labels -> EndpointPolicy.

Reference: upstream cilium ``pkg/policy/resolve.go`` (``ResolvePolicy``
producing an ``EndpointPolicy`` whose ``MapState`` holds the desired
policy-map entries) and ``pkg/policy/l4.go`` (``L4Filter`` expansion of
peer selectors x port specs).

Expansion rules (mirroring the reference's L4Filter semantics):

- a rule with no ``toPorts`` grants all protocols/ports (one PROTO_ANY
  contribution covering every dense proto, including OTHER);
- ``toPorts`` with protocol ANY expands to TCP+UDP+SCTP (port rules
  never cover ICMP/OTHER);
- peer sets are the union of fromEndpoints/toEndpoints selections (via
  SelectorCache), entity selectors, and CIDR-derived local identities;
- an L7 section on an allow turns it into a proxy REDIRECT.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import FrozenSet, List, Optional, Sequence, Tuple

from ..labels import Label, LabelSet, SOURCE_RESERVED
from ..identity.allocator import CachingIdentityAllocator
from .api import (
    CIDRRule,
    ENTITY_ALL,
    ENTITY_CLUSTER,
    ENTITY_SELECTORS,
    EgressRule,
    EndpointSelector,
    IngressRule,
    PortRule,
    Rule,
)
from .mapstate import (
    Contribution,
    DIR_EGRESS,
    DIR_INGRESS,
    MapState,
    PROTO_ANY,
    PROTO_BY_NAME,
    PROTO_ICMP,
    PROTO_SCTP,
    PROTO_TCP,
    PROTO_UDP,
)
from .selectorcache import SelectorCache

# Base port for proxy redirect allocation (reference: pkg/proxy port
# allocator range).
PROXY_PORT_BASE = 10000


@dataclass
class EndpointPolicy:
    """Resolved policy for one subject identity (shared across endpoints
    with the same identity — reference: pkg/policy/distillery.go
    ``SelectorPolicy``/``PolicyCache``)."""

    subject_labels: LabelSet
    revision: int
    ingress: MapState
    egress: MapState
    # (proxy_port, rule_label, L7Rules) per redirect — the L7 proxy
    # compiles these into per-port request-verdict tensors
    redirects: List[Tuple[int, str, object]] = field(default_factory=list)

    def mapstate(self, direction: int) -> MapState:
        return self.ingress if direction == DIR_INGRESS else self.egress

    def lookup(self, direction: int, identity: int, proto: int,
               port: int) -> Tuple[int, int]:
        return self.mapstate(direction).lookup(identity, proto, port)

    def lookup_full(self, direction: int, identity: int, proto: int,
                    port: int) -> Tuple[int, int, bool]:
        """(verdict, proxy, auth_required) — see MapState.lookup_full."""
        return self.mapstate(direction).lookup_full(identity, proto,
                                                    port)


# Policy enforcement modes (reference: pkg/option PolicyEnforcement —
# "default" enforces iff a rule selects the endpoint, "always" is
# default-deny even with no rules, "never" disables enforcement).
ENFORCEMENT_DEFAULT = "default"
ENFORCEMENT_ALWAYS = "always"
ENFORCEMENT_NEVER = "never"
ENFORCEMENT_MODES = (ENFORCEMENT_DEFAULT, ENFORCEMENT_ALWAYS,
                     ENFORCEMENT_NEVER)


def with_enforcement(pol: EndpointPolicy, mode: str) -> EndpointPolicy:
    """Apply a policy-enforcement mode to a resolved policy.

    The mode is per ENDPOINT while the resolved policy is per identity
    (distillery sharing), so endpoints with non-default modes get
    their own derived policy — contribution lists are copied so
    incremental identity churn patches each variant independently."""
    if mode == ENFORCEMENT_DEFAULT:
        return pol
    if mode == ENFORCEMENT_ALWAYS:
        return EndpointPolicy(
            subject_labels=pol.subject_labels,
            revision=pol.revision,
            ingress=MapState(DIR_INGRESS, True,
                             list(pol.ingress.contributions)),
            egress=MapState(DIR_EGRESS, True,
                            list(pol.egress.contributions)),
            redirects=list(pol.redirects))
    if mode == ENFORCEMENT_NEVER:
        return EndpointPolicy(
            subject_labels=pol.subject_labels,
            revision=pol.revision,
            ingress=MapState(DIR_INGRESS, False, []),
            egress=MapState(DIR_EGRESS, False, []),
            redirects=[])
    raise ValueError(
        f"enforcement mode {mode!r} not in {ENFORCEMENT_MODES}")


# The "cluster" entity as a live selector: every identity NOT carrying
# reserved:world (reference: entity "cluster" covers all
# cluster-managed endpoints + host).  Expressed as a selector so
# identity churn updates cluster peer sets incrementally.
from .api import Requirement  # noqa: E402

CLUSTER_SELECTOR = EndpointSelector(
    match_expressions=(Requirement(key=f"{SOURCE_RESERVED}:world",
                                   operator="DoesNotExist"),))


@dataclass(frozen=True)
class PeerSet:
    """Resolved peer identities + the live selectors they came from
    (the selectors make the set incrementally updatable on churn)."""

    ids: Optional[FrozenSet[int]]  # None == wildcard peer
    selectors: Tuple[EndpointSelector, ...] = ()
    fqdn_patterns: Tuple[str, ...] = ()


def _peer_identities(
    selectors: Sequence[EndpointSelector],
    cidrs: Sequence[CIDRRule],
    entities: Sequence[str],
    selector_cache: SelectorCache,
    allocator: CachingIdentityAllocator,
    fqdns: Sequence[str] = (),
) -> PeerSet:
    """PeerSet(ids=None) == wildcard peer (no L3 constraint)."""
    if not selectors and not cidrs and not entities and not fqdns:
        return PeerSet(ids=None)
    ids: set = set()
    live: list = []
    patterns: list = []
    for sel in selectors:
        ids |= selector_cache.selections(sel)
        live.append(sel)
    for ent in entities:
        if ent in (ENTITY_ALL,):
            return PeerSet(ids=None)
        if ent == ENTITY_CLUSTER:
            world = Label(SOURCE_RESERVED, "world")
            ids |= {
                i.numeric_id for i in selector_cache.known_identities()
                if not i.labels.has(world)
            }
            live.append(CLUSTER_SELECTOR)
            continue
        sel = ENTITY_SELECTORS.get(ent)
        if sel is None:
            raise ValueError(f"unknown entity {ent!r}")
        ids |= selector_cache.selections(sel)
        live.append(sel)
    import ipaddress as _ip

    for c in cidrs:
        ident = allocator.allocate_cidr(c.cidr)
        ids.add(ident.numeric_id)
        # CIDR peers select by LABEL (r05, DIVERGENCES #8 closed):
        # every CIDR identity carries its parent-prefix labels, so a
        # fromCIDR range selects later-minted more-specific identities
        # (fqdn /32s, other rules' toCIDR) — with 'except' prefixes as
        # DoesNotExist requirements, exactly upstream's
        # cidrRuleToEndpointSelector translation.
        net = _ip.ip_network(c.cidr, strict=False)
        sel = EndpointSelector(
            match_labels=((f"cidr:{net}", ""),),
            match_expressions=tuple(
                Requirement(
                    key=f"cidr:{_ip.ip_network(e, strict=False)}",
                    operator="DoesNotExist")
                for e in c.except_cidrs))
        ids |= selector_cache.selections(sel)
        live.append(sel)
        # 'except' CIDRs allocate identities too so the ipcache can carve
        # them out; they are excluded from this peer set.
        for exc in c.except_cidrs:
            allocator.allocate_cidr(exc)
    # toFQDNs select identities carrying an fqdn:<name> label — created
    # by the DNS-proxy subsystem (reference: pkg/fqdn) as lookups are
    # observed.  Before any DNS activity the set is empty (deny), never
    # a wildcard.  matchPattern globs match against all observed fqdn
    # labels under the per-label ``*`` grammar (reference:
    # api.FQDNSelector.MatchPattern via pkg/fqdn/matchpattern).
    from ..fqdn.matchpattern import matches as _pat_matches

    for name in fqdns:
        if "*" in name:
            for ident in selector_cache.known_identities():
                for lab in ident.labels:
                    if lab.source == "fqdn" and _pat_matches(name,
                                                             lab.key):
                        ids.add(ident.numeric_id)
            patterns.append(name)
        else:
            sel = EndpointSelector.from_labels(f"fqdn:{name}")
            ids |= selector_cache.selections(sel)
            live.append(sel)
    return PeerSet(ids=frozenset(ids), selectors=tuple(live),
                   fqdn_patterns=tuple(patterns))


def _port_specs(to_ports: Sequence[PortRule], named_ports=None):
    """Expand toPorts into (dense_proto, lo, hi, l7_rules|None) tuples.

    ``named_ports`` (name -> number) resolves symbolic ports; a name
    with no mapping contributes nothing (matches upstream: the rule is
    inert until some endpoint defines the port name)."""
    if not to_ports:
        return [(PROTO_ANY, 0, 65535, None)]
    out = []
    for pr in to_ports:
        l7 = None if pr.rules.is_empty else pr.rules
        ports = pr.ports or ()
        if not ports:
            if l7 is not None:
                # an L7 section without ports still only applies to
                # port-bearing protocols — never ICMP/OTHER
                for p in (PROTO_TCP, PROTO_UDP, PROTO_SCTP):
                    out.append((p, 0, 65535, l7))
            else:
                out.append((PROTO_ANY, 0, 65535, None))
            continue
        for pp in ports:
            for lo, hi in pp.port_ranges(named_ports):
                proto = PROTO_BY_NAME.get(pp.protocol, PROTO_ANY)
                if proto == PROTO_ANY:
                    for p in (PROTO_TCP, PROTO_UDP, PROTO_SCTP):
                        out.append((p, lo, hi, l7))
                else:
                    out.append((proto, lo, hi, l7))
    return out


def resolve_policy(
    rules: Sequence[Rule],
    subject_labels: LabelSet,
    selector_cache: SelectorCache,
    allocator: CachingIdentityAllocator,
    revision: int = 0,
    proxy_port_for=None,
    named_ports=None,
    peer_named_ports=None,
) -> EndpointPolicy:
    """Resolve the rule set down to per-direction MapStates for a subject.

    ``proxy_port_for(key) -> port`` allocates redirect listener ports;
    the repository passes a persistent registry so ports are unique
    across ALL subjects' policies and stable across re-resolves
    (reference: pkg/proxy redirect lifecycle keeps ports across
    regenerations).  The default is a per-call counter (unit tests)."""
    ing = MapState(direction=DIR_INGRESS, enforcing=False)
    egr = MapState(direction=DIR_EGRESS, enforcing=False)
    redirects: List[Tuple[int, str, object]] = []
    if proxy_port_for is None:
        _counter = iter(range(PROXY_PORT_BASE, PROXY_PORT_BASE + 10000))

        def proxy_port_for(key: str) -> int:
            return next(_counter)

    subject_key = subject_labels.sorted_key()

    for rule in rules:
        if not rule.endpoint_selector.matches(subject_labels):
            continue
        if rule.enables_ingress:
            ing.enforcing = True
        if rule.enables_egress:
            egr.enforcing = True
        label = ",".join(rule.labels) or rule.description

        def emit(ms: MapState, peers: PeerSet,
                 to_ports, is_deny: bool, auth: bool = False) -> None:
            # named ports are direction-relative (reference): ingress
            # names the SUBJECT's own container ports; egress names the
            # DESTINATION's, which could be any pod — the node-wide
            # multimap expands every binding of the name
            np = (named_ports if ms.direction == DIR_INGRESS
                  else peer_named_ports)
            for proto, lo, hi, l7 in _port_specs(to_ports, np):
                redirect = l7 is not None and not is_deny
                proxy_port = 0
                if redirect:
                    proxy_port = proxy_port_for(
                        f"{subject_key}|{label}|{ms.direction}|"
                        f"{proto}:{lo}-{hi}")
                    redirects.append((proxy_port, label, l7))
                ms.contributions.append(Contribution(
                    is_deny=is_deny,
                    auth=auth and not is_deny,
                    identities=peers.ids,
                    proto=proto,
                    lo=lo,
                    hi=hi,
                    redirect=redirect,
                    proxy_port=proxy_port,
                    rule_label=label,
                    selectors=peers.selectors,
                    fqdn_patterns=peers.fqdn_patterns,
                ))

        for r in rule.ingress:
            peers = _peer_identities(r.from_endpoints, r.from_cidr,
                                     r.from_entities, selector_cache,
                                     allocator)
            emit(ing, peers, r.to_ports, is_deny=False,
                 auth=r.auth_mode == "required")
        for r in rule.ingress_deny:
            peers = _peer_identities(r.from_endpoints, r.from_cidr,
                                     r.from_entities, selector_cache,
                                     allocator)
            emit(ing, peers, r.to_ports, is_deny=True)
        for r in rule.egress:
            peers = _peer_identities(r.to_endpoints, r.to_cidr,
                                     r.to_entities, selector_cache,
                                     allocator, fqdns=r.to_fqdns)
            emit(egr, peers, r.to_ports, is_deny=False,
                 auth=r.auth_mode == "required")
        for r in rule.egress_deny:
            peers = _peer_identities(r.to_endpoints, r.to_cidr,
                                     r.to_entities, selector_cache,
                                     allocator, fqdns=r.to_fqdns)
            emit(egr, peers, r.to_ports, is_deny=True)

    return EndpointPolicy(
        subject_labels=subject_labels,
        revision=revision,
        ingress=ing,
        egress=egr,
        redirects=redirects,
    )
