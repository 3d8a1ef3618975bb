"""Policy rule schema — accepts cilium's rule JSON/YAML ~verbatim.

Reference: upstream cilium ``pkg/policy/api`` (``Rule``,
``EndpointSelector``, ``IngressRule``/``EgressRule``, ``PortRule``,
``CIDRRule``, entities, deny rules, L7 ``PortRuleHTTP``/``PortRuleDNS``).

The dict format handled by :func:`rule_from_dict` matches what
``cilium policy import`` accepts (and what a CiliumNetworkPolicy spec
carries), so reference policy sets replay unchanged — a requirement for
the verdict-divergence gate in BASELINE.md.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..labels import Label, LabelSet, SOURCE_ANY, SOURCE_RESERVED

# ---------------------------------------------------------------------------
# Selectors


@dataclass(frozen=True)
class Requirement:
    """One matchExpressions entry (k8s LabelSelectorRequirement)."""

    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist
    values: Tuple[str, ...] = ()


@dataclass(frozen=True)
class EndpointSelector:
    """Label selector over endpoint identities.

    Reference: pkg/policy/api ``EndpointSelector`` wrapping a k8s
    LabelSelector.  ``match_labels`` keys may carry a source prefix
    (``k8s:app`` / ``reserved:host``/ ``any:app``); bare keys default to
    ``any``.
    """

    match_labels: Tuple[Tuple[str, str], ...] = ()
    match_expressions: Tuple[Requirement, ...] = ()

    @staticmethod
    def from_dict(d: Optional[dict]) -> "EndpointSelector":
        if not d:
            return EndpointSelector()  # empty selector == wildcard
        ml = tuple(sorted((str(k), str(v))
                          for k, v in (d.get("matchLabels") or {}).items()))
        me = []
        for e in d.get("matchExpressions") or ():
            if e["operator"] not in ("In", "NotIn", "Exists", "DoesNotExist"):
                raise ValueError(
                    f"unknown matchExpressions operator {e['operator']!r}")
            me.append(Requirement(
                key=e["key"],
                operator=e["operator"],
                values=tuple(e.get("values") or ()),
            ))
        me = tuple(me)
        return EndpointSelector(match_labels=ml, match_expressions=me)

    @staticmethod
    def from_labels(*labels: str) -> "EndpointSelector":
        return EndpointSelector(
            match_labels=tuple(sorted(_split_kv(l) for l in labels))
        )

    @property
    def is_wildcard(self) -> bool:
        return not self.match_labels and not self.match_expressions

    def matches(self, labels: LabelSet) -> bool:
        for raw_key, value in self.match_labels:
            sel = _selector_label(raw_key, value)
            if not labels.has(sel):
                return False
        for req in self.match_expressions:
            source, key = _split_source(req.key)
            found = labels.get(source, key)
            if req.operator == "Exists":
                if found is None:
                    return False
            elif req.operator == "DoesNotExist":
                if found is not None:
                    return False
            elif req.operator == "In":
                if found is None or found.value not in req.values:
                    return False
            elif req.operator == "NotIn":
                if found is not None and found.value in req.values:
                    return False
            else:
                raise ValueError(f"unknown operator {req.operator!r}")
        return True


def _split_source(raw_key: str) -> Tuple[str, str]:
    if ":" in raw_key:
        source, key = raw_key.split(":", 1)
        return source, key
    return SOURCE_ANY, raw_key


def _split_kv(s: str) -> Tuple[str, str]:
    if "=" in s:
        k, v = s.split("=", 1)
        return k, v
    return s, ""


def _selector_label(raw_key: str, value: str) -> Label:
    source, key = _split_source(raw_key)
    return Label(source=source, key=key, value=value)


# ---------------------------------------------------------------------------
# Entities (reference: pkg/policy/api entities — named peers)

Entity = str
ENTITY_ALL = "all"
ENTITY_WORLD = "world"
ENTITY_HOST = "host"
ENTITY_CLUSTER = "cluster"
ENTITY_REMOTE_NODE = "remote-node"
ENTITY_HEALTH = "health"
ENTITY_INIT = "init"
ENTITY_KUBE_APISERVER = "kube-apiserver"
ENTITY_INGRESS = "ingress"

ENTITY_SELECTORS: Dict[str, EndpointSelector] = {
    ENTITY_ALL: EndpointSelector(),
    ENTITY_WORLD: EndpointSelector.from_labels(f"{SOURCE_RESERVED}:world"),
    ENTITY_HOST: EndpointSelector.from_labels(f"{SOURCE_RESERVED}:host"),
    ENTITY_REMOTE_NODE: EndpointSelector.from_labels(
        f"{SOURCE_RESERVED}:remote-node"),
    ENTITY_HEALTH: EndpointSelector.from_labels(f"{SOURCE_RESERVED}:health"),
    ENTITY_INIT: EndpointSelector.from_labels(f"{SOURCE_RESERVED}:init"),
    ENTITY_KUBE_APISERVER: EndpointSelector.from_labels(
        f"{SOURCE_RESERVED}:kube-apiserver"),
    ENTITY_INGRESS: EndpointSelector.from_labels(f"{SOURCE_RESERVED}:ingress"),
}


# ---------------------------------------------------------------------------
# L4 / L7


import re as _re

# k8s IANA_SVC_NAME: lowercase alnum + '-', <=15 chars, at least one
# letter, no leading/trailing/double '-'
_NAMED_PORT_RE = _re.compile(
    r"(?=.*[a-z])(?!-)(?!.*--)[a-z0-9-]{1,15}(?<!-)")


@dataclass(frozen=True)
class PortProtocol:
    """One port+protocol spec.

    ICMP semantics (deliberate, documented): for ``protocol: ICMP`` the
    ``port`` value is the **ICMP type** — the datapath carries the ICMP
    type in the dport column (core/packets.py COL_DPORT) and ICMP owns
    its own dense proto class row, so a TCP port-80 rule and an ICMP
    type-8 rule never share table entries.  The upstream ``icmps`` rule
    field (reference: api.ICMPRule, cilium 1.12+) parses into exactly
    this form.  ``protocol: ANY`` never covers ICMP (matches upstream:
    port rules expand to TCP/UDP/SCTP only)."""

    port: str  # numeric string or named port; "0" or "" == all ports
    protocol: str = "ANY"  # TCP | UDP | SCTP | ICMP | ANY
    end_port: int = 0  # inclusive range end (0 = single port)
    # exact ICMP type from an `icmps` rule; distinguishes type 0 (echo
    # reply) from the "port 0 == all" wildcard convention above
    icmp_type: Optional[int] = None

    @staticmethod
    def from_dict(d: dict) -> "PortProtocol":
        """Parse + sanitize (reference: api.Rule.Sanitize rejects bad
        ports at import time, not resolve time).  Named ports (k8s
        IANA_SVC_NAME: lowercase alphanumeric + '-', <= 15 chars, at
        least one letter) are kept symbolic and resolved against the
        endpoint port registry at resolve time."""
        port = str(d.get("port", "0"))
        end_port = int(d.get("endPort", 0))
        try:
            port_num = int(port or 0)
        except ValueError:
            if not _NAMED_PORT_RE.fullmatch(port):
                raise ValueError(
                    f"invalid port {port!r}: not numeric and not a "
                    "valid named port") from None
            if end_port:
                raise ValueError("endPort cannot combine with a named "
                                 f"port {port!r}")
            port_num = None
        if port_num is not None and not 0 <= port_num <= 65535:
            raise ValueError(f"port {port_num} out of range")
        if end_port and port_num is not None and end_port < port_num:
            raise ValueError(
                f"endPort {end_port} must be >= port {port_num}")
        protocol = str(d.get("protocol", "ANY")).upper()
        if protocol not in ("TCP", "UDP", "SCTP", "ICMP", "ANY"):
            raise ValueError(f"unknown protocol {protocol!r}")
        icmp_type = d.get("icmpType")
        if icmp_type is not None and protocol != "ICMP":
            raise ValueError(
                f"icmpType is only valid with protocol ICMP, got "
                f"{protocol!r}")
        return PortProtocol(port=port, protocol=protocol,
                            end_port=end_port,
                            icmp_type=(int(icmp_type)
                                       if icmp_type is not None else None))

    @property
    def is_named(self) -> bool:
        try:
            int(self.port or 0)
            return False
        except ValueError:
            return True

    def port_range(self, named_ports=None) -> Optional[Tuple[int, int]]:
        """Resolve to one inclusive [lo, hi] numeric port range (first
        of :meth:`port_ranges`, or None when the spec matches
        nothing)."""
        ranges = self.port_ranges(named_ports)
        return ranges[0] if ranges else None

    def port_ranges(self, named_ports=None) -> List[Tuple[int, int]]:
        """Resolve to inclusive [lo, hi] numeric port ranges.

        A named port resolves through ``named_ports`` — name -> number
        for an endpoint's own ports (ingress), or name -> iterable of
        numbers for the node-wide multimap (egress: the destination
        could be any pod, so every binding of the name gets an entry;
        reference: NamedPortMultiMap).  Unresolvable names return []
        and the spec matches nothing (policy with unknown named ports
        selects no traffic until a pod defines the name)."""
        if self.icmp_type is not None:
            return [(self.icmp_type, self.icmp_type)]
        try:
            p = int(self.port or 0)
        except ValueError:
            num = (named_ports or {}).get(self.port)
            if num is None:
                return []
            if isinstance(num, (int, str)):
                return [(int(num), int(num))]
            return [(int(n), int(n)) for n in sorted(num)]
        if p == 0:
            return [(0, 65535)]
        return [(p, self.end_port if self.end_port else p)]


@dataclass(frozen=True)
class PortRuleHTTP:
    method: str = ""
    path: str = ""
    host: str = ""
    headers: Tuple[str, ...] = ()

    @staticmethod
    def from_dict(d: dict) -> "PortRuleHTTP":
        return PortRuleHTTP(
            method=d.get("method", ""),
            path=d.get("path", ""),
            host=d.get("host", ""),
            headers=tuple(d.get("headers") or ()),
        )


@dataclass(frozen=True)
class PortRuleDNS:
    match_name: str = ""
    match_pattern: str = ""

    @staticmethod
    def from_dict(d: dict) -> "PortRuleDNS":
        return PortRuleDNS(
            match_name=d.get("matchName", ""),
            match_pattern=d.get("matchPattern", ""),
        )


@dataclass(frozen=True)
class L7Rules:
    http: Tuple[PortRuleHTTP, ...] = ()
    dns: Tuple[PortRuleDNS, ...] = ()
    kafka: Tuple[dict, ...] = ()  # schema passthrough
    # plugin protocols (proxy/registry.py): ((kind_name, (rule, ...)),
    # ...) — schema keys beyond the three built-ins pass through to
    # whatever parser plugin registered that name (reference:
    # api.PortRuleL7 "l7proto" + proxylib plugin rules)
    extra: Tuple[Tuple[str, Tuple[dict, ...]], ...] = ()

    @property
    def is_empty(self) -> bool:
        return not (self.http or self.dns or self.kafka or self.extra)

    @property
    def extra_by_name(self) -> Dict[str, Tuple[dict, ...]]:
        return dict(self.extra)

    @staticmethod
    def from_dict(d: Optional[dict]) -> "L7Rules":
        if not d:
            return L7Rules()
        d = dict(d)
        # upstream api.PortRuleL7 spells plugin rules as
        # {"l7proto": "<parser>", "l7": [rule, ...]}; normalize to the
        # keyed-by-parser form
        proto_name = d.pop("l7proto", None)
        l7_list = d.pop("l7", None)
        extra_items: dict = {}
        if proto_name:
            extra_items[str(proto_name)] = list(l7_list or ())
        for k, v in d.items():
            if k in ("http", "dns", "kafka") or not v:
                continue
            if not isinstance(v, (list, tuple)):
                raise ValueError(
                    f"L7 rules for {k!r} must be a list of rule "
                    f"objects, got {type(v).__name__}")
            extra_items.setdefault(str(k), []).extend(v)
        extra = tuple(
            (k, tuple(dict(x) for x in rules))
            for k, rules in sorted(extra_items.items()) if rules)
        return L7Rules(
            http=tuple(PortRuleHTTP.from_dict(x) for x in d.get("http") or ()),
            dns=tuple(PortRuleDNS.from_dict(x) for x in d.get("dns") or ()),
            kafka=tuple(dict(x) for x in d.get("kafka") or ()),
            extra=extra,
        )


@dataclass(frozen=True)
class PortRule:
    ports: Tuple[PortProtocol, ...] = ()
    rules: L7Rules = field(default_factory=L7Rules)

    @staticmethod
    def from_dict(d: dict) -> "PortRule":
        return PortRule(
            ports=tuple(PortProtocol.from_dict(p) for p in d.get("ports") or ()),
            rules=L7Rules.from_dict(d.get("rules")),
        )


def _icmp_port_rules(icmps) -> Tuple[PortRule, ...]:
    """Upstream ``icmps`` field -> PortRules with protocol ICMP.

    Reference schema (api.ICMPRule): ``[{fields: [{type: 8, family:
    "IPv4"}]}]``.  ICMPv4 and ICMPv6 share one dense proto class here
    (compiler.make_proto_table maps both 1 and 58 to PROTO_ICMP), so
    family only validates."""
    out = []
    for icmp in icmps or ():
        ports = []
        for f in icmp.get("fields") or ():
            fam = str(f.get("family", "IPv4"))
            if fam not in ("IPv4", "IPv6", "4", "6"):
                raise ValueError(f"unknown ICMP family {fam!r}")
            t = int(f.get("type", 0))
            if not 0 <= t <= 255:
                raise ValueError(f"ICMP type {t} out of range")
            ports.append(PortProtocol(port=str(t), protocol="ICMP",
                                      icmp_type=t))
        if ports:
            out.append(PortRule(ports=tuple(ports)))
    return tuple(out)


# ---------------------------------------------------------------------------
# CIDR


@dataclass(frozen=True)
class CIDRRule:
    cidr: str
    except_cidrs: Tuple[str, ...] = ()

    @staticmethod
    def from_obj(obj) -> "CIDRRule":
        if isinstance(obj, str):
            return CIDRRule(cidr=obj)
        if obj.get("cidrGroupRef"):
            # like toServices: silently dropping the ref would leave
            # the entry peer-less (an L3 wildcard).  The k8s layer
            # expands group refs against the live CiliumCIDRGroup
            # cache (upstream pkg/policy api CIDRGroupRef).
            raise ValueError(
                "cidrGroupRef must be expanded against the "
                "CiliumCIDRGroup cache: import the policy as a "
                "CiliumNetworkPolicy through the k8s watcher path")
        return CIDRRule(
            cidr=obj["cidr"],
            except_cidrs=tuple(obj.get("except") or ()),
        )


def _fqdn_from_obj(obj) -> str:
    """One toFQDNs entry -> name or glob pattern string.

    Reference: api.FQDNSelector has matchName (exact) and matchPattern
    (glob, ``*`` wildcards).  Patterns keep their ``*`` and are matched
    under the per-label grammar (fqdn/matchpattern.py) against
    observed fqdn labels at resolve time.
    """
    if isinstance(obj, str):
        return obj
    name = obj.get("matchName")
    if name:
        return name
    pattern = obj.get("matchPattern")
    if pattern:
        return pattern
    raise ValueError(f"toFQDNs entry needs matchName or matchPattern: {obj}")


# ---------------------------------------------------------------------------
# Ingress / Egress rules

AUTH_MODES = ("", "required", "disabled")


def _auth_mode(d: dict) -> str:
    """Rule-level mutual authentication (reference: api.Rule
    Authentication, cilium 1.14+ pkg/auth): ``required`` gates the
    entry's allows behind a live authmap entry; ``disabled``
    explicitly opts out.  Unknown modes are rejected — silently
    ignoring one would drop the operator's auth requirement."""
    auth = d.get("authentication")
    if not auth:
        return ""
    mode = str(auth.get("mode", ""))
    if mode not in AUTH_MODES:
        raise ValueError(f"unknown authentication mode {mode!r}")
    return mode


@dataclass(frozen=True)
class IngressRule:
    from_endpoints: Tuple[EndpointSelector, ...] = ()
    from_cidr: Tuple[CIDRRule, ...] = ()
    from_entities: Tuple[Entity, ...] = ()
    to_ports: Tuple[PortRule, ...] = ()
    auth_mode: str = ""  # "" | "required" | "disabled"

    @staticmethod
    def from_dict(d: dict) -> "IngressRule":
        return IngressRule(
            auth_mode=_auth_mode(d),
            from_endpoints=tuple(EndpointSelector.from_dict(s)
                                 for s in d.get("fromEndpoints") or ()),
            from_cidr=tuple(CIDRRule.from_obj(c)
                            for c in (d.get("fromCIDR") or ())) +
                      tuple(CIDRRule.from_obj(c)
                            for c in (d.get("fromCIDRSet") or ())),
            from_entities=tuple(d.get("fromEntities") or ()),
            to_ports=tuple(PortRule.from_dict(p)
                           for p in d.get("toPorts") or ()) +
                     _icmp_port_rules(d.get("icmps")),
        )

    @property
    def peer_is_wildcard(self) -> bool:
        """True when no L3 peer constraint at all (L4-only rule)."""
        return not (self.from_endpoints or self.from_cidr or self.from_entities)


@dataclass(frozen=True)
class EgressRule:
    to_endpoints: Tuple[EndpointSelector, ...] = ()
    to_cidr: Tuple[CIDRRule, ...] = ()
    to_entities: Tuple[Entity, ...] = ()
    to_ports: Tuple[PortRule, ...] = ()
    to_fqdns: Tuple[str, ...] = ()
    auth_mode: str = ""  # "" | "required" | "disabled"

    @staticmethod
    def from_dict(d: dict) -> "EgressRule":
        if d.get("toServices"):
            # silently ignoring this key would turn the entry into an
            # L3 WILDCARD (allow-to-everything) — the opposite of the
            # author's intent.  Upstream's k8s layer translates
            # toServices to toCIDRSet against the live service cache
            # (pkg/k8s TranslateToServicesRule); ours does too.
            raise ValueError(
                "toServices must be expanded against the k8s service "
                "cache: import the policy as a CiliumNetworkPolicy "
                "through the k8s watcher path")
        return EgressRule(
            auth_mode=_auth_mode(d),
            to_endpoints=tuple(EndpointSelector.from_dict(s)
                               for s in d.get("toEndpoints") or ()),
            to_cidr=tuple(CIDRRule.from_obj(c)
                          for c in (d.get("toCIDR") or ())) +
                    tuple(CIDRRule.from_obj(c)
                          for c in (d.get("toCIDRSet") or ())),
            to_entities=tuple(d.get("toEntities") or ()),
            to_ports=tuple(PortRule.from_dict(p)
                           for p in d.get("toPorts") or ()) +
                     _icmp_port_rules(d.get("icmps")),
            to_fqdns=tuple(_fqdn_from_obj(f) for f in (d.get("toFQDNs")
                                                       or ())),
        )

    @property
    def peer_is_wildcard(self) -> bool:
        return not (self.to_endpoints or self.to_cidr or self.to_entities
                    or self.to_fqdns)


# ---------------------------------------------------------------------------
# Rule


@dataclass(frozen=True)
class Rule:
    """One policy rule (reference: pkg/policy/api ``Rule``).

    ``endpoint_selector`` picks the *subject* endpoints; ingress/egress
    lists grant traffic; the deny variants (reference: 1.9+ deny rules)
    take precedence over any allow at the same or broader scope.
    """

    endpoint_selector: EndpointSelector
    ingress: Tuple[IngressRule, ...] = ()
    egress: Tuple[EgressRule, ...] = ()
    ingress_deny: Tuple[IngressRule, ...] = ()
    egress_deny: Tuple[EgressRule, ...] = ()
    labels: Tuple[str, ...] = ()
    description: str = ""

    @property
    def enables_ingress(self) -> bool:
        return bool(self.ingress or self.ingress_deny)

    @property
    def enables_egress(self) -> bool:
        return bool(self.egress or self.egress_deny)


def rule_from_dict(d: dict) -> Rule:
    sel = d.get("endpointSelector")
    if sel is None and "nodeSelector" in d:
        sel = d["nodeSelector"]
    return Rule(
        endpoint_selector=EndpointSelector.from_dict(sel),
        ingress=tuple(IngressRule.from_dict(r) for r in d.get("ingress") or ()),
        egress=tuple(EgressRule.from_dict(r) for r in d.get("egress") or ()),
        ingress_deny=tuple(IngressRule.from_dict(r)
                           for r in d.get("ingressDeny") or ()),
        egress_deny=tuple(EgressRule.from_dict(r)
                          for r in d.get("egressDeny") or ()),
        labels=tuple(str(l) for l in d.get("labels") or ()),
        description=d.get("description", ""),
    )


def rules_from_obj(obj) -> List[Rule]:
    """Accept a single rule dict, a list of rules, or a
    CiliumNetworkPolicy object (`cilium policy import` takes all
    three; CNPs route through the k8s translation layer)."""
    if isinstance(obj, dict):
        if obj.get("kind") in ("CiliumNetworkPolicy",
                               "CiliumClusterwideNetworkPolicy"):
            from ..k8s import rules_from_cnp

            return rules_from_cnp(obj)
        return [rule_from_dict(obj)]
    out: List[Rule] = []
    for d in obj:
        out.extend(rules_from_obj(d))
    return out


# ---------------------------------------------------------------------------
# Serialization (GET /policy renders the repository back as JSON)


def _selector_to_dict(sel: EndpointSelector) -> dict:
    d: dict = {}
    if sel.match_labels:
        d["matchLabels"] = {k: v for k, v in sel.match_labels}
    if sel.match_expressions:
        d["matchExpressions"] = [
            {"key": r.key, "operator": r.operator,
             **({"values": list(r.values)} if r.values else {})}
            for r in sel.match_expressions]
    return d


def _ports_to_dict(pr: PortRule) -> dict:
    d: dict = {"ports": [
        {"port": p.port, "protocol": p.protocol,
         **({"endPort": p.end_port} if p.end_port else {}),
         # extension key so exact ICMP types (esp. type 0) survive the
         # serialize -> import round trip (checkpoint saves rules as
         # JSON); absent for plain port rules, ignored by upstream
         **({"icmpType": p.icmp_type} if p.icmp_type is not None else {})}
        for p in pr.ports]}
    rules: dict = {}
    if pr.rules.http:
        rules["http"] = [
            {k: v for k, v in (("method", h.method), ("path", h.path),
                               ("host", h.host)) if v}
            for h in pr.rules.http]
    if pr.rules.dns:
        rules["dns"] = [
            {k: v for k, v in (("matchName", x.match_name),
                               ("matchPattern", x.match_pattern)) if v}
            for x in pr.rules.dns]
    if pr.rules.kafka:
        rules["kafka"] = [dict(x) for x in pr.rules.kafka]
    if rules:
        d["rules"] = rules
    return d


def _ingress_to_dict(r: IngressRule) -> dict:
    d: dict = {}
    if r.from_endpoints:
        d["fromEndpoints"] = [_selector_to_dict(s) for s in r.from_endpoints]
    if r.from_cidr:
        d["fromCIDRSet"] = [
            {"cidr": c.cidr,
             **({"except": list(c.except_cidrs)} if c.except_cidrs else {})}
            for c in r.from_cidr]
    if r.from_entities:
        d["fromEntities"] = list(r.from_entities)
    if r.to_ports:
        d["toPorts"] = [_ports_to_dict(p) for p in r.to_ports]
    if r.auth_mode:
        d["authentication"] = {"mode": r.auth_mode}
    return d


def _egress_to_dict(r: EgressRule) -> dict:
    d: dict = {}
    if r.to_endpoints:
        d["toEndpoints"] = [_selector_to_dict(s) for s in r.to_endpoints]
    if r.to_cidr:
        d["toCIDRSet"] = [
            {"cidr": c.cidr,
             **({"except": list(c.except_cidrs)} if c.except_cidrs else {})}
            for c in r.to_cidr]
    if r.to_entities:
        d["toEntities"] = list(r.to_entities)
    if r.to_fqdns:
        d["toFQDNs"] = [
            ({"matchPattern": f} if "*" in f else {"matchName": f})
            for f in r.to_fqdns]
    if r.to_ports:
        d["toPorts"] = [_ports_to_dict(p) for p in r.to_ports]
    if r.auth_mode:
        d["authentication"] = {"mode": r.auth_mode}
    return d


def rule_to_dict(rule: Rule) -> dict:
    d: dict = {"endpointSelector": _selector_to_dict(rule.endpoint_selector)}
    if rule.ingress:
        d["ingress"] = [_ingress_to_dict(r) for r in rule.ingress]
    if rule.ingress_deny:
        d["ingressDeny"] = [_ingress_to_dict(r) for r in rule.ingress_deny]
    if rule.egress:
        d["egress"] = [_egress_to_dict(r) for r in rule.egress]
    if rule.egress_deny:
        d["egressDeny"] = [_egress_to_dict(r) for r in rule.egress_deny]
    if rule.labels:
        d["labels"] = list(rule.labels)
    if rule.description:
        d["description"] = rule.description
    return d
