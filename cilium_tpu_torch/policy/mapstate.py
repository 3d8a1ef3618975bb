"""MapState: the desired per-endpoint policy-map contents + the verdict
oracle implementing eBPF lookup semantics.

Reference: upstream cilium ``pkg/policy/mapstate.go`` (``MapState``,
keys ``{identity, dport, proto, direction}`` -> entries with
deny/redirect flags) and ``bpf/lib/policy.h``'s
``__policy_can_access`` lookup order (exact -> L3-only -> L4-wildcard ->
all-wildcard, deny precedence).

Verdict semantics implemented here (and compiled into the dense tensors
by :mod:`cilium_tpu_torch.policy.compiler`):

1. If any matching **deny** contribution covers ``(identity, proto,
   port)`` -> DENY.  (Deny always wins — reference: deny rules 1.9+.)
2. Else if any matching **allow** contribution covers it -> ALLOW, or
   REDIRECT when the allow carries L7 rules (proxy redirect).
3. Else: default-deny if any rule selects this endpoint for that
   direction, default-allow otherwise (policy enforcement "default"
   mode — reference: option.DefaultEnforcement).

``MapState.lookup`` is the **oracle** for the divergence suite: the
TPU datapath must agree with it on every packet (target <=1%,
BASELINE.md; we gate at 0%).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Tuple

# Verdict codes surfaced by the datapath (u8 on device).
VERDICT_DEFAULT_DENY = 0
VERDICT_ALLOW = 1
VERDICT_DENY = 2
VERDICT_REDIRECT = 3

# Dense proto indices used on-device (IP proto -> dense via table).
# OTHER buckets every IP proto without port semantics (GRE, ESP, ...):
# only portless (L3) contributions can match it.
PROTO_TCP = 0
PROTO_UDP = 1
PROTO_ICMP = 2
PROTO_SCTP = 3
PROTO_OTHER = 4
PROTO_ANY = -1  # host-side wildcard marker
N_PROTO = 5

IP_PROTO_NUMBERS = {PROTO_TCP: 6, PROTO_UDP: 17, PROTO_ICMP: 1,
                    PROTO_SCTP: 132}
PROTO_BY_NAME = {"TCP": PROTO_TCP, "UDP": PROTO_UDP, "ICMP": PROTO_ICMP,
                 "SCTP": PROTO_SCTP, "ANY": PROTO_ANY}
PROTO_NAMES = {v: k for k, v in PROTO_BY_NAME.items()}
PROTO_NAMES[PROTO_OTHER] = "OTHER"

DIR_INGRESS = 0
DIR_EGRESS = 1


@dataclass(frozen=True)
class Contribution:
    """One (peer-set x port-spec) grant/deny derived from a rule.

    ``identities`` is None for an L3-wildcard peer (rule had no peer
    constraint, or explicitly selected all).  ``proto`` is a dense proto
    index or PROTO_ANY.  ``lo``/``hi`` is an inclusive dport range
    ([0, 65535] = all ports; for ICMP the range is over icmp type).

    ``selectors``/``fqdn_patterns`` record WHERE the identity set came
    from (the label selectors + fqdn matchPattern globs whose
    selections were unioned in), so identity churn can be applied
    incrementally: a new identity joins the frozen set iff it matches
    one of them (reference: L4Filter holds CachedSelectors and receives
    SelectorCache delta notifications).  CIDR-derived members are
    static (resolved by ipcache/LPM, not by labels).
    """

    is_deny: bool
    identities: Optional[FrozenSet[int]]  # None == wildcard peer
    proto: int
    lo: int
    hi: int
    redirect: bool = False
    proxy_port: int = 0
    # mutual authentication required before this grant forwards
    # (reference: api.Rule Authentication -> MapStateEntry auth type)
    auth: bool = False
    rule_label: str = ""
    selectors: Tuple = ()  # Tuple[EndpointSelector, ...]
    fqdn_patterns: Tuple[str, ...] = ()

    def covers(self, identity: int, proto: int, port: int) -> bool:
        if self.identities is not None and identity not in self.identities:
            return False
        if self.proto != PROTO_ANY and self.proto != proto:
            return False
        return self.lo <= port <= self.hi

    def selects_labels(self, labels) -> bool:
        """Would an identity with these labels belong to the peer set?
        (The incremental-membership test; wildcard peers select all.)"""
        from ..fqdn.matchpattern import matches as _pat_matches

        if self.identities is None:
            return True
        if any(sel.matches(labels) for sel in self.selectors):
            return True
        for pat in self.fqdn_patterns:
            for lab in labels:
                if lab.source == "fqdn" and _pat_matches(pat, lab.key):
                    return True
        return False


@dataclass(frozen=True)
class PolicyKey:
    """A cilium policymap-style key, for display/diff (bpf policy get)."""

    direction: int
    identity: int  # 0 == any
    proto: int  # PROTO_ANY == any
    dport_lo: int
    dport_hi: int


@dataclass(frozen=True)
class PolicyEntry:
    verdict: int
    proxy_port: int = 0
    derived_from: Tuple[str, ...] = ()


@dataclass
class MapState:
    """Desired policy state for one direction of one endpoint."""

    direction: int
    enforcing: bool  # False => default-allow (no rule selects endpoint)
    contributions: List[Contribution] = field(default_factory=list)

    def lookup(self, identity: int, proto: int, port: int
               ) -> Tuple[int, int]:
        """Oracle verdict: returns (verdict, proxy_port)."""
        v, p, _a = self.lookup_full(identity, proto, port)
        return v, p

    def lookup_full(self, identity: int, proto: int, port: int
                    ) -> Tuple[int, int, bool]:
        """(verdict, proxy_port, auth_required) — auth is the WINNING
        allow contribution's flag (denies and default verdicts never
        require auth; there is nothing to gate)."""
        allow: Optional[Contribution] = None
        for c in self.contributions:
            if not c.covers(identity, proto, port):
                continue
            if c.is_deny:
                return VERDICT_DENY, 0, False
            if allow is None or (c.redirect and not allow.redirect):
                allow = c
        if allow is not None:
            if allow.redirect:
                return VERDICT_REDIRECT, allow.proxy_port, allow.auth
            return VERDICT_ALLOW, 0, allow.auth
        if self.enforcing:
            return VERDICT_DEFAULT_DENY, 0, False
        return VERDICT_ALLOW, 0, False

    def to_entries(self) -> Dict[PolicyKey, PolicyEntry]:
        """Materialize cilium-style map entries (for CLI/diff display)."""
        out: Dict[PolicyKey, PolicyEntry] = {}
        for c in self.contributions:
            ids = sorted(c.identities) if c.identities is not None else [0]
            for ident in ids:
                key = PolicyKey(self.direction, ident, c.proto, c.lo, c.hi)
                verdict = (VERDICT_DENY if c.is_deny
                           else VERDICT_REDIRECT if c.redirect
                           else VERDICT_ALLOW)
                prev = out.get(key)
                if prev is not None and prev.verdict == VERDICT_DENY:
                    continue  # deny sticks
                out[key] = PolicyEntry(
                    verdict=verdict,
                    proxy_port=c.proxy_port,
                    derived_from=(c.rule_label,) if c.rule_label else (),
                )
        return out
