"""k8s integration: CiliumNetworkPolicy objects -> repository rules.

Reference: the JAX package's ``k8s/__init__.py`` (itself upstream
cilium ``pkg/k8s``: ``apis/cilium.io/v2`` CiliumNetworkPolicy with
``spec``/``specs``, translated into ``api.Rule`` lists as
``pkg/k8s/apis/cilium.io/v2.ParseToCiliumRule`` does).  This module is
the translation layer alone: it accepts CNP-shaped dicts (parsed YAML/
JSON) and produces repository mutations; the watchers (``watchers.py``)
drive it from an event stream.  The informer is not ported (ROADMAP
A20).

Namespace semantics (mirroring ParseToCiliumRule):

- the subject endpointSelector gains
  ``k8s:io.kubernetes.pod.namespace=<ns>`` unless it already
  constrains the namespace;
- ``fromEndpoints``/``toEndpoints`` selectors likewise default to the
  policy's namespace unless they name one, carry a
  ``namespaceSelector`` (compiled to namespace-label matches — see
  ``_selector_in_namespace``), or already match namespace labels;
- every derived rule carries identity labels
  ``k8s:io.cilium.k8s.policy.name/namespace/uid`` so delete-by-labels
  removes exactly this CNP's rules.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..policy.api import Rule, rule_from_dict

NS_LABEL = "io.kubernetes.pod.namespace"
# namespace OBJECT labels folded into pod identities (reference:
# k8s.GetPodMetadata + policy.JoinPath) — what namespaceSelector
# peers compile down to
NS_LABELS_PREFIX = "io.cilium.k8s.namespace.labels."
POLICY_NAME_LABEL = "k8s:io.cilium.k8s.policy.name"
POLICY_NS_LABEL = "k8s:io.cilium.k8s.policy.namespace"
POLICY_UID_LABEL = "k8s:io.cilium.k8s.policy.uid"


def _selector_in_namespace(sel: Optional[dict], ns: str) -> dict:
    """Scope a (possibly empty) selector dict to the namespace unless
    it already constrains it.

    A ``namespaceSelector`` key (k8s NetworkPolicyPeer style) compiles
    to ``k8s:io.cilium.k8s.namespace.labels.<key>`` matches — the
    labels the pod watcher folds in from Namespace objects — and lifts
    the default same-namespace scoping (reference:
    parseNetworkPolicyPeer's namespaceSelector handling)."""
    sel = dict(sel or {})
    ml = dict(sel.get("matchLabels") or {})
    me = list(sel.get("matchExpressions") or ())
    nssel = sel.get("namespaceSelector")
    ns_constrained = nssel is not None
    if nssel:
        for k, v in (nssel.get("matchLabels") or {}).items():
            ml[f"k8s:{NS_LABELS_PREFIX}{k}"] = v
        for e in nssel.get("matchExpressions") or ():
            e = dict(e)
            e["key"] = f"k8s:{NS_LABELS_PREFIX}{e.get('key', '')}"
            me.append(e)

    def _ns_key(k: str) -> bool:
        bare = k.split(":", 1)[-1]
        return bare == NS_LABEL or bare.startswith(NS_LABELS_PREFIX)

    constrained = (ns_constrained
                   or any(_ns_key(k) for k in ml)
                   or any(_ns_key(e.get("key", "")) for e in me))
    if not constrained:
        ml[f"k8s:{NS_LABEL}"] = ns
    out: dict = {}
    if ml:
        out["matchLabels"] = ml
    if me:
        out["matchExpressions"] = me
    return out


def _scope_peers(section: dict, ns: str) -> dict:
    """Namespace the peer selectors of one ingress/egress entry."""
    out = dict(section)
    for key in ("fromEndpoints", "toEndpoints"):
        if key in out and out[key]:
            out[key] = [_selector_in_namespace(s, ns) for s in out[key]]
    return out


def rules_from_cnp(obj: dict) -> List[Rule]:
    """One CiliumNetworkPolicy object (parsed YAML/JSON) -> rules.

    Accepts ``spec`` (one rule) or ``specs`` (several); both error if
    absent, matching upstream sanitization."""
    kind = obj.get("kind", "")
    if kind not in ("CiliumNetworkPolicy", "CiliumClusterwideNetworkPolicy"):
        raise ValueError(f"not a CNP object: kind={kind!r}")
    meta = obj.get("metadata") or {}
    name = meta.get("name", "")
    if not name:
        raise ValueError("CNP metadata.name is required")
    ns = meta.get("namespace", "default")
    clusterwide = kind == "CiliumClusterwideNetworkPolicy"
    specs = []
    if obj.get("spec"):
        specs.append(obj["spec"])
    specs.extend(obj.get("specs") or ())
    if not specs:
        raise ValueError("CNP needs spec or specs")

    derived = [f"{POLICY_NAME_LABEL}={name}"]
    if not clusterwide:
        derived.append(f"{POLICY_NS_LABEL}={ns}")
    if meta.get("uid"):
        derived.append(f"{POLICY_UID_LABEL}={meta['uid']}")

    rules = []
    for spec in specs:
        d = dict(spec)
        if not clusterwide:
            sel_key = ("endpointSelector" if "endpointSelector" in d
                       else "nodeSelector" if "nodeSelector" in d
                       else "endpointSelector")
            d[sel_key] = _selector_in_namespace(d.get(sel_key), ns)
            for section in ("ingress", "ingressDeny", "egress",
                            "egressDeny"):
                if d.get(section):
                    d[section] = [_scope_peers(s, ns)
                                  for s in d[section]]
        d["labels"] = list(d.get("labels") or ()) + derived
        if not d.get("description"):
            d["description"] = f"cnp:{ns}/{name}" if not clusterwide \
                else f"ccnp:{name}"
        rules.append(rule_from_dict(d))
    return rules


def _expand_to_services(section: dict, services_view) -> dict:
    """One egress entry: ``toServices`` -> derived ``toCIDRSet``
    (reference: pkg/k8s TranslateToServicesRule rewrites the rule
    in place against the service/endpoints caches).

    An expansion yielding NO peers inserts the unmatchable
    ``0.0.0.0/32`` instead of leaving the entry peer-less — a
    peer-less egress entry is an L3 wildcard, and a vanished service
    must fail closed, not open."""
    tos = section.get("toServices")
    if not tos:
        return section
    out = dict(section)
    del out["toServices"]
    peers: set = set()
    for ent in tos:
        ks = ent.get("k8sService") or {}
        sel = ent.get("k8sServiceSelector") or {}
        if ks:
            peers |= services_view.service_peer_ips(
                ks.get("namespace", "default"),
                ks.get("serviceName", ""))
        elif sel:
            peers |= services_view.select_peer_ips(
                dict(sel.get("selector") or {}), sel.get("namespace"))
    cidrs = list(out.get("toCIDRSet") or ())
    if peers:
        cidrs.extend({"cidr": (f"{ip}/32" if ":" not in ip
                               else f"{ip}/128")}
                     for ip in sorted(peers))
    else:
        cidrs.append({"cidr": "0.0.0.0/32"})  # matches nothing real
    out["toCIDRSet"] = cidrs
    return out


def expand_cnp_services(obj: dict, services_view) -> dict:
    """Deep-copy a CNP, expanding every egress/egressDeny entry's
    ``toServices`` against the live service view.  Objects without
    toServices return unchanged (same identity — callers use that to
    skip re-imports)."""
    if not cnp_has_to_services(obj):
        return obj
    import copy
    obj = copy.deepcopy(obj)
    specs = ([obj["spec"]] if obj.get("spec") else []) + \
        list(obj.get("specs") or ())
    for spec in specs:
        for section in ("egress", "egressDeny"):
            if spec.get(section):
                spec[section] = [
                    _expand_to_services(s, services_view)
                    for s in spec[section]]
    return obj


def cnp_cidr_group_refs(obj: dict) -> set:
    """Names of every CiliumCIDRGroup the CNP references via
    fromCIDRSet/toCIDRSet ``cidrGroupRef`` entries."""
    refs = set()
    specs = ([obj.get("spec")] if obj.get("spec") else []) + \
        list(obj.get("specs") or ())
    for spec in specs:
        for section in ("ingress", "ingressDeny", "egress",
                        "egressDeny"):
            for e in spec.get(section) or ():
                for key in ("fromCIDRSet", "toCIDRSet"):
                    for c in e.get(key) or ():
                        if isinstance(c, dict) and c.get("cidrGroupRef"):
                            refs.add(c["cidrGroupRef"])
    return refs


def expand_cnp_cidr_groups(obj: dict, groups) -> dict:
    """Deep-copy a CNP, replacing ``cidrGroupRef`` entries with the
    referenced group's CIDRs (reference: pkg/policy CIDRGroupRef
    resolution against CiliumCIDRGroup.spec.externalCIDRs).  A ref to
    a MISSING/empty group expands to the unmatchable ``0.0.0.0/32``
    — fail closed, never widen."""
    if not cnp_cidr_group_refs(obj):
        return obj
    import copy
    obj = copy.deepcopy(obj)
    specs = ([obj["spec"]] if obj.get("spec") else []) + \
        list(obj.get("specs") or ())
    for spec in specs:
        for section in ("ingress", "ingressDeny", "egress",
                        "egressDeny"):
            for e in spec.get(section) or ():
                for key in ("fromCIDRSet", "toCIDRSet"):
                    if not e.get(key):
                        continue
                    out = []
                    for c in e[key]:
                        if not (isinstance(c, dict)
                                and c.get("cidrGroupRef")):
                            out.append(c)
                            continue
                        cidrs = groups.get(c["cidrGroupRef"]) or ()
                        exc = list(c.get("except") or ())
                        if cidrs:
                            # the entry's 'except' carve-outs apply to
                            # every expanded CIDR — dropping them
                            # would WIDEN the policy
                            out.extend(
                                {"cidr": x,
                                 **({"except": exc} if exc else {})}
                                for x in cidrs)
                        else:
                            out.append({"cidr": "0.0.0.0/32"})
                    e[key] = out
    return obj


def cnp_has_to_services(obj: dict) -> bool:
    specs = ([obj.get("spec")] if obj.get("spec") else []) + \
        list(obj.get("specs") or ())
    return any(e.get("toServices")
               for spec in specs
               for section in ("egress", "egressDeny")
               for e in (spec.get(section) or ()))


def cnp_identity_labels(obj: dict) -> List[str]:
    """The derived labels identifying one CNP's rules (for delete)."""
    meta = obj.get("metadata") or {}
    out = [f"{POLICY_NAME_LABEL}={meta.get('name', '')}"]
    if obj.get("kind") != "CiliumClusterwideNetworkPolicy":
        out.append(
            f"{POLICY_NS_LABEL}={meta.get('namespace', 'default')}")
    return out


class CNPWatcher:
    """The watcher half: CNP add/update/delete events -> repository
    mutations (reference: pkg/k8s/watchers cilium_network_policy.go).
    Drive it from a fake event stream in tests, or a real informer in
    deployment.

    ``services`` (a ServiceWatcher, optional) enables ``toServices``
    egress entries: they expand to the referenced services' peer IPs
    at import, and :meth:`resync_services` (wired to service/
    endpoints churn by the hub) re-expands affected CNPs — skipping
    the repository round-trip when the expansion is unchanged.
    ``groups`` (a CIDRGroupWatcher, optional) likewise enables
    ``cidrGroupRef`` entries (CiliumCIDRGroup expansion), re-expanded
    via :meth:`resync_cidr_groups`."""

    def __init__(self, repo, services=None, groups=None):
        self.repo = repo
        self.services = services
        self.groups = groups
        # CNPs carrying toServices:
        #   key -> (raw obj, last expansion, named-ref keys, has_sel)
        # named-ref keys are the "<ns>/<name>" services the CNP names
        # via k8sService; has_sel marks k8sServiceSelector use (those
        # depend on EVERY service's labels, so any change re-expands)
        self._svc_cnps: Dict[str, tuple] = {}
        # CNPs carrying cidrGroupRef: key -> (raw, last, group names)
        self._group_cnps: Dict[str, tuple] = {}

    @staticmethod
    def _key(obj: dict) -> str:
        meta = obj.get("metadata") or {}
        # kind-qualified: a CCNP and a default-ns CNP may share a name
        kind = "ccnp" if obj.get("kind") == \
            "CiliumClusterwideNetworkPolicy" else "cnp"
        return (f"{kind}:{meta.get('namespace', 'default')}"
                f"/{meta.get('name')}")

    @staticmethod
    def _service_refs(obj: dict) -> tuple:
        """-> (named '<ns>/<name>' keys, any-selector flag)."""
        named, has_sel = set(), False
        specs = ([obj.get("spec")] if obj.get("spec") else []) + \
            list(obj.get("specs") or ())
        for spec in specs:
            for section in ("egress", "egressDeny"):
                for e in spec.get(section) or ():
                    for ent in e.get("toServices") or ():
                        ks = ent.get("k8sService") or {}
                        if ks:
                            named.add(
                                f"{ks.get('namespace', 'default')}"
                                f"/{ks.get('serviceName', '')}")
                        elif ent.get("k8sServiceSelector"):
                            has_sel = True
        return named, has_sel

    def _expand(self, obj: dict) -> dict:
        key = self._key(obj)
        has_svc = cnp_has_to_services(obj)
        grefs = cnp_cidr_group_refs(obj)
        if has_svc and self.services is None:
            raise ValueError("toServices needs a service view "
                             "(CNPWatcher(services=...))")
        if grefs and self.groups is None:
            raise ValueError("cidrGroupRef needs a CiliumCIDRGroup "
                             "view (CNPWatcher(groups=...))")
        expanded = obj
        if has_svc:
            expanded = expand_cnp_services(expanded, self.services)
        if grefs:
            expanded = expand_cnp_cidr_groups(expanded, self.groups)
        # both trackers record the FULLY expanded form: the
        # unchanged-skip in either resync compares against
        # _reexpand's full composition
        if has_svc:
            named, has_sel = self._service_refs(obj)
            self._svc_cnps[key] = (obj, expanded, named, has_sel)
        else:
            self._svc_cnps.pop(key, None)
        if grefs:
            self._group_cnps[key] = (obj, expanded, grefs)
        else:
            self._group_cnps.pop(key, None)
        return expanded

    def on_add(self, obj: dict) -> int:
        return self.repo.add_list(rules_from_cnp(self._expand(obj)))

    def on_update(self, obj: dict) -> int:
        expanded = self._expand(obj)
        self.repo.delete_by_labels(cnp_identity_labels(obj))
        return self.repo.add_list(rules_from_cnp(expanded))

    def on_delete(self, obj: dict) -> int:
        self._svc_cnps.pop(self._key(obj), None)
        self._group_cnps.pop(self._key(obj), None)
        return self.repo.delete_by_labels(cnp_identity_labels(obj))

    def resync_services(self, changed: str = None) -> int:
        """Service/Endpoints churn: re-expand the toServices CNPs
        that could see ``changed`` ("<ns>/<name>"; None = all) and
        whose derived peer set actually moved.  Returns CNPs
        re-imported."""
        n = 0
        for key, (raw, last, named, has_sel) in list(
                self._svc_cnps.items()):
            if changed is not None and not has_sel \
                    and changed not in named:
                continue
            fresh = self._reexpand(raw)
            if fresh != last:
                self._svc_cnps[key] = (raw, fresh, named, has_sel)
                self.repo.delete_by_labels(cnp_identity_labels(raw))
                self.repo.add_list(rules_from_cnp(fresh))
                n += 1
        return n

    def _reexpand(self, raw: dict) -> dict:
        """Full re-expansion (services THEN groups — the import-time
        composition order), keeping the group tracking in step when a
        service-driven resync moves a CNP that also carries refs."""
        fresh = raw
        if cnp_has_to_services(raw) and self.services is not None:
            fresh = expand_cnp_services(fresh, self.services)
        grefs = cnp_cidr_group_refs(raw)
        if grefs and self.groups is not None:
            fresh = expand_cnp_cidr_groups(fresh, self.groups)
            self._group_cnps[self._key(raw)] = (raw, fresh, grefs)
        return fresh

    def resync_cidr_groups(self, changed: str = None) -> int:
        """CiliumCIDRGroup churn: re-expand CNPs referencing the
        changed group (None = all)."""
        n = 0
        for key, (raw, last, grefs) in list(self._group_cnps.items()):
            if changed is not None and changed not in grefs:
                continue
            fresh = self._reexpand(raw)
            if fresh != last:
                self._group_cnps[key] = (raw, fresh, grefs)
                if key in self._svc_cnps:
                    named, has_sel = self._service_refs(raw)
                    self._svc_cnps[key] = (raw, fresh, named, has_sel)
                self.repo.delete_by_labels(cnp_identity_labels(raw))
                self.repo.add_list(rules_from_cnp(fresh))
                n += 1
        return n
