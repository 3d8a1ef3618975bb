"""k8s watchers: Service/Endpoints, Pod, Namespace and CiliumCIDRGroup
event handlers, and the hub that routes an event stream to them.

Reference: the JAX package's ``k8s/watchers.py`` (itself upstream
``pkg/k8s/watchers``): informer callbacks translating k8s objects into
agent mutations:

- ``service.go`` + ``endpoints.go``: Service + Endpoints objects
  reconcile into the ServiceManager (frontend = clusterIP:port and the
  external frontend classes, backends = ready endpoint addresses x the
  matching port);
- ``pod.go``: local pods become endpoints (labels -> identity, pod IP
  -> ipcache host route, container ports -> named ports), with their
  namespace's labels folded in (the Namespace watcher);
- CiliumCIDRGroup objects: named CIDR sets for ``cidrGroupRef``.

The translation half only: tests drive it from fake event streams.
Handlers are idempotent (k8s informers re-deliver).  The
CiliumIdentity, CiliumEndpoint(Slice), CiliumEgressGatewayPolicy,
CiliumLocalRedirectPolicy and CiliumNode watchers are not ported yet
(ROADMAP A20): the hub raises NotImplementedError for their kinds.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import NS_LABEL, NS_LABELS_PREFIX

_PROTO_NUM = {"TCP": 6, "UDP": 17, "SCTP": 132}
# k8s resource.Quantity suffixes, CASE-SENSITIVE ("m" is milli, "M"
# mega — upstream parses the annotation as a Quantity of bits/s);
# "K"/"k" both accepted (common operator typo for the canonical "k")
_BW_UNITS = {"": 1, "m": 1e-3, "k": 10 ** 3, "K": 10 ** 3,
             "M": 10 ** 6, "G": 10 ** 9, "T": 10 ** 12,
             "P": 10 ** 15, "E": 10 ** 18,
             "Ki": 1 << 10, "Mi": 1 << 20, "Gi": 1 << 30,
             "Ti": 1 << 40, "Pi": 1 << 50, "Ei": 1 << 60}


def parse_bandwidth(spec) -> int:
    """``kubernetes.io/egress-bandwidth`` quantity -> BYTES/s (0 =
    none/invalid; the annotation is a k8s resource.Quantity in
    bits/s — upstream pkg/bandwidth parses it the same way)."""
    if not spec:
        return 0
    s = str(spec).strip()
    for suffix in sorted(_BW_UNITS, key=len, reverse=True):
        if suffix and s.endswith(suffix):
            num = s[: -len(suffix)]
            break
    else:
        suffix, num = "", s
    try:
        bits = float(num) * _BW_UNITS[suffix]
        return max(int(bits / 8), 0)
    except (ValueError, OverflowError):
        # covers non-numeric specs AND inf/nan/1e400, whose float()
        # succeeds but whose int() raises — one malformed annotation
        # must read as "no limit", never crash the watcher
        return 0




def _meta_key(obj: dict) -> str:
    meta = obj.get("metadata") or {}
    return f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"


def _k8s_selector_matches(sel: dict, labels: dict) -> bool:
    """Plain k8s LabelSelector over an object's metadata.labels:
    matchLabels AND every matchExpression (In/NotIn/Exists/
    DoesNotExist) must hold.  Unknown operators fail CLOSED (match
    nothing) — silently ignoring a constraint would widen a policy."""
    for k, v in (sel.get("matchLabels") or {}).items():
        if labels.get(k) != v:
            return False
    for e in sel.get("matchExpressions") or ():
        key, op = e.get("key", ""), e.get("operator", "")
        vals = e.get("values") or ()
        if op == "In":
            if labels.get(key) not in vals:
                return False
        elif op == "NotIn":
            if key in labels and labels[key] in vals:
                return False
        elif op == "Exists":
            if key not in labels:
                return False
        elif op == "DoesNotExist":
            if key in labels:
                return False
        else:
            return False
    return True


class ServiceWatcher:
    """Service + Endpoints objects -> ServiceManager entries.

    One LB entry per (k8s service, port, frontend): registry name
    ``<ns>/<name>:<portname-or-number>`` for the clusterIP frontend,
    with ``/nodeport``, ``/external/<ip>`` and ``/lb/<ip>`` suffixes
    for the external frontend classes (reference: pkg/k8s/watchers
    service+endpoints caches feeding pkg/service's frontend set).

    Frontend classes (reference pkg/loadbalancer SVCType):

    - ClusterIP (spec.clusterIP) — always, unless headless;
    - NodePort (``node_ip``:spec.ports[].nodePort) for
      type NodePort/LoadBalancer.  Divergence vs upstream: upstream
      matches a nodePort on EVERY local address; here the frontend
      compiles at the agent's configured ``node_ip`` only;
    - ExternalIP (spec.externalIPs[]);
    - LoadBalancer (status.loadBalancer.ingress[].ip).

    ``externalTrafficPolicy: Local`` filters external frontends to
    node-LOCAL backends, ``internalTrafficPolicy: Local`` does the
    same for the clusterIP frontend (``is_local_ip`` decides — wired
    to the endpoint registry).  A frontend whose filtered backend set
    is EMPTY still installs: matching traffic must drop with
    NO_SERVICE (upstream DROP_NO_SERVICE), not fall through to
    routing.  ``sessionAffinity: ClientIP`` carries its timeout onto
    every frontend of the service."""

    def __init__(self, services, node_ip=None, local_ips=None,
                 nodeport_addresses=()):
        self.services = services  # ServiceManager
        self.node_ip = node_ip
        # extra addresses nodePort frontends bind (reference:
        # --nodeport-addresses; narrows DIVERGENCES #21 — upstream's
        # catch-all binds every local address)
        self.nodeport_addresses = tuple(nodeport_addresses)
        # () -> set of node-local pod IPs, snapshotted ONCE per
        # reconcile (a per-ip predicate would rescan the endpoint
        # registry ports x backends times per event)
        self.local_ips = local_ips
        self._svc: Dict[str, dict] = {}
        self._eps: Dict[str, dict] = {}
        self._installed: Dict[str, set] = {}  # key -> LB names
        # fired with the changed "<ns>/<name>" after every service/
        # endpoints event (the hub wires CNPWatcher.resync_services
        # here so toServices re-expands only affected CNPs)
        self.on_change = None

    def _changed(self, key: str) -> None:
        if self.on_change is not None:
            self.on_change(key)

    # -- Service objects ---------------------------------------------
    def on_service_add(self, obj: dict) -> None:
        key = _meta_key(obj)
        self._svc[key] = obj
        self._reconcile(key)
        self._changed(key)

    on_service_update = on_service_add

    def on_service_delete(self, obj: dict) -> None:
        key = _meta_key(obj)
        self._svc.pop(key, None)
        self._reconcile(key)
        self._changed(key)

    # -- Endpoints objects -------------------------------------------
    def on_endpoints_add(self, obj: dict) -> None:
        key = _meta_key(obj)
        self._eps[key] = obj
        self._reconcile(key)
        self._changed(key)

    on_endpoints_update = on_endpoints_add

    def on_endpoints_delete(self, obj: dict) -> None:
        key = _meta_key(obj)
        self._eps.pop(key, None)
        self._reconcile(key)
        self._changed(key)

    def _reconcile(self, key: str) -> None:
        svc = self._svc.get(key)
        eps = self._eps.get(key)
        wanted: Dict[str, Tuple[str, List[str], int, str, int]] = {}
        local_set = None
        if svc is not None:
            spec = svc.get("spec") or {}
            stype = spec.get("type") or "ClusterIP"
            cluster_ip = spec.get("clusterIP")
            ext_local = spec.get("externalTrafficPolicy") == "Local"
            int_local = spec.get("internalTrafficPolicy") == "Local"
            if (ext_local or int_local) and self.local_ips is not None:
                local_set = set(self.local_ips())
            aff = 0
            if spec.get("sessionAffinity") == "ClientIP":
                aff = int(((spec.get("sessionAffinityConfig") or {})
                           .get("clientIP") or {})
                          .get("timeoutSeconds", 10800))
            lb_ips = [ing.get("ip")
                      for ing in ((svc.get("status") or {})
                                  .get("loadBalancer") or {})
                      .get("ingress") or () if ing.get("ip")]
            for p in spec.get("ports") or ():
                pname = p.get("name") or str(p.get("port"))
                proto = _PROTO_NUM.get(p.get("protocol", "TCP"), 6)
                backends = (self._backends(eps, p)
                            if eps is not None else [])
                local = (backends if local_set is None else
                         [b for b in backends
                          if b.rsplit(":", 1)[0] in local_set])
                # dual-stack: spec.clusterIPs may add a second-family
                # VIP beyond the primary spec.clusterIP
                cips: List[str] = []
                for c in ([cluster_ip]
                          + list(spec.get("clusterIPs") or ())):
                    if c and c != "None" and c not in cips:
                        cips.append(c)
                for j, cip in enumerate(cips):
                    suffix = "" if j == 0 else f"/ip{j}"
                    wanted[f"{key}:{pname}{suffix}"] = (
                        f"{cip}:{p.get('port')}",
                        local if int_local else backends,
                        proto, "ClusterIP", aff)
                ext_be = local if ext_local else backends
                node_port = p.get("nodePort")
                if stype in ("NodePort", "LoadBalancer") and node_port:
                    addrs: List[str] = []
                    for a in (self.node_ip,) + self.nodeport_addresses:
                        if a and a not in addrs:  # dedup vs node_ip
                            addrs.append(a)
                    for i, addr in enumerate(addrs):
                        suffix = "" if i == 0 else f"/{addr}"
                        wanted[f"{key}:{pname}/nodeport{suffix}"] = (
                            f"{addr}:{node_port}", ext_be,
                            proto, "NodePort", aff)
                for eip in spec.get("externalIPs") or ():
                    wanted[f"{key}:{pname}/external/{eip}"] = (
                        f"{eip}:{p.get('port')}", ext_be,
                        proto, "ExternalIP", aff)
                if stype == "LoadBalancer":
                    for lip in lb_ips:
                        wanted[f"{key}:{pname}/lb/{lip}"] = (
                            f"{lip}:{p.get('port')}", ext_be,
                            proto, "LoadBalancer", aff)
        have = self._installed.get(key, set())
        for name in have - set(wanted):
            self.services.delete(name)
        for name, (frontend, backends, proto, kind,
                   aff) in wanted.items():
            c = self.services.get(name)
            if (c is not None and c.protocol == proto
                    and c.kind == kind and c.affinity_timeout == aff
                    and f"{c.frontend_ip}:{c.frontend_port}" == frontend
                    and [f"{b.ip}:{b.port}" for b in c.backends]
                    == backends):
                continue  # unchanged: keep the compiled LB tensors
            self.services.upsert(name, frontend, backends,
                                 protocol=proto, kind=kind,
                                 affinity_timeout=aff)
        if wanted:
            self._installed[key] = set(wanted)
        else:  # fully withdrawn: don't grow an empty entry per
            self._installed.pop(key, None)  # ever-seen service

    def resync(self) -> None:
        """Endpoint churn: Local traffic policies re-filter their
        backend sets against the endpoints now on this node (a pod
        attaching after its Endpoints event must start receiving,
        and vice versa)."""
        for key, svc in list(self._svc.items()):
            spec = svc.get("spec") or {}
            if (spec.get("externalTrafficPolicy") == "Local"
                    or spec.get("internalTrafficPolicy") == "Local"):
                self._reconcile(key)

    # -- toServices peer views (pkg/k8s TranslateToServicesRule) ------
    def service_peer_ips(self, ns: str, name: str) -> set:
        """The IP peer set a ``k8sService`` reference expands to:
        clusterIP + every ready backend address (upstream translates
        to the endpoints' IPs; the frontend rides along so socket-LB'd
        connects to the VIP are judged consistently)."""
        key = f"{ns}/{name}"
        out: set = set()
        svc = self._svc.get(key)
        if svc is not None:
            cip = (svc.get("spec") or {}).get("clusterIP")
            if cip and cip != "None":
                out.add(cip)
        eps = self._eps.get(key)
        if eps is not None:
            for subset in eps.get("subsets") or ():
                for a in subset.get("addresses") or ():
                    if a.get("ip"):
                        out.add(a["ip"])
        return out

    def select_peer_ips(self, selector: dict,
                        ns: Optional[str] = None) -> set:
        """``k8sServiceSelector`` expansion: services whose OBJECT
        labels match the full k8s LabelSelector grammar (matchLabels
        AND matchExpressions), all namespaces unless ``ns`` given."""
        out: set = set()
        for key, svc in self._svc.items():
            sns, name = key.split("/", 1)
            if ns and sns != ns:
                continue
            labels = (svc.get("metadata") or {}).get("labels") or {}
            if _k8s_selector_matches(selector or {}, labels):
                out |= self.service_peer_ips(sns, name)
        return out

    @staticmethod
    def _backends(eps: dict, svc_port: dict) -> List[str]:
        """Ready addresses x the subset port matching this service
        port (by name, or the single unnamed port)."""
        pname = svc_port.get("name")
        out = []
        for subset in eps.get("subsets") or ():
            ports = subset.get("ports") or ()
            target = None
            for sp in ports:
                if (pname and sp.get("name") == pname) or (
                        not pname and len(ports) == 1):
                    target = sp.get("port")
                    break
            if target is None:
                continue
            for addr in subset.get("addresses") or ():
                ip = addr.get("ip")
                if ip:
                    out.append(f"{ip}:{target}")
        return sorted(out)


def pod_labels(obj: dict,
               ns_labels: Optional[Dict[str, str]] = None) -> List[str]:
    """Pod metadata labels -> cilium identity labels (``k8s:`` source
    + the namespace label + the NAMESPACE's own labels under the
    ``io.cilium.k8s.namespace.labels.`` prefix, reference:
    k8s.GetPodMetadata — that prefix is what namespaceSelector peers
    compile to)."""
    meta = obj.get("metadata") or {}
    ns = meta.get("namespace", "default")
    out = [f"k8s:{k}={v}" for k, v in (meta.get("labels") or {}).items()]
    out.append(f"k8s:{NS_LABEL}={ns}")
    for k, v in (ns_labels or {}).items():
        out.append(f"k8s:{NS_LABELS_PREFIX}{k}={v}")
    return sorted(out)


class PodWatcher:
    """Local pods -> endpoint lifecycle (reference: pod.go).

    Only pods scheduled on THIS node become endpoints (remote pods
    reach the ipcache via CiliumEndpoint objects).  A label change
    re-registers the endpoint (identity change = new endpoint policy,
    like upstream's UpdateLabels regeneration)."""

    def __init__(self, daemon, node_name: Optional[str] = None,
                 namespaces: Optional["NamespaceWatcher"] = None):
        self.daemon = daemon
        self.node_name = node_name or daemon.config.node_name
        self.namespaces = namespaces
        self._eps: Dict[str, int] = {}  # ns/name -> endpoint id
        self._sig: Dict[str, tuple] = {}  # ns/name -> (labels,ips,ports)
        self._objs: Dict[str, dict] = {}  # ns/name -> last pod object

    def _pod_ips(self, obj: dict) -> Tuple[str, ...]:
        st = obj.get("status") or {}
        ips = [e.get("ip") for e in st.get("podIPs") or () if e.get("ip")]
        if not ips and st.get("podIP"):
            ips = [st["podIP"]]
        return tuple(ips)

    @staticmethod
    def _named_ports(obj: dict) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for c in (obj.get("spec") or {}).get("containers") or ():
            for p in c.get("ports") or ():
                if p.get("name") and p.get("containerPort"):
                    out[p["name"]] = int(p["containerPort"])
        return out

    def on_add(self, obj: dict) -> Optional[int]:
        key = _meta_key(obj)
        if (obj.get("spec") or {}).get("nodeName") != self.node_name:
            return None
        ips = self._pod_ips(obj)
        if not ips:
            return None  # not yet scheduled/IP'd; a later update fires
        ns = (obj.get("metadata") or {}).get("namespace", "default")
        ns_labels = (self.namespaces.labels_of(ns)
                     if self.namespaces else None)
        labels = pod_labels(obj, ns_labels)
        ports = self._named_ports(obj)
        bw = parse_bandwidth(((obj.get("metadata") or {}).get(
            "annotations") or {}).get("kubernetes.io/egress-bandwidth"))
        # idempotency covers EVERYTHING the endpoint derives from the
        # pod: an IP change (sandbox restart) or port change with
        # unchanged labels must still re-register
        sig = (tuple(labels), ips, tuple(sorted(ports.items())), bw)
        if key in self._eps:
            if sig == self._sig.get(key):
                return self._eps[key]  # idempotent re-deliver
            self.on_delete(obj)  # pod changed: re-register
        ep = self.daemon.add_endpoint(key, ips, labels,
                                      named_ports=ports)
        if bw:
            # reference: pkg/bandwidth reads the pod annotation and
            # programs the endpoint's EDT aggregate
            self.daemon.set_bandwidth(ep.id, bw)
        self._eps[key] = ep.id
        self._sig[key] = sig
        self._objs[key] = obj
        return ep.id

    on_update = on_add

    def on_delete(self, obj: dict) -> bool:
        key = _meta_key(obj)
        ep_id = self._eps.pop(key, None)
        self._sig.pop(key, None)
        self._objs.pop(key, None)
        if ep_id is None:
            return False
        self.daemon.set_bandwidth(ep_id, None)
        return self.daemon.endpoints.remove(ep_id)

    def reregister_namespace(self, ns: str) -> int:
        """Namespace labels changed: replay every known pod of that
        namespace so identities pick up the new
        ``io.cilium.k8s.namespace.labels.*`` set."""
        n = 0
        for key, obj in list(self._objs.items()):
            if key.split("/", 1)[0] == ns:
                self.on_add(obj)
                n += 1
        return n


class NamespaceWatcher:
    """Namespace objects -> namespace-label registry (reference:
    pkg/k8s watcher for Namespace; upstream folds namespace labels
    into pod identity labels under ``io.cilium.k8s.namespace.labels.``
    so namespaceSelector peers can match them)."""

    def __init__(self, pods: Optional[PodWatcher] = None):
        self.pods = pods
        self._labels: Dict[str, Dict[str, str]] = {}

    def labels_of(self, ns: str) -> Dict[str, str]:
        return self._labels.get(ns, {})

    def on_add(self, obj: dict):
        meta = obj.get("metadata") or {}
        name = meta.get("name", "")
        labels = dict(meta.get("labels") or {})
        if self._labels.get(name) == labels:
            return
        self._labels[name] = labels
        if self.pods is not None:
            self.pods.reregister_namespace(name)

    on_update = on_add

    def on_delete(self, obj: dict):
        name = (obj.get("metadata") or {}).get("name", "")
        if self._labels.pop(name, None) is not None and self.pods:
            self.pods.reregister_namespace(name)


class CIDRGroupWatcher:
    """CiliumCIDRGroup objects -> named CIDR sets for policy
    ``cidrGroupRef`` expansion (reference: pkg/policy CIDRGroupRef +
    the CiliumCIDRGroup CRD, cilium 1.13+).  ``on_change`` fires with
    the group name so the CNP watcher re-expands only dependents."""

    def __init__(self):
        self._groups: Dict[str, tuple] = {}
        self.on_change = None

    def _changed(self, name: str) -> None:
        if self.on_change is not None:
            self.on_change(name)

    def on_add(self, obj: dict) -> None:
        name = (obj.get("metadata") or {}).get("name", "")
        spec = obj.get("spec") or {}
        self._groups[name] = tuple(spec.get("externalCIDRs") or ())
        self._changed(name)

    on_update = on_add

    def on_delete(self, obj: dict) -> None:
        name = (obj.get("metadata") or {}).get("name", "")
        self._groups.pop(name, None)
        self._changed(name)

    def get(self, name: str):
        return self._groups.get(name)


# kinds whose watchers are not ported yet: dispatching one raises
_UNPORTED_KINDS = {
    "CiliumIdentity": "the CiliumIdentity watcher",
    "CiliumEndpoint": "the CiliumEndpoint watcher",
    "CiliumEndpointSlice": "the CiliumEndpointSlice watcher",
    "CiliumEgressGatewayPolicy": "the CiliumEgressGatewayPolicy watcher",
    "CiliumLocalRedirectPolicy": "the CiliumLocalRedirectPolicy watcher",
    "CiliumNode": "the CiliumNode watcher",
}


class K8sWatcherHub:
    """The ported watchers wired to one daemon — the pkg/k8s/watchers
    K8sWatcher aggregate.  ``dispatch(event, obj)`` routes a fake (or
    real) informer stream: CNP, CCNP, Service, Endpoints, Pod, Namespace
    and CiliumCIDRGroup objects.  The kinds of the watchers not ported
    yet raise NotImplementedError naming ROADMAP A20; nothing is
    dropped silently."""

    def __init__(self, daemon):
        from . import CNPWatcher

        self.services = ServiceWatcher(
            daemon.services, node_ip=daemon.config.node_ip,
            nodeport_addresses=daemon.config.nodeport_addresses,
            local_ips=lambda: {ip for ep in daemon.endpoints.list()
                               for ip in ep.ips})
        daemon.endpoints.on_attach(
            lambda _p: self.services.resync())
        self.cidr_groups = CIDRGroupWatcher()
        self.cnp = CNPWatcher(daemon.repo, services=self.services,
                              groups=self.cidr_groups)
        self.services.on_change = self.cnp.resync_services
        self.cidr_groups.on_change = self.cnp.resync_cidr_groups
        self.pods = PodWatcher(daemon)
        self.namespaces = NamespaceWatcher(self.pods)
        self.pods.namespaces = self.namespaces
        self._routes = {
            "CiliumNetworkPolicy": self.cnp,
            "CiliumClusterwideNetworkPolicy": self.cnp,
            "Service": _Renamed(self.services, "service"),
            "Endpoints": _Renamed(self.services, "endpoints"),
            "Pod": self.pods,
            "Namespace": self.namespaces,
            "CiliumCIDRGroup": self.cidr_groups,
        }

    def dispatch(self, event: str, obj: dict):
        """``event`` in add|update|delete; ``obj`` any supported
        kind."""
        kind = obj.get("kind", "")
        what = _UNPORTED_KINDS.get(kind)
        if what is not None:
            raise NotImplementedError(
                f"{what} ({kind}) is not ported yet (ROADMAP A20)")
        handler = self._routes.get(kind)
        if handler is None:
            raise ValueError(f"unhandled k8s kind {kind!r}")
        return getattr(handler, f"on_{event}")(obj)

    def replay(self, events) -> int:
        """Apply a fixture stream of (event, obj) pairs."""
        n = 0
        for event, obj in events:
            self.dispatch(event, obj)
            n += 1
        return n


class _Renamed:
    """Adapts ServiceWatcher's per-kind handler names to the generic
    on_add/on_update/on_delete surface."""

    def __init__(self, inner, prefix: str):
        self._inner = inner
        self._prefix = prefix

    def __getattr__(self, name: str):
        if name.startswith("on_"):
            return getattr(self._inner,
                           f"on_{self._prefix}_{name[3:]}")
        raise AttributeError(name)
