"""The port's k8s layer: CiliumNetworkPolicy translation
(``k8s.rules_from_cnp``, ``CNPWatcher``), the Pod and Namespace
watchers and the watcher hub, against the JAX package's on the same
objects (``tests/test_k8s_cnp.py`` ``TestCNPTranslation``,
``TestCNPWatcher``; ``tests/test_k8s_watchers.py`` ``TestPodWatcher``,
``TestNamespaceSelector``):

- ``rules_from_cnp`` gives the reference's rules field by field;
- the watchers drive the port's daemon (``device="cpu"``) and the JAX
  daemon (``backend="tpu"``, JAX on the CPU) to the same endpoints,
  identities and verdicts;
- the hub routes the ported kinds and raises NotImplementedError
  naming ROADMAP A20 for the kinds whose watchers are not ported."""

import dataclasses

import numpy as np
import pytest
import torch

from cilium_tpu.agent import Daemon as JDaemon, DaemonConfig as JConfig
from cilium_tpu.core import make_batch
from cilium_tpu.k8s import CNPWatcher as JCNPWatcher
from cilium_tpu.k8s import rules_from_cnp as jrules_from_cnp
from cilium_tpu_torch.agent import Daemon, DaemonConfig
from cilium_tpu_torch.core.packets import TCP_SYN
from cilium_tpu_torch.datapath.verdict import REASON_NO_ENDPOINT
from cilium_tpu_torch.k8s import CNPWatcher, rules_from_cnp
from cilium_tpu_torch.policy.api import rules_from_obj
from cilium_tpu_torch.policy.mapstate import VERDICT_ALLOW

torch.set_num_threads(1)

CT = 1 << 12
NODE = "node0"  # both packages' default node name
CNP = {
    "apiVersion": "cilium.io/v2",
    "kind": "CiliumNetworkPolicy",
    "metadata": {"name": "allow-web-to-db", "namespace": "prod",
                 "uid": "abc-123"},
    "spec": {
        "endpointSelector": {"matchLabels": {"app": "db"}},
        "ingress": [
            {"fromEndpoints": [{"matchLabels": {"app": "web"}}],
             "toPorts": [{"ports": [{"port": "5432",
                                     "protocol": "TCP"}]}]},
        ],
    },
}


def _specs_cnp():
    cnp = {k: v for k, v in CNP.items() if k != "spec"}
    return {**cnp, "specs": [CNP["spec"], CNP["spec"]]}


def _daemons():
    jd = JDaemon(JConfig(backend="tpu", ct_capacity=CT, enable_hubble=False,
                         flow_agg_enabled=False, history_interval=0.0))
    td = Daemon(DaemonConfig(ct_capacity=CT), device="cpu")
    return jd, td


def _shutdown(ds):
    for d in ds:
        d.shutdown()


def _pod(name="db-0", ns="default", ip="10.0.2.1", node=NODE,
         labels=None, cport=5432, cport_name="pg"):
    return {"kind": "Pod",
            "metadata": {"name": name, "namespace": ns,
                         "labels": labels or {"app": "db"}},
            "spec": {"nodeName": node,
                     "containers": [{"ports": [
                         {"name": cport_name, "containerPort": cport}]}]},
            "status": {"podIP": ip}}


def _namespace(name, labels):
    return {"kind": "Namespace",
            "metadata": {"name": name, "labels": labels}}


def _process_both(ds, rows, now):
    """One process_batch of the same rows on both daemons: verdicts and
    reasons equal row for row; returns the port's event batch."""
    evs = [d.process_batch(make_batch(rows).data, now=now) for d in ds]
    np.testing.assert_array_equal(evs[1].verdict, evs[0].verdict)
    np.testing.assert_array_equal(evs[1].reason, evs[0].reason)
    return evs[1]


def _endpoint_view(d, ip):
    ep = d.endpoints.lookup_by_ip(ip)
    if ep is None:
        return None
    return (ep.id, ep.identity.numeric_id, dict(ep.named_ports),
            sorted(str(l) for l in ep.labels))


def _assert_rules_equal(got, want):
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]


# -- translation (tests/test_k8s_cnp.py TestCNPTranslation) ------------
class TestCNPTranslation:
    def test_subject_and_peers_are_namespaced(self):
        rules = rules_from_cnp(CNP)
        _assert_rules_equal(rules, jrules_from_cnp(CNP))
        assert len(rules) == 1
        r = rules[0]
        sel = dict(r.endpoint_selector.match_labels)
        assert sel["k8s:io.kubernetes.pod.namespace"] == "prod"
        peer = dict(r.ingress[0].from_endpoints[0].match_labels)
        assert peer["k8s:io.kubernetes.pod.namespace"] == "prod"

    def test_derived_labels_identify_the_cnp(self):
        r = rules_from_cnp(CNP)[0]
        _assert_rules_equal([r], jrules_from_cnp(CNP))
        assert "k8s:io.cilium.k8s.policy.name=allow-web-to-db" in r.labels
        assert "k8s:io.cilium.k8s.policy.namespace=prod" in r.labels
        assert "k8s:io.cilium.k8s.policy.uid=abc-123" in r.labels

    def test_explicit_namespace_not_overridden(self):
        cnp = {**CNP, "spec": {
            "endpointSelector": {"matchLabels": {
                "app": "db", "k8s:io.kubernetes.pod.namespace": "other"}},
            "ingress": [{"fromEndpoints": [{}]}],
        }}
        r = rules_from_cnp(cnp)[0]
        _assert_rules_equal([r], jrules_from_cnp(cnp))
        sel = dict(r.endpoint_selector.match_labels)
        assert sel["k8s:io.kubernetes.pod.namespace"] == "other"

    def test_specs_plural(self):
        cnp = _specs_cnp()
        rules = rules_from_cnp(cnp)
        _assert_rules_equal(rules, jrules_from_cnp(cnp))
        assert len(rules) == 2

    def test_clusterwide_skips_namespacing(self):
        ccnp = {**CNP, "kind": "CiliumClusterwideNetworkPolicy"}
        r = rules_from_cnp(ccnp)[0]
        _assert_rules_equal([r], jrules_from_cnp(ccnp))
        sel = dict(r.endpoint_selector.match_labels)
        assert "k8s:io.kubernetes.pod.namespace" not in sel

    def test_rejects_non_cnp(self):
        for fn in (rules_from_cnp, jrules_from_cnp):
            with pytest.raises(ValueError, match="not a CNP"):
                fn({"kind": "NetworkPolicy", "metadata": {}})

    def test_namespace_selector_and_auth_translate_alike(self):
        """namespaceSelector peers, deny sections, an auth entry and an
        egress section: the same rules as the reference, and
        ``rules_from_obj`` takes the CNP through the translation."""
        cnp = {"kind": "CiliumNetworkPolicy",
               "metadata": {"name": "mix", "namespace": "test"},
               "spec": {
                   "endpointSelector": {"matchLabels": {"name": "server"}},
                   "ingress": [{
                       "fromEndpoints": [{
                           "matchLabels": {"app": "web"},
                           "namespaceSelector": {
                               "matchLabels": {"env": "prod"}}}],
                       "authentication": {"mode": "required"}}],
                   "ingressDeny": [{"fromEndpoints": [
                       {"matchLabels": {"app": "bad"}}]}],
                   "egress": [{"toEntities": ["world"],
                               "toPorts": [{"ports": [
                                   {"port": "443", "protocol": "TCP"}]}]}],
               }}
        want = jrules_from_cnp(cnp)
        _assert_rules_equal(rules_from_cnp(cnp), want)
        _assert_rules_equal(rules_from_obj(cnp), want)
        assert want[0].ingress[0].auth_mode == "required"


# -- the watcher (tests/test_k8s_cnp.py TestCNPWatcher) ----------------
class TestCNPWatcher:
    def test_add_update_delete_lifecycle(self):
        jd = JDaemon(JConfig(backend="interpreter", enable_hubble=False,
                             flow_agg_enabled=False, history_interval=0.0))
        td = Daemon(DaemonConfig(ct_capacity=CT), device="cpu")
        ws = (JCNPWatcher(jd.repo), CNPWatcher(td.repo))
        counts = []
        for w, d in zip(ws, (jd, td)):
            w.on_add(CNP)
            n_add = len(d.repo.rules())
            w.on_update(_specs_cnp())
            n_upd = len(d.repo.rules())
            w.on_delete(CNP)
            counts.append((n_add, n_upd, len(d.repo.rules())))
        assert counts[1] == counts[0] == (1, 2, 0)
        _shutdown((jd, td))

    def test_cnp_through_policy_import_and_enforced(self):
        """An upstream-format CNP through ``policy_import``, then
        packets verdict per its rules on both daemons."""
        ds = _daemons()
        ns = "k8s:io.kubernetes.pod.namespace=prod"
        for d in ds:
            d.add_endpoint("web-1", ("10.0.1.1",), ["k8s:app=web", ns])
            db = d.add_endpoint("db-1", ("10.0.2.1",), ["k8s:app=db", ns])
            d.policy_import(CNP)  # kind-detected, k8s-translated
            d.start()
        ev = _process_both(ds, [
            dict(src="10.0.1.1", dst="10.0.2.1", sport=40000, dport=5432,
                 proto=6, flags=TCP_SYN, ep=db.id, dir=0),
            dict(src="10.0.1.1", dst="10.0.2.1", sport=40001, dport=80,
                 proto=6, flags=TCP_SYN, ep=db.id, dir=0),
        ], now=10)
        assert list(ev.verdict) == [1, 0]
        _shutdown(ds)


# -- tests/test_k8s_watchers.py TestPodWatcher --------------------------
class TestPodWatcher:
    def test_pod_lifecycle(self):
        """Add, idempotent re-delivery, a label change that re-registers,
        delete: the endpoint follows on both daemons, and traffic to the
        deleted pod drops as an lxcmap miss."""
        ds = _daemons()
        hubs = [d.k8s_watchers() for d in ds]
        for h in hubs:
            h.dispatch("add", _pod())
        views = [_endpoint_view(d, "10.0.2.1") for d in ds]
        assert views[1] == views[0]
        ep_id, ident, ports, labels = views[1]
        assert ports == {"pg": 5432}
        assert any("app=db" in l for l in labels)
        assert [h.dispatch("add", _pod()) for h in hubs] == [ep_id, ep_id]
        for h in hubs:
            h.dispatch("update", _pod(labels={"app": "db", "tier": "gold"}))
        views = [_endpoint_view(d, "10.0.2.1") for d in ds]
        assert views[1] == views[0]
        assert views[1][1] != ident
        ep2 = views[1][0]
        for h in hubs:
            h.dispatch("delete", _pod())
        assert [_endpoint_view(d, "10.0.2.1") for d in ds] == [None, None]
        ev = _process_both(ds, [dict(src="10.0.1.1", dst="10.0.2.1",
                                     sport=40000, dport=5432, proto=6,
                                     flags=TCP_SYN, ep=ep2, dir=0)], now=10)
        assert int(ev.reason[0]) == REASON_NO_ENDPOINT
        _shutdown(ds)

    def test_pod_ip_change_reregisters(self):
        ds = _daemons()
        for d in ds:
            hub = d.k8s_watchers()
            hub.dispatch("add", _pod())
            hub.dispatch("update", _pod(ip="10.0.2.33"))
        assert [_endpoint_view(d, "10.0.2.1") for d in ds] == [None, None]
        views = [_endpoint_view(d, "10.0.2.33") for d in ds]
        assert views[0] is not None and views[1] == views[0]
        _shutdown(ds)

    def test_remote_pod_ignored_by_pod_watcher(self):
        ds = _daemons()
        for d in ds:
            assert d.k8s_watchers().dispatch(
                "add", _pod(node="node-9")) is None
            assert d.endpoints.lookup_by_ip("10.0.2.1") is None
        _shutdown(ds)

    def test_pod_without_ip_waits_for_update(self):
        ds = _daemons()
        got = []
        for d in ds:
            hub = d.k8s_watchers()
            pod = _pod()
            pod["status"] = {}
            got.append((hub.dispatch("add", pod),
                        hub.dispatch("update", _pod())))
        assert got[1] == got[0]
        assert got[1][0] is None and got[1][1] is not None
        _shutdown(ds)


# -- tests/test_k8s_watchers.py TestNamespaceSelector -------------------
class TestNamespaceSelector:
    """Namespace labels fold into pod identities and CNP peers select on
    them through the io.cilium.k8s.namespace.labels.* prefix."""

    def _worlds(self):
        ds = _daemons()
        for d in ds:
            hub = d.k8s_watchers()
            hub.dispatch("add", _namespace("prod", {"env": "prod"}))
            hub.dispatch("add", _namespace("dev", {"env": "dev"}))
            hub.dispatch("add", _pod(name="db-0", ns="prod",
                                     ip="10.0.2.1"))
            hub.dispatch("add", _pod(name="web-prod", ns="prod",
                                     ip="10.0.1.1", labels={"app": "web"}))
            hub.dispatch("add", _pod(name="web-dev", ns="dev",
                                     ip="10.0.1.2", labels={"app": "web"}))
        return ds

    def test_namespace_labels_fold_into_identities(self):
        ds = self._worlds()
        views = [_endpoint_view(d, "10.0.1.1") for d in ds]
        assert views[1] == views[0]
        assert any("io.cilium.k8s.namespace.labels.env=prod" in l
                   for l in views[1][3])
        _shutdown(ds)

    def test_namespace_selector_peer_crosses_namespaces(self):
        ds = self._worlds()
        for d in ds:
            d.k8s_watchers().dispatch("add", {
                "kind": "CiliumNetworkPolicy",
                "metadata": {"name": "allow-prod-web", "namespace": "prod"},
                "spec": {
                    "endpointSelector": {"matchLabels": {"app": "db"}},
                    "ingress": [{
                        "fromEndpoints": [{
                            "matchLabels": {"app": "web"},
                            "namespaceSelector": {
                                "matchLabels": {"env": "prod"}},
                        }],
                        "toPorts": [{"ports": [{"port": "5432",
                                                "protocol": "TCP"}]}],
                    }],
                }})
        db = ds[1].endpoints.lookup_by_ip("10.0.2.1")

        def row(src, sport):
            return dict(src=src, dst="10.0.2.1", sport=sport, dport=5432,
                        proto=6, flags=TCP_SYN, ep=db.id, dir=0)

        ev = _process_both(ds, [row("10.0.1.1", 40000),
                                row("10.0.1.2", 40001)], now=10)
        assert int(ev.verdict[0]) == VERDICT_ALLOW
        assert int(ev.verdict[1]) != VERDICT_ALLOW
        _shutdown(ds)

    def test_namespace_label_change_reregisters_pods(self):
        ds = self._worlds()
        old = ds[1].endpoints.lookup_by_ip("10.0.1.2").identity.numeric_id
        for d in ds:
            d.k8s_watchers().dispatch(
                "update", _namespace("dev", {"env": "staging"}))
        views = [_endpoint_view(d, "10.0.1.2") for d in ds]
        assert views[1] == views[0]
        assert views[1][1] != old
        assert any("namespace.labels.env=staging" in l for l in views[1][3])
        _shutdown(ds)


# -- the hub -------------------------------------------------------------
@pytest.mark.parametrize("kind", [
    "CiliumIdentity", "CiliumEndpoint", "CiliumEndpointSlice",
    "CiliumEgressGatewayPolicy", "CiliumLocalRedirectPolicy",
    "CiliumNode"])
def test_hub_refuses_the_unported_kinds_naming_a20(kind):
    td = Daemon(DaemonConfig(ct_capacity=CT), device="cpu")
    hub = td.k8s_watchers()
    with pytest.raises(NotImplementedError, match="ROADMAP A20"):
        hub.dispatch("add", {"kind": kind, "metadata": {"name": "x"}})
    with pytest.raises(ValueError, match="unhandled k8s kind"):
        hub.dispatch("add", {"kind": "ConfigMap", "metadata": {}})
    td.shutdown()


def test_hub_cidr_group_ref_expands_like_the_reference():
    """A CNP whose fromCIDRSet names a CiliumCIDRGroup: the group's CIDRs
    reach the repository as the reference's do, a group change
    re-expands the CNP, and a delete fails closed."""
    ds = _daemons()
    group = {"kind": "CiliumCIDRGroup", "metadata": {"name": "corp"},
             "spec": {"externalCIDRs": ["192.0.2.0/24"]}}
    cnp = {"kind": "CiliumNetworkPolicy",
           "metadata": {"name": "corp-in", "namespace": "default"},
           "spec": {"endpointSelector": {"matchLabels": {"app": "db"}},
                    "ingress": [{"fromCIDRSet": [
                        {"cidrGroupRef": "corp"}]}]}}

    def rules(d):
        return [dataclasses.asdict(r) for r in d.repo.rules()]

    for d in ds:
        hub = d.k8s_watchers()
        hub.dispatch("add", group)
        hub.dispatch("add", cnp)
    assert rules(ds[1]) == rules(ds[0])
    assert "192.0.2.0/24" in str(rules(ds[1]))
    for d in ds:
        d.k8s_watchers().dispatch(
            "update",
            {**group, "spec": {"externalCIDRs": ["198.51.100.0/24"]}})
    assert rules(ds[1]) == rules(ds[0])
    assert "198.51.100.0/24" in str(rules(ds[1]))
    for d in ds:
        d.k8s_watchers().dispatch("delete", group)
    assert rules(ds[1]) == rules(ds[0])
    assert "0.0.0.0/32" in str(rules(ds[1]))
    _shutdown(ds)
