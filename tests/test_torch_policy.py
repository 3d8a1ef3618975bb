"""Policy compiler port: the copied host modules of cilium_tpu_torch
(labels, identity, policy, LPM compiler) give the JAX package's arrays
exactly, on the benchmark world and on a rule set that exercises every
verdict class."""

import numpy as np
import pytest
import torch

from cilium_tpu.testing import fixtures as jfix
from cilium_tpu_torch.testing import fixtures as tfix

torch.set_num_threads(1)

_POLICY_FIELDS = ("proto_table", "port_class", "class_map", "verdict")
_LPM_FIELDS = ("l1", "l2", "l3", "v6_net", "v6_mask", "v6_value",
               "v6_plen")


@pytest.mark.parametrize("n_id,n_rules,n_v6", [(64, 4, 0), (256, 8, 16)])
def test_benchmark_world_compiles_identically(n_id, n_rules, n_v6):
    j = jfix.build_world(n_id, n_rules, ct_capacity=1 << 8, n_v6=n_v6)
    t = tfix.build_world(n_id, n_rules, ct_capacity=1 << 8, n_v6=n_v6,
                         device="cpu")
    assert t.ipcache == j.ipcache
    assert t.pod_ips == j.pod_ips and t.pod_ips6 == j.pod_ips6
    for f in _POLICY_FIELDS:
        np.testing.assert_array_equal(getattr(t.tensors, f),
                                      getattr(j.tensors, f))
    for f in _LPM_FIELDS:
        np.testing.assert_array_equal(getattr(t.lpm, f), getattr(j.lpm, f))
    assert ([t.row_map.row(i.numeric_id) for i in t.alloc.all_identities()]
            == [j.row_map.row(i.numeric_id) for i in j.alloc.all_identities()])


_RULES = [
    {"endpointSelector": {"matchLabels": {"app": "db"}},
     "ingress": [
         {"fromEndpoints": [{"matchLabels": {"app": "web"}}],
          "toPorts": [{"ports": [{"port": "5432", "protocol": "TCP"}]}],
          "authentication": {"mode": "required"}},
         {"fromEndpoints": [{"matchLabels": {"app": "web"}}],
          "toPorts": [{"ports": [{"port": "80", "protocol": "TCP"}],
                       "rules": {"http": [{"method": "GET"}]}}]},
         {"fromCIDR": ["192.168.0.0/16"],
          "toPorts": [{"ports": [{"port": "8000", "endPort": 8999}]}]},
         {"fromEntities": ["world"],
          "toPorts": [{"ports": [{"port": "53", "protocol": "UDP"}]}]}],
     "ingressDeny": [
         {"fromEndpoints": [{"matchLabels": {"app": "web"}}],
          "toPorts": [{"ports": [{"port": "22", "protocol": "TCP"}]}]}],
     "egress": [
         {"toEndpoints": [{"matchLabels": {"app": "web"}}]},
         {"toFQDNs": [{"matchPattern": "*.example.com"}]}]},
]


def _compile(pkg):
    labels = __import__(f"{pkg}.labels", fromlist=["LabelSet"])
    ident = __import__(f"{pkg}.identity", fromlist=["x"])
    pol = __import__(f"{pkg}.policy", fromlist=["x"])
    alloc = ident.CachingIdentityAllocator()
    repo = pol.PolicyRepository(alloc)
    db = labels.LabelSet.parse("k8s:app=db")
    for spec in ("k8s:app=db", "k8s:app=web", "reserved:world",
                 "k8s:app=other"):
        alloc.allocate(labels.LabelSet.parse(spec))
    repo.add_obj(_RULES)
    row_map = pol.IdentityRowMap(capacity=64)
    for i in alloc.all_identities():
        row_map.add(i.numeric_id)
    return pol.compile_policy([repo.resolve(db)], row_map)


def test_every_verdict_class_compiles_identically():
    j, t = _compile("cilium_tpu"), _compile("cilium_tpu_torch")
    for f in _POLICY_FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    packed = t.verdict & 0xFF
    assert {0, 1, 2, 3} <= set(np.unique(packed).tolist())
    assert ((t.verdict >> 24) & 1).any()  # the auth bit


def test_cnp_objects_raise_until_k8s_translation_is_ported():
    """A CNP object went through NotImplementedError until the k8s
    translation was ported; now it translates: namespaced, labelled,
    the reference's rules."""
    import dataclasses

    from cilium_tpu.policy.api import rules_from_obj as jrules_from_obj
    from cilium_tpu_torch.policy.api import rules_from_obj

    cnp = {"kind": "CiliumNetworkPolicy",
           "metadata": {"name": "db", "namespace": "prod"},
           "spec": _RULES[0]}
    (rule,) = rules_from_obj(cnp)
    assert dict(rule.endpoint_selector.match_labels)[
        "k8s:io.kubernetes.pod.namespace"] == "prod"
    assert "k8s:io.cilium.k8s.policy.name=db" in rule.labels
    assert [dataclasses.asdict(r) for r in rules_from_obj(cnp)] == \
        [dataclasses.asdict(r) for r in jrules_from_obj(cnp)]
    with pytest.raises(ValueError, match="spec or specs"):
        rules_from_obj({"kind": "CiliumNetworkPolicy",
                        "metadata": {"name": "x"}, "spec": {}})
    assert len(rules_from_obj(_RULES)) == 1
