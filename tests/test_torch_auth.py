"""Mutual authentication on the port: ``authentication.mode: required``
entries drop un-authenticated NEW flows with AUTH_REQUIRED, the
``AuthManager`` handshakes and grants (one [1, 1] cell of the device
auth table written by the ``dus`` kernel's plain version here, K10 on
the card), retried traffic forwards, grants expire and are swept, and
established flows ride the CT through expiry.

Every case of ``tests/test_auth.py`` runs on the port (``device="cpu"``)
and on the JAX daemon (``backend="tpu"``, JAX on the CPU) alike: each
packet's verdict and reason, ``auth_entries`` and the published auth
table must be equal, row for row and bit for bit."""

import numpy as np
import pytest
import torch

from cilium_tpu.agent import Daemon as JDaemon, DaemonConfig as JConfig
from cilium_tpu.agent.auth import DenyAuthProvider as JDenyAuthProvider
from cilium_tpu.core import make_batch
from cilium_tpu.labels import LabelSet as JLabelSet
from cilium_tpu_torch import u32
from cilium_tpu_torch.agent import Daemon, DaemonConfig
from cilium_tpu_torch.agent.auth import DenyAuthProvider
from cilium_tpu_torch.core.packets import TCP_ACK, TCP_SYN
from cilium_tpu_torch.datapath.verdict import (REASON_AUTH_REQUIRED,
                                               REASON_FORWARDED)
from cilium_tpu_torch.labels import LabelSet

torch.set_num_threads(1)

NS = "k8s:io.kubernetes.pod.namespace=default"
CT = 1 << 12
AUTH_RULE = {
    "endpointSelector": {"matchLabels": {"app": "db"}},
    "ingress": [{
        "fromEndpoints": [{"matchLabels": {"app": "web"}}],
        "toPorts": [{"ports": [{"port": "5432", "protocol": "TCP"}]}],
        "authentication": {"mode": "required"},
    }],
}


def _daemons(**over):
    """The JAX daemon and the port daemon, built alike."""
    cfg = dict(ct_capacity=CT, **over)
    jd = JDaemon(JConfig(backend="tpu", enable_hubble=False,
                         flow_agg_enabled=False, history_interval=0.0,
                         **cfg))
    td = Daemon(DaemonConfig(**cfg), device="cpu")
    return jd, td


def _worlds(auth_ttl=60, mesh_auth=True):
    """tests/test_auth.py's world on both packages: [(daemon, db)]."""
    sides = []
    for d in _daemons(mesh_auth=mesh_auth, auth_ttl=auth_ttl):
        d.add_endpoint("web", ("10.0.1.1",), ["k8s:app=web", NS])
        d.add_endpoint("db", ("10.0.2.1",), ["k8s:app=db", NS])
        d.policy_import([AUTH_RULE])
        sides.append((d, d.endpoints.lookup_by_ip("10.0.2.1")))
    assert sides[0][1].id == sides[1][1].id
    return sides


def _auth_table(d):
    t = d.loader.state.policy.auth
    if isinstance(t, torch.Tensor):
        return u32.to_numpy(t).copy()
    return np.asarray(t).copy()


def _assert_auth_equal(sides):
    (jd, _), (td, _) = sides
    assert td.loader.auth_entries() == jd.loader.auth_entries()
    np.testing.assert_array_equal(_auth_table(td), _auth_table(jd))


def _flows(sides, rows, now):
    """One process_batch of the same rows on both daemons: verdicts and
    reasons equal row for row, the grants and the auth table equal;
    returns the reasons."""
    evs = [d.process_batch(make_batch(rows).data, now=now)
           for d, _ in sides]
    np.testing.assert_array_equal(evs[1].verdict, evs[0].verdict)
    np.testing.assert_array_equal(evs[1].reason, evs[0].reason)
    _assert_auth_equal(sides)
    return [int(r) for r in evs[1].reason]


def _pkt(sides, sport, flags=TCP_SYN, now=50, src="10.0.1.1",
         dport=5432):
    ep = sides[0][1].id
    return _flows(sides, [dict(src=src, dst="10.0.2.1", sport=sport,
                               dport=dport, proto=6, flags=flags, ep=ep,
                               dir=0)], now)[0]


def _shutdown(sides):
    for d, _ in sides:
        d.shutdown()


def test_drop_then_handshake_then_forward():
    sides = _worlds()
    # first packet: policy allows but no grant -> AUTH_REQUIRED; the
    # manager observes the drop and handshakes synchronously
    assert _pkt(sides, 41000, now=50) == REASON_AUTH_REQUIRED
    assert [d.auth_manager.granted for d, _ in sides] == [1, 1]
    # the retry (next batch) forwards
    assert _pkt(sides, 41000, now=51) == REASON_FORWARDED
    (entry,) = sides[1][0].loader.auth_entries()
    assert entry["expires"] == 50 + 60
    web = sides[1][0].endpoints.lookup_by_ip("10.0.1.1")
    assert entry["remote_identity"] == web.identity.numeric_id
    assert sides[1][0].status()["auth"] == sides[0][0].status()["auth"]
    _shutdown(sides)


def test_established_flows_survive_grant_expiry():
    """Auth is judged at policy time (NEW) only: an established flow
    keeps forwarding after its grant expired; a NEW flow
    re-authenticates."""
    sides = _worlds(auth_ttl=20)
    assert _pkt(sides, 41000, now=50) == REASON_AUTH_REQUIRED
    assert _pkt(sides, 41000, now=51) == REASON_FORWARDED
    assert _pkt(sides, 41000, flags=TCP_ACK, now=100) == REASON_FORWARDED
    assert _pkt(sides, 42000, now=101) == REASON_AUTH_REQUIRED
    assert _pkt(sides, 42000, now=102) == REASON_FORWARDED
    _shutdown(sides)


def test_deny_provider_keeps_dropping():
    sides = _worlds()
    sides[0][0].auth_manager.provider = JDenyAuthProvider()
    sides[1][0].auth_manager.provider = DenyAuthProvider()
    assert _pkt(sides, 41000, now=50) == REASON_AUTH_REQUIRED
    assert _pkt(sides, 41000, now=51) == REASON_AUTH_REQUIRED
    stats = [d.auth_manager.status() for d, _ in sides]
    assert stats[1] == stats[0]
    assert stats[1]["failed"] >= 1 and stats[1]["granted"] == 0
    # failures back off: within retry_s no second handshake runs
    assert _pkt(sides, 41001, now=52) == REASON_AUTH_REQUIRED
    assert sides[1][0].auth_manager.failed == stats[1]["failed"]
    _shutdown(sides)


def test_mesh_auth_disabled_drops_forever():
    sides = _worlds(mesh_auth=False)
    assert [d.auth_manager for d, _ in sides] == [None, None]
    assert "auth" not in sides[1][0].status()
    for i in range(3):
        assert _pkt(sides, 41000 + i, now=50 + i) == REASON_AUTH_REQUIRED
    _shutdown(sides)


def test_rules_without_auth_unaffected():
    sides = _worlds()
    for d, _ in sides:
        d.policy_import([{
            "endpointSelector": {"matchLabels": {"app": "db"}},
            "ingress": [AUTH_RULE["ingress"][0], {
                "fromEndpoints": [{"matchLabels": {"app": "web"}}],
                "toPorts": [{"ports": [{"port": "8080",
                                        "protocol": "TCP"}]}],
            }],
        }])
    assert _pkt(sides, 43000, dport=8080, now=50) == REASON_FORWARDED
    assert _pkt(sides, 43001, now=51) == REASON_AUTH_REQUIRED
    _shutdown(sides)


def test_gc_sweeps_expired_grants():
    sides = _worlds(auth_ttl=60)
    _pkt(sides, 41000, now=50)
    assert len(sides[1][0].loader.auth_entries()) == 1
    assert [d.auth_manager.gc(now=300) for d, _ in sides] == [1, 1]
    _assert_auth_equal(sides)
    assert sides[1][0].loader.auth_entries() == []
    _shutdown(sides)


def test_reserved_identity_handshake_fails():
    """reserved:world holds no workload certificate to handshake with."""
    sides = _worlds()
    for d, _ in sides:
        d.policy_import([{
            "endpointSelector": {"matchLabels": {"app": "db"}},
            "ingress": [{"fromEntities": ["world"],
                         "authentication": {"mode": "required"}}],
        }])
    assert _pkt(sides, 41000, src="198.51.100.9",
                now=50) == REASON_AUTH_REQUIRED
    for d, _ in sides:
        assert d.auth_manager.failed >= 1
        assert d.auth_manager.granted == 0
    _shutdown(sides)


def test_recycled_identity_row_does_not_inherit_grant():
    """An identity row freed by incremental churn and handed to a NEW
    identity must not carry the previous occupant's live grant: the
    auth column is re-projected on every identity patch."""
    sides = []
    for d in _daemons(auth_ttl=600):
        d.add_endpoint("db", ("10.0.2.1",), ["k8s:app=db", NS])
        d.policy_import([{
            "endpointSelector": {"matchLabels": {"app": "db"}},
            "ingress": [{
                "fromEndpoints": [{"matchLabels": {"team": "blue"}}],
                "authentication": {"mode": "required"},
            }],
        }])
        # identity churn lands as incremental row patches only on a
        # started daemon (the recycle path under test)
        d.start()
        sides.append((d, d.endpoints.lookup_by_ip("10.0.2.1")))
    try:
        def mint(pod):
            out = []
            for (d, _), ls in zip(sides, (JLabelSet, LabelSet)):
                out.append(d.allocator.allocate(
                    ls.parse("k8s:team=blue", f"k8s:pod={pod}")))
            assert out[0].numeric_id == out[1].numeric_id
            return out

        a = mint("a")
        for (d, _), ident in zip(sides, a):
            d.upsert_ipcache("10.8.0.1/32", ident.numeric_id)
        assert _pkt(sides, 41000, src="10.8.0.1",
                    now=50) == REASON_AUTH_REQUIRED
        assert _pkt(sides, 41000, src="10.8.0.1", now=51) == REASON_FORWARDED
        # the identity churns away; its row becomes reusable
        for (d, _), ident in zip(sides, a):
            d.delete_ipcache("10.8.0.1/32")
            d.allocator.release(ident)
        b = mint("b")
        for (d, _), ident in zip(sides, b):
            d.upsert_ipcache("10.8.0.2/32", ident.numeric_id)
        # a NEW flow from the newcomer must handshake again
        assert _pkt(sides, 42000, src="10.8.0.2",
                    now=52) == REASON_AUTH_REQUIRED
    finally:
        _shutdown(sides)


def test_unknown_auth_mode_rejected():
    sides = _worlds()
    for d, _ in sides:
        with pytest.raises(ValueError, match="authentication mode"):
            d.policy_import([{
                "endpointSelector": {"matchLabels": {"app": "db"}},
                "ingress": [{"authentication": {"mode": "maybe"}}],
            }])
    _shutdown(sides)


def test_grants_survive_regeneration():
    """Policy regeneration must not wipe live grants: the host dict
    re-projects onto the auth table at every attach (full or delta)."""
    sides = _worlds()
    assert _pkt(sides, 41000, now=50) == REASON_AUTH_REQUIRED
    assert _pkt(sides, 41000, now=51) == REASON_FORWARDED
    for d, _ in sides:
        d.policy_import([{
            "endpointSelector": {"matchLabels": {"app": "other"}},
            "ingress": [{}],
        }])
    assert _pkt(sides, 44000, now=52) == REASON_FORWARDED
    _shutdown(sides)


def test_serving_event_join_grants_like_process_batch():
    """The serving path: AUTH_REQUIRED drops reach the manager through
    the event join (on the daemon's clock, pinned here on both sides),
    the pair is granted once, and the next batch forwards."""
    sides = _worlds()
    ep = sides[0][1].id
    rows = make_batch([dict(src="10.0.1.1", dst="10.0.2.1", sport=45000 + i,
                            dport=5432, proto=6, flags=TCP_SYN, ep=ep, dir=0)
                       for i in range(8)]).data
    for d, _ in sides:
        d._now = lambda: 70
        d.start_serving(ring_capacity=1 << 12, trace_sample=1)
        d.serve_batch(rows, now=70)
        d.stop_serving()
    assert [d.auth_manager.granted for d, _ in sides] == [1, 1]
    _assert_auth_equal(sides)
    (entry,) = sides[1][0].loader.auth_entries()
    assert entry["expires"] == 70 + 60
    assert _pkt(sides, 45000, now=71) == REASON_FORWARDED
    _shutdown(sides)
