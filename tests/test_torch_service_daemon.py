"""The service path of the port's ``Daemon.process_batch`` (device
"cpu", the plain PyTorch versions) against the JAX package's
``Daemon.process_batch`` (backend "tpu", JAX on the CPU): the socket-LB
flow cache on v4 rows, the per-packet v6 pass, NO_SERVICE through the
step's ``lb_drop`` channel, then masquerade, bandwidth, the step and
reverse NAT as before.

Per batch the monitor events are bit-exact (wall-clock timestamps
aside); at the end the flow caches (table, fingerprints, pins), the
``socklb_entries`` views, the CT tables and the metrics are equal.
Mirrors ``tests/test_service_lb.py`` ``TestDaemonIntegration``,
``tests/test_service_v6.py`` ``TestDualStackDaemon`` (through
``ServiceWatcher`` directly: the watcher hub is not ported),
``tests/test_socklb.py``, ``tests/test_affinity.py`` ``TestDaemonAffinity``
and the daemon cases of ``tests/test_service_types.py``.  Every batch
holds B rows, so the JAX side compiles each stage once per world.
"""

import ipaddress

import numpy as np
import pytest
import torch

from cilium_tpu.agent import Daemon as JDaemon, DaemonConfig as JConfig
from cilium_tpu.k8s.watchers import ServiceWatcher as JWatcher
from cilium_tpu_torch import u32
from cilium_tpu_torch.agent import Daemon, DaemonConfig
from cilium_tpu_torch.core.packets import (COL_DIR, COL_DPORT, COL_DST_IP0,
                                           COL_DST_IP3, COL_EP, COL_FAMILY,
                                           COL_FLAGS, COL_LEN, COL_PROTO,
                                           COL_SPORT, COL_SRC_IP0,
                                           COL_SRC_IP3, N_COLS, TCP_ACK,
                                           TCP_SYN, ip_to_words)
from cilium_tpu_torch.datapath.verdict import (REASON_BANDWIDTH,
                                               REASON_FORWARDED,
                                               REASON_NO_SERVICE)
from cilium_tpu_torch.k8s.watchers import ServiceWatcher

torch.set_num_threads(1)

CT = 1 << 12
B = 128
NODE = "192.168.0.1"
WEB_VIP, AFF_VIP, EMPTY_VIP, DB_VIP = ("172.16.0.10", "172.16.0.20",
                                       "172.16.0.99", "172.16.0.5")
EXT_VIP = "172.16.0.77"  # backed outside the cluster: masqueraded
BACKENDS = [f"10.0.1.{i + 1}:8080" for i in range(4)]
RULES = [
    {"endpointSelector": {"matchLabels": {"app": "client"}},
     "egress": [{"toEndpoints": [{"matchLabels": {"app": "web"}}],
                 "toPorts": [{"ports": [{"port": "8080",
                                         "protocol": "TCP"}]}]},
                {"toEntities": ["world"]}]},
    {"endpointSelector": {"matchLabels": {"app": "db"}},
     "ingress": [{"fromEndpoints": [{"matchLabels": {"app": "web"}}],
                  "toPorts": [{"ports": [{"port": "5432",
                                          "protocol": "TCP"}]}]}]},
    {"endpointSelector": {"matchLabels": {"app": "web"}},
     "ingress": [{}], "egress": [{}]},
    # everything but port 9 denied
    {"endpointSelector": {"matchLabels": {"app": "locked"}},
     "egress": [{"toPorts": [{"ports": [{"port": "9",
                                         "protocol": "TCP"}]}]}]},
]
PODS = {"client": ("10.0.9.9", "fd00:9::9"), "web": ("10.0.1.1", "fd00:1::1"),
        "web2": ("10.0.1.2",), "web3": ("10.0.1.3",), "web4": ("10.0.1.4",),
        "db": ("10.0.2.1",), "locked": ("10.0.8.8",)}
LABELS = {"client": "client", "db": "db", "locked": "locked"}


def _ip(s):
    return int(ipaddress.IPv4Address(s))


def _daemons(**kw):
    cfg = dict(ct_capacity=CT, **kw)
    jd = JDaemon(JConfig(backend="tpu", mesh_auth=False, enable_hubble=False,
                         flow_agg_enabled=False, history_interval=0.0,
                         **cfg))
    td = Daemon(DaemonConfig(**cfg), device="cpu")
    ids = []
    for d in (jd, td):
        d.policy_import(RULES)
        ids.append({name: d.add_endpoint(
            name, ips, [f"k8s:app={LABELS.get(name, 'web')}"]).id
            for name, ips in PODS.items()})
    assert ids[0] == ids[1]
    return jd, td, ids[1]


def _upsert(daemons, *args, **kw):
    for d in daemons:
        d.services.upsert(*args, **kw)


def _both(jd, td, rows, now):
    """One batch through both daemons: events bit-exact."""
    jb = jd.process_batch(rows.copy(), now=now)
    tb = td.process_batch(rows.copy(), now=now)
    for c in ("msg_type", "verdict", "reason", "ct_state", "identity",
              "proxy_port", "hdr"):
        np.testing.assert_array_equal(getattr(tb, c), getattr(jb, c),
                                      err_msg=c)
    return tb


def _same_state(jd, td, now):
    for f in ("table", "fp", "aff"):
        np.testing.assert_array_equal(
            u32.to_numpy(getattr(td._socklb, f)),
            np.asarray(getattr(jd._socklb, f)), err_msg=f)
    jd._now = td._now = lambda: now
    assert td.socklb_entries() == jd.socklb_entries()
    np.testing.assert_array_equal(td.loader.ct_snapshot(),
                                  jd.loader.ct_snapshot())
    np.testing.assert_array_equal(td.loader.metrics(), jd.loader.metrics())


def _rows(ep, n=B, dst=WEB_VIP, dport=80, proto=6, sport0=41000,
          src="10.0.9.9", flags=TCP_SYN, dirn=1):
    rows = np.zeros((n, N_COLS), np.uint32)
    rows[:, COL_SRC_IP3], rows[:, COL_DST_IP3] = _ip(src), _ip(dst)
    rows[:, COL_SPORT] = sport0 + np.arange(n)
    rows[:, COL_DPORT], rows[:, COL_PROTO] = dport, proto
    rows[:, COL_FLAGS], rows[:, COL_LEN] = flags, 100
    rows[:, COL_FAMILY], rows[:, COL_EP], rows[:, COL_DIR] = 4, ep, dirn
    return rows


def _mix(ids, rng, sport0):
    """Client rows: web VIP, the affinity VIP, the empty VIP (policy
    would deny it too), the db VIP (policy denies the backend), a
    non-service destination, a wrong protocol on the web VIP."""
    parts = [(WEB_VIP, 80, 6, 48), (AFF_VIP, 80, 6, 24),
             (EMPTY_VIP, 80, 6, 16), (DB_VIP, 5432, 6, 8),
             ("10.0.1.1", 8080, 6, 16), (WEB_VIP, 80, 17, 16)]
    rows = np.concatenate([
        _rows(ids["client"], k, dst=dst, dport=port, proto=proto,
              sport0=sport0 + 1000 * i)
        for i, (dst, port, proto, k) in enumerate(parts)])
    return rows[rng.permutation(B)]


def test_services_through_process_batch_match_jax():
    jd, td, ids = _daemons()
    ds = (jd, td)
    _upsert(ds, "web", f"{WEB_VIP}:80", BACKENDS)
    _upsert(ds, "web-dup", f"{WEB_VIP}:80", ["10.0.9.1:1"])
    _upsert(ds, "aff", f"{AFF_VIP}:80", BACKENDS, affinity_timeout=60)
    _upsert(ds, "empty", f"{EMPTY_VIP}:80", [])
    _upsert(ds, "db", f"{DB_VIP}:5432", ["10.0.2.1:5432"])
    rng = np.random.default_rng(4)
    first = _mix(ids, rng, 40000)
    b = _both(jd, td, first, 10)
    empty = first[:, COL_DST_IP3] == _ip(EMPTY_VIP)
    # NO_SERVICE wins over the client's policy, which allows only web
    assert (b.reason[empty] == REASON_NO_SERVICE).all()
    assert (b.reason == REASON_NO_SERVICE).sum() == empty.sum()
    web = (first[:, COL_DST_IP3] == _ip(WEB_VIP)) & (first[:, COL_PROTO] == 6)
    assert (b.reason[web] == REASON_FORWARDED).all()
    assert (b.hdr[web, COL_DPORT] == 8080).all()
    # the same flows again (ACKs, cached), then a backend leaves
    again = first.copy()
    again[:, COL_FLAGS] = TCP_ACK
    b2 = _both(jd, td, again, 11)
    dnat = [COL_DST_IP3, COL_DPORT]
    np.testing.assert_array_equal(b2.hdr[:, dnat], b.hdr[:, dnat])
    _upsert(ds, "aff", f"{AFF_VIP}:80", BACKENDS[1:], affinity_timeout=60)
    _upsert(ds, "web", f"{WEB_VIP}:80", BACKENDS[:2])
    b3 = _both(jd, td, again, 12)
    np.testing.assert_array_equal(b3.hdr[web][:, dnat], b.hdr[web][:, dnat])
    fresh = _mix(ids, rng, 50000)
    b4 = _both(jd, td, fresh, 13)
    fweb = ((fresh[:, COL_DST_IP3] == _ip(WEB_VIP))
            & (fresh[:, COL_PROTO] == 6))
    assert set(b4.hdr[fweb, COL_DST_IP3].tolist()) <= {_ip("10.0.1.1"),
                                                        _ip("10.0.1.2")}
    # NO_SERVICE wins over a policy deny: the locked pod's rows to the
    # empty frontend drop NO_SERVICE, to the web frontend by policy
    locked = np.concatenate([
        _rows(ids["locked"], 64, dst=EMPTY_VIP, src="10.0.8.8"),
        _rows(ids["locked"], 64, dst=WEB_VIP, src="10.0.8.8")])
    b5 = _both(jd, td, locked, 14)
    assert (b5.reason[:64] == REASON_NO_SERVICE).all()
    assert (b5.verdict[64:] != 1).all()
    assert not np.isin(b5.reason[64:], [REASON_FORWARDED,
                                        REASON_NO_SERVICE]).any()
    # the affinity pins expire; later flows pin again
    _both(jd, td, _mix(ids, rng, 60000), 80)
    _same_state(jd, td, 80)
    for d in ds:
        d.shutdown()


def test_services_with_masquerade_and_bandwidth_match_jax():
    jd, td, ids = _daemons(masquerade=True, node_ip=NODE,
                           nat_pool_capacity=256)
    ds = (jd, td)
    _upsert(ds, "web", f"{WEB_VIP}:80", BACKENDS)
    _upsert(ds, "ext", f"{EXT_VIP}:443", ["93.184.0.7:443", "93.184.0.8:443"])
    _upsert(ds, "empty", f"{EMPTY_VIP}:80", [])
    for d in ds:
        d.set_bandwidth(ids["client"], 9_000)
    rng = np.random.default_rng(8)
    for now in (10, 10, 11, 13):
        rows = np.concatenate([
            _rows(ids["client"], 64, dst=WEB_VIP, sport0=30000 + now * 100),
            _rows(ids["client"], 48, dst=EXT_VIP, dport=443,
                  sport0=20000 + now * 100),
            _rows(ids["client"], 16, dst=EMPTY_VIP)])
        rows[:, COL_LEN] = rng.integers(200, 1400, B)
        b = _both(jd, td, rows, now)
        ext = slice(64, 112)
        # DNAT to the outside backend, then SNAT to the node
        ok = b.reason[ext] == REASON_FORWARDED
        assert (b.hdr[ext][ok, COL_SRC_IP3] == _ip(NODE)).all()
        assert (b.reason[112:] == REASON_NO_SERVICE).all()
    assert (td.loader.metrics()[REASON_BANDWIDTH].sum() > 0)
    np.testing.assert_array_equal(td.loader.nat_snapshot(),
                                  jd.loader.nat_snapshot())
    _same_state(jd, td, 13)
    for d in ds:
        d.shutdown()


def _rows6(ep, n, dst, sport0=41000):
    rows = np.zeros((n, N_COLS), np.uint32)
    rows[:, COL_SRC_IP0:COL_SRC_IP0 + 4] = ip_to_words("fd00:9::9")
    rows[:, COL_DST_IP0:COL_DST_IP0 + 4] = ip_to_words(dst)
    rows[:, COL_SPORT] = sport0 + np.arange(n)
    rows[:, COL_DPORT], rows[:, COL_PROTO] = 80, 6
    rows[:, COL_FLAGS], rows[:, COL_LEN] = TCP_SYN, 100
    rows[:, COL_FAMILY], rows[:, COL_EP], rows[:, COL_DIR] = 6, ep, 1
    return rows


def test_dual_stack_service_through_the_watcher_matches_jax():
    jd, td, ids = _daemons()
    ws = [JWatcher(jd.services), ServiceWatcher(td.services)]
    v6_vip, v6_be = "fd00::10", "fd00:1::1"
    svc = {"kind": "Service",
           "metadata": {"name": "web", "namespace": "default"},
           "spec": {"clusterIP": "172.20.0.10",
                    "clusterIPs": ["172.20.0.10", v6_vip],
                    "ports": [{"port": 80, "protocol": "TCP"}]}}

    def eps(addrs):
        return {"kind": "Endpoints",
                "metadata": {"name": "web", "namespace": "default"},
                "subsets": [{"addresses": [{"ip": a} for a in addrs],
                             "ports": [{"port": 8080, "protocol": "TCP"}]}]}

    for w in ws:
        w.on_service_add(svc)
        w.on_endpoints_add(eps(["10.0.1.1", v6_be]))
    for d in (jd, td):
        assert {s.frontend_ip for s in d.services.list()} == {
            "172.20.0.10", v6_vip}
    rows = np.concatenate([_rows6(ids["client"], 64, v6_vip),
                           _rows(ids["client"], 64, dst="172.20.0.10")])
    b = _both(jd, td, rows, 50)
    assert (b.reason == REASON_FORWARDED).sum() == B
    assert (b.hdr[:64, COL_DST_IP3] == ip_to_words(v6_be)[3]).all()
    # the v6 backend leaves: v6 VIP rows drop NO_SERVICE, v4 ones forward
    for w in ws:
        w.on_endpoints_update(eps(["10.0.1.1"]))
    rows = np.concatenate([_rows6(ids["client"], 64, v6_vip, sport0=44000),
                           _rows(ids["client"], 64, dst="172.20.0.10",
                                 sport0=44000)])
    b = _both(jd, td, rows, 51)
    assert (b.reason[:64] == REASON_NO_SERVICE).all()
    assert (b.reason[64:] == REASON_FORWARDED).all()
    _same_state(jd, td, 51)
    for d in (jd, td):
        d.shutdown()


def test_policy_applies_to_backend_not_vip():
    """LB before policy: a rule allowing traffic to the BACKEND admits
    VIP-addressed traffic after DNAT; the client's same rows to the db
    VIP (a backend its policy does not allow) drop."""
    jd, td, ids = _daemons()
    _upsert((jd, td), "db-svc", f"{DB_VIP}:5432", ["10.0.2.1:5432"])
    rows = np.concatenate([
        _rows(ids["db"], 64, src="10.0.1.1", dst=DB_VIP, dport=5432,
              dirn=0),
        _rows(ids["client"], 64, dst=DB_VIP, dport=5432, sport0=45000)])
    b = _both(jd, td, rows, 10)
    assert (b.verdict[:64] == 1).all()
    assert (b.hdr[:, COL_DST_IP3] == _ip("10.0.2.1")).all()
    assert (b.reason[64:] != REASON_FORWARDED).all()
    assert td.services.list()[0].to_dict() == jd.services.list()[0].to_dict()
    for d in (jd, td):
        d.shutdown()


def test_affinity_pins_and_flow_cache_entries_match_jax():
    """TestDaemonAffinity: two flows of one client to an affinity
    service are cached with the same (pinned) backend; the entries
    views agree."""
    jd, td, ids = _daemons()
    _upsert((jd, td), "web", f"{WEB_VIP}:80", BACKENDS,
            affinity_timeout=120)
    # the first batch repeats one flow: its row pins the backend
    first = _rows(ids["client"])
    first[:, COL_SPORT] = 41000
    _both(jd, td, first, 100)
    for now in range(101, 104):
        _both(jd, td, _rows(ids["client"], sport0=41000 + 200 * now), now)
    entries = [e for e in td.socklb_entries() if e["backend"]]
    assert len(entries) == 3 * B + 1
    assert len({e["backend"] for e in entries}) == 1
    _same_state(jd, td, 103)
    assert td.socklb_entries(limit=5) == jd.socklb_entries(limit=5)
    for d in (jd, td):
        d.shutdown()


def test_service_tables_live_on_the_loader_device():
    td = Daemon(DaemonConfig(ct_capacity=CT), device="cpu")
    assert td.socklb_entries() == []
    td.services.upsert("web", f"{WEB_VIP}:80", BACKENDS)
    assert td.services.tensors().maglev.device.type == "cpu"
    td.process_batch(_rows(1, 8), now=5)
    assert td._socklb.table.device.type == "cpu"
    assert len(td.socklb_entries()) == 8
    td.shutdown()
