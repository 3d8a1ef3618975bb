"""The L7 proxy plane of the port: the worker pool's ledger (the cases
of ``tests/test_l7plane.py::TestPoolLedger`` on the port's classes),
``L7Plane.ingest`` grouping equal to the JAX plane's on one decoded
``EventBatch``, the port's ``Daemon(device="cpu")`` against the JAX
``Daemon`` on one world with L7 rules (the same redirected rows and the
same allowed/denied totals), the DNS-answer -> FQDN identity loop
flipping verdicts under live serving, and a mint racing the drain
thread.  Every comparison is exact (counts and verdict codes).
Threads are few and waits short: the suite runs under xdist beside
wall-clock gates.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from cilium_tpu.agent import Daemon as JDaemon, DaemonConfig as JConfig
from cilium_tpu.core import TCP_SYN, make_batch
from cilium_tpu.monitor.api import EventBatch as JEventBatch
from cilium_tpu.proxy import L7Proxy as JProxy
from cilium_tpu.policy.api import L7Rules as JL7Rules
from cilium_tpu.serving.l7plane import L7Plane as JPlane
from cilium_tpu_torch.agent import Daemon, DaemonConfig
from cilium_tpu_torch.core.packets import COL_DPORT, COL_SPORT
from cilium_tpu_torch.infra import faults
from cilium_tpu_torch.monitor.api import EventBatch
from cilium_tpu_torch.policy.api import L7Rules
from cilium_tpu_torch.policy.mapstate import (VERDICT_ALLOW,
                                              VERDICT_REDIRECT)
from cilium_tpu_torch.proxy import L7Proxy
from cilium_tpu_torch.proxy.worker import L7Task, L7WorkerPool
from cilium_tpu_torch.serving.l7plane import L7Plane

torch.set_num_threads(1)

# the fqdn-loop policy shape of tests/test_l7plane.py: DNS egress is
# L7-inspected, and traffic may flow only to IPs the allowed names
# resolved to
RULES_DNS = [{
    "endpointSelector": {"matchLabels": {"app": "client"}},
    "egress": [
        {"toEntities": ["world"],
         "toPorts": [{"ports": [{"port": "53", "protocol": "UDP"}],
                      "rules": {"dns": [
                          {"matchName": "example.com"},
                          {"matchPattern": "*.corp.io"}]}}]},
        {"toFQDNs": ["example.com"],
         "toPorts": [{"ports": [{"port": "443",
                                 "protocol": "TCP"}]}]},
        {"toFQDNs": ["*.corp.io"],
         "toPorts": [{"ports": [{"port": "8443",
                                 "protocol": "TCP"}]}]},
    ],
}]
EXAMPLE_IP = "93.184.216.34"


@pytest.fixture(autouse=True)
def _disarm_port_faults():
    yield
    faults.disarm()


def _wait(pred, timeout=20.0, tick=0.002):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(tick)
    return True


def _assert_l7_ledger(l7):
    assert l7["redirected"] == (l7["l7-allowed"] + l7["l7-denied"]
                                + l7["l7-shed"] + l7["l7-failed"]), l7
    assert l7["ledger-exact"], l7
    return l7


# -- the pool's ledger --------------------------------------------------------


def test_pool_clean_drain_closes_ledger():
    p = L7WorkerPool(lambda t: (t.rows, 0), workers=2, queue_depth=64)
    p.start()
    for _ in range(16):
        assert p.submit(L7Task(port=10000, rows=4))
    st = p.stop()
    assert st["redirected"] == 64 == st["l7-allowed"]
    assert st["tasks-done"] == 16
    _assert_l7_ledger(st)


def test_pool_overflow_sheds_oldest_counted():
    started, gate = threading.Event(), threading.Event()

    def handle(t):
        started.set()
        gate.wait(10)
        return (t.rows, 0)

    p = L7WorkerPool(handle, workers=1, queue_depth=2)
    p.start()
    p.submit(L7Task(port=1, rows=1))
    assert started.wait(10)  # in flight: the queue is empty again
    p.submit(L7Task(port=1, rows=2))
    p.submit(L7Task(port=1, rows=4))
    p.submit(L7Task(port=1, rows=8))  # overflow: evicts rows=2
    st = p.stats()
    assert st["queue-overflows"] == 1 and st["l7-shed"] == 2
    assert "queue full" in st["last-drop-cause"]
    gate.set()
    st = p.stop()
    assert st["l7-allowed"] == 1 + 4 + 8 and st["redirected"] == 15
    _assert_l7_ledger(st)


def test_pool_handler_exception_contained_and_accounting_clamped():
    def handle(t):
        if t.port == 666:
            raise ValueError("bad payload")
        return (1, 1) if t.port == 1 else (9, 9)

    p = L7WorkerPool(handle, workers=1, queue_depth=8)
    p.start()
    p.submit(L7Task(port=666, rows=5))
    p.submit(L7Task(port=1, rows=5))  # under-reported by 3
    p.submit(L7Task(port=2, rows=4))  # over-reported: clamped to 4
    st = p.stop()
    assert st["l7-failed"] == 5 + 3
    assert st["l7-allowed"] + st["l7-denied"] == 2 + 4
    assert st["worker-restarts"] == 0  # contained, not a death
    _assert_l7_ledger(st)


def test_pool_worker_death_restarts_and_counts_rows():
    inj = faults.arm("l7.parse=1x1@1")  # the 2nd parse dies
    p = L7WorkerPool(lambda t: (t.rows, 0), workers=1, restart_budget=3)
    p.start()
    for _ in range(3):
        p.submit(L7Task(port=1, rows=2))
    assert _wait(lambda: p.stats()["worker-restarts"] >= 1, 10)
    st = p.stop()
    faults.disarm(inj)
    assert st["worker-restarts"] == 1
    assert st["l7-failed"] == 2 and st["l7-allowed"] == 4
    assert "worker died" in st["last-drop-cause"]
    _assert_l7_ledger(st)


def test_pool_stop_right_after_a_restart_drains_the_successor():
    """stop() issued the moment a restart is counted must still drain
    the queue through the successor worker.  The reference pool misses
    a successor published between its slot read and its liveness check
    and sweeps the queued task as shed (about half of these rounds on
    a CPU-only host); the port's pool follows the slot until its thread
    is dead and unreplaced."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(40):
            inj = faults.arm("l7.parse=1x1@1")
            p = L7WorkerPool(lambda t: (t.rows, 0), workers=1,
                             restart_budget=3)
            p.start()
            for _ in range(3):
                p.submit(L7Task(port=1, rows=2))
            assert _wait(lambda: p.stats()["worker-restarts"] >= 1, 10,
                         tick=0.0001)
            st = p.stop()
            faults.disarm(inj)
            assert (st["l7-allowed"], st["l7-failed"], st["l7-shed"]) \
                == (4, 2, 0), st
            _assert_l7_ledger(st)
    finally:
        sys.setswitchinterval(old)


def test_pool_restart_budget_terminal_sheds_and_fires_incident():
    inj = faults.arm("l7.parse=1")  # every parse dies
    fired = []
    p = L7WorkerPool(lambda t: (t.rows, 0), workers=1, restart_budget=1,
                     on_terminal=fired.append)
    p.start()
    p.submit(L7Task(port=1, rows=2))  # death 1: restart
    p.submit(L7Task(port=1, rows=2))  # death 2: terminal
    assert _wait(lambda: p.stats().get("error") is not None, 10)
    assert p.submit(L7Task(port=1, rows=2)) is False  # shed, counted
    st = p.stop()
    faults.disarm(inj)
    assert len(fired) == 1 and "budget" in fired[0]
    assert st["worker-restarts"] == 1
    assert st["l7-failed"] == 4 and st["l7-shed"] == 2
    _assert_l7_ledger(st)


def test_pool_stop_without_drain_sheds_queued():
    p = L7WorkerPool(lambda t: (t.rows, 0), workers=1, queue_depth=8)
    for _ in range(3):  # never started: all queued until the sweep
        p.submit(L7Task(port=1, rows=4))
    st = p.stop(drain=False)
    assert st["l7-shed"] == 12 and st["redirected"] == 12
    assert "without drain" in st["last-drop-cause"]
    _assert_l7_ledger(st)


# -- the plane against the JAX plane ------------------------------------------


def test_ingest_groups_like_jax():
    """One decoded batch of mixed verdicts: both planes queue the same
    (port, identity, rows) tasks in the same order."""
    rng = np.random.default_rng(7)
    n = 512
    cols = dict(
        msg_type=rng.integers(0, 3, n).astype(np.uint8),
        verdict=rng.choice(np.array([0, 1, 2, 3, 3], np.uint8), n),
        reason=np.zeros(n, np.uint8),
        ct_state=np.zeros(n, np.uint8),
        identity=rng.choice(np.array([2, 256, 257, 70000, 0xFFFFFFFF],
                                     np.uint32), n),
        proxy_port=rng.choice(np.array([0, 10000, 10001, 65535],
                                       np.uint16), n),
        hdr=np.zeros((n, 16), np.uint32), timestamp=1.0)
    planes = (JPlane(JProxy(), queue_depth=4096),
              L7Plane(L7Proxy(device="cpu"), queue_depth=4096))
    got = []
    for plane, cls in zip(planes, (JEventBatch, EventBatch)):
        ingested = plane.ingest(cls(**cols))
        got.append((ingested, [(t.port, t.rows, t.identities)
                               for t in plane.pool._q]))
        plane.stop(drain=False)
    assert got[0] == got[1]
    assert got[1][0] == int(((cols["verdict"] == 3)
                             & (cols["proxy_port"] > 0)).sum())
    assert len(got[1][1]) > 4


def test_kind_dispatch_like_jax():
    listeners = {10000: {"http": [{"method": "GET"}]},
                 10053: {"dns": [{"matchName": "a.io"},
                                 {"matchName": "b.io"}],
                         "http": [{"method": "GET"}]},
                 19092: {"kafka": [{"topic": "t"}]},
                 11000: {"memcached": [{"command": "get",
                                        "keyExact": "k"}]}}
    kinds = []
    for proxy, cls, plane_cls in ((JProxy(), JL7Rules, JPlane),
                                  (L7Proxy(device="cpu"), L7Rules, L7Plane)):
        proxy.update([type("P", (), {"redirects": [
            (p, "r", cls.from_dict(r)) for p, r in listeners.items()]})()])
        plane = plane_cls(proxy)
        kinds.append([plane._kind_of(p) for p in (10000, 10053, 19092,
                                                  11000, 4242)])
    assert kinds[0] == kinds[1] == ["http", "dns", "kafka", "memcached",
                                    "http"]


# -- the daemon against the JAX daemon ----------------------------------------

CT = 1 << 12
WEB, DB = "10.0.1.1", "10.0.2.1"
N_REMOTE = 6
RULES_HTTP = [{
    "endpointSelector": {"matchLabels": {"app": "db"}},
    "ingress": [
        {"fromEndpoints": [{"matchLabels": {"app": "web"}}],
         "toPorts": [{"ports": [{"port": "80", "protocol": "TCP"}],
                      "rules": {"http": [{"method": "GET",
                                          "path": "/public"}]}}]},
        {"fromEndpoints": [{"matchLabels": {"ns": "default"}}],
         "toPorts": [{"ports": [{"port": "8080", "protocol": "TCP"}],
                      "rules": {"http": [{"method": "GET",
                                          "path": "/static/.*"}]}}]},
        {"fromEndpoints": [{"matchLabels": {"ns": "default"}}],
         "toPorts": [{"ports": [{"port": "5432", "protocol": "TCP"}]}]},
    ],
}]


def _request_source(port, kind, task):
    """Deterministic requests per redirected row group: a mix the rules
    allow and deny, so both totals are exercised."""
    paths = ("/public", "/static/a.js", "/secret", "/static/")
    return [{"method": "GET" if i % 5 else "POST",
             "path": paths[(i + port) % 4]} for i in range(task.rows)]


def _http_world(d, labelset):
    for i in range(N_REMOTE):
        ident = d.allocator.allocate(labelset.parse(f"k8s:app=svc{i}",
                                                    "k8s:ns=default"))
        d.ipcache.upsert(f"10.1.0.{i + 1}/32", ident.numeric_id,
                         source="k8s")
    d.policy_import(RULES_HTTP)
    web = d.add_endpoint("web", (WEB,), ["k8s:app=web", "k8s:ns=default"])
    db = d.add_endpoint("db", (DB,), ["k8s:app=db"])
    return web, db


def _http_rows(rng, n, db_id, sport0):
    srcs = [WEB] + [f"10.1.0.{i + 1}" for i in range(N_REMOTE)]
    return make_batch([
        dict(src=srcs[int(rng.integers(0, len(srcs)))], dst=DB,
             sport=sport0 + i,
             dport=int(rng.choice([80, 8080, 5432, 22])), proto=6,
             flags=TCP_SYN, ep=db_id, dir=0)
        for i in range(n)]).data


def test_daemon_l7_ledger_matches_jax():
    """The same world, rules, rows and request source through both
    daemons' serve_batch: the same redirect events, and the same L7
    ledger once neither pool sheds (queue depth 128, above the task
    count: at most 7 sources x 2 ports a batch, 4 batches)."""
    jd = JDaemon(JConfig(backend="tpu", ct_capacity=CT, mesh_auth=False,
                         enable_hubble=False, flow_agg_enabled=False,
                         history_interval=0.0, l7_workers=1,
                         l7_queue_depth=128))
    td = Daemon(DaemonConfig(ct_capacity=CT, l7_workers=1,
                             l7_queue_depth=128), device="cpu")
    ids = []
    for d, mod in ((jd, "cilium_tpu"), (td, "cilium_tpu_torch")):
        ls = __import__(f"{mod}.labels", fromlist=["LabelSet"]).LabelSet
        web, db = _http_world(d, ls)
        ids.append((web.id, db.id, web.identity.numeric_id))
    assert ids[0] == ids[1]
    assert td.proxy.ports == jd.proxy.ports and len(td.proxy.ports) == 2
    evs = ([], [])
    rng = np.random.default_rng(11)
    batches = [_http_rows(rng, 256, ids[0][1], 20000 + 300 * b)
               for b in range(4)]
    for d, ev in zip((jd, td), evs):
        d.monitor.register("t", ev.append)
        d.l7_request_source = _request_source
        d.start_serving(ring_capacity=1 << 12, drain_every=1,
                        trace_sample=0)
        for b, rows in enumerate(batches):
            d.serve_batch(rows.copy(), now=10 + b)
    outs = [d.stop_serving() for d in (jd, td)]
    want, got = (_assert_l7_ledger(o["l7"]) for o in outs)
    for k in ("redirected", "l7-allowed", "l7-denied", "l7-shed",
              "l7-failed", "tasks-submitted", "tasks-done",
              "batches-ingested"):
        assert got[k] == want[k], k
    assert got["l7-allowed"] > 0 and got["l7-denied"] > 0
    assert got["l7-shed"] == got["l7-failed"] == 0
    for c in ("verdict", "proxy_port", "identity"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(b, c) for b in evs[1]]),
            np.concatenate([getattr(b, c) for b in evs[0]]), err_msg=c)
    redirects = sum(int((b.verdict == VERDICT_REDIRECT).sum())
                    for b in evs[1])
    assert redirects == got["redirected"] > 0
    # the offline entry answers as the reference's does
    reqs = [{"method": "GET", "path": "/public"},
            {"method": "GET", "path": "/secret"},
            {"method": "POST", "path": "/public"}]
    port80 = sorted(td.proxy.ports)[0]
    for d in (jd, td):
        assert d.handle_l7_http(port80, reqs,
                                src_identity=ids[0][2]).tolist() == [1, 0, 0]
    ps = td.proxy_stats()
    assert ps["plane"] is td._l7_last and not ps["plane-active"]
    assert ps["requests-total"] == (got["l7-allowed"] + got["l7-denied"]
                                    + len(reqs))
    for d in (jd, td):
        d.shutdown()


@pytest.mark.parametrize("knob", ["l7_workers", "l7_queue_depth"])
def test_l7_knobs_validated_at_construction(knob):
    with pytest.raises(ValueError, match=knob):
        Daemon(DaemonConfig(**{knob: 0}), device="cpu")


# -- the FQDN loop under live serving -----------------------------------------


def _dns_rows(ep, n=64, base=20000):
    # unique sports: every packet a NEW flow, so every redirect verdict
    # emits an event the plane can ingest
    return make_batch([
        dict(src="10.0.1.1", dst="8.8.8.8", sport=base + i, dport=53,
             proto=17, flags=TCP_SYN, ep=ep, dir=1)
        for i in range(n)]).data


def _probe_rows(ep, dst, dport=443, n=64, base=50000):
    return make_batch([
        dict(src="10.0.1.1", dst=dst, sport=base + i, dport=dport,
             proto=6, flags=TCP_SYN, ep=ep, dir=1)
        for i in range(n)]).data


def _probe_verdicts(got, sport_lo, sport_hi, dport):
    out = {}
    for b in list(got):
        m = ((b.hdr[:, COL_DPORT] == dport) & (b.hdr[:, COL_SPORT] >= sport_lo)
             & (b.hdr[:, COL_SPORT] < sport_hi))
        for sp, v in zip(b.hdr[m, COL_SPORT].tolist(),
                         b.verdict[m].tolist()):
            out[int(sp)] = int(v)
    return out


def _dns_daemon():
    d = Daemon(DaemonConfig(ct_capacity=CT, serving_queue_depth=4096,
                            serving_bucket_ladder=(64,),
                            serving_max_wait_us=500.0,
                            map_pressure_interval=0.0, l7_workers=2,
                            l7_queue_depth=64), device="cpu")
    ep = d.add_endpoint("client-1", ("10.0.1.1",), ["k8s:app=client"])
    d.policy_import(RULES_DNS)
    d.l7_request_source = \
        lambda port, kind, task: ["example.com"] * task.rows
    d.l7_dns_resolver = lambda q: ([EXAMPLE_IP], 300)
    got = []
    d.monitor.register("t", got.append)
    d.start()
    return d, ep, got


def test_fqdn_mint_flips_verdicts_under_serving():
    """Probes to the unresolved IP drop; a DNS batch redirects, the L7
    workers allow example.com, the answer mints an FQDN identity, and
    the next probes are allowed, mid-serving.  The port has no
    incremental patch path yet (ROADMAP A2/A3): the mint pays a full
    regeneration (attach_count moves), where the reference patches
    in place without recompiling."""
    d, ep, got = _dns_daemon()
    d.start_serving(trace_sample=0, ingress=True, drain_every=1)
    try:
        d.submit(_probe_rows(ep.id, EXAMPLE_IP, base=50000))
        assert _wait(lambda: len(_probe_verdicts(got, 50000, 50064,
                                                 443)) == 64)
        pre = _probe_verdicts(got, 50000, 50064, 443)
        assert all(v != VERDICT_ALLOW for v in pre.values()), pre
        attaches = d.loader.attach_count
        for r in range(2):
            d.submit(_dns_rows(ep.id, base=20000 + r * 100))
        assert _wait(lambda: len(d.fqdn.entries()) >= 1)
        assert _wait(lambda: d._l7plane.pool.pending == 0)
        assert d.loader.attach_count > attaches  # a full regeneration
        d.submit(_probe_rows(ep.id, EXAMPLE_IP, base=51000))
        assert _wait(lambda: len(_probe_verdicts(got, 51000, 51064,
                                                 443)) == 64)
        post = _probe_verdicts(got, 51000, 51064, 443)
        assert all(v == VERDICT_ALLOW for v in post.values()), post
        st = d.stop_serving()
    finally:
        d.shutdown()
    fe, l7 = st["front-end"], _assert_l7_ledger(st["l7"])
    assert fe["submitted"] == (fe["verdicts"] + fe["shed"]
                               + fe["fault-tolerance"]["recovery-dropped"])
    assert l7["redirected"] == l7["l7-allowed"] == 128
    assert l7["dns-answers"] >= 1
    assert [e["ip"] for e in d.fqdn.entries()] == [EXAMPLE_IP]


def test_mint_racing_the_drain_thread_matches_a_serial_run():
    """A producer keeps probe batches flowing while an L7 worker mints
    the identity and regenerates.  The loader swaps tables under the
    lock its serve calls take, so every probe batch sees one table
    generation (all its rows drop, or all are allowed, never a mix),
    once allowed they stay allowed, and afterwards the raced daemon
    verdicts a fresh batch exactly as a daemon that observed the same
    answer serially."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    d, ep, got = _dns_daemon()
    sent = []
    try:
        d.start_serving(trace_sample=0, ingress=True, drain_every=1)

        def produce():
            # probes before, during and after the mint: two more
            # batches once the identity exists, at most 200 in all
            after = 0
            for b in range(200):
                d.submit(_probe_rows(ep.id, EXAMPLE_IP,
                                     base=40000 + 64 * b))
                sent.append(b)
                if b == 2:
                    d.submit(_dns_rows(ep.id))
                after += bool(d.fqdn.entries())
                if after > 2:
                    return
                time.sleep(0.001)

        t = threading.Thread(target=produce)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        n_probe = len(sent)
        assert _wait(lambda: len(_probe_verdicts(
            got, 40000, 40000 + 64 * n_probe, 443)) == 64 * n_probe)
        assert _wait(lambda: len(d.fqdn.entries()) == 1)
        st = d.stop_serving()
    finally:
        sys.setswitchinterval(old)
    _assert_l7_ledger(st["l7"])
    pv = _probe_verdicts(got, 40000, 40000 + 64 * n_probe, 443)
    per_batch = [{pv[40000 + 64 * b + i] for i in range(64)}
                 for b in range(n_probe)]
    assert all(len(v) == 1 for v in per_batch), per_batch
    flags = [VERDICT_ALLOW in v for v in per_batch]
    assert flags == sorted(flags)  # drop ... drop, allow ... allow
    assert not flags[0] and flags[-1]
    # the serial run: the same answer observed before serving
    serial, sep, sgot = _dns_daemon()
    assert sep.id == ep.id
    serial.proxy.observe_answer("example.com", [EXAMPLE_IP], ttl=300)
    rows = _probe_rows(ep.id, EXAMPLE_IP, base=60000)
    want = []
    for s, ev in ((d, got), (serial, sgot)):
        ev.clear()
        s.start_serving(trace_sample=0, drain_every=1)
        s.serve_batch(rows.copy(), now=500)
        s.stop_serving()
        want.append(np.concatenate([b.verdict for b in ev]))
        s.shutdown()
    np.testing.assert_array_equal(want[0], want[1])
    assert (want[0] == VERDICT_ALLOW).all()


def test_two_subjects_get_distinct_stable_listener_ports():
    """Two endpoints with L7 rules get two listeners (one HTTP, one
    DNS) on distinct ports that survive a re-resolve.  The reference's
    repository allocates each subject's ports from 10000 afresh, so
    there the two would collide on one port and the proxy would keep
    only the first listener; the port's repository keeps one registry
    (ROADMAP queue C)."""
    d = Daemon(DaemonConfig(ct_capacity=CT), device="cpu")
    d.policy_import(RULES_HTTP[:1] + RULES_DNS)
    d.add_endpoint("db", (DB,), ["k8s:app=db"])
    d.add_endpoint("client", ("10.0.1.9",), ["k8s:app=client"])
    kinds = {li["proxy-port"]: (li["http-rules"], li["dns-rules"])
             for li in d.proxy.listeners()}
    assert sorted(kinds.values()) == [(0, 2), (1, 0), (1, 0)]
    before = d.proxy.ports
    d.policy_import([{"endpointSelector": {"matchLabels": {"app": "web"}},
                      "ingress": [{"fromEndpoints": [{}]}]}])
    d.add_endpoint("web", (WEB,), ["k8s:app=web"])
    assert d.proxy.ports == before and len(before) == 3
    d.shutdown()
