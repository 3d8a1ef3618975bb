"""The second slice end to end: the port's ``Daemon`` (device="cpu",
the plain PyTorch versions) against the JAX package's ``Daemon``
(backend "tpu", JAX on the CPU).  The same endpoints, identities,
ipcache entries, rules and rows go through ``serve_batch`` and
``serve_superbatch`` at a fixed clock: the monitor events (wall-clock
timestamps aside), metrics and CT rows are bit-exact.  Then the ingress
front end (``submit`` -> ``stop_serving``): its ledger is exact and its
metrics equal the JAX daemon's for forward-only traffic; the
``upsert_ipcache`` fallback verdicts as the JAX daemon's patch path
does; and every unported feature raises NotImplementedError naming its
ROADMAP item."""

import threading
import time

import numpy as np
import pytest
import torch

from cilium_tpu.agent import Daemon as JDaemon, DaemonConfig as JConfig
from cilium_tpu.core.packets import pack_eligibility, pack_rows
from cilium_tpu.labels import LabelSet as JLabelSet
from cilium_tpu.serving.batcher import SuperBatch as JSuperBatch
from cilium_tpu_torch.agent import Daemon, DaemonConfig
from cilium_tpu_torch.core.packets import (COL_DIR, COL_DPORT, COL_DST_IP3,
                                           COL_EP, COL_FAMILY, COL_FLAGS,
                                           COL_LEN, COL_PROTO, COL_SPORT,
                                           COL_SRC_IP3, N_COLS, TCP_ACK,
                                           TCP_SYN, ip_to_words)
from cilium_tpu_torch.labels import LabelSet
from cilium_tpu_torch.serving.batcher import SuperBatch

torch.set_num_threads(1)

CT = 1 << 12
N_REMOTE = 32
LADDER = (256, 1024)
RULES = [{
    "endpointSelector": {"matchLabels": {"app": "db"}},
    "ingress": [
        {"fromEndpoints": [{"matchLabels": {"app": "web"}}],
         "toPorts": [{"ports": [{"port": "5432", "protocol": "TCP"}]}]},
        {"fromEndpoints": [{"matchLabels": {"ns": "default"}}],
         "toPorts": [{"ports": [{"port": "8000", "endPort": 8100,
                                 "protocol": "TCP"}]}]},
        {"fromCIDR": ["192.168.0.0/16"],
         "toPorts": [{"ports": [{"port": "443", "protocol": "TCP"}]}]},
    ],
    "ingressDeny": [
        {"fromEndpoints": [{"matchLabels": {"app": "svc0"}}],
         "toPorts": [{"ports": [{"port": "8050", "protocol": "TCP"}]}]},
    ],
    "egress": [
        {"toEntities": ["world"],
         "toPorts": [{"ports": [{"port": "53", "protocol": "UDP"}]}]},
    ],
}]
WEB, DB = "10.0.1.1", "10.0.2.1"


def _remote_ip(i):
    return f"10.1.{i // 250}.{i % 250 + 1}"


def _build(d, labelset):
    """Remote identities with their /32s before any endpoint, the rules,
    then the endpoints (the daemon phase's order)."""
    for i in range(N_REMOTE):
        ident = d.allocator.allocate(labelset.parse(f"k8s:app=svc{i}",
                                                    "k8s:ns=default"))
        d.ipcache.upsert(_remote_ip(i) + "/32", ident.numeric_id,
                         source="k8s")
    d.policy_import(RULES)
    web = d.add_endpoint("web", (WEB,), ["k8s:app=web"])
    db = d.add_endpoint("db", (DB,), ["k8s:app=db"])
    return web.id, db.id


def _daemons(**serving):
    jd = JDaemon(JConfig(backend="tpu", ct_capacity=CT, mesh_auth=False,
                         enable_hubble=False, flow_agg_enabled=False,
                         history_interval=0.0, **serving))
    td = Daemon(DaemonConfig(ct_capacity=CT, **serving), device="cpu")
    ids = [_build(d, ls) for d, ls in ((jd, JLabelSet), (td, LabelSet))]
    assert ids[0] == ids[1]
    return jd, td, ids[0]


def _collect(d):
    got = []
    d.monitor.register("test", got.append)
    return got


def _events(batches):
    cols = ("msg_type", "verdict", "reason", "ct_state", "identity",
            "proxy_port")
    if not batches:
        return {c: np.zeros(0) for c in cols + ("hdr",)}
    out = {c: np.concatenate([getattr(b, c) for b in batches])
           for c in cols}
    out["hdr"] = np.concatenate([b.hdr for b in batches])
    return out


def _ingress_rows(rng, n, db_id, sport0=20000):
    """Forward traffic into db: web, the remote pods, 192.168/16 and
    unknown sources, on allowed, denied and unmatched ports."""
    srcs = np.array([ip_to_words(WEB)[3]]
                    + [ip_to_words(_remote_ip(i))[3] for i in range(N_REMOTE)]
                    + [ip_to_words("192.168.7.9")[3],
                       ip_to_words("172.16.0.3")[3]], np.uint32)
    rows = np.zeros((n, N_COLS), np.uint32)
    rows[:, COL_SRC_IP3] = rng.choice(srcs, n)
    rows[:, COL_DST_IP3] = ip_to_words(DB)[3]
    rows[:, COL_SPORT] = sport0 + rng.integers(0, 4000, n)
    rows[:, COL_DPORT] = rng.choice(np.array([5432, 8050, 8000, 443, 22,
                                              9999], np.uint32), n)
    rows[:, COL_PROTO] = 6
    rows[:, COL_FLAGS] = rng.choice(np.array([TCP_SYN, TCP_ACK],
                                             np.uint32), n)
    rows[:, COL_LEN] = rng.integers(40, 1500, n)
    rows[:, COL_FAMILY] = 4
    rows[:, COL_EP] = db_id
    rows[:, COL_DIR] = 0
    return rows


def _egress_rows(rng, n, db_id):
    """db's egress: UDP 53 and TCP to world (v4 and v6) and to web."""
    rows = _ingress_rows(rng, n, db_id)
    rows[:, COL_SRC_IP3] = ip_to_words(DB)[3]
    rows[:, COL_DST_IP3] = rng.choice(np.array(
        [ip_to_words("8.8.8.8")[3], ip_to_words(WEB)[3]], np.uint32), n)
    v6 = rng.random(n) < 0.2
    rows[v6, COL_DST_IP3 - 3:COL_DST_IP3 + 1] = ip_to_words("2001:db8::5")
    rows[v6, COL_FAMILY] = 6
    rows[:, COL_PROTO] = rng.choice(np.array([6, 17], np.uint32), n)
    rows[:, COL_DPORT] = rng.choice(np.array([53, 80], np.uint32), n)
    rows[:, COL_DIR] = 1
    return rows


def test_daemon_matches_jax_through_serve_batch_and_superbatch():
    jd, td, (_web, db) = _daemons()
    jev, tev = _collect(jd), _collect(td)
    for d in (jd, td):
        d.start_serving(ring_capacity=1 << 12, drain_every=2,
                        trace_sample=16)
    rng = np.random.default_rng(1)
    now = 50
    plan = []
    for b in range(3):  # packed single batches
        rows = _ingress_rows(rng, 256, db)
        valid = rng.random(256) < 0.9
        plan.append(("packed", rows, valid))
    plan.append(("wide", _egress_rows(rng, 256, db), np.ones(256, bool)))
    fwd = _ingress_rows(rng, 256, db)
    plan.append(("super", np.stack([fwd, _ingress_rows(rng, 256, db)]),
                 None))
    plan.append(("wide", _ingress_rows(rng, 256, db),
                 rng.random(256) < 0.8))
    for kind, rows, valid in plan:
        for d, sb_cls in ((jd, JSuperBatch), (td, SuperBatch)):
            if kind == "packed":
                ok, ep, dirn = pack_eligibility(rows)
                assert ok
                d.serve_batch(pack_rows(rows), now=now, valid=valid,
                              packed_meta=(ep, dirn))
            elif kind == "wide":
                d.serve_batch(rows, now=now, valid=valid)
            else:
                metas = [pack_eligibility(r) for r in rows]
                sb = sb_cls(hdr=np.stack([pack_rows(r) for r in rows]),
                            valid=np.ones(rows.shape[:2], bool),
                            bucket=rows.shape[1], arrivals=[],
                            packed=True,
                            eps=np.array([m[1] for m in metas], np.uint32),
                            dirns=np.array([m[2] for m in metas],
                                           np.uint32))
                d.serve_superbatch(sb, now=now)
        now += 5
    outs = [d.stop_serving() for d in (jd, td)]
    for k in ("windows", "events", "lost"):
        assert outs[0][k] == outs[1][k], k
    assert outs[1]["events"] > 0 and outs[1]["lost"] == 0
    want, got = _events(jev), _events(tev)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    assert set(np.unique(got["reason"])) >= {0, 1, 2}
    np.testing.assert_array_equal(td.loader.metrics(), jd.loader.metrics())
    np.testing.assert_array_equal(td.loader.ct_snapshot(),
                                  jd.loader.ct_snapshot())
    for d in (jd, td):
        d.shutdown()


def _assert_ledger(fe):
    ft = fe["fault-tolerance"]
    assert fe["submitted"] == (fe["verdicts"] + fe["shed"]
                               + ft["recovery-dropped"]), fe


def test_ingress_ledger_and_metrics_match_jax():
    """submit() from a producer thread, stop_serving(): the ledger is
    exact, and the metrics equal the JAX daemon's over the same rows in
    fixed batches (forward-only traffic: verdicts do not depend on
    batch boundaries)."""
    serving = dict(serving_bucket_ladder=LADDER, serving_queue_depth=1 << 14,
                   serving_max_wait_us=500.0)
    jd, td, (_web, db) = _daemons(**serving)
    rng = np.random.default_rng(2)
    rows = _ingress_rows(rng, 6000, db)
    td.start()
    td.start_serving(ingress=True, packed=True, superbatch_k=2,
                     ring_capacity=1 << 12)
    ev = _collect(td)

    def produce():
        # one chunk of four top buckets first: the drain loop then finds
        # at least two full buckets pending and dispatches a superbatch
        td.submit(rows[:4096])
        for i in range(4096, len(rows), 700):
            td.submit(rows[i:i + 700])

    t = threading.Thread(target=produce)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    out = td.stop_serving()
    fe = out["front-end"]
    _assert_ledger(fe)
    assert fe["submitted"] == fe["verdicts"] == len(rows)
    assert fe["dispatch"]["superbatches"] > 0
    assert out["lost"] == 0 and sum(len(b) for b in ev) == out["events"]
    jd.start_serving(ring_capacity=1 << 12)
    for i in range(0, len(rows), 1024):
        chunk = rows[i:i + 1024]
        hdr = np.zeros((1024, N_COLS), np.uint32)
        hdr[:len(chunk)] = chunk
        jd.serve_batch(hdr, now=1, valid=np.arange(1024) < len(chunk))
    jd.stop_serving()
    np.testing.assert_array_equal(td.loader.metrics(), jd.loader.metrics())
    # the controllers ran: a map-pressure sample at start(), gc on call
    assert td.pressure.samples >= 1
    assert td.pressure.last["ct"]["capacity"] == CT
    for d in (jd, td):
        d.shutdown()


def test_ingress_overflow_sheds_counted():
    """One chunk larger than the queue sheds; the ledger stays exact
    and every shed row surfaces as an INGRESS_OVERFLOW drop event."""
    td = Daemon(DaemonConfig(ct_capacity=CT, serving_bucket_ladder=LADDER,
                             serving_queue_depth=2048), device="cpu")
    _web, db = _build(td, LabelSet)
    td.start_serving(ingress=True, packed=True, ring_capacity=1 << 12)
    ev = _collect(td)
    rows = _ingress_rows(np.random.default_rng(3), 5000, db)
    admitted = td.submit(rows)
    out = td.stop_serving()
    fe = out["front-end"]
    _assert_ledger(fe)
    assert fe["shed"] == len(rows) - admitted > 0
    shed_events = sum(int((b.reason == 9).sum()) for b in ev)
    assert shed_events == fe["shed"]
    assert td.loader.metrics().sum() == fe["verdicts"]
    td.shutdown()


def test_upsert_ipcache_falls_back_to_regeneration_like_jax_patch():
    """The port's loader answers False to every in-place patch (a full
    attach is required); upsert_ipcache then regenerates, and the
    verdicts equal the JAX daemon's, which patches in place."""
    jd, td, (_web, db) = _daemons()
    assert td.loader.patch_ipcache("10.9.0.0/16", 1) is False
    assert td.loader.delete_ipcache("10.9.0.0/16") is False
    assert td.loader.patch_identity("add", 1, []) is False
    svc3 = [d.allocator.lookup_by_labels(ls.parse("k8s:app=svc3",
                                                  "k8s:ns=default"))
            for d, ls in ((jd, JLabelSet), (td, LabelSet))]
    assert svc3[0].numeric_id == svc3[1].numeric_id
    before = td.loader.attach_count
    for d in (jd, td):
        d.start()
        d.upsert_ipcache("10.9.0.0/16", svc3[0].numeric_id)
    assert td.loader.attach_count == before + 1
    rows = _ingress_rows(np.random.default_rng(4), 256, db)
    rows[::2, COL_SRC_IP3] = ip_to_words("10.9.4.4")[3]
    rows[:, COL_DPORT] = np.where(np.arange(256) % 4 < 2, 8050, 8000)
    evs = [_collect(d) for d in (jd, td)]
    for d in (jd, td):
        d.start_serving(ring_capacity=1 << 12, trace_sample=1)
        d.serve_batch(rows, now=9)
        d.stop_serving()
    want, got = _events(evs[0]), _events(evs[1])
    for c in want:
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    from_patch = got["hdr"][:, COL_SRC_IP3] == ip_to_words("10.9.4.4")[3]
    assert (got["identity"][from_patch] == svc3[0].numeric_id).all()
    np.testing.assert_array_equal(td.loader.metrics(), jd.loader.metrics())
    for d in (jd, td):
        d.shutdown()


@pytest.fixture(autouse=True)
def _disarm_port_faults():
    """No armed injector of the port may leak into the next test."""
    yield
    from cilium_tpu_torch.infra import faults

    faults.disarm()


def _fault_daemon(spec):
    td = Daemon(DaemonConfig(
        ct_capacity=CT, serving_queue_depth=4096,
        serving_bucket_ladder=(256,), serving_max_wait_us=500.0,
        serving_dispatch_deadline_ms=2000.0, serving_restart_budget=4,
        serving_restart_backoff_ms=1.0, serving_demote_threshold=2,
        serving_promote_after=3, serving_promote_cooldown_s=0.05,
        fault_injection=spec, fault_seed=1), device="cpu")
    _web, db = _build(td, LabelSet)
    return td, db


def _wait(pred, timeout=30.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(0.002)
    return True


def test_packed_demotes_to_wide_then_promotes_back():
    """Two packed-path faults: the first is contained (its rows become
    counted recovery drops), the second demotes single -> wide and its
    batch retries on the demoted rung; sustained health promotes back.
    The ledger stays exact, and the metricsmap counts the recovery
    drops under REASON_RECOVERY_DROP (11)."""
    td, db = _fault_daemon("loader.serve_packed=1x2@1")
    td.start_serving(trace_sample=0, ingress=True, packed=True,
                     drain_every=2, ring_capacity=1 << 12)
    rt = td._serving["runtime"]
    rng = np.random.default_rng(8)
    td.submit(_ingress_rows(rng, 256, db))  # warm (packed)
    assert _wait(lambda: rt.stats.verdicts >= 256)
    td.submit(_ingress_rows(rng, 256, db))  # fault 1: contained drop
    assert _wait(lambda: rt.stats.recovery_dropped >= 256)
    td.submit(_ingress_rows(rng, 256, db))  # fault 2: demote + retry
    assert _wait(lambda: rt.stats.verdicts >= 512)
    st = td.serving_stats()
    assert st["mode"] == "wide" and st["ladder"]["demotions"] == 1
    assert rt.stats.restarts == 0
    for i in range(5):
        td.submit(_ingress_rows(rng, 256, db))
        assert _wait(lambda i=i: rt.stats.verdicts >= 512 + (i + 1) * 256)
        time.sleep(0.02)
    assert _wait(lambda: td.serving_stats()["mode"] == "single",
                 timeout=10)
    out = td.stop_serving()
    fe = out["front-end"]
    _assert_ledger(fe)
    assert fe["fault-tolerance"]["recovery-dropped"] == 256
    m = td.loader.metrics()
    assert m[11, 0] == 256 and m.sum() == fe["verdicts"] + 256
    assert {i["kind"] for i in td.incidents} == {"ladder-demotion"}
    td.shutdown()


def test_dead_dispatch_restarts_and_accounts_the_batch():
    """A dispatch that raises outside the ladder kills the drain
    thread: the watchdog restarts it and the lost batch is counted as
    recovery drops, metricsmap and DROP events alike."""
    td, db = _fault_daemon("serving.dispatch=1x1@1")
    ev = _collect(td)
    td.start_serving(ingress=True, packed=True, ring_capacity=1 << 12)
    rt = td._serving["runtime"]
    rng = np.random.default_rng(9)
    for _ in range(3):
        td.submit(_ingress_rows(rng, 256, db))
        assert _wait(lambda: rt.stats.verdicts + rt.stats.recovery_dropped
                     >= 256 * (_ + 1))
    out = td.stop_serving()
    fe = out["front-end"]
    _assert_ledger(fe)
    assert fe["fault-tolerance"]["restarts"] == 1
    assert fe["fault-tolerance"]["recovery-dropped"] == 256
    assert td.loader.metrics()[11, 0] == 256
    assert sum(int((b.reason == 11).sum()) for b in ev) == 256
    td.shutdown()


@pytest.mark.parametrize("knob,value,item", [
    ("serving_trace_sample", 4, "A14"), ("profile_dir", "/nonexistent",
                                         "A14"),
    ("enable_hubble", True, "A13"), ("flow_agg_enabled", True, "A14"),
    ("sysdump_dir", "/nonexistent", "A14"),
    ("history_interval", 10.0, "A14"), ("mesh_auth", True, "A5"),
    ("enable_encryption", True, "A15"), ("masquerade", True, "A8"),
    ("policy_audit_mode", True, "A16"),
    ("monitor_aggregation", "medium", "A16")])
def test_unported_config_raises_naming_its_roadmap_item(knob, value, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        Daemon(DaemonConfig(**{knob: value}), device="cpu")


def test_unported_calls_raise_naming_their_roadmap_item():
    td = Daemon(DaemonConfig(ct_capacity=CT), device="cpu")
    auth = [{"endpointSelector": {"matchLabels": {"app": "db"}},
             "ingress": [{"fromEndpoints": [{}],
                          "authentication": {"mode": "required"}}]}]
    cases = [(lambda: td.policy_import(auth), "A5"),
             (lambda: td.start_serving(mesh=8), "A10"),
             (lambda: td.start_serving(span_sample=4), "A14"),
             (lambda: td.set_bandwidth(1, 1000), "A8")]
    for call, item in cases:
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            call()
    assert td.repo.revision == 1  # the rule set was not imported
    assert td._serving is None
    td.shutdown()


def test_runtime_profile_window_raises_naming_its_roadmap_item():
    from cilium_tpu_torch.serving import ServingRuntime

    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        ServingRuntime(dispatch=lambda *a, **k: None, queue_depth=1024,
                       bucket_ladder=(256,), max_wait_us=100.0,
                       profile_dir="/nonexistent")


def test_daemon_defaults_to_the_card():
    if torch.cuda.is_available():
        assert Daemon(DaemonConfig(ct_capacity=CT)).loader.device.type == \
            "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Daemon(DaemonConfig(ct_capacity=CT))


def test_controllers_sweep_and_sample_in_the_background():
    """start() schedules the ct-gc and map-pressure controllers; both
    tick on their own threads against the port's loader."""
    td = Daemon(DaemonConfig(ct_capacity=CT, ct_gc_interval=0.02,
                             map_pressure_interval=0.02), device="cpu")
    td.start()
    t0 = time.monotonic()
    while td.pressure.samples < 3 and time.monotonic() - t0 < 10:
        time.sleep(0.01)
    assert td.pressure.samples >= 3
    st = td.controllers.statuses()
    assert set(st) == {"ct-gc", "map-pressure", "fqdn-gc"}
    td.shutdown()
