"""Policy audit mode and monitor trace aggregation through the port's
``Daemon`` (``device="cpu"``) against the JAX daemon (backend "tpu",
JAX on the CPU): the same endpoints, rules and rows give the same
verdicts, reasons, events, metrics and CT rows, exactly, through
``process_batch`` (the plain step and the service path's), packed and
wide ``serve_batch``, ``serve_superbatch`` and the sharded path; under
``monitor_aggregation="medium"`` the monitor sees exactly the rows the
reference's filter keeps, an endpoint with ``Debug`` on exempt.

Mirrors ``tests/test_audit_mode.py``.
"""

import numpy as np
import pytest
import torch

from cilium_tpu.agent import Daemon as JDaemon, DaemonConfig as JConfig
from cilium_tpu.core.packets import pack_eligibility, pack_rows
from cilium_tpu.serving.batcher import SuperBatch as JSuperBatch
from cilium_tpu_torch.agent import Daemon, DaemonConfig
from cilium_tpu_torch.core.packets import (COL_DIR, COL_DPORT, COL_DST_IP3,
                                           COL_EP, COL_FAMILY, COL_FLAGS,
                                           COL_LEN, COL_PROTO, COL_SPORT,
                                           COL_SRC_IP3, N_COLS, TCP_ACK,
                                           TCP_FIN, TCP_PSH, TCP_RST,
                                           TCP_SYN, ip_to_words, make_batch)
from cilium_tpu_torch.datapath.verdict import (OUT_REASON, OUT_VERDICT,
                                               REASON_AUTH_REQUIRED,
                                               REASON_FORWARDED,
                                               REASON_NAT_EXHAUSTED,
                                               REASON_NO_ENDPOINT,
                                               REASON_NO_SERVICE,
                                               REASON_POLICY_DEFAULT_DENY,
                                               REASON_POLICY_DENY)
from cilium_tpu_torch.monitor.api import MSG_TRACE
from cilium_tpu_torch.policy.mapstate import VERDICT_ALLOW
from cilium_tpu_torch.serving.batcher import SuperBatch

torch.set_num_threads(1)

NS = "k8s:io.kubernetes.pod.namespace=default"
RULES = [{
    "endpointSelector": {"matchLabels": {"app": "db"}},
    "ingress": [{
        "fromEndpoints": [{"matchLabels": {"app": "web"}}],
        "toPorts": [{"ports": [{"port": "5432", "protocol": "TCP"}]}],
    }],
    "ingressDeny": [{
        "fromEndpoints": [{"matchLabels": {"app": "web"}}],
        "toPorts": [{"ports": [{"port": "8050", "protocol": "TCP"}]}],
    }],
}]
WEB, DB = "10.0.1.1", "10.0.2.1"


def _pair(audit=True, mesh_auth=False, aggregation="none", **cfg):
    """The JAX daemon and the port's, built alike; -> (jd, td, web id,
    db id)."""
    out = []
    for mk, conf, extra in ((JDaemon, JConfig, {"backend": "tpu"}),
                            (lambda c: Daemon(c, device="cpu"), DaemonConfig,
                             {})):
        d = mk(conf(ct_capacity=1 << 12, policy_audit_mode=audit,
                    mesh_auth=mesh_auth, monitor_aggregation=aggregation,
                    **extra, **cfg))
        web = d.add_endpoint("web", (WEB,), ["k8s:app=web", NS])
        db = d.add_endpoint("db", (DB,), ["k8s:app=db", NS])
        d.policy_import(RULES)
        out.append((d, web.id, db.id))
    (jd, jw, jdb), (td, tw, tdb) = out
    assert (jw, jdb) == (tw, tdb)
    return jd, td, tw, tdb


def _pkt(d, ep, sport, dport=9999, flags=TCP_SYN, now=50, src=WEB):
    ev = d.process_batch(make_batch([
        dict(src=src, dst=DB, sport=sport, dport=dport, proto=6,
             flags=flags, ep=ep, dir=0)]).data, now=now)
    return int(ev.verdict[0]), int(ev.reason[0])


def _both(jd, td, *args, **kw):
    got = [_pkt(d, *args, **kw) for d in (jd, td)]
    assert got[1] == got[0]
    return got[1]


def _shutdown(*ds):
    for d in ds:
        d.shutdown()


def test_would_be_deny_forwards_with_reason():
    jd, td, _web, db = _pair()
    # port 9999 is outside the allow: default-deny, audited
    assert _both(jd, td, db, 41000) == (VERDICT_ALLOW,
                                        REASON_POLICY_DEFAULT_DENY)
    # ...and the flow got CT state: the ACK rides the fast path
    assert _both(jd, td, db, 41000, flags=TCP_ACK, now=51) == (
        VERDICT_ALLOW, REASON_FORWARDED)
    np.testing.assert_array_equal(td.loader.ct_snapshot(),
                                  jd.loader.ct_snapshot())
    _shutdown(jd, td)


def test_explicit_deny_audited():
    jd, td, _web, db = _pair()
    assert _both(jd, td, db, 42000, dport=8050) == (VERDICT_ALLOW,
                                                    REASON_POLICY_DENY)
    _shutdown(jd, td)


def test_auth_required_audited():
    jd, td, _web, db = _pair()
    for d in (jd, td):
        d.policy_import([{
            "endpointSelector": {"matchLabels": {"app": "db"}},
            "ingress": [{
                "fromEndpoints": [{"matchLabels": {"app": "web"}}],
                "authentication": {"mode": "required"},
            }],
        }])
    # port 7777 is covered ONLY by the auth-required rule
    assert _both(jd, td, db, 43000, dport=7777) == (VERDICT_ALLOW,
                                                    REASON_AUTH_REQUIRED)
    _shutdown(jd, td)


def test_non_policy_drops_still_drop():
    jd, td, _web, db = _pair()
    # lxcmap miss: an unregistered endpoint id still drops
    v, r = _both(jd, td, 999, 44000, dport=5432)
    assert r == REASON_NO_ENDPOINT and v != VERDICT_ALLOW
    # NO_SERVICE (an empty frontend) still drops: the service path's step
    got = []
    for d in (jd, td):
        d.services.upsert("empty", "172.20.0.10:80", [])
        ev = d.process_batch(make_batch([
            dict(src=DB, dst="172.20.0.10", sport=44001, dport=80, proto=6,
                 flags=TCP_SYN, ep=db, dir=1),
            dict(src=WEB, dst=DB, sport=44002, dport=9999, proto=6,
                 flags=TCP_SYN, ep=db, dir=0)]).data, now=51)
        got.append((ev.verdict.tolist(), ev.reason.tolist()))
    assert got[1] == got[0]
    assert got[1][1] == [REASON_NO_SERVICE, REASON_POLICY_DEFAULT_DENY]
    assert got[1][0][1] == VERDICT_ALLOW  # audited on the service path
    _shutdown(jd, td)


def test_pre_stage_drop_beats_audit():
    """A row policy denies AND a pre-stage condemns (NAT exhaustion)
    really drops under audit: audit spares only the policy stage."""
    jd, td, _web, db = _pair()
    hdr = make_batch([dict(src=WEB, dst=DB, sport=47000, dport=9999,
                           proto=6, flags=TCP_SYN, ep=db, dir=0)]).data
    outs = []
    for d in (jd, td):
        out, _rm = d.loader.step(hdr, 50, pre_drop=np.array([True]),
                                 audit=True)
        outs.append(np.asarray(out))
    np.testing.assert_array_equal(outs[1], outs[0])
    assert int(outs[1][0, OUT_REASON]) == REASON_NAT_EXHAUSTED
    assert int(outs[1][0, OUT_VERDICT]) != VERDICT_ALLOW
    _shutdown(jd, td)


def test_audit_off_denies():
    jd, td, _web, db = _pair(audit=False)
    v, r = _both(jd, td, db, 45000)
    assert v != VERDICT_ALLOW and r == REASON_POLICY_DEFAULT_DENY
    _shutdown(jd, td)


def test_flow_renders_audit_flag():
    jd, td, _web, db = _pair()
    _both(jd, td, db, 46000)
    got = []
    for d in (jd, td):
        flows = [f.to_dict() for f in d.observer.get_flows()
                 if f.to_dict().get("policy_audit")]
        assert flows, "an audited flow carries the audit signature"
        fd = flows[-1]
        assert fd["verdict"] == "FORWARDED"
        assert fd["drop_reason_desc"] == "POLICY_DENY_DEFAULT"
        fd.pop("time")
        got.append(fd)
    assert got[1] == got[0]
    _shutdown(jd, td)


def _rows(rng, n, db, sport0):
    """SYNs into db, every flow new (unique source ports): web on the
    allowed, the denied and an unmatched port; unknown sources."""
    srcs = np.array([ip_to_words(WEB)[3], ip_to_words("10.9.9.9")[3],
                     ip_to_words("192.168.3.3")[3]], np.uint32)
    rows = np.zeros((n, N_COLS), np.uint32)
    rows[:, COL_SRC_IP3] = rng.choice(srcs, n)
    rows[:, COL_DST_IP3] = ip_to_words(DB)[3]
    rows[:, COL_SPORT] = sport0 + np.arange(n)
    rows[:, COL_DPORT] = rng.choice(np.array([5432, 8050, 9999, 22],
                                             np.uint32), n)
    rows[:, COL_PROTO] = 6
    rows[:, COL_FLAGS] = TCP_SYN
    rows[:, COL_LEN] = rng.integers(40, 1500, n)
    rows[:, COL_FAMILY] = 4
    rows[:, COL_EP] = db
    return rows


def _collect(d):
    got = []
    d.monitor.register("test", got.append)
    return got


def _events(batches):
    cols = ("msg_type", "verdict", "reason", "ct_state", "identity",
            "proxy_port")
    out = {c: np.concatenate([getattr(b, c) for b in batches]) for c in cols}
    out["hdr"] = np.concatenate([b.hdr for b in batches])
    return out


def test_serving_paths_audit_equal_the_reference():
    """Packed and wide ``serve_batch`` and a packed ``serve_superbatch``
    with audit on: the events, metrics and CT equal the JAX daemon's,
    and every policy drop of a new flow forwarded with its reason."""
    jd, td, _web, db = _pair()
    jev, tev = _collect(jd), _collect(td)
    for d in (jd, td):
        d.start_serving(ring_capacity=1 << 12, drain_every=2,
                        trace_sample=1)
    rng = np.random.default_rng(5)
    plan = [("packed", _rows(rng, 256, db, 20000)),
            ("wide", _rows(rng, 256, db, 21000)),
            ("super", np.stack([_rows(rng, 256, db, 22000),
                                _rows(rng, 256, db, 23000)]))]
    now = 50
    for kind, rows in plan:
        for d, sb_cls in ((jd, JSuperBatch), (td, SuperBatch)):
            if kind == "packed":
                ok, ep, dirn = pack_eligibility(rows)
                assert ok
                d.serve_batch(pack_rows(rows), now=now,
                              valid=np.ones(256, bool),
                              packed_meta=(ep, dirn))
            elif kind == "wide":
                d.serve_batch(rows, now=now, valid=np.ones(256, bool))
            else:
                metas = [pack_eligibility(r) for r in rows]
                d.serve_superbatch(sb_cls(
                    hdr=np.stack([pack_rows(r) for r in rows]),
                    valid=np.ones(rows.shape[:2], bool),
                    bucket=rows.shape[1], arrivals=[], packed=True,
                    eps=np.array([m[1] for m in metas], np.uint32),
                    dirns=np.array([m[2] for m in metas], np.uint32)),
                    now=now)
        now += 5
    outs = [d.stop_serving() for d in (jd, td)]
    assert outs[1]["events"] == outs[0]["events"] == 4 * 256
    want, got = _events(jev), _events(tev)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    assert (got["verdict"] == VERDICT_ALLOW).all()
    assert {REASON_POLICY_DEFAULT_DENY, REASON_POLICY_DENY} <= set(
        got["reason"].tolist())
    np.testing.assert_array_equal(td.loader.metrics(), jd.loader.metrics())
    np.testing.assert_array_equal(td.loader.ct_snapshot(),
                                  jd.loader.ct_snapshot())
    _shutdown(jd, td)


def test_sharded_audit_equals_the_unsharded_path():
    """The sharded serve step (4 shards on the CPU) with audit on: new
    flows verdict as on the single-shard path, which the test above
    holds to the reference; the would-be denies forward."""
    got = []
    for mesh in (None, 4):
        td = Daemon(DaemonConfig(ct_capacity=1 << 12,
                                 policy_audit_mode=True, mesh_auth=False),
                    device="cpu")
        td.add_endpoint("web", (WEB,), ["k8s:app=web", NS])
        db = td.add_endpoint("db", (DB,), ["k8s:app=db", NS]).id
        td.policy_import(RULES)
        ev = _collect(td)
        td.start_serving(ring_capacity=1 << 12, trace_sample=1, mesh=mesh)
        rows = _rows(np.random.default_rng(6), 256, db, 30000)
        td.serve_batch(rows, now=50, valid=np.ones(256, bool))
        out = td.stop_serving()
        assert out["lost"] == 0 and out["events"] == 256
        e = _events(ev)
        order = np.argsort(e["hdr"][:, COL_SPORT], kind="stable")
        got.append({c: v[order] for c, v in e.items()})
        td.shutdown()
    for c in got[0]:
        np.testing.assert_array_equal(got[1][c], got[0][c], err_msg=c)
    assert (got[1]["verdict"] == VERDICT_ALLOW).all()
    assert (got[1]["reason"] == REASON_POLICY_DEFAULT_DENY).any()


def _medium_filter(batch, debug_eps):
    """A numpy copy of the reference's "medium" aggregation: a TCP
    trace with none of SYN, FIN and RST is boring, unless its endpoint
    has Debug on."""
    proto = batch.hdr[:, COL_PROTO]
    flags = batch.hdr[:, COL_FLAGS]
    boring = ((proto == 6) & ((flags & (TCP_SYN | TCP_FIN | TCP_RST)) == 0)
              & (batch.msg_type == MSG_TRACE))
    boring &= ~np.isin(batch.hdr[:, COL_EP], list(debug_eps))
    return ~boring


@pytest.mark.parametrize("path", ["process_batch", "serve_batch"])
def test_medium_aggregation_keeps_what_the_reference_keeps(path):
    """Established flows of both endpoints (web with Debug on), every
    flag mix, UDP and drops: the monitor sees exactly the rows the
    reference's filter keeps (its copy in numpy), the same events as
    the JAX daemon's monitor, and the metrics keep every row."""
    jd, td, web, db = _pair(audit=False, aggregation="medium")
    for d in (jd, td):
        d.endpoints.update_config(web, options={"Debug": True})
    rng = np.random.default_rng(7)
    n = 512
    rows = _rows(rng, n, db, 40000)
    rows[:, COL_SRC_IP3] = ip_to_words(WEB)[3]
    rows[:, COL_DPORT] = rng.choice(np.array([5432, 5432, 5432, 9999],
                                             np.uint32), n)
    rows[::3, COL_EP] = web  # egress from web to db
    rows[::3, COL_DIR] = 1
    syn = rows.copy()
    rows[:, COL_FLAGS] = rng.choice(np.array(
        [TCP_ACK, TCP_PSH | TCP_ACK, TCP_FIN | TCP_ACK, TCP_RST, TCP_SYN,
         TCP_ACK], np.uint32), n)
    rows[::7, COL_PROTO] = 17
    seen, published = [], []
    for d in (jd, td):
        ev = _collect(d)
        if path == "process_batch":
            d.process_batch(syn, now=50)  # establishes the allowed flows
            full = d.process_batch(rows, now=51)
        else:
            d.start_serving(ring_capacity=1 << 12, trace_sample=1)
            d.serve_batch(syn, now=50, valid=np.ones(n, bool))
            d.serve_batch(rows, now=51, valid=np.ones(n, bool))
            d.stop_serving()
            full = None
        seen.append(_events(ev))
        published.append(d.monitor.published)
        if full is not None:
            # the caller's batch keeps every row; the monitor saw the kept
            assert len(full) == n
            keep = _medium_filter(full, {web})
            assert len(ev[-1]) == int(keep.sum()) < n
            np.testing.assert_array_equal(ev[-1].hdr, full.hdr[keep])
    for c in seen[0]:
        np.testing.assert_array_equal(seen[1][c], seen[0][c], err_msg=c)
    assert published[1] == published[0]
    # web's boring traces pass (Debug), db's do not
    traces = seen[1]["msg_type"] == MSG_TRACE
    tcp = seen[1]["hdr"][:, COL_PROTO] == 6
    quiet = (seen[1]["hdr"][:, COL_FLAGS] & (TCP_SYN | TCP_FIN | TCP_RST)) == 0
    boring_seen = traces & tcp & quiet
    assert boring_seen.any()
    assert (seen[1]["hdr"][boring_seen, COL_EP] == web).all()
    np.testing.assert_array_equal(td.loader.metrics(), jd.loader.metrics())
    _shutdown(jd, td)


def test_bad_aggregation_value_raises():
    with pytest.raises(ValueError, match="none\\|medium"):
        Daemon(DaemonConfig(monitor_aggregation="low"), device="cpu")
