"""The port's Hubble flow plane (``cilium_tpu_torch/flow``) against the
JAX package's (``cilium_tpu/flow``).  The same seeded event batches, L7
records and rows go through both: the flows (``to_dict``), the filters,
the proto bytes, the metrics exposition, the JSONL export, the recorder's
pcap and the relay's merge are equal, exactly (host and integer code:
the tolerance is zero).  Daemon-level checks drive the port's ``Daemon``
(``device="cpu"``) beside the JAX daemon (backend "tpu", JAX on the CPU)
with the same endpoints, rules and rows; flow times are wall-clock
there, so those comparisons leave ``time`` out.

Mirrors ``tests/test_monitor_flow.py``, ``tests/test_flow_proto.py``,
``tests/test_hubble_seven.py``, ``tests/test_operator_ipam_mesh.py::
TestRecorder`` and ``tests/test_l7plane.py::TestRedirectFlowStamp``.
"""

import json
import time

import numpy as np
import pytest
import torch

from cilium_tpu import flow as jflow
from cilium_tpu.agent import Daemon as JDaemon, DaemonConfig as JConfig
from cilium_tpu.flow import proto as jproto
from cilium_tpu.monitor import api as japi
from cilium_tpu.proxy.proxy import L7Record as JL7Record
from cilium_tpu_torch import flow as tflow
from cilium_tpu_torch.agent import Daemon, DaemonConfig
from cilium_tpu_torch.core.packets import (COL_DIR, COL_DPORT, COL_DST_IP0,
                                           COL_EP, COL_FAMILY, COL_FLAGS,
                                           COL_LEN, COL_PROTO, COL_SPORT,
                                           COL_SRC_IP0, N_COLS, TCP_ACK,
                                           TCP_FIN, TCP_PSH, TCP_RST,
                                           TCP_SYN, ip_to_words, make_batch)
from cilium_tpu_torch.flow import proto as tproto
from cilium_tpu_torch.flow.seven import MSG_L7
from cilium_tpu_torch.monitor import api as tapi
from cilium_tpu_torch.monitor.agent import MonitorAgent
from cilium_tpu_torch.policy.mapstate import (VERDICT_ALLOW,
                                              VERDICT_DEFAULT_DENY,
                                              VERDICT_DENY, VERDICT_REDIRECT)
from cilium_tpu_torch.proxy.featurize import KIND_DNS, KIND_HTTP, KIND_KAFKA
from cilium_tpu_torch.proxy.proxy import L7Record

torch.set_num_threads(1)

T0 = 1700000000.25
IPS4 = ("10.0.1.1", "10.0.2.1", "10.1.0.5", "192.168.7.9")
IPS6 = ("2001:db8::5", "fd00::1")
LABELS = {256: ("k8s:app=web", "k8s:ns=default"), 1000: ("k8s:app=db",),
          2: ("reserved:world",)}


def _labels(n):
    return LABELS.get(n, ())


def _endpoint(e):
    return (f"default/pod-{e}", e) if e else ("", e)


def _arrays(seed, n=256):
    """A seeded event batch's columns: v4 and v6 rows; TCP (every flag
    mix), UDP, SCTP, ICMP, ICMPv6 and a portless protocol; drops of
    every reason, traces and policy verdicts, redirects with their
    proxy port, audited forwards (ALLOW with a deny reason), replies."""
    rng = np.random.default_rng(seed)
    hdr = np.zeros((n, N_COLS), np.uint32)
    v6 = rng.random(n) < 0.25
    w4 = np.array([ip_to_words(ip) for ip in IPS4], np.uint32)
    w6 = np.array([ip_to_words(ip) for ip in IPS6], np.uint32)
    for col in (COL_SRC_IP0, COL_DST_IP0):
        hdr[:, col:col + 4] = np.where(v6[:, None],
                                       w6[rng.integers(0, 2, n)],
                                       w4[rng.integers(0, 4, n)])
    hdr[:, COL_FAMILY] = np.where(v6, 6, 4)
    proto = rng.choice(np.array([6, 6, 6, 17, 132, 1, 47], np.uint32), n)
    proto[v6 & (proto == 1)] = 58
    hdr[:, COL_PROTO] = proto
    ports = np.isin(proto, (6, 17, 132))
    hdr[:, COL_SPORT] = np.where(ports, rng.choice(
        np.array([80, 443, 5432, 40000, 40001, 53000], np.uint32), n), 0)
    hdr[:, COL_DPORT] = np.where(
        ports, rng.choice(np.array([80, 443, 5432, 53, 8080], np.uint32), n),
        np.where(np.isin(proto, (1, 58)), rng.choice([0, 3, 8, 11], n), 0))
    flags = rng.choice(np.array([TCP_SYN, TCP_ACK, TCP_SYN | TCP_ACK,
                                 TCP_FIN | TCP_ACK, TCP_RST,
                                 TCP_PSH | TCP_ACK], np.uint32), n)
    hdr[:, COL_FLAGS] = np.where(proto == 6, flags, 0)
    hdr[:, COL_LEN] = rng.integers(40, 1500, n)
    hdr[:, COL_EP] = rng.choice(np.array([0, 1, 2, 7], np.uint32), n)
    hdr[:, COL_DIR] = rng.integers(0, 2, n)
    msg = rng.choice(np.array([tapi.MSG_DROP, tapi.MSG_TRACE,
                               tapi.MSG_POLICY_VERDICT], np.uint8), n)
    drop = msg == tapi.MSG_DROP
    verdict = np.where(
        drop, rng.choice(np.array([VERDICT_DENY, VERDICT_DEFAULT_DENY]), n),
        rng.choice(np.array([VERDICT_ALLOW, VERDICT_ALLOW,
                             VERDICT_REDIRECT]), n)).astype(np.uint8)
    reason = np.where(drop, rng.integers(1, 13, n), 0)
    audited = (~drop) & (verdict == VERDICT_ALLOW) & (rng.random(n) < 0.2)
    reason = np.where(audited, rng.choice([1, 2, 8], n), reason)
    proxy = np.where(verdict == VERDICT_REDIRECT,
                     rng.choice([10000, 10001], n), 0)
    return dict(
        msg_type=msg, verdict=verdict, reason=reason.astype(np.uint8),
        ct_state=rng.integers(0, 4, n).astype(np.uint8),
        identity=rng.choice(np.array([0, 2, 256, 1000, 70000],
                                     np.uint32), n),
        proxy_port=proxy.astype(np.uint16), hdr=hdr)


def _batches(seed, n=256, t=T0):
    """The same seeded batch as the JAX package's EventBatch and the
    port's (separate copies of every column)."""
    a = _arrays(seed, n)
    return (japi.EventBatch(timestamp=t, **{k: v.copy() for k, v in a.items()}),
            tapi.EventBatch(timestamp=t, **{k: v.copy() for k, v in a.items()}))


def _observers(capacity):
    return (jflow.Observer(capacity, _labels, _endpoint),
            tflow.Observer(capacity, _labels, _endpoint))


def _dicts(flows, drop_time=False):
    out = [f.to_dict() if hasattr(f, "to_dict") else dict(f) for f in flows]
    if drop_time:
        for d in out:
            d.pop("time", None)
    return out


# -- the observer (tests/test_monitor_flow.py) ---------------------------
@pytest.mark.parametrize("capacity,batches,number,newest", [
    (1024, 1, 300, 255),  # test_flows_enriched: no wrap
    (128, 3, 128, 3 * 256 - 1),  # test_ring_wraparound
    (8, 2, 8, 511),  # test_oversize_batch_keeps_ring_aligned
])
def test_observer_flows_equal_the_reference(capacity, batches, number,
                                            newest):
    jo, to = _observers(capacity)
    for b in range(batches):
        jb, tb = _batches(b, t=T0 + b)
        jo.consume(jb)
        to.consume(tb)
    assert len(to) == len(jo) == min(batches * 256, capacity)
    tf = to.get_flows(number=number)
    assert _dicts(tf) == _dicts(jo.get_flows(number=number))
    uuids = [f.uuid for f in tf]
    assert uuids[0] == newest and uuids == sorted(uuids, reverse=True)
    assert uuids == list(range(newest, newest - len(uuids), -1))
    old = to.get_flows(number=number, oldest_first=True)
    assert _dicts(old) == _dicts(jo.get_flows(number=number,
                                              oldest_first=True))
    assert to.server_status() == jo.server_status()


FILTERS = [
    dict(verdict=VERDICT_ALLOW), dict(verdict=VERDICT_DEFAULT_DENY),
    dict(port=5432), dict(protocol=17), dict(source_ip="10.0.1.1"),
    dict(destination_ip="2001:db8::5"), dict(identity=256),
    dict(source_identity=1000), dict(destination_identity=256),
    dict(reply=True), dict(reply=False), dict(since=T0 + 1),
    dict(until=T0), dict(verdict=VERDICT_ALLOW, port=443, protocol=6),
    dict(unsupported=True)]


@pytest.mark.parametrize("i", range(len(FILTERS)))
def test_filters_equal_the_reference(i):
    """One filter, the filter OR the next one, and the filter as a
    blacklist: the same flows in the same order."""
    jo, to = _observers(1024)
    for b in range(2):
        jb, tb = _batches(10 + b, t=T0 + b)
        jo.consume(jb)
        to.consume(tb)
    f, g = FILTERS[i], FILTERS[(i + 1) % len(FILTERS)]
    for kw in ({"filters": [f]}, {"filters": [f, g]}, {"blacklist": [f]},
               {"filters": [g], "blacklist": [f]}):
        want = jo.get_flows(number=1000, **{
            k: [jflow.FlowFilter(**x) for x in v] for k, v in kw.items()})
        got = to.get_flows(number=1000, **{
            k: [tflow.FlowFilter(**x) for x in v] for k, v in kw.items()})
        assert _dicts(got) == _dicts(want)


def test_flows_since_and_l7_rows_equal_the_reference():
    jo, to = _observers(256)
    cursor_j = cursor_t = 0
    for b in range(3):
        jb, tb = _batches(20 + b, n=100, t=T0 + b)
        jo.consume(jb)
        to.consume(tb)
        rec = dict(kind=KIND_HTTP, verdict=b % 2, proxy_port=10000,
                   src_row=3, timestamp=T0 + b + 0.5, method="GET",
                   path=f"/r{b}", host="db" if b else "", status=200)
        jflow.SevenParser(jo, lambda r: r + 1000).consume(JL7Record(**rec))
        tflow.SevenParser(to, lambda r: r + 1000).consume(L7Record(**rec))
        jf, cursor_j = jo.flows_since(cursor_j, limit=64)
        tf, cursor_t = to.flows_since(cursor_t, limit=64)
        assert cursor_t == cursor_j and _dicts(tf) == _dicts(jf)
    assert _dicts(to.get_flows(number=300)) == _dicts(jo.get_flows(number=300))


def test_parser_wire_decode_equals_the_reference():
    jb, tb = _batches(30, n=32)
    jp = jflow.ThreeFourParser(jflow.Observer(64, _labels, _endpoint))
    tp = tflow.ThreeFourParser(tflow.Observer(64, _labels, _endpoint))
    for jev, tev in zip(jb, tb):
        data = tev.pack()
        assert data == jev.pack()
        assert tp.decode(data, 9.0).to_dict() == \
            jp.decode(data, 9.0).to_dict()
    assert tp.decoded == jp.decoded == 32
    with pytest.raises(ValueError):
        tp.decode(b"short")
    assert tp.errors == 1


def test_metrics_render_equals_the_reference():
    jm, tm = jflow.FlowMetrics(), tflow.FlowMetrics()
    for b in range(3):
        jb, tb = _batches(40 + b)
        jm.consume(jb)
        tm.consume(tb)
    for attr in ("flows_total", "drops_total", "port_distribution",
                 "policy_verdicts"):
        assert dict(getattr(tm, attr)) == dict(getattr(jm, attr))
    assert sum(tm.flows_total.values()) == 3 * 256
    text = tm.render()
    assert text == jm.render()
    assert 'verdict="forwarded"' in text


@pytest.mark.parametrize("max_bytes", [64 << 20, 40_000])
def test_exporter_jsonl_equals_the_reference(tmp_path, max_bytes):
    """Two batches into each exporter: the same lines, byte for byte
    (the batches' timestamps are fixed), uuids running on across
    batches; a small ``max_bytes`` rotates both alike."""
    paths = []
    for mod, i in ((jflow, 0), (tflow, 1)):
        p = str(tmp_path / f"flows{i}.log")
        ex = mod.FlowExporter(p, max_bytes=max_bytes,
                              identity_getter=_labels,
                              endpoint_getter=_endpoint)
        for b in range(2):
            ex.consume(_batches(50 + b, t=T0 + b)[i])
        ex.close()
        assert ex.written == 512
        paths.append(p)
    for suffix in ("", ".1"):
        try:
            want = open(paths[0] + suffix, "rb").read()
        except FileNotFoundError:
            want = None
        got = (open(paths[1] + suffix, "rb").read()
               if want is not None else None)
        assert got == want
    lines = open(paths[1] + ("" if max_bytes > 1e6 else ".1")).read() \
        .splitlines()
    rec = json.loads(lines[0])
    assert "flow" in rec and rec["node_name"] == "node0"
    if max_bytes > 1e6:
        assert len(lines) == 512
        assert int(json.loads(lines[511])["flow"]["uuid"]) == 511


def test_monitor_fans_out_to_parser_metrics_and_exporter(tmp_path):
    """The daemon's wiring on a bare MonitorAgent: parser -> observer,
    metrics and exporter each see every row once."""
    agent = MonitorAgent()
    obs = tflow.Observer(1024)
    parser = tflow.ThreeFourParser(obs)
    metrics = tflow.FlowMetrics()
    ex = tflow.FlowExporter(str(tmp_path / "f.log"))
    agent.register("hubble", parser.consume)
    agent.register("metrics", metrics.consume)
    agent.register("exporter", ex.consume)
    agent.publish(_batches(60)[1])
    ex.close()
    assert parser.decoded == len(obs) == ex.written == 256
    assert sum(metrics.flows_total.values()) == 256


# -- proto (tests/test_flow_proto.py) --------------------------------------
def _flow(mod):
    return mod.flow.Flow(
        time=1700000000.5, uuid=42, verdict=1, drop_reason=0,
        event_type=9, is_reply=False, traffic_direction=0, proto=6,
        flags=0x12, length=64,
        source=mod.flow.FlowEndpoint(ip="10.0.1.1", port=40000,
                                     identity=4321, labels=("k8s:app=web",),
                                     pod_name="default/web-0",
                                     endpoint_id=2),
        destination=mod.flow.FlowEndpoint(ip="10.0.2.1", port=5432,
                                          identity=4400,
                                          labels=("k8s:app=db",),
                                          pod_name="default/db-0",
                                          endpoint_id=1))


GOLDEN_HEX = (
    "0a0c0880e2cfaa061080cab5ee0110012a160a0831302e302e312e311208"
    "31302e302e322e311801320f0a0d08c0b80210b82a1a04100128014222080210"
    "e1211a0764656661756c74220b6b38733a6170703d7765622a057765622d304a"
    "20080110b0221a0764656661756c74220a6b38733a6170703d64622a0464622d"
    "3050015a066e6f64652d319a01020809b00101d20100920202343282ea302d31"
    "302e302e312e313a3430303030202d3e2031302e302e322e313a353433322054"
    "435020464f52574152444544")


def test_varints_and_tags_equal_the_reference():
    for n in (0, 1, 127, 128, 300, 2 ** 32 - 1, 2 ** 56, -1, -300):
        data = tproto.encode_varint(n)
        assert data == jproto.encode_varint(n)
        got, off = tproto.decode_varint(data, 0)
        assert got == (n if n >= 0 else n + (1 << 64)) and off == len(data)
    # field 100000 (Summary) needs a 3-byte tag varint
    assert tproto.encode_varint((100000 << 3) | 2) == bytes.fromhex("82ea30")


def test_golden_bytes():
    assert tproto.encode_flow(_flow(tflow), node_name="node-1").hex() == \
        GOLDEN_HEX
    msg = tproto.decode_message(bytes.fromhex(GOLDEN_HEX))
    assert msg == jproto.decode_message(bytes.fromhex(GOLDEN_HEX))
    assert msg[34] == [b"42"]
    assert msg[100000][0].decode().endswith("TCP FORWARDED")


VARIANTS = {
    "drop": dict(verdict=2, drop_reason=1),
    "default-deny": dict(verdict=0, drop_reason=2),
    "native-reason": dict(verdict=2, drop_reason=9),
    "audit": dict(verdict=1, drop_reason=2),
    "redirect": dict(verdict=3, proxy_port=10001),
    "reply-egress": dict(is_reply=True, traffic_direction=1),
    "udp": dict(proto=17), "sctp": dict(proto=132), "icmp": dict(proto=1),
    "icmp6": dict(proto=58), "gre": dict(proto=47),
    "http": dict(l7={"type": "REQUEST",
                     "http": {"code": 0, "method": "GET", "url": "/x",
                              "protocol": "HTTP/1.1"}}),
    "dns": dict(l7={"type": "REQUEST",
                    "dns": {"query": "evil.com", "rcode": 5}}),
    "kafka": dict(l7={"type": "REQUEST",
                      "kafka": {"api_key": "produce", "topic": "t",
                                "error_code": 29}}),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_flow_bytes_and_decode_equal_the_reference(variant):
    """encode_flow / encode_get_flows_response bytes equal the
    reference's; decode_flow gives the reference's dict back."""
    fs = []
    for mod in (jflow, tflow):
        f = _flow(mod)
        for k, v in VARIANTS[variant].items():
            setattr(f, k, v)
        fs.append(f)
    jf, tf = fs
    raw = tproto.encode_flow(tf, node_name="n1")
    assert raw == jproto.encode_flow(jf, node_name="n1")
    assert tproto.encode_get_flows_response(tf, "n1") == \
        jproto.encode_get_flows_response(jf, "n1")
    assert tproto.decode_flow(raw) == jproto.decode_flow(raw)


def test_seeded_flows_round_trip_through_the_wire():
    """Every flow of a seeded batch: the same bytes as the reference's,
    and ``decode_flow`` returns what it renders of the flow intact."""
    jo, to = _observers(512)
    jb, tb = _batches(70)
    jo.consume(jb)
    to.consume(tb)
    for jf, tf in zip(jo.get_flows(number=256), to.get_flows(number=256)):
        raw = tproto.encode_flow(tf)
        assert raw == jproto.encode_flow(jf)
        back = tproto.decode_flow(raw)
        d = tf.to_dict()
        assert back == jproto.decode_flow(raw)
        # the wire keeps every field decode_flow renders (ports and the
        # proxy port ride the Summary)
        assert back == {k: d[k] for k in back}
        assert {"IP", "verdict", "Summary", "uuid", "is_reply"} <= set(back)
        assert back.get("drop_reason", 0) == tf.drop_reason


def test_requests_and_status_equal_the_reference():
    raw = tproto.encode_get_flows_request(
        number=50, whitelist=[{"source_ip": "10.0.1.1", "verdict": 2}],
        blacklist=[{"destination_ip": "10.0.2.2"}])
    assert raw == jproto.encode_get_flows_request(
        number=50, whitelist=[{"source_ip": "10.0.1.1", "verdict": 2}],
        blacklist=[{"destination_ip": "10.0.2.2"}])
    req = tproto.decode_get_flows_request(raw)
    assert req == jproto.decode_get_flows_request(raw)
    assert req["whitelist"] == [{"source_ip": "10.0.1.1", "verdict": 2}]
    assert tproto.encode_server_status(3, 4096, 7) == \
        jproto.encode_server_status(3, 4096, 7)
    # a length-delimited field longer than the payload must raise
    bad = tproto.encode_get_flows_request(number=7) + bytes.fromhex("2aff01")
    with pytest.raises((ValueError, IndexError)):
        tproto.decode_message(bad)


def test_unsupported_filter_field_matches_nothing():
    raw = (tproto._varint_field(1, 10)
           + tproto._msg_field(4, tproto._str_field(9, "default/web-0")))
    req = tproto.decode_get_flows_request(raw)
    assert req == jproto.decode_get_flows_request(raw)
    [f] = req["blacklist"]
    assert f.get("unsupported") is True
    assert not tflow.FlowFilter(**f).mask(
        type("R", (), {})(), np.arange(3)).any()


# -- daemons: the seven parser, the recorder, the redirect stamp ----------
RULES_L7 = [{
    "endpointSelector": {"matchLabels": {"app": "db"}},
    "ingress": [
        {"fromEndpoints": [{"matchLabels": {"app": "web"}}],
         "toPorts": [{"ports": [{"port": "80", "protocol": "TCP"}],
                      "rules": {"http": [{"method": "GET",
                                          "path": "/ok"}]}}]},
        {"fromEndpoints": [{}],
         "toPorts": [{"ports": [{"port": "5432", "protocol": "TCP"}]}]},
    ],
}]
RULES_DNS = [{
    "endpointSelector": {"matchLabels": {"app": "client"}},
    "egress": [
        {"toEntities": ["world"],
         "toPorts": [{"ports": [{"port": "53", "protocol": "UDP"}],
                      "rules": {"dns": [{"matchName": "example.com"}]}}]},
    ],
}]


def _pair(rules, endpoints, export_dir=None):
    """A JAX daemon and a port daemon with the same endpoints and rules,
    started; with ``export_dir`` each exports to ``export<i>.log``
    there (0: the JAX daemon)."""
    out = []
    for i, (mk, cfg) in enumerate(((JDaemon, JConfig),
                                   (lambda c: Daemon(c, device="cpu"),
                                    DaemonConfig))):
        extra = ({"backend": "tpu"} if i == 0 else {})
        if export_dir is not None:
            extra["export_path"] = str(export_dir / f"export{i}.log")
        d = mk(cfg(ct_capacity=1 << 12, mesh_auth=False, **extra))
        eps = [d.add_endpoint(n, (ip,), [f"k8s:app={app}"])
               for n, ip, app in endpoints]
        d.policy_import(rules)
        d.start()
        out.append((d, eps))
    return out


def _rows(ep, specs):
    """(src, dst, sport, dport, proto, dir) -> the same rows for both."""
    return make_batch([dict(src=s, dst=t, sport=sp, dport=dp, proto=p,
                            flags=TCP_SYN, ep=ep, dir=dr)
                       for s, t, sp, dp, p, dr in specs]).data


WEB_DB = (("web-1", "10.0.1.1", "web"), ("db-1", "10.0.2.1", "db"))


def test_proxy_records_become_l7_flows():
    """tests/test_hubble_seven.py test_proxy_records_become_l7_flows and
    test_flow_json_carries_l7: a REDIRECT, two HTTP requests through
    the proxy, the flows (the redirect and both L7 records) equal."""
    flows = []
    for d, (web, db) in _pair(RULES_L7, WEB_DB):
        evb = d.process_batch(_rows(db.id, [
            ("10.0.1.1", "10.0.2.1", 40000, 80, 6, 0)]), now=10)
        port = int(evb.proxy_port[0])
        assert int(evb.verdict[0]) == VERDICT_REDIRECT and port > 0
        d.handle_l7_http(port, [{"method": "GET", "path": "/ok",
                                 "host": "db"},
                                {"method": "POST", "path": "/ok"}],
                         src_identity=web.identity.numeric_id)
        got = d.observer.get_flows(number=10)
        l7 = [f for f in got if f.l7 is not None]
        assert len(l7) == 2
        allowed = [f for f in l7 if f.verdict_name == "FORWARDED"]
        assert len(allowed) == 1 and allowed[0].event_type == MSG_L7
        assert allowed[0].l7["http"]["code"] == 200
        assert allowed[0].source.identity == web.identity.numeric_id
        assert allowed[0].to_dict()["Type"] == "L7"
        assert d.status()["flows-seen"] == 3
        flows.append(_dicts(got, drop_time=True))
        d.shutdown()
    assert flows[1] == flows[0]


def test_dns_records_and_the_relay_equal_the_reference():
    """tests/test_hubble_seven.py test_dns_records and
    TestRelay::test_merges_and_stamps_nodes."""
    out = []
    for mod, rec_t, kinds in ((jflow, JL7Record, None),
                              (tflow, L7Record, None)):
        a, b = mod.Observer(capacity=64), mod.Observer(capacity=64)
        sa, sb = mod.SevenParser(a), mod.SevenParser(b)
        sa.consume(rec_t(kind=KIND_DNS, verdict=0, proxy_port=10053,
                         src_row=0, timestamp=T0, qname="evil.com"))
        for i, (p, t) in enumerate(((sa, T0 + 1), (sb, T0 + 2),
                                    (sa, T0 + 3))):
            p.consume(rec_t(kind=KIND_HTTP if i < 2 else KIND_KAFKA,
                            verdict=1, proxy_port=10000, src_row=0,
                            timestamp=t, method="GET", path=f"/r{i}",
                            status=200))
        relay = mod.Relay({"node-a": a, "node-b": b})
        flows = relay.get_flows(number=10)
        assert [f["node_name"] for f in flows] == ["node-a", "node-b",
                                                   "node-a", "node-a"]
        assert flows[-1]["l7"]["dns"] == {"query": "evil.com", "rcode": 5}

        class Dead:
            def server_status(self):
                raise ConnectionError("gone")

        relay.add_peer("node-c", Dead())
        out.append((flows, relay.nodes(), relay.server_status()))
    assert out[1] == out[0]
    assert out[1][1][2]["state"] == "unavailable"


def test_recorder_filters_or_together_and_write_the_reference_pcap(tmp_path):
    """tests/test_operator_ipam_mesh.py TestRecorder (both tests): a
    filter list is a whitelist (OR); the recorded pcap's bytes equal
    the reference's and read back to the captured rows."""
    from cilium_tpu_torch.core.pcap import read_pcap

    rules = [{"endpointSelector": {"matchLabels": {"app": "db"}},
              "ingress": [{"fromEndpoints": [{}]}]}]
    pcaps = []
    for i, (d, (db,)) in enumerate(_pair(rules, WEB_DB[1:])):
        ff = jflow.FlowFilter if i == 0 else tflow.FlowFilter
        multi = str(tmp_path / f"multi{i}.pcap")
        one = str(tmp_path / f"one{i}.pcap")
        r1 = d.recorder.start(multi, [ff(port=80), ff(port=443)])
        r2 = d.recorder.start(one, [ff(port=5432)])
        d.process_batch(_rows(db.id, [
            ("10.0.1.1", "10.0.2.1", 40000 + j, dport, 6, 0)
            for j, dport in enumerate((80, 443, 22, 5432))]), now=10)
        assert d.recorder.stop(r1.recording_id).captured == 2
        assert d.recorder.stop(r2.recording_id).captured == 1
        assert [r["active"] for r in d.recorder.list()] == [False, False]
        pcaps.append((open(multi, "rb").read(), open(one, "rb").read()))
        d.shutdown()
    assert pcaps[1] == pcaps[0]
    replay = read_pcap(str(tmp_path / "one1.pcap"))
    assert len(replay) == 1 and int(replay.data[0][COL_DPORT]) == 5432


def test_redirected_flow_carries_proxy_port(tmp_path):
    """tests/test_l7plane.py TestRedirectFlowStamp (both tests): the
    REDIRECT flow carries its proxy port through the observer, its
    summary and the JSONL exporter; a non-redirect flow carries none."""
    lines, flows = [], []
    for i, (d, (ep,)) in enumerate(_pair(
            RULES_DNS, (("client-1", "10.0.1.1", "client"),),
            export_dir=tmp_path)):
        evb = d.process_batch(_rows(ep.id, [
            ("10.0.1.1", "8.8.8.8", 20000, 53, 17, 1),
            ("10.0.1.1", "203.0.113.1", 50000, 443, 6, 1)]), now=5)
        port = int(evb.proxy_port[0])
        assert int(evb.verdict[0]) == VERDICT_REDIRECT and port > 0
        assert int(evb.verdict[1]) != VERDICT_REDIRECT
        red, plain = d.observer.get_flows(number=2, oldest_first=True)
        assert red.proxy_port == port and f" to-proxy:{port}" in red.summary()
        assert red.to_dict()["proxy_port"] == port
        assert plain.proxy_port == 0 and "proxy_port" not in plain.to_dict()
        d.shutdown()  # closes the exporter
        lines.append([json.loads(x) for x in
                      open(tmp_path / f"export{i}.log").read().splitlines()])
        flows.append(_dicts(d.observer.get_flows(number=2), drop_time=True))
    for got in lines:
        for rec in got:
            rec.pop("time")
            rec["flow"].pop("time")
    assert lines[1] == lines[0] and flows[1] == flows[0]
    assert lines[1][0]["flow"]["verdict"] == "REDIRECTED"


# -- the gRPC surface (grpc is not on every host) -------------------------
def test_binary_and_json_clients_share_one_server(tmp_path):
    """tests/test_flow_proto.py TestBinaryObserver (both tests) and
    tests/test_hubble_seven.py TestObserverGRPC::test_get_flows_over_grpc:
    the port's server over the port daemon's observer answers both
    encodings, its flows equal to the JAX server's over the JAX daemon's;
    wire DROPPED matches both internal drop codes."""
    pytest.importorskip("grpc")
    from cilium_tpu.flow.grpc_server import serve as jserve
    from cilium_tpu_torch.flow.grpc_server import (BinaryObserverClient,
                                                   ObserverClient, serve)

    rules = [{"endpointSelector": {"matchLabels": {"app": "db"}},
              "ingress": [{"fromEndpoints": [
                  {"matchLabels": {"app": "web"}}]}]}]
    answers = []
    for i, (d, (web, db)) in enumerate(_pair(rules, WEB_DB)):
        d.process_batch(_rows(db.id, [
            ("10.0.1.1", "10.0.2.1", 40000, 5432, 6, 0),
            ("10.9.9.9", "10.0.2.1", 40001, 5432, 6, 0)]), now=5)
        addr = f"unix://{tmp_path}/hubble{i}.sock"
        server = (jserve if i == 0 else serve)(d.observer, addr,
                                               node_name="n1")
        try:
            bc = BinaryObserverClient(addr)
            msgs = bc.get_flows(number=10)
            assert len(msgs) == 2 and msgs[0][1000] == [b"n1"]
            dropped = bc.get_flows(number=10, whitelist=[{"verdict": 2}])
            fwd = bc.get_flows(number=10, whitelist=[{"verdict": 1}])
            assert len(dropped) == 1 and len(fwd) == 1
            st = bc.server_status()
            assert st["seen_flows"] == 2
            dicts = bc.get_flow_dicts(number=10)
            bc.close()
            jc = ObserverClient(addr)
            jflows = jc.get_flows(number=10)
            assert jflows[1]["IP"]["source"] == "10.0.1.1"
            jc.close()
        finally:
            server.stop(grace=0.2)
        for x in dicts + jflows:
            x.pop("time", None)
        answers.append((dicts, jflows, st))
        d.shutdown()
    assert answers[1] == answers[0]


def test_daemon_config_serves_hubble_and_relays_over_grpc(tmp_path):
    """tests/test_hubble_seven.py test_daemon_config_serves_hubble and
    test_relay_over_grpc_peers: ``hubble_listen`` starts the server at
    ``start()`` and ``shutdown`` stops it; a relay over two gRPC peers
    merges time-ordered."""
    pytest.importorskip("grpc")
    from cilium_tpu_torch.flow.grpc_server import ObserverClient, serve

    addr = f"unix://{tmp_path}/hubble2.sock"
    d = Daemon(DaemonConfig(ct_capacity=1 << 12, hubble_listen=addr),
               device="cpu")
    db = d.add_endpoint("db-1", ("10.0.2.1",), ["k8s:app=db"])
    d.start()
    d.process_batch(_rows(db.id, [("10.0.1.1", "10.0.2.1", 40000, 80, 6,
                                   0)]), now=10)
    client = ObserverClient(addr)
    assert client.server_status()["seen_flows"] == 1
    client.close()
    d.shutdown()
    assert d.hubble_server is None
    obs_a, obs_b = tflow.Observer(capacity=64), tflow.Observer(capacity=64)
    for obs, path, t in ((obs_a, "/a", T0), (obs_b, "/b", T0 + 1)):
        tflow.SevenParser(obs).consume(L7Record(
            kind=KIND_HTTP, verdict=1, proxy_port=1, src_row=0,
            timestamp=t, method="GET", path=path, status=200))
    sa = serve(obs_a, f"unix://{tmp_path}/a.sock")
    sb = serve(obs_b, f"unix://{tmp_path}/b.sock")
    try:
        peers = {n: ObserverClient(f"unix://{tmp_path}/{n}.sock")
                 for n in ("a", "b")}
        relay = tflow.Relay(peers)
        flows = relay.get_flows(number=10)
        assert [f["node_name"] for f in flows] == ["b", "a"]
        assert [f["l7"]["http"]["url"] for f in flows] == ["/b", "/a"]
        for c in peers.values():
            c.close()
    finally:
        sa.stop(grace=0.2)
        sb.stop(grace=0.2)


def test_add_relay_peer_merges_this_node_with_its_peers():
    d = Daemon(DaemonConfig(ct_capacity=1 << 12), device="cpu")
    peer = tflow.Observer(capacity=64)
    tflow.SevenParser(peer).consume(L7Record(
        kind=KIND_HTTP, verdict=1, proxy_port=1, src_row=0,
        timestamp=time.time() + 10, method="GET", path="/p", status=200))
    d.add_relay_peer("node1", peer)
    db = d.add_endpoint("db-1", ("10.0.2.1",), ["k8s:app=db"])
    d.process_batch(_rows(db.id, [("10.0.1.1", "10.0.2.1", 40000, 80, 6,
                                   0)]), now=10)
    flows = d.relay.get_flows(number=10)
    assert [f["node_name"] for f in flows] == ["node1", "node0"]
    assert [n["name"] for n in d.relay.nodes()] == ["node0", "node1"]
    d.shutdown()
