"""Hand-encoded protobuf wire format for the Hubble Observer API.

Reference: upstream ``api/v1/flow/flow.proto`` (message ``Flow`` and
friends) and ``api/v1/observer/observer.proto`` (``GetFlowsRequest``,
``GetFlowsResponse``).  The environment has no protoc-gen plugins, so
the wire format is encoded by hand from the proto definitions: field
numbers and enum values below are flow.proto's (provenance caveat:
the reference mount is empty, so they are transcribed from the
upstream schema rather than cited to a file; the golden test pins the
resulting bytes).

Only the subset of fields this framework populates is encoded —
protobuf readers skip unknown fields and default missing ones, so a
stock hubble CLI can consume the stream.

Wire-format primitives implemented: varint (wire type 0) and
length-delimited (wire type 2) — flow.proto uses nothing else.
:func:`decode_message` is a schema-less decoder used by the golden
round-trip test and the binary client.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from .flow import Flow, FlowEndpoint

# --- primitives ------------------------------------------------------


def encode_varint(n: int) -> bytes:
    if n < 0:  # proto int32/enum negatives ride as 10-byte varints
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(data: bytes, off: int) -> Tuple[int, int]:
    shift = 0
    n = 0
    while True:
        b = data[off]
        off += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, off
        shift += 7


def _tag(field: int, wire_type: int) -> bytes:
    return encode_varint((field << 3) | wire_type)


def _varint_field(field: int, value: int) -> bytes:
    if not value:
        return b""  # proto3 default elision
    return _tag(field, 0) + encode_varint(value)


def _bytes_field(field: int, value: bytes) -> bytes:
    if not value:
        return b""
    return _tag(field, 2) + encode_varint(len(value)) + value


def _str_field(field: int, value: str) -> bytes:
    return _bytes_field(field, value.encode())


def _msg_field(field: int, payload: bytes) -> bytes:
    """Submessage: encoded even when empty IF the caller passes
    non-None (presence carries meaning for message fields)."""
    return _tag(field, 2) + encode_varint(len(payload)) + payload


def decode_message(data: bytes) -> Dict[int, list]:
    """Schema-less decode: {field: [value, ...]} where value is an int
    (wire type 0) or bytes (wire type 2).  Fixed32/64 are not used by
    flow.proto and raise."""
    out: Dict[int, list] = {}
    off = 0
    while off < len(data):
        key, off = decode_varint(data, off)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, off = decode_varint(data, off)
        elif wt == 2:
            ln, off = decode_varint(data, off)
            if off + ln > len(data):
                # Python slicing would silently truncate: a corrupt
                # request must error, not decode to partial filters
                raise ValueError("truncated length-delimited field")
            v = data[off:off + ln]
            off += ln
        else:
            raise ValueError(f"unsupported wire type {wt}")
        out.setdefault(field, []).append(v)
    return out


# --- flow.proto enums ------------------------------------------------

# enum Verdict
VERDICT_WIRE = {1: 1, 3: 5, 2: 2, 0: 2}  # ALLOW->FORWARDED,
# REDIRECT->REDIRECTED, DENY/DEFAULT_DENY->DROPPED

# wire Verdict -> internal verdict codes (one wire DROPPED covers two
# internal codes; binary filters expand through this, since FlowFilter
# compares against INTERNAL codes)
VERDICT_WIRE_TO_INTERNAL = {1: (1,), 2: (0, 2), 5: (3,)}

# enum DropReason: internal reason codes -> flow.proto values.  The
# reference's bpf DROP_* space starts at 130; POLICY_DENIED is 133.
# Reasons without an upstream value travel as 0 (UNKNOWN) in the
# field-25 ENUM — but the NATIVE code always rides field 3 (the
# deprecated uint32 ``drop_reason``, numerically below the bpf
# DROP_* floor so it cannot collide with an upstream value), and
# :func:`decode_flow` prefers it, so relay-merged flows decoded from
# the binary wire keep full drop-reason fidelity (the DIVERGENCES
# #15 caveat, closed).  A stock hubble reader that only
# looks at field 25 still sees a valid (if generic) enum value.
DROP_REASON_WIRE = {1: 133, 2: 133, 3: 0, 4: 0, 5: 0, 6: 0, 7: 0,
                    8: 0, 9: 0, 10: 0, 11: 0, 12: 0}

# enum FlowType
FLOW_TYPE_L3_L4 = 1
FLOW_TYPE_L7 = 2

# enum TrafficDirection
TRAFFIC_INGRESS = 1
TRAFFIC_EGRESS = 2

# enum IPVersion
IP_V4 = 1
IP_V6 = 2

_TCP_FLAG_FIELDS = (  # message TCPFlags field numbers
    ("FIN", 1, 0x01), ("SYN", 2, 0x02), ("RST", 3, 0x04),
    ("PSH", 4, 0x08), ("ACK", 5, 0x10), ("URG", 6, 0x20),
)


# --- message encoders ------------------------------------------------


def _encode_timestamp(t: float) -> bytes:
    secs = int(t)
    nanos = int(round((t - secs) * 1e9))
    secs += nanos // 1_000_000_000  # rounding can carry a full second
    nanos %= 1_000_000_000
    return _varint_field(1, secs) + _varint_field(2, nanos)


def _encode_endpoint(ep: FlowEndpoint) -> bytes:
    # message Endpoint: ID=1, identity=2, namespace=3, labels=4,
    # pod_name=5
    ns = ""
    pod = ep.pod_name
    if "/" in pod:
        ns, pod = pod.split("/", 1)
    out = _varint_field(1, ep.endpoint_id)
    out += _varint_field(2, ep.identity)
    out += _str_field(3, ns)
    for lab in ep.labels:
        out += _str_field(4, lab)
    out += _str_field(5, pod)
    return out


def _encode_l4(f: Flow) -> Optional[bytes]:
    # message Layer4 oneof protocol: TCP=1, UDP=2, ICMPv4=3, ICMPv6=4,
    # SCTP=5
    sp, dp = f.source.port, f.destination.port
    if f.proto == 6:
        flags = b""
        for _name, field, bit in _TCP_FLAG_FIELDS:
            if f.flags & bit:
                flags += _varint_field(field, 1)
        tcp = (_varint_field(1, sp) + _varint_field(2, dp)
               + (_msg_field(3, flags) if flags else b""))
        return _msg_field(1, tcp)
    if f.proto == 17:
        return _msg_field(2, _varint_field(1, sp) + _varint_field(2, dp))
    if f.proto in (1, 58):
        icmp = _varint_field(1, f.destination.port)  # type=1 (code=2)
        return _msg_field(3 if f.proto == 1 else 4, icmp)
    if f.proto == 132:
        return _msg_field(5, _varint_field(1, sp) + _varint_field(2, dp))
    return None


def _encode_l7(l7: dict) -> bytes:
    # message Layer7: type=1, latency_ns=2, oneof record {dns=100,
    # http=101, kafka=102}
    out = b""
    kind_map = {"REQUEST": 1, "RESPONSE": 2, "SAMPLE": 3}
    out += _varint_field(1, kind_map.get(str(l7.get("type", "")), 0))
    http = l7.get("http")
    if http:
        payload = (_varint_field(1, int(http.get("code", 0)))
                   + _str_field(2, str(http.get("method", "")))
                   + _str_field(3, str(http.get("url", "")))
                   + _str_field(4, str(http.get("protocol", ""))))
        out += _msg_field(101, payload)
    dns = l7.get("dns")
    if dns:
        payload = _str_field(1, str(dns.get("query", "")))
        for ip in dns.get("ips", ()):
            payload += _str_field(2, str(ip))
        payload += _varint_field(3, int(dns.get("ttl", 0)))
        out += _msg_field(100, payload)
    kafka = l7.get("kafka")
    if kafka:
        payload = (_varint_field(1, int(kafka.get("error_code", 0)))
                   + _varint_field(2, int(kafka.get("api_version", 0)))
                   + _str_field(3, str(kafka.get("api_key", "")))
                   + _varint_field(4, int(kafka.get("correlation_id",
                                                    0)))
                   + _str_field(5, str(kafka.get("topic", ""))))
        out += _msg_field(102, payload)
    return out


def encode_flow(f: Flow, node_name: str = "") -> bytes:
    """message Flow: time=1, verdict=2, drop_reason=3, IP=5, l4=6,
    source=8, destination=9, Type=10, node_name=11, l7=15, reply=16
    (deprecated), event_type=19, traffic_direction=22,
    drop_reason_desc=25, is_reply=26 (BoolValue), Summary=100000
    (deprecated), uuid=34."""
    out = _msg_field(1, _encode_timestamp(f.time))
    out += _varint_field(2, VERDICT_WIRE.get(f.verdict, 0))
    if f.drop_reason:
        out += _varint_field(3, f.drop_reason)  # deprecated raw code
    ip = (_str_field(1, f.source.ip) + _str_field(2, f.destination.ip)
          + _varint_field(3, IP_V6 if ":" in f.source.ip else IP_V4))
    out += _msg_field(5, ip)
    l4 = _encode_l4(f)
    if l4 is not None:
        out += _msg_field(6, l4)
    out += _msg_field(8, _encode_endpoint(f.source))
    out += _msg_field(9, _encode_endpoint(f.destination))
    out += _varint_field(10, FLOW_TYPE_L7 if f.l7 else FLOW_TYPE_L3_L4)
    out += _str_field(11, node_name)
    if f.l7:
        out += _msg_field(15, _encode_l7(f.l7))
    out += _varint_field(16, 1 if f.is_reply else 0)
    out += _msg_field(19, _varint_field(1, f.event_type))
    out += _varint_field(
        22, TRAFFIC_EGRESS if f.traffic_direction else TRAFFIC_INGRESS)
    if f.drop_reason:
        out += _varint_field(
            25, DROP_REASON_WIRE.get(f.drop_reason, 0))
    out += _msg_field(26, _varint_field(1, 1 if f.is_reply else 0))
    out += _str_field(34, str(f.uuid))
    out += _str_field(100000, f.summary())
    return out


def encode_get_flows_response(f: Flow, node_name: str = "") -> bytes:
    """observer.proto GetFlowsResponse: oneof {flow=1, ...},
    node_name=1000, time=1001."""
    out = _msg_field(1, encode_flow(f, node_name))
    out += _str_field(1000, node_name)
    out += _msg_field(1001, _encode_timestamp(f.time))
    return out


# FlowFilter wire fields handled (flow.proto): source_ip=1,
# destination_ip=4, verdict=6.  Other filter fields (source_pod=2,
# labels, fqdns, ...) are skipped schema-aware — misreading them as a
# different field would silently mis-filter.
_FILTER_SOURCE_IP = 1
_FILTER_DEST_IP = 4
_FILTER_VERDICT = 6


def encode_get_flows_request(number: int = 0, follow: bool = False,
                             whitelist: Sequence[dict] = (),
                             blacklist: Sequence[dict] = ()) -> bytes:
    """Client-side GetFlowsRequest (for the binary client + tests).
    ``verdict`` values are WIRE enum values (FORWARDED=1, DROPPED=2,
    REDIRECTED=5)."""
    out = _varint_field(1, number)
    out += _varint_field(3, 1 if follow else 0)

    def _filter_payload(f: dict) -> bytes:
        return (_str_field(_FILTER_SOURCE_IP, f.get("source_ip", ""))
                + _str_field(_FILTER_DEST_IP,
                             f.get("destination_ip", ""))
                + _varint_field(_FILTER_VERDICT, f.get("verdict", 0)))

    for f in blacklist:
        out += _msg_field(4, _filter_payload(f))
    for f in whitelist:
        out += _msg_field(5, _filter_payload(f))
    return out


def encode_server_status(num_flows: int, max_flows: int,
                         seen_flows: int) -> bytes:
    """observer.proto ServerStatusResponse: num_flows=1, max_flows=2,
    seen_flows=3."""
    return (_varint_field(1, num_flows) + _varint_field(2, max_flows)
            + _varint_field(3, seen_flows))


def decode_get_flows_request(data: bytes) -> dict:
    """observer.proto GetFlowsRequest subset: number=1, follow=3,
    blacklist=4, whitelist=5.  FlowFilter fields handled:
    source_ip=1, destination_ip=4, verdict=6 (the _FILTER_* constants
    above); other filter fields are skipped rather than misread."""
    msg = decode_message(data)
    out: dict = {}
    if 1 in msg:
        out["number"] = int(msg[1][-1])
    if 3 in msg:
        out["follow"] = bool(msg[3][-1])

    def _filters(raws) -> list:
        supported = {_FILTER_SOURCE_IP, _FILTER_DEST_IP, _FILTER_VERDICT}
        fs = []
        for raw in raws:
            m = decode_message(raw)
            f: dict = {}
            if _FILTER_SOURCE_IP in m:
                f["source_ip"] = m[_FILTER_SOURCE_IP][-1].decode()
            if _FILTER_DEST_IP in m:
                f["destination_ip"] = m[_FILTER_DEST_IP][-1].decode()
            if _FILTER_VERDICT in m:
                f["verdict"] = int(m[_FILTER_VERDICT][-1])
            if set(m) - supported:
                # a condition we cannot evaluate: the filter must match
                # NOTHING (matching everything would turn a narrow
                # blacklist into exclude-all / a whitelist into
                # match-all)
                f["unsupported"] = True
            fs.append(f)
        return fs

    if 4 in msg:
        out["blacklist"] = _filters(msg[4])
    if 5 in msg:
        out["whitelist"] = _filters(msg[5])
    return out


# wire Verdict -> hubble JSON verdict name (decode side)
_VERDICT_WIRE_NAMES = {1: "FORWARDED", 2: "DROPPED", 5: "REDIRECTED"}


def _decode_endpoint(raw: bytes) -> dict:
    m = decode_message(raw)
    out: dict = {"identity": int(m.get(2, [0])[-1])}
    labels = [b.decode() for b in m.get(4, [])]
    if labels:
        out["labels"] = labels
    if 5 in m:
        pod = m[5][-1].decode()
        ns = m[3][-1].decode() if 3 in m else ""
        out["podName"] = f"{ns}/{pod}" if ns else pod
    if 1 in m:
        out["ID"] = int(m[1][-1])
    return out


def decode_flow(raw: bytes) -> dict:
    """One encoded ``Flow`` message -> the hubble-JSON-shaped dict
    ``Flow.to_dict`` produces, with NATIVE drop-reason fidelity: the
    native reason code rides field 3 (the deprecated uint32
    ``drop_reason``) and is preferred over the field-25 enum, so a
    repo-native reason (ingress shed, dispatch timeout, cluster
    overflow, NAT exhaustion...) decoded off the binary wire renders
    its precise name instead of UNKNOWN(0) — the DIVERGENCES #15
    caveat, closed.  Used by ``BinaryObserverClient.get_flow_dicts``
    (the relay-peer surface over the binary wire)."""
    from .flow import DROP_REASON_DESC

    m = decode_message(raw)
    out: dict = {}
    if 1 in m:
        t = decode_message(m[1][-1])
        out["time"] = (int(t.get(1, [0])[-1])
                       + int(t.get(2, [0])[-1]) / 1e9)
    out["verdict"] = _VERDICT_WIRE_NAMES.get(
        int(m.get(2, [0])[-1]), "VERDICT_UNKNOWN")
    if 5 in m:
        ip = decode_message(m[5][-1])
        out["IP"] = {
            "source": (ip[1][-1].decode() if 1 in ip else ""),
            "destination": (ip[2][-1].decode() if 2 in ip else ""),
        }
    if 8 in m:
        out["source"] = _decode_endpoint(m[8][-1])
    if 9 in m:
        out["destination"] = _decode_endpoint(m[9][-1])
    out["Type"] = ("L7" if int(m.get(10, [1])[-1]) == FLOW_TYPE_L7
                   else "L3_L4")
    if 11 in m:
        out["node_name"] = m[11][-1].decode()
    if 19 in m:
        et = decode_message(m[19][-1])
        out["event_type"] = {"type": int(et.get(1, [0])[-1])}
    out["traffic_direction"] = (
        "EGRESS" if int(m.get(22, [TRAFFIC_INGRESS])[-1])
        == TRAFFIC_EGRESS else "INGRESS")
    if 26 in m:
        br = decode_message(m[26][-1])
        out["is_reply"] = bool(int(br.get(1, [0])[-1]))
    else:
        out["is_reply"] = bool(int(m.get(16, [0])[-1]))
    # drop-reason fidelity: field 3 carries the NATIVE code; field 25
    # the (lossy) upstream enum.  Prefer native when present.
    native = int(m.get(3, [0])[-1])
    wire_desc = int(m.get(25, [0])[-1])
    if native:
        out["drop_reason"] = native
        out["drop_reason_desc"] = DROP_REASON_DESC.get(
            native, f"DROP_REASON_{native}")
    elif wire_desc:
        out["drop_reason"] = wire_desc
        out["drop_reason_desc"] = f"DROP_REASON_{wire_desc}"
    if 100000 in m:
        out["Summary"] = m[100000][-1].decode()
    if 34 in m:
        out["uuid"] = m[34][-1].decode()
    return out
