"""The Observer gRPC API: hubble's external surface.

Reference: upstream hubble serves ``observer.Observer`` over gRPC
(``GetFlows`` server-streaming + ``ServerStatus``; schemas
``api/v1/flow/flow.proto`` + ``api/v1/observer/observer.proto``).

The service speaks BOTH encodings on the same method paths:

- **binary flow.proto** (hand-encoded wire format, ``flow/proto.py``)
  — what a stock hubble CLI with generated stubs sends/expects;
- **flow.proto JSON** (the dicts ``Flow.to_dict`` produces — hubble's
  JSON rendering) — used by the in-repo relay/CLI clients.

Requests are sniffed: JSON starts with ``{`` (0x7b decodes as an
invalid protobuf tag, so the sniff is unambiguous); each response is
serialized in the encoding its request used.

``serve(observer, address)`` -> grpc.Server;
:class:`ObserverClient` is the matching JSON client (used by the
relay for remote peers and by the CLI's ``hubble observe``);
:class:`BinaryObserverClient` drives the binary surface.
"""

from __future__ import annotations

import json
from typing import Iterator, List, Optional, Sequence

import grpc

SERVICE = "observer.Observer"

_dumps = lambda d: json.dumps(d).encode()  # noqa: E731
_loads = lambda b: json.loads(b.decode()) if b else {}  # noqa: E731
_ident = lambda b: b  # noqa: E731 — handlers serialize per-request


def _sniff_request(data: bytes) -> dict:
    """bytes -> request dict + ``_wire`` marker ("json" | "proto")."""
    from .proto import decode_get_flows_request

    if not data:
        return {"_wire": "proto"}
    if data[:1] == b"{":
        req = _loads(data)
        req["_wire"] = "json"
        return req
    req = decode_get_flows_request(data)
    req["_wire"] = "proto"
    return req


class _ObserverHandler(grpc.GenericRpcHandler):
    def __init__(self, observer, node_name: str = ""):
        self.observer = observer
        self.node_name = node_name

    def service(self, handler_call_details):
        method = handler_call_details.method
        if method == f"/{SERVICE}/GetFlows":
            return grpc.unary_stream_rpc_method_handler(
                self._get_flows,
                request_deserializer=_sniff_request,
                response_serializer=_ident)
        if method == f"/{SERVICE}/ServerStatus":
            return grpc.unary_unary_rpc_method_handler(
                self._server_status,
                request_deserializer=_sniff_request,
                response_serializer=_ident)
        return None

    def _get_flows(self, request: dict, context) -> Iterator[bytes]:
        from .observer import FlowFilter
        from .proto import encode_get_flows_response

        binary = request.get("_wire") == "proto"
        number = int(request.get("number", 100))

        def to_filters(entries) -> list:
            out = []
            for f in entries:
                if binary and "verdict" in f:
                    # binary filters carry WIRE Verdict enum values;
                    # the ring compares INTERNAL codes (one wire
                    # DROPPED spans two internal codes, so a filter
                    # may expand into several OR'd ones)
                    from .proto import VERDICT_WIRE_TO_INTERNAL

                    f = dict(f)
                    internals = VERDICT_WIRE_TO_INTERNAL.get(
                        f.pop("verdict"), (-1,))  # unknown: none
                    out.extend(FlowFilter(verdict=v, **f)
                               for v in internals)
                else:
                    out.append(FlowFilter(**f))
            return out

        kwargs = dict(
            filters=to_filters(request.get("whitelist", ())),
            number=number,
            oldest_first=bool(request.get("oldest_first", False)))
        blacklist = to_filters(request.get("blacklist", ()))
        if blacklist:
            kwargs["blacklist"] = blacklist
        flows = self.observer.get_flows(**kwargs)
        for f in flows:
            is_flow = hasattr(f, "to_dict")
            if binary:
                if not is_flow:
                    # relay-aggregated dicts carry no Flow object to
                    # re-encode; answering a proto request with JSON
                    # bytes would crash the client's decoder
                    # mid-stream — fail the RPC explicitly instead
                    context.abort(
                        grpc.StatusCode.UNIMPLEMENTED,
                        "binary wire unavailable for relay-aggregated "
                        "flows; use the JSON encoding")
                yield encode_get_flows_response(f, self.node_name)
            else:
                yield _dumps({"flow": f.to_dict() if is_flow
                              else dict(f)})

    def _server_status(self, request: dict, context) -> bytes:
        from .proto import encode_server_status

        obs = self.observer
        if hasattr(obs, "server_status"):
            st = obs.server_status()
        else:
            st = {"num_flows": len(obs), "seen_flows": obs.seq,
                  "max_flows": obs.capacity}
        if request.get("_wire") == "proto":
            return encode_server_status(
                int(st.get("num_flows", 0)), int(st.get("max_flows", 0)),
                int(st.get("seen_flows", 0)))
        return _dumps(st)


def serve(observer, address: str = "unix:///tmp/hubble.sock",
          max_workers: int = 4, node_name: str = "") -> grpc.Server:
    """Start the Observer service (unix:// or host:port address).
    ``observer`` may be an Observer or a Relay (relay exposes the same
    GetFlows protocol, making this the hubble-relay server too)."""
    from concurrent import futures

    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers(
        (_ObserverHandler(observer, node_name),))
    server.add_insecure_port(address)
    server.start()
    return server


class ObserverClient:
    """GetFlows/ServerStatus client; quacks like an Observer for the
    relay (get_flows returns flow dicts)."""

    def __init__(self, address: str = "unix:///tmp/hubble.sock"):
        self.channel = grpc.insecure_channel(address)
        self._get = self.channel.unary_stream(
            f"/{SERVICE}/GetFlows",
            request_serializer=_dumps, response_deserializer=_loads)
        self._status = self.channel.unary_unary(
            f"/{SERVICE}/ServerStatus",
            request_serializer=_dumps, response_deserializer=_loads)

    def get_flows(self, filters: Sequence = (), number: int = 100,
                  oldest_first: bool = False,
                  blacklist: Sequence = ()) -> List[dict]:
        req = {"number": number, "oldest_first": oldest_first}
        if filters:
            req["whitelist"] = [f.__dict__ for f in filters]
        if blacklist:
            req["blacklist"] = [f.__dict__ for f in blacklist]
        return [msg["flow"] for msg in self._get(req)]

    def server_status(self) -> dict:
        return self._status({})

    def close(self) -> None:
        self.channel.close()


class BinaryObserverClient:
    """Binary flow.proto client — what a stock hubble CLI's generated
    stubs put on the wire; responses decode through the schema-less
    decoder (flow/proto.py field numbers)."""

    def __init__(self, address: str = "unix:///tmp/hubble.sock"):
        self.channel = grpc.insecure_channel(address)
        self._get = self.channel.unary_stream(
            f"/{SERVICE}/GetFlows",
            request_serializer=_ident, response_deserializer=_ident)
        self._status = self.channel.unary_unary(
            f"/{SERVICE}/ServerStatus",
            request_serializer=_ident, response_deserializer=_ident)

    def get_flows(self, number: int = 100,
                  whitelist: Sequence[dict] = (),
                  blacklist: Sequence[dict] = ()) -> List[dict]:
        """Returns schema-less decodes of each GetFlowsResponse:
        {field: [values]} with field 1 = the encoded Flow."""
        from .proto import decode_message, encode_get_flows_request

        req = encode_get_flows_request(number=number,
                                       whitelist=whitelist,
                                       blacklist=blacklist)
        return [decode_message(raw) for raw in self._get(req)]

    def get_flow_dicts(self, number: int = 100,
                       whitelist: Sequence[dict] = (),
                       blacklist: Sequence[dict] = ()) -> List[dict]:
        """GetFlows decoded to hubble-JSON-shaped dicts with NATIVE
        drop-reason fidelity (``flow/proto.decode_flow`` prefers the
        field-3 native code over the lossy field-25 enum) — the
        relay-peer surface over the binary wire: a Relay fed these
        merges flows whose repo-native drop reasons survive the
        round trip (DIVERGENCES #15 caveat, closed)."""
        from .proto import decode_flow

        out = []
        for msg in self.get_flows(number=number, whitelist=whitelist,
                                  blacklist=blacklist):
            if 1 in msg:
                out.append(decode_flow(msg[1][-1]))
        return out

    def server_status(self) -> dict:
        from .proto import decode_message

        msg = decode_message(self._status(b""))
        return {"num_flows": int(msg.get(1, [0])[-1]),
                "max_flows": int(msg.get(2, [0])[-1]),
                "seen_flows": int(msg.get(3, [0])[-1])}

    def close(self) -> None:
        self.channel.close()
