"""L7 protocol plugin registry — the proxylib plugin seam.

Reference: upstream ``proxylib/`` loads protocol parsers (cassandra,
memcached, r2d2, ...) as Go plugins behind one interface
(``proxylib/proxylib/parserfactory.go``); a new protocol registers a
factory and the policy schema key follows.  Here a
protocol plugin maps its requests onto the SHARED feature-row layout
(featurize.py L7_* columns — method id in one word, two 64-bit string
hashes) and its rules onto rows of the SAME match tensor, so every
protocol's verdict rides the one L7 verdict kernel behind
``l7policy.l7_verdict`` with zero per-protocol device code.

A fourth protocol therefore needs ONLY a registration call — no edits
to featurize.py, l7policy.py, or proxy.py (see plugins.py for the
cassandra/memcached proofs).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .featurize import (
    L7_COLS,
    L7_HOST_H0,
    L7_HOST_H1,
    L7_KIND,
    L7_METHOD,
    L7_PATH_H0,
    L7_PATH_H1,
    L7_PORT,
    L7_SRC_ROW,
    fnv64,
)

# kinds 0..2 are the built-in HTTP/DNS/Kafka featurizers
_FIRST_PLUGIN_KIND = 16


@dataclass(frozen=True)
class L7Protocol:
    """One pluggable protocol.

    ``featurize(requests, port, src_row) -> (rows, raw)`` maps request
    dicts onto the shared feature columns; ``compile_rule(rule) ->
    ("row", [method, f0_lo, f0_hi, f1_lo, f1_hi]) | ("matcher", fn)``
    maps one policy rule onto a match-tensor row (exact fields) or a
    host-side matcher (regex/prefix fields); ``record_fields(raw) ->
    (method_str, path_str)`` feeds the access log."""

    name: str  # the L7Rules schema key, e.g. "cassandra"
    kind: int
    featurize: Callable[[Sequence[dict], int, int],
                        Tuple[np.ndarray, List]]
    compile_rule: Callable[[dict], Tuple[str, object]]
    record_fields: Callable[[dict], Tuple[str, str]] = \
        lambda r: (str(r.get("method", "")), str(r.get("path", "")))
    # optional wire-facing half: raw payload bytes -> request dicts
    # (proxylib OnData analogue; parsers without it accept structured
    # requests only)
    parse_bytes: Optional[Callable[[Sequence[bytes]], List[dict]]] = None


_registry: Dict[str, L7Protocol] = {}


def register(proto: L7Protocol) -> L7Protocol:
    """Add a protocol to the registry (idempotent by name+kind;
    conflicting re-registration raises)."""
    prev = _registry.get(proto.name)
    if prev is not None and prev.kind != proto.kind:
        raise ValueError(
            f"L7 protocol {proto.name!r} already registered as kind "
            f"{prev.kind}")
    for other in _registry.values():
        if other.kind == proto.kind and other.name != proto.name:
            raise ValueError(
                f"kind {proto.kind} already taken by {other.name!r}")
    _registry[proto.name] = proto
    return proto


def next_kind() -> int:
    """Allocate the next free plugin kind id."""
    taken = {p.kind for p in _registry.values()}
    k = _FIRST_PLUGIN_KIND
    while k in taken:
        k += 1
    return k


def get(name: str) -> Optional[L7Protocol]:
    return _registry.get(name)


def names() -> Tuple[str, ...]:
    return tuple(sorted(_registry))


# -- per-plugin parse latency -------------------------------------------
# Upstream's Envoy proxy exports per-listener histogram stats; here the
# registry is the shared seam every plugin's parse+verdict rides
# through, so the parse-latency histograms live beside it.  Keyed by
# plugin/kind NAME ("http", "dns", "kafka", "cassandra", ...).  The L7
# workers record into these from the ``l7`` domain; snapshots feed
# ``Daemon.proxy_stats()`` and the L7 plane's stats.
_lat_lock = threading.Lock()
_latency: Dict[str, object] = {}


def observe_parse(name: str, us: float) -> None:
    # thread-affinity: any
    """Record one parse+verdict latency (µs) for plugin ``name``."""
    from ..serving.stats import LatencyHistogram

    h = _latency.get(name)
    if h is None:
        with _lat_lock:
            h = _latency.setdefault(name, LatencyHistogram())
    h.record(us)


def latency_snapshot() -> Dict[str, dict]:
    """Per-plugin parse-latency percentiles (p50/p95/p99/max/count)."""
    with _lat_lock:
        items = list(_latency.items())
    return {name: h.snapshot() for name, h in items}


def featurize_generic(kind: int, requests: Sequence[dict], port: int,
                      src_row: int,
                      method_of: Callable[[dict], int],
                      f0_of: Callable[[dict], str],
                      f1_of: Callable[[dict], str] = lambda r: ""
                      ) -> Tuple[np.ndarray, List[dict]]:
    """The standard featurizer shape: a method id + two hashed string
    fields (what HTTP/Kafka/cassandra/memcached all reduce to)."""
    n = len(requests)
    out = np.zeros((n, L7_COLS), dtype=np.uint32)
    out[:, L7_PORT] = port
    out[:, L7_KIND] = kind
    out[:, L7_SRC_ROW] = src_row
    for i, r in enumerate(requests):
        out[i, L7_METHOD] = method_of(r)
        lo, hi = fnv64(f0_of(r))
        out[i, L7_PATH_H0], out[i, L7_PATH_H1] = lo, hi
        lo, hi = fnv64(f1_of(r))
        out[i, L7_HOST_H0], out[i, L7_HOST_H1] = lo, hi
    return out, list(requests)
