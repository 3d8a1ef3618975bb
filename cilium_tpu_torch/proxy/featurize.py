"""L7 featurizers: requests -> fixed-width feature rows.

Reference: ``proxylib/`` parsers (Go, loaded into Envoy via cgo) parse
protocol payloads and hand structured requests to the policy filter.
Here the parser's output is a ``[N, L7_COLS] uint32`` tensor —
string fields ride as 64-bit FNV-1a hashes (two u32 words) so the
policy match is pure tensor compares; the raw strings travel alongside
only for (a) regex-rule host fallback and (b) access-log records.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

# Feature row columns.
L7_PORT = 0  # proxy port the request arrived on
L7_KIND = 1  # 0 = HTTP, 1 = DNS
L7_METHOD = 2  # dense method id (HTTP) / query type (DNS)
L7_PATH_H0 = 3  # FNV-64 low word of path (HTTP) / qname (DNS)
L7_PATH_H1 = 4  # FNV-64 high word
L7_HOST_H0 = 5  # FNV-64 low word of Host header
L7_HOST_H1 = 6
L7_SRC_ROW = 7  # source identity row (for per-peer L7 policy + logs)
L7_COLS = 8

KIND_HTTP = 0
KIND_DNS = 1
KIND_KAFKA = 2
# rule-tensor-only kind: an HTTP PREFIX rule row (matches KIND_HTTP
# requests through the rolling prefix-hash tensor; l7policy.py)
KIND_HTTP_PREFIX = 3

# longest path prefix that can match on device (longer prefixes fall
# back to host matchers); bounds the rolling-hash tensor
MAX_PREFIX = 48

# Kafka api keys the policy schema names (reference: proxylib kafka
# parser + api.PortRuleKafka role/apiKey)
KAFKA_API_IDS = {"produce": 1, "fetch": 2, "consume": 2,
                 "metadata": 3, "offsets": 4, "offsetcommit": 8,
                 "offsetfetch": 9}

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def fnv64(s: str) -> Tuple[int, int]:
    """FNV-1a 64-bit of the utf-8 bytes -> (lo32, hi32); ('' -> (0,0)).

    The empty string maps to (0, 0) = the wildcard marker, so policy
    fields left blank mean "any" (upstream: empty method/path/host
    fields are unconstrained)."""
    if not s:
        return 0, 0
    h = _FNV_OFFSET
    for b in s.encode():
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    lo, hi = h & 0xFFFFFFFF, h >> 32
    if lo == 0 and hi == 0:  # never collide with the wildcard marker
        lo = 1
    return lo, hi


def _norm_dns(name: str) -> str:
    return name.rstrip(".").lower()


def path_prefix_hashes(paths: Sequence[str],
                       lengths: Optional[Sequence[int]] = None
                       ) -> np.ndarray:
    """Rolling FNV-64 of each path, sampled at prefix lengths.

    ``lengths=None`` samples EVERY position: [N, MAX_PREFIX, 2] u32
    with column j holding fnv64(path[:j+1]) (bit-equal to
    :func:`fnv64`, same zero-avoidance).  With ``lengths`` (sorted,
    ascending — the lengths the compiled prefix rules actually probe)
    the output is the compact [N, len(lengths), 2] and the rolling
    loop stops at max(lengths) — the serving-path shape.  Prefixes
    past a path's end are (0, 0), the "no such prefix" sentinel that
    doubles as the length check."""
    n = len(paths)
    if lengths is None:
        sample = list(range(1, MAX_PREFIX + 1))
    else:
        sample = [int(x) for x in lengths]
    upto = sample[-1] if sample else 0
    arr = np.zeros((n, max(upto, 1)), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    for i, p in enumerate(paths):
        b = p.encode()[:upto]
        lens[i] = len(b)
        arr[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    # vectorized rolling FNV: one pass over positions, whole batch per
    # step (uint64 wraps mod 2^64 natively)
    out = np.zeros((n, len(sample), 2), dtype=np.uint32)
    h = np.full(n, _FNV_OFFSET, dtype=np.uint64)
    prime = np.uint64(_FNV_PRIME)
    col = {L: k for k, L in enumerate(sample)}
    with np.errstate(over="ignore"):
        for j in range(upto):
            h = (h ^ arr[:, j].astype(np.uint64)) * prime
            k = col.get(j + 1)
            if k is None:
                continue
            lo = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            hi = (h >> np.uint64(32)).astype(np.uint32)
            lo = np.where((lo | hi) == 0, np.uint32(1), lo)
            alive = j < lens
            out[:, k, 0] = np.where(alive, lo, 0)
            out[:, k, 1] = np.where(alive, hi, 0)
    return out


def featurize_http(requests: Sequence[dict], port: int,
                   src_row: int = 0) -> Tuple[np.ndarray, List[dict]]:
    """Structured HTTP requests ({method, path, host}) -> feature rows.

    Returns (rows [N, L7_COLS], the requests echoed back — callers keep
    them for regex fallback + access logs)."""
    from .l7policy import METHOD_IDS

    n = len(requests)
    out = np.zeros((n, L7_COLS), dtype=np.uint32)
    out[:, L7_PORT] = port
    out[:, L7_KIND] = KIND_HTTP
    out[:, L7_SRC_ROW] = src_row
    for i, r in enumerate(requests):
        out[i, L7_METHOD] = METHOD_IDS.get(r.get("method", "").upper(), 0)
        lo, hi = fnv64(r.get("path", ""))
        out[i, L7_PATH_H0], out[i, L7_PATH_H1] = lo, hi
        lo, hi = fnv64(r.get("host", ""))
        out[i, L7_HOST_H0], out[i, L7_HOST_H1] = lo, hi
    return out, list(requests)


def featurize_dns(qnames: Sequence[str], port: int,
                  src_row: int = 0) -> Tuple[np.ndarray, List[str]]:
    """DNS query names -> feature rows (qname hash in the path words)."""
    n = len(qnames)
    out = np.zeros((n, L7_COLS), dtype=np.uint32)
    out[:, L7_PORT] = port
    out[:, L7_KIND] = KIND_DNS
    out[:, L7_SRC_ROW] = src_row
    names = [_norm_dns(q) for q in qnames]
    for i, q in enumerate(names):
        lo, hi = fnv64(q)
        out[i, L7_PATH_H0], out[i, L7_PATH_H1] = lo, hi
    return out, names


def featurize_kafka(requests: Sequence[dict], port: int,
                    src_row: int = 0) -> Tuple[np.ndarray, List[dict]]:
    """Kafka requests ({api_key, topic, client_id}) -> feature rows:
    api id in the method column, topic hash in the path words."""
    n = len(requests)
    out = np.zeros((n, L7_COLS), dtype=np.uint32)
    out[:, L7_PORT] = port
    out[:, L7_KIND] = KIND_KAFKA
    out[:, L7_SRC_ROW] = src_row
    for i, r in enumerate(requests):
        out[i, L7_METHOD] = KAFKA_API_IDS.get(
            str(r.get("api_key", "")).lower(), 0)
        lo, hi = fnv64(r.get("topic", ""))
        out[i, L7_PATH_H0], out[i, L7_PATH_H1] = lo, hi
        lo, hi = fnv64(r.get("client_id", ""))
        out[i, L7_HOST_H0], out[i, L7_HOST_H1] = lo, hi
    return out, list(requests)


def parse_http_bytes(payloads: Iterable[bytes]) -> List[dict]:
    """Minimal HTTP/1.x request parser: request line + Host header.

    The wire-facing half of the featurizer (reference: proxylib's HTTP
    parser); malformed requests become empty dicts, which match no
    rule and are therefore denied by an enforcing L7 policy."""
    out = []
    for raw in payloads:
        try:
            head = raw.split(b"\r\n\r\n", 1)[0].decode("latin-1")
            lines = head.split("\r\n")
            method, path, _ = lines[0].split(" ", 2)
            host = ""
            for ln in lines[1:]:
                if ln.lower().startswith("host:"):
                    host = ln.split(":", 1)[1].strip()
                    break
            out.append({"method": method, "path": path, "host": host})
        except (ValueError, IndexError):
            out.append({})
    return out
