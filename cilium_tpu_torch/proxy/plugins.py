"""Built-in L7 protocol plugins: cassandra + memcached.

Reference: ``proxylib/cassandra`` (parses CQL query strings, matches
``query_action`` + ``query_table``) and ``proxylib/memcache`` (matches
command + keyExact/keyPrefix).  Each plugin here registers through the
generic seam in registry.py — NO code in featurize.py / l7policy.py /
proxy.py knows these protocols exist, which is the point: a fourth
protocol is a registration, not an edit.
"""

from __future__ import annotations

import re
from typing import Tuple

from .featurize import fnv64
from .registry import L7Protocol, featurize_generic, register

# -- cassandra ---------------------------------------------------------

# CQL actions the policy schema names (reference: proxylib/cassandra
# cassandraparser.go action table)
CQL_ACTIONS = {"select": 1, "insert": 2, "update": 3, "delete": 4,
               "create-table": 5, "drop-table": 6, "alter-table": 7,
               "truncate": 8, "use": 9, "batch": 10}

_CQL_RE = re.compile(
    r"^\s*(select|insert|update|delete|truncate|use|batch)\b"
    r"(?:.*?\b(?:from|into|update)\s+([\w.\"]+))?",
    re.IGNORECASE | re.DOTALL)


def parse_cql(query: str) -> dict:
    """CQL query string -> {action, table} (the wire-facing half;
    reference: proxylib/cassandra parses the QUERY frame body)."""
    m = _CQL_RE.match(query or "")
    if not m:
        return {}
    action = m.group(1).lower()
    table = (m.group(2) or "").replace('"', "").lower()
    if action == "update":  # UPDATE <table> SET ...
        m2 = re.match(r"\s*update\s+([\w.\"]+)", query, re.IGNORECASE)
        table = (m2.group(1).replace('"', "").lower() if m2 else table)
    return {"action": action, "table": table}


def _cass_featurize(requests, port, src_row=0):
    # requests: {action, table} (or {query} parsed on the fly)
    reqs = [parse_cql(r["query"]) if "query" in r else r
            for r in requests]
    return featurize_generic(
        CASSANDRA.kind, reqs, port, src_row,
        method_of=lambda r: CQL_ACTIONS.get(
            str(r.get("action", "")).lower(), 0),
        f0_of=lambda r: str(r.get("table", "")).lower())


# regex metacharacters EXCEPT '.', which in a table rule is the
# keyspace.table separator (the overwhelmingly common literal case);
# patterns carrying real regex operators still get regex semantics
_TABLE_REGEX_CHARS = re.compile(r"[*+?^$()\[\]{}|\\]")


def _cass_compile(rule: dict):
    """{queryAction, queryTable} -> tensor row; a regex table (like
    upstream's query_table regex) -> host matcher."""
    action = str(rule.get("queryAction") or rule.get("action") or
                 "").lower()
    table = str(rule.get("queryTable") or rule.get("table") or "")
    action_id = CQL_ACTIONS.get(action, 0) if action else 0
    literal = not _TABLE_REGEX_CHARS.search(table)
    if (action and action_id == 0) or not literal:
        table_re = re.compile(table.lower()) if table else None

        def match(req) -> bool:
            if not isinstance(req, dict):
                return False
            if "query" in req:
                req = parse_cql(req["query"])
            if action and str(req.get("action", "")).lower() != action:
                return False
            if table_re and not table_re.fullmatch(
                    str(req.get("table", "")).lower()):
                return False
            return True

        return "matcher", match
    lo, hi = fnv64(table.lower())
    return "row", [action_id, lo, hi, 0, 0]


def parse_cql_frames(payloads) -> list:
    """CQL native-protocol frames -> request dicts (the wire-facing
    half; reference: proxylib/cassandra parses the 9-byte frame
    header + QUERY long-string body).  Non-QUERY opcodes pass through
    as {} (matched by no rule -> denied under enforcing policy);
    malformed frames likewise."""
    import struct

    out = []
    for raw in payloads:
        try:
            if len(raw) < 9:
                out.append({})
                continue
            opcode = raw[4]
            if opcode != 0x07:  # QUERY
                out.append({"opcode": int(opcode)})
                continue
            (qlen,) = struct.unpack_from(">i", raw, 9)
            query = raw[13:13 + qlen].decode("utf-8", "replace")
            out.append(parse_cql(query))
        except (struct.error, IndexError):
            out.append({})
    return out


CASSANDRA = register(L7Protocol(
    name="cassandra", kind=16,
    featurize=_cass_featurize,
    compile_rule=_cass_compile,
    record_fields=lambda r: (str(r.get("action", "")),
                             str(r.get("table", ""))),
    parse_bytes=parse_cql_frames,
))

# -- memcached ---------------------------------------------------------

MEMCACHE_COMMANDS = {"get": 1, "gets": 1, "set": 2, "add": 3,
                     "replace": 4, "append": 5, "prepend": 6, "cas": 7,
                     "delete": 8, "incr": 9, "decr": 10, "touch": 11,
                     "flush_all": 12, "stats": 13}


def _mc_featurize(requests, port, src_row=0):
    return featurize_generic(
        MEMCACHED.kind, requests, port, src_row,
        method_of=lambda r: MEMCACHE_COMMANDS.get(
            str(r.get("command", "")).lower(), 0),
        f0_of=lambda r: str(r.get("key", "")))


def _mc_compile(rule: dict):
    """{command, keyExact} -> tensor row; {command, keyPrefix} ->
    host matcher (a prefix is not an exact hash)."""
    cmd = str(rule.get("command") or "").lower()
    cmd_id = MEMCACHE_COMMANDS.get(cmd, 0) if cmd else 0
    prefix = rule.get("keyPrefix")
    exact = rule.get("keyExact")
    if (cmd and cmd_id == 0) or prefix is not None:
        def match(req) -> bool:
            if not isinstance(req, dict):
                return False
            if cmd and str(req.get("command", "")).lower() != cmd:
                return False
            key = str(req.get("key", ""))
            if prefix is not None and not key.startswith(str(prefix)):
                return False
            if exact is not None and key != str(exact):
                return False
            return True

        return "matcher", match
    lo, hi = fnv64(str(exact or ""))
    return "row", [cmd_id, lo, hi, 0, 0]


def parse_memcache_lines(payloads) -> list:
    """Memcached TEXT protocol request lines -> request dicts
    (reference: proxylib/memcache; the command word + first key).
    Multi-key gets emit one dict per key is NOT done here — the
    policy unit is the request line, matching upstream's per-request
    verdict."""
    out = []
    for raw in payloads:
        try:
            line = raw.split(b"\r\n", 1)[0].decode("ascii", "replace")
            parts = line.split()
            if not parts:
                out.append({})
                continue
            cmd = parts[0].lower()
            req = {"command": cmd}
            if len(parts) > 1 and cmd in MEMCACHE_COMMANDS:
                req["key"] = parts[1]
            out.append(req)
        except (IndexError, ValueError):
            out.append({})
    return out


MEMCACHED = register(L7Protocol(
    name="memcached", kind=17,
    featurize=_mc_featurize,
    compile_rule=_mc_compile,
    record_fields=lambda r: (str(r.get("command", "")),
                             str(r.get("key", ""))),
    parse_bytes=parse_memcache_lines,
))
