"""The L7 proxy port against the JAX package's: ``compile_l7`` gives the
same arrays; ``l7_verdict_plain`` (torch, int32 bit patterns) gives
JAX ``l7_verdict_jit``'s verdicts bit for bit over seeded random rule
and request tensors and the edge cases (literal, ``.*`` and ``.+``
prefixes, method-any, host-any, no rules, no prefix tensor with prefix
rows, prefix lengths at MAX_PREFIX - 1, full sampling); and the port's
``L7Proxy(device="cpu")`` gives the JAX ``L7Proxy``'s verdicts, counters
and access records on the cases of ``tests/test_l7.py`` and
``tests/test_l7_plugins.py``.  Every comparison is exact (the verdicts
are booleans).
"""

import numpy as np
import pytest
import torch

from cilium_tpu.policy.api import L7Rules as JL7Rules
from cilium_tpu.proxy import L7Proxy as JProxy
from cilium_tpu.proxy import featurize as jfeat
from cilium_tpu.proxy import plugins as jplugins
from cilium_tpu.proxy.l7policy import compile_l7 as jcompile
from cilium_tpu.proxy.l7policy import l7_verdict_jit
from cilium_tpu_torch import u32
from cilium_tpu_torch.policy.api import L7Rules
from cilium_tpu_torch.proxy import L7Proxy
from cilium_tpu_torch.proxy import featurize as tfeat
from cilium_tpu_torch.proxy import plugins as tplugins
from cilium_tpu_torch.proxy import registry as treg
from cilium_tpu_torch.proxy.l7policy import (KIND_DNS, KIND_HTTP,
                                             KIND_HTTP_PREFIX, KIND_KAFKA,
                                             MAX_PREFIX, R_COLS, compile_l7,
                                             l7_verdict, l7_verdict_plain)

torch.set_num_threads(1)


def _redirects(rules_by_port, l7cls):
    return [(port, "rule", l7cls.from_dict(rules))
            for port, rules in rules_by_port.items()]


def _pair(rules_by_port):
    """The JAX proxy and the port's (on the CPU) on one listener set."""
    j, t = JProxy(), L7Proxy(device="cpu")
    j.update([type("P", (), {"redirects": _redirects(rules_by_port,
                                                     JL7Rules)})()])
    t.update([type("P", (), {"redirects": _redirects(rules_by_port,
                                                     L7Rules)})()])
    return j, t


_LITERAL = [{"method": ("GET", "POST", "PUT", "DELETE")[i % 4],
             "path": f"/api/v{i % 3}/resource{i}"} for i in range(24)]
_PREFIX = [{"method": "GET", "path": f"/static/{i}/.*"} for i in range(4)]

COMPILE_CASES = {
    "http-literal": {10000: {"http": _LITERAL}},
    "http-prefix-and-regex": {10000: {"http": _PREFIX + [
        {"method": "GET", "path": "/api/v1/.+"},
        {"method": "GET", "path": "/api/v[0-9]+/users"},
        {"method": "PURGE", "path": "/cache"},
        {"method": "GET", "path": "/h", "headers": ["X-A: 1"]},
        {"path": "/" + "a" * 60 + "/.*"},
        {"host": "api.internal"}]}},
    "dns": {10053: {"dns": [{"matchName": "example.com."},
                            {"matchPattern": "*.example.com"}]}},
    "kafka": {19092: {"kafka": [{"role": "produce", "topic": "orders"},
                                {"topic": "logs"},
                                {"apiKey": "nosuchapi"}]}},
    "plugins": {11000: {"cassandra": [
        {"queryAction": "select", "queryTable": "ks.users"},
        {"queryAction": "select", "queryTable": "ks\\.(a|b)"}],
        "memcached": [{"command": "get", "keyExact": "k"},
                      {"command": "get", "keyPrefix": "p/"}]}},
    "two-ports": {10000: {"http": _LITERAL[:4] + _PREFIX[:2]},
                  10053: {"dns": [{"matchName": "a.io"}]}},
}


@pytest.mark.parametrize("case", sorted(COMPILE_CASES))
def test_compile_l7_matches_jax(case):
    rb = COMPILE_CASES[case]
    j = jcompile(_redirects(rb, JL7Rules))
    t = compile_l7(_redirects(rb, L7Rules))
    np.testing.assert_array_equal(t.rules, j.rules)
    assert t.rules.dtype == j.rules.dtype == np.uint32
    assert t.prefix_lengths == j.prefix_lengths
    assert t.ports == j.ports and t.n_prefix == j.n_prefix
    assert ({p: len(m) for p, m in t.host_matchers.items()}
            == {p: len(m) for p, m in j.host_matchers.items()})


# -- l7_verdict_plain against JAX l7_verdict_jit ---------------------------


def _random_tensors(seed, n=96, n_rules=40, k=6):
    """Rule and request rows drawn from small value pools, so every
    field both matches and misses; prefix rules with both flags."""
    rng = np.random.default_rng(seed)
    ports = np.array([10000, 10001, 0xFFFF0000], np.uint32)
    kinds = np.array([KIND_HTTP, KIND_DNS, KIND_KAFKA, KIND_HTTP_PREFIX, 16],
                     np.uint32)
    hashes = np.array([[0, 0], [1, 0x80000000], [0xDEADBEEF, 7],
                       [0xFFFFFFFF, 0xFFFFFFFF]], np.uint32)
    lens = np.sort(rng.choice(np.arange(1, MAX_PREFIX + 1), k,
                              replace=False)).astype(np.int32)
    rules = np.zeros((n_rules, R_COLS), np.uint32)
    rules[:, 0] = rng.choice(ports, n_rules)
    rules[:, 1] = rng.choice(kinds, n_rules)
    rules[:, 2] = rng.choice(np.array([0, 1, 2, 0xFFFFFFFF], np.uint32),
                             n_rules)
    pre = rules[:, 1] == KIND_HTTP_PREFIX
    plen = rng.choice(np.concatenate([lens, lens - 1, [MAX_PREFIX - 1]]),
                      n_rules).clip(0, 0xFF).astype(np.uint32)
    rules[pre, 2] = (rng.integers(0, 3, int(pre.sum())).astype(np.uint32)
                     | (plen[pre] << 8)
                     | (rng.integers(0, 2, int(pre.sum())).astype(np.uint32)
                        << 16))
    rules[:, 3:5] = hashes[rng.integers(0, 4, n_rules)]
    rules[:, 5:7] = hashes[rng.integers(0, 4, n_rules)]
    rows = np.zeros((n, 8), np.uint32)
    rows[:, 0] = rng.choice(ports, n)
    rows[:, 1] = rng.choice(np.array([KIND_HTTP, KIND_DNS, KIND_KAFKA, 16],
                                     np.uint32), n)
    rows[:, 2] = rng.choice(np.array([0, 1, 2, 0xFFFFFFFF], np.uint32), n)
    rows[:, 3:5] = hashes[rng.integers(0, 4, n)]
    rows[:, 5:7] = hashes[rng.integers(0, 4, n)]
    rows[:, 7] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    pref = hashes[rng.integers(0, 4, (n, k))]
    pref[rng.random((n, k)) < 0.3] = 0  # past the path's end
    # a prefix rule's own hash at its column, for some requests
    for i in np.nonzero(pre)[0][:8]:
        col = min(int(np.searchsorted(lens, plen[i])), k - 1)
        pref[i::7, col] = rules[i, 3:5]
    return rules, rows, pref.astype(np.uint32), lens


def _edge_tensors(name):
    """Hand-built rules and requests for one edge case; prefix hashes
    from the real featurizer so lengths and the (0, 0) sentinel are
    the proxy's."""
    port = 10000
    paths = ["/static/app.js", "/static/", "/static", "/api/v1/x",
             "/api/v1/", "/" + "b" * (MAX_PREFIX - 2) + "/z",
             "/" + "b" * (MAX_PREFIX - 2), "", "/other"]
    methods = [1, 1, 2, 1, 0, 3, 1, 1, 9]
    rows = np.zeros((len(paths), 8), np.uint32)
    rows[:, 0] = port
    rows[:, 1] = KIND_HTTP
    rows[:, 2] = methods
    for i, p in enumerate(paths):
        rows[i, 3:5] = tfeat.fnv64(p)
        rows[i, 5:7] = tfeat.fnv64("h.svc" if i % 2 else "")
    rows[-1, 1] = KIND_DNS

    def rule(kind, method, path="", host="", plen=0, plus=0):
        lo, hi = tfeat.fnv64(path)
        hlo, hhi = tfeat.fnv64(host)
        return [port, kind, method | (plen << 8) | (plus << 16), lo, hi,
                hlo, hhi]

    long_lit = "/" + "b" * (MAX_PREFIX - 2)  # MAX_PREFIX - 1 bytes
    table = {
        "literal": [rule(KIND_HTTP, 1, "/static/app.js"),
                    rule(KIND_HTTP, 1, "/api/v1/x", "h.svc")],
        "prefix-star": [rule(KIND_HTTP_PREFIX, 1, "/static/", plen=8)],
        "prefix-plus": [rule(KIND_HTTP_PREFIX, 0, "/api/v1/", plen=8,
                             plus=1)],
        "method-any": [rule(KIND_HTTP, 0, "/static")],
        "host-any": [rule(KIND_HTTP, 1, "")],
        "no-rules": [],
        "prefix-at-max": [rule(KIND_HTTP_PREFIX, 0, long_lit,
                               plen=MAX_PREFIX - 1, plus=1),
                          rule(KIND_HTTP_PREFIX, 1, long_lit,
                               plen=MAX_PREFIX - 1)],
        "dns-literal": [rule(KIND_DNS, 0, "/other")],
    }
    rules = np.asarray(table[name], np.uint32).reshape(-1, R_COLS)
    plens = set()
    for r in rules:
        if r[1] == KIND_HTTP_PREFIX:
            plens.add(int(r[2] >> 8) & 0xFF)
            if (r[2] >> 16) & 1:
                plens.add((int(r[2] >> 8) & 0xFF) + 1)
    lens = tuple(sorted(plens)) or (1,)
    pref = tfeat.path_prefix_hashes(paths, lens)
    return rules, rows, pref, np.asarray(lens, np.int32)


def _jax_verdict(rules, rows, pref, lens):
    import jax.numpy as jnp

    return np.asarray(l7_verdict_jit(
        jnp.asarray(rules), jnp.asarray(rows),
        None if pref is None else jnp.asarray(pref),
        None if lens is None else jnp.asarray(lens)))


def _port_verdict(rules, rows, pref, lens):
    t = [None if a is None else u32.from_numpy(a, "cpu")
         for a in (rules, rows, pref)]
    tl = None if lens is None else torch.from_numpy(lens.astype(np.int32))
    got = l7_verdict_plain(t[0], t[1], t[2], tl)
    # the dispatching wrapper takes the plain version on the CPU
    assert torch.equal(l7_verdict(t[0], t[1], t[2], tl), got)
    return got.numpy()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("sampling", ["compact", "full", "none"])
def test_l7_verdict_plain_matches_jax_random(seed, sampling):
    rules, rows, pref, lens = _random_tensors(seed)
    if sampling == "full":  # every length 1..K, column j = length j + 1
        lens = None
    elif sampling == "none":  # no prefix tensor: prefix rows never match
        pref = lens = None
    want = _jax_verdict(rules, rows, pref, lens)
    got = _port_verdict(rules, rows, pref, lens)
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(want)  # both outcomes exercised


@pytest.mark.parametrize("case", ["literal", "prefix-star", "prefix-plus",
                                  "method-any", "host-any", "no-rules",
                                  "prefix-at-max", "dns-literal"])
@pytest.mark.parametrize("with_pref", [True, False])
def test_l7_verdict_plain_matches_jax_edges(case, with_pref):
    rules, rows, pref, lens = _edge_tensors(case)
    if not with_pref:
        pref = lens = None
    want = _jax_verdict(rules, rows, pref, lens)
    np.testing.assert_array_equal(_port_verdict(rules, rows, pref, lens),
                                  want)
    if case == "no-rules":
        assert not want.any()
    if case in ("prefix-star", "prefix-plus", "prefix-at-max"):
        assert want.any() == with_pref  # prefix rows need the tensor


def test_l7_verdict_raises_without_a_kernel_or_plain_path():
    rules = torch.zeros((1, R_COLS), dtype=torch.int32, device="meta")
    rows = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        l7_verdict(rules, rows)


def test_proxy_defaults_to_the_card():
    if torch.cuda.is_available():
        assert L7Proxy().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            L7Proxy()


# -- the proxy against the JAX proxy ------------------------------------------


def _bench_requests(n, n_exact=24, n_regex=4, seed=3):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        r = rng.random()
        if r < 0.70:
            i = int(rng.integers(0, n_exact))
            reqs.append({"method": ("GET", "POST", "PUT", "DELETE")[i % 4],
                         "path": f"/api/v{i % 3}/resource{i}",
                         "host": "db.svc"})
        elif r < 0.85:
            i = int(rng.integers(0, n_regex))
            reqs.append({"method": "GET", "path": f"/static/{i}/app.js",
                         "host": "db.svc"})
        else:
            reqs.append({"method": "DELETE", "path": "/etc/passwd",
                         "host": "db.svc"})
    return reqs


_GET = {"method": "GET"}
# name -> (listeners, handler, port, requests); tests/test_l7.py and
# tests/test_l7_plugins.py case by case, plus a bench-shaped mix
PROXY_CASES = {
    "method-and-path": ({10000: {"http": [{"method": "GET",
                                           "path": "/data"}]}},
                        "http", 10000,
                        [{"method": "GET", "path": "/data"},
                         {"method": "POST", "path": "/data"},
                         {"method": "GET", "path": "/other"},
                         {"method": "GET", "path": "/data/x"}]),
    "method-only": ({10000: {"http": [_GET]}}, "http", 10000,
                    [{"method": "GET", "path": "/anything"},
                     {"method": "DELETE", "path": "/anything"}]),
    "host-constraint": ({10000: {"http": [{"method": "GET",
                                           "host": "api.internal"}]}},
                        "http", 10000,
                        [{"method": "GET", "path": "/x",
                          "host": "api.internal"},
                         {"method": "GET", "path": "/x",
                          "host": "evil.example"}]),
    "regex-path-fallback": ({10000: {"http": [
        {"method": "GET", "path": "/api/v[0-9]+/.*"}]}}, "http", 10000,
        [{"method": "GET", "path": "/api/v1/users"},
         {"method": "GET", "path": "/api/vX/users"},
         {"method": "POST", "path": "/api/v1/users"}]),
    "mixed-exact-and-regex": ({10000: {"http": [
        {"method": "GET", "path": "/exact"},
        {"method": "PUT", "path": "/re/.*"},
        {"method": "GET", "path": "/g(a|b)"}]}}, "http", 10000,
        [{"method": "GET", "path": "/exact"},
         {"method": "PUT", "path": "/re/anything"},
         {"method": "PUT", "path": "/exact"},
         {"method": "GET", "path": "/gb"}]),
    "unknown-port": ({10000: {"http": [_GET]}}, "http", 31337,
                     [{"method": "DELETE", "path": "/"}]),
    "unknown-method": ({10000: {"http": [{"method": "PURGE",
                                          "path": "/cache"}]}},
                       "http", 10000,
                       [{"method": "PURGE", "path": "/cache"},
                        {"method": "GET", "path": "/cache"}]),
    "headers": ({10000: {"http": [{"method": "GET", "path": "/h",
                                   "headers": ["X-A: 1"]}]}}, "http", 10000,
                [{"method": "GET", "path": "/h", "headers": ["X-A: 1"]},
                 {"method": "GET", "path": "/h"}]),
    "prefix-semantics": ({10000: {"http": [
        {"method": "GET", "path": "/static/.*"},
        {"method": "GET", "path": "/api/v1/.+"}]}}, "http", 10000,
        [{"method": "GET", "path": "/static/app.js"},
         {"method": "GET", "path": "/static/"},
         {"method": "GET", "path": "/static"},
         {"method": "POST", "path": "/static/app.js"},
         {"method": "GET", "path": "/api/v1/x"},
         {"method": "GET", "path": "/api/v1/"},
         {"method": "GET", "path": "/api/v2/x"}]),
    "long-prefix-host-fallback": ({10000: {"http": [
        {"method": "GET", "path": "/" + "a" * 60 + "/.*"}]}}, "http",
        10000, [{"method": "GET", "path": "/" + "a" * 60 + "/x"},
                {"method": "GET", "path": "/b"}]),
    "prefix-with-host": ({10000: {"http": [
        {"method": "GET", "path": "/files/.*", "host": "cdn.svc"}]}},
        "http", 10000,
        [{"method": "GET", "path": "/files/x", "host": "cdn.svc"},
         {"method": "GET", "path": "/files/x", "host": "evil.svc"}]),
    "bench-mix": ({10000: {"http": _LITERAL + _PREFIX + [
        {"method": "GET", "path": "/legacy/[a-z]+"}]}}, "http", 10000,
        _bench_requests(256)),
    "dns-match-name": ({10053: {"dns": [{"matchName": "example.com"}]}},
                       "dns", 10053,
                       ["example.com", "example.com.", "EXAMPLE.COM",
                        "evil.com", "sub.example.com"]),
    "dns-match-pattern": ({10053: {"dns": [
        {"matchPattern": "*.example.com"}]}}, "dns", 10053,
        ["api.example.com", "example.com", "deep.sub.example.com",
         "evil.com"]),
    "kafka-produce-topic": ({19092: {"kafka": [
        {"role": "produce", "topic": "orders"}]}}, "kafka", 19092,
        [{"api_key": "produce", "topic": "orders"},
         {"api_key": "produce", "topic": "secrets"},
         {"api_key": "fetch", "topic": "orders"}]),
    "kafka-topic-only": ({19092: {"kafka": [{"topic": "orders"},
                                            {"apiKey": "bogus"}]}},
                         "kafka", 19092,
                         [{"api_key": "produce", "topic": "orders"},
                          {"api_key": "fetch", "topic": "orders"},
                          {"api_key": "fetch", "topic": "other"},
                          {"api_key": "bogus", "topic": "x"}]),
    "cassandra-exact": ({11000: {"cassandra": [
        {"queryAction": "select", "queryTable": "ks.users"},
        {"queryAction": "insert", "queryTable": "ks.audit"}]}},
        "cassandra", 11000,
        [{"action": "select", "table": "ks.users"},
         {"action": "insert", "table": "ks.audit"},
         {"action": "select", "table": "ks.secrets"},
         {"action": "drop-table", "table": "ks.users"}]),
    "cassandra-query-strings": ({11000: {"cassandra": [
        {"queryAction": "select", "queryTable": "ks.users"}]}},
        "cassandra", 11000,
        [{"query": "SELECT name FROM ks.users WHERE id = 1"},
         {"query": "DELETE FROM ks.users WHERE id = 1"}]),
    "cassandra-regex-table": ({11000: {"cassandra": [
        {"queryAction": "select", "queryTable": "ks\\.(users|posts)"}]}},
        "cassandra", 11000,
        [{"action": "select", "table": "ks.posts"},
         {"action": "select", "table": "ks.secrets"}]),
    "memcached-exact": ({11000: {"memcached": [
        {"command": "get", "keyExact": "session/1"}]}}, "memcached", 11000,
        [{"command": "get", "key": "session/1"},
         {"command": "set", "key": "session/1"},
         {"command": "get", "key": "session/2"}]),
    "memcached-prefix": ({11000: {"memcached": [
        {"command": "get", "keyPrefix": "public/"}]}}, "memcached", 11000,
        [{"command": "get", "key": "public/motd"},
         {"command": "get", "key": "private/motd"}]),
}

_COUNTERS = ("requests_total", "requests_denied", "host_fallback_checked",
             "host_fallback_allowed")


def _call(proxy, handler, port, reqs, src_row=5):
    if handler == "http":
        return proxy.handle_http(port, reqs, src_row)
    if handler == "dns":
        return proxy.handle_dns(port, reqs, src_row)
    if handler == "kafka":
        return proxy.handle_kafka(port, reqs, src_row)
    return proxy.handle(handler, port, reqs, src_row)


def _record_fields(r):
    return (r.kind, r.verdict, r.proxy_port, r.src_row, r.method, r.path,
            r.host, r.qname, r.status)


@pytest.mark.parametrize("case", sorted(PROXY_CASES))
def test_proxy_matches_jax(case):
    listeners, handler, port, reqs = PROXY_CASES[case]
    j, t = _pair(listeners)
    recs = ([], [])
    j.on_record(recs[0].append)
    t.on_record(recs[1].append)
    want = _call(j, handler, port, reqs)
    got = _call(t, handler, port, reqs)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    for c in _COUNTERS:
        assert getattr(t, c) == getattr(j, c), c
    assert ([_record_fields(r) for r in recs[1]]
            == [_record_fields(r) for r in recs[0]])
    assert t.listeners() == j.listeners() and t.ports == j.ports


@pytest.mark.parametrize("kind,payloads", [
    ("cassandra", [b"\x04\x00\x00\x01\x07\x00\x00\x00\x2c"
                   b"\x00\x00\x00\x25SELECT a FROM ks.users WHERE id = 1",
                   b"\x04\x00\x00\x01\x05\x00\x00\x00\x00", b"short"]),
    ("memcached", [b"get session/1\r\n", b"set session/1 0 0 1\r\nx\r\n",
                   b"\r\n"])])
def test_handle_bytes_matches_jax(kind, payloads):
    rules = {"cassandra": [{"queryAction": "select",
                            "queryTable": "ks.users"}],
             "memcached": [{"command": "get", "keyExact": "session/1"}]}
    j, t = _pair({11000: {kind: rules[kind]}})
    np.testing.assert_array_equal(t.handle_bytes(kind, 11000, payloads),
                                  j.handle_bytes(kind, 11000, payloads))
    for c in _COUNTERS:
        assert getattr(t, c) == getattr(j, c), c


def test_update_swaps_listeners_and_keeps_first_port_owner():
    """Two policies naming one port: the first compiles (reference:
    one listener per port); a later update replaces the whole table."""
    pols = [{10000: {"http": [{"method": "GET", "path": "/a"}]}},
            {10000: {"http": [{"method": "GET", "path": "/b"}]},
             10001: {"http": [_GET]}}]
    reqs = [{"method": "GET", "path": "/a"}, {"method": "GET", "path": "/b"}]
    j, t = JProxy(), L7Proxy(device="cpu")
    for p, cls in ((j, JL7Rules), (t, L7Rules)):
        p.update([type("P", (), {"redirects": _redirects(rb, cls)})()
                  for rb in pols])
    np.testing.assert_array_equal(t.handle_http(10000, reqs),
                                  j.handle_http(10000, reqs))
    assert t.ports == j.ports == frozenset({10000, 10001})
    for p, cls in ((j, JL7Rules), (t, L7Rules)):
        p.update([type("P", (), {"redirects": _redirects(pols[1], cls)})()])
    np.testing.assert_array_equal(t.handle_http(10000, reqs),
                                  j.handle_http(10000, reqs))
    assert t.handle_http(10000, reqs).tolist() == [0, 1]


def test_observe_answer_notifies_fqdn_observers():
    _j, t = _pair({10053: {"dns": [{"matchName": "example.com"}]}})
    seen = []
    t.observe_dns(lambda name, ips, ttl: seen.append((name, tuple(ips),
                                                      ttl)))
    t.observe_answer("Example.COM.", ["93.184.216.34"], ttl=300)
    assert seen == [("example.com", ("93.184.216.34",), 300)]


# -- the copied host modules ----------------------------------------------


def test_featurizers_match_jax():
    reqs = _bench_requests(64) + [{}, {"method": "purge", "path": "/x"}]
    for name in ("featurize_http", "featurize_kafka"):
        a = getattr(jfeat, name)(reqs, 10000, 3)[0]
        b = getattr(tfeat, name)(reqs, 10000, 3)[0]
        np.testing.assert_array_equal(b, a)
    names = ["Example.COM.", "a.b", ""]
    np.testing.assert_array_equal(tfeat.featurize_dns(names, 53)[0],
                                  jfeat.featurize_dns(names, 53)[0])
    paths = [r.get("path", "") for r in reqs] + ["/" + "z" * 70]
    for lens in (None, (1, 8, 9, MAX_PREFIX)):
        np.testing.assert_array_equal(
            tfeat.path_prefix_hashes(paths, lens),
            jfeat.path_prefix_hashes(paths, lens))
    for s in ("", "a", "/static/", "ü"):
        assert tfeat.fnv64(s) == jfeat.fnv64(s)
    raw = [b"GET /public HTTP/1.1\r\nHost: db.svc\r\n\r\n",
           b"POST /x HTTP/1.1\r\n\r\nbody", b"garbage"]
    assert tfeat.parse_http_bytes(raw) == jfeat.parse_http_bytes(raw)
    for q in ("INSERT INTO ks.t (a) VALUES (1)", "UPDATE ks.t SET a = 1",
              "", "select * from \"KS\".\"T\""):
        assert tplugins.parse_cql(q) == jplugins.parse_cql(q)


def test_registry_seam():
    assert {"cassandra", "memcached"} <= set(treg.names())
    with pytest.raises(ValueError):
        treg.register(treg.L7Protocol(
            name="clasher", kind=16, featurize=lambda *a: None,
            compile_rule=lambda r: ("row", [0, 0, 0, 0, 0])))
    # a fourth protocol needs only a registration
    kind = treg.next_kind()
    cmds = {"get": 1, "set": 2}
    proto = treg.register(treg.L7Protocol(
        name="toyredis-port", kind=kind,
        featurize=lambda reqs, port, src_row=0: treg.featurize_generic(
            kind, reqs, port, src_row,
            method_of=lambda r: cmds.get(r.get("cmd", ""), 0),
            f0_of=lambda r: r.get("key", "")),
        compile_rule=lambda rule: ("row", [cmds.get(rule.get("cmd", ""), 0),
                                           *tfeat.fnv64(rule.get("key", "")),
                                           0, 0])))
    assert treg.get("toyredis-port") is proto
    t = L7Proxy(device="cpu")
    t.update([type("P", (), {"redirects": [(11000, "t", L7Rules.from_dict(
        {"toyredis-port": [{"cmd": "get", "key": "k1"}]}))]})()])
    assert t.handle("toyredis-port", 11000, [
        {"cmd": "get", "key": "k1"}, {"cmd": "set", "key": "k1"}]).tolist() \
        == [1, 0]
    with pytest.raises(KeyError):
        t.handle("nosuchproto", 11000, [{"x": 1}])
    with pytest.raises(KeyError):
        t.handle_bytes("toyredis-port", 11000, [b"x"])
