"""L7Rules -> per-rule match tensors + host fallback matchers.

Reference: upstream cilium pushes ``api.L7Rules`` to Envoy as an xDS
``NetworkPolicy`` (``pkg/envoy``); the cilium Envoy filter evaluates
each request against the rule list (an unmatched request on an
L7-policied port gets 403 / a refused DNS answer — L7 default deny).

Each HTTP/DNS rule row compiles to one row of a match tensor; a
request matches a rule iff every constrained field agrees (method id,
64-bit path/qname hash, host hash).  The batched verdict is one pass
over [N requests x R rules] on the card: the ``l7_verdict`` kernel (K9,
``csrc/l7.cu``) for CUDA tensors, :func:`l7_verdict_plain` for CPU
tensors.  Rules whose fields are regexes/globs (not expressible as
exact hashes) compile to *host matchers* instead; a port is
host-evaluated only for requests no exact rule already admitted.

u32 words are int32 bit patterns on torch (``u32.py``): the compares
are sign-agnostic equalities, and the shifts that read a prefix rule's
method word widen to int64 first, so they are logical.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..policy.api import L7Rules
from ..u32 import widen
from .registry import get as registry_get
from .featurize import (
    KAFKA_API_IDS,
    KIND_DNS,
    KIND_HTTP,
    KIND_HTTP_PREFIX,
    KIND_KAFKA,
    L7_COLS,
    L7_HOST_H0,
    L7_HOST_H1,
    L7_KIND,
    L7_METHOD,
    L7_PATH_H0,
    L7_PATH_H1,
    L7_PORT,
    MAX_PREFIX,
    fnv64,
)

METHOD_IDS: Dict[str, int] = {
    "GET": 1, "POST": 2, "PUT": 3, "DELETE": 4, "HEAD": 5,
    "OPTIONS": 6, "PATCH": 7, "CONNECT": 8, "TRACE": 9,
}

# rule tensor columns
R_PORT = 0
R_KIND = 1
R_METHOD = 2  # 0 == any
R_PATH_H0 = 3  # (0,0) == any
R_PATH_H1 = 4
R_HOST_H0 = 5
R_HOST_H1 = 6
R_COLS = 7

_REGEX_CHARS = re.compile(r"[.*+?^$()\[\]{}|\\]")


def _is_literal(path: str) -> bool:
    """True when the rule's path regex is a plain literal (the common
    case), so it compiles to an exact hash."""
    return not _REGEX_CHARS.search(path)


def _prefix_form(path: str):
    """``LITERAL.*`` / ``LITERAL.+`` -> (literal, min_extra) or None.

    The overwhelmingly common regex-path shape compiles to a device
    prefix row (rolling prefix-hash compare); anything else stays a
    host matcher.  The literal must fit the rolling-hash window."""
    if len(path) < 3 or path[-1] not in "*+" or path[-2] != ".":
        return None
    lit = path[:-2]
    if not lit or not _is_literal(lit) or len(lit) > MAX_PREFIX - 1:
        return None
    return lit, (1 if path[-1] == "+" else 0)


@dataclass
class L7PolicyTensors:
    """Compiled L7 policy: device rule tensor + host fallback."""

    rules: np.ndarray  # [R, R_COLS] uint32 (exact rules)
    # port -> [fn(request_dict) -> bool] for regex/glob rules
    host_matchers: Dict[int, List[Callable]] = field(default_factory=dict)
    # every L7-policied port (requests on other ports bypass the proxy)
    ports: frozenset = frozenset()
    # port -> original L7Rules (for xDS-style display / DNS observers)
    by_port: Dict[int, L7Rules] = field(default_factory=dict)

    # sorted prefix lengths the rules probe (incl. L+1 for .+ rules);
    # the featurizer samples the rolling hash at exactly these
    prefix_lengths: Tuple[int, ...] = ()

    @property
    def n_prefix(self) -> int:
        """Device prefix rows (callers compute the rolling-hash tensor
        only when some rule consumes it)."""
        if self.rules.shape[0] == 0:
            return 0
        return int((self.rules[:, R_KIND] == KIND_HTTP_PREFIX).sum())


def compile_l7(redirects: Sequence[Tuple[int, str, L7Rules]]
               ) -> L7PolicyTensors:
    """Compile ``EndpointPolicy.redirects`` into match tensors.

    ``redirects`` is the resolver's (proxy_port, rule_label, L7Rules)
    list; one listener per port (reference: pkg/proxy redirect
    lifecycle)."""
    rows: List[List[int]] = []
    host_matchers: Dict[int, List[Callable]] = {}
    by_port: Dict[int, L7Rules] = {}
    ports = set()

    for port, _label, l7 in redirects:
        ports.add(port)
        by_port[port] = l7
        # regex-PATH-only http rules group into ONE alternation per
        # (method, host): the fallback then runs one fullmatch per
        # request instead of one per rule (the bench's 200-rule config
        # showed the per-rule loop dominating the fallback path)
        path_groups: Dict[Tuple[str, str], List[str]] = {}
        for h in l7.http:
            # 0 in the method column means "any"; a method OUTSIDE the
            # dense id table (PURGE, custom verbs) must NOT compile to
            # 0 — that would widen the rule — so it takes the host
            # matcher path, which compares method strings.
            method_id = (0 if not h.method
                         else METHOD_IDS.get(h.method.upper()))
            literal = ((not h.path or _is_literal(h.path))
                       and not h.headers and method_id is not None
                       and _is_literal(h.host))
            if literal:
                p_lo, p_hi = fnv64(h.path)
                ho_lo, ho_hi = fnv64(h.host)
                rows.append([
                    port, KIND_HTTP, method_id,
                    p_lo, p_hi, ho_lo, ho_hi,
                ])
                continue
            pref = (_prefix_form(h.path)
                    if h.path and not h.headers and method_id is not None
                    and _is_literal(h.host) else None)
            if pref is not None:
                # LITERAL.* rides the device prefix-hash compare: the
                # method word carries len(prefix) (bits 8..15) and the
                # .+ at-least-one-more-byte flag (bit 16)
                lit, extra = pref
                p_lo, p_hi = fnv64(lit)
                ho_lo, ho_hi = fnv64(h.host)
                rows.append([
                    port, KIND_HTTP_PREFIX,
                    method_id | (len(lit) << 8) | (extra << 16),
                    p_lo, p_hi, ho_lo, ho_hi,
                ])
                continue
            if (h.path and not h.headers and _is_literal(h.host)
                    and _groupable(h.path)):
                path_groups.setdefault(
                    (h.method.upper(), h.host), []).append(h.path)
                continue
            host_matchers.setdefault(port, []).append(
                _http_matcher(h))
        for (meth, host), paths in path_groups.items():
            host_matchers.setdefault(port, []).append(
                _http_group_matcher(meth, host, paths))
        for d in l7.dns:
            if d.match_name:
                lo, hi = fnv64(d.match_name.rstrip(".").lower())
                rows.append([port, KIND_DNS, 0, lo, hi, 0, 0])
            if d.match_pattern:
                pat = d.match_pattern.rstrip(".").lower()
                host_matchers.setdefault(port, []).append(
                    _dns_matcher(pat))
        for k in l7.kafka:
            # reference: api.PortRuleKafka {role|apiKey, topic,
            # clientID}; role produce/consume maps onto api ids
            api = str(k.get("apiKey") or k.get("role") or "").lower()
            api_id = KAFKA_API_IDS.get(api, 0) if api else 0
            topic = str(k.get("topic") or "")
            client = str(k.get("clientID") or "")
            if api and api_id == 0:
                # unknown api name: host matcher compares strings
                host_matchers.setdefault(port, []).append(
                    _kafka_matcher(k))
                continue
            t_lo, t_hi = fnv64(topic)
            c_lo, c_hi = fnv64(client)
            rows.append([port, KIND_KAFKA, api_id,
                         t_lo, t_hi, c_lo, c_hi])
        # plugin protocols (registry.py): each rule compiles to a row
        # of the SAME tensor or a host matcher — no per-protocol code
        # here.  Rules for an UNREGISTERED parser compile to nothing,
        # which under L7 default deny means such requests are denied
        # (the reference fails policy push when the parser is missing).
        for name, extra_rules in getattr(l7, "extra", ()):
            plugin = registry_get(name)
            if plugin is None:
                continue
            for rule in extra_rules:
                what, val = plugin.compile_rule(rule)
                if what == "row":
                    m, f0l, f0h, f1l, f1h = val
                    rows.append([port, plugin.kind, m,
                                 f0l, f0h, f1l, f1h])
                else:
                    host_matchers.setdefault(port, []).append(val)

    rules = (np.asarray(rows, dtype=np.uint32) if rows
             else np.zeros((0, R_COLS), dtype=np.uint32))
    plens = set()
    for row in rows:
        if row[R_KIND] == KIND_HTTP_PREFIX:
            L = (row[R_METHOD] >> 8) & 0xFF
            plens.add(L)
            if (row[R_METHOD] >> 16) & 1:
                plens.add(L + 1)  # the .+ at-least-one-more check
    return L7PolicyTensors(rules=rules, host_matchers=host_matchers,
                           ports=frozenset(ports), by_port=by_port,
                           prefix_lengths=tuple(sorted(plens)))


_BACKREF = re.compile(
    r"\\[1-9]|\(\?P=|\(\?P?<|\((?!\?)|\(\?[aiLmsux-]+\)")


def _groupable(path: str) -> bool:
    """A path regex joins the (method, host) alternation only if it
    carries no capturing groups, backreferences, or global inline
    flags — the alternation renumbers groups (``(a)\\1`` would match
    different text once other patterns precede it), and a ``(?i)``
    would either fail to compile mid-pattern or leak onto every
    grouped rule."""
    return _BACKREF.search(path) is None


def _http_group_matcher(meth: str, host: str,
                        paths: Sequence[str]) -> Callable:
    """One matcher for EVERY regex-path rule sharing (method, host):
    a single compiled alternation replaces the per-rule loop."""
    try:
        combined = re.compile("|".join(f"(?:{p})" for p in paths))
    except re.error:
        # a construct _groupable didn't anticipate: never let one
        # pattern take down the whole redirect set — match per rule
        singles = [re.compile(p) for p in paths]

        class combined:  # noqa: N801 — duck-typed fallback
            @staticmethod
            def fullmatch(s):
                return next(
                    (m for r in singles if (m := r.fullmatch(s))), None)

    def match(req) -> bool:
        if not isinstance(req, dict):
            return False
        if meth and req.get("method", "").upper() != meth:
            return False
        if host and req.get("host", "") != host:
            return False
        return combined.fullmatch(req.get("path", "")) is not None

    return match


def _http_matcher(h) -> Callable:
    meth = h.method.upper()
    path_re = re.compile(h.path) if h.path else None
    host_re = re.compile(h.host) if h.host else None

    def match(req) -> bool:
        if not isinstance(req, dict):
            return False  # a DNS qname on a mixed-rule port
        if meth and req.get("method", "").upper() != meth:
            return False
        if path_re and not path_re.fullmatch(req.get("path", "")):
            return False
        if host_re and not host_re.fullmatch(req.get("host", "")):
            return False
        if h.headers:
            have = {x.strip() for x in req.get("headers", ())}
            if not set(h.headers).issubset(have):
                return False
        return True

    return match


def _kafka_matcher(rule: dict) -> Callable:
    api = str(rule.get("apiKey") or rule.get("role") or "").lower()
    topic = str(rule.get("topic") or "")
    client = str(rule.get("clientID") or "")

    def match(req) -> bool:
        if not isinstance(req, dict):
            return False  # a DNS qname on a mixed-rule port
        if api and str(req.get("api_key", "")).lower() != api:
            return False
        if topic and req.get("topic", "") != topic:
            return False
        if client and req.get("client_id", "") != client:
            return False
        return True

    return match


def _dns_matcher(pattern: str) -> Callable:
    from ..fqdn.matchpattern import matches

    def match(req) -> bool:
        name = req if isinstance(req, str) else req.get("qname", "")
        return matches(pattern, name)

    return match


def _pref_lengths(pref: torch.Tensor,
                  pref_lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """The prefix length each column of ``pref`` samples (None: full
    sampling, column j = length j + 1)."""
    if pref_lengths is None:
        return torch.arange(1, pref.shape[1] + 1, dtype=torch.int64,
                            device=pref.device)
    return pref_lengths.to(device=pref.device, dtype=torch.int64)


def prefix_columns(rules: torch.Tensor,
                   pref_lengths: torch.Tensor) -> torch.Tensor:
    """Each rule's prefix columns, [R, 2] int32 (col, ncol): the
    left-side ``searchsorted`` of its prefix length ``L`` and of
    ``L + 1`` in ``pref_lengths`` (sorted ascending), each clamped to
    ``K - 1``, exactly as the reference picks them.  It depends on the
    rules only, so the proxy computes it once per policy update; a rule
    that is not a prefix row gets columns it never reads.  ``K`` must be
    at least 1."""
    k = pref_lengths.shape[0]
    plen = (widen(rules[:, R_METHOD]) >> 8) & 0xFF
    lens = pref_lengths.to(device=rules.device, dtype=torch.int64)
    col = torch.searchsorted(lens, plen).clamp(max=k - 1)
    ncol = torch.searchsorted(lens, plen + 1).clamp(max=k - 1)
    return torch.stack([col, ncol], dim=1).to(torch.int32)


def l7_verdict_plain(rules: torch.Tensor, rows: torch.Tensor,
                     pref: Optional[torch.Tensor] = None,
                     pref_lengths: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Batched request verdict: [N, L7_COLS] x [R, R_COLS] -> [N] bool
    (plain version; int32 bit patterns in, as ``u32.from_numpy`` makes
    them).

    A request is admitted iff SOME rule row matches on every
    constrained field (L7 default deny otherwise).

    ``pref`` ([N, K, 2] rolling path prefix hashes,
    featurize.path_prefix_hashes) serves the KIND_HTTP_PREFIX rows:
    a ``LITERAL.*`` rule matches when the request's rolling hash at
    ``len(LITERAL)`` equals the rule's prefix hash (and for ``.+``,
    a hash exists one byte further — i.e. the path is longer).  With
    no ``pref`` (or K = 0) prefix rows match nothing."""
    n = rows.shape[0]
    if rules.shape[0] == 0:
        return torch.zeros(n, dtype=torch.bool, device=rows.device)
    r = rules[None, :, :]  # [1, R, C]
    q = rows[:, None, :]  # [N, 1, C]
    is_pref = r[:, :, R_KIND] == KIND_HTTP_PREFIX
    port_ok = q[:, :, L7_PORT] == r[:, :, R_PORT]
    kind_ok = torch.where(is_pref, q[:, :, L7_KIND] == KIND_HTTP,
                          q[:, :, L7_KIND] == r[:, :, R_KIND])
    meth_id = torch.where(is_pref, r[:, :, R_METHOD] & 0xFF,
                          r[:, :, R_METHOD])
    meth_ok = (meth_id == 0) | (q[:, :, L7_METHOD] == meth_id)
    path_any = (r[:, :, R_PATH_H0] == 0) & (r[:, :, R_PATH_H1] == 0)
    path_ok = path_any | ((q[:, :, L7_PATH_H0] == r[:, :, R_PATH_H0])
                          & (q[:, :, L7_PATH_H1] == r[:, :, R_PATH_H1]))
    if pref is not None and pref.shape[1] > 0:
        cols = prefix_columns(rules, _pref_lengths(pref, pref_lengths))
        col, ncol = cols[:, 0].long(), cols[:, 1].long()
        extra = (widen(rules[:, R_METHOD]) >> 16) & 1  # [R]
        # the rule's sampled column, per request: [N, R]
        ph_hit = ((pref[:, col, 0] == rules[None, :, R_PATH_H0])
                  & (pref[:, col, 1] == rules[None, :, R_PATH_H1]))
        beyond_ok = (pref[:, ncol, 0] | pref[:, ncol, 1]) != 0
        pref_hit = ph_hit & ((extra[None, :] == 0) | beyond_ok)
        path_ok = torch.where(is_pref, pref_hit, path_ok)
    else:
        path_ok = path_ok & ~is_pref  # no prefix tensor: can't match
    host_any = (r[:, :, R_HOST_H0] == 0) & (r[:, :, R_HOST_H1] == 0)
    host_ok = host_any | ((q[:, :, L7_HOST_H0] == r[:, :, R_HOST_H0])
                          & (q[:, :, L7_HOST_H1] == r[:, :, R_HOST_H1]))
    hit = port_ok & kind_ok & meth_ok & path_ok & host_ok
    return hit.any(dim=1)


def l7_verdict(rules: torch.Tensor, rows: torch.Tensor,
               pref: Optional[torch.Tensor] = None,
               pref_lengths: Optional[torch.Tensor] = None,
               rule_cols: Optional[torch.Tensor] = None) -> torch.Tensor:
    """See :func:`l7_verdict_plain`.  CUDA tensors launch the
    ``l7_verdict`` kernel (K9); CPU tensors take the plain version.
    ``rule_cols`` is :func:`prefix_columns` precomputed for these rules
    and ``pref``'s sampling (the proxy's per-update bundle); without it
    the kernel path computes it here.  An empty rule table admits
    nothing and launches nothing."""
    if rows.is_cuda:
        if rules.shape[0] == 0:
            return torch.zeros(rows.shape[0], dtype=torch.bool,
                               device=rows.device)
        from ..kernels import launch_l7_verdict

        if pref is not None and pref.shape[1] > 0 and rule_cols is None:
            rule_cols = prefix_columns(rules,
                                       _pref_lengths(pref, pref_lengths))
        return launch_l7_verdict(rules, rows, pref, rule_cols)
    if rows.device.type != "cpu":
        raise ValueError(f"l7_verdict: no kernel for {rows.device}")
    return l7_verdict_plain(rules, rows, pref, pref_lengths)
