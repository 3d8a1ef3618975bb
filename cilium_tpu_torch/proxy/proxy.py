"""The L7 proxy: redirect listeners, request verdicts, access records.

Reference: upstream cilium's proxy plane — ``pkg/proxy`` (redirect
lifecycle: one listener per allocated proxy port), the Envoy cilium
filter (per-request policy verdicts), and Hubble's ``parser/seven``
records (access logs).  Here requests batch through the featurizer and
the compiled match tensors (``l7policy``): the tensors live on the
proxy's device, and a request batch's verdict is one ``l7_verdict``
call there (the K9 kernel on the card, its plain version on the CPU).
Only regex/glob rules drop to host matchers, and only for requests the
exact tensor pass didn't already admit.

The reference runs this verdict on the host's CPU backend on purpose,
to save a round trip to a remote accelerator; the port runs it on the
card like every other entry point, on the proxy's own CUDA stream so
that a verdict never waits behind the serving path's queued batches.
Each policy update swaps one complete bundle (host tensors, device
tensors) under the lock; a worker holding an older bundle keeps it
alive until its call ends.

An unmatched request on an L7-policied port is DENIED (HTTP 403 /
refused DNS) — L7 default deny, matching the reference's filter
behavior on ports carrying ``rules``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .featurize import (
    KIND_DNS,
    KIND_HTTP,
    featurize_dns,
    featurize_http,
)
from .. import u32
from ..device import resolve_device
from .l7policy import (L7PolicyTensors, compile_l7, l7_verdict,
                       prefix_columns)

VERDICT_FORWARDED = 1
VERDICT_DENIED = 0


@dataclass
class L7Record:
    """One access-log record (the hubble "seven" flow's source)."""

    kind: int  # KIND_HTTP | KIND_DNS
    verdict: int  # VERDICT_FORWARDED | VERDICT_DENIED
    proxy_port: int
    src_row: int
    timestamp: float
    # HTTP: method/path/host + synthetic status; DNS: qname
    method: str = ""
    path: str = ""
    host: str = ""
    qname: str = ""
    status: int = 0


# fn(qname, ips, ttl) — the fqdn subsystem subscribes to observed DNS
# answers (reference: pkg/fqdn's DNS proxy feeds the name manager)
DNSAnswerFn = Callable[[str, Sequence[str], int], None]


@dataclass(frozen=True)
class _Bundle:
    """One policy update's listener table: the compiled host tensors
    and their copies on the proxy's device (None without rules)."""

    tensors: L7PolicyTensors
    rules: Optional[torch.Tensor] = None  # [R, R_COLS] int32 bit patterns
    lens: Optional[torch.Tensor] = None  # [K] prefix lengths sampled
    cols: Optional[torch.Tensor] = None  # [R, 2] their prefix columns


class L7Proxy:
    def __init__(self, device=None):
        """``device`` holds the rule tensors and runs the verdicts
        (None: the card; ``"cpu"`` runs the plain version)."""
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        self._lock = threading.Lock()
        # guarded-by: _lock: _bundle, requests_total, requests_denied,
        # guarded-by: _lock: host_fallback_checked, host_fallback_allowed
        self._bundle = self._upload(compile_l7([]))
        self._records: List[Callable[[L7Record], None]] = []
        self._dns_observers: List[DNSAnswerFn] = []
        self.requests_total = 0
        self.requests_denied = 0
        # host-fallback accounting: requests the device tensors did NOT
        # admit that were re-checked against regex/glob host matchers
        # (the per-request Python cost center — the bench reports the
        # hit fraction so the device-tensor coverage is visible)
        self.host_fallback_checked = 0
        self.host_fallback_allowed = 0

    def _upload(self, tensors: L7PolicyTensors) -> _Bundle:
        """The device half of a bundle: the rules and their prefix
        columns (computed here, once per policy update), copied on the
        proxy's stream and finished before the bundle is published."""
        if not tensors.rules.shape[0]:
            return _Bundle(tensors)
        rules = u32.from_numpy(tensors.rules, "cpu")
        lens = cols = None
        if tensors.prefix_lengths:
            lens = torch.tensor(tensors.prefix_lengths, dtype=torch.int32)
            cols = prefix_columns(rules, lens)
        if self._stream is None:
            return _Bundle(tensors, rules, lens, cols)
        with torch.cuda.stream(self._stream):
            rules, lens, cols = (None if t is None else t.to(self.device)
                                 for t in (rules, lens, cols))
        self._stream.synchronize()
        return _Bundle(tensors, rules, lens, cols)

    # -- wiring -------------------------------------------------------
    def update(self, policies) -> None:
        """Recompile listeners from the resolved policies' redirects
        (called on attach/regeneration; reference: pkg/proxy
        UpdateRedirect on endpoint regeneration)."""
        redirects = []
        seen = set()
        for pol in policies:
            for port, label, l7 in pol.redirects:
                if port not in seen:
                    seen.add(port)
                    redirects.append((port, label, l7))
        bundle = self._upload(compile_l7(redirects))
        with self._lock:
            self._bundle = bundle

    def on_record(self, fn: Callable[[L7Record], None]) -> None:
        self._records.append(fn)

    def observe_dns(self, fn: DNSAnswerFn) -> None:
        self._dns_observers.append(fn)

    @property
    def ports(self) -> frozenset:
        with self._lock:
            return self._bundle.tensors.ports

    def listeners(self) -> list:
        """Redirect listeners + their rule shapes (GET /proxy; the
        xDS NetworkPolicy view)."""
        with self._lock:
            by_port = dict(self._bundle.tensors.by_port)
        return [{
            "proxy-port": port,
            "http-rules": len(l7.http),
            "dns-rules": len(l7.dns),
            "kafka-rules": len(l7.kafka),
            **{f"{name}-rules": len(rules)
               for name, rules in getattr(l7, "extra", ())},
        } for port, l7 in sorted(by_port.items())]

    # -- request paths ------------------------------------------------
    def _device_verdicts(self, b: _Bundle, rows: np.ndarray,
                         pref: Optional[np.ndarray]) -> np.ndarray:
        """Upload the request rows (and prefix hashes), run the verdict
        on the proxy's device and read the [N] mask back.  On the card
        all of it runs on the proxy's stream, and the read-back waits
        for that stream alone."""
        def run():
            q = u32.from_numpy(rows, self.device)
            p = None if pref is None else u32.from_numpy(pref, self.device)
            return l7_verdict(b.rules, q, p, b.lens,
                              rule_cols=b.cols).cpu().numpy()

        if self._stream is None:
            return run()
        with torch.cuda.stream(self._stream):
            return run()

    def _verdicts(self, rows: np.ndarray, port: int,
                  raw: Sequence) -> np.ndarray:
        with self._lock:
            b = self._bundle
        t = b.tensors
        if port not in t.ports:
            # no listener: the datapath never redirects here; treat as
            # pass-through (reference: proxy without policy forwards)
            return np.ones(len(raw), dtype=np.uint8)
        if t.rules.shape[0]:
            from .featurize import path_prefix_hashes

            # prefix rows consume the rolling path-hash tensor; it is
            # only computed when some rule needs it
            pref = None
            if t.n_prefix:
                pref = path_prefix_hashes(
                    [r.get("path", "") if isinstance(r, dict) else ""
                     for r in raw], t.prefix_lengths)
            allow = self._device_verdicts(b, rows, pref)
        else:
            allow = np.zeros(len(raw), dtype=bool)
        matchers = t.host_matchers.get(port)
        if matchers:
            pending = np.nonzero(~allow)[0]
            hits = 0
            for i in pending:
                if any(m(raw[i]) for m in matchers):
                    allow[i] = True
                    hits += 1
            with self._lock:
                self.host_fallback_checked += len(pending)
                self.host_fallback_allowed += hits
        return allow.astype(np.uint8)

    def _count(self, allow: np.ndarray) -> None:
        with self._lock:
            self.requests_total += len(allow)
            self.requests_denied += int((allow == 0).sum())

    def handle_http(self, port: int, requests: Sequence[dict],
                    src_row: int = 0) -> np.ndarray:
        """Verdict a batch of HTTP requests on one listener port.

        Returns [N] uint8 (1 = forward, 0 = 403)."""
        rows, raw = featurize_http(requests, port, src_row)
        allow = self._verdicts(rows, port, raw)
        now = time.time()
        self._count(allow)
        for i, req in enumerate(raw):
            self._emit(L7Record(
                kind=KIND_HTTP, verdict=int(allow[i]), proxy_port=port,
                src_row=src_row, timestamp=now,
                method=req.get("method", ""), path=req.get("path", ""),
                host=req.get("host", ""),
                status=200 if allow[i] else 403))
        return allow

    def handle(self, kind_name: str, port: int,
               requests: Sequence[dict],
               src_row: int = 0) -> np.ndarray:
        """Verdict requests of a PLUGIN protocol (registry.py) — the
        generic path a fourth parser rides without proxy edits."""
        from . import registry

        plugin = registry.get(kind_name)
        if plugin is None:
            raise KeyError(f"no L7 parser registered for {kind_name!r}")
        rows, raw = plugin.featurize(requests, port, src_row)
        allow = self._verdicts(rows, port, raw)
        now = time.time()
        self._count(allow)
        for i, req in enumerate(raw):
            m, p = plugin.record_fields(req)
            self._emit(L7Record(
                kind=plugin.kind, verdict=int(allow[i]),
                proxy_port=port, src_row=src_row, timestamp=now,
                method=m, path=p))
        return allow

    def handle_bytes(self, kind_name: str, port: int,
                     payloads: Sequence[bytes],
                     src_row: int = 0) -> np.ndarray:
        """Verdict RAW payloads of a plugin protocol that ships a
        wire parser (proxylib OnData analogue)."""
        from . import registry

        plugin = registry.get(kind_name)
        if plugin is None or plugin.parse_bytes is None:
            raise KeyError(
                f"no byte-level L7 parser registered for {kind_name!r}")
        return self.handle(kind_name, port, plugin.parse_bytes(payloads),
                           src_row)

    def handle_kafka(self, port: int, requests: Sequence[dict],
                     src_row: int = 0) -> np.ndarray:
        """Verdict Kafka requests ({api_key, topic, client_id});
        1 = forward, 0 = topic-authorization-failed."""
        from .featurize import KIND_KAFKA, featurize_kafka

        rows, raw = featurize_kafka(requests, port, src_row)
        allow = self._verdicts(rows, port, raw)
        now = time.time()
        self._count(allow)
        for i, req in enumerate(raw):
            self._emit(L7Record(
                kind=KIND_KAFKA, verdict=int(allow[i]),
                proxy_port=port, src_row=src_row, timestamp=now,
                method=str(req.get("api_key", "")),
                path=str(req.get("topic", ""))))
        return allow

    def handle_dns(self, port: int, qnames: Sequence[str],
                   src_row: int = 0) -> np.ndarray:
        """Verdict a batch of DNS queries (1 = forward, 0 = refused)."""
        rows, names = featurize_dns(qnames, port, src_row)
        allow = self._verdicts(rows, port, names)
        now = time.time()
        self._count(allow)
        for i, q in enumerate(names):
            self._emit(L7Record(
                kind=KIND_DNS, verdict=int(allow[i]), proxy_port=port,
                src_row=src_row, timestamp=now, qname=q))
        return allow

    def observe_answer(self, qname: str, ips: Sequence[str],
                       ttl: int = 60) -> None:
        """Feed an observed DNS answer to the fqdn subsystem
        (reference: the DNS proxy snoops responses and updates the
        name manager -> new fqdn identities -> ipcache)."""
        name = qname.rstrip(".").lower()
        for fn in list(self._dns_observers):
            fn(name, ips, ttl)

    def _emit(self, rec: L7Record) -> None:
        for fn in list(self._records):
            fn(rec)
