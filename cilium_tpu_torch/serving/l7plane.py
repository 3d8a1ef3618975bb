"""The L7 proxy plane: REDIRECT as a first-class serving outcome.

Reference: upstream cilium's redirect lifecycle — the datapath verdict
says ``REDIRECT`` with a proxy port, the packet detours through the
userspace proxy (Envoy / proxylib parsers), the proxy's L7 verdict
decides the flow's fate, and DNS answers observed by the dnsproxy
mint new identities that change SUBSEQUENT datapath verdicts
(``pkg/proxy``, ``pkg/fqdn``).  This module is the serving-tier
equivalent: it sits between the event plane and the
:class:`~..proxy.worker.L7WorkerPool`.

Lifecycle of one redirected row::

    device verdict REDIRECT (datapath/verdict.py, proxy port packed
      into the ring's 4-bit listener index)
        -> event plane join (decode_ring_rows restores the REAL port)
        -> L7Plane.ingest  [event-worker thread: select + group +
                            bounded submit, never the drain thread]
        -> L7WorkerPool    [l7 threads: synthesize/parse requests via
                            the plugin registry, the L7 verdict kernel
                            (K9) behind l7policy.l7_verdict on the
                            proxy's own stream, per-plugin parse
                            latency into the registry histograms]
        -> allowed DNS queries resolve (dns_resolver hook) and feed
           proxy.observe_answer -> fqdn.NameManager.observe -> a LIVE
           identity mint -> a full regeneration (the port has no
           incremental patch path yet, ROADMAP A2/A3) -> the NEXT
           device batch's verdict flips, mid-serving.

Rows are the ledger unit; the pool's no-silent-loss contract
(``redirected == l7_allowed + l7_denied + l7_shed + l7_failed``)
covers everything this plane ingests.

The device carries no payload bytes (headers only — the paper's
datapath is L3/L4), so the parse leg runs on the REQUEST SOURCE seam:
``request_source(port, kind, task)`` returns the payload-shaped
requests for a redirected row group.  The default source synthesizes
one deterministic request per row (exercising the full parse +
verdict machinery); tests and embedders install real sources (e.g.
the DNS proxy's captured queries) through
``Daemon.l7_request_source``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..policy.mapstate import VERDICT_REDIRECT
from ..proxy import registry as l7registry
from ..proxy.worker import (
    DEFAULT_L7_QUEUE,
    DEFAULT_L7_WORKERS,
    L7Task,
    L7WorkerPool,
)

# listener-kind dispatch preference when a port carries several rule
# families (upstream: one Envoy listener per parser type; here one
# port can in principle compile mixed rows)
_KIND_ORDER = ("http", "dns", "kafka")


def _default_request_source(port: int, kind: str, task: L7Task):
    """One deterministic synthetic request per redirected row — the
    parse + verdict machinery runs for real; the verdicts reflect the
    port's actual rules against the synthetic shape."""
    n = task.rows
    if kind == "dns":
        return [f"row{i}.synthesized.internal" for i in range(n)]
    if kind == "kafka":
        return [{"api_key": "fetch", "topic": "synthesized"}
                for _ in range(n)]
    return [{"method": "GET", "path": "/", "host": ""}
            for _ in range(n)]


class L7Plane:
    """Owns the worker pool and the redirect fan-out/handling logic.

    ``ingest(batch)`` runs on the event-join worker; everything
    downstream runs on the pool's ``l7`` threads."""

    def __init__(self, proxy,
                 workers: int = DEFAULT_L7_WORKERS,
                 queue_depth: int = DEFAULT_L7_QUEUE,
                 restart_budget: int = 3,
                 on_terminal: Optional[Callable[[str], None]] = None,
                 request_source: Optional[Callable] = None,
                 dns_resolver: Optional[Callable[[str], Tuple]] = None):
        self.proxy = proxy
        self.request_source = request_source or _default_request_source
        # dns_resolver(qname) -> (ips, ttl) | None: the answer leg for
        # ALLOWED dns queries; answers feed proxy.observe_answer ->
        # fqdn identity mints (a full regeneration each, until A2/A3)
        self.dns_resolver = dns_resolver
        self.pool = L7WorkerPool(
            self._handle, workers=workers, queue_depth=queue_depth,
            restart_budget=restart_budget, on_terminal=on_terminal)
        self._lock = threading.Lock()
        # guarded-by: _lock: batches_ingested, dns_answers,
        # guarded-by: _lock: dns_resolve_errors
        self.batches_ingested = 0
        self.dns_answers = 0
        self.dns_resolve_errors = 0

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        # thread-affinity: api
        self.pool.start()

    def stop(self, drain: bool = True, timeout: float = 30.0) -> dict:
        # thread-affinity: api
        self.pool.stop(drain=drain, timeout=timeout)
        return self.stats()

    # -- producer side (the event-join worker) -------------------------
    def ingest(self, batch) -> int:
        # thread-affinity: event-worker
        """Fan one decoded :class:`~..monitor.api.EventBatch`'s
        redirect rows into the pool, grouped by (proxy_port, source
        identity) so every task reaches the L7 verdict with one
        homogeneous ``src_row``.  Returns rows ingested.  Never
        blocks: the pool's submit is bounded + counted."""
        if len(batch) == 0:
            return 0
        sel = (np.asarray(batch.verdict) == VERDICT_REDIRECT) \
            & (np.asarray(batch.proxy_port) > 0)
        n = int(np.count_nonzero(sel))
        if n == 0:
            return 0
        ports = np.asarray(batch.proxy_port)[sel].astype(np.uint64)
        idents = np.asarray(batch.identity)[sel].astype(np.uint64)
        keys = (ports << np.uint64(32)) | idents
        # one pass for every group's row count (the reference counts
        # each group with its own scan over the batch); same groups, in
        # the same key order
        uniq, counts = np.unique(keys, return_counts=True)
        for key, rows in zip(uniq.tolist(), counts.tolist()):
            self.pool.submit(L7Task(port=key >> 32, rows=rows,
                                    identities=key & 0xFFFFFFFF))
        with self._lock:
            self.batches_ingested += 1
        return n

    # -- the handling leg (l7 workers) ---------------------------------
    def _kind_of(self, port: int) -> str:
        # thread-affinity: l7
        """The port's dominant rule family — upstream's parser-type
        selection at listener creation, done per task here because
        policy can re-compile the listener set mid-serving."""
        for li in self.proxy.listeners():
            if li.get("proxy-port") != port:
                continue
            best, best_n = "http", 0
            plugin_kinds = tuple(k for k in l7registry.names()
                                 if k not in _KIND_ORDER)
            for kind in _KIND_ORDER + plugin_kinds:
                c = int(li.get(f"{kind}-rules", 0) or 0)
                if c > best_n:
                    best, best_n = kind, c
            return best
        return "http"

    def _handle(self, task: L7Task) -> Tuple[int, int]:
        # thread-affinity: l7
        """Parse + verdict one redirected row group; returns
        (allowed, denied) row counts for the pool's ledger."""
        kind = self._kind_of(task.port)
        requests = self.request_source(task.port, kind, task)
        src_row = int(task.identities or 0)
        t0 = time.perf_counter()
        if kind == "dns":
            verdicts = self.proxy.handle_dns(task.port, requests,
                                             src_row=src_row)
        elif kind == "kafka":
            verdicts = self.proxy.handle_kafka(task.port, requests,
                                               src_row=src_row)
        elif kind == "http":
            verdicts = self.proxy.handle_http(task.port, requests,
                                              src_row=src_row)
        else:
            verdicts = self.proxy.handle(kind, task.port, requests,
                                         src_row=src_row)
        l7registry.observe_parse(
            kind, (time.perf_counter() - t0) * 1e6)
        v = np.asarray(verdicts)
        allowed = int(np.count_nonzero(v))
        denied = int(v.size) - allowed
        if kind == "dns" and allowed and self.dns_resolver is not None:
            self._resolve_allowed(task.port, requests, v)
        return allowed, denied

    def _resolve_allowed(self, port: int, qnames, verdicts) -> None:
        # thread-affinity: l7
        """The DNS answer leg: resolve each allowed query and feed the
        answer into the live FQDN pipeline.  Resolver failures are
        counted, never fatal — the verdict already landed."""
        for q, v in zip(qnames, verdicts):
            if not v:
                continue
            try:
                ans = self.dns_resolver(str(q))
                if not ans:
                    continue
                ips, ttl = ans
                if ips:
                    self.proxy.observe_answer(str(q), list(ips),
                                              ttl=int(ttl))
                    with self._lock:
                        self.dns_answers += 1
            except Exception:  # noqa: BLE001 — contained: an answer
                # that fails to mint must not fail the verdict ledger
                with self._lock:
                    self.dns_resolve_errors += 1

    # -- reading (API/CLI threads) -------------------------------------
    def stats(self) -> Dict[str, object]:
        # thread-affinity: any
        out = self.pool.stats()
        with self._lock:
            out["batches-ingested"] = self.batches_ingested
            out["dns-answers"] = self.dns_answers
            out["dns-resolve-errors"] = self.dns_resolve_errors
        out["parse-latency-by-plugin"] = l7registry.latency_snapshot()
        return out
