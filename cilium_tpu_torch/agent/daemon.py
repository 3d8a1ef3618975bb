"""Daemon: the agent wiring of the port, reduced to the serving path.

Reference: the JAX package's ``agent/daemon.py`` (itself upstream
cilium's ``daemon/cmd``): identity allocator, policy repository,
ipcache, endpoint regeneration, the monitor, background controllers,
and the serving front end -- admission queue, adaptive batcher, drain
runtime, K-batch superbatch dispatch, the occupancy-bounded ring drain
and the event-join worker, and the L7 proxy plane (the proxy, its
worker pool fed by the event join's REDIRECT rows, and the DNS-answer
-> FQDN identity loop).  The datapath is :class:`TorchLoader` on
``device`` (None: the card; the tests pass ``device="cpu"``), and the
proxy runs its L7 verdicts on the same device.

Ported members keep the reference's names and semantics.  What the
reference wires in besides, and the port does not have yet, raises
NotImplementedError naming its ROADMAP item, at construction (a config
knob turned on) or at the call: a multi-card mesh, span tracing and the
profiler window, mutual auth, encryption, the SLO plane and metric
history, the flight recorder, flow analytics, Hubble, NAT and
masquerade, the bandwidth manager, policy audit mode and monitor trace
aggregation.  The proxy's socket listeners, the DNS proxy and the xDS
surface are not ported (ROADMAP A17): L7 requests arrive through the
``handle_l7*`` calls and the serving plane's request source.
"""

from __future__ import annotations

import collections
import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import u32
from ..datapath.loader import TorchLoader
from ..fqdn import NameManager
from ..identity.allocator import CachingIdentityAllocator
from ..infra.controller import ControllerManager
from ..ipcache import IPCache
from ..labels import LabelSet, SOURCE_CIDR
from ..monitor.agent import MonitorAgent
from ..monitor.api import EventBatch
from ..policy.api import rules_from_obj
from ..policy.repository import PolicyRepository
from ..proxy import L7Proxy
from .endpoint import Endpoint
from .endpointmanager import EndpointManager

# incidents kept in memory (the flight recorder that captures bundles
# for them is not ported: ROADMAP A14)
MAX_INCIDENTS = 256


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


@dataclass
class DaemonConfig:
    """The reference's DaemonConfig, cut to the knobs of the ported
    path.  Knobs of unported planes default to off and raise
    NotImplementedError at construction when turned on."""

    ct_capacity: int = 1 << 20
    ct_gc_interval: float = 30.0
    fqdn_gc_interval: float = 15.0  # pkg/fqdn TTL sweep cadence
    # -- serving front end (serving/): see the reference for each knob
    serving_queue_depth: int = 1 << 16
    serving_bucket_ladder: Tuple[int, ...] = (1024, 4096, 16384, 65536)
    serving_max_wait_us: float = 2000.0
    serving_overflow_policy: str = "drop-tail"
    serving_packed_ingest: bool = False
    serving_superbatch_k: int = 1
    serving_window_queue_depth: int = 4
    serving_event_gather: bool = True
    # -- the L7 proxy plane (serving/l7plane.py + proxy/worker.py):
    # redirected rows fan out of the event-join worker into a bounded
    # pool of L7 workers.  Worker count and task-queue depth; overflow
    # sheds the OLDEST queued task, counted l7_shed, never silently.
    # The pool shares serving_restart_budget for its restart budget
    l7_workers: int = 2
    l7_queue_depth: int = 128
    # -- serving fault tolerance (watchdog + degraded-mode ladder)
    serving_dispatch_deadline_ms: float = 1000.0
    serving_restart_budget: int = 8
    serving_restart_backoff_ms: float = 10.0
    serving_demote_threshold: int = 3
    serving_promote_after: int = 64
    serving_promote_cooldown_s: float = 5.0
    # deterministic fault injection (infra/faults.py spec string)
    fault_injection: Optional[str] = None
    fault_seed: int = 0
    # -- map pressure (datapath/pressure.py); 0 disables the sampler
    map_pressure_interval: float = 5.0
    ct_pressure_threshold: float = 0.85
    ct_pressure_clear: float = 0.70
    ct_gc_pressure_interval: float = 1.0
    ct_gc_relax_after: float = 300.0
    ct_gc_relax_factor: float = 2.0
    ct_gc_relax_max: float = 4.0
    # -- unported planes: on raises NotImplementedError
    serving_trace_sample: int = 0  # span tracing (ROADMAP A14)
    profile_dir: Optional[str] = None  # profiler window (ROADMAP A14)
    enable_hubble: bool = False  # Hubble observer (ROADMAP A13)
    flow_agg_enabled: bool = False  # flow analytics (ROADMAP A14)
    sysdump_dir: Optional[str] = None  # flight recorder (ROADMAP A14)
    history_interval: float = 0.0  # SLO plane + history (ROADMAP A14)
    mesh_auth: bool = False  # mutual auth (ROADMAP A5)
    enable_encryption: bool = False  # encryption (ROADMAP A15)
    masquerade: bool = False  # NAT and masquerade (ROADMAP A8, B12)
    policy_audit_mode: bool = False  # audit mode (ROADMAP A16)
    monitor_aggregation: str = "none"  # trace aggregation (ROADMAP A16)


# config knob -> (what it turns on, the ROADMAP item that ports it)
_UNPORTED_KNOBS = {
    "serving_trace_sample": ("span tracing (obs/trace.py)", "A14"),
    "profile_dir": ("the serving profiler window", "A14"),
    "enable_hubble": ("the Hubble observer (flow/)", "A13"),
    "flow_agg_enabled": ("flow analytics (obs/analytics.py)", "A14"),
    "sysdump_dir": ("the flight recorder (obs/flightrec.py)", "A14"),
    "history_interval": ("the SLO plane and metric history (obs/slo.py, "
                         "obs/history.py)", "A14"),
    "mesh_auth": ("mutual authentication (agent/auth.py)", "A5"),
    "enable_encryption": ("transparent encryption (encryption/)", "A15"),
    "masquerade": ("NAT and masquerade (service/nat.py)", "A8, B12"),
    "policy_audit_mode": ("policy audit mode", "A16"),
    "monitor_aggregation": ("monitor trace aggregation", "A16"),
}


def _requires_auth(rules) -> bool:
    """Whether a rule section asks for mutual authentication, which the
    port cannot enforce yet (ROADMAP A5)."""
    return any(entry.auth_mode == "required"
               for r in rules
               for entry in (r.ingress + r.egress + r.ingress_deny
                             + r.egress_deny))


class Daemon:
    def __init__(self, config: Optional[DaemonConfig] = None,
                 device=None):
        from ..datapath.pressure import (MapPressureMonitor,
                                         validate_pressure_config,
                                         validate_relax_config)
        from ..serving import (validate_recovery_config,
                               validate_serving_config,
                               validate_superbatch_config)

        self.config = cfg = config or DaemonConfig()
        defaults = DaemonConfig()
        for knob, (what, item) in _UNPORTED_KNOBS.items():
            if getattr(cfg, knob) != getattr(defaults, knob):
                raise _not_ported(f"{what} ({knob})", item)
        # serving knobs fail at CONSTRUCTION, normalized values written
        # back (the reference's contract)
        (cfg.serving_queue_depth, cfg.serving_bucket_ladder,
         cfg.serving_max_wait_us,
         cfg.serving_overflow_policy) = validate_serving_config(
            cfg.serving_queue_depth, cfg.serving_bucket_ladder,
            cfg.serving_max_wait_us, cfg.serving_overflow_policy)
        (cfg.serving_dispatch_deadline_ms, cfg.serving_restart_budget,
         cfg.serving_restart_backoff_ms, cfg.serving_demote_threshold,
         cfg.serving_promote_after,
         cfg.serving_promote_cooldown_s) = validate_recovery_config(
            cfg.serving_dispatch_deadline_ms, cfg.serving_restart_budget,
            cfg.serving_restart_backoff_ms, cfg.serving_demote_threshold,
            cfg.serving_promote_after, cfg.serving_promote_cooldown_s)
        cfg.serving_superbatch_k, _ = validate_superbatch_config(
            cfg.serving_superbatch_k)
        cfg.serving_window_queue_depth = int(cfg.serving_window_queue_depth)
        if cfg.serving_window_queue_depth < 1:
            raise ValueError(
                "serving_window_queue_depth must be >= 1 (the "
                "event-join worker's bounded window queue)")
        cfg.l7_workers = int(cfg.l7_workers)
        if cfg.l7_workers < 1:
            raise ValueError(
                "l7_workers must be >= 1 (the L7 proxy worker pool)")
        cfg.l7_queue_depth = int(cfg.l7_queue_depth)
        if cfg.l7_queue_depth < 1:
            raise ValueError(
                "l7_queue_depth must be >= 1 (the L7 pool's bounded "
                "task queue)")
        (cfg.map_pressure_interval, cfg.ct_pressure_threshold,
         cfg.ct_pressure_clear,
         cfg.ct_gc_pressure_interval) = validate_pressure_config(
            cfg.map_pressure_interval, cfg.ct_pressure_threshold,
            cfg.ct_pressure_clear, cfg.ct_gc_pressure_interval)
        (cfg.ct_gc_relax_after, cfg.ct_gc_relax_factor,
         cfg.ct_gc_relax_max) = validate_relax_config(
            cfg.ct_gc_relax_after, cfg.ct_gc_relax_factor,
            cfg.ct_gc_relax_max)
        self.allocator = CachingIdentityAllocator()
        self.repo = PolicyRepository(self.allocator)
        self.ipcache = IPCache()
        self.loader = TorchLoader(cfg.ct_capacity, device=device)
        self.endpoints = EndpointManager(self.repo, self.ipcache,
                                         self.loader)
        # L7 proxy plane: listeners follow the resolved redirects
        # (reference: pkg/proxy redirect lifecycle + Envoy filter)
        self.proxy = L7Proxy(device=self.loader.device)
        self.endpoints.on_attach(self.proxy.update)
        # the live L7 plane (serving/l7plane.py): built per serving
        # session in start_serving and read by the event-join worker
        # through this attribute, never through self._serving.
        # _l7_last keeps the last session's final stats
        self._l7plane = None
        self._l7_last: Optional[dict] = None
        # embedder seams for the plane's parse leg: a request source
        # (port, kind, task) -> requests, and a DNS resolver
        # (qname) -> (ips, ttl) feeding live FQDN identity mints
        self.l7_request_source = None
        self.l7_dns_resolver = None
        self.monitor = MonitorAgent()
        self.controllers = ControllerManager()
        self.incidents: collections.deque = collections.deque(
            maxlen=MAX_INCIDENTS)
        self._boot_time = time.time()
        self._started = False
        self._serving = None  # start_serving() installs the ring path
        self.ct_gc_evicted = 0  # CT entries the aging sweeps evicted
        self.pressure = MapPressureMonitor(
            sample_fn=lambda: self.loader.map_pressure(self._now()),
            on_accelerate=self._ct_gc_accelerate,
            on_restore=self._ct_gc_restore,
            record_incident=self.record_incident,
            ct_threshold=cfg.ct_pressure_threshold,
            ct_clear=cfg.ct_pressure_clear,
            gc_pressure_interval_s=cfg.ct_gc_pressure_interval,
            relax_after_s=cfg.ct_gc_relax_after,
            relax_factor=cfg.ct_gc_relax_factor,
            relax_max=cfg.ct_gc_relax_max,
            on_relax=self._ct_gc_relax)
        # ipcache catch-all: IPs no entry covers belong to WORLD
        world = self.allocator.allocate(LabelSet.parse("reserved:world"))
        self.ipcache.upsert("0.0.0.0/0", world.numeric_id,
                            source="reserved")
        self.ipcache.upsert("::/0", world.numeric_id, source="reserved")
        # fqdn loop: DNS answers observed by the proxy become identities
        # and ipcache entries (reference: pkg/fqdn)
        self.fqdn = NameManager(self.allocator, self.delete_ipcache)
        self.proxy.observe_dns(self.fqdn.observe)
        # rule changes and identity churn both end in one coalesced
        # regeneration
        self.repo.on_change(lambda rev: self.endpoints.regenerate())
        self.allocator.observe(self._on_identity_change)
        # initial empty attach so the datapath is live pre-endpoints
        self.endpoints.regenerate()
        # deterministic fault injection, armed last so a construction
        # that fails leaves nothing armed; shutdown() disarms it
        self._fault_injector = None
        if cfg.fault_injection:
            from ..infra import faults

            self._fault_injector = faults.arm(cfg.fault_injection,
                                              seed=cfg.fault_seed)

    # -- incidents -------------------------------------------------------
    def record_incident(self, kind: str, detail=None) -> dict:
        # thread-affinity: any
        """Keep one incident (map-pressure episode, ladder demotion,
        watchdog restart, terminal event worker) in memory."""
        inc = {"kind": kind, "detail": detail, "at": time.time()}
        self.incidents.append(inc)
        return inc

    def _serving_restart_incident(self, cause: str,
                                  terminal: bool) -> None:
        self.record_incident("watchdog-terminal" if terminal
                             else "watchdog-restart", {"cause": cause})

    def _eventworker_incident(self, error: str) -> None:
        self.record_incident("eventworker-terminal", {"error": error})

    def _l7pool_incident(self, error: str) -> None:
        """The L7 worker pool's on_terminal hook (a dying l7 thread)."""
        self.record_incident("l7pool-terminal", {"error": error})

    # -- identity churn ----------------------------------------------
    def _on_identity_change(self, kind: str, ident) -> None:
        # CIDR-derived identities feed the ipcache; only the MOST
        # SPECIFIC cidr label is the identity's prefix
        cidr_labels = []
        if kind == "add":
            cidrs = [l.key for l in ident.labels
                     if l.source == SOURCE_CIDR]
            if cidrs:
                exact = max(cidrs,
                            key=lambda c: int(c.rsplit("/", 1)[1]))
                self.ipcache.upsert(exact, ident.numeric_id,
                                    source="generated")
                cidr_labels.append(exact)
        if not self._started:
            # no serve loop yet, but cached resolutions are STALE (peer
            # sets freeze at resolve time): clear the cache only; the
            # regeneration add_endpoint triggers re-resolves fresh
            self.repo.invalidate_cache()
            # ...except a CIDR identity minted into a live pre-start
            # world: its ipcache entry must reach the datapath now
            if not (kind == "add" and cidr_labels
                    and self.endpoints.list()):
                return
        if self.endpoints.patch_identity(kind, ident):
            ok = all(self.endpoints.patch_ipcache(c, ident.numeric_id)
                     for c in cidr_labels)
            if ok:
                return
        self.repo.invalidate()  # also triggers regeneration

    # -- CT aging cadence (datapath/pressure.py hooks) --------------------
    def _ct_gc_sweep(self) -> int:
        # thread-affinity: api -- the ct-gc controller thread
        """One CT aging sweep at the daemon's clock; the evictions add
        to ``ct_gc_evicted``."""
        n = self.loader.gc(self._now())
        self.ct_gc_evicted += n
        return n

    def _ct_gc_schedule(self, interval: float) -> None:
        self.controllers.update("ct-gc", self._ct_gc_sweep, interval)

    def _ct_gc_accelerate(self, interval: float) -> None:
        # thread-affinity: api -- the map-pressure controller thread
        if not self._started:
            return
        self._ct_gc_schedule(interval)
        c = self.controllers.get("ct-gc")
        if c is not None:
            c.trigger()

    def _ct_gc_restore(self) -> None:
        # thread-affinity: api -- the map-pressure controller thread
        if not self._started:
            return
        self._ct_gc_schedule(self.config.ct_gc_interval)

    def _ct_gc_relax(self, multiplier: float) -> None:
        # thread-affinity: api -- the map-pressure controller thread
        if not self._started:
            return
        self._ct_gc_schedule(self.config.ct_gc_interval * multiplier)

    # -- lifecycle ----------------------------------------------------
    def start(self) -> None:
        """Start the background controllers: the CT aging sweep, the
        map-pressure sampler (one synchronous sample first, which seeds
        the insert-drop baseline) and the FQDN TTL sweep."""
        self._started = True
        self._ct_gc_schedule(self.config.ct_gc_interval)
        if self.config.map_pressure_interval > 0:
            self.pressure.sample()
            self.controllers.update(
                "map-pressure", self.pressure.sample,
                self.config.map_pressure_interval)
        self.controllers.update(
            "fqdn-gc", self.fqdn.gc, self.config.fqdn_gc_interval)

    def shutdown(self) -> None:
        self.controllers.stop_all()
        self.stop_serving()  # no-op when idle; drains in-flight work
        self.allocator.close()
        if self._fault_injector is not None:
            from ..infra import faults

            faults.disarm(self._fault_injector)
            self._fault_injector = None

    def _now(self) -> int:
        return int(time.time() - self._boot_time) + 1

    # -- policy, endpoint and ipcache API ------------------------------
    def policy_import(self, obj) -> int:
        rules = rules_from_obj(obj)
        if _requires_auth(rules):
            raise _not_ported("a policy rule requiring mutual "
                              "authentication (agent/auth.py)", "A5")
        return self.repo.add_list(rules)

    def add_endpoint(self, name: str, ips: Tuple[str, ...],
                     labels: List[str],
                     named_ports: Optional[Dict[str, int]] = None
                     ) -> Endpoint:
        return self.endpoints.add(name, ips, LabelSet.parse(*labels),
                                  named_ports=named_ports)

    def upsert_ipcache(self, cidr: str, numeric_id: int,
                       source: str = "k8s") -> None:
        """Map a prefix to an identity.  The port's loader has no
        in-place patch yet (ROADMAP B11), so this regenerates, which
        computes the same tables."""
        self.ipcache.upsert(cidr, numeric_id, source=source)
        if self.endpoints.patch_ipcache(cidr, numeric_id):
            return
        self.endpoints.regenerate()

    def delete_ipcache(self, cidr: str) -> None:
        self.ipcache.delete(cidr)
        if self.loader.delete_ipcache(cidr):
            return
        self.endpoints.regenerate()

    def set_bandwidth(self, ep_id: int, bytes_per_s) -> None:
        raise _not_ported("the bandwidth manager (datapath/bandwidth.py)",
                          "A8, B14")

    # -- L7 proxy API (the listener-facing entry) ----------------------
    def _src_row(self, src_identity: int) -> int:
        return (self.loader.row_map.row(src_identity)
                if self.loader.row_map else 0)

    def handle_l7_http(self, proxy_port: int, requests,
                       src_identity: int = 0) -> np.ndarray:
        """Verdict HTTP requests arriving on a redirect listener
        (1 = forward, 0 = 403)."""
        return self.proxy.handle_http(proxy_port, requests,
                                      self._src_row(src_identity))

    def handle_l7_dns(self, proxy_port: int, qnames,
                      src_identity: int = 0) -> np.ndarray:
        return self.proxy.handle_dns(proxy_port, qnames,
                                     self._src_row(src_identity))

    def handle_l7_kafka(self, proxy_port: int, requests,
                        src_identity: int = 0) -> np.ndarray:
        return self.proxy.handle_kafka(proxy_port, requests,
                                       self._src_row(src_identity))

    def handle_l7(self, kind: str, proxy_port: int, requests,
                  src_identity: int = 0) -> np.ndarray:
        """Verdict requests of a PLUGIN protocol (cassandra,
        memcached, or anything proxy/registry.py knows)."""
        return self.proxy.handle(kind, proxy_port, requests,
                                 self._src_row(src_identity))

    def proxy_stats(self) -> dict:
        """The proxy plane's picture: listener table, offline proxy
        counters, the LIVE L7 worker-pool ledger (or the last session's
        final one), per-plugin parse latency."""
        from ..proxy import registry as l7registry

        l7 = self._l7plane
        out = {
            "listeners": self.proxy.listeners(),
            "requests-total": self.proxy.requests_total,
            "requests-denied": self.proxy.requests_denied,
            "plane-active": l7 is not None,
            "parse-latency-by-plugin": l7registry.latency_snapshot(),
        }
        if l7 is not None:
            out["plane"] = l7.stats()
        elif self._l7_last is not None:
            out["plane"] = self._l7_last
        return out

    # -- the serving path ----------------------------------------------
    def start_serving(self, ring_capacity: int = 1 << 15,
                      drain_every: int = 4,
                      trace_sample: int = 1024,
                      ingress: bool = False,
                      packed: Optional[bool] = None,
                      mesh=None,
                      span_sample: Optional[int] = None,
                      window_queue_depth: Optional[int] = None,
                      event_gather: Optional[bool] = None,
                      superbatch_k: Optional[int] = None) -> None:
        """Switch to the SERVING monitor path: batches run through the
        datapath and the device event ring (no per-packet host fetch),
        and only the compacted events cross to the host at the drain
        cadence.  :meth:`serve_batch` / :meth:`serve_superbatch` feed
        it; :meth:`stop_serving` drains what is in flight.

        ``ingress=True`` also starts the front end: the bounded
        admission queue, the adaptive batcher (its staging arena in
        pinned host memory on the card) and the drain runtime;
        :meth:`submit` then feeds a packet stream.  ``packed``,
        ``window_queue_depth``, ``event_gather`` and ``superbatch_k``
        default to their ``serving_*`` config knobs, as on the
        reference.  ``mesh`` and ``span_sample`` raise
        NotImplementedError (ROADMAP A10 and A14)."""
        from ..monitor.ring import AsyncRingDrainer
        from ..serving import (ServingAlreadyActiveError,
                               validate_superbatch_config)
        from ..serving.eventplane import EventJoinWorker
        from ..serving.ladder import (FallbackLadder, RUNG_SINGLE,
                                      RUNG_WIDE)

        if mesh is not None:
            raise _not_ported("multi-card serving (start_serving(mesh=)"
                              ", parallel/mesh.py)", "A10, B17")
        if span_sample:
            raise _not_ported("span tracing (obs/trace.py)", "A14")
        if self._serving is not None:
            raise ServingAlreadyActiveError(
                "already serving; stop_serving() first")
        cfg = self.config
        if packed is None:
            packed = cfg.serving_packed_ingest
        if window_queue_depth is None:
            window_queue_depth = cfg.serving_window_queue_depth
        window_queue_depth = int(window_queue_depth)
        if window_queue_depth < 1:
            raise ValueError("window_queue_depth must be >= 1")
        if event_gather is None:
            event_gather = cfg.serving_event_gather
        event_gather = bool(event_gather)
        if superbatch_k is None:
            superbatch_k = cfg.serving_superbatch_k
        superbatch_k, k_ladder = validate_superbatch_config(superbatch_k)
        # the listener table: redirect events carry their proxy port as
        # an index into it (ring_append and the drainer share it)
        from ..kernels import MAX_PROXY_PORTS

        table = np.asarray(sorted(self.proxy.ports)[:MAX_PROXY_PORTS],
                           dtype=np.uint32)
        dev = self.loader.device
        drainer = AsyncRingDrainer(ring_capacity, proxy_ports=table,
                                   gather=event_gather, device=dev)
        rungs = ([RUNG_SINGLE] if packed else []) + [RUNG_WIDE]
        # arena recycling horizon (serving/batcher.py): a header slot
        # must outlive the batches filling the next window plus every
        # window in flight on the worker; the worker refuses joins
        # older than join_horizon batches (counted drops)
        arena_depth = (window_queue_depth + 3) * drain_every + 2
        join_horizon = window_queue_depth * drain_every + 2
        worker = EventJoinWorker(
            self._event_join, queue_depth=window_queue_depth,
            restart_budget=cfg.serving_restart_budget,
            on_terminal=self._eventworker_incident)
        # the L7 proxy plane: redirected rows fan out of the event-join
        # worker into its bounded worker pool
        from ..serving.l7plane import L7Plane

        l7plane = L7Plane(
            self.proxy, workers=cfg.l7_workers,
            queue_depth=cfg.l7_queue_depth,
            restart_budget=cfg.serving_restart_budget,
            on_terminal=self._l7pool_incident,
            request_source=self.l7_request_source,
            dns_resolver=self.l7_dns_resolver)
        self._serving = {
            "drainer": drainer,
            "ring": drainer.fresh(),
            "table_dev": (u32.from_numpy(table, dev) if len(table)
                          else None),
            "proxy_table": table,
            "ring_capacity": ring_capacity,
            "trace_sample": trace_sample,
            "drain_every": drain_every,
            "seq": 0,
            "packed": bool(packed),
            "packed_pref": bool(packed),  # survives wide demotion
            "ladder": FallbackLadder(
                rungs, demote_threshold=cfg.serving_demote_threshold,
                promote_after=cfg.serving_promote_after,
                cooldown_s=cfg.serving_promote_cooldown_s,
                k_ladder=k_ladder),
            # the configured K ceiling (the ladder's live K can sit
            # below it after demotions); stretches window retention
            "superbatch_k": superbatch_k,
            # batch_id (wrapped) -> (kind, host rows, (ep, dirn) or
            # None, numeric ids, timestamp)
            "window": {},
            "eventplane": worker,
            "gather": event_gather,
            "join_horizon": join_horizon,
            # seq at the last drain tick
            "last_tick": 0,
        }
        l7plane.start()
        self._l7plane = l7plane
        worker.start()
        if ingress:
            from ..core.packets import N_COLS
            from ..serving import ServingRuntime

            deadline_s = cfg.serving_dispatch_deadline_ms * 1e-3
            runtime = ServingRuntime(
                dispatch=self._serving_dispatch,
                dispatch_super=self._serving_dispatch_super,
                superbatch_k=self._serving["ladder"].k,
                on_shed=self._publish_sheds,
                on_recovery_drop=self._publish_recovery_drops,
                queue_depth=cfg.serving_queue_depth,
                bucket_ladder=cfg.serving_bucket_ladder,
                max_wait_us=cfg.serving_max_wait_us,
                overflow_policy=cfg.serving_overflow_policy,
                expected_cols=N_COLS,
                pack=bool(packed),
                arena_depth=arena_depth,
                dispatch_deadline_s=deadline_s,
                restart_budget=cfg.serving_restart_budget,
                restart_backoff_s=cfg.serving_restart_backoff_ms * 1e-3,
                idle_wait_s=(min(0.05, deadline_s / 4)
                             if deadline_s > 0 else 0.05),
                idle_fn=self._serving_event_idle_tick,
                on_restart=self._serving_restart_incident,
                pin=dev.type == "cuda")
            self._serving["runtime"] = runtime
            runtime.start()

    def _serving_dispatch(self, hdr: np.ndarray, valid: np.ndarray,
                          n_valid: int, packed_meta=None):
        # thread-affinity: drain, api -- the ServingRuntime dispatch
        # callback; stop()'s final drain also lands here
        """The runtime's device leg: one padded bucket through
        serve_batch, wrapped by the degraded-mode ladder.  A failure
        counts toward the rung's demotion threshold; at the threshold
        the session demotes (single -> wide, K shrinking first) and
        the TRIGGERING batch retries on the demoted rung.  Below it the
        failure is contained (DispatchFailedError: counted recovery
        drops, the loop lives on); at the floor it escalates raw to
        the watchdog."""
        from ..serving import DispatchFailedError

        s = self._serving
        try:
            info = self._serving_device_leg(hdr, valid, packed_meta)
        except Exception as e:  # noqa: BLE001 — any device-leg fault
            lad = s["ladder"]
            cause = f"{type(e).__name__}: {e}"
            if not lad.record_failure(cause):
                if lad.at_floor:
                    raise  # not containable: escalate to the watchdog
                raise DispatchFailedError(
                    f"dispatch failed on rung {lad.rung!r} "
                    f"({lad.fail_streak}/{lad.demote_threshold}): "
                    f"{cause}") from e
            self._serving_demote(cause)
            # a packed bucket demoting to wide unpacks host-side first
            if packed_meta is not None and not s["packed"]:
                from ..core.packets import unpack_rows_np

                hdr = unpack_rows_np(np.asarray(hdr), *packed_meta)
                packed_meta = None
            info = self._serving_device_leg(hdr, valid, packed_meta)
            if isinstance(info, dict):
                info["demoted"] = True
        lad = s["ladder"]
        if lad.record_success() and s.get("runtime") is not None:
            self._serving_promote()
        return info

    def _serving_device_leg(self, hdr, valid, packed_meta):
        # thread-affinity: drain, api
        if packed_meta is None:
            return self.serve_batch(hdr, valid=valid)
        return self.serve_batch(hdr, valid=valid, packed_meta=packed_meta)

    def _serving_dispatch_super(self, sb):
        # thread-affinity: drain
        """The runtime's K-batch device leg, with the ladder wrap of
        :meth:`_serving_dispatch`; after a demotion the K batches
        retry one by one on the demoted rung."""
        from ..serving import DispatchFailedError

        s = self._serving
        try:
            info = self.serve_superbatch(sb)
        except Exception as e:  # noqa: BLE001 — any device-leg fault
            lad = s["ladder"]
            cause = f"{type(e).__name__}: {e}"
            if not lad.record_failure(cause):
                if lad.at_floor:
                    raise
                raise DispatchFailedError(
                    f"superbatch dispatch failed on rung "
                    f"{lad.rung!r} k={lad.k} "
                    f"({lad.fail_streak}/{lad.demote_threshold}): "
                    f"{cause}") from e
            self._serving_demote(cause)
            info = self._serving_retry_super_steps(sb)
            info["demoted"] = True
        lad = s["ladder"]
        if lad.record_success() and s.get("runtime") is not None:
            self._serving_promote()
        return info

    def _serving_retry_super_steps(self, sb) -> dict:
        # thread-affinity: drain
        """Retry a failed superbatch's steps one by one through the
        single-batch device leg (a packed step unpacks host-side first
        when the demotion also left packed mode)."""
        s = self._serving
        bids, total_h2d, mode = [], 0, None
        for k in range(sb.k):
            hdr = sb.hdr[k]
            meta = ((int(sb.eps[k]), int(sb.dirns[k]))
                    if sb.packed else None)
            if meta is not None and not s["packed"]:
                from ..core.packets import unpack_rows_np

                hdr = unpack_rows_np(np.asarray(hdr), *meta)
                meta = None
            info = self._serving_device_leg(hdr, sb.valid[k], meta)
            bids.append(int(info.get("batch_id", -1)))
            total_h2d += int(info.get("h2d_bytes", 0))
            mode = info.get("mode", mode)
        return {"h2d_bytes": total_h2d,
                "mode": mode or ("packed" if s["packed"] else "wide"),
                "bids": bids, "dispatches": sb.k}

    def _serving_demote(self, cause: str) -> None:
        # thread-affinity: drain, api
        """One rung down: shrink K first; single -> wide stops
        packing (the batcher and the per-batch path)."""
        s = self._serving
        lad = s["ladder"]
        old, old_k = lad.rung, lad.k
        new = lad.demote()
        # hot-path-ok: a ladder demotion is a rare contained-failure
        # event, never per batch
        logging.getLogger(__name__).warning(
            "serving ladder demotes %s@k%d -> %s@k%d: %s", old, old_k,
            new, lad.k, cause)
        self.record_incident("ladder-demotion",
                             {"from": f"{old}@k{old_k}",
                              "to": f"{new}@k{lad.k}", "cause": cause})
        s["packed"] = (new == "single") and s["packed_pref"]
        runtime = s.get("runtime")
        if runtime is not None:
            runtime.batcher.pack = s["packed"]
            runtime.superbatch_k = lad.k
            # the demoted shape's first dispatch is not a hang
            runtime.reset_warm_shapes()

    def _serving_promote(self) -> None:
        # thread-affinity: drain, api
        """One rung back up after sustained health and the cooldown:
        grow K, or wide -> single re-enables packing."""
        s = self._serving
        lad = s["ladder"]
        old, old_k = lad.rung, lad.k
        new = lad.promote()
        # hot-path-ok: promotions happen at most once per cooldown
        logging.getLogger(__name__).info(
            "serving ladder promotes %s@k%d -> %s@k%d", old, old_k, new,
            lad.k)
        if new != old:
            s["packed"] = s["packed_pref"]
        runtime = s.get("runtime")
        if runtime is not None:
            runtime.batcher.pack = s["packed"]
            runtime.superbatch_k = lad.k
            if new != old:
                runtime.reset_warm_shapes()

    def _publish_recovery_drops(self, rows: Optional[np.ndarray],
                                count: int, reason: int) -> None:
        # thread-affinity: drain, watchdog, api
        """Recovery-plane drops -> metricsmap + monitor DROP events."""
        from ..monitor.api import synth_drop_batch

        self.loader.add_host_drops(reason, count)
        if rows is None or not len(rows):
            return
        batch = synth_drop_batch(rows, reason, time.time())
        self.monitor.publish(self._filter_events(batch))

    def _publish_sheds(self, rows: Optional[np.ndarray],
                       count: int) -> None:
        # thread-affinity: drain, api
        """Admission sheds -> monitor DROP events (``count`` is exact,
        ``rows`` the bounded retained subset)."""
        from ..datapath.verdict import REASON_INGRESS_OVERFLOW
        from ..monitor.api import synth_drop_batch

        if rows is None or not len(rows):
            return
        batch = synth_drop_batch(rows, REASON_INGRESS_OVERFLOW,
                                 time.time())
        self.monitor.publish(self._filter_events(batch))

    def submit(self, rows: np.ndarray, t: Optional[float] = None) -> int:
        # thread-affinity: any
        """Offer a chunk of header rows to the serving front end
        (requires ``start_serving(ingress=True)``); returns how many
        were admitted.  Never blocks: overflow sheds by the configured
        policy and surfaces as counted DROP events."""
        from ..serving import ServingNotStartedError

        s = self._serving
        runtime = s.get("runtime") if s is not None else None
        if runtime is None:
            raise ServingNotStartedError(
                "call start_serving(ingress=True) first")
        return runtime.submit(rows, t)

    def serving_stats(self) -> dict:
        """Front-end telemetry, ring-drain counters, the event plane,
        the ladder and the map-pressure block."""
        s = self._serving
        if s is None:
            return {"active": False}
        d = s["drainer"]
        out = {"active": True,
               "ring": {"windows": d.windows, "events": d.events,
                        "lost": d.lost},
               "event-plane": s["eventplane"].stats(),
               "pressure": self.pressure.stats(),
               "mode": s["ladder"].rung,
               "ladder": s["ladder"].to_dict()}
        runtime = s.get("runtime")
        if runtime is not None:
            out.update(runtime.snapshot())
        l7 = self._l7plane
        if l7 is not None:
            out["l7"] = l7.stats()
        return out

    def serve_batch(self, hdr: np.ndarray, now: Optional[int] = None,
                    valid: Optional[np.ndarray] = None,
                    packed_meta=None) -> dict:
        # thread-affinity: drain, api
        """One serving-path batch: dispatch, retain the host header
        rows for the event join, tick the drain every ``drain_every``
        batches.  ``hdr`` must be host memory, left untouched until its
        window drains.  ``valid`` masks padding rows;
        ``packed_meta=(ep, dirn)`` marks ``hdr`` as packed [N, 4] rows.
        Returns link accounting for the runtime's telemetry."""
        from ..serving import ServingNotStartedError

        s = self._serving
        if s is None:
            raise ServingNotStartedError("call start_serving() first")
        if now is None:
            now = self._now()
        # the drain tick BEFORE the dispatch: the window then covers
        # exactly the batches dispatched since the previous tick
        if s["seq"] - s["last_tick"] >= s["drain_every"]:
            self._serving_drain_tick(s)
        bid = s["seq"] & 0x1FFF  # ring batch field width
        if packed_meta is not None:
            ep, dirn = packed_meta
            s["ring"], row_map = self.loader.serve_packed(
                s["ring"], hdr, now, bid, ep, dirn,
                trace_sample=s["trace_sample"],
                proxy_ports=s["table_dev"], valid=valid)
            self._serving_snapshot_numerics(s, row_map)
            s["window"][bid] = ("packed", np.asarray(hdr),
                                (int(ep), int(dirn)), s["numerics"],
                                time.time())
            info = {"h2d_bytes": hdr.nbytes, "mode": "packed",
                    "batch_id": bid}
        else:
            s["ring"], row_map = self.loader.serve(
                s["ring"], hdr, now, bid,
                trace_sample=s["trace_sample"],
                proxy_ports=s["table_dev"], valid=valid)
            self._serving_snapshot_numerics(s, row_map)
            # retained by REFERENCE: callers must not mutate hdr until
            # its window drains (the batcher arena's horizon)
            s["window"][bid] = ("wide", np.asarray(hdr), None,
                                s["numerics"], time.time())
            info = {"h2d_bytes": hdr.nbytes, "mode": "wide",
                    "batch_id": bid}
        s["seq"] += 1
        return info

    def _serving_snapshot_numerics(self, s, row_map) -> None:
        # thread-affinity: drain, api
        # numeric_array() copies the whole row -> numeric table; the
        # map only changes on identity churn, so snapshot per (object,
        # version)
        if (s.get("row_map") is not row_map
                or s.get("row_map_version") != row_map.version):
            s["row_map"] = row_map
            s["row_map_version"] = row_map.version
            s["numerics"] = row_map.numeric_array()

    def serve_superbatch(self, sb, now: Optional[int] = None) -> dict:
        # thread-affinity: drain, api
        """K batches in ONE loader call: ``sb`` is the batcher's
        :class:`~..serving.batcher.SuperBatch` ([K, bucket, cols] rows
        + [K, bucket] valid masks).  Each inner step gets its own batch
        id (``seq + k``) and its own retained window record, so the
        event-join worker decodes a superbatch window exactly like K
        single batches; the drain tick fires per dispatch."""
        from ..serving import ServingNotStartedError

        s = self._serving
        if s is None:
            raise ServingNotStartedError("call start_serving() first")
        if now is None:
            now = self._now()
        if s["seq"] - s["last_tick"] >= s["drain_every"]:
            self._serving_drain_tick(s)
        bid0 = s["seq"] & 0x1FFF
        s["ring"], row_map = self.loader.serve_superbatch(
            s["ring"], sb.hdr, now, bid0, eps=sb.eps, dirns=sb.dirns,
            trace_sample=s["trace_sample"], proxy_ports=s["table_dev"],
            valid=sb.valid, packed=sb.packed)
        self._serving_snapshot_numerics(s, row_map)
        ts = time.time()
        kind = "packed" if sb.packed else "wide"
        bids = []
        for k in range(sb.k):
            bid = (s["seq"] + k) & 0x1FFF
            meta = ((int(sb.eps[k]), int(sb.dirns[k]))
                    if sb.packed else None)
            s["window"][bid] = (kind, sb.hdr[k], meta, s["numerics"], ts)
            bids.append(bid)
        s["seq"] += sb.k
        return {"h2d_bytes": sb.hdr.nbytes, "mode": f"super-{kind}",
                "batch_id0": bid0, "bids": bids, "k": sb.k}

    def _serving_drain_tick(self, s) -> None:
        # thread-affinity: drain, api
        """The drain thread's whole event leg: read the cursor, start
        the occupancy-bounded asynchronous copy (``swap_window``) and
        push the window with its batch records onto the worker's
        bounded queue.  The cursor read also retires every staging
        copy issued before it (serving/batcher.py)."""
        from ..serving.eventplane import DrainWindow

        window, s["ring"] = s["drainer"].swap_window(s["ring"])
        s["last_tick"] = s["seq"]
        # shallow snapshot: the window keeps its records alive on the
        # worker regardless of the pruning below
        records = dict(s["window"])
        s["eventplane"].submit(DrainWindow(window, records, seq=s["seq"]))
        # retain headers for the batches filling the next window plus
        # one horizon of slack; a superbatch advances seq by K
        live = {(s["seq"] - 1 - i) & 0x1FFF
                for i in range(2 * (s["drain_every"]
                                    + s.get("superbatch_k", 1)))}
        for b in list(s["window"]):
            if b not in live:
                del s["window"][b]

    def _serving_event_idle_tick(self) -> None:
        # thread-affinity: drain
        """The runtime's idle hook: if any batch dispatched since the
        last drain tick, tick now, so a traffic pause flushes the
        pending window to the event plane."""
        s = self._serving
        if s is None or s["seq"] <= s["last_tick"]:
            return
        try:
            self._serving_drain_tick(s)
        except Exception:  # noqa: BLE001 — an idle-cadence swap
            # failure must not kill the drain loop
            # hot-path-ok: failure path of the IDLE tick
            logging.getLogger(__name__).warning(
                "idle event-plane drain tick failed", exc_info=True)

    def _event_join(self, dw) -> None:
        # thread-affinity: event-worker
        """The worker's join leg (never the drain thread): wait for the
        copy and decode, join packed rows back to wide columns, and
        publish to the monitor."""
        self._event_check_horizon(dw, self._serving)
        rows, shards, _appended, _lost = dw.ring.fetch()
        try:
            # the fetch can stall: re-check the recycling horizon
            # before publishing anything
            self._event_check_horizon(dw, self._serving)
            self._emit_ring_rows(rows, dw.records)
        except Exception:
            # the monitor got nothing and the worker counts the window
            # dropped: roll back fetch()'s credit so the ring ledger
            # and the event-plane ledger never count it twice
            d = dw.ring.drainer
            if d is not None:
                d.windows -= 1
                d.events -= dw.appended - dw.lost
                d.lost -= dw.lost
            raise

    @staticmethod
    def _event_check_horizon(dw, s) -> None:
        # thread-affinity: event-worker
        """Refuse a window the producer has dispatched past the arena
        recycling horizon: its records may point at recycled slots.
        Raising makes it a contained, COUNTED drop."""
        if (s is not None and dw.seq is not None
                and s["seq"] - dw.seq > s.get("join_horizon", 1 << 30)):
            raise RuntimeError(
                f"arena horizon exceeded: window is "
                f"{s['seq'] - dw.seq} batches stale "
                f"(horizon {s['join_horizon']})")

    def stop_serving(self) -> dict:
        # thread-affinity: api
        """Drain everything in flight and emit it; returns serving
        stats (windows/events/lost, the event plane, and the front-end
        snapshot when ingress mode was on).  Idempotent."""
        s = self._serving
        if s is None:
            return {"windows": 0, "events": 0, "lost": 0}
        runtime = s.get("runtime")
        front = None
        if runtime is not None:
            # stop the front end FIRST: its drain flushes every queued
            # row through serve_batch before the ring drains below
            front = runtime.stop(drain=True)
        d = s["drainer"]
        self._serving_drain_tick(s)
        ev = s["eventplane"].stop(drain=True)
        # the L7 plane stops AFTER the event plane: the join worker was
        # still fanning redirect rows into the pool until its drain
        # completed.  Drain the pool and keep its final stats
        l7 = None
        if self._l7plane is not None:
            l7 = self._l7plane.stop(drain=True)
            self._l7_last = l7
            self._l7plane = None
        self._serving = None
        out = {"windows": d.windows, "events": d.events,
               "lost": d.lost, "event-plane": ev}
        lad = s["ladder"]
        if lad.demotions or lad.promotions:
            out["ladder"] = lad.to_dict()
        if front is not None:
            out["front-end"] = front
        if l7 is not None:
            out["l7"] = l7
        return out

    def _emit_ring_rows(self, rows: np.ndarray, records: dict) -> None:
        # thread-affinity: event-worker
        """Join decoded ring rows back to their retained batch records
        and publish (``records`` is the window's swap-time snapshot,
        so this never touches ``self._serving``)."""
        from ..core.packets import unpack_rows_np
        from ..monitor.api import decode_ring_rows
        from ..monitor.ring import COL_BATCH, COL_PKT_IDX

        if rows is None or not len(rows):
            return
        for b in np.unique(rows[:, COL_BATCH]):
            rec = records.get(int(b))
            if rec is None:
                continue  # header window expired (overrun drain lag)
            kind, hdr, meta, numerics, ts = rec
            rows_b = rows[rows[:, COL_BATCH] == b]
            sel = hdr[rows_b[:, COL_PKT_IDX].astype(np.int64)]
            if kind == "packed":
                # wide columns only for the rows the ring kept
                sel = unpack_rows_np(sel, *meta)
            batch = decode_ring_rows(rows_b, sel, numerics, ts,
                                     aligned=True)
            # redirect fan-out: the L7 plane's bounded submit (never
            # blocks, shed is counted).  An attribute read, not a
            # _serving key; a racing stop_serving already drained what
            # was submitted or sheds it counted
            l7 = self._l7plane
            if l7 is not None:
                l7.ingest(batch)
            self.monitor.publish(self._filter_events(batch))

    def _filter_events(self, batch: EventBatch) -> EventBatch:
        """Per-endpoint event options: filters what the MONITOR plane
        sees; metrics keep every row."""
        from ..core.packets import COL_EP
        from ..monitor.api import MSG_DROP, MSG_TRACE

        opts = self.endpoints.event_options()
        if not opts:
            return batch
        keep = np.ones(len(batch), dtype=bool)
        ep_col = batch.hdr[:, COL_EP]
        for ep_id, o in opts.items():
            m = ep_col == ep_id
            if not o.get("DropNotification", True):
                keep &= ~(m & (batch.msg_type == MSG_DROP))
            if not o.get("TraceNotification", True):
                keep &= ~(m & (batch.msg_type == MSG_TRACE))
        if keep.all():
            return batch
        return EventBatch(
            msg_type=batch.msg_type[keep], verdict=batch.verdict[keep],
            reason=batch.reason[keep], ct_state=batch.ct_state[keep],
            identity=batch.identity[keep],
            proxy_port=batch.proxy_port[keep], hdr=batch.hdr[keep],
            timestamp=batch.timestamp)
