"""Daemon: the agent wiring of the port, reduced to the serving path.

Reference: the JAX package's ``agent/daemon.py`` (itself upstream
cilium's ``daemon/cmd``): identity allocator, policy repository,
ipcache, endpoint regeneration, the monitor, background controllers,
and the serving front end -- admission queue, adaptive batcher, drain
runtime, K-batch superbatch dispatch, the occupancy-bounded ring drain
and the event-join worker, and the L7 proxy plane (the proxy, its
worker pool fed by the event join's REDIRECT rows, and the DNS-answer
-> FQDN identity loop), and the offline path ``process_batch`` (the
service load balancer with its socket-LB flow cache, egress SNAT with
port allocation and the egress gateway, bandwidth policing, the
datapath step, reverse NAT, the monitor), and sharded serving over S
flow-routed shards on the one card (``start_serving(mesh=S)``, with its
rung of the degraded-mode ladder and the CT carried across its
demotion), CT snapshots and checkpoint/restore, mutual authentication
(an :class:`auth.AuthManager` granting the identity pairs that dropped
AUTH_REQUIRED) and the k8s watcher hub (``k8s_watchers``), and the
Hubble flow plane (``flow/``: the three-four parser into the Observer's
flow ring, the flow metrics, the JSONL exporter, the seven parser on the
proxy's access records, the pcap recorder, the relay and, with
``hubble_listen``, the gRPC Observer server), policy audit mode,
monitor trace aggregation and the flow analytics plane
(``obs/analytics.py``: windowed identity-pair aggregates, top-K
talkers and drop-spike incidents, aggregated off the dispatch path).
The datapath
is :class:`TorchLoader` on ``device`` (None: the card; the tests pass
``device="cpu"``), and the proxy runs its L7 verdicts on the same
device.  With ``anomaly_model_path`` set, an :class:`ml.AnomalyScorer`
on the same device scores every event the monitor publishes (advisory:
no verdict changes).

Ported members keep the reference's names and semantics.  What the
reference wires in besides, and the port does not have yet, raises
NotImplementedError naming its ROADMAP item, at construction (a config
knob turned on) or at the call: span tracing and the profiler window,
encryption, the SLO plane and metric history, and the flight recorder.
The proxy's socket listeners, the DNS proxy and the xDS surface are
not ported (ROADMAP A17): L7 requests arrive through the
``handle_l7*`` calls and the serving plane's request source.
"""

from __future__ import annotations

import collections
import json
import logging
import os
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
# the checkpoint's format version (the reference's VERSION)
VERSION = "0.1.0"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


@dataclass
class DaemonConfig:
    """The reference's DaemonConfig, field for field and at its
    defaults, so any config of the reference constructs here.

    Knobs of unported planes raise NotImplementedError naming their
    ROADMAP item at construction when set off their default
    (``_UNPORTED_KNOBS``).  One default differs from the reference on
    purpose, because its plane is not ported: ``history_interval`` is
    0.0.  ``backend`` ("tpu" |
    "interpreter") picks the reference's loader; the port has one loader
    on ``Daemon(device=...)`` and ignores it.  ``flow_ring_capacity``
    sizes the Hubble flow ring: a positive power of two, as the
    Observer asserts."""

    node_name: str = "node0"  # A20 (the node registry)
    backend: str = "tpu"  # accepted and ignored (docstring)
    ct_capacity: int = 1 << 20
    ct_gc_interval: float = 30.0
    flow_ring_capacity: int = 4096  # the Hubble flow ring
    export_path: Optional[str] = None  # the Hubble JSONL flow export
    # checkpoint directory: shutdown() checkpoints into it
    state_dir: Optional[str] = None
    enable_hubble: bool = True  # the Hubble observer and flow metrics
    anomaly_model_path: Optional[str] = None  # trained AnomalyModel .npz
    anomaly_threshold: float = 0.8
    fqdn_gc_interval: float = 15.0  # pkg/fqdn TTL sweep cadence
    # the Hubble gRPC Observer server's address (needs ``grpc``)
    hubble_listen: Optional[str] = None
    api_socket_path: Optional[str] = None  # A19
    health_probe_interval: float = 10.0  # A20
    # mutual authentication (agent/auth.py): the manager observes
    # AUTH_REQUIRED drops and grants for auth_ttl seconds
    mesh_auth: bool = True
    auth_ttl: int = 3600
    auth_gc_interval: float = 30.0
    enable_encryption: bool = False  # A15
    encryption_key_path: Optional[str] = None  # A15
    # -- egress masquerade (service/nat.py): node_ip is required with it
    masquerade: bool = False
    node_ip: Optional[str] = None
    nodeport_addresses: Tuple[str, ...] = ()  # A20
    non_masquerade_cidrs: Tuple[str, ...] = ("10.0.0.0/8",)
    identity_lease_ttl: Optional[float] = None  # A20
    # policy audit mode: policy/auth denials FORWARD (and create CT
    # state) while the event keeps the would-be reason
    policy_audit_mode: bool = False
    # monitor trace aggregation: "medium" keeps only drops, SYN/FIN/RST
    # and non-TCP traces; an endpoint's Debug option exempts it
    monitor_aggregation: str = "none"
    # -- serving front end (serving/): see the reference for each knob
    serving_queue_depth: int = 1 << 16
    serving_bucket_ladder: Tuple[int, ...] = (1024, 4096, 16384, 65536)
    serving_max_wait_us: float = 2000.0
    serving_overflow_policy: str = "drop-tail"
    serving_packed_ingest: bool = False
    serving_superbatch_k: int = 1
    serving_window_queue_depth: int = 4
    # -- the L7 proxy plane (serving/l7plane.py + proxy/worker.py):
    # redirected rows fan out of the event-join worker into a bounded
    # pool of L7 workers.  Worker count and task-queue depth; overflow
    # sheds the OLDEST queued task, counted l7_shed, never silently.
    # The pool shares serving_restart_budget for its restart budget
    l7_workers: int = 2
    l7_queue_depth: int = 128
    serving_event_gather: bool = True
    # -- serving fault tolerance (watchdog + degraded-mode ladder)
    serving_dispatch_deadline_ms: float = 1000.0
    serving_restart_budget: int = 8
    serving_restart_backoff_ms: float = 10.0
    serving_demote_threshold: int = 3
    serving_promote_after: int = 64
    serving_promote_cooldown_s: float = 5.0
    # periodic CT snapshot cadence in seconds (0: only on demotion and
    # checkpoint); the last snapshot rides the recovery paths
    ct_snapshot_interval: float = 0.0
    # deterministic fault injection (infra/faults.py spec string)
    fault_injection: Optional[str] = None
    fault_seed: int = 0
    # -- observability (ROADMAP A14)
    serving_trace_sample: int = 0  # span tracing
    profile_dir: Optional[str] = None  # the profiler window
    profile_batches: int = 16
    # -- the flow analytics plane (obs/analytics.py): windowed
    # identity-pair aggregates, top-K talkers, drop-spike incidents
    flow_agg_enabled: bool = True
    flow_agg_window_s: float = 1.0
    flow_agg_windows: int = 8
    flow_agg_topk: int = 32
    flow_agg_queue_depth: int = 16
    flow_agg_max_duty: float = 0.1
    spike_factor: float = 4.0
    spike_min_drops: int = 64
    spike_baseline_windows: int = 4
    sysdump_dir: Optional[str] = None  # the flight recorder
    sysdump_retention: int = 8
    sysdump_max_bytes: int = 1 << 20
    sysdump_min_interval_s: float = 1.0
    sysdump_flows: int = 128
    # -- the process-mode cluster (ROADMAP A21)
    cluster_forward_depth: int = 1 << 15
    cluster_probe_interval_s: float = 0.5
    cluster_death_threshold: int = 2
    cluster_convergence_deadline_s: float = 5.0
    cluster_kvstore: str = "remote"
    cluster_mode: str = "thread"
    cluster_slot_factor: int = 16
    cluster_obs_interval_s: float = 1.0
    cluster_obs_stale_after_s: float = 30.0
    cluster_trace_sample: int = 0
    cluster_forward_window: int = 8
    cluster_ack_every: int = 4
    cluster_ack_flush_ms: float = 2.0
    cluster_encrypt: bool = False
    cluster_epoch_grace_s: float = 2.0
    cluster_autoscale: bool = False
    cluster_autoscale_max_nodes: int = 8
    cluster_autoscale_high_frac: float = 0.5
    cluster_autoscale_ticks: int = 3
    cluster_autoscale_interval_s: float = 0.5
    cluster_autoscale_min_nodes: int = 1
    cluster_autoscale_low_frac: float = 0.0
    # -- delta attach: repaint only the fingerprint-changed policies on
    # a re-attach (False: every attach compiles in full); warn when a
    # publish holds the dispatch lock longer than policy_swap_warn_ms
    # (0: off)
    policy_delta_compile: bool = True
    policy_swap_warn_ms: float = 0.0
    # -- map pressure (datapath/pressure.py); 0 disables the sampler
    map_pressure_interval: float = 5.0
    ct_pressure_threshold: float = 0.85
    ct_pressure_clear: float = 0.70
    ct_gc_pressure_interval: float = 1.0
    # SNAT port-pool size: a power of two, the pool inside the port
    # space above NAT_PORT_MIN; None: NAT_DEFAULT_CAPACITY (1 << 14)
    nat_pool_capacity: Optional[int] = None
    ct_gc_relax_after: float = 300.0
    ct_gc_relax_factor: float = 2.0
    ct_gc_relax_max: float = 4.0
    # -- the SLO plane and metric history (ROADMAP A14)
    history_interval: float = 0.0  # the reference's 10.0
    history_slots: int = 360
    history_slow_every: int = 30
    history_slow_slots: int = 288
    slo_fast_window: float = 60.0
    slo_slow_window: float = 600.0
    slo_page_burn: float = 10.0
    slo_warn_burn: float = 2.0
    slo_clear_ticks: int = 3
    slo_max_duty: float = 0.05


# config knob -> (what it turns on, the ROADMAP item that ports it)
_UNPORTED_KNOBS = {
    "node_name": ("the node registry and health plane", "A20"),
    "api_socket_path": ("the agent's API server (api/)", "A19"),
    "health_probe_interval": ("the health plane (health/)", "A20"),
    "encryption_key_path": ("transparent encryption (encryption/)",
                            "A15"),
    "nodeport_addresses": ("the nodePort frontends of the k8s "
                           "watchers", "A20"),
    "identity_lease_ttl": ("leased identities (kvstore/)", "A20"),
    "serving_trace_sample": ("span tracing (obs/trace.py)", "A14"),
    "profile_dir": ("the serving profiler window", "A14"),
    "profile_batches": ("the serving profiler window", "A14"),
    "sysdump_dir": ("the flight recorder (obs/flightrec.py)", "A14"),
    "enable_encryption": ("transparent encryption (encryption/)", "A15"),
}
for _knob in ("sysdump_retention", "sysdump_max_bytes",
              "sysdump_min_interval_s", "sysdump_flows"):
    _UNPORTED_KNOBS[_knob] = ("the flight recorder (obs/flightrec.py)",
                              "A14")
for _knob in ("history_interval", "history_slots", "history_slow_every",
              "history_slow_slots", "slo_fast_window", "slo_slow_window",
              "slo_page_burn", "slo_warn_burn", "slo_clear_ticks",
              "slo_max_duty"):
    _UNPORTED_KNOBS[_knob] = ("the SLO plane and metric history "
                              "(obs/slo.py, obs/history.py)", "A14")
for _knob in ("cluster_forward_depth", "cluster_probe_interval_s",
              "cluster_death_threshold", "cluster_convergence_deadline_s",
              "cluster_kvstore", "cluster_mode", "cluster_slot_factor",
              "cluster_obs_interval_s", "cluster_obs_stale_after_s",
              "cluster_trace_sample", "cluster_forward_window",
              "cluster_ack_every", "cluster_ack_flush_ms",
              "cluster_encrypt", "cluster_epoch_grace_s",
              "cluster_autoscale", "cluster_autoscale_max_nodes",
              "cluster_autoscale_high_frac", "cluster_autoscale_ticks",
              "cluster_autoscale_interval_s",
              "cluster_autoscale_min_nodes", "cluster_autoscale_low_frac"):
    _UNPORTED_KNOBS[_knob] = ("the process-mode cluster (cluster/)",
                              "A21")
BACKENDS = ("tpu", "interpreter")  # the reference's; the port ignores it


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
        if cfg.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {cfg.backend!r} "
                f"(the port ignores it: its loader runs on the Daemon's "
                f"device)")
        ring_cap = cfg.flow_ring_capacity
        if ring_cap < 1 or ring_cap & (ring_cap - 1):
            raise ValueError(f"flow_ring_capacity must be a positive power "
                             f"of two, got {ring_cap}")
        cfg.monitor_aggregation = self._cast_aggregation(
            cfg.monitor_aggregation)
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
        if cfg.nat_pool_capacity is not None:
            # the failure names the knob, not a first masquerade deep in
            # process_batch
            from ..service.nat import NAT_PORT_MIN

            cap = int(cfg.nat_pool_capacity)
            if cap < 8 or cap & (cap - 1) or NAT_PORT_MIN + cap > 65536:
                raise ValueError(
                    f"nat_pool_capacity must be a power of two with "
                    f"NAT_PORT_MIN + capacity <= 65536 (the pool is "
                    f"[{NAT_PORT_MIN}, {NAT_PORT_MIN} + capacity) node "
                    f"ports)")
            cfg.nat_pool_capacity = cap
        cfg.policy_swap_warn_ms = float(cfg.policy_swap_warn_ms)
        if cfg.policy_swap_warn_ms < 0:
            raise ValueError("policy_swap_warn_ms must be >= 0")
        if cfg.masquerade and not cfg.node_ip:
            # running WITHOUT masquerade when the operator asked for it
            # would leak pod source IPs
            raise ValueError("masquerade=True requires node_ip to be set")
        from ..obs import FlowAnalytics, validate_analytics_config

        (cfg.flow_agg_window_s, cfg.flow_agg_windows, cfg.flow_agg_topk,
         cfg.flow_agg_queue_depth, cfg.spike_factor, cfg.spike_min_drops,
         cfg.spike_baseline_windows,
         cfg.flow_agg_max_duty) = validate_analytics_config(
            cfg.flow_agg_window_s, cfg.flow_agg_windows, cfg.flow_agg_topk,
            cfg.flow_agg_queue_depth, cfg.spike_factor, cfg.spike_min_drops,
            cfg.spike_baseline_windows, cfg.flow_agg_max_duty)
        self.allocator = CachingIdentityAllocator()
        self.repo = PolicyRepository(self.allocator)
        self.ipcache = IPCache()
        self.loader = TorchLoader(cfg.ct_capacity, device=device,
                                  nat_capacity=cfg.nat_pool_capacity,
                                  delta_compile=cfg.policy_delta_compile,
                                  swap_warn_ms=cfg.policy_swap_warn_ms)
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
        # the retained CT snapshot (periodic, on demotion, on checkpoint)
        self._ct_snap: Optional[dict] = None
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
        # bandwidth manager (pkg/bandwidth analogue): per-endpoint egress
        # rates; None until some endpoint is limited
        self._bw = None
        self._bw_rates = None
        self._bw_limits: Dict[int, int] = {}
        # egress masquerade and egress-gateway policies (name -> spec);
        # endpoint churn re-expands the pod selectors over the local
        # endpoints
        self._egress_policies: Dict[str, dict] = {}
        self._egress_rules_cache = None  # the last expanded rule tuple
        self.endpoints.on_attach(
            lambda _pols: (self._recompile_nat()
                           if self._egress_policies else None))
        self.nat = None
        if cfg.masquerade:
            from ..service.nat import NATConfig

            self.nat = NATConfig(
                node_ip=cfg.node_ip,
                non_masquerade_cidrs=cfg.non_masquerade_cidrs,
            ).compile(self.loader.device)
        # the service LB (service/__init__.py): VIP -> Maglev backend,
        # applied before the policy pipeline; the connect-time flow
        # cache (service/socklb.py) is created on first service traffic
        from ..service import ServiceManager

        self.services = ServiceManager(device=self.loader.device)
        self._socklb = None
        self._svc_version_seen = None  # affinity prune bookkeeping
        # mutual auth (pkg/auth): the drop-observing handshake manager,
        # fed where the batch's clock is in hand (process_batch, the
        # serving event join): grants are stamped on the clock the
        # datapath compares them with
        self.auth_manager = None
        if cfg.mesh_auth:
            from .auth import AuthManager

            self.auth_manager = AuthManager(self)
        # initial empty attach so the datapath is live pre-endpoints
        self.endpoints.regenerate()
        # the Hubble plane: the monitor's consumers in the reference's
        # order (hubble, metrics, exporter, anomaly, analytics, recorder)
        from ..flow import FlowExporter, FlowMetrics, Observer, ThreeFourParser
        from ..flow.recorder import Recorder

        self.observer = Observer(capacity=cfg.flow_ring_capacity,
                                 identity_getter=self._identity_labels,
                                 endpoint_getter=self._endpoint_info)
        self.parser = ThreeFourParser(self.observer)
        self.flow_metrics = FlowMetrics()
        self.seven = None
        self.exporter: Optional[FlowExporter] = None
        self.relay = None
        self.hubble_server = None
        if cfg.enable_hubble:
            self.monitor.register("hubble", self.parser.consume)
            self.monitor.register("metrics", self.flow_metrics.consume)
            # the seven parser: the proxy's access records become L7
            # flows in the same ring
            from ..flow.seven import SevenParser

            self.seven = SevenParser(
                self.observer,
                numeric_of_row=lambda r: (self.loader.row_map.numeric(r)
                                          if self.loader.row_map else 0))
            self.proxy.on_record(self.seven.consume)
        if cfg.export_path:
            self.exporter = FlowExporter(
                cfg.export_path, cfg.node_name,
                identity_getter=self._identity_labels,
                endpoint_getter=self._endpoint_info)
            self.monitor.register("exporter", self.exporter.consume)
        # learned path: advisory anomaly scores on the monitor stream
        self.anomaly = None
        if cfg.anomaly_model_path:
            from ..ml import AnomalyScorer, load_model

            self.anomaly = AnomalyScorer(
                load_model(cfg.anomaly_model_path, self.loader.device),
                self._rows_of_identity, threshold=cfg.anomaly_threshold,
                device=self.loader.device)
            self.monitor.register("anomaly", self.anomaly.consume)
        # flow analytics: one O(1) reference-park consumer on the
        # monitor stream; the aggregation runs on the event-join worker,
        # the process_batch caller, the roll controller and queries
        self.analytics = FlowAnalytics(
            window_s=cfg.flow_agg_window_s,
            retention=cfg.flow_agg_windows,
            topk=cfg.flow_agg_topk,
            queue_depth=cfg.flow_agg_queue_depth,
            spike_factor=cfg.spike_factor,
            spike_min_drops=cfg.spike_min_drops,
            spike_baseline_windows=cfg.spike_baseline_windows,
            max_duty=cfg.flow_agg_max_duty,
            ep_identity=self._endpoint_identity,
            on_incident=self.record_incident,
            enabled=cfg.flow_agg_enabled)
        self.monitor.register("analytics", self.analytics.submit)
        # the recorder: FlowFilter-gated pcap capture off the monitor
        self.recorder = Recorder()
        self.monitor.register("recorder", self.recorder.consume)
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
        watchdog restart, terminal event worker, drop spike) in memory."""
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
        # the fast path: patch the identity's verdict row and its LPM
        # slots in place (no re-resolve, no compile, no attach); a full
        # regeneration when the loader cannot express the patch
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
        the insert-drop baseline), the FQDN TTL sweep and, with flow
        analytics on, the window roll."""
        self._started = True
        self._ct_gc_schedule(self.config.ct_gc_interval)
        if self.config.map_pressure_interval > 0:
            self.pressure.sample()
            self.controllers.update(
                "map-pressure", self.pressure.sample,
                self.config.map_pressure_interval)
        self.controllers.update(
            "fqdn-gc", self.fqdn.gc, self.config.fqdn_gc_interval)
        if self.auth_manager is not None:
            self.controllers.update(
                "auth-gc", lambda: self.auth_manager.gc(self._now()),
                self.config.auth_gc_interval)
        if self.config.hubble_listen and self.hubble_server is None:
            # grpc is imported here only: a host without it runs every
            # other plane
            from ..flow.grpc_server import serve as hubble_serve

            self.hubble_server = hubble_serve(
                self.observer, self.config.hubble_listen,
                node_name=self.config.node_name)
        if self.config.ct_snapshot_interval > 0:
            # periodic CT snapshots: a recovery path whose live CT is
            # unreadable restores established flows from the last one
            self.controllers.update(
                "ct-snapshot",
                lambda: self.ct_snapshot_now(trigger="interval"),
                self.config.ct_snapshot_interval)
        if self.config.flow_agg_enabled:
            # close aggregation windows on WALL time: a drop burst
            # followed by silence must still reach the spike detector.
            # A controller thread is off the dispatch path, like every
            # other drain() caller
            self.controllers.update(
                "flow-agg-roll", self.analytics.drain,
                self.config.flow_agg_window_s)

    def shutdown(self) -> None:
        self.controllers.stop_all()
        self.stop_serving()  # no-op when idle; drains in-flight work
        if self.hubble_server is not None:
            self.hubble_server.stop(grace=0.5)
            self.hubble_server = None
        if self.exporter:
            self.exporter.close()
        if self.config.state_dir:
            self.checkpoint(self.config.state_dir)
        self.allocator.close()
        if self._fault_injector is not None:
            from ..infra import faults

            faults.disarm(self._fault_injector)
            self._fault_injector = None

    def _now(self) -> int:
        return int(time.time() - self._boot_time) + 1

    # -- policy, endpoint and ipcache API ------------------------------
    def policy_import(self, obj) -> int:
        """Add rules: a rule dict, a list of them, or a
        CiliumNetworkPolicy object (k8s translation)."""
        return self.repo.add_list(rules_from_obj(obj))

    def add_endpoint(self, name: str, ips: Tuple[str, ...],
                     labels: List[str],
                     named_ports: Optional[Dict[str, int]] = None
                     ) -> Endpoint:
        return self.endpoints.add(name, ips, LabelSet.parse(*labels),
                                  named_ports=named_ports)

    def upsert_ipcache(self, cidr: str, numeric_id: int,
                       source: str = "k8s") -> None:
        """Map a prefix to an identity; patches the device LPM in
        place when possible, else falls back to regeneration."""
        self.ipcache.upsert(cidr, numeric_id, source=source)
        if self.endpoints.patch_ipcache(cidr, numeric_id):
            return
        self.endpoints.regenerate()

    def delete_ipcache(self, cidr: str) -> None:
        self.ipcache.delete(cidr)
        if self.loader.delete_ipcache(cidr):
            return
        self.endpoints.regenerate()

    # -- egress gateway (CiliumEgressGatewayPolicy analogue) -----------
    def add_egress_gateway(self, name: str, selector: dict,
                           dest_cidrs, egress_ip: str) -> None:
        """Pods matching ``selector`` (a k8s LabelSelector dict, or a
        list of them) SNAT via ``egress_ip`` toward ``dest_cidrs``
        (single-node scope: the gateway is this node).  Validates
        before storing: a malformed policy raises here and never
        poisons a later recompile."""
        import ipaddress

        from ..policy.api import EndpointSelector

        eip = ipaddress.IPv4Address(egress_ip)  # raises on v6/garbage
        cidrs = []
        for c in dest_cidrs:
            net = ipaddress.ip_network(c, strict=False)
            if net.version != 4:
                raise ValueError(
                    f"egress gateway destinationCIDR {c!r}: the SNAT "
                    "path is v4-only")
            cidrs.append(str(net))
        if not cidrs:
            raise ValueError("egress gateway needs destinationCIDRs")
        selectors = (selector if isinstance(selector, (list, tuple))
                     else (selector,))
        if not selectors:
            raise ValueError("egress gateway needs a selector")
        for sel in selectors:
            EndpointSelector.from_dict(sel)  # raises on bad operators
        self._egress_policies[name] = {
            "selectors": tuple(selectors),
            "dest_cidrs": tuple(cidrs),
            "egress_ip": str(eip),
        }
        self._recompile_nat()

    def remove_egress_gateway(self, name: str) -> bool:
        if self._egress_policies.pop(name, None) is None:
            return False
        self._recompile_nat()
        return True

    def _egress_rules(self):
        """The policies expanded over the CURRENT local endpoints:
        (pod IP, destination CIDR, egress IP) triples."""
        from ..policy.api import EndpointSelector

        rules = []
        for pol in self._egress_policies.values():
            sels = [EndpointSelector.from_dict(s) for s in pol["selectors"]]
            for ep in self.endpoints.list():
                if not any(s.matches(ep.labels) for s in sels):
                    continue
                for ip in ep.ips:
                    if ":" in ip:
                        continue  # v4-only SNAT path
                    for cidr in pol["dest_cidrs"]:
                        rules.append((ip, cidr, pol["egress_ip"]))
        return tuple(rules)

    def _recompile_nat(self) -> None:
        """Rebuild the NAT tensors from the masquerade config and the
        egress policies (endpoint attaches re-expand the selectors);
        skipped when the expanded rule set is unchanged."""
        from ..service.nat import NATConfig

        rules = self._egress_rules()
        if rules == self._egress_rules_cache:
            return
        self._egress_rules_cache = rules
        if self.config.masquerade:
            self.nat = NATConfig(
                node_ip=self.config.node_ip,
                non_masquerade_cidrs=self.config.non_masquerade_cidrs,
                egress_rules=rules,
            ).compile(self.loader.device)
        elif rules:
            # egress gateway without masquerade: the exemption list
            # covers everything, so ONLY policy-matched rows SNAT
            self.nat = NATConfig(
                node_ip=self.config.node_ip or "0.0.0.0",
                non_masquerade_cidrs=("0.0.0.0/0",),
                egress_rules=rules,
            ).compile(self.loader.device)
        else:
            self.nat = None

    # -- bandwidth manager (pkg/bandwidth / EDT analogue) --------------
    def set_bandwidth(self, ep_id: int,
                      bytes_per_sec: Optional[int]) -> None:
        """Set (or clear with None/0) an endpoint's egress rate limit in
        bytes/s (the kubernetes.io/egress-bandwidth annotation)."""
        from ..datapath.bandwidth import BandwidthState, rates_array

        if bytes_per_sec:
            if self._bw_limits.get(int(ep_id)) == int(bytes_per_sec):
                return  # unchanged: skip the tensor rebuild
            self._bw_limits[int(ep_id)] = int(bytes_per_sec)
        elif self._bw_limits.pop(int(ep_id), None) is None:
            return  # nothing was limited: nothing to rebuild
        if self._bw_limits:
            dev = self.loader.device
            self._bw_rates = u32.from_numpy(rates_array(self._bw_limits),
                                            dev)
            if self._bw is None:
                self._bw = BandwidthState.create(dev)
        else:
            self._bw_rates = None
            self._bw = None

    def _bw_police(self, hdr, now: int):
        """-> per-row REASON codes for the datapath's
        ``pre_drop_reason`` (None when no endpoint is limited)."""
        if self._bw_rates is None:
            return None
        from ..datapath.bandwidth import bw_stage

        return bw_stage(self._bw, hdr, now, self._bw_rates)

    # -- the offline path ----------------------------------------------
    def _service_lb(self, hdr, now: int):
        """The service LB stage of ``process_batch`` on device rows:
        connect-time translation with a per-flow cache on v4 rows
        (``socklb_stage``, K17 on the card: established flows ride a
        window probe, only new flows pay the frontend compare and
        Maglev), then the per-packet v6 pass (``lb6_stage``, K16) when
        a service has a v6 frontend.  A service-set change first expires
        the ClientIP affinity pins whose backend is gone (a host sweep,
        only when some service pins affinity).  Returns (rows, [N] bool
        NO_SERVICE mask)."""
        from ..service import lb6_stage
        from ..service.socklb import SockLBTable, socklb_stage

        if self._socklb is None:
            self._socklb = SockLBTable.create(device=self.loader.device)
        svc_ver = self.services.version
        if self._svc_version_seen != svc_ver:
            if self.services.any_affinity:
                self._socklb.prune_affinity(self.services.backend_set())
            self._svc_version_seen = svc_ver
        hdr, _hits, nobe, _tbl = socklb_stage(
            self._socklb, self.services.tensors(), hdr, now)
        t6 = self.services.tensors6()
        if t6 is not None:
            hdr, _hits6, nobe6 = lb6_stage(t6, hdr)
            nobe = nobe | nobe6
        return hdr, nobe

    def process_batch(self, hdr: np.ndarray,
                      now: Optional[int] = None) -> EventBatch:
        # thread-affinity: offline, api, cli
        """One batch of wide header rows through the service LB ->
        egress SNAT -> bandwidth policing -> the datapath step ->
        reverse NAT -> the monitor.  The rows stay on the device across
        the stages; the one fetch feeds the event decode, which needs
        the rewritten rows.  Rows whose frontend selects no backend
        drop NO_SERVICE through the step's ``lb_drop`` channel, ahead
        of policy (upstream's LB lookup runs before the endpoint
        program)."""
        if now is None:
            now = self._now()
        if not (len(self.services) or self.nat is not None
                or self._bw_rates is not None):
            out, row_map = self.loader.step(
                hdr, now, audit=self.config.policy_audit_mode)
            return self._finish_batch(out, hdr, row_map, now)
        hdr_dev = self.loader._to_device(hdr)
        svc_nobe = None
        if len(self.services):
            hdr_dev, svc_nobe = self._service_lb(hdr_dev, now)
        nat_drop = None
        if self.nat is not None:
            # CT-aware: replies to inbound connections keep their
            # source; pool exhaustion marks the row for a
            # REASON_NAT_EXHAUSTED drop in the step
            hdr_dev, nat_drop = self.loader.masquerade(self.nat, hdr_dev,
                                                       now)
        bw_reasons = self._bw_police(hdr_dev, now)
        out, row_map = self.loader.step(hdr_dev, now, pre_drop=nat_drop,
                                        pre_drop_reason=bw_reasons,
                                        lb_drop=svc_nobe,
                                        audit=self.config.policy_audit_mode)
        if self.nat is not None:
            # reverse translation AFTER the verdict: CT and policy see
            # the wire tuple, delivery and events the pod destination
            hdr_dev = self.loader.reverse_nat(self.nat, hdr_dev, now)
        return self._finish_batch(out, u32.to_numpy(hdr_dev), row_map, now)

    def socklb_entries(self, limit: int = 1000) -> list:
        """Decode the socket-LB flow cache (``cilium bpf lb list``):
        live slots with their backend, negative entries with None."""
        from ..service.socklb import socklb_entries_from_snapshot

        tbl = self._socklb
        if tbl is None:
            return []
        return socklb_entries_from_snapshot(u32.to_numpy(tbl.table),
                                            self._now(), limit)

    def _finish_batch(self, out, hdr: np.ndarray, row_map,
                      now: int) -> EventBatch:
        # thread-affinity: offline, api, cli
        """The process_batch tail: decode, auth observe, monitor
        publish, then the flow analytics on the caller's thread."""
        from ..monitor.api import decode_out

        batch = decode_out(out, hdr, row_map.numeric_array(),
                           timestamp=time.time())
        if self.auth_manager is not None:
            self.auth_manager.observe(batch, now)
        self.monitor.publish(self._filter_events(batch))
        # offline path: aggregate inline on the CALLER's thread (the
        # serving path drains on the event-join worker)
        self.analytics.drain()
        return batch

    def status(self) -> dict:
        """The agent's status, cut to the ported planes; the ``nat``
        block appears once the SNAT pool is in use, the ``auth`` block
        with ``mesh_auth``."""
        m = self.loader.metrics()
        out = {
            "endpoints": {"total": len(self.endpoints.list())},
            "identities": len(self.allocator.all_identities()),
            "ipcache-entries": len(self.ipcache.entries()),
            "fqdn-entries": len(self.fqdn.entries()),
            "l7-requests": self.proxy.requests_total,
            "regenerations": self.endpoints.regenerations,
            "forwarded": int(m[0].sum()),
            "dropped": int(m[1:].sum()),
            "monitor-events": self.monitor.published,
            "flows-seen": self.observer.seq,
            "flow-aggregation": self.analytics.stats(),
            "map-pressure": self.pressure.stats(),
        }
        nat = (self.loader.nat_status(self._now())
               if self.nat is not None else None)
        if nat:
            out["nat"] = nat
        if self.auth_manager is not None:
            out["auth"] = self.auth_manager.status()
        return out

    # -- k8s integration ------------------------------------------------
    _k8s_hub = None

    def k8s_watchers(self):
        """The k8s watcher aggregate (pkg/k8s/watchers analogue), built
        on first use; drive it from an informer stream or a fixture
        replay."""
        if self._k8s_hub is None:
            from ..k8s.watchers import K8sWatcherHub

            self._k8s_hub = K8sWatcherHub(self)
        return self._k8s_hub

    # -- CT snapshots (periodic, on demotion, on demand) ---------------
    def ct_snapshot_now(self, trigger: str = "manual") -> dict:
        """Take and retain a CT snapshot (dense portable rows).  The
        retained copy rides the recovery paths: a demotion whose live
        CT is unreadable restores from it instead of dropping every
        established flow."""
        rows = self.loader.ct_snapshot()
        return self._store_ct_snapshot(rows, trigger)

    def _store_ct_snapshot(self, rows: np.ndarray, trigger: str) -> dict:
        s = self._serving
        lad = s.get("ladder") if s is not None else None
        self._ct_snap = {
            "rows": np.array(rows, copy=True),
            "taken-at": time.time(),
            "trigger": trigger,
            "mode": lad.rung if lad is not None else "offline",
            "revision": self.repo.revision,
        }
        return self.ct_snapshot_info()

    def ct_snapshot_info(self) -> Optional[dict]:
        """Metadata of the retained CT snapshot (None before the first
        one): how stale a recovery restore would be."""
        snap = self._ct_snap
        if snap is None:
            return None
        return {
            "age-seconds": round(time.time() - snap["taken-at"], 3),
            "entries": int(len(snap["rows"])),
            "trigger": snap["trigger"],
            "mode": snap["mode"],
            "revision": snap["revision"],
        }

    def restore_ct_snapshot(self) -> bool:
        """Restore the retained snapshot into the live loader; False
        when no snapshot has been taken."""
        if self._ct_snap is None:
            return False
        self.loader.ct_restore(self._ct_snap["rows"])
        return True

    # -- checkpoint / restore -------------------------------------------
    def checkpoint(self, state_dir: str) -> None:
        """Persist the control-plane state and the CT (and NAT)
        snapshot (reference: /var/run/cilium/state + pinned maps)."""
        from ..policy.api import rule_to_dict

        os.makedirs(state_dir, exist_ok=True)
        ids = [{"id": i.numeric_id,
                "labels": [str(l) for l in i.labels]}
               for i in self.allocator.all_identities()]
        meta = {
            "version": VERSION,
            "node": self.config.node_name,
            "revision": self.repo.revision,
            "identities": ids,
            "endpoints": [ep.to_dict() for ep in self.endpoints.list()],
            "ipcache": [
                {"cidr": e.cidr, "identity": e.identity,
                 "source": e.source}
                for e in self.ipcache.entries()
                if e.source not in ("endpoint", "generated")],
            "rules": [rule_to_dict(r) for r in self.repo.rules()],
            # limits and egress policies survive a restart: the restored
            # NAT snapshot's mappings carry their egress IPs
            "bandwidth": {str(k): v for k, v in self._bw_limits.items()},
            "egress-gateways": {
                name: {"selectors": list(p["selectors"]),
                       "dest_cidrs": list(p["dest_cidrs"]),
                       "egress_ip": p["egress_ip"]}
                for name, p in self._egress_policies.items()},
        }
        # ct.npz first, state.json LAST: state.json is the commit point,
        # so a crash between the two renames never pairs new state with
        # a stale CT; the CT carries the policy revision it was taken
        # under, and restore skips a snapshot whose revision differs
        ct = self.loader.ct_snapshot()
        self._store_ct_snapshot(ct, trigger="checkpoint")
        extra = {}
        nat = self.loader.nat_snapshot()
        if nat is not None:
            extra["nat"] = nat  # NAT pairs with CT: one file, atomic
        ct_tmp = os.path.join(state_dir, "ct.npz.tmp")
        with open(ct_tmp, "wb") as f:
            np.savez_compressed(f, table=ct,
                                revision=np.int64(self.repo.revision),
                                **extra)
        os.replace(ct_tmp, os.path.join(state_dir, "ct.npz"))
        tmp = os.path.join(state_dir, "state.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, os.path.join(state_dir, "state.json"))

    def restore(self, state_dir: str) -> bool:
        """Reload a checkpoint (the agent-restart path: datapath state
        survives; endpoints re-register and regenerate).  False when
        the directory holds no checkpoint."""
        path = os.path.join(state_dir, "state.json")
        if not os.path.exists(path):
            return False
        with open(path) as f:
            meta = json.load(f)
        for rec in meta["identities"]:
            self.allocator.restore_identity(
                rec["id"], LabelSet.parse(*rec["labels"]))
        for rec in meta["ipcache"]:
            self.ipcache.upsert(rec["cidr"], rec["identity"],
                                rec["source"])
        if meta["rules"]:
            self.repo.add_obj(meta["rules"])
        for rec in meta["endpoints"]:
            # RESTORING until the batched regeneration below realizes
            # their policy; enforcement mode and options round-trip
            self.endpoints.add(rec["name"], tuple(rec["ips"]),
                               LabelSet.parse(*rec["labels"]),
                               ep_id=rec["id"],
                               named_ports=rec.get("named-ports"),
                               restoring=True, defer_regen=True,
                               enforcement=rec.get("policy-enforcement",
                                                   "default"),
                               options=rec.get("options"))
        self.endpoints.regenerate()
        for ep_id, bps in (meta.get("bandwidth") or {}).items():
            self.set_bandwidth(int(ep_id), int(bps))
        for name, p in (meta.get("egress-gateways") or {}).items():
            self.add_egress_gateway(name, p["selectors"],
                                    p["dest_cidrs"], p["egress_ip"])
        ct_path = os.path.join(state_dir, "ct.npz")
        if os.path.exists(ct_path):
            try:
                snap = np.load(ct_path)
                snap_rev = (int(snap["revision"])
                            if "revision" in snap.files else None)
                if snap_rev is not None and snap_rev != meta["revision"]:
                    # the torn-checkpoint case: never resurrect flows
                    # admitted under policy absent from the restored set
                    logging.getLogger(__name__).warning(
                        "CT snapshot revision %s != checkpoint revision "
                        "%s (torn checkpoint); skipping connection "
                        "state", snap_rev, meta["revision"])
                else:
                    self.loader.ct_restore(snap["table"])
                    if "nat" in snap.files:
                        self.loader.nat_restore(snap["nat"])
            except Exception as e:  # noqa: BLE001 — a corrupt snapshot
                # costs the live connections, not the restored planes
                logging.getLogger(__name__).warning(
                    "CT snapshot restore failed (%s); continuing "
                    "without connection state", e)
        return True

    def _rows_of_identity(self, numerics: np.ndarray) -> np.ndarray:
        # thread-affinity: any
        """Numeric identities -> the live row map's rows (0: unknown)."""
        row_map = self.loader.row_map
        if row_map is None:
            return np.zeros(len(numerics), dtype=np.int64)
        return row_map.rows_of(numerics)

    # -- getters for flow enrichment -----------------------------------
    def _identity_labels(self, numeric: int) -> Tuple[str, ...]:
        # thread-affinity: any
        ident = self.allocator.lookup_by_id(numeric)
        return tuple(str(l) for l in ident.labels) if ident else ()

    def _endpoint_info(self, ep_id: int) -> Tuple[str, int]:
        # thread-affinity: any
        ep = self.endpoints.get(ep_id)
        return (ep.name, ep.id) if ep else ("", ep_id)

    def _endpoint_identity(self, ep_id: int) -> int:
        # thread-affinity: any
        """ep id -> LOCAL numeric identity (the analytics plane's
        src/dst attribution for the local side of a flow)."""
        ep = self.endpoints.get(ep_id)
        if ep is not None and ep.identity is not None:
            return int(ep.identity.numeric_id)
        return 0

    def flows_aggregate(self, top: int = 16) -> dict:
        """The analytics snapshot (``GET /flows/aggregate``): drains
        pending batches on THIS thread, which is off the dispatch path
        by definition."""
        return self.analytics.snapshot(top=top)

    def add_relay_peer(self, name: str, observer) -> None:
        """Register a peer agent's Observer (or anything with its
        ``get_flows`` protocol, such as a gRPC ``ObserverClient``) for
        relay-merged flow views: ``self.relay`` merges this node's
        observer with every peer, time-ordered and node-stamped."""
        from ..flow.relay import Relay

        if self.relay is None:
            self.relay = Relay({self.config.node_name: self.observer})
        self.relay.add_peer(name, observer)

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
                      shard_headroom: int = 2,
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
        reference.  ``span_sample`` raises NotImplementedError (ROADMAP
        A14).

        ``mesh`` (an int S or a :class:`~..parallel.ShardMesh`) serves
        sharded on the one card: each bucket is flow-routed into S
        blocks of ``shard_headroom * bucket / S`` rows, each shard owns a
        CT slice and a private ring, and the sharded kernels serve all S
        in one launch sequence.  The batcher never packs under a mesh
        (routing needs wide rows; routed batches re-pack); the ladder
        pins K = 1 on the sharded rung, and demotion carries the CT to
        the single-shard rungs."""
        from ..monitor.ring import AsyncRingDrainer, ShardedAsyncRingDrainer
        from ..serving import (BucketArena, ServingAlreadyActiveError,
                               validate_superbatch_config)
        from ..serving.eventplane import EventJoinWorker
        from ..serving.ladder import (FallbackLadder, RUNG_SHARDED,
                                      RUNG_SINGLE, RUNG_WIDE)

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
        n_shards = 0
        if mesh is not None:
            from ..parallel import make_mesh, make_sharded_ring

            if isinstance(mesh, int):
                mesh = make_mesh(mesh, dev)
            n_shards = int(mesh.n_shards)
            ladder = cfg.serving_bucket_ladder
            if ladder[0] % n_shards:
                raise ValueError(
                    f"sharded serving needs every ladder bucket "
                    f"divisible by the {n_shards}-shard mesh; smallest "
                    f"bucket is {ladder[0]}")
            if shard_headroom < 1:
                raise ValueError("shard_headroom must be >= 1")
            self.loader.serving_shard(mesh)
            drainer = ShardedAsyncRingDrainer(
                ring_capacity, n_shards,
                fresh_fn=lambda: make_sharded_ring(mesh, ring_capacity),
                proxy_ports=table, gather=event_gather, device=dev)
        else:
            drainer = AsyncRingDrainer(ring_capacity, proxy_ports=table,
                                       gather=event_gather, device=dev)
        rungs = (([RUNG_SHARDED] if mesh is not None else [])
                 + ([RUNG_SINGLE] if packed else []) + [RUNG_WIDE])
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
            "mesh": mesh,
            "mesh_pref": mesh,  # survives sharded demotion
            "n_shards": n_shards,
            "headroom": int(shard_headroom),
            "route_overflow": 0,
            # the sharded leg's routed (and re-packed) batches and their
            # valid masks: the batcher arena's recycling horizon, in
            # pinned memory on the card; the orig indices stay on the
            # host
            "route_arena": BucketArena(arena_depth,
                                       pin=dev.type == "cuda"),
            "route_orig": BucketArena(arena_depth),
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
                # sharded dispatch flow-routes WIDE rows and re-packs
                # after routing: the batcher packs only for the
                # single-shard device leg
                pack=bool(packed) and mesh is None,
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
        """One rung down: shrink K first.  sharded -> single: drain the
        per-shard rings, snapshot the CT, leave the mesh and restore the
        snapshot into the single-shard placement, so established flows
        survive.  single -> wide stops packing (the batcher and the
        per-batch path)."""
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
        if old == "sharded" and new != old:
            self._serving_leave_mesh(s)
        s["packed"] = (new == "single") and s["packed_pref"]
        runtime = s.get("runtime")
        if runtime is not None:
            # single-shard rungs pack in the batcher; wide never does
            runtime.batcher.pack = s["packed"] and s["mesh"] is None
            runtime.superbatch_k = lad.k
            # the demoted shape's first dispatch is not a hang
            runtime.reset_warm_shapes()

    def _serving_leave_mesh(self, s) -> None:
        # thread-affinity: drain, api
        """The sharded demotion's CT carry: flush what the per-shard
        rings hold onto the event plane (best effort: the ledger counts
        what a wedged swap abandons), snapshot the CT (falling back to
        the last periodic snapshot when the live one is unreadable),
        leave the mesh, restore, and swap to a single ring."""
        from ..monitor.ring import AsyncRingDrainer

        try:
            self._serving_drain_tick(s)
        except Exception:  # noqa: BLE001
            # hot-path-ok: demotion failure path only
            logging.getLogger(__name__).warning(
                "sharded ring drain failed during demotion; in-flight "
                "window events lost (counted)")
        ct, fresh = None, False
        try:
            ct = self.loader.ct_snapshot()
            fresh = True
        except Exception:  # noqa: BLE001
            if self._ct_snap is not None:
                ct = self._ct_snap["rows"]
                # hot-path-ok: demotion failure path only
                logging.getLogger(__name__).warning(
                    "live CT unreadable during demotion; restoring the "
                    "%.1fs-old periodic snapshot",
                    time.time() - self._ct_snap["taken-at"])
        self.loader.serving_unshard()
        if ct is not None:
            if fresh:
                # a stale fallback keeps its own taken-at
                self._store_ct_snapshot(ct, trigger="demotion")
            self.loader.ct_restore(ct)
        s["mesh"] = None
        s["n_shards"] = 0
        d = AsyncRingDrainer(s["ring_capacity"],
                             proxy_ports=s["proxy_table"],
                             gather=s["gather"], device=self.loader.device)
        s["drainer"] = d
        s["ring"] = d.fresh()
        s["window"].clear()

    def _serving_promote(self) -> None:
        # thread-affinity: drain, api
        """One rung back up after sustained health and the cooldown:
        grow K; wide -> single re-enables packing; single -> sharded
        re-enters the mesh with per-shard rings.  Re-sharding keeps CT
        rows where they are: a flow whose entry lies outside its shard's
        slice re-establishes as NEW on its next packet (never dropped);
        demotion is the direction that must be lossless, and is."""
        from ..monitor.ring import ShardedAsyncRingDrainer
        from ..parallel import make_sharded_ring

        s = self._serving
        lad = s["ladder"]
        old, old_k = lad.rung, lad.k
        new = lad.promote()
        # hot-path-ok: promotions happen at most once per cooldown
        logging.getLogger(__name__).info(
            "serving ladder promotes %s@k%d -> %s@k%d", old, old_k, new,
            lad.k)
        if new == "sharded" and new != old:
            mesh = s["mesh_pref"]
            try:
                self._serving_drain_tick(s)
            except Exception:  # noqa: BLE001
                # hot-path-ok: promotion failure path only
                logging.getLogger(__name__).warning(
                    "ring drain failed during promotion; in-flight "
                    "window events lost (counted)")
            self.loader.serving_shard(mesh)
            s["mesh"] = mesh
            s["n_shards"] = int(mesh.n_shards)
            cap = s["ring_capacity"]
            s["drainer"] = ShardedAsyncRingDrainer(
                cap, s["n_shards"],
                fresh_fn=lambda: make_sharded_ring(mesh, cap),
                proxy_ports=s["proxy_table"], gather=s["gather"],
                device=self.loader.device)
            s["ring"] = s["drainer"].fresh()
            s["window"].clear()
            s["packed"] = False
        elif new != old:
            s["packed"] = s["packed_pref"]
        runtime = s.get("runtime")
        if runtime is not None:
            runtime.batcher.pack = s["packed"] and s["mesh"] is None
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
        the ladder, the map-pressure and table-generation blocks."""
        s = self._serving
        if s is None:
            return {"active": False}
        d = s["drainer"]
        out = {"active": True,
               "ring": {"windows": d.windows, "events": d.events,
                        "lost": d.lost},
               "event-plane": s["eventplane"].stats(),
               "analytics": self.analytics.stats(),
               "pressure": self.pressure.stats(),
               "mode": s["ladder"].rung,
               "ladder": s["ladder"].to_dict(),
               # the live-churn plane (datapath/tables.py): published
               # generation, swap/update latency, attach/patch counts
               "tables": self.loader.table_stats()}
        if s["n_shards"]:
            out["shards"] = s["n_shards"]
            out["route-overflow"] = s["route_overflow"]
        runtime = s.get("runtime")
        if runtime is not None:
            out.update(runtime.snapshot())
        snap = self.ct_snapshot_info()
        if snap is not None:
            out["ct-snapshot"] = snap
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
        if s["mesh"] is not None:
            if packed_meta is not None:
                raise ValueError(
                    "sharded serving routes wide rows (packing happens "
                    "after flow routing); submit wide batches")
            info = self._serve_batch_sharded(s, hdr, now, bid, valid)
        elif packed_meta is not None:
            ep, dirn = packed_meta
            s["ring"], row_map = self.loader.serve_packed(
                s["ring"], hdr, now, bid, ep, dirn,
                trace_sample=s["trace_sample"],
                proxy_ports=s["table_dev"],
                audit=self.config.policy_audit_mode, valid=valid)
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
                proxy_ports=s["table_dev"],
                audit=self.config.policy_audit_mode, valid=valid)
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
        if s["mesh"] is not None:
            # the ladder pins K = 1 on the sharded rung, so the drain
            # loop never gets here; this guards direct callers
            raise ValueError(
                "superbatch dispatch is a single-shard shape; sharded "
                "serving flow-routes per batch (the ladder pins K=1 on "
                "the sharded rung)")
        if now is None:
            now = self._now()
        if s["seq"] - s["last_tick"] >= s["drain_every"]:
            self._serving_drain_tick(s)
        bid0 = s["seq"] & 0x1FFF
        s["ring"], row_map = self.loader.serve_superbatch(
            s["ring"], sb.hdr, now, bid0, eps=sb.eps, dirns=sb.dirns,
            trace_sample=s["trace_sample"], proxy_ports=s["table_dev"],
            audit=self.config.policy_audit_mode, valid=sb.valid,
            packed=sb.packed)
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

    def _serve_batch_sharded(self, s, hdr: np.ndarray, now: int,
                             bid: int, valid) -> dict:
        # thread-affinity: drain, api
        """The sharded leg: flow-route the bucket into per-shard blocks
        (the RSS analogue), account router overflow as
        REASON_ROUTE_OVERFLOW (metricsmap + synthesized DROP events),
        re-pack eligible routed batches to 16 B/packet, and dispatch
        the sharded serve step (a CT slice and a ring per shard)."""
        from ..core.packets import (N_COLS, PACKED_COLS,
                                    pack_eligibility, pack_rows)
        from ..datapath.verdict import REASON_ROUTE_OVERFLOW
        from ..monitor.api import synth_drop_batch
        from ..parallel import route_by_flow

        S = s["n_shards"]
        hdr = np.asarray(hdr)
        if valid is None:
            rows = hdr
        else:
            n_valid = int(valid.sum())
            # the batcher's buckets are prefix-valid (a view); a direct
            # caller's holes are honored (a copy)
            rows = (hdr[:n_valid] if valid[:n_valid].all()
                    else hdr[valid])
        bucket = max(len(hdr), S)
        # ONE routed shape per ladder rung: block is fixed at
        # headroom * bucket / S; the headroom absorbs flow skew
        block = s["headroom"] * bucket // S
        arena = s["route_arena"]
        out = (arena.slot(S * block, N_COLS),
               arena.slot(S * block, 0, dtype=bool),
               s["route_orig"].slot(S * block, 0, dtype=np.int64))
        routed, rvalid, orig, n_ovf = route_by_flow(rows, S, block,
                                                    out=out)
        if n_ovf:
            # a shard's block overflowed (flow skew): counted in the
            # metricsmap AND surfaced as DROP events, like admission
            # sheds
            s["route_overflow"] += n_ovf
            self.loader.add_route_overflow(n_ovf)
            dropped = np.ones(len(rows), dtype=bool)
            dropped[orig[orig >= 0]] = False
            batch = synth_drop_batch(rows[dropped], REASON_ROUTE_OVERFLOW,
                                     time.time())
            self.monitor.publish(self._filter_events(batch))
        ship, meta, kind = routed, None, "wide"
        if s["packed"]:
            ok, ep, dirn = pack_eligibility(rows)
            if ok:
                ship = pack_rows(routed, out=arena.slot(len(routed),
                                                        PACKED_COLS))
                meta, kind = (ep, dirn), "packed"
        s["ring"], row_map = self.loader.serve_sharded(
            s["ring"], ship, now, bid, trace_sample=s["trace_sample"],
            proxy_ports=s["table_dev"],
            audit=self.config.policy_audit_mode, valid=rvalid,
            packed_meta=meta)
        self._serving_snapshot_numerics(s, row_map)
        s["window"][bid] = (kind, ship, meta, s["numerics"], time.time())
        return {"h2d_bytes": ship.nbytes, "mode": f"sharded-{kind}",
                "batch_id": bid}

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
        publish to the monitor, then aggregate the flow analytics."""
        self._event_check_horizon(dw, self._serving)
        rows, shards, _appended, _lost = dw.ring.fetch()
        try:
            # the fetch can stall: re-check the recycling horizon
            # before publishing anything
            self._event_check_horizon(dw, self._serving)
            self._emit_ring_rows(rows, shards, dw.records,
                                 dw.ring.n_shards)
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
        # the flow analytics drain HERE, on the event-join worker, never
        # the drain thread, and only when no window waits behind this
        # one: the windows come first (the reference drains after every
        # window, and one 2^16-event ingest overflowed the window
        # queue).  What stays pending drains at the next idle join, on
        # the flow-agg-roll controller or in stop_serving.  Contained:
        # the window's events were already delivered, so an analytics
        # fault must not recount the window as a drop
        s = self._serving
        if s is not None and s["eventplane"].pending > 1:
            return
        try:
            self.analytics.drain()
        except Exception:  # noqa: BLE001
            logging.getLogger(__name__).warning(
                "flow-analytics drain failed at window join",
                exc_info=True)

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
        # the worker is drained: aggregate whatever it published (the
        # caller's thread; the drain loop has stopped)
        self.analytics.drain()
        # the L7 plane stops AFTER the event plane: the join worker was
        # still fanning redirect rows into the pool until its drain
        # completed.  Drain the pool and keep its final stats
        l7 = None
        if self._l7plane is not None:
            l7 = self._l7plane.stop(drain=True)
            self._l7_last = l7
            self._l7plane = None
        if s["mesh"] is not None:
            # the single-shard steps serve step() / process_batch again
            self.loader.serving_unshard()
        self._serving = None
        out = {"windows": d.windows, "events": d.events,
               "lost": d.lost, "event-plane": ev}
        if s["n_shards"]:
            out["shards"] = s["n_shards"]
            out["route-overflow"] = s["route_overflow"]
        lad = s["ladder"]
        if lad.demotions or lad.promotions:
            out["ladder"] = lad.to_dict()
        if front is not None:
            out["front-end"] = front
        if l7 is not None:
            out["l7"] = l7
        return out

    def _emit_ring_rows(self, rows: np.ndarray,
                        shards: Optional[np.ndarray], records: dict,
                        n_shards: int) -> None:
        # thread-affinity: event-worker
        """Join decoded ring rows back to their retained batch records
        and publish (``records`` is the window's swap-time snapshot,
        so this never touches ``self._serving``).  A sharded window's
        rows carry shard-local packet indices: the retained record is
        the ROUTED batch, shard s owning rows [s*block, (s+1)*block)."""
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
            m = rows[:, COL_BATCH] == b
            rows_b = rows[m]
            pkt = rows_b[:, COL_PKT_IDX].astype(np.int64)
            if shards is not None:
                pkt = shards[m] * (len(hdr) // n_shards) + pkt
            sel = hdr[pkt]
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
            if self.auth_manager is not None:
                # the drained window's clock is gone; the serving loop
                # stamps its batches with _now(), so grants land on the
                # clock the datapath compares them with
                self.auth_manager.observe(batch, self._now())
            self.monitor.publish(self._filter_events(batch))

    def _filter_events(self, batch: EventBatch) -> EventBatch:
        # thread-affinity: any
        """Per-endpoint event options (DropNotification,
        TraceNotification, Debug) and monitor trace aggregation: what
        the MONITOR plane sees; the caller's EventBatch (and metrics)
        keep every row.  Under ``"medium"`` a TCP trace with none of
        SYN, FIN and RST is boring and dropped, except on an endpoint
        whose Debug option is on."""
        from ..core.packets import (COL_EP, COL_FLAGS, COL_PROTO, TCP_FIN,
                                    TCP_RST, TCP_SYN)
        from ..monitor.api import MSG_DROP, MSG_TRACE

        opts = self.endpoints.event_options()
        aggregate = self.config.monitor_aggregation == "medium"
        if not opts and not aggregate:
            return batch
        keep = np.ones(len(batch), dtype=bool)
        ep_col = batch.hdr[:, COL_EP]
        if aggregate:
            proto = batch.hdr[:, COL_PROTO]
            flags = batch.hdr[:, COL_FLAGS]
            boring = ((proto == 6)
                      & ((flags & (TCP_SYN | TCP_FIN | TCP_RST)) == 0)
                      & (batch.msg_type == MSG_TRACE))
            for ep_id, o in opts.items():
                if o.get("Debug"):
                    boring &= ep_col != ep_id
            keep &= ~boring
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

    @staticmethod
    def _cast_aggregation(raw) -> str:
        """The monitor_aggregation knob's value check (the reference's
        cast of its runtime ``monitor-aggregation`` option)."""
        v = str(raw)
        if v not in ("none", "medium"):
            raise ValueError(f"monitor-aggregation must be none|medium,"
                             f" got {v!r}")
        return v
