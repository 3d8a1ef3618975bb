"""Seeded adversarial workloads: named scenarios and the one runner.

A copy of the JAX package's ``testing/workloads.py``: the
:class:`Scenario` contract, seven of its eight scenarios,
:func:`make_scenario`, :func:`scenario_daemon`, :func:`evaluate_criteria`
and both legs of :func:`run_scenario` (the serving front end and the
offline ``process_batch`` pipeline).  Host-only: a scenario is a
deterministic generator of traffic batches and control-plane ops,
applied to a ``Daemon`` through its own API, so the tests and
``chip_smoke.py`` replay the same schedule for the same seed.

Scenarios:

- ``identity_churn`` — mint/withdraw label-selected peer identities,
  Zipf-weighted;
- ``syn_flood`` — a new-flow storm of unique-tuple SYNs sized past the
  CT map, driving insert-drop pressure;
- ``port_scan`` — one source sweeping the port space with tiny SYNs,
  feeding the drop-spike detector, the flow aggregates and the anomaly
  models;
- ``l7_abuse`` — the port scan's shape against a victim whose open port
  carries an HTTP redirect rule, so the L7 plane's ledger must close
  under a default-deny storm;
- ``nat_exhaustion`` — an egress ramp of unique flows that drains the
  SNAT port pool (the offline path: masquerade rides there);
- ``elephant_mice`` — Zipf flow popularity over a fixed flow pool,
  stressing the analytics plane's space-saving top-K sketches;
- ``endpoint_churn`` — endpoints connecting/disconnecting (full
  add_endpoint/remove regeneration) under live traffic.

The reference's eighth, ``rotation_storm``, rotates the key epochs of
the process-mode cluster's encrypted channels, which the port does not
have yet (ROADMAP A21): :func:`make_scenario` raises NotImplementedError
for it.
"""

from __future__ import annotations

import hashlib
import itertools
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.packets import (
    COL_DIR,
    COL_DPORT,
    COL_DST_IP3,
    COL_EP,
    COL_FAMILY,
    COL_FLAGS,
    COL_LEN,
    COL_PROTO,
    COL_SPORT,
    COL_SRC_IP3,
    N_COLS,
    TCP_ACK,
    TCP_SYN,
)


def _ip(s: str) -> int:
    import ipaddress

    return int(ipaddress.IPv4Address(s))


def _rows(n: int) -> np.ndarray:
    out = np.zeros((n, N_COLS), dtype=np.uint32)
    out[:, COL_FAMILY] = 4
    out[:, COL_PROTO] = 6
    return out


def _zipf_weights(n: int, a: float) -> np.ndarray:
    """Rank -> probability ~ 1/rank^a (normalized); rank 0 is the
    elephant.  ONE definition for every Zipf-weighted scenario."""
    w = 1.0 / np.power(np.arange(1, n + 1), a)
    return w / w.sum()


class Scenario:
    """The scenario contract: a docstring saying what hostile shape it
    reproduces, a ``name``, declared pass ``criteria`` and a ``seed``
    (same name and seed, byte-identical streams: :meth:`signature`).

    A scenario owns two deterministic streams — ``iter_batches(ep)``
    (wide ``[N, N_COLS]`` uint32 header tensors) and ``ops(n)``
    (control-plane events applied via :meth:`apply`) — plus
    ``setup(target)``, which registers whatever endpoints/policy the
    streams assume (``target`` exposes ``add_endpoint`` /
    ``policy_import``, as a ``Daemon`` does).  ``path`` names the
    serving leg it runs on (``serving``: admission queue -> drain
    loop), and
    ``daemon_overrides`` the DaemonConfig knobs its pressure shape
    needs.
    """

    name: str = ""
    criteria: Dict[str, object] = {}
    path: str = "serving"
    daemon_overrides: Dict[str, object] = {}
    interval_s: float = 0.0  # op spacing; 0 = no op stream

    def setup(self, target) -> dict:
        """Register the scenario's world; returns the run's context
        (at least ``{"ep": <endpoint id>}`` for traffic scenarios)."""
        return {"ep": 0}

    def iter_batches(self, ep: int) -> Iterator[np.ndarray]:
        return iter(())

    def ops(self, n: Optional[int] = None) -> List:
        return []

    def apply(self, daemon, op, live: Dict) -> None:
        raise NotImplementedError

    def drain(self, daemon, live: Dict) -> None:
        """Unwind every surviving op (teardown; default no-op)."""

    # -- the determinism contract --------------------------------------
    def signature(self, ep: int = 7, n_batches: int = 3,
                  n_ops: int = 64) -> str:
        """Digest of the scenario's first ``n_batches`` batches and
        ``n_ops`` ops — two fresh instances with the same constructor
        args must agree byte for byte (the contract test's surface)."""
        h = hashlib.sha256()
        for b in itertools.islice(self.iter_batches(ep), n_batches):
            h.update(np.ascontiguousarray(b).tobytes())
        for op in self.ops(n_ops):
            h.update(repr(op).encode())
        return h.hexdigest()


@dataclass(frozen=True)
class ChurnOp:
    """One scenario event: mint or withdraw slot ``slot``'s identity.

    ``cidr`` is the slot's /32.  Minting allocates an identity for
    the slot's labels (see :meth:`IdentityChurnScenario.slot_labels`
    — rules select them via the ``k8s:churn=yes`` convention) and
    upserts the /32; withdrawing deletes the ipcache entry and
    releases the identity.  ``t_s`` is the op's offset from the
    scenario start at the configured rate."""

    kind: str  # "mint" | "withdraw"
    slot: int
    cidr: str
    t_s: float


class IdentityChurnScenario(Scenario):
    """Mint/withdraw CIDR identities at ``rate_hz``, Zipf-weighted
    over ``n_slots`` peer slots.

    Each slot alternates mint -> withdraw -> mint ... (an op on a
    live slot withdraws it, on a dead slot mints it), so the op
    stream is valid by construction and the live set follows the
    Zipf weights.  Deterministic per (seed, n_slots, zipf_a,
    rate_hz): the churn tests and ``chip_smoke.py`` replay the same
    schedule.
    """

    name = "identity_churn"
    criteria = {"ledger_exact": True, "max_shed_frac": 0.95}
    path = "serving"
    daemon_overrides = {"serving_bucket_ladder": (64,),
                        "serving_max_wait_us": 500.0}

    def __init__(self, seed: int = 0, n_slots: int = 16,
                 zipf_a: float = 1.3, rate_hz: float = 200.0,
                 subnet: Tuple[int, int] = (10, 9),
                 n_batches: int = 48):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if zipf_a <= 1.0:
            raise ValueError("zipf_a must be > 1 (Zipf exponent)")
        if rate_hz <= 0:
            raise ValueError("rate_hz must be > 0")
        self.seed = int(seed)
        self.n_batches = int(n_batches)
        self.n_slots = int(n_slots)
        self.zipf_a = float(zipf_a)
        self.rate_hz = float(rate_hz)
        self.interval_s = 1.0 / self.rate_hz
        if self.n_slots > 65534:
            raise ValueError("n_slots must fit the /16 slot space")
        a, b = subnet
        # host s+1 within the /16 (skips .0.0; (s+1) & 0xFF may be 0
        # — x.y.z.0/32 is a valid host route)
        self._cidrs = [f"{a}.{b}.{(s + 1) >> 8}.{(s + 1) & 0xFF}/32"
                       for s in range(self.n_slots)]
        # slot 0 is the elephant peer
        self._weights = _zipf_weights(self.n_slots, self.zipf_a)

    def slot_cidr(self, slot: int) -> str:
        return self._cidrs[slot]

    def slot_ip(self, slot: int) -> str:
        return self._cidrs[slot].rsplit("/", 1)[0]

    def slot_labels(self, slot: int) -> List[str]:
        """The slot identity's labels.  ``k8s:churn=yes`` is the
        selection convention: a rule with ``fromEndpoints``
        ``matchLabels {"churn": "yes"}`` admits exactly the LIVE
        slots (a dead slot's /32 resolves to identity 0 and
        default-denies) — deliberately NOT a ``fromCIDR`` rule,
        whose covering-prefix identity would admit the whole subnet
        regardless of slot liveness."""
        return [f"k8s:app=churn{slot}", "k8s:churn=yes",
                "k8s:ns=default"]

    def setup(self, target) -> dict:
        target.add_endpoint("churn-web", ("10.9.255.1",),
                            ["k8s:app=churn-web"])
        ep = target.add_endpoint("churn-db", ("10.9.255.2",),
                                 ["k8s:app=churn-db"])
        target.policy_import([{
            "endpointSelector": {"matchLabels": {"app": "churn-db"}},
            "ingress": [
                {"fromEndpoints": [
                    {"matchLabels": {"app": "churn-web"}}],
                 "toPorts": [{"ports": [{"port": "5432",
                                         "protocol": "TCP"}]}]},
                {"fromEndpoints": [{"matchLabels": {"churn": "yes"}}],
                 "toPorts": [{"ports": [{"port": "5432",
                                         "protocol": "TCP"}]}]},
            ],
        }])
        return {"ep": ep.id}

    def iter_batches(self, ep: int) -> Iterator[np.ndarray]:
        """A light stable-allowed stream (churn-web -> :5432) so the
        serving plane has traffic while the op stream churns —
        ``n_batches`` of 64 rows."""
        rng = np.random.default_rng(self.seed + 1)
        for _ in range(self.n_batches):
            out = _rows(64)
            out[:, COL_SRC_IP3] = _ip("10.9.255.1")
            out[:, COL_DST_IP3] = _ip("10.9.255.2")
            out[:, COL_SPORT] = rng.integers(1024, 60000, 64)
            out[:, COL_DPORT] = 5432
            out[:, COL_FLAGS] = TCP_ACK
            out[:, COL_LEN] = 512
            out[:, COL_EP] = ep
            yield out

    def ops(self, n: Optional[int] = None) -> List[ChurnOp]:
        """The first ``n`` ops of the schedule (deterministic)."""
        return list(self.iter_ops(n if n is not None else 256))

    def iter_ops(self, n: Optional[int] = None) -> Iterator[ChurnOp]:
        rng = np.random.default_rng(self.seed)
        live = [False] * self.n_slots
        i = 0
        while n is None or i < n:
            slot = int(rng.choice(self.n_slots, p=self._weights))
            kind = "withdraw" if live[slot] else "mint"
            live[slot] = not live[slot]
            yield ChurnOp(kind=kind, slot=slot,
                          cidr=self._cidrs[slot],
                          t_s=i * self.interval_s)
            i += 1

    # -- applying ops to a daemon -----------------------------------------
    def apply(self, daemon, op: ChurnOp, live: Dict[int, object]
              ) -> None:
        """Apply one op against a live daemon.  ``live`` is the
        caller's slot -> Identity map (the scenario owns the
        schedule, the caller owns the handles).

        Mint allocates the slot's labeled identity — the allocator
        observer chain applies it to the selecting contributions and
        patches its verdict row in place (``patch_identity``) — then
        upserts the slot's /32 (``patch_ipcache``).  Withdraw
        deletes the ipcache entry FIRST (no LPM entry may reference
        the row when it recycles), then releases the identity."""
        from ..labels import LabelSet

        if op.kind == "mint":
            ident = daemon.allocator.allocate(
                LabelSet.parse(*self.slot_labels(op.slot)))
            daemon.upsert_ipcache(op.cidr, ident.numeric_id,
                                  source="generated")
            live[op.slot] = ident
        else:
            ident = live.pop(op.slot, None)
            if ident is not None:
                daemon.delete_ipcache(op.cidr)
                daemon.allocator.release(ident)

    def drain(self, daemon, live: Dict[int, object]) -> None:
        """Withdraw every surviving slot (teardown), so op semantics
        (field order, withdraw steps) live only here."""
        for slot in list(live):
            self.apply(daemon, ChurnOp("withdraw", slot,
                                       self.slot_cidr(slot), 0.0),
                       live)


class SynFloodScenario(Scenario):
    """A new-flow SYN storm: ``n_flows`` unique (src, sport) tuples,
    each one SYN at the victim's allowed port — every packet is a CT
    insert, so a storm sized past the CT map fills it and drives
    insert-drop pressure (``CTTable.dropped``, the ctmap map-pressure
    analogue) plus the fingerprint-overflow full-window-probe rerun
    at high occupancy.  The flood is ALLOWED traffic by design
    (``fromEntities: [world]`` to the flood port): only the allow
    path creates CT entries, and surviving a flood of wanted-looking
    connections is exactly the ctmap GC story."""

    name = "syn_flood"
    criteria = {"ledger_exact": True, "max_shed_frac": 0.95,
                "min_ct_insert_drops": 1, "p99_ms": 120000.0}
    path = "serving"
    # the storm must outsize the CT map: 4096 unique flows against a
    # 1k-entry table (bench + tests build the daemon from these)
    daemon_overrides = {"ct_capacity": 1 << 10,
                        "serving_bucket_ladder": (512,),
                        "serving_queue_depth": 1 << 14}

    def __init__(self, seed: int = 0, n_flows: int = 4096,
                 batch: int = 512, dport: int = 80):
        if n_flows < 1 or batch < 1:
            raise ValueError("n_flows and batch must be >= 1")
        self.seed = int(seed)
        self.n_flows = int(n_flows)
        self.batch = int(batch)
        self.dport = int(dport)

    def setup(self, target) -> dict:
        ep = target.add_endpoint("sf-victim", ("10.0.40.1",),
                                 ["k8s:app=sf-victim"])
        target.policy_import([{
            "endpointSelector": {"matchLabels":
                                 {"app": "sf-victim"}},
            "ingress": [{"fromEntities": ["world"],
                         "toPorts": [{"ports": [
                             {"port": str(self.dport),
                              "protocol": "TCP"}]}]}],
        }])
        return {"ep": ep.id}

    def iter_batches(self, ep: int) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed)
        base = _ip("172.16.0.1")
        dst = _ip("10.0.40.1")
        flow = 0
        while flow < self.n_flows:
            n = min(self.batch, self.n_flows - flow)
            i = np.arange(flow, flow + n, dtype=np.uint32)
            out = _rows(n)
            # unique tuple per flow: 1024 sources x rotating sports
            out[:, COL_SRC_IP3] = base + (i % 1024)
            out[:, COL_SPORT] = 1024 + (i // 1024) * 1024 \
                + rng.integers(0, 1024, n).astype(np.uint32)
            out[:, COL_DST_IP3] = dst
            out[:, COL_DPORT] = self.dport
            out[:, COL_FLAGS] = TCP_SYN
            out[:, COL_LEN] = rng.integers(40, 60, n)
            out[:, COL_EP] = ep
            yield out
            flow += n


class PortScanScenario(Scenario):
    """One source sweeping the destination port space with tiny SYNs
    (the classic recon shape): all but the victim's one allowed port
    default-deny, so the stream feeds the drop-spike detector, the
    per-identity-pair aggregates, and the anomaly models a clean
    synthetic attack (the r05 evaluation's ``portscan`` kind,
    replayed through the REAL serving/offline pipeline)."""

    name = "port_scan"
    criteria = {"ledger_exact": True, "max_shed_frac": 0.95,
                "min_drop_frac": 0.5}
    path = "serving"
    daemon_overrides = {"serving_bucket_ladder": (512,),
                        "serving_queue_depth": 1 << 14,
                        "spike_min_drops": 64}

    def __init__(self, seed: int = 0, n_packets: int = 4096,
                 batch: int = 512, open_port: int = 5432):
        if n_packets < 1 or batch < 1:
            raise ValueError("n_packets and batch must be >= 1")
        self.seed = int(seed)
        self.n_packets = int(n_packets)
        self.batch = int(batch)
        self.open_port = int(open_port)

    def setup(self, target) -> dict:
        ep = target.add_endpoint("ps-victim", ("10.0.41.1",),
                                 ["k8s:app=ps-victim"])
        target.policy_import([{
            "endpointSelector": {"matchLabels":
                                 {"app": "ps-victim"}},
            "ingress": [{"fromEntities": ["world"],
                         "toPorts": [{"ports": [
                             {"port": str(self.open_port),
                              "protocol": "TCP"}]}]}],
        }])
        return {"ep": ep.id}

    def iter_batches(self, ep: int) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed)
        src = _ip("172.20.0.7")
        dst = _ip("10.0.41.1")
        sent = 0
        while sent < self.n_packets:
            n = min(self.batch, self.n_packets - sent)
            out = _rows(n)
            out[:, COL_SRC_IP3] = src
            out[:, COL_SPORT] = rng.integers(1024, 65535, n)
            out[:, COL_DST_IP3] = dst
            out[:, COL_DPORT] = rng.integers(1, 65535, n)
            out[:, COL_FLAGS] = TCP_SYN
            out[:, COL_LEN] = rng.integers(40, 60, n)
            out[:, COL_EP] = ep
            yield out
            sent += n


class L7AbuseScenario(Scenario):
    """Port-scan-shaped probes against a victim whose one open port
    carries an L7 HTTP redirect rule: a slice of the sweep
    lands on the redirect port and verdicts REDIRECT — feeding the
    serving L7 plane a sustained redirect stream under drop pressure
    — while the rest of the sweep default-denies.  Proves the proxy
    plane's no-silent-loss ledger (``redirected == l7_allowed +
    l7_denied + l7_shed + l7_failed``) closes under recon-shaped
    abuse, not just clean traffic."""

    name = "l7_abuse"
    criteria = {"ledger_exact": True, "l7_ledger_exact": True,
                "min_l7_redirected": 1, "max_shed_frac": 0.95,
                "min_drop_frac": 0.25}
    path = "serving"
    daemon_overrides = {"serving_bucket_ladder": (512,),
                        "serving_queue_depth": 1 << 14,
                        "spike_min_drops": 64}

    def __init__(self, seed: int = 0, n_packets: int = 4096,
                 batch: int = 512, redirect_port: int = 80,
                 redirect_every: int = 4):
        if n_packets < 1 or batch < 1:
            raise ValueError("n_packets and batch must be >= 1")
        if redirect_every < 1:
            raise ValueError("redirect_every must be >= 1")
        self.seed = int(seed)
        self.n_packets = int(n_packets)
        self.batch = int(batch)
        self.redirect_port = int(redirect_port)
        self.redirect_every = int(redirect_every)

    def setup(self, target) -> dict:
        ep = target.add_endpoint("l7-victim", ("10.0.47.1",),
                                 ["k8s:app=l7-victim"])
        target.policy_import([{
            "endpointSelector": {"matchLabels":
                                 {"app": "l7-victim"}},
            "ingress": [{"fromEntities": ["world"],
                         "toPorts": [{
                             "ports": [
                                 {"port": str(self.redirect_port),
                                  "protocol": "TCP"}],
                             "rules": {"http": [
                                 {"method": "GET",
                                  "path": "/public"}]},
                         }]}],
        }])
        return {"ep": ep.id}

    def iter_batches(self, ep: int) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed)
        src = _ip("172.20.0.9")
        dst = _ip("10.0.47.1")
        sent = 0
        while sent < self.n_packets:
            n = min(self.batch, self.n_packets - sent)
            out = _rows(n)
            out[:, COL_SRC_IP3] = src
            out[:, COL_SPORT] = rng.integers(1024, 65535, n)
            out[:, COL_DST_IP3] = dst
            dports = rng.integers(1, 65535, n).astype(np.uint32)
            # every redirect_every-th probe hits the L7 port: the
            # sweep's recon shape stays, the redirect stream is
            # deterministic and non-empty
            idx = np.arange(sent, sent + n)
            dports[idx % self.redirect_every == 0] = \
                self.redirect_port
            out[:, COL_DPORT] = dports
            out[:, COL_FLAGS] = TCP_SYN
            out[:, COL_LEN] = rng.integers(40, 60, n)
            out[:, COL_EP] = ep
            yield out
            sent += n


class NatExhaustionScenario(Scenario):
    """An egress ramp of unique pod -> world flows sized past the SNAT
    port pool: once every probe-window slot is live, allocation fails
    and the row drops as ``REASON_NAT_EXHAUSTED`` (DROP_NAT_NO_MAPPING),
    counted in ``NATTable.failed`` (the NAT pool-pressure signal).
    Runs on the OFFLINE path: masquerade rides ``process_batch``."""

    name = "nat_exhaustion"
    criteria = {"ledger_exact": True, "min_nat_failures": 1}
    path = "offline"
    # a 256-port pool against a 1k-flow ramp: exhaustion by design
    daemon_overrides = {"masquerade": True, "node_ip": "192.168.0.1",
                        "nat_pool_capacity": 256,
                        "ct_capacity": 1 << 12}

    def __init__(self, seed: int = 0, n_flows: int = 1024,
                 batch: int = 256):
        if n_flows < 1 or batch < 1:
            raise ValueError("n_flows and batch must be >= 1")
        self.seed = int(seed)
        self.n_flows = int(n_flows)
        self.batch = int(batch)

    def setup(self, target) -> dict:
        ep = target.add_endpoint("nat-client", ("10.0.45.1",),
                                 ["k8s:app=nat-client"])
        target.policy_import([{
            "endpointSelector": {"matchLabels": {"app": "nat-client"}},
            "egress": [{"toEntities": ["world"]}],
        }])
        return {"ep": ep.id}

    def iter_batches(self, ep: int) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed)
        src = _ip("10.0.45.1")
        dst_base = _ip("93.184.0.1")
        flow = 0
        while flow < self.n_flows:
            n = min(self.batch, self.n_flows - flow)
            i = np.arange(flow, flow + n, dtype=np.uint32)
            out = _rows(n)
            out[:, COL_SRC_IP3] = src
            out[:, COL_SPORT] = 1024 + (i % 60000)
            out[:, COL_DST_IP3] = dst_base + (i % 512)
            out[:, COL_DPORT] = 443
            out[:, COL_FLAGS] = TCP_SYN
            out[:, COL_LEN] = rng.integers(60, 120, n)
            out[:, COL_EP] = ep
            out[:, COL_DIR] = 1  # egress: the masquerade hook
            yield out
            flow += n


class ElephantMiceScenario(Scenario):
    """Zipf flow popularity over a fixed flow pool: a few elephant
    flows carry most packets while a long tail of mice appears once
    or twice — the heavy-tail shape the space-saving top-K sketches
    must survive (elephants always retained, per-key overcount
    bounded; the mergeable-summaries contract under realistic
    skew)."""

    name = "elephant_mice"
    criteria = {"ledger_exact": True, "max_shed_frac": 0.95,
                "p99_ms": 120000.0}
    path = "serving"
    daemon_overrides = {"serving_bucket_ladder": (512,),
                        "serving_queue_depth": 1 << 14}

    def __init__(self, seed: int = 0, n_flows: int = 512,
                 n_packets: int = 8192, batch: int = 512,
                 zipf_a: float = 1.2):
        if n_flows < 1 or n_packets < 1 or batch < 1:
            raise ValueError("n_flows/n_packets/batch must be >= 1")
        if zipf_a <= 1.0:
            raise ValueError("zipf_a must be > 1 (Zipf exponent)")
        self.seed = int(seed)
        self.n_flows = int(n_flows)
        self.n_packets = int(n_packets)
        self.batch = int(batch)
        self.zipf_a = float(zipf_a)
        self._weights = _zipf_weights(self.n_flows, self.zipf_a)

    def setup(self, target) -> dict:
        ep = target.add_endpoint("em-srv", ("10.0.42.1",),
                                 ["k8s:app=em-srv"])
        target.policy_import([{
            "endpointSelector": {"matchLabels": {"app": "em-srv"}},
            "ingress": [{"fromEntities": ["world"]}],
        }])
        return {"ep": ep.id}

    def flow_tuple(self, rank: int) -> Tuple[int, int]:
        """Rank -> (src ip, sport); rank 0 is the top elephant."""
        return (_ip("172.24.0.1") + rank % 256,
                1024 + rank)

    def iter_batches(self, ep: int) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed)
        dst = _ip("10.0.42.1")
        sent = 0
        while sent < self.n_packets:
            n = min(self.batch, self.n_packets - sent)
            ranks = rng.choice(self.n_flows, n, p=self._weights)
            srcs = (_ip("172.24.0.1")
                    + (ranks % 256)).astype(np.uint32)
            sports = (1024 + ranks).astype(np.uint32)
            out = _rows(n)
            out[:, COL_SRC_IP3] = srcs
            out[:, COL_SPORT] = sports
            out[:, COL_DST_IP3] = dst
            out[:, COL_DPORT] = 443
            out[:, COL_FLAGS] = TCP_ACK
            out[:, COL_LEN] = rng.integers(60, 1500, n)
            out[:, COL_EP] = ep
            yield out
            sent += n


@dataclass(frozen=True)
class EndpointOp:
    """One endpoint-churn event: connect or disconnect slot
    ``slot``'s endpoint (full add_endpoint/remove regeneration)."""

    kind: str  # "connect" | "disconnect"
    slot: int
    ip: str
    t_s: float


class EndpointChurnScenario(Scenario):
    """Endpoints connecting and disconnecting under live traffic:
    each op is a FULL ``add_endpoint``/``remove`` (policy
    re-resolve + regeneration + table publish), Zipf-weighted over
    slots — the pod-churn shape that stresses the attach path while
    the serving plane keeps dispatching."""

    name = "endpoint_churn"
    criteria = {"ledger_exact": True, "max_shed_frac": 0.95}
    path = "serving"
    daemon_overrides = {"serving_bucket_ladder": (64,),
                        "serving_max_wait_us": 500.0}

    def __init__(self, seed: int = 0, n_slots: int = 8,
                 zipf_a: float = 1.3, rate_hz: float = 50.0,
                 n_batches: int = 32):
        if n_slots < 1 or n_slots > 250:
            raise ValueError("n_slots must be in [1, 250]")
        if zipf_a <= 1.0:
            raise ValueError("zipf_a must be > 1 (Zipf exponent)")
        if rate_hz <= 0:
            raise ValueError("rate_hz must be > 0")
        self.seed = int(seed)
        self.n_slots = int(n_slots)
        self.n_batches = int(n_batches)
        self.zipf_a = float(zipf_a)
        self.rate_hz = float(rate_hz)
        self.interval_s = 1.0 / self.rate_hz
        self._weights = _zipf_weights(self.n_slots, self.zipf_a)

    def slot_ip(self, slot: int) -> str:
        return f"10.0.44.{slot + 1}"

    def setup(self, target) -> dict:
        ep = target.add_endpoint("ec-svc", ("10.0.43.1",),
                                 ["k8s:app=ec-svc"])
        target.policy_import([{
            "endpointSelector": {"matchLabels": {"app": "ec-svc"}},
            "ingress": [{"fromEntities": ["world"],
                         "toPorts": [{"ports": [
                             {"port": "8080",
                              "protocol": "TCP"}]}]}],
        }])
        return {"ep": ep.id}

    def iter_batches(self, ep: int) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed + 1)
        dst = _ip("10.0.43.1")
        for _ in range(self.n_batches):
            out = _rows(64)
            out[:, COL_SRC_IP3] = _ip("172.28.0.1") \
                + rng.integers(0, 64, 64).astype(np.uint32)
            out[:, COL_SPORT] = rng.integers(1024, 60000, 64)
            out[:, COL_DST_IP3] = dst
            out[:, COL_DPORT] = 8080
            out[:, COL_FLAGS] = TCP_ACK
            out[:, COL_LEN] = 256
            out[:, COL_EP] = ep
            yield out

    def ops(self, n: Optional[int] = None) -> List[EndpointOp]:
        return list(self.iter_ops(n if n is not None else 256))

    def iter_ops(self, n: Optional[int] = None
                 ) -> Iterator[EndpointOp]:
        rng = np.random.default_rng(self.seed)
        live = [False] * self.n_slots
        i = 0
        while n is None or i < n:
            slot = int(rng.choice(self.n_slots, p=self._weights))
            kind = "disconnect" if live[slot] else "connect"
            live[slot] = not live[slot]
            yield EndpointOp(kind=kind, slot=slot,
                             ip=self.slot_ip(slot),
                             t_s=i * self.interval_s)
            i += 1

    def apply(self, daemon, op: EndpointOp,
              live: Dict[int, object]) -> None:
        if op.kind == "connect":
            live[op.slot] = daemon.add_endpoint(
                f"ec{op.slot}", (op.ip,),
                [f"k8s:app=ec{op.slot}", "k8s:ec-churn=yes"])
        else:
            ep = live.pop(op.slot, None)
            if ep is not None:
                daemon.endpoints.remove(ep.id)

    def drain(self, daemon, live: Dict[int, object]) -> None:
        for slot in list(live):
            self.apply(daemon, EndpointOp("disconnect", slot,
                                          self.slot_ip(slot), 0.0),
                       live)


# name -> scenario class, in the reference's order
SCENARIOS = {
    IdentityChurnScenario.name: IdentityChurnScenario,
    SynFloodScenario.name: SynFloodScenario,
    PortScanScenario.name: PortScanScenario,
    L7AbuseScenario.name: L7AbuseScenario,
    NatExhaustionScenario.name: NatExhaustionScenario,
    ElephantMiceScenario.name: ElephantMiceScenario,
    EndpointChurnScenario.name: EndpointChurnScenario,
}


def make_scenario(name: str, seed: int = 0, **kw):
    """Instantiate a named scenario; unknown names list the registry,
    and a scenario of the reference that the port cannot run yet raises
    NotImplementedError naming its ROADMAP item."""
    if name == "rotation_storm":
        raise NotImplementedError(
            "scenario 'rotation_storm' rotates the key epochs of the "
            "process-mode cluster's encrypted channels, which is not "
            "ported yet (ROADMAP A21)")
    cls = SCENARIOS.get(name)
    if cls is None:
        raise ValueError(
            f"unknown scenario {name!r}; registered: "
            f"{', '.join(sorted(SCENARIOS))}")
    return cls(seed=seed, **kw)


def scenario_daemon(scenario, device=None, **overrides):
    """Build a Daemon shaped for ``scenario`` (its ``daemon_overrides``
    under the caller's ``overrides``) on ``device`` (None: the card): the
    one construction the tests and ``chip_smoke.py`` share, so the
    pressure shape a scenario declares is the shape it runs against.
    The Hubble flow ring is 2^13 flows, as the reference's; its
    ``backend`` key has no use here."""
    from ..agent.daemon import Daemon, DaemonConfig

    cfg = dict(flow_ring_capacity=1 << 13)
    cfg.update(scenario.daemon_overrides)
    cfg.update(overrides)
    return Daemon(DaemonConfig(**cfg), device=device)


# -- criteria evaluation ----------------------------------------------
def evaluate_criteria(criteria: Dict[str, object],
                      metrics: Dict[str, object]) -> Dict[str, bool]:
    """Declared criteria -> {criterion: passed}.  Unknown criterion
    keys evaluate False (a typo'd criterion must fail loudly, not
    vacuously pass)."""
    checks: Dict[str, bool] = {}
    for key, want in criteria.items():
        if key == "ledger_exact":
            checks[key] = bool(metrics.get("ledger_exact")) == bool(
                want)
        elif key == "max_shed_frac":
            shed = metrics.get("shed_frac")
            checks[key] = shed is not None and shed <= float(want)
        elif key == "p99_ms":
            p99 = metrics.get("p99_us")
            checks[key] = (p99 is not None
                           and p99 <= float(want) * 1e3)
        elif key == "min_ct_insert_drops":
            checks[key] = (metrics.get("ct_insert_drops", 0)
                           >= int(want))
        elif key == "min_nat_failures":
            checks[key] = (metrics.get("nat_failures", 0)
                           >= int(want))
        elif key == "min_drop_frac":
            frac = metrics.get("drop_frac")
            checks[key] = frac is not None and frac >= float(want)
        elif key == "l7_ledger_exact":
            checks[key] = bool(metrics.get("l7_ledger_exact")) \
                == bool(want)
        elif key == "min_l7_redirected":
            checks[key] = (metrics.get("l7_redirected", 0)
                           >= int(want))
        elif key == "min_rotations":
            checks[key] = (metrics.get("rotations", 0)
                           >= int(want))
        else:
            checks[key] = False
    return checks


def run_scenario(daemon, scenario, *, ctx: Optional[dict] = None,
                 max_ops: int = 256,
                 serving_kwargs: Optional[dict] = None) -> dict:
    """The one scenario runner the tests and ``chip_smoke.py`` share:
    replay the scenario's batch stream (serving or offline
    path) while applying its op stream on schedule, then evaluate
    the declared pass criteria.

    Returns ``{"name", "seed", "criteria", "metrics", "checks",
    "passed"}`` where ``metrics`` carries ``submitted`` /
    ``verdicts`` / ``shed`` / ``shed_frac`` / ``sustained_pps`` /
    ``p99_us`` / ``ledger_exact`` / ``ct_insert_drops`` /
    ``nat_failures`` / ``drop_frac`` and ``checks`` maps each
    declared criterion to its verdict.

    The reference also drives a started ``ClusterServing`` here; the
    port has no cluster yet (ROADMAP A21)."""
    if ctx is None:
        ctx = scenario.setup(daemon)
    ep = ctx.get("ep", 0)
    pressure0 = daemon.loader.map_pressure(daemon._now())
    metrics0 = np.array(daemon.loader.metrics(), dtype=np.int64)
    ops = iter(scenario.ops(max_ops))
    live: Dict = {}
    applied = 0
    next_op = None

    def tick_ops(elapsed: float) -> None:
        nonlocal next_op, applied
        if scenario.interval_s <= 0:
            return
        if next_op is None:
            next_op = elapsed
        # catch-up is CAPPED: an op that runs slower than its
        # schedule (endpoint churn's full regeneration) must
        # not replay its whole backlog in one burst — the run
        # degrades to best-effort rate instead of stalling traffic
        burst = 0
        while next_op is not None and elapsed >= next_op \
                and burst < 4:
            try:
                scenario.apply(daemon, next(ops), live)
                applied += 1
                burst += 1
                next_op += scenario.interval_s
            except StopIteration:
                next_op = None
        if next_op is not None and elapsed - next_op \
                > 64 * scenario.interval_s:
            next_op = elapsed  # drop an unservable backlog

    submitted = 0
    events = 0
    if scenario.path == "serving":
        kw = dict(ring_capacity=1 << 13, trace_sample=0,
                  packed=True, ingress=True)
        kw.update(serving_kwargs or {})
        daemon.start_serving(**kw)
        q = daemon._serving["runtime"].queue
        t0 = time.perf_counter()
        for b in scenario.iter_batches(ep):
            # submit() returns the ADMITTED count; the exact
            # submitted/shed split comes from the front-end snapshot
            daemon.submit(b)
            tick_ops(time.perf_counter() - t0)
            # backpressure: let the drain loop keep up instead of
            # shedding the whole storm at admission
            while q.pending > q.capacity // 2:
                time.sleep(0.001)
                tick_ops(time.perf_counter() - t0)
        st = daemon.stop_serving()
        fe = st["front-end"]
        l7 = st.get("l7") or {}
        dt = max(time.perf_counter() - t0, 1e-9)
        ft = fe["fault-tolerance"]
        ledger_exact = fe["submitted"] == (
            fe["verdicts"] + fe["shed"] + ft["recovery-dropped"])
        shed_frac = (fe["shed"] / fe["submitted"]
                     if fe["submitted"] else 0.0)
        p99 = (fe.get("latency-us") or {}).get("p99")
        verdicts = fe["verdicts"]
        submitted = fe["submitted"]
        pps = verdicts / dt
    else:  # offline: the process_batch pipeline (LB -> SNAT -> step)
        l7 = {}
        t0 = time.perf_counter()
        for b in scenario.iter_batches(ep):
            evb = daemon.process_batch(b)
            submitted += len(b)
            events += len(evb)
            tick_ops(time.perf_counter() - t0)
        dt = max(time.perf_counter() - t0, 1e-9)
        ledger_exact = events == submitted
        shed_frac = 0.0
        p99 = None
        verdicts = events
        pps = submitted / dt
    scenario.drain(daemon, live)
    pressure1 = daemon.loader.map_pressure(daemon._now())
    metrics1 = np.array(daemon.loader.metrics(), dtype=np.int64)
    reason_delta = (metrics1 - metrics0).sum(axis=1)
    dropped = int(reason_delta[1:].sum())  # reason 0 = forwarded
    metrics = {
        "submitted": int(submitted),
        "verdicts": int(verdicts),
        "shed_frac": round(float(shed_frac), 4),
        "sustained_pps": round(float(pps), 1),
        "p99_us": p99,
        "ledger_exact": bool(ledger_exact),
        "ops_applied": applied,
        "ct_insert_drops": (pressure1["ct"]["insert-drops"]
                            - pressure0["ct"]["insert-drops"]),
        "ct_occupancy": pressure1["ct"]["occupancy"],
        "nat_failures": (pressure1["nat"]["failures"]
                         - pressure0["nat"]["failures"]),
        "drop_frac": (round(dropped / submitted, 4)
                      if submitted else None),
        "drops_by_reason": {
            int(r): int(n) for r, n in enumerate(reason_delta)
            if r and n},
        "elapsed_s": round(dt, 3),
        # the L7 proxy-plane ledger: rows that verdicted
        # REDIRECT and their fate through the worker pool
        "l7_redirected": int(l7.get("redirected", 0)),
        "l7_allowed": int(l7.get("l7-allowed", 0)),
        "l7_denied": int(l7.get("l7-denied", 0)),
        "l7_shed": int(l7.get("l7-shed", 0)),
        "l7_failed": int(l7.get("l7-failed", 0)),
        "l7_ledger_exact": bool(l7.get("ledger-exact", False)),
    }
    checks = evaluate_criteria(scenario.criteria, metrics)
    return {
        "name": scenario.name,
        "seed": scenario.seed,
        "criteria": dict(scenario.criteria),
        "metrics": metrics,
        "checks": checks,
        "passed": all(checks.values()),
    }
