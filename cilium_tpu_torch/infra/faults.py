"""Deterministic fault injection for the serving datapath.

Reference: upstream cilium treats failure as an input it must keep
working through — ``cilium-health`` probes every node, endpoints
REGENERATE after datapath faults, the kvstore layer fails over.  The
control-plane half of that discipline already exists here
(``testing/chaos.ChaosKVStore``); this module is the DATAPATH half: a
seeded injector with NAMED SITES threaded through the serving hot
path, so the watchdog / fallback-ladder / recovery machinery
(serving/runtime.py, agent/daemon.py) can be proven against the
failures it exists for — deterministically, on CPU, in tier-1.

Sites are LOCATIONS (where the fault fires); the armed spec picks the
BEHAVIOR per site — raise (the code path dies there) or hang (the
call stalls, simulating a wedged device dispatch / stuck d2h fetch).

Spec grammar (one string, config/env-friendly)::

    spec  := entry (";" entry)*
    entry := site "=" rate ["x" count] ["@" skip] ["~" seconds]

- ``rate``: fire probability per pass through the site (1 = always).
- ``xN``: fire at most N times total (the usual test shape: ``x1``
  kills exactly one dispatch; ``x3`` drives a demotion threshold).
- ``@K``: stay inert for the first K passes through the site (skip
  the warmup dispatches that pay first-use costs, then strike).
- ``~S``: HANG for S seconds instead of raising (interruptible: the
  site's ``abort`` callback — e.g. "my generation was abandoned" —
  ends the stall early, like a cancelled RPC).

Examples: ``serving.dispatch=1x1`` (one dispatch raises),
``serving.dispatch=1x1@2~0.3`` (the third dispatch hangs 300 ms),
``loader.serve_sharded=1x3`` (three sharded dispatches fail — a shard
gone unavailable), ``serving.queue.take=0.01`` (1% of dequeue memcpys
fault).

Arming is PROCESS-GLOBAL (the sites live in hot paths that cannot
thread an injector object through every layer): ``arm()`` installs an
injector, ``disarm()`` removes it, and the disarmed fast path is one
module-global load + None check — zero-cost in production.  The agent
arms from ``DaemonConfig.fault_injection`` and disarms on shutdown.  Draws are seeded per (seed, site) so a fault
schedule replays exactly.
"""

from __future__ import annotations

import re
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

# -- the named sites ---------------------------------------------------
# serving/runtime.py — the drain thread, just before the device leg:
# a raise here kills the drain thread (dead-thread recovery); a hang
# simulates a wedged dispatch the watchdog must deadline.
SITE_SERVING_DISPATCH = "serving.dispatch"
# serving/ingress.py — the dequeue memcpy inside take_into(): the
# queue is exception-atomic (nothing is popped until every copy
# landed), so this kills the drain thread WITHOUT losing rows.
SITE_QUEUE_TAKE = "serving.queue.take"
# datapath/loader.py — the single-chip wide / packed serve dispatch
# and the sharded serve dispatch (a shard dropping off the mesh).
SITE_LOADER_SERVE = "loader.serve"
SITE_LOADER_SERVE_PACKED = "loader.serve_packed"
SITE_LOADER_SERVE_SHARDED = "loader.serve_sharded"
# ...and the K-batch superbatch dispatch: a raise fails
# the whole K-batch dispatch, which is exactly how the ladder's
# K-shrink demotion path is exercised.
SITE_LOADER_SERVE_SUPER = "loader.serve_super"
# monitor/ring.py — the window swap / collect of the async drainer
# (arm with ``~S`` for the ring-drain stall failure mode).
SITE_RING_SWAP = "ring.swap"
SITE_RING_COLLECT = "ring.collect"
# serving/eventplane.py — the event-join worker, just before it joins
# a popped window: a raise KILLS the worker thread (restart-on-death
# under its budget); a ``~S`` hang stalls the join plane so windows
# pile up against the bounded queue (overflow accounting).
SITE_EVENT_JOIN = "eventplane.join"
# cluster/membership.py — fired per node probe (fixed sweep order):
# a raise CRASHES the probed node (its serving runtime is
# crash-stopped, queued rows counted) and fails the probe, so
# ``cluster.probe=1x1@K`` is a deterministic "kill the K-th probed
# node" — the injected-node-death entry for cluster failover chaos.
SITE_CLUSTER_PROBE = "cluster.probe"
# datapath/loader.py table versioning (datapath/tables.py) — the
# mid-swap crash/hang sites of the churn chaos gate.  ``churn.build``
# fires in the BUILDER, after the successor tables are assembled but
# before publication: a raise abandons the build (the published
# generation and its tables stay untouched); a ``~S`` hang stalls the
# builder with only the build lock held, proving serving dispatches
# keep flowing through a slow rebuild.  ``churn.swap`` fires INSIDE
# the dispatch lock immediately before the generation flip: a raise
# proves a crash at the last possible instant still publishes
# nothing; a ``~S`` hang holds the dispatch lock (the worst-case
# swap stall the watchdog's deadline machinery must tolerate).
SITE_CHURN_BUILD = "churn.build"
SITE_CHURN_SWAP = "churn.swap"
# proxy/worker.py — an L7 worker, just before it parses a redirected
# task's payloads: a raise KILLS the worker mid-parse (the pool's
# watchdog restarts it under the budget and the task's rows are
# counted l7_failed, keeping the redirect ledger exact); a ``~S``
# hang stalls the pool so redirected tasks pile against the bounded
# queue (shed accounting).
SITE_L7_PARSE = "l7.parse"
# encryption/__init__.py — the AEAD legs of the encrypted cluster
# data channel.  ``crypto.seal`` fires in EncryptedChannel.seal just
# before the AEAD: a raise on the parent's forward path drops the
# frame BEFORE it reaches the wire (rows requeue through the window's
# drop accounting, ledger exact).  ``crypto.open`` fires in
# EncryptedChannel.open before verification: the frame arrived but
# cannot be opened — the receiver must count it rejected and reply
# with the typed crypto-reject record, never die.
SITE_CRYPTO_SEAL = "crypto.seal"
SITE_CRYPTO_OPEN = "crypto.open"

SITES = frozenset({
    SITE_SERVING_DISPATCH,
    SITE_QUEUE_TAKE,
    SITE_LOADER_SERVE,
    SITE_LOADER_SERVE_PACKED,
    SITE_LOADER_SERVE_SHARDED,
    SITE_LOADER_SERVE_SUPER,
    SITE_RING_SWAP,
    SITE_RING_COLLECT,
    SITE_EVENT_JOIN,
    SITE_CLUSTER_PROBE,
    SITE_CHURN_BUILD,
    SITE_CHURN_SWAP,
    SITE_L7_PARSE,
    SITE_CRYPTO_SEAL,
    SITE_CRYPTO_OPEN,
})


class InjectedFault(RuntimeError):
    """An armed site fired.  Deliberately a plain RuntimeError
    subclass: recovery code must treat it exactly like the organic
    failure it stands in for."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at {site}")
        self.site = site


_ENTRY_RE = re.compile(
    r"^(?P<site>[a-z][a-z0-9_.]*)=(?P<rate>[0-9.]+)"
    r"(?:x(?P<count>[0-9]+))?(?:@(?P<skip>[0-9]+))?"
    r"(?:~(?P<hang>[0-9.]+))?$")


@dataclass
class _Site:
    rate: float
    remaining: Optional[int]  # None = unlimited
    skip: int  # inert passes before the site goes live
    hang_s: Optional[float]  # None = raise


class FaultInjector:
    """A parsed, armed fault plan.  Thread-safe; draws are seeded per
    (seed, site) so one spec replays the same schedule."""

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = int(seed)
        self._sites: Dict[str, _Site] = {}
        self._rngs: Dict[str, np.random.Generator] = {}
        self.fired: Dict[str, int] = {}
        self._lock = threading.Lock()
        for entry in re.split(r"[;\s]+", spec.strip()):
            if not entry:
                continue
            m = _ENTRY_RE.match(entry)
            if m is None:
                raise ValueError(
                    f"bad fault spec entry {entry!r} (want "
                    f"site=rate[xcount][~seconds])")
            site = m.group("site")
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; sites: "
                    f"{', '.join(sorted(SITES))}")
            rate = float(m.group("rate"))
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"fault rate {rate} not in [0, 1]")
            self._sites[site] = _Site(
                rate=rate,
                remaining=(int(m.group("count"))
                           if m.group("count") else None),
                skip=(int(m.group("skip"))
                      if m.group("skip") else 0),
                hang_s=(float(m.group("hang"))
                        if m.group("hang") else None))
            # crc32, not hash(): str hashes are salted per process and
            # the whole point is a replayable schedule
            self._rngs[site] = np.random.default_rng(
                (self.seed << 32) ^ zlib.crc32(site.encode()))
            self.fired[site] = 0

    def check(self, site: str,
              abort: Optional[Callable[[], bool]] = None) -> None:
        # thread-affinity: any
        """Fire the site per its armed spec: raise
        :class:`InjectedFault`, or stall ``~S`` seconds (ended early
        when ``abort()`` turns True).  No-op for unarmed sites."""
        sp = self._sites.get(site)
        if sp is None:
            return
        with self._lock:
            if sp.skip > 0:
                sp.skip -= 1
                return
            if sp.remaining == 0:
                return
            if sp.rate < 1.0 and self._rngs[site].random() >= sp.rate:
                return
            if sp.remaining is not None:
                sp.remaining -= 1
            self.fired[site] += 1
        if sp.hang_s is None:
            raise InjectedFault(site)
        t_end = time.monotonic() + sp.hang_s
        while True:
            left = t_end - time.monotonic()
            if left <= 0:
                return
            if abort is not None and abort():
                return
            # hot-path-ok: the ~S HANG INJECTION itself — only
            # reachable while a fault site is armed (tests/chaos);
            # disarmed cost is one global load + None check
            time.sleep(min(0.005, left))


# -- the process-global arm point --------------------------------------
_active: Optional[FaultInjector] = None


def arm(spec: str, seed: int = 0) -> FaultInjector:
    """Parse ``spec`` and install it as THE active injector (last arm
    wins); returns it so the owner can :func:`disarm` exactly what it
    armed and read ``fired`` counts."""
    global _active
    inj = FaultInjector(spec, seed)
    _active = inj
    return inj


def disarm(injector: Optional[FaultInjector] = None) -> None:
    """Remove the active injector.  Passing the injector ``arm()``
    returned makes disarm ownership-safe: a daemon shutting down after
    another one re-armed leaves the newer plan in place."""
    global _active
    if injector is None or injector is _active:
        _active = None


def active() -> Optional[FaultInjector]:
    return _active


def check(site: str,
          abort: Optional[Callable[[], bool]] = None) -> None:
    """The hot-path entry: one global load + None check when disarmed."""
    inj = _active
    if inj is None:
        return
    inj.check(site, abort)
