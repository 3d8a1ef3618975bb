"""The L7 worker pool: bounded-queue proxy workers off the event plane.

Reference: upstream cilium redirects matched flows to a userspace
proxy (Envoy via ``pkg/proxy``, proxylib parsers for the long tail of
protocols) running in its own threads — the packet path's only cost
is the REDIRECT verdict and the proxy does payload work at its own
cadence.  Here the device emits ``VERDICT_REDIRECT``
rows into the monitor ring; the event plane's join worker fans those
rows out (never the drain thread — the same separation the event
plane itself exists for) into THIS pool, whose workers parse payloads
via the plugin registry and evaluate L7 policy through the fused
L7 verdict kernel behind ``l7policy.l7_verdict``.

Loss discipline — the no-silent-loss contract, applied to the proxy
plane's own machinery, in ROWS (redirected packets), not windows::

    redirected == l7_allowed + l7_denied + l7_shed + l7_failed

- bounded-queue OVERFLOW drops the OLDEST queued task, its rows
  counted ``l7_shed`` — a stalled proxy keeps the freshest redirects;
- a task whose handling RAISES is contained: its rows count
  ``l7_failed``, the worker lives on;
- worker DEATH (an exception outside the per-task containment, e.g.
  the ``l7.parse`` fault site) claims the in-flight task — its rows
  count ``l7_failed`` — and the thread restarts under a POOL-WIDE
  restart budget (the drain-loop watchdog idiom); terminal once
  exhausted (new submissions shed, surviving workers keep draining);
- ``stop(drain=True)`` handles everything queued before returning,
  so the ledger closes exactly afterwards.

The counters are declared in ``L7WorkerPool.__init__`` and surfaced
verbatim through ``stats()`` → ``Daemon.serving_stats()["l7"]`` and
``Daemon.proxy_stats()``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..infra import faults
from ..serving.stats import LatencyHistogram

_IDLE_WAIT_S = 0.05
DEFAULT_L7_WORKERS = 2
DEFAULT_L7_QUEUE = 128


class L7Task:
    """One redirected row-group in flight between the event plane and
    an L7 worker: every redirect row of one (proxy_port, batch) pair,
    with the header columns the parse leg needs to synthesize /
    attribute requests.  ``rows`` is the ledger unit — the task is
    accounted in rows whatever happens to it."""

    __slots__ = ("port", "rows", "hdr", "identities", "meta",
                 "t_submit")

    def __init__(self, port: int, rows: int, hdr=None,
                 identities=None, meta=None):
        self.port = int(port)
        self.rows = int(rows)
        self.hdr = hdr  # per-row header columns (dict of np arrays)
        self.identities = identities  # per-row source identity ids
        self.meta = meta  # owner context (plane's request source etc.)
        self.t_submit = 0.0


class L7WorkerPool:
    """N worker threads popping :class:`L7Task` off one bounded queue
    and running ``handle_fn(task) -> (n_allowed, n_denied)`` (the L7
    plane's parse + verdict + DNS-observe leg).  Rows the handler does
    not account for (``allowed + denied < task.rows``) count
    ``l7_failed`` — the ledger closes no matter what a handler does."""

    def __init__(self, handle_fn: Callable[[L7Task], tuple],
                 workers: int = DEFAULT_L7_WORKERS,
                 queue_depth: int = DEFAULT_L7_QUEUE,
                 restart_budget: int = 3,
                 on_terminal: Optional[Callable[[str], None]] = None):
        self._handle_fn = handle_fn
        # incident hook: fires once, from the dying worker thread, when
        # the pool-wide restart budget exhausts — a terminal proxy pool
        # means redirected traffic is shedding (the daemon records an
        # incident in memory; the flight recorder is ROADMAP A14).
        self._on_terminal = on_terminal
        self.n_workers = max(1, int(workers))
        self.queue_depth = max(1, int(queue_depth))
        self._budget = max(0, int(restart_budget))
        self._cv = threading.Condition()
        # guarded-by: _cv: _q, _current, _stop, error, restarts,
        # guarded-by: _cv: tasks_submitted, tasks_done, tasks_dropped,
        # guarded-by: _cv: overflows, redirected, l7_allowed,
        # guarded-by: _cv: l7_denied, l7_shed, l7_failed, parse_lag,
        # guarded-by: _cv: last_drop_cause
        self._q: List[L7Task] = []
        # one in-flight slot per worker: death/stop sweeps claim them
        # under the lock so a wedged handler can never double-count
        self._current: List[Optional[L7Task]] = \
            [None] * self.n_workers
        self._stop = False
        self._threads: List[Optional[threading.Thread]] = \
            [None] * self.n_workers
        self.error: Optional[str] = None  # terminal fault
        # the proxy-plane ledger (rows):
        #   redirected == l7_allowed + l7_denied + l7_shed + l7_failed
        # exact once pending reaches 0 (post-stop it always does)
        self.redirected = 0
        self.l7_allowed = 0
        self.l7_denied = 0
        self.l7_shed = 0
        self.l7_failed = 0
        self.tasks_submitted = 0
        self.tasks_done = 0
        self.tasks_dropped = 0
        self.overflows = 0  # ...of the dropped, at the bounded queue
        self.restarts = 0  # pool-wide, against one shared budget
        self.parse_lag = LatencyHistogram()  # submit -> handled, µs
        self.last_drop_cause = ""

    # -- producer side (the event-join worker) -------------------------
    def submit(self, task: L7Task) -> bool:
        # thread-affinity: any
        """Offer one task; never blocks.  A full queue sheds the
        OLDEST queued task (counted) to admit the new one; a
        terminal/stopped pool sheds the offered task instead.
        Returns False when the offered task itself was shed."""
        victim = drop_cause = None
        task.t_submit = time.monotonic()
        with self._cv:
            self.tasks_submitted += 1
            # the rows entered the proxy plane regardless of what
            # happens to the task now — that is what keeps the ledger
            # exact under trace-sampling upstream and shedding here
            self.redirected += task.rows
            if self.error is not None:
                drop_cause = "pool terminal"
            elif self._stop:
                drop_cause = "pool stopped"
            else:
                if len(self._q) >= self.queue_depth:
                    self.overflows += 1
                    victim = self._q.pop(0)
                self._q.append(task)
                self._cv.notify()
        if victim is not None:
            self._shed(victim, "task queue full")
            return True
        if drop_cause is not None:
            self._shed(task, drop_cause)
            return False
        return True

    @property
    def pending(self) -> int:
        # thread-affinity: any
        with self._cv:
            return (len(self._q)
                    + sum(1 for c in self._current if c is not None))

    def _stopping(self) -> bool:
        """Locked read of the stop-and-drained predicate (the
        ``l7.parse`` hang site's abort hook)."""
        with self._cv:
            return self._stop and not self._q

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        # thread-affinity: api
        assert all(t is None for t in self._threads), \
            "pool already started"
        for i in range(self.n_workers):
            t = threading.Thread(target=self._run, args=(i,),
                                 daemon=True,
                                 name=f"serving-l7-w{i}")
            self._threads[i] = t
            t.start()

    def stop(self, drain: bool = True, timeout: float = 30.0) -> dict:
        # thread-affinity: api
        """Stop the pool.  With ``drain`` (default) every queued task
        is handled first — the ``stop_serving`` contract; the sweep
        below only fires for dead/terminal workers or a timeout, and
        it COUNTS what it sweeps."""
        with self._cv:
            self._stop = True
            if not drain:
                swept, self._q = self._q, []
            self._cv.notify_all()
        if not drain:
            for t in swept:
                self._shed(t, "stopped without drain")
        deadline = time.monotonic() + timeout
        for i in range(self.n_workers):
            # follow restart successors: a dying worker publishes its
            # successor (already started) before it exits, so the slot
            # is drained once its thread is dead AND still the slot's
            # (the reference re-reads the slot only after a join, and
            # misses a successor published between the read and the
            # liveness check: the queued tasks are then swept as shed)
            while time.monotonic() < deadline:
                t = self._threads[i]
                if t is not None and t.is_alive():
                    t.join(timeout=0.1)
                elif self._threads[i] is t:
                    break
        with self._cv:
            swept, self._q = self._q, []
            # claim every in-flight task too: a handler hung past the
            # timeout must still land in the ledger.  Claiming under
            # the lock transfers ownership — if the wedged handler
            # eventually returns, _run_body sees it lost the claim
            # and does NOT also count the task done.
            curs = [c for c in self._current if c is not None]
            self._current = [None] * self.n_workers
            sweep_cause = self.error or "pool did not drain in time"
        for t in swept:
            self._shed(t, sweep_cause)
        for t in curs:
            self._fail(t, t.rows, "handler hung past stop timeout")
        return self.stats()

    # -- the worker threads --------------------------------------------
    def _run(self, slot: int) -> None:
        # thread-affinity: l7
        try:
            self._run_body(slot)
        except BaseException as e:  # noqa: BLE001 — death path: the
            # in-flight task's rows are a counted l7_failed loss, and
            # the slot restarts under the pool budget (the drain-loop
            # watchdog discipline applied to the proxy plane).  Claim
            # under the lock — stop()'s sweep may have taken it.
            with self._cv:
                cur, self._current[slot] = self._current[slot], None
            if cur is not None:
                self._fail(cur, cur.rows, f"worker died: {e}")
            went_terminal = fire = False
            err = None
            with self._cv:
                if self._stop or self.restarts >= self._budget:
                    went_terminal = True
                    # a worker dying DURING stop() is the sweep's
                    # business, not an incident
                    fire = not self._stop and self.error is None
                    if self.error is None:
                        self.error = (
                            f"l7 worker died ({type(e).__name__}: "
                            f"{e}); restart budget "
                            f"{self.restarts}/{self._budget} exhausted")
                    err = self.error
                    self._cv.notify_all()
                else:
                    self.restarts += 1
                    n = self.restarts
            if went_terminal:
                if fire and self._on_terminal is not None:
                    try:  # contained: a failing hook must not mask
                        # the terminal error it reports
                        self._on_terminal(err)
                    except Exception:  # noqa: BLE001
                        pass
                return
            t = threading.Thread(target=self._run, args=(slot,),
                                 daemon=True,
                                 name=f"serving-l7-w{slot}-r{n}")
            t.start()  # started before published: stop() joins it
            self._threads[slot] = t

    def _run_body(self, slot: int) -> None:
        # thread-affinity: l7
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait(_IDLE_WAIT_S)
                if self._q:
                    task = self._q.pop(0)
                    self._current[slot] = task
                else:  # stopped AND drained
                    return
            # the injection site: a raise here kills the worker
            # mid-parse (restart-on-death, rows counted l7_failed); a
            # ~S hang stalls the pool so the bounded queue's shed
            # accounting can be proven
            faults.check(faults.SITE_L7_PARSE, abort=self._stopping)
            try:
                allowed, denied = self._handle_fn(task)
                allowed = max(0, int(allowed))
                denied = max(0, int(denied))
            except Exception as e:  # noqa: BLE001 — contained: one
                # task's rows lost (counted), the worker lives on
                with self._cv:
                    owned = self._current[slot] is task
                    self._current[slot] = None
                if owned:
                    self._fail(task, task.rows,
                               f"handler failed: "
                               f"{type(e).__name__}: {e}")
                continue
            with self._cv:
                if self._current[slot] is not task:
                    # stop()'s timeout sweep claimed this task and
                    # already counted it while the handler hung —
                    # never double-count it
                    continue
                self._current[slot] = None
                # rows the handler left unaccounted are failures, so
                # the ledger closes no matter what a handler returns
                short = task.rows - min(task.rows, allowed + denied)
                if allowed + denied > task.rows:
                    allowed = min(allowed, task.rows)
                    denied = task.rows - allowed
                self.l7_allowed += allowed
                self.l7_denied += denied
                self.l7_failed += short
                self.tasks_done += 1
                self.parse_lag.record(
                    (time.monotonic() - task.t_submit) * 1e6)
                self._cv.notify_all()

    def _shed(self, task: L7Task, cause: str) -> None:
        # thread-affinity: any
        with self._cv:
            self.tasks_dropped += 1
            self.l7_shed += task.rows
            self.last_drop_cause = (cause or "")[:200]
            self._cv.notify_all()

    def _fail(self, task: L7Task, rows: int, cause: str) -> None:
        # thread-affinity: any
        with self._cv:
            self.tasks_dropped += 1
            self.l7_failed += rows
            self.last_drop_cause = (cause or "")[:200]
            self._cv.notify_all()

    # -- reading (API/CLI threads) -------------------------------------
    def stats(self) -> Dict[str, object]:
        # thread-affinity: any
        with self._cv:
            pending = (len(self._q)
                       + sum(1 for c in self._current
                             if c is not None))
            accounted = (self.l7_allowed + self.l7_denied
                         + self.l7_shed + self.l7_failed)
            out = {
                "workers": self.n_workers,
                "queue-depth": self.queue_depth,
                "tasks-pending": pending,
                "tasks-submitted": self.tasks_submitted,
                "tasks-done": self.tasks_done,
                "tasks-dropped": self.tasks_dropped,
                "queue-overflows": self.overflows,
                "redirected": self.redirected,
                "l7-allowed": self.l7_allowed,
                "l7-denied": self.l7_denied,
                "l7-shed": self.l7_shed,
                "l7-failed": self.l7_failed,
                # exact once nothing is in flight (post-stop always)
                "ledger-exact": (pending == 0
                                 and self.redirected == accounted),
                "worker-restarts": self.restarts,
                "parse-lag-us": self.parse_lag.snapshot(),
            }
            if self.last_drop_cause:
                out["last-drop-cause"] = self.last_drop_cause
            if self.error is not None:
                out["error"] = self.error
            return out
