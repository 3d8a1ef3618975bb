"""The off-hot-path event plane: async window join, bounded.

Reference: upstream cilium never pays for its monitor plane in the
packet path — the kernel appends to the perf ring and
``pkg/monitor/agent`` drains it from userspace at its own cadence.
Before this module our serving loop violated that separation: every
``drain_every``-th dispatch, the DRAIN THREAD blocked on a
full-capacity d2h copy plus host-side decode / wide-column
reconstruction / monitor fan-out before the next batch could
dispatch.  Now the drain thread's only event work is ``swap_window``
(block on the 8-byte cursor, start the async — occupancy-bounded —
copy) and one bounded-queue push; THIS worker completes the
transfer, decodes, joins packed rows back to wide columns, and emits
to monitor/hubble consumers.

Loss discipline (the no-silent-loss contract, applied to the event
plane's own machinery):

- bounded-queue OVERFLOW drops the OLDEST queued window, counted
  (``windows-dropped`` / ``events-dropped``), never silently — the
  freshest telemetry survives a stall, and the stalest arena-slot
  references (the ones closest to recycling) release first;
- a window whose join starts only after the producer's arena may
  have recycled its record slots is refused and counted (the
  ``seq``/join-horizon check in ``Daemon._event_join``) — stale
  windows become counted loss, never silently-corrupt events;
- a window whose join RAISES is dropped and counted — the worker
  lives on (the contained-failure shape the dispatch ladder uses);
- worker DEATH (an exception outside the per-window containment,
  e.g. the ``eventplane.join`` fault site) restarts the thread under
  a restart budget — the drain-loop watchdog pattern; terminal once
  exhausted, with every queued window swept as a counted drop;
- ``stop(drain=True)`` processes everything queued before returning,
  so ``submitted == joined + dropped`` holds exactly afterwards.

The packet ledger (``submitted == verdicts + shed +
recovery_dropped``) is untouched by any of this: verdicts are
recorded at dispatch, and event-plane loss is monitor-plane loss —
counted in its own ledger, surfaced through serving stats /
``GET /serving`` / the metrics registry.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from ..infra import faults
from .stats import LatencyHistogram

# how long the worker sleeps between queue polls while idle; also
# bounds how fast stop()/death detection propagate
_IDLE_WAIT_S = 0.05
DEFAULT_WINDOW_QUEUE = 4


class DrainWindow:
    """One drain window in flight between the serving drain thread
    and the event-join worker: the :class:`~..monitor.ring.RingWindow`
    transfer handle plus the host-side join context captured at swap
    time — the batch records (header arena slots, numerics snapshots)
    of every batch whose events this window holds.

    Capturing the records AT SWAP (a dict handoff, zero copy) is what
    extends the arena recycling horizon cleanly: the drain thread
    forgets the window, the snapshot keeps the references, and
    ``Daemon.start_serving`` sizes the arena depth to cover every
    window the bounded queue can hold."""

    __slots__ = ("ring", "records", "t_swap", "seq")

    def __init__(self, ring, records: dict, seq=None):
        self.ring = ring
        self.records = records  # bid -> (kind, hdr, meta, numerics, ts)
        self.t_swap = ring.t_swap
        # producer's batch seq at swap: the join leg compares it
        # against the live seq to refuse joins whose arena-slot
        # references may have been recycled (see Daemon._event_join)
        self.seq = seq

    @property
    def appended(self) -> int:
        return self.ring.appended

    @property
    def lost(self) -> int:
        return self.ring.lost

    @property
    def d2h_bytes(self) -> int:
        return self.ring.d2h_bytes


class EventJoinWorker:
    """The dedicated join thread: pops :class:`DrainWindow` handles
    off a bounded queue and runs ``join_fn(window)`` (the daemon's
    fetch + decode + wide-column join + monitor emit leg) off the
    dispatch path.  ``drop_fn(window)``, when given, runs for every
    window the plane LOSES (overflow, contained join failure, death,
    stop sweep)."""

    def __init__(self, join_fn: Callable, drop_fn: Optional[Callable]
                 = None, queue_depth: int = DEFAULT_WINDOW_QUEUE,
                 restart_budget: int = 3,
                 on_terminal: Optional[Callable[[str], None]] = None):
        self._join_fn = join_fn
        self._drop_fn = drop_fn
        # INCIDENT HOOK POINT (obs/flightrec.py): on_terminal(error)
        # fires once, from the dying worker thread, when the restart
        # budget exhausts — the daemon wires it to the flight
        # recorder (a terminal event worker means the monitor plane
        # went dark, which is exactly when an operator wants a
        # state bundle).  Contained: a failing hook must not mask
        # the terminal error it reports
        self._on_terminal = on_terminal
        self.queue_depth = max(1, int(queue_depth))
        self._budget = max(0, int(restart_budget))
        self._cv = threading.Condition()
        # guarded-by: _cv: _q, _current, _stop, error, restarts,
        # guarded-by: _cv: windows_submitted, windows_joined,
        # guarded-by: _cv: windows_dropped, overflows, events_joined,
        # guarded-by: _cv: events_dropped, ring_lost, d2h_bytes,
        # guarded-by: _cv: join_lag, last_drop_cause
        self._q: list = []
        self._current: Optional[DrainWindow] = None
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[str] = None  # terminal fault
        # the event-plane ledger: submitted == joined + dropped once
        # pending reaches 0 (post-stop it always does)
        self.windows_submitted = 0
        self.windows_joined = 0
        self.windows_dropped = 0
        self.overflows = 0  # ...of the dropped, at the bounded queue
        self.events_joined = 0
        self.events_dropped = 0
        self.ring_lost = 0  # lap loss summed over windows (either way)
        self.d2h_bytes = 0
        self.restarts = 0
        self.join_lag = LatencyHistogram()  # swap -> emitted, µs
        self.last_drop_cause = ""

    # -- producer side (the serving drain thread) ----------------------
    def submit(self, window: DrainWindow) -> bool:
        # thread-affinity: any
        """Offer one window; never blocks.  A full queue drops the
        OLDEST queued window (counted) to admit the new one — the
        drop-oldest discipline the monitor queues use, so a stalled
        plane keeps the freshest telemetry AND releases the stalest
        arena references first.  A terminal/stopped worker drops the
        offered window instead.  Returns False when the offered
        window itself was dropped."""
        victim = drop_cause = None
        with self._cv:
            self.windows_submitted += 1
            # the bytes crossed the link at swap regardless of what
            # happens to the window now
            self.d2h_bytes += window.d2h_bytes
            if self.error is not None:
                drop_cause = "worker terminal"
            elif self._stop:
                drop_cause = "worker stopped"
            else:
                if len(self._q) >= self.queue_depth:
                    self.overflows += 1
                    victim = self._q.pop(0)
                self._q.append(window)
                self._cv.notify()
        if victim is not None:
            self._drop(victim, "window queue full")
            return True
        if drop_cause is not None:
            self._drop(window, drop_cause)
            return False
        return True

    @property
    def pending(self) -> int:
        # thread-affinity: any
        with self._cv:
            return len(self._q) + (1 if self._current is not None
                                   else 0)

    def _stopping(self) -> bool:
        """Locked read of the stop-and-drained predicate (the fault
        site's abort hook — the bare lambda read violated the
        guarded-by contract)."""
        with self._cv:
            return self._stop and not self._q

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        # thread-affinity: api
        assert self._thread is None, "worker already started"
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-eventjoin")
        self._thread.start()

    def stop(self, drain: bool = True, timeout: float = 30.0) -> dict:
        # thread-affinity: api
        """Stop the worker.  With ``drain`` (default) every queued
        window is joined first — the ``stop_serving`` contract; the
        sweep below only fires for a dead/terminal worker or a
        timeout, and it COUNTS what it sweeps."""
        with self._cv:
            self._stop = True
            if not drain:
                swept, self._q = self._q, []
            self._cv.notify_all()
        if not drain:
            for w in swept:
                self._drop(w, "stopped without drain")
        deadline = time.monotonic() + timeout
        t = self._thread
        while (t is not None and t.is_alive()
               and time.monotonic() < deadline):
            t.join(timeout=0.1)
            t = self._thread  # follow restart-spawned successors
        with self._cv:
            swept, self._q = self._q, []
            # claim the in-flight window too: a join hung past the
            # timeout must still land in the ledger (submitted ==
            # joined + dropped is the post-stop contract).  Claiming
            # it here transfers ownership — if the wedged join_fn
            # eventually returns, _run_body sees it lost the claim
            # and does NOT also count the window joined.
            cur, self._current = self._current, None
            # the terminal error is read under the SAME lock that
            # writes it (the bare `self.error or ...` read below the
            # block raced a dying worker's write)
            sweep_cause = self.error or "worker did not drain in time"
        for w in swept:
            self._drop(w, sweep_cause)
        if cur is not None:
            self._drop(cur, "join hung past stop timeout")
        return self.stats()

    # -- the worker thread ---------------------------------------------
    def _run(self) -> None:
        # thread-affinity: event-worker
        try:
            self._run_body()
        except BaseException as e:  # noqa: BLE001 — death path: the
            # window being joined is a counted loss, and the thread
            # restarts under the budget (the drain-loop watchdog
            # discipline applied to the join plane).  Claim under the
            # lock — stop()'s timeout sweep may have taken it already.
            with self._cv:
                cur, self._current = self._current, None
            if cur is not None:
                self._drop(cur, f"worker died: {e}")
            went_terminal = fire = False
            err = None
            with self._cv:
                if self._stop or self.restarts >= self._budget:
                    went_terminal = True
                    # a worker dying DURING stop() is the sweep's
                    # business, not an incident
                    fire = not self._stop
                    err = self.error = (
                        f"event-join worker died ({type(e).__name__}: "
                        f"{e}); restart budget "
                        f"{self.restarts}/{self._budget} exhausted")
                    self._cv.notify_all()
                else:
                    self.restarts += 1
                    n = self.restarts
            if went_terminal:
                if fire and self._on_terminal is not None:
                    try:  # outside the lock: the hook may read
                        # stats(), so hand it the captured error
                        self._on_terminal(err)
                    except Exception:  # noqa: BLE001
                        pass
                return
            t = threading.Thread(target=self._run, daemon=True,
                                 name=f"serving-eventjoin-r{n}")
            self._thread = t
            t.start()

    def _run_body(self) -> None:
        # thread-affinity: event-worker
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait(_IDLE_WAIT_S)
                if self._q:
                    window = self._q.pop(0)
                    self._current = window
                else:  # stopped AND drained
                    return
            # the injection site: a raise here kills the worker
            # (restart-on-death); a ~S hang stalls the plane so the
            # bounded queue's overflow accounting can be proven
            faults.check(faults.SITE_EVENT_JOIN, abort=self._stopping)
            try:
                self._join_fn(window)
            except Exception as e:  # noqa: BLE001 — contained: one
                # window lost (counted), the plane lives on
                with self._cv:
                    owned = self._current is window
                    self._current = None
                if owned:
                    self._drop(window, f"join failed: "
                                       f"{type(e).__name__}: {e}")
                continue
            with self._cv:
                if self._current is not window:
                    # stop()'s timeout sweep claimed this window and
                    # already counted it dropped while the join hung
                    # — never double-count it
                    continue
                self._current = None
                self.windows_joined += 1
                self.events_joined += window.appended - window.lost
                self.ring_lost += window.lost
                self.join_lag.record(
                    (time.monotonic() - window.t_swap) * 1e6)
                self._cv.notify_all()

    def _drop(self, window: DrainWindow, cause: str) -> None:
        # thread-affinity: any
        with self._cv:
            self.windows_dropped += 1
            self.events_dropped += window.appended - window.lost
            self.ring_lost += window.lost
            self.last_drop_cause = (cause or "")[:200]
            self._cv.notify_all()
        if self._drop_fn is not None:
            try:
                self._drop_fn(window)
            except Exception:  # noqa: BLE001 — loss accounting must
                pass  # never cascade

    # -- reading (API/CLI threads) -------------------------------------
    def stats(self) -> Dict[str, object]:
        # thread-affinity: any
        with self._cv:
            out = {
                "queue-depth": self.queue_depth,
                "windows-pending": (len(self._q)
                                    + (1 if self._current is not None
                                       else 0)),
                "windows-submitted": self.windows_submitted,
                "windows-joined": self.windows_joined,
                "windows-dropped": self.windows_dropped,
                "queue-overflows": self.overflows,
                "events-joined": self.events_joined,
                "events-dropped": self.events_dropped,
                "ring-lost": self.ring_lost,
                "d2h-bytes": self.d2h_bytes,
                "d2h-bytes-per-event": (
                    round(self.d2h_bytes
                          / (self.events_joined + self.events_dropped),
                          2)
                    if (self.events_joined + self.events_dropped)
                    else None),
                "worker-restarts": self.restarts,
                "join-lag-us": self.join_lag.snapshot(),
            }
            if self.last_drop_cause:
                out["last-drop-cause"] = self.last_drop_cause
            if self.error is not None:
                out["error"] = self.error
            return out
