"""The serving drain loop: ingress stream -> device batches.

Reference: upstream cilium's NAPI-ish consumption of the XDP/RSS
front end — a poll loop takes what arrived (up to the ring budget),
runs it through the datapath, and surfaces sheds as counted drops.
Production inference stacks call the same shape "continuous
batching".

Double buffering: ``dispatch`` (``Daemon.serve_batch`` under the
hood) ENQUEUES the device work and returns — kernels launch
asynchronously on the card's stream — so while batch N executes on device, this loop is already draining
the queue and padding batch N+1 on the host.  hdr/valid buffers come
from the batcher's preallocated arena (ownership transfers to the
dispatcher under the recycling horizon documented in batcher.py), so
assembly is allocation-free AND never touches pages an in-flight h2d
copy or the drain-time event join may still be reading.

The loop owns all dispatch: ``submit()`` (any thread) only offers
rows to the bounded ingress queue, which is the backpressure point —
overflow sheds by policy, sheds surface through ``on_shed`` as
monitor DROP events, and nothing ever blocks the producer.

Fault tolerance (the cilium-health / endpoint-regeneration analogue
for the serving plane): with ``restart_budget > 0`` a WATCHDOG thread
supervises the drain loop —

- a DEAD drain thread (any uncaught exception) is restarted with
  exponential backoff, its in-flight batch accounted as counted
  recovery drops (``REASON_RECOVERY_DROP``);
- a HUNG dispatch is deadlined (``dispatch_deadline_s``): the wedged
  generation is ABANDONED (a bumped generation counter makes the old
  thread exit without dispatching or double-recording when it ever
  wakes), its batch accounted as ``REASON_DISPATCH_TIMEOUT`` drops,
  and a fresh drain thread takes over.  A REAL hang inside a device
  call cannot be cancelled from Python — if it eventually completes,
  its device side effects land but its host accounting is discarded
  (the restart budget bounds how often this can happen);
- a dispatch that raises :class:`~..serving.DispatchFailedError`
  (the degraded-mode ladder's "contained failure") costs neither a
  thread death nor a restart: the batch's rows become recovery drops
  and the loop continues;
- the restart budget caps recovery: once exhausted the runtime goes
  TERMINAL (submit() raises, the error rides every snapshot) —
  exactly the pre-watchdog corpse, but only after the budget proved
  the fault persistent.

The no-silent-loss ledger holds throughout:
``submitted == verdicts + shed + recovery_dropped`` after a drained
stop, with every recovery drop ALSO surfaced as a decoded monitor
DROP event via ``on_recovery_drop`` (retention-bounded, counter
exact) — the same contract admission sheds have.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from . import ServingAlreadyActiveError, validate_serving_config
from ..infra import faults
from .batcher import AdaptiveBatcher, AssembledBatch
from .ingress import IngressQueue
from .stats import ServingStats

# dispatch(hdr [bucket, N_COLS], valid [bucket] bool, n_valid) -> any;
# packed batches (pack=True and the rows were eligible) add a
# packed_meta=(ep, dirn) kwarg and ship hdr as [bucket, 4] wire rows.
# A dispatcher may return a dict with "h2d_bytes" to override the
# link accounting (the sharded path re-routes and re-packs, so the
# bytes that actually crossed differ from the assembled hdr's size).
DispatchFn = Callable[[np.ndarray, np.ndarray, int], Optional[dict]]
# on_shed(retained header rows or None, exact shed count) -> None
ShedFn = Callable[[Optional[np.ndarray], int], None]
# on_recovery_drop(wide rows or None, exact count, REASON_*) -> None:
# the recovery plane's event + metricsmap surfacing (rows may be
# fewer than count when a lost batch could not be reconstructed)
RecoveryFn = Callable[[Optional[np.ndarray], int, int], None]

# idle wait granularity: how long the loop sleeps when rows are
# pending but neither bucket-full nor deadline has fired yet.  Small
# enough that a max-wait deadline is honored within ~1ms.
_TICK_S = 0.001
# default consumer-idle wait (queue empty).  Overridable per runtime:
# the daemon derives it from the dispatch deadline so watchdog
# deadlines shorter than this are actually honorable — a loop asleep
# in a 50ms wait cannot notice stop/generation churn any faster.
DEFAULT_IDLE_WAIT_S = 0.05
_BACKOFF_CAP_S = 1.0


class ServingRuntime:
    """start() -> submit() from any thread -> stop(drain=True).

    ``dispatch`` is the device leg (``Daemon.serve_batch``); the
    runtime never imports the agent so the serving plane stays a
    leaf package."""

    def __init__(self, dispatch: DispatchFn, queue_depth: int,
                 bucket_ladder, max_wait_us: float,
                 overflow_policy: str = "drop-tail",
                 on_shed: Optional[ShedFn] = None,
                 expected_cols: Optional[int] = None,
                 pack: bool = False,
                 arena_depth: Optional[int] = None,
                 dispatch_deadline_s: float = 0.0,
                 restart_budget: int = 0,
                 restart_backoff_s: float = 0.01,
                 idle_wait_s: float = DEFAULT_IDLE_WAIT_S,
                 on_recovery_drop: Optional[RecoveryFn] = None,
                 gauge_fn: Optional[Callable[[], dict]] = None,
                 idle_fn: Optional[Callable[[], None]] = None,
                 on_restart: Optional[Callable[[str, bool], None]]
                 = None,
                 profile_dir: Optional[str] = None,
                 dispatch_super: Optional[Callable] = None,
                 superbatch_k: int = 1,
                 pin: bool = False):
        from .batcher import DEFAULT_ARENA_DEPTH

        if profile_dir:
            raise NotImplementedError(
                "the batch-scoped profiler capture window is not ported "
                "yet (ROADMAP A14)")

        depth, ladder, wait, policy = validate_serving_config(
            queue_depth, bucket_ladder, max_wait_us, overflow_policy)
        self.queue = IngressQueue(depth, policy)
        # pack: assemble eligible IPv4 single-stream batches as the
        # 16 B/packet wire format; arena_depth: the staging-slot
        # recycling horizon — MUST exceed however many in-flight
        # batches the dispatcher retains (batcher.py module doc); pin:
        # the slots live in pinned host memory (the card's staging)
        self.batcher = AdaptiveBatcher(
            ladder, wait, pack=pack,
            arena_depth=arena_depth or DEFAULT_ARENA_DEPTH, pin=pin)
        self.stats = ServingStats()
        self._dispatch = dispatch
        # K-batch superbatch dispatch: when armed
        # (dispatch_super given AND superbatch_k > 1) the drain loop
        # assembles up to K ready batches per device dispatch —
        # Python dispatch cost amortized K-fold.  superbatch_k is
        # MUTABLE from the ladder (a K-shrink demotion writes it, the
        # drain loop reads it once per assembly — benign int race,
        # next assembly sees the new K)
        self._dispatch_super = dispatch_super
        self.superbatch_k = max(int(superbatch_k), 1)
        self._on_shed = on_shed
        self._on_recovery_drop = on_recovery_drop
        # row width the datapath expects (N_COLS): a malformed chunk
        # must bounce off submit() with a ValueError, not detonate
        # inside the drain thread batches later
        self._expected_cols = expected_cols
        # fault-tolerance knobs (module doc): budget 0 = unsupervised
        # (legacy: a dead loop is a terminal, visible corpse)
        self._deadline_s = max(float(dispatch_deadline_s), 0.0)
        self._budget = max(int(restart_budget), 0)
        self._backoff_s = max(float(restart_backoff_s), 0.0)
        self._idle_wait_s = max(float(idle_wait_s), _TICK_S)
        self._supervised = self._budget > 0
        self._error: Optional[str] = None  # drain-loop fault (the
        # watchdog clears it on recovery; terminal once the budget is
        # exhausted or when unsupervised)
        self._killed = False  # kill() crash stop: terminal, no drain
        self._stop = threading.Event()
        # serializes submit() against stop()'s final drain: a chunk
        # offered after the drain swept the queue would sit there
        # forever — neither dispatched nor shed-counted
        self._submit_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._watchdog: Optional[threading.Thread] = None
        # recovery bookkeeping, guarded by _rec_lock: the drain-thread
        # GENERATION (an abandoned generation exits without touching
        # stats), the IN-FLIGHT batch (registered before the device
        # leg so a death/hang between "rows left the queue" and "stats
        # recorded" can always be accounted), and the restart count.
        self._rec_lock = threading.Lock()
        # guarded-by: _rec_lock: _gen, _inflight, _warm_shapes, _warm_gen
        self._gen = 0
        # (gen, t0, batch, deadline_exempt, warm_gen)
        self._inflight: Optional[tuple] = None
        # shapes that completed a dispatch: the FIRST dispatch of a
        # (bucket, format) pays first-use costs — unbounded wall time
        # that must not read as a hung device (the watchdog would
        # restart-storm through the budget deadlining compiles).  A
        # hang on a genuinely cold shape is the one blind spot; every
        # warm-shape dispatch is deadlined.  _warm_gen invalidates the
        # set on a mode change — see reset_warm_shapes.
        self._warm_shapes: set = set()
        self._warm_gen = 0
        self.restarts = 0
        # arrivals of the batch currently executing on device: its
        # end-to-end completion is stamped when the NEXT dispatch
        # returns (the device runs batches in order, so by then batch
        # N's events have been appended)
        self._prev_arrivals: List[Tuple[int, float]] = []
        # idle-tick gauges (arena occupancy + whatever the owner's
        # gauge_fn adds) land in stats.gauges; gauges that must stay
        # fresh under load (queue backlog, in-flight window) are read
        # live by the metrics registry instead — the idle tick only
        # fires when the queue is empty
        self._gauge_fn = gauge_fn
        # idle_fn runs in the drain loop's queue-empty branch (drain-
        # thread context, same as dispatch): the owner's chance to
        # tick work that otherwise only advances per-dispatch — the
        # daemon drains pending event windows here, so ring events
        # flush when traffic PAUSES instead of
        # waiting for the next drain_every-th batch that may never
        # come
        self._idle_fn = idle_fn
        # INCIDENT HOOK POINT (obs/flightrec.py): on_restart(cause,
        # terminal) fires from the WATCHDOG thread on every
        # drain-loop restart (terminal=False) and once more when the
        # restart budget exhausts (terminal=True) — the daemon wires
        # it to the flight recorder so each recovery event leaves a
        # sysdump bundle behind.  Contained: a failing hook must not
        # cost the restart it describes
        self._on_restart = on_restart

    # -- producer side (any thread) -----------------------------------
    def submit(self, rows: np.ndarray,
               t: Optional[float] = None) -> int:
        # thread-affinity: any
        """Offer a chunk of header rows; returns how many were
        admitted.  Never blocks on the datapath: overflow sheds by
        the configured policy and is surfaced as counted monitor DROP
        events.  Raises after :meth:`stop` — a post-drain chunk would
        queue forever, neither dispatched nor shed-counted.

        Under supervision a dead drain loop does NOT bounce submits:
        the queue is intact, the watchdog is restarting the consumer,
        and producers should not see a blip the supervisor will heal.
        Only a TERMINAL fault (unsupervised death, or restart budget
        exhausted) raises."""
        from . import ServingError, ServingNotStartedError

        rows = np.asarray(rows)
        if rows.ndim != 2 or not np.issubdtype(rows.dtype,
                                               np.integer):
            raise ValueError(
                "submit() wants [n, N_COLS] integer header rows, got "
                f"shape {rows.shape} dtype {rows.dtype}")
        if (self._expected_cols is not None
                and rows.shape[1] != self._expected_cols):
            raise ValueError(
                f"submit() wants {self._expected_cols}-column header "
                f"rows, got {rows.shape[1]}")
        with self._submit_lock:
            if self._error is not None and self._terminal():
                raise ServingError(
                    f"serving drain loop died: {self._error}")
            if self._stop.is_set():
                raise ServingNotStartedError(
                    "serving runtime is stopped")
            offered = len(rows)
            accepted = self.queue.offer(rows, t)
            self.stats.record_submit(offered, accepted)
            return accepted

    def _terminal(self) -> bool:
        return (self._killed or not self._supervised
                or self.restarts >= self._budget)

    def _gen_is(self, gen: int) -> bool:
        """Locked read of the drain-thread generation — the loop's
        am-I-still-the-owner check.  A bare ``self._gen == gen`` read
        was benign on CPython but violated the guarded-by contract;
        the authoritative checks in ``_dispatch_one`` stay where they
        were."""
        with self._rec_lock:
            return self._gen == gen

    def reset_warm_shapes(self) -> None:
        # thread-affinity: drain, api
        """Forget which shapes have compiled — call after a dispatch
        MODE change (ladder demotion/promotion): the same bucket then
        maps to a different executable, and its first dispatch pays a
        fresh compile the deadline must not misread as a hang.  The
        CURRENTLY in-flight dispatch (the demotion-triggering batch
        being retried on the new rung) goes cold too — its retry pays
        the new rung's compile under the old registration, and its
        completion must NOT warm the shape for the NEW mode (the
        warm-generation bump makes _dispatch_one skip the add)."""
        with self._rec_lock:
            self._warm_shapes.clear()
            self._warm_gen += 1
            if self._inflight is not None:
                gen, t0, batch, _exempt, wg = self._inflight
                self._inflight = (gen, t0, batch, True, wg)

    # -- lifecycle -----------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        # thread-affinity: api
        if self._thread is not None:
            raise ServingAlreadyActiveError(
                "serving runtime already started")
        self._stop.clear()
        with self._rec_lock:
            gen0 = self._gen
        self._thread = threading.Thread(target=self._loop,
                                        args=(gen0,),
                                        daemon=True,
                                        name="serving-drain")
        self._thread.start()
        if self._supervised:
            # watchdog tick: fine enough that a deadline is detected
            # within ~deadline * 1.25, and a dead thread within ~10ms
            tick = (min(max(self._deadline_s / 4.0, 0.002), 0.05)
                    if self._deadline_s > 0 else 0.01)
            self._watch_tick = tick
            self._watchdog = threading.Thread(target=self._watch,
                                              daemon=True,
                                              name="serving-watchdog")
            self._watchdog.start()

    def kill(self, cause: str, timeout: float = 60.0) -> dict:
        # thread-affinity: api
        """Simulated crash stop (chaos / cluster node death): no
        drain — queued rows are swept as COUNTED recovery drops, the
        runtime goes terminal (submit raises, the cause rides every
        snapshot), and the returned snapshot closes the ledger over
        the corpse.  The in-flight dispatch, if any, completes or is
        accounted exactly as a stop() would."""
        with self._submit_lock:
            self._stop.set()  # producers bounce from here on; also
            # parks the watchdog before it can clear the error below
            self._killed = True
        if self._error is None:
            self._error = f"killed: {cause}"
        return self.stop(drain=False, timeout=timeout)

    def stop(self, drain: bool = True, timeout: float = 60.0) -> dict:
        # thread-affinity: api
        """Stop the loop; with ``drain`` (default) every queued row is
        batched and dispatched before returning.  Idempotent.
        ``drain=False`` never loses silently either: pending rows are
        swept as counted recovery drops (the kill()/crash path).

        Raises :class:`ServingError` if the loop thread does not exit
        within ``timeout`` (e.g. stuck in a first-dispatch kernel
        build): draining concurrently with a live loop would race
        on the batcher's unsynchronized buffers — the caller retries
        once the dispatch returns.

        After a drain-loop DEATH the queued-but-never-dispatched rows
        are not skipped: they are swept and counted as recovery drops
        (the same fault would fire again if we dispatched them), the
        pending sheds still flush as DROP events, and the last
        completed batch's latency is stamped — the ledger
        ``submitted == verdicts + shed + recovery_dropped`` balances
        exactly even for a stop over a corpse."""
        from . import ServingError

        with self._submit_lock:  # in-flight submit finishes or fails
            self._stop.set()
        w = self._watchdog
        if w is not None:
            w.join(timeout=5.0)
            self._watchdog = None
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise ServingError(
                    f"serving drain loop still running after "
                    f"{timeout}s (dispatch in flight?); retry stop()")
            self._thread = None
        # a batch registered in flight but never accounted means the
        # thread died (or was abandoned) between dequeue and stats —
        # account it now, before the ledger below is read
        with self._rec_lock:
            inflight, self._inflight = self._inflight, None
            self._gen += 1
            gen = self._gen
        if inflight is not None:
            self._account_lost(inflight[2], timeout_flavor=False)
        if drain and self._error is None and not self._killed:
            # the loop thread has exited; dispatch stays serialized.
            while True:
                batch = self.batcher.assemble(self.queue, force=True)
                if batch is None:
                    break
                self._dispatch_one(batch, gen)
        else:
            # dead loop / crash stop: the same fault would fire again
            # (or the operator asked for no drain) — sweep the queue
            # into counted recovery drops instead (no silent loss;
            # the error rides the snapshot)
            self._sweep_queue_as_recovery_drops()
        if self._prev_arrivals:
            self.stats.record_completion(self._prev_arrivals,
                                         time.monotonic())
            self._prev_arrivals = []
        self._flush_sheds()
        return self.snapshot()

    def snapshot(self) -> dict:
        # thread-affinity: any
        out = self.stats.snapshot(queue_pending=self.queue.pending,
                                  queue_depth=self.queue.capacity)
        if self._error is not None:
            out["error"] = self._error
        ft = out.get("fault-tolerance")
        if ft is not None:
            ft["supervised"] = self._supervised
            ft["restart-budget"] = self._budget
            ft["dispatch-deadline-ms"] = round(self._deadline_s * 1e3,
                                               3)
        return out

    # -- the drain loop ------------------------------------------------
    def _loop(self, gen: int) -> None:
        # thread-affinity: drain
        try:
            self._loop_body(gen)
        except Exception as e:  # noqa: BLE001 — a dying drain thread
            # must leave a visible corpse: the watchdog (when armed)
            # accounts + restarts from here; otherwise submit() raises
            # from here on, serving_stats() carries the fault, and
            # stop() sweeps instead of draining
            with self._rec_lock:
                if self._gen != gen:
                    return  # abandoned generation: already accounted
            self._error = f"{type(e).__name__}: {e}"

    def _loop_body(self, gen: int) -> None:
        # thread-affinity: drain
        from .batcher import SuperBatch

        while not self._stop.is_set() and self._gen_is(gen):
            k_max = self.superbatch_k
            if k_max > 1 and self._dispatch_super is not None:
                batch = self.batcher.assemble_super(self.queue,
                                                    k_max)
            else:
                batch = self.batcher.assemble(self.queue)
            if batch is not None:
                if isinstance(batch, SuperBatch):
                    self._dispatch_one_super(batch, gen)
                else:
                    self._dispatch_one(batch, gen)
                continue
            # idle: stamp the last batch's completion now rather than
            # at the next dispatch (which may never come — an idle
            # hour must not be recorded as that batch's latency at
            # stop).  Approximate on async backends: its dispatch has
            # returned, residual device work is bounded by the drain
            # cadence.
            if self._prev_arrivals:
                self.stats.record_completion(self._prev_arrivals,
                                             time.monotonic())
                self._prev_arrivals = []
            self._flush_sheds()
            if self.queue.pending:
                # rows are waiting but neither full-bucket nor
                # deadline fired: sleep toward the deadline.  An
                # ALREADY-EXPIRED deadline (0.0 — it can expire
                # between the assemble above and here) loops straight
                # back to flush; the old `min(ttd, tick) or tick`
                # turned that 0 into a full tick of tail latency on
                # every deadline flush.
                ttd = self.batcher.time_to_deadline(self.queue)
                if ttd > 0.0:
                    # hot-path-ok: the bounded idle tick — rows are
                    # waiting but neither full-bucket nor deadline
                    # fired; sleeping toward the deadline IS the
                    # batching policy, capped at _TICK_S
                    time.sleep(min(ttd, _TICK_S))
            else:
                # the idle tick: the registry-backed gauges (queue
                # depth, arena occupancy, in-flight window) sample
                # here — off the dispatch path, at the idle cadence
                self._sample_gauges()
                if self._idle_fn is not None:
                    try:
                        self._idle_fn()
                    except Exception:  # noqa: BLE001 — an idle hook
                        pass  # must never kill the drain loop
                self.queue.wait_nonempty(self._idle_wait_s)

    def _dispatch_one(self, batch: AssembledBatch, gen: int) -> None:
        # thread-affinity: drain, api -- stop()'s final drain runs here
        from . import DispatchFailedError

        t0 = time.monotonic()
        shape = (batch.hdr.shape, batch.packed)
        # register BEFORE the device leg: a death or hang from here on
        # can always be accounted by the watchdog / stop()
        with self._rec_lock:
            self._inflight = (gen, t0, batch,
                              shape not in self._warm_shapes,
                              self._warm_gen)
        # injection sites: a raise kills this thread (dead-thread
        # recovery); a hang (~S) wedges it past the dispatch deadline
        faults.check(faults.SITE_SERVING_DISPATCH,
                     abort=lambda: (not self._gen_is(gen)
                                    or self._stop.is_set()))
        with self._rec_lock:
            if self._gen != gen:
                # deadlined while wedged: the watchdog already
                # accounted this batch and a successor owns the loop —
                # do NOT dispatch (the device never saw these rows)
                return
        try:
            if batch.packed:
                info = self._dispatch(batch.hdr, batch.valid,
                                      batch.n_valid,
                                      packed_meta=(batch.ep,
                                                   batch.dirn))
            else:
                info = self._dispatch(batch.hdr, batch.valid,
                                      batch.n_valid)
        except DispatchFailedError:
            # contained device-leg failure (degraded-mode ladder):
            # the batch is lost but counted; the loop lives on
            self.stats.record_dispatch_failure()
            with self._rec_lock:
                mine = (self._inflight is not None
                        and self._inflight[0] == gen)
                if mine:
                    self._inflight = None
            if mine:
                self._account_lost(batch, timeout_flavor=False)
            self._flush_sheds()
            return
        t1 = time.monotonic()
        with self._rec_lock:
            if self._gen != gen:
                # a real hang that eventually completed after the
                # watchdog recovered: device effects landed, but the
                # rows were already accounted as timeout drops —
                # recording them again would double-count
                return
            inflight, self._inflight = self._inflight, None
            # skip the warm-add when a ladder transition happened
            # while this dispatch ran: the shape key now names a
            # DIFFERENT executable, and warming it would let the new
            # mode's first compile be misread as a hang
            if (inflight is not None
                    and inflight[4] == self._warm_gen):
                self._warm_shapes.add(shape)
        # the dispatcher knows best what crossed the link: the
        # sharded leg re-packs AFTER flow routing, so the assembled
        # batch's format/size can differ from the shipped one
        h2d, packed = None, batch.packed
        if isinstance(info, dict):
            h2d = info.get("h2d_bytes")
            if "mode" in info:
                packed = "packed" in info["mode"]
        self.stats.record_batch(batch.n_valid, len(batch.hdr),
                                batch.arrivals, t0, packed=packed,
                                h2d_bytes=(h2d if h2d is not None
                                           else batch.hdr.nbytes))
        self.stats.record_dispatch(1)
        if self._prev_arrivals:
            self.stats.record_completion(self._prev_arrivals, t1)
        self._prev_arrivals = batch.arrivals
        self._flush_sheds()

    def _dispatch_one_super(self, sb, gen: int) -> None:
        # thread-affinity: drain
        """The K-batch flavor of :meth:`_dispatch_one`: same
        registration / generation / warm-shape / accounting
        discipline, one device dispatch for ``sb.k`` batches.  The
        in-flight registration carries the whole SuperBatch, so a
        death or hang accounts all K batches' rows exactly like a
        single lost batch would."""
        from . import DispatchFailedError

        t0 = time.monotonic()
        shape = (sb.hdr.shape, sb.packed)
        with self._rec_lock:
            self._inflight = (gen, t0, sb,
                              shape not in self._warm_shapes,
                              self._warm_gen)
        faults.check(faults.SITE_SERVING_DISPATCH,
                     abort=lambda: (not self._gen_is(gen)
                                    or self._stop.is_set()))
        with self._rec_lock:
            if self._gen != gen:
                return  # deadlined while wedged (see _dispatch_one)
        try:
            info = self._dispatch_super(sb)
        except DispatchFailedError:
            self.stats.record_dispatch_failure()
            with self._rec_lock:
                mine = (self._inflight is not None
                        and self._inflight[0] == gen)
                if mine:
                    self._inflight = None
            if mine:
                self._account_lost(sb, timeout_flavor=False)
            self._flush_sheds()
            return
        t1 = time.monotonic()
        with self._rec_lock:
            if self._gen != gen:
                return  # late wake after watchdog recovery
            inflight, self._inflight = self._inflight, None
            if (inflight is not None
                    and inflight[4] == self._warm_gen):
                self._warm_shapes.add(shape)
        h2d, packed, n_disp = None, sb.packed, 1
        if isinstance(info, dict):
            h2d = info.get("h2d_bytes")
            if "mode" in info:
                # recompute the wire format from what actually
                # shipped: a mode-demoted per-step retry of a packed
                # superbatch ships WIDE rows (same recompute the
                # single-batch path does)
                packed = "packed" in info["mode"]
            # a demoted retry ran K single dispatches, not one fused
            # one — the dispatch scoreboard must count what happened
            n_disp = int(info.get("dispatches", 1))
        # per-step batch accounting keeps every existing counter's
        # meaning (batches counts INNER batches); the dispatch
        # amortization shows up in dispatches/batches-per-dispatch.
        # h2d bytes for the whole superbatch land on step 0.
        total_h2d = h2d if h2d is not None else sb.hdr.nbytes
        for k in range(sb.k):
            self.stats.record_batch(
                sb.bucket, sb.bucket,
                sb.arrivals if k == 0 else [], t0, packed=packed,
                h2d_bytes=total_h2d if k == 0 else 0)
        self.stats.record_dispatch(sb.k, rows_real=sb.n_valid,
                                   rows_shipped=sb.k * sb.bucket,
                                   dispatches=n_disp)
        if self._prev_arrivals:
            self.stats.record_completion(self._prev_arrivals, t1)
        self._prev_arrivals = sb.arrivals
        self._flush_sheds()

    # -- gauges ----------------------------------------------------------
    def _sample_gauges(self) -> None:
        # thread-affinity: drain
        # queue backlog/depth deliberately NOT copied here: the idle
        # tick only fires when the queue is empty, so a sampled copy
        # would read ~0 during exactly the overload episodes a
        # backlog gauge exists for — the registry reads them live.
        # Arena occupancy iterates the slot dict, which only this
        # (drain) thread may do safely, hence the sampled copy
        occ = self.batcher.arena.occupancy()
        g = {"arena-shapes": occ["shapes"],
             "arena-bytes": occ["bytes"]}
        if self._gauge_fn is not None:
            try:
                g.update(self._gauge_fn())
            except Exception:  # noqa: BLE001 — a gauge hook must
                pass  # never kill the drain loop
        g["sampled-at"] = time.monotonic()
        self.stats.gauges = g  # whole-dict swap: no torn reads

    def _flush_sheds(self) -> None:
        # thread-affinity: drain, api
        rows, count = self.queue.take_sheds()
        if count == 0:
            return
        if self._on_shed is not None:
            self._on_shed(rows, count)
        self.stats.record_sheds(count,
                                len(rows) if rows is not None else 0)

    # -- the recovery plane (watchdog thread + stop path) --------------
    def _watch(self) -> None:
        # thread-affinity: watchdog
        """Supervise the drain thread: restart a dead one, deadline a
        hung dispatch, account every lost row.  Exits when the stop
        flag rises or the restart budget is exhausted."""
        backoff = self._backoff_s
        while not self._stop.wait(self._watch_tick):
            if self._stop.is_set():
                return  # stop raced the tick: not a death
            t = self._thread
            dead = (self._error is not None
                    or (t is not None and not t.is_alive()
                        and not self._stop.is_set()))
            hung = False
            if not dead and self._deadline_s > 0:
                with self._rec_lock:
                    inflight = self._inflight
                    hung = (inflight is not None
                            and inflight[0] == self._gen
                            and not inflight[3]  # cold-shape compile
                            and (time.monotonic() - inflight[1]
                                 > self._deadline_s))
            if not dead and not hung:
                backoff = self._backoff_s  # healthy: backoff re-arms
                continue
            cause = (self._error
                     or ("dispatch exceeded deadline "
                         f"{self._deadline_s * 1e3:.0f}ms" if hung
                         else "drain thread died"))
            if self.restarts >= self._budget:
                # budget exhausted: go terminal with a visible corpse
                self._error = (f"restart budget ({self._budget}) "
                               f"exhausted; last fault: {cause}")
                self._notify_restart(self._error, terminal=True)
                return
            # abandon the current generation (a wedged thread that
            # ever wakes will exit without dispatching or recording)
            # and account its in-flight batch
            with self._rec_lock:
                self._gen += 1
                gen = self._gen
                inflight, self._inflight = self._inflight, None
            # record the restart AT detection (the observable tests
            # and operators time against), then account: the first
            # accounting pays a one-time metricsmap-op compile that
            # must not read as detection latency
            self._error = None
            self.stats.record_restart(cause, timeout=hung)
            self.restarts += 1
            self._notify_restart(cause, terminal=False)
            if inflight is not None:
                self._account_lost(inflight[2], timeout_flavor=hung)
            if self._stop.wait(backoff):  # exponential, stop-aware
                return
            backoff = min(backoff * 2 if backoff else self._backoff_s,
                          _BACKOFF_CAP_S)
            t = threading.Thread(target=self._loop, args=(gen,),
                                 daemon=True,
                                 name=f"serving-drain-r{self.restarts}")
            self._thread = t
            t.start()

    def _notify_restart(self, cause: str, terminal: bool) -> None:
        # thread-affinity: watchdog
        """Fire the incident hook (watchdog thread); contained."""
        if self._on_restart is None:
            return
        try:
            self._on_restart(cause, terminal)
        except Exception:  # noqa: BLE001 — an incident hook must
            pass  # never cost the recovery it describes

    def _account_lost(self, batch,
                      timeout_flavor: bool) -> None:
        # thread-affinity: drain, watchdog, api
        """One lost batch (or SuperBatch — all K inner batches) ->
        counted recovery drops + decoded DROP events.
        ``timeout_flavor`` picks REASON_DISPATCH_TIMEOUT (watchdog
        deadline) over REASON_RECOVERY_DROP."""
        from ..datapath.verdict import (REASON_DISPATCH_TIMEOUT,
                                        REASON_RECOVERY_DROP)
        from .batcher import SuperBatch

        sup = isinstance(batch, SuperBatch)
        n = batch.n_valid
        if n == 0:
            return
        rows: Optional[np.ndarray] = None
        try:
            # the batcher emits prefix-valid buckets; reconstruct wide
            # rows for event synthesis (COPY — the hdr is an arena
            # slot that recycles under the next generation)
            if sup and batch.packed:
                from ..core.packets import unpack_rows_np

                rows = np.concatenate([
                    unpack_rows_np(np.asarray(batch.hdr[k]),
                                   int(batch.eps[k]),
                                   int(batch.dirns[k]))
                    for k in range(batch.k)])
            elif sup:
                rows = np.array(batch.hdr, copy=True).reshape(
                    n, batch.hdr.shape[2])
            elif batch.packed:
                from ..core.packets import unpack_rows_np

                rows = unpack_rows_np(np.asarray(batch.hdr[:n]),
                                      batch.ep, batch.dirn)
            else:
                rows = np.array(batch.hdr[:n], copy=True)
        except Exception:  # noqa: BLE001 — accounting must not die on
            rows = None  # a corrupt lost batch; the COUNT stays exact
        reason = (REASON_DISPATCH_TIMEOUT if timeout_flavor
                  else REASON_RECOVERY_DROP)
        self.stats.record_recovery_drops(
            n, timeout=timeout_flavor,
            events=len(rows) if rows is not None else 0)
        if self._on_recovery_drop is not None:
            self._on_recovery_drop(rows, n, reason)

    def _sweep_queue_as_recovery_drops(self) -> None:
        # thread-affinity: api
        """stop() over a dead loop: queued-but-never-dispatched rows
        become counted recovery drops (REASON_RECOVERY_DROP) instead
        of silently vanishing with the queue object."""
        from ..datapath.verdict import REASON_RECOVERY_DROP

        pending = self.queue.pending
        if pending == 0:
            return
        rows, _arrivals = self.queue.take(pending)
        n = len(rows)
        self.stats.record_recovery_drops(n, timeout=False, events=n)
        if self._on_recovery_drop is not None and n:
            self._on_recovery_drop(np.array(rows, copy=True), n,
                                   REASON_RECOVERY_DROP)
