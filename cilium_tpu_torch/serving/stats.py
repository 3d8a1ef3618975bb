"""Serving telemetry: per-batch counters + latency histograms.

The monitor plane streams EVENTS; this module answers the operator
questions events cannot: how long do packets wait for admission, how
much device work is padding, what end-to-end latency do the p95/p99
packets see, and is the runtime keeping up with offered load.
Exposed through ``GET /serving`` and ``cilium-tpu serving stats``.

Histograms are fixed log2 buckets in microseconds (1µs .. ~17min) —
constant memory, lock-cheap to record.  Percentile reads LINEARLY
INTERPOLATE within the winning bucket (the upper bound overstated
p99 by up to 2x at coarse buckets); ``percentile(p, upper=True)``
keeps the conservative bucket-upper-bound read for callers that
want "never better than reality".
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

N_BUCKETS = 30  # 2^30 us ~ 17.9 min: past any sane serving latency


class LatencyHistogram:
    """Log2-bucketed microsecond histogram."""

    def __init__(self):
        self.buckets = [0] * N_BUCKETS
        self.count = 0
        self.max_us = 0.0
        self.total_us = 0.0  # the prometheus histogram _sum

    def record(self, us: float) -> None:
        if us < 0:
            us = 0.0
        idx = min(max(int(us), 0).bit_length(), N_BUCKETS - 1)
        self.buckets[idx] += 1
        self.count += 1
        self.total_us += us
        if us > self.max_us:
            self.max_us = us

    def percentile(self, p: float,
                   upper: bool = False) -> Optional[float]:
        """The p-quantile, linearly interpolated within the winning
        log2 bucket (None when empty).  ``upper=True`` returns the
        bucket's upper bound instead — the conservative read (a
        reported p99 is never better than reality), which the
        default overstated by up to 2x at coarse buckets."""
        if self.count == 0:
            return None
        target = p * self.count
        acc = 0
        for i, c in enumerate(self.buckets):
            if not c:
                continue
            if acc + c >= target:
                # bucket i holds [2^(i-1), 2^i); bucket 0 is [0, 1)
                hi = float(min(1 << i, max(self.max_us, 1.0)))
                if upper:
                    return hi
                lo = float(1 << (i - 1)) if i else 0.0
                hi = min(float(1 << i), max(self.max_us, lo))
                frac = (target - acc) / c
                return lo + frac * (hi - lo)
            acc += c
        return self.max_us

    def snapshot(self) -> Dict[str, Optional[float]]:
        return {
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
            "max": self.max_us if self.count else None,
            "count": self.count,
        }


class ServingStats:
    """Cumulative serving-session telemetry.  Written by the runtime
    thread, snapshot by API/CLI threads — one lock, coarse."""

    def __init__(self):
        self._lock = threading.Lock()
        # guarded-by: _lock: submitted, admitted, shed, shed_events,
        # guarded-by: _lock: batches, verdicts, padded_rows, shapes,
        # guarded-by: _lock: packed_batches, wide_batches, h2d_bytes,
        # guarded-by: _lock: queue_wait, latency, recovery_dropped,
        # guarded-by: _lock: timeout_dropped, recovery_events,
        # guarded-by: _lock: dispatch_failures, dispatch_timeouts,
        # guarded-by: _lock: restarts, last_restart_cause,
        # guarded-by: _lock: last_restart_at
        self.started_at = time.monotonic()
        self.submitted = 0  # packets offered to the queue
        self.admitted = 0  # packets the queue accepted
        self.shed = 0  # packets shed at admission (exact)
        self.shed_events = 0  # shed rows surfaced as DROP events
        self.batches = 0
        self.verdicts = 0  # real (valid) rows dispatched
        self.padded_rows = 0  # padding rows dispatched
        self.shapes: Dict[int, int] = {}  # bucket size -> batches
        # h2d link accounting (the 16 B/packet tentpole's scoreboard):
        # batches and bytes per wire format.  Bytes are the hdr tensor
        # actually shipped (packed 16 B/row vs wide 64 B/row,
        # including padding rows — they cross the link too).
        self.packed_batches = 0
        self.wide_batches = 0
        self.h2d_bytes = 0
        # superbatch dispatch scoreboard: device DISPATCHES
        # vs batches — the amortization the K-batch scan buys is
        # batches/dispatches > 1.  Fill tracks real rows vs rows
        # shipped across superbatch dispatches (the round-down
        # assembly keeps every step a full bucket, so fill defends
        # the no-empty-steps design at 1.0).
        # guarded-by: _lock: dispatches, superbatches,
        # guarded-by: _lock: super_rows_real, super_rows_shipped,
        # guarded-by: _lock: super_shapes
        self.dispatches = 0  # device dispatches (single + super)
        self.superbatches = 0  # ...of which carried K > 1 batches
        self.super_rows_real = 0
        self.super_rows_shipped = 0
        self.super_shapes: Dict[int, int] = {}  # K -> dispatches
        self.queue_wait = LatencyHistogram()  # arrival -> dispatch
        self.latency = LatencyHistogram()  # arrival -> events emitted
        # fault-tolerance plane (serving/runtime.py watchdog): the
        # conservation law the chaos suite asserts is
        #   submitted == verdicts + shed + recovery_dropped
        # after a drained stop — every offered row is exactly one of
        # dispatched, shed (either overflow policy), or accounted by
        # recovery (dead/hung/failed dispatch, or queued rows swept at
        # a dead-loop stop).
        self.recovery_dropped = 0  # rows accounted by recovery (all)
        self.timeout_dropped = 0  # ...of which via dispatch deadline
        self.recovery_events = 0  # recovery rows surfaced as DROPs
        self.dispatch_failures = 0  # contained dispatch failures
        self.dispatch_timeouts = 0  # watchdog deadline hits
        self.restarts = 0  # drain-thread restarts
        self.last_restart_cause = ""
        self.last_restart_at: Optional[float] = None  # monotonic
        # point-in-time gauges sampled by the drain loop's idle tick
        # (queue depth, arena occupancy, in-flight window) — written
        # whole-dict by the runtime, read by the metrics registry, so
        # no lock is needed beyond the GIL's dict-swap atomicity
        self.gauges: Dict[str, float] = {}

    # -- recording (runtime thread) -----------------------------------
    def record_submit(self, offered: int, accepted: int) -> None:
        """``accepted`` is what the queue took from THIS chunk.  The
        shed counter is NOT derived from the difference — under
        drop-oldest the queue admits the whole arrival and evicts
        previously-admitted rows instead, so sheds are recorded from
        the queue's own exact accounting (:meth:`record_sheds`)."""
        with self._lock:
            self.submitted += offered
            self.admitted += accepted

    def record_sheds(self, count: int, retained: int) -> None:
        """``count`` exact sheds since the last flush (either policy);
        ``retained`` of them surfaced as DROP events (retention is
        bounded, the counter is not)."""
        with self._lock:
            self.shed += count
            self.shed_events += retained

    def record_batch(self, n_valid: int, bucket: int,
                     arrivals: List[Tuple[int, float]],
                     t_dispatch: float, packed: bool = False,
                     h2d_bytes: int = 0) -> None:
        with self._lock:
            self.batches += 1
            self.verdicts += n_valid
            self.padded_rows += bucket - n_valid
            self.shapes[bucket] = self.shapes.get(bucket, 0) + 1
            if packed:
                self.packed_batches += 1
            else:
                self.wide_batches += 1
            self.h2d_bytes += h2d_bytes
            # chunk-granular: one sample per chunk keeps the record
            # cost O(chunks), not O(packets)
            for count, t in arrivals:
                if count:
                    self.queue_wait.record((t_dispatch - t) * 1e6)

    def record_dispatch(self, batches: int, rows_real: int = 0,
                        rows_shipped: int = 0,
                        dispatches: int = 1) -> None:
        """``dispatches`` DEVICE dispatches carried ``batches`` inner
        batches (1/1 on the single-batch path; K/1 for a fused
        superbatch; K/K for a demoted superbatch retried one step at
        a time — which therefore does NOT count as a superbatch).
        ``rows_real``/``rows_shipped`` feed the fill-efficiency
        read."""
        with self._lock:
            self.dispatches += dispatches
            if batches > 1 and dispatches == 1:
                self.superbatches += 1
                self.super_rows_real += rows_real
                self.super_rows_shipped += rows_shipped
                self.super_shapes[batches] = (
                    self.super_shapes.get(batches, 0) + 1)

    def record_recovery_drops(self, count: int, timeout: bool,
                              events: int = 0) -> None:
        """``count`` rows lost to a dead/hung/failed dispatch (or the
        dead-loop stop sweep), ``events`` of them surfaced as decoded
        DROP events; ``timeout`` marks the watchdog-deadline flavor
        (REASON_DISPATCH_TIMEOUT vs REASON_RECOVERY_DROP)."""
        with self._lock:
            self.recovery_dropped += count
            self.recovery_events += events
            if timeout:
                self.timeout_dropped += count

    def record_dispatch_failure(self) -> None:
        with self._lock:
            self.dispatch_failures += 1

    def record_restart(self, cause: str, timeout: bool) -> None:
        with self._lock:
            self.restarts += 1
            self.last_restart_cause = cause[:200]
            self.last_restart_at = time.monotonic()
            if timeout:
                self.dispatch_timeouts += 1

    def record_completion(self, arrivals: List[Tuple[int, float]],
                          t_done: float) -> None:
        """End-to-end: arrival -> the batch's events emitted to the
        monitor plane (the drain boundary)."""
        with self._lock:
            for _count, t in arrivals:
                self.latency.record((t_done - t) * 1e6)

    # -- reading (API/CLI threads) ------------------------------------
    def snapshot(self, queue_pending: int = 0,
                 queue_depth: int = 0) -> dict:
        with self._lock:
            dt = max(time.monotonic() - self.started_at, 1e-9)
            pad = self.padded_rows
            real = self.verdicts
            return {
                # no "active" key: liveness is the daemon's to report
                # (a snapshot outlives the session that produced it)
                "uptime-seconds": round(dt, 3),
                "submitted": self.submitted,
                "admitted": self.admitted,
                "shed": self.shed,
                "shed-events": self.shed_events,
                # the scenario harness's shed criterion + the
                # operator's first overload read (exact, from the
                # queue's own accounting)
                "shed-fraction": round(self.shed / self.submitted, 4)
                if self.submitted else None,
                "batches": self.batches,
                "verdicts": real,
                "padded-rows": pad,
                "pad-efficiency": round(real / (real + pad), 4)
                if (real + pad) else None,
                "batches-per-sec": round(self.batches / dt, 2),
                "verdicts-per-sec": round(real / dt),
                "batch-shapes": {str(k): v for k, v in
                                 sorted(self.shapes.items())},
                "h2d": {
                    "packed-batches": self.packed_batches,
                    "wide-batches": self.wide_batches,
                    "bytes": self.h2d_bytes,
                    # per REAL packet: padding crosses the link too,
                    # so a mostly-padded session reads honestly worse
                    "bytes-per-packet": round(self.h2d_bytes / real, 2)
                    if real else None,
                },
                # the superbatch scoreboard: batches-per-dispatch is
                # THE amortization number the K-batch scan exists for
                "dispatch": {
                    "dispatches": self.dispatches,
                    "batches-per-dispatch": round(
                        self.batches / self.dispatches, 3)
                    if self.dispatches else None,
                    "superbatches": self.superbatches,
                    "superbatch-shapes": {
                        str(k): v for k, v in
                        sorted(self.super_shapes.items())},
                    "superbatch-fill": round(
                        self.super_rows_real
                        / self.super_rows_shipped, 4)
                    if self.super_rows_shipped else None,
                },
                "queue-pending": queue_pending,
                "queue-depth": queue_depth,
                "gauges": dict(self.gauges),
                "queue-wait-us": self.queue_wait.snapshot(),
                "latency-us": self.latency.snapshot(),
                "fault-tolerance": {
                    "restarts": self.restarts,
                    "dispatch-timeouts": self.dispatch_timeouts,
                    "dispatch-failures": self.dispatch_failures,
                    "recovery-dropped": self.recovery_dropped,
                    "timeout-dropped": self.timeout_dropped,
                    "recovery-events": self.recovery_events,
                    "last-restart-cause": self.last_restart_cause,
                    "seconds-since-restart": (
                        round(time.monotonic()
                              - self.last_restart_at, 3)
                        if self.last_restart_at is not None else None),
                    # the no-silent-loss ledger: exact once the queue
                    # is drained (post-stop) — while running, rows in
                    # the queue / in flight are outside every counter
                    "accounted": (self.verdicts + self.shed
                                  + self.recovery_dropped
                                  + queue_pending),
                },
            }
