"""Bounded admission queue — the XDP ring / per-CPU ring analogue.

Reference: upstream cilium's front end admits packets into per-CPU
rings sized by ``--...-ring-size``; when producers outrun the
consumer the ring sheds and the drop is COUNTED (the metricsmap's
queue-overflow reason), never silently lost.  Same contract here:
:class:`IngressQueue` bounds admission by packet count, sheds by a
configurable policy, and retains the shed rows (bounded) so the
serving runtime can surface them as monitor DROP events with
``REASON_INGRESS_OVERFLOW``.

Packets arrive as CHUNKS of header rows (``[n, N_COLS] uint32``) —
the arrival unit of a NIC ring doorbell, not a Python object per
packet — so admission is O(chunks), and batch assembly slices numpy
views.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

# retained shed HEADERS are bounded (the counter is always exact):
# an unbounded retention buffer would turn a sustained overload into
# a host OOM — exactly the failure the bounded queue exists to stop
MAX_RETAINED_SHED_ROWS = 1 << 14


class IngressQueue:
    """Bounded FIFO of header-row chunks.

    ``policy``:
      - ``drop-tail`` (default): an arriving chunk that does not fit
        is truncated; the overflow sheds (new traffic pays).
      - ``drop-oldest``: the oldest queued rows shed to make room for
        the arrival (stale traffic pays — the wrap-overwrite ring
        semantics of the monitor plane, applied to admission).
    """

    def __init__(self, capacity: int, policy: str = "drop-tail"):
        if capacity <= 0:
            raise ValueError("ingress queue capacity must be > 0")
        if policy not in ("drop-tail", "drop-oldest"):
            raise ValueError(f"unknown overflow policy {policy!r}")
        self.capacity = int(capacity)
        self.policy = policy
        self._chunks: deque = deque()  # (rows, t_arrival)
        self._pending = 0
        self.admitted = 0  # packets ever admitted
        self.shed = 0  # packets ever shed (exact)
        self._shed_rows: List[np.ndarray] = []  # bounded retention
        self._shed_retained = 0
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        # guarded-by: _lock: _chunks, _pending, admitted, shed,
        # guarded-by: _lock: _shed_rows, _shed_retained

    # -- producer side -------------------------------------------------
    def offer(self, rows: np.ndarray,
              t: Optional[float] = None) -> int:
        # thread-affinity: any
        """Admit a chunk; returns how many of its rows were accepted.
        Sheds (from either end, per policy) are counted and retained
        for drop-event synthesis.

        The queue COPIES what it admits (one vectorized memcpy per
        chunk — exactly a NIC ring copying the frame into ring
        memory): producers refill their chunk buffer the moment
        offer() returns, and a queued view of caller memory would
        silently dispatch the refilled bytes as the earlier
        packets."""
        rows = np.asarray(rows)
        if rows.ndim != 2:
            raise ValueError("offer() wants [n, N_COLS] header rows")
        n = len(rows)
        if n == 0:
            return 0
        if t is None:
            t = time.monotonic()
        with self._nonempty:
            room = self.capacity - self._pending
            if n <= room:
                accepted = n
            elif self.policy == "drop-tail":
                accepted = max(room, 0)
                if accepted < n:
                    self._shed(rows[accepted:])
                rows = rows[:accepted]
            else:  # drop-oldest: evict from the head until it fits
                accepted = min(n, self.capacity)
                if accepted < n:  # chunk larger than the whole queue
                    self._shed(rows[:n - accepted])
                    rows = rows[n - accepted:]
                need = accepted - room
                while need > 0 and self._chunks:
                    old, old_t = self._chunks.popleft()
                    if len(old) <= need:
                        self._shed(old)
                        self._pending -= len(old)
                        need -= len(old)
                    else:
                        self._shed(old[:need])
                        self._chunks.appendleft((old[need:], old_t))
                        self._pending -= need
                        need = 0
            if accepted:
                self._chunks.append((np.array(rows, copy=True), t))
                self._pending += accepted
                self.admitted += accepted
                self._nonempty.notify()
            return accepted

    def _shed(self, rows: np.ndarray) -> None:
        # holds: _lock -- only called from offer()'s locked region
        n = len(rows)
        self.shed += n
        keep = min(n, MAX_RETAINED_SHED_ROWS - self._shed_retained)
        if keep > 0:
            self._shed_rows.append(np.array(rows[:keep]))
            self._shed_retained += keep

    # -- consumer side -------------------------------------------------
    @property
    def pending(self) -> int:
        # thread-affinity: any
        with self._lock:
            return self._pending

    def row_width(self) -> Optional[int]:
        """Column count of the queued rows (None when empty) — the
        batcher sizes its staging scratch from the head chunk."""
        with self._lock:
            if not self._chunks:
                return None
            return self._chunks[0][0].shape[1]

    def oldest_age(self, now: Optional[float] = None) -> float:
        """Seconds the head-of-line chunk has waited (0 when empty)."""
        with self._lock:
            if not self._chunks:
                return 0.0
            head_t = self._chunks[0][1]
        return (now if now is not None else time.monotonic()) - head_t

    def take(self, n: int) -> Tuple[np.ndarray, List[Tuple[int, float]]]:
        # thread-affinity: drain, api
        """Dequeue up to ``n`` rows in FIFO order.

        Returns ``(rows, arrivals)`` where ``arrivals`` is a list of
        ``(count, t_arrival)`` at chunk granularity — the batcher's
        queue-wait / latency accounting input."""
        parts: List[np.ndarray] = []
        arrivals: List[Tuple[int, float]] = []
        got = 0
        with self._lock:
            while got < n and self._chunks:
                rows, t = self._chunks[0]
                want = n - got
                if len(rows) <= want:
                    self._chunks.popleft()
                    parts.append(rows)
                    arrivals.append((len(rows), t))
                    got += len(rows)
                else:
                    parts.append(rows[:want])
                    self._chunks[0] = (rows[want:], t)
                    arrivals.append((want, t))
                    got += want
            self._pending -= got
        if not parts:
            return np.zeros((0, 0), dtype=np.uint32), arrivals
        if len(parts) == 1:
            return parts[0], arrivals
        return np.concatenate(parts), arrivals

    def take_into(self, out: np.ndarray
                  ) -> Tuple[int, List[Tuple[int, float]]]:
        # thread-affinity: drain, api
        """Dequeue up to ``len(out)`` rows in FIFO order DIRECTLY into
        ``out`` (the batcher's staging arena): one vectorized memcpy
        per chunk, no intermediate concatenate — the zero-copy half of
        batch assembly.  Returns ``(n, arrivals)``; ``out[:n]`` holds
        the rows, everything past ``n`` is untouched.

        EXCEPTION-ATOMIC: all copies land before ANY chunk is popped
        (copy first, commit after), so a memcpy fault mid-dequeue —
        the ``serving.queue.take`` injection site, or a real staging
        failure — leaves every row still queued.  A dead drain thread
        then loses nothing: its restart (or the stop-path recovery
        sweep) finds the rows where they were."""
        from ..infra import faults

        n = len(out)
        arrivals: List[Tuple[int, float]] = []
        got = 0
        with self._lock:
            # copy phase: nothing is mutated; a raise here (injected
            # or organic) aborts with the queue intact
            plan: List[int] = []
            pos = 0
            for rows, t in self._chunks:
                if pos >= n:
                    break
                faults.check(faults.SITE_QUEUE_TAKE)
                take = min(len(rows), n - pos)
                out[pos:pos + take] = rows[:take]
                arrivals.append((take, t))
                plan.append(take)
                pos += take
            # commit phase: pure pointer moves, cannot fail
            for take in plan:
                rows, t = self._chunks[0]
                got += take
                if take == len(rows):
                    self._chunks.popleft()
                else:
                    self._chunks[0] = (rows[take:], t)
            self._pending -= got
        return got, arrivals

    def take_sheds(self) -> Tuple[Optional[np.ndarray], int]:
        # thread-affinity: drain, api
        """Drain the shed accounting accumulated since the last call:
        ``(retained header rows or None, exact shed count)``.  The
        count can exceed the row count when retention was capped."""
        with self._lock:
            rows_list, self._shed_rows = self._shed_rows, []
            count = self.shed - getattr(self, "_shed_reported", 0)
            self._shed_reported = self.shed
            self._shed_retained = 0
        if not rows_list:
            return None, count
        rows = (rows_list[0] if len(rows_list) == 1
                else np.concatenate(rows_list))
        return rows, count

    def wait_nonempty(self, timeout: float) -> bool:
        # thread-affinity: drain
        """Block until a chunk is queued (or timeout); the runtime's
        idle wait between deadline checks."""
        with self._nonempty:
            if self._pending:
                return True
            return self._nonempty.wait(timeout) or self._pending > 0
