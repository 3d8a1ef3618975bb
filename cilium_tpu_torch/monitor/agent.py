"""Monitor agent: fan-out of event batches to subscribers.

Reference: upstream cilium ``pkg/monitor/agent`` — the perf-buffer
reader loop that multiplexes events to unix-socket listeners (the
``cilium monitor`` CLI) and in-process consumers (Hubble).  Here the
"reader loop" is :meth:`MonitorAgent.publish` called by the datapath
loader after each device step with the decoded :class:`EventBatch`;
subscribers receive whole batches (SoA), not per-event callbacks, so
the observability plane stays vectorized end to end.

Lost-event accounting: a slow subscriber does not block the datapath —
batches are dropped for that subscriber past a queue bound and counted
(the perf ring buffer overflow analogue).
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Deque, Dict, List, Optional

from .api import EventBatch

Consumer = Callable[[EventBatch], None]


class MonitorAgent:
    def __init__(self, queue_depth: int = 64):
        self._consumers: Dict[str, Consumer] = {}
        self._queues: Dict[str, Deque[EventBatch]] = {}
        self._lost: Dict[str, int] = {}
        self._queue_depth = queue_depth
        self._lock = threading.Lock()
        # guarded-by: _lock: _consumers, _queues, _lost
        # serializes the publish fan-out across emitting threads
        # (event-join worker + drain thread) — see publish()
        self._emit_lock = threading.RLock()
        # guarded-by: _emit_lock: published
        self.published = 0

    def register(self, name: str, consumer: Consumer) -> None:
        # thread-affinity: any
        """In-process consumer (e.g. the Hubble observer)."""
        with self._lock:
            self._consumers[name] = consumer
            self._lost.setdefault(name, 0)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._consumers.pop(name, None)

    def subscribe_queue(self, name: str) -> Deque[EventBatch]:
        """Pull-style subscriber (CLI streamers poll this queue)."""
        with self._lock:
            q: Deque[EventBatch] = collections.deque(
                maxlen=self._queue_depth)
            self._queues[name] = q
            self._lost.setdefault(name, 0)
            return q

    def unsubscribe_queue(self, name: str) -> None:
        with self._lock:
            self._queues.pop(name, None)

    def publish(self, batch: EventBatch) -> None:
        # thread-affinity: any
        """Called by the loader after each datapath step.

        The fan-out is serialized under ``_emit_lock``: since the
        async event plane ring-event joins publish from the
        event-join WORKER while host-synthesized drops (shed /
        recovery events) still publish from the drain thread, and
        consumers (flow aggregation, metrics dicts) are not
        individually thread-safe.  Reentrant (RLock) so a consumer
        that publishes derived events from its callback cannot
        deadlock itself.

        ``_lost`` increments take ``_lock``: they used to mutate
        under ``_emit_lock`` only, racing the ``setdefault`` in
        ``register``/``subscribe_queue`` (two locks guarding one
        dict can lose an increment on a concurrent first-register —
        the static guarded-by pass surfaced it)."""
        with self._lock:
            consumers = list(self._consumers.items())
            queues = list(self._queues.items())
        with self._emit_lock:
            self.published += len(batch)
            for name, consumer in consumers:
                try:
                    consumer(batch)
                except Exception:
                    # a broken consumer must not take down the
                    # datapath
                    with self._lock:
                        self._lost[name] = (self._lost.get(name, 0)
                                            + len(batch))
            for name, q in queues:
                if q.maxlen is not None and len(q) == q.maxlen:
                    with self._lock:
                        self._lost[name] = (self._lost.get(name, 0)
                                            + len(q[0]))
                q.append(batch)

    def lost_count(self, name: str) -> int:
        # thread-affinity: any
        with self._lock:
            return self._lost.get(name, 0)
