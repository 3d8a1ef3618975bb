"""Debounced trigger: coalesce bursts of requests into one run.

Reference: upstream cilium ``pkg/trigger`` — endpoint regeneration and
policy recalculation are triggered many times in a burst (k8s event
storms) but must run serialized with a minimum interval.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class Trigger:
    def __init__(self, fn: Callable[[], None],
                 min_interval: float = 0.0, name: str = "trigger"):
        self._fn = fn
        self._min_interval = min_interval
        self.name = name
        self._lock = threading.Lock()
        self._pending = False
        self._running = False
        self._last_run = 0.0
        self.run_count = 0
        self.fold_count = 0  # requests coalesced into an already-pending run

    def trigger(self) -> None:
        """Request a run.  Synchronous when idle (runs on the calling
        thread); folds into the pending run otherwise."""
        with self._lock:
            if self._running:
                if not self._pending:
                    self._pending = True
                else:
                    self.fold_count += 1
                return
            self._running = True
        while True:
            wait = self._min_interval - (time.time() - self._last_run)
            if wait > 0:
                time.sleep(wait)
            self._fn()
            with self._lock:
                self.run_count += 1
                self._last_run = time.time()
                if self._pending:
                    self._pending = False
                    continue  # somebody asked again while we ran
                self._running = False
                return
