"""Named retry-with-backoff reconciliation loops.

Reference: upstream cilium ``pkg/controller`` — every background
reconciliation (CT GC, kvstore sync, ipcache sync...) runs in a named
``Controller`` with exponential backoff on failure, and their health is
reported in ``cilium status --verbose``.
"""

from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional


@dataclass
class ControllerStatus:
    name: str
    success_count: int = 0
    failure_count: int = 0
    consecutive_failures: int = 0
    last_error: str = ""
    last_success: float = 0.0


class Controller:
    def __init__(self, name: str, fn: Callable[[], None],
                 interval: float, backoff_max: float = 60.0):
        self.status = ControllerStatus(name)
        self._fn = fn
        self._interval = interval
        self._backoff_max = backoff_max
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"ctrl-{self.status.name}")
        self._thread.start()

    def trigger(self) -> None:
        """Run now instead of waiting out the interval."""
        self._wake.set()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=5)

    def run_once(self) -> bool:
        """Synchronous single run (tests; also used by the loop)."""
        try:
            self._fn()
        except Exception:
            self.status.failure_count += 1
            self.status.consecutive_failures += 1
            self.status.last_error = traceback.format_exc(limit=3)
            return False
        self.status.success_count += 1
        self.status.consecutive_failures = 0
        self.status.last_error = ""
        self.status.last_success = time.time()
        return True

    def _run(self) -> None:
        while not self._stop.is_set():
            ok = self.run_once()
            wait = self._interval if ok else min(
                self._interval * (2 ** self.status.consecutive_failures),
                self._backoff_max)
            self._wake.wait(timeout=wait)
            self._wake.clear()


class ControllerManager:
    def __init__(self):
        self._controllers: Dict[str, Controller] = {}
        _MANAGERS.add(self)

    def update(self, name: str, fn: Callable[[], None],
               interval: float) -> Controller:
        self.remove(name)
        c = Controller(name, fn, interval)
        self._controllers[name] = c
        c.start()
        return c

    def get(self, name: str) -> Optional[Controller]:
        return self._controllers.get(name)

    def remove(self, name: str) -> None:
        c = self._controllers.pop(name, None)
        if c:
            c.stop()

    def stop_all(self) -> None:
        # a controller stopped mid-run may re-arm another (map pressure
        # re-schedules CT GC): sweep until none is left
        while self._controllers:
            for name in list(self._controllers):
                self.remove(name)

    def statuses(self) -> Dict[str, ControllerStatus]:
        return {n: c.status for n, c in self._controllers.items()}


# Controllers run device work (CT GC) on daemon threads; a thread
# caught mid-kernel-launch while the interpreter tears down crashes the
# runtime's C++ destructors (std::terminate).  Stop every live
# controller at interpreter exit — also the correct agent-shutdown
# order (background reconciliation quiesces before the datapath).
import atexit
import weakref

_MANAGERS: "weakref.WeakSet[ControllerManager]" = weakref.WeakSet()


def _stop_all_at_exit() -> None:
    for mgr in list(_MANAGERS):
        try:
            mgr.stop_all()
        except Exception:
            pass


atexit.register(_stop_all_at_exit)
