"""Versioned device table publication.

Reference: upstream cilium's SelectorCache-driven incremental updates
mutate pinned BPF maps while traffic flows — the datapath always sees
either the pre-change or the post-change entry, never a torn hybrid.
The dense tables (verdict tensor, LPM, ep_policy, auth) get the same
guarantee here: this module is the publication protocol every table
mutation in ``datapath/loader.py`` goes through.  Adapted from the JAX
package's module; the lock is a plain ``threading.Lock``.

- BUILD OFF THE DISPATCH PATH: builders assemble the successor tables
  (host compile and staging uploads) with only the BUILD lock held,
  never the loader's dispatch lock.
- ONE FLIP: publication is :meth:`flip` — a monotonic ``generation``
  bump — executed while the caller holds the loader's dispatch lock
  and swaps the loader's state, so a concurrent serving dispatch sees
  either the old tables or the new ones, whole.
- NO SLOT PAIR: the JAX package keeps the previous generation's
  bundle in a spare slot because donation recycles its buffers.  Here
  nothing reads a previous generation: an ATTACH replaces the tensors
  (a step already enqueued on the loader's stream still reads the old
  ones, and the caching allocator reuses their memory only after the
  stream has passed it), and a PATCH writes the live tensors in place
  with the ``dus`` kernel, ordered after every step enqueued before it.

A failed build (an exception anywhere before :meth:`flip`, including
the ``churn.build`` / ``churn.swap`` fault sites) leaves the
generation and every published table byte exactly as they were.

Builders serialize on :attr:`build_lock` (lock order: the build lock
BEFORE the loader's dispatch lock — the publish step takes the
dispatch lock while holding the build lock, never the reverse).
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from typing import Optional

from ..serving.stats import LatencyHistogram


class _Build:
    """Handle for one builder pass (see :meth:`TableVersioner.building`).
    ``published`` carries the generation the pass flipped to, or None
    when the builder bailed out without publishing."""

    __slots__ = ("t0", "published")

    def __init__(self, t0: float):
        self.t0 = t0
        self.published: Optional[int] = None


class TableVersioner:
    """Monotonic generation tag, builder lock and publish statistics.

    Written by builder threads (API / regeneration / allocator
    observers) under :attr:`build_lock`; the flip itself additionally
    runs under the loader's dispatch lock.  Counters and histograms
    are read lock-free by stats scrapes (single-writer ints and log2
    buckets)."""

    def __init__(self, warn_ms: float = 0.0):
        # serializes builders end to end (compute + publish + mirror
        # writes); the flip additionally holds the dispatch lock
        self.build_lock = threading.Lock()
        self.generation = 0  # monotonic; bumps ONLY at flip
        self.swaps = 0
        self.last_swap_us: Optional[float] = None
        # dispatch-lock hold for one flip (the drain thread's swap
        # stall ceiling) and mutation-entry -> published latency (the
        # operator-visible "policy update latency")
        self.swap_stall = LatencyHistogram()
        self.update_visible = LatencyHistogram()
        # delta-compile scoreboard (TorchLoader.attach)
        self.full_attaches = 0
        self.delta_attaches = 0
        self.policies_recompiled = 0
        self.patches = 0  # in-place row/LPM patch publishes
        self.failed_builds = 0  # builder passes that raised
        # slow-swap warning budget (policy_swap_warn_ms; 0 = off)
        self.warn_ms = float(warn_ms)

    # -- builder side ---------------------------------------------------
    @contextmanager
    def building(self):
        """One serialized builder pass.  Records update-visible latency
        on publish, counts a failed build on exception (an exception
        before the flip leaves the active generation untouched)."""
        t0 = time.monotonic()  # BEFORE the lock: update-visible
        # latency includes waiting behind a slow builder ahead in line
        with self.build_lock:
            b = _Build(t0)
            try:
                yield b
            except BaseException:
                self.failed_builds += 1
                raise
            if b.published is not None:
                self.update_visible.record(
                    (time.monotonic() - b.t0) * 1e6)

    def flip(self, build: _Build, t_lock: float) -> int:
        """Publish: bump the generation and record the stall.  ``t_lock``
        is when the caller acquired the dispatch lock — the stall clock.
        MUST be called with the loader's dispatch lock held, right after
        the loader swapped in the successor tables."""
        self.generation += 1
        self.swaps += 1
        stall_us = (time.monotonic() - t_lock) * 1e6
        self.last_swap_us = round(stall_us, 3)
        self.swap_stall.record(stall_us)
        build.published = self.generation
        if self.warn_ms > 0 and stall_us > self.warn_ms * 1e3:
            # operator-armed (policy_swap_warn_ms, default off): fires
            # only when a flip exceeds the configured budget
            logging.getLogger(__name__).warning(
                "table publish held the dispatch lock %.1fms "
                "(policy_swap_warn_ms=%.1f) at generation %d",
                stall_us / 1e3, self.warn_ms, self.generation)
        return self.generation

    # -- read side ------------------------------------------------------
    def snapshot(self) -> dict:
        """The ``tables`` stats block (``Daemon.serving_stats``)."""
        return {
            "generation": self.generation,
            "swaps": self.swaps,
            "last-swap-us": self.last_swap_us,
            "swap-stall-us": self.swap_stall.snapshot(),
            "update-visible-us": self.update_visible.snapshot(),
            "full-attaches": self.full_attaches,
            "delta-attaches": self.delta_attaches,
            "policies-recompiled": self.policies_recompiled,
            "patches": self.patches,
            "failed-builds": self.failed_builds,
        }
