"""Degraded-mode fallback ladder: sharded -> single-chip -> wide.

Reference: upstream cilium never stops forwarding because a fancier
path broke — endpoints REGENERATE after datapath faults, kvstore
clients fail over to the next endpoint, and health state gates when
traffic returns.  The serving plane's analogue is a ladder of
dispatch modes ordered by capability:

- ``sharded``  — multi-chip flow-routed dispatch;
- ``single``   — single-chip, packed 16 B/packet when eligible;
- ``wide``     — single-chip, wide 64 B/packet rows only (the same
  per-batch fallback shape used for pack-ineligible traffic,
  now pinned as a MODE).

This module is the pure STATE MACHINE (hysteresis + bookkeeping);
``Daemon`` owns the transition mechanics (ring swap, CT snapshot +
restore, loader re-placement).

INCIDENT HOOK POINT (obs/flightrec.py): every demotion is a named
``ladder-demotion`` incident — ``Daemon._serving_demote`` calls
``record_incident`` right after :meth:`FallbackLadder.demote`, so a
rung drop leaves a sysdump bundle (ladder state, recent flows, live
aggregation windows) behind.  The capture runs on a dedicated
capture thread, never the drain thread driving this state machine;
promotions are routine recovery and deliberately NOT incidents.
The other serving-plane hooks live in runtime.py (``on_restart``,
the watchdog) and eventplane.py (``on_terminal``, the join worker).

Rules:

- DEMOTE after ``demote_threshold`` CONSECUTIVE dispatch failures on
  the current rung (one success resets the streak — flapping shards
  must not walk the ladder down);
- PROMOTE one rung after ``promote_after`` consecutive healthy
  batches AND ``cooldown_s`` since the last transition (hysteresis:
  a half-healed mesh that fails again right after re-promotion burns
  a full cooldown before the next attempt);
- the FLOOR rung never demotes away — at the floor, failures are no
  longer containable and escalate to the runtime's restart budget.
"""

from __future__ import annotations

import time
from typing import List, Optional

RUNG_SHARDED = "sharded"
RUNG_SINGLE = "single"
RUNG_WIDE = "wide"
# capability order, best first
RUNG_ORDER = (RUNG_SHARDED, RUNG_SINGLE, RUNG_WIDE)


class FallbackLadder:
    """Hysteresis state machine over the rungs a serving session can
    actually run (built from its start_serving config: no mesh ->
    no ``sharded`` rung; packing disabled -> no ``single`` rung).

    Driven from the drain thread only (record_* / demote / promote);
    reads from API threads are snapshot-style (``to_dict``)."""

    def __init__(self, rungs: List[str], demote_threshold: int = 3,
                 promote_after: int = 64, cooldown_s: float = 5.0,
                 k_ladder=(1,)):
        if not rungs:
            raise ValueError("ladder needs at least one rung")
        order = [r for r in RUNG_ORDER if r in rungs]
        if len(order) != len(rungs):
            raise ValueError(f"unknown rung in {rungs!r}; rungs: "
                             f"{RUNG_ORDER}")
        self.rungs = tuple(order)
        self.rung = self.rungs[0]  # start at the best the config has
        # the superbatch K dimension: K is a RUNG PROPERTY
        # — demotion shrinks K one step before it would ever change
        # mode (a K-related fault costs amortization, not capability),
        # and the floor is the last mode at K=1.  The sharded rung
        # pins K=1 (superbatching is a single-chip dispatch shape;
        # the router re-routes per batch), so sharded sessions walk
        # the K ladder only after demoting off the mesh.  Default
        # (1,) keeps the pre-superbatch ladder byte-identical.
        kl = tuple(sorted(set(int(k) for k in k_ladder)))
        if not kl or kl[0] < 1:
            raise ValueError(f"k_ladder must be >= 1, got {k_ladder!r}")
        self.k_ladder = kl
        self.demote_threshold = int(demote_threshold)
        self.promote_after = int(promote_after)
        self.cooldown_s = float(cooldown_s)
        self._k_idx = len(self._k_options()) - 1  # best K of the rung
        self.fail_streak = 0
        self.ok_streak = 0
        self.demotions = 0
        self.promotions = 0
        self.last_change: Optional[float] = None  # monotonic
        self.last_cause = ""

    def _k_options(self):
        """The K rungs the CURRENT mode can run (sharded pins 1)."""
        return self.k_ladder if self.rung != RUNG_SHARDED else (1,)

    @property
    def k(self) -> int:
        """The superbatch K of the current (mode, K) rung."""
        return self._k_options()[self._k_idx]

    @property
    def at_floor(self) -> bool:
        return self.rung == self.rungs[-1] and self._k_idx == 0

    @property
    def degraded(self) -> bool:
        return (self.rung != self.rungs[0]
                or self._k_idx != len(self._k_options()) - 1)

    def record_failure(self, cause: str = "") -> bool:
        # thread-affinity: drain, api
        """One dispatch failure on the current rung.  Returns True
        when the threshold fired and the caller should demote NOW
        (via :meth:`demote` after performing the mode switch); at the
        floor it always returns False — escalate instead."""
        self.fail_streak += 1
        self.ok_streak = 0
        self.last_cause = cause[:200]
        return (not self.at_floor
                and self.fail_streak >= self.demote_threshold)

    def record_success(self,
                       now: Optional[float] = None) -> bool:
        # thread-affinity: drain, api
        """One healthy dispatch.  Returns True when sustained health
        plus an elapsed cooldown warrant promoting one rung."""
        self.fail_streak = 0
        self.ok_streak += 1
        if not self.degraded:
            return False
        if self.ok_streak < self.promote_after:
            return False
        if self.last_change is not None:
            if now is None:
                now = time.monotonic()
            if now - self.last_change < self.cooldown_s:
                return False
        return True

    def demote(self) -> str:
        # thread-affinity: drain, api
        """Step one (mode, K) rung down; returns the (possibly
        unchanged) mode rung.  K shrinks FIRST: only at K=1 does the
        mode itself demote — entering the next mode at ITS best K
        (the new mode's executables are fresh capability; the K tax
        re-proves itself there)."""
        assert not self.at_floor, "cannot demote past the floor"
        if self._k_idx > 0:
            self._k_idx -= 1
        else:
            i = self.rungs.index(self.rung)
            self.rung = self.rungs[i + 1]
            self._k_idx = len(self._k_options()) - 1
        self.demotions += 1
        self.fail_streak = 0
        self.ok_streak = 0
        self.last_change = time.monotonic()
        return self.rung

    def promote(self) -> str:
        # thread-affinity: drain, api
        """Step one (mode, K) rung up (the exact inverse of
        :meth:`demote`'s walk); returns the mode rung.  K grows back
        to the mode's best before the mode itself promotes, and a
        mode promotion enters the better mode at its SMALLEST K."""
        opts = self._k_options()
        if self._k_idx < len(opts) - 1:
            self._k_idx += 1
        else:
            i = self.rungs.index(self.rung)
            assert i > 0, "already at the top rung"
            self.rung = self.rungs[i - 1]
            self._k_idx = 0
        self.promotions += 1
        self.fail_streak = 0
        self.ok_streak = 0
        self.last_change = time.monotonic()
        return self.rung

    def to_dict(self) -> dict:
        return {
            "rung": self.rung,
            "rungs": list(self.rungs),
            "k": self.k,
            "k-ladder": list(self.k_ladder),
            "degraded": self.degraded,
            "demotions": self.demotions,
            "promotions": self.promotions,
            "fail-streak": self.fail_streak,
            "ok-streak": self.ok_streak,
            "demote-threshold": self.demote_threshold,
            "promote-after": self.promote_after,
            "cooldown-s": self.cooldown_s,
            "last-cause": self.last_cause,
            "seconds-since-change": (
                round(time.monotonic() - self.last_change, 3)
                if self.last_change is not None else None),
        }
