"""Map-pressure monitor + graceful-degradation controller.

Reference: upstream cilium exports per-map pressure gauges
(``cilium_bpf_map_pressure``), runs the conntrack GC on an ADAPTIVE
interval (``pkg/maps/ctmap``: the sweep accelerates while the map is
under pressure and relaxes when it drains), and degrades by counting
drops (``DROP_NAT_NO_MAPPING``) instead of failing.  This repo
already COUNTS those pressures — ``CTTable.dropped`` (failed CT
inserts), ``NATTable.failed`` (SNAT pool exhaustion) — but nothing
reacted to them.  This module is the reaction:

- :class:`MapPressureMonitor` samples the loader's
  :meth:`~cilium_tpu.datapath.loader.Loader.map_pressure` snapshot on
  a named controller (``map-pressure``, the existing
  ``infra/controller`` infra) — OFF the drain thread by construction;
- crossing a threshold (CT occupancy >= ``ct_pressure_threshold``,
  or any NEW insert drops / NAT pool failures inside a sample
  window) enters the PRESSURE state: the CT aging sweep is
  re-scheduled at ``ct_gc_pressure_interval`` (an immediate sweep
  triggered), and ONE ``map-pressure`` incident is recorded (flight-
  recorder capture) per episode — hysteresis (occupancy back under
  ``ct_pressure_clear`` AND a quiet window) exits the state and
  restores the normal cadence, so a storm cannot flap incidents;
- the last sample is cached for the registry collectors
  (``cilium_ct_occupancy`` / ``cilium_ct_insert_drops_total`` /
  ``cilium_nat_pool_failures_total``) and the serving-stats /
  ``GET /serving`` / CLI Pressure block — scrapes never touch the
  device.

Occupancy counts OCCUPIED slots (live + expired-but-unswept): that
is what the map actually has left for inserts, and it is exactly the
number the accelerated sweep visibly drives back down.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

STATE_OK = "ok"
STATE_PRESSURE = "pressure"


def validate_pressure_config(interval_s, ct_threshold, ct_clear,
                             gc_pressure_interval_s) -> tuple:
    """Validate the map-pressure DaemonConfig knobs (the
    validate_serving_config contract: fail at construction)."""
    interval_s = float(interval_s)
    if interval_s < 0:
        raise ValueError("map_pressure_interval must be >= 0 "
                         "(0 disables the monitor)")
    ct_threshold = float(ct_threshold)
    ct_clear = float(ct_clear)
    if not 0.0 < ct_threshold <= 1.0:
        raise ValueError("ct_pressure_threshold must be in (0, 1]")
    if not 0.0 < ct_clear <= ct_threshold:
        raise ValueError("ct_pressure_clear must be in (0, "
                         "ct_pressure_threshold] (the hysteresis "
                         "band)")
    gc_pressure_interval_s = float(gc_pressure_interval_s)
    if gc_pressure_interval_s <= 0:
        raise ValueError("ct_gc_pressure_interval must be > 0")
    return (interval_s, ct_threshold, ct_clear,
            gc_pressure_interval_s)


def validate_relax_config(relax_after_s, relax_factor,
                          relax_max) -> tuple:
    """Validate the adaptive GC-relaxation knobs (same
    fail-at-construction contract)."""
    relax_after_s = float(relax_after_s)
    if relax_after_s < 0:
        raise ValueError("ct_gc_relax_after must be >= 0 "
                         "(0 disables relaxation)")
    relax_factor = float(relax_factor)
    if relax_factor <= 1.0:
        raise ValueError("ct_gc_relax_factor must be > 1 (a "
                         "non-stretching relax step would spin the "
                         "multiplier without changing the cadence)")
    relax_max = float(relax_max)
    if relax_max < relax_factor:
        raise ValueError("ct_gc_relax_max must be >= "
                         "ct_gc_relax_factor (the bound must admit "
                         "at least one step)")
    return relax_after_s, relax_factor, relax_max


class MapPressureMonitor:
    """Samples map pressure, drives the graceful-degradation
    response.  ``sample_fn()`` returns the loader's map_pressure
    snapshot; ``on_accelerate(interval_s)`` re-schedules the CT GC
    controller (and triggers an immediate sweep);
    ``record_incident(kind, detail)`` is ``Daemon.record_incident``.
    """

    def __init__(self, sample_fn: Callable[[], Dict],
                 on_accelerate: Callable[[float], None],
                 on_restore: Callable[[], None],
                 record_incident: Optional[Callable] = None,
                 ct_threshold: float = 0.85,
                 ct_clear: float = 0.70,
                 gc_pressure_interval_s: float = 1.0,
                 relax_after_s: float = 0.0,
                 relax_factor: float = 2.0,
                 relax_max: float = 4.0,
                 on_relax: Optional[Callable[[float], None]] = None):
        self._sample_fn = sample_fn
        self._on_accelerate = on_accelerate
        self._on_restore = on_restore
        self._record_incident = record_incident
        self.ct_threshold = float(ct_threshold)
        self.ct_clear = float(ct_clear)
        self.gc_pressure_interval_s = float(gc_pressure_interval_s)
        # adaptive relaxation: after every
        # relax_after_s of CONTINUOUS calm the normal GC cadence
        # stretches by relax_factor (compounding, bounded by
        # relax_max); any episode snaps the multiplier back to 1.
        # 0 disables.  on_relax(multiplier) re-schedules the sweep
        self.relax_after_s = float(relax_after_s)
        self.relax_factor = float(relax_factor)
        self.relax_max = float(relax_max)
        self._on_relax = on_relax
        self._lock = threading.Lock()
        # guarded-by: _lock: state, episodes, samples, last,
        # guarded-by: _lock: _prev_drops, _prev_nat, last_episode,
        # guarded-by: _lock: relax_mult, relaxes, _calm_since
        self.state = STATE_OK
        self.episodes = 0  # completed ENTRIES into pressure
        self.samples = 0
        self.last: Optional[Dict] = None  # the cached sample the
        # registry/CLI collectors read (scrapes never touch the
        # device)
        self.last_episode: Optional[Dict] = None
        self._prev_drops: Optional[int] = None
        self._prev_nat: Optional[int] = None
        self.relax_mult = 1.0
        self.relaxes = 0  # completed relax STEPS
        self._calm_since: Optional[float] = None

    # -- the controller body -------------------------------------------
    def sample(self, now: Optional[float] = None) -> Dict:
        # thread-affinity: api -- the map-pressure controller thread
        # (plus Daemon.start()'s synchronous warm call); never the
        # drain thread
        """One monitor tick: fetch the pressure snapshot, update the
        per-window rates, and walk the state machine.  ``now`` is the
        monotonic clock the relaxation streak measures against —
        injectable so tests pin the never-mid-episode guarantee on a
        fake timeline."""
        if now is None:
            now = time.monotonic()
        snap = self._sample_fn()
        ct = snap["ct"]
        nat = snap["nat"]
        episode_detail = None
        with self._lock:
            self.samples += 1
            drops = int(ct["insert-drops"])
            natf = int(nat["failures"])
            d_drops = (drops - self._prev_drops
                       if self._prev_drops is not None else 0)
            d_nat = (natf - self._prev_nat
                     if self._prev_nat is not None else 0)
            self._prev_drops, self._prev_nat = drops, natf
            occ = ct.get("occupancy")
            snap["ct"]["insert-drop-delta"] = d_drops
            snap["nat"]["failure-delta"] = d_nat
            hot = ((occ is not None and occ >= self.ct_threshold)
                   or d_drops > 0 or d_nat > 0)
            calm = ((occ is None or occ < self.ct_clear)
                    and d_drops == 0 and d_nat == 0)
            if self.state == STATE_OK and hot:
                self.state = STATE_PRESSURE
                self.episodes += 1
                # entering an episode snaps relaxation back: the
                # accelerated cadence takes over, and whatever calm
                # streak was building is void
                self.relax_mult = 1.0
                self._calm_since = None
                episode_detail = {
                    "occupancy": occ,
                    "insert-drop-delta": d_drops,
                    "nat-failure-delta": d_nat,
                    "episode": self.episodes,
                }
                self.last_episode = dict(episode_detail)
                snap["state"] = self.state
                self.last = snap
                # the response runs UNDER the lock so a concurrent
                # resync() (patch_config) serializes against the
                # transition — an unsynchronized check-then-act
                # could cancel the accelerated cadence mid-episode.
                # Safe to nest: the ct-gc controller body never
                # takes this lock (its join cannot deadlock), and
                # incident capture only SPAWNS its thread here (the
                # capture thread's stats() read waits out the
                # remainder of this sample, nothing more)
                self._on_accelerate(self.gc_pressure_interval_s)
                if self._record_incident is not None:
                    self._record_incident("map-pressure",
                                          episode_detail)
            elif self.state == STATE_PRESSURE and calm:
                self.state = STATE_OK
                snap["state"] = self.state
                self.last = snap
                # the episode just closed: the calm streak starts
                # NOW — relaxation needs a full relax_after_s of
                # post-episode calm before its first step, so it can
                # never fire mid-episode (test-pinned)
                self._calm_since = now
                self._on_restore()
            else:
                if self.state == STATE_OK and self.relax_after_s > 0:
                    if not calm:
                        # sub-threshold heat (occupancy inside the
                        # hysteresis band, or deltas on an already-
                        # pressured map shape) resets the streak
                        # without opening an episode
                        self._calm_since = None
                    elif self._calm_since is None:
                        self._calm_since = now
                    elif (now - self._calm_since >= self.relax_after_s
                          and self.relax_mult < self.relax_max):
                        self.relax_mult = min(
                            self.relax_max,
                            self.relax_mult * self.relax_factor)
                        self.relaxes += 1
                        self._calm_since = now
                        if self._on_relax is not None:
                            # under the lock like on_accelerate: a
                            # concurrent resync() serializes against
                            # the stretched cadence
                            self._on_relax(self.relax_mult)
                snap["state"] = self.state
                self.last = snap
        return snap

    def resync(self, normal_interval_s: float, schedule) -> None:
        # thread-affinity: any
        """Re-apply the CT-GC cadence for the CURRENT state under
        the monitor lock — the race-free path for config changes
        (``patch_config``): a concurrent sample's state transition
        serializes against this, so a mid-episode reconfigure can
        neither cancel the accelerated sweep nor leave it stuck
        after the episode exits."""
        with self._lock:
            schedule(self.gc_pressure_interval_s
                     if self.state == STATE_PRESSURE
                     else normal_interval_s * self.relax_mult)

    # -- reading --------------------------------------------------------
    def stats(self) -> Dict:
        # thread-affinity: any
        """The serving-stats / GET /serving / CLI Pressure block."""
        with self._lock:
            out = {
                "state": self.state,
                "episodes": self.episodes,
                "samples": self.samples,
                "ct-threshold": self.ct_threshold,
                "ct-clear": self.ct_clear,
                "gc-pressure-interval-s": self.gc_pressure_interval_s,
                "accelerated": self.state == STATE_PRESSURE,
                "relax": {
                    "after-s": self.relax_after_s,
                    "factor": self.relax_factor,
                    "max": self.relax_max,
                    "multiplier": self.relax_mult,
                    "steps": self.relaxes,
                },
            }
            if self.last is not None:
                out["ct"] = dict(self.last["ct"])
                out["nat"] = dict(self.last["nat"])
            if self.last_episode is not None:
                out["last-episode"] = dict(self.last_episode)
            return out
