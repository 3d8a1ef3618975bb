"""The flow analytics plane: streaming aggregation over the decoded
event stream.

Reference: upstream cilium's Hubble does not stop at storing flows —
``pkg/hubble/metrics`` aggregates the stream into per-identity rates
and hubble-ui renders top talkers and a service map from it, and
production operators page on *derived* signals (drop-rate spikes),
not raw flows.  The repo already had the flow ring (an Observer of
the last N flows) and per-label counters (``flow/metrics.py``); what
was missing is the ANALYTICS layer: windowed per-identity-pair
aggregates, heavy-hitter tracking, and a drop-spike detector that
turns the stream into a named incident.

Hot-path discipline:

- ``submit(batch)`` is the only thing any publishing thread pays: an
  O(1) reference append onto a bounded deque (overflow drops the
  OLDEST pending batch, counted).  It is registered as a
  MonitorAgent consumer, so it sees every decoded batch the monitor
  plane sees — ring-event joins from the event-join worker AND the
  host-synthesized drop batches (sheds, recovery drops) the drain
  thread publishes.  Every column is a numpy array: the event join
  decodes the card's ring rows to host arrays before it publishes.
- ``drain()`` does the actual work and runs ONLY off the dispatch
  path: the daemon calls it from the event-join worker after a
  window join that leaves no window waiting, from ``process_batch``
  (the offline path), and from API queries.  A test records the
  thread identity of ``_ingest`` to prove the drain thread never
  executes it.
- Under a duty cap (``max_duty`` below 1) ``drain()`` ingests a
  batch in slices of at most :data:`INGEST_SLICE` rows and checks
  the budget before each, so one large batch cannot hold its thread
  much past the budget (the reference ingests a batch whole: one
  2^16-event batch held the event-join worker ~0.5 s on an H100's
  host, against a 0.1 s budget).  A batch the budget cuts part way
  counts dropped; the slices it ingested stay aggregated.  Without a
  cap a batch ingests whole, as the reference's does, and a slice of
  a batch merges into the windows exactly as the whole batch would;
  only the top-K sketches can differ, within their guarantees.
- ``_ingest`` is vectorized numpy over the batch: ``np.unique`` over
  composite key columns + ``np.add.at`` for byte sums.  Python loops
  run over UNIQUE keys per batch (identity pairs, distinct flows),
  never per packet.

Three aggregates:

- :class:`WindowAggregator` — rolling time windows (``window_s``
  wide, ``retention`` closed windows kept in a ring) of counters
  keyed by ``(src_identity, dst_identity, verdict, drop_reason)``
  with packet + byte sums; the ``GET /flows/aggregate`` verdict
  matrix renders from these.
- :class:`SpaceSavingSketch` — the Metwally et al. space-saving
  top-K heavy-hitters sketch, one instance keyed by flow 4-tuple and
  one by identity pair.  Guarantees (documented, tested): any key
  whose true count exceeds ``N/k`` is in the sketch, and every
  estimate overshoots its true count by at most ``N/k`` (the
  per-key ``error`` field bounds it exactly).
- :class:`SpikeDetector` — drop count per closed window vs the mean
  of the trailing ``baseline_windows`` non-spike windows; crossing
  ``max(min_drops, factor * baseline)`` raises ONE incident and
  enters the spike state, which releases only when drops fall back
  to the baseline (hysteresis: a burst spanning several windows is
  one incident, not one per window).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from ..core.packets import (COL_DIR, COL_DPORT, COL_DST_IP0, COL_EP,
                            COL_FAMILY, COL_LEN, COL_PROTO, COL_SPORT,
                            COL_SRC_IP0, words_to_ip)
from ..datapath.conntrack import CT_REPLY
from ..monitor.api import MSG_DROP

# ep-id -> local numeric identity (the daemon's endpoint table)
EpIdentityGetter = Callable[[int], int]
# on_incident(kind, detail_dict) — fired from whatever thread drained
IncidentFn = Callable[[str, dict], None]

DEFAULT_QUEUE_DEPTH = 16
# the rows of one ingest step under a duty cap: a sixteenth of a
# 2^16-row device batch, so that one step is a small part of a 0.1 s
# budget (two 8192-row steps spent it on an H100's host serving
# config #3)
INGEST_SLICE = 4096


def validate_analytics_config(window_s, windows, topk, queue_depth,
                              spike_factor, spike_min_drops,
                              spike_baseline_windows,
                              max_duty=0.5) -> tuple:
    """Validate the flow-analytics DaemonConfig knobs; returns the
    normalized tuple.  Same contract as ``validate_serving_config``:
    a bad knob fails at daemon construction, never as analytics that
    silently aggregates nothing."""
    max_duty = float(max_duty)
    if not 0.0 < max_duty <= 1.0:
        raise ValueError("flow_agg_max_duty must be in (0, 1] (the "
                         "aggregation duty-cycle cap)")
    window_s = float(window_s)
    if window_s <= 0:
        raise ValueError("flow_agg_window_s must be > 0")
    windows = int(windows)
    if windows < 1:
        raise ValueError("flow_agg_windows must be >= 1 (the closed-"
                         "window retention ring)")
    topk = int(topk)
    if topk < 1:
        raise ValueError("flow_agg_topk must be >= 1")
    queue_depth = int(queue_depth)
    if queue_depth < 1:
        raise ValueError("flow_agg_queue_depth must be >= 1")
    spike_factor = float(spike_factor)
    if spike_factor < 1.0:
        raise ValueError("spike_factor must be >= 1 (a spike is "
                         "MORE drops than baseline)")
    spike_min_drops = int(spike_min_drops)
    if spike_min_drops < 1:
        raise ValueError("spike_min_drops must be >= 1")
    spike_baseline_windows = int(spike_baseline_windows)
    if spike_baseline_windows < 1:
        raise ValueError("spike_baseline_windows must be >= 1")
    return (window_s, windows, topk, queue_depth, spike_factor,
            spike_min_drops, spike_baseline_windows, max_duty)


class SpaceSavingSketch:
    """Space-saving top-K (Metwally, Agrawal, El Abbadi 2005),
    extended with a byte sum per key.

    Invariants (the correctness test asserts both on Zipf traffic):

    - every key with true count > N/k is monitored (an elephant can
      never be evicted by mice: eviction replaces the MINIMUM
      counter, and min <= N/k always);
    - ``estimate - error <= true count <= estimate`` per key, with
      ``error <= N/k`` (a key inherits the evicted minimum as its
      error bound).

    Not thread-safe on its own — the owning :class:`FlowAnalytics`
    serializes updates under its aggregation lock."""

    __slots__ = ("k", "counts", "evictions", "total", "_key_hash")

    # fixed odd multipliers for the membership prefilter hash (a
    # wrapped dot product per row — vectorized).  The hash only
    # PREFILTERS: every candidate is confirmed by exact tuple lookup,
    # so a collision costs one wasted dict probe, never a wrong count
    _HASH_MULT = (np.random.default_rng(0xC111).integers(
        1, 1 << 63, size=32, dtype=np.uint64) << np.uint64(1)) \
        | np.uint64(1)

    def __init__(self, k: int):
        self.k = int(k)
        # key -> [count, bytes, error]
        self.counts: Dict[tuple, list] = {}
        self.evictions = 0
        self.total = 0  # sum of true increments ever offered (N)
        # hashes of counts' keys (rebuilt lazily): batch membership
        # prefilters vectorized against this
        self._key_hash: Optional[np.ndarray] = None

    @classmethod
    def _row_hash(cls, arr: np.ndarray) -> np.ndarray:
        w = arr.shape[1]
        return (arr.astype(np.uint64)
                * cls._HASH_MULT[:w]).sum(axis=1, dtype=np.uint64)

    def update(self, key: tuple, pkts: int, byts: int) -> None:
        self.total += pkts
        cur = self.counts.get(key)
        if cur is not None:
            cur[0] += pkts
            cur[1] += byts
            return
        self._key_hash = None
        if len(self.counts) < self.k:
            self.counts[key] = [pkts, byts, 0]
            return
        # evict the minimum-count key; the newcomer inherits its
        # count as the overestimate error (the space-saving step)
        victim = min(self.counts, key=lambda x: self.counts[x][0])
        floor = self.counts.pop(victim)[0]
        self.evictions += 1
        self.counts[key] = [floor + pkts, byts, floor]

    def update_many(self, keys: list, pkts, byts) -> None:
        """List-keyed convenience wrapper over
        :meth:`update_batch`."""
        if not len(keys):
            return
        self.update_batch(
            np.asarray(keys, dtype=np.int64).reshape(len(keys), -1),
            np.asarray(pkts, dtype=np.int64),
            np.asarray(byts, dtype=np.int64))

    def update_batch(self, rows: np.ndarray, pkts: np.ndarray,
                     byts: np.ndarray) -> None:
        """Batch merge — the streaming engine's hot call.  A batch's
        exact per-key counts form a zero-error summary, so this is a
        summary MERGE (Agarwal et al., "Mergeable Summaries"): a key
        absent from the sketch enters floored at the sketch's
        current minimum (that floor is its error), then the union is
        truncated to the top-k by estimate.  Same guarantees as m
        sequential :meth:`update` calls (elephants retained,
        overcount <= N/k), but the python-held work is O(k) per
        batch REGARDLESS of how many distinct keys the batch
        carried: membership runs vectorized against the numpy key
        mirror, and only the k largest fresh keys (by count — the
        only ones that can survive the truncation, since absent keys
        all share the same floor) are ever converted to tuples.  The
        worker thread's GIL time is what the serving drain thread
        contends with on CPU hosts, so this bound is load-bearing."""
        m = len(rows)
        if m == 0:
            return
        self.total += int(pkts.sum())
        counts = self.counts
        s = len(counts)
        if s:
            if self._key_hash is None:
                self._key_hash = self._row_hash(np.array(
                    list(counts.keys()), dtype=np.int64
                ).reshape(s, -1))
            # hash prefilter (vectorized) + exact confirm (python
            # over <= k candidates): a collision only costs a dict
            # probe that misses
            cand = np.flatnonzero(
                np.isin(self._row_hash(rows), self._key_hash))
            fresh_mask = np.ones(m, dtype=bool)
            for j in cand.tolist():
                cur = counts.get(tuple(rows[j].tolist()))
                if cur is not None:
                    cur[0] += int(pkts[j])
                    cur[1] += int(byts[j])
                    fresh_mask[j] = False
            fresh = np.flatnonzero(fresh_mask)
        else:
            fresh = np.arange(m)
        nf = len(fresh)
        if nf == 0:
            return
        if nf > self.k:
            # EXACT preselection: fresh keys all enter at mu + count,
            # so their estimate order is their count order — only
            # the k largest can survive the union truncation below
            order = np.argsort(pkts[fresh], kind="stable")[::-1]
            keep = fresh[order[:self.k]]
        else:
            keep = fresh
        mu = (min(c[0] for c in counts.values())
              if s >= self.k else 0)
        union = list(counts.items()) + [
            (key, [mu + p, b, mu])
            for key, p, b in zip(map(tuple, rows[keep].tolist()),
                                 pkts[keep].tolist(),
                                 byts[keep].tolist())]
        self._key_hash = None
        if len(union) > self.k:
            union.sort(key=lambda kv: -kv[1][0])
            self.evictions += s + nf - self.k
            self.counts = dict(union[:self.k])
        else:
            self.counts = dict(union)

    def top(self, n: Optional[int] = None) -> List[dict]:
        items = sorted(self.counts.items(), key=lambda kv: -kv[1][0])
        if n is not None:
            items = items[:n]
        return [{"key": k, "packets": int(c), "bytes": int(b),
                 "error": int(e)} for k, (c, b, e) in items]

    def error_bound(self) -> int:
        """The analytic overestimate bound: N/k."""
        return self.total // self.k if self.k else 0


class _Window:
    __slots__ = ("wid", "start", "packets", "bytes", "drops",
                 "counters", "opened_at")

    def __init__(self, wid: int, window_s: float):
        self.wid = wid
        self.start = wid * window_s
        self.packets = 0
        self.bytes = 0
        self.drops = 0
        # (src_id, dst_id, verdict, reason) -> [pkts, bytes]
        self.counters: Dict[tuple, list] = {}
        # wall clock at open (monotonic): the age-based roll closes
        # a window that outlived window_s with NO successor batch —
        # keyed on age, not wall window id, so synthetic-timestamp
        # streams (tests, replay) are not force-closed
        self.opened_at = time.monotonic()

    def to_dict(self, top: int = 16) -> dict:
        rows = sorted(self.counters.items(),
                      key=lambda kv: -kv[1][0])[:top]
        return {
            "window": self.wid,
            "start": round(self.start, 3),
            "packets": self.packets,
            "bytes": self.bytes,
            "drops": self.drops,
            "counters": [
                {"src-identity": k[0], "dst-identity": k[1],
                 "verdict": k[2], "reason": k[3],
                 "packets": int(v[0]), "bytes": int(v[1])}
                for k, v in rows],
        }


class WindowAggregator:
    """Ring-of-windows retention: one open window plus the last
    ``retention`` closed ones.  Ingest rolls the window forward when
    a batch's timestamp crosses the boundary; a straggler batch
    stamped before the boundary folds into the open window rather
    than resurrecting a closed one (monotonic enough for rates, and
    it keeps the close callback a one-shot per window)."""

    def __init__(self, window_s: float, retention: int,
                 on_close: Optional[Callable[[_Window], None]] = None):
        self.window_s = float(window_s)
        self.retention = int(retention)
        self.closed: Deque[_Window] = collections.deque(
            maxlen=self.retention)
        self.current: Optional[_Window] = None
        self.windows_closed = 0
        self._on_close = on_close

    def ingest(self, wid: int, keys: np.ndarray, pkts: np.ndarray,
               byts: np.ndarray, drops: int) -> None:
        cur = self.current
        if cur is None:
            cur = self.current = _Window(wid, self.window_s)
        elif wid > cur.wid:
            self.roll(wid)
            cur = self.current
        cur.packets += int(pkts.sum())
        cur.bytes += int(byts.sum())
        cur.drops += int(drops)
        counters = cur.counters
        # tolist() converts rows to native-int tuples in C; the loop
        # body is pure dict ops over UNIQUE keys
        for key, p, b in zip(map(tuple, keys.tolist()),
                             pkts.tolist(), byts.tolist()):
            slot = counters.get(key)
            if slot is None:
                counters[key] = [p, b]
            else:
                slot[0] += p
                slot[1] += b

    def roll(self, wid: int) -> None:
        """Close the open window (fires ``on_close`` exactly once)
        and open a fresh one at ``wid``."""
        cur = self.current
        self.current = _Window(wid, self.window_s)
        if cur is None:
            return
        self.closed.append(cur)
        self.windows_closed += 1
        if self._on_close is not None:
            self._on_close(cur)

    def matrix(self, top: int = 32) -> List[dict]:
        """The verdict matrix: per (src_identity, dst_identity,
        verdict, reason) totals aggregated over the open window plus
        every retained closed one."""
        agg: Dict[tuple, list] = {}
        wins = list(self.closed)
        if self.current is not None:
            wins.append(self.current)
        for w in wins:
            for k, v in w.counters.items():
                slot = agg.get(k)
                if slot is None:
                    agg[k] = [v[0], v[1]]
                else:
                    slot[0] += v[0]
                    slot[1] += v[1]
        rows = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
        return [{"src-identity": k[0], "dst-identity": k[1],
                 "verdict": k[2], "reason": k[3],
                 "packets": v[0], "bytes": v[1]} for k, v in rows]


class SpikeDetector:
    """Drop-spike detection over CLOSED windows, with hysteresis.

    A window whose drop count crosses ``max(min_drops, factor *
    baseline)`` enters the spike state and fires ``on_spike`` ONCE;
    the state releases only when a window's drops fall back to
    ``max(baseline, min_drops / 2)``.  Spike windows are EXCLUDED
    from the baseline — a sustained burst must not teach the
    detector that the burst is normal (which would re-arm flapping
    across window boundaries)."""

    def __init__(self, factor: float, min_drops: int,
                 baseline_windows: int,
                 on_spike: Optional[Callable[[dict], None]] = None):
        self.factor = float(factor)
        self.min_drops = int(min_drops)
        self._baseline: Deque[int] = collections.deque(
            maxlen=int(baseline_windows))
        self.in_spike = False
        self.spikes = 0
        self.last_spike: Optional[dict] = None
        self._on_spike = on_spike

    @property
    def baseline(self) -> float:
        if not self._baseline:
            return 0.0
        return sum(self._baseline) / len(self._baseline)

    def observe(self, window: _Window) -> Optional[dict]:
        base = self.baseline
        threshold = max(float(self.min_drops), self.factor * base)
        fired = None
        if not self.in_spike:
            if window.drops >= threshold:
                self.in_spike = True
                self.spikes += 1
                fired = self.last_spike = {
                    "window": window.wid,
                    "drops": window.drops,
                    "packets": window.packets,
                    "baseline": round(base, 3),
                    "threshold": round(threshold, 3),
                    "detected-at": time.time(),
                }
                if self._on_spike is not None:
                    self._on_spike(fired)
            else:
                self._baseline.append(window.drops)
        else:
            release = max(base, self.min_drops / 2.0)
            if window.drops <= release:
                self.in_spike = False
                self._baseline.append(window.drops)
        return fired

    def to_dict(self) -> dict:
        return {
            "in-spike": self.in_spike,
            "spikes": self.spikes,
            "baseline-drops": round(self.baseline, 3),
            "min-drops": self.min_drops,
            "factor": self.factor,
            "last-spike": self.last_spike,
        }


# columns composing the flow 4-tuple sketch key (family first so the
# renderer knows how to print the ip words)
_TUPLE_COLS = ([COL_FAMILY]
               + list(range(COL_SRC_IP0, COL_SRC_IP0 + 4))
               + list(range(COL_DST_IP0, COL_DST_IP0 + 4))
               + [COL_SPORT, COL_DPORT, COL_PROTO])


def _unique_rows(arr: np.ndarray):
    """Exact ``np.unique(axis=0)`` replacement for integer rows —
    ``(unique_rows, inverse, counts)`` — an order of magnitude
    faster on the wide keys this module aggregates.  ``axis=0``
    unique argsorts a VOID view (per-element memcmp through a
    function pointer: ~15 ms for 8k x 12 rows, measured — which
    would make the analytics worker the serving bottleneck);
    instead, factorize column by column, combining the running code
    as ``code * card + col_code`` and RE-COMPRESSING after every
    combine so values stay < N² (no overflow for any column count,
    and every sort is a plain 1-D int64 sort).  Constant columns
    (most of a real header: family, dst ip, dport, proto) cost one
    cheap unique and no combine."""
    n = len(arr)
    if n == 0:
        return arr, np.zeros(0, dtype=np.int64), np.zeros(
            0, dtype=np.int64)
    code = None
    bound = 1  # exclusive upper bound on code values (python int)
    for j in range(arr.shape[1]):
        u, inv = np.unique(arr[:, j], return_inverse=True)
        card = len(u)
        if card == 1:
            continue
        if code is None:
            code, bound = inv, card
            continue
        if bound * card >= (1 << 62):
            # only re-compress when the combine would overflow —
            # with few varying columns this never fires, so the
            # whole factorization is one sort per varying column
            code = np.unique(code, return_inverse=True)[1]
            bound = n
        code = code * card + inv
        bound *= card
    if code is None:  # every column constant: one unique row
        return (arr[:1], np.zeros(n, dtype=np.int64),
                np.array([n], dtype=np.int64))
    _, code = np.unique(code, return_inverse=True)
    # code is DENSE now: counts and a representative row per code
    # come from O(n) passes, no further sorting
    counts = np.bincount(code)
    rep = np.empty(len(counts), dtype=np.int64)
    rep[code] = np.arange(n)
    return arr[rep], code, counts


def _batch_rows(batch, lo: int, hi: int):
    """Rows ``lo:hi`` of an EventBatch (views of its columns)."""
    return dataclasses.replace(
        batch, **{f.name: getattr(batch, f.name)[lo:hi]
                  for f in dataclasses.fields(batch)
                  if f.name != "timestamp"})


class FlowAnalytics:
    """The engine: a bounded pending queue fed by ``submit`` (any
    thread, O(1)) and drained by ``drain`` (worker / API threads
    only).  All aggregation state is guarded by one lock taken only
    in ``drain``/``snapshot`` — never by a publishing thread."""

    def __init__(self, window_s: float = 1.0, retention: int = 8,
                 topk: int = 32,
                 queue_depth: int = DEFAULT_QUEUE_DEPTH,
                 spike_factor: float = 4.0, spike_min_drops: int = 64,
                 spike_baseline_windows: int = 4,
                 max_duty: float = 0.1,
                 ep_identity: Optional[EpIdentityGetter] = None,
                 on_incident: Optional[IncidentFn] = None,
                 enabled: bool = True):
        (window_s, retention, topk, queue_depth, spike_factor,
         spike_min_drops, spike_baseline_windows, max_duty
         ) = validate_analytics_config(
            window_s, retention, topk, queue_depth, spike_factor,
            spike_min_drops, spike_baseline_windows, max_duty)
        self.enabled = bool(enabled)
        self.window_s = window_s
        self.topk = topk
        self.queue_depth = queue_depth
        # the duty-cycle governor: aggregation may spend at most
        # max_duty of wall time per rolling second; excess pending
        # batches become COUNTED drops.  This bounds by construction
        # how much CPU the analytics plane can take from anything
        # else (the same cores enqueue the card's launches and join
        # its events — "off the dispatch path" must also mean "not
        # eating the dispatch path's machine")
        self.max_duty = max_duty
        self._duty_t0 = 0.0
        self._duty_spent = 0.0
        self._ep_identity = ep_identity or (lambda e: 0)
        self._on_incident = on_incident
        # the pending queue: tiny lock, append/popleft only — this is
        # ALL a publishing thread (incl. the serving drain thread)
        # ever touches
        self._qlock = threading.Lock()
        # guarded-by: _qlock: _pending, batches_submitted,
        # guarded-by: _qlock: batches_ingested, batches_dropped,
        # guarded-by: _qlock: ingest_failures
        self._pending: Deque[object] = collections.deque()
        # the aggregation state: worker/API threads only.  Lock order
        # where both are held: _lock THEN _qlock (drain's ledger
        # updates nest _qlock inside the aggregation lock)
        self._lock = threading.Lock()
        # guarded-by: _lock: windows, talkers, pairs, detector,
        # guarded-by: _lock: _fired_spikes, _duty_t0, _duty_spent,
        # guarded-by: _lock: packets_seen
        self.detector = SpikeDetector(
            spike_factor, spike_min_drops, spike_baseline_windows)
        # spikes detected while the aggregation lock is held are
        # DEFERRED and fired after drain() releases it: the incident
        # callback reaches the flight recorder, whose sysdump capture
        # snapshots this very engine — firing under the lock would
        # deadlock the worker against its own capture
        self._fired_spikes: List[dict] = []
        self.windows = WindowAggregator(window_s, retention,
                                        on_close=self._window_closed)
        self.talkers = SpaceSavingSketch(topk)
        self.pairs = SpaceSavingSketch(topk)
        # the ledger: submitted == ingested + dropped once pending
        # drains (drain() always empties what it saw)
        self.batches_submitted = 0
        self.batches_ingested = 0
        self.batches_dropped = 0
        # ...of the dropped, batches _ingest raised on (an unreadable
        # batch): each is also logged
        self.ingest_failures = 0
        self.packets_seen = 0

    # -- producer side (ANY thread, including the drain thread) --------
    def submit(self, batch) -> None:
        # thread-affinity: any
        """A MonitorAgent consumer: park one decoded EventBatch by
        reference.  Never aggregates here — the deque append is the
        entire cost on the publishing thread.  While the duty budget
        is exhausted (a shed storm), the batch is dropped HERE
        (counted) instead of parked: retaining references the
        governor will drop anyway extends big drop-batch lifetimes
        across the queue, and that allocator/cache pressure is paid
        by the whole machine."""
        if not self.enabled or len(batch) == 0:
            return
        with self._qlock:
            self.batches_submitted += 1
            # ADVISORY cross-lock read of the _lock-guarded duty
            # clock, racy BY DESIGN: taking _lock on the publishing
            # path would make the drain thread wait out a whole
            # aggregation pass — the exact contention submit() exists
            # to avoid.  Worst case one batch is parked (or dropped)
            # a beat late; drain() re-checks authoritatively.
            spent, t0 = self._duty_spent, self._duty_t0
            if (spent >= self.max_duty
                    and time.monotonic() - t0 < 1.0):
                self.batches_dropped += 1
                return
            if len(self._pending) >= self.queue_depth:
                self._pending.popleft()
                self.batches_dropped += 1
            self._pending.append(batch)

    @property
    def pending(self) -> int:
        # thread-affinity: any
        with self._qlock:
            return len(self._pending)

    # -- consumer side (event-join worker / API / offline callers) -----
    def drain(self) -> int:
        # thread-affinity: event-worker, capture, api, cli, offline
        """Aggregate everything pending, then roll the open window
        if wall time has crossed its boundary — a drop burst
        followed by SILENCE must still close its window and reach
        the spike detector (the daemon's flow-agg-roll controller
        ticks this on the window cadence, so detection never waits
        for a next batch that may not come).  Runs on the CALLING
        thread — the daemon only calls it off the dispatch path
        (event-join worker, process_batch tail, the roll controller,
        API queries, stop_serving)."""
        with self._qlock:
            batches, self._pending = list(self._pending), \
                collections.deque()
        with self._lock:
            for batch in batches:
                # Ledger counters mutate under _qlock ONLY (submit's
                # duty-exhausted drop also counts there; split locks
                # would lose increments and break the exact
                # submitted == ingested + dropped ledger)
                whole = self._ingest_governed(batch)
                with self._qlock:
                    if whole:
                        self.batches_ingested += 1
                    else:
                        self.batches_dropped += 1
            # age-based roll: a window that outlived window_s with
            # no successor batch still closes (and reaches the spike
            # detector) — a drop burst followed by SILENCE is
            # exactly the case the detector must not sleep through.
            # An EMPTY aged window only rolls while the detector is
            # in a spike (the release observation); pure silence
            # does not churn empty windows through the ring
            cur = self.windows.current
            if (cur is not None
                    and time.monotonic() - cur.opened_at
                    >= self.window_s
                    and (cur.packets or cur.drops
                         or self.detector.in_spike)):
                self.windows.roll(cur.wid + 1)
            fired, self._fired_spikes = self._fired_spikes, []
        for spike in fired:  # outside the lock — see _window_closed
            self._spike_incident(spike)
        return len(batches)

    def _ingest_governed(self, batch) -> bool:
        # holds: _lock -- called from drain()'s locked region only
        # thread-affinity: event-worker, capture, api, cli, offline
        """Ingest one batch under the duty governor, a slice of at
        most INGEST_SLICE rows at a time while a cap is set; False
        when the budget cut it (before or part way) or it could not
        be read."""
        n = len(batch)
        step = max(n, 1) if self.max_duty >= 1.0 else INGEST_SLICE
        for lo in range(0, n, step):
            now = time.monotonic()
            if now - self._duty_t0 >= 1.0:
                self._duty_t0, self._duty_spent = now, 0.0
            if self._duty_spent >= self.max_duty:
                # duty budget spent this second: shed the rest of the
                # batch instead of stealing more CPU from the machine
                # the datapath runs on
                return False
            try:
                self._ingest(batch if step >= n
                             else _batch_rows(batch, lo, lo + step))
            except Exception:  # noqa: BLE001 — one poisoned batch
                # must not wedge the analytics plane: a counted drop
                logging.getLogger(__name__).warning(
                    "flow analytics could not ingest a batch of %d "
                    "events", n, exc_info=True)
                with self._qlock:
                    self.ingest_failures += 1
                return False
            finally:
                self._duty_spent += time.monotonic() - now
        return True

    def _window_closed(self, window: _Window) -> None:
        # holds: _lock -- the WindowAggregator close hook fires from
        # drain()'s locked region
        # thread-affinity: event-worker, capture, api, cli, offline
        """WindowAggregator close hook (called under ``_lock``):
        detect, but DEFER the incident callback to drain()'s
        unlocked tail."""
        fired = self.detector.observe(window)
        if fired is not None:
            self._fired_spikes.append(fired)

    def _ingest(self, batch) -> None:
        # holds: _lock -- called from drain()'s locked region only
        # thread-affinity: event-worker, capture, api, cli, offline
        # -- NEVER the drain thread
        """Vectorized aggregation of one EventBatch (the point a test
        records the thread of, to prove the drain thread never runs
        it)."""
        hdr = batch.hdr
        n = len(batch)
        self.packets_seen += n
        lens = hdr[:, COL_LEN].astype(np.int64)
        # local identity per row: python only over UNIQUE endpoints
        eps, inv = np.unique(hdr[:, COL_EP], return_inverse=True)
        local = np.fromiter(
            (self._ep_identity(int(e)) for e in eps),
            dtype=np.int64, count=len(eps))[inv]
        remote = batch.identity.astype(np.int64)
        # remote sits on the src side for ingress non-reply rows
        # (the threefour parser's endpoint resolution, vectorized)
        remote_is_src = ((hdr[:, COL_DIR] == 0)
                         ^ (batch.ct_state == CT_REPLY))
        src_id = np.where(remote_is_src, remote, local)
        dst_id = np.where(remote_is_src, local, remote)
        key4 = np.stack(
            [src_id, dst_id, batch.verdict.astype(np.int64),
             batch.reason.astype(np.int64)], axis=1)
        uniq, inv4, cnt = _unique_rows(key4)
        byts = np.bincount(inv4, weights=lens,
                           minlength=len(uniq)).astype(np.int64)
        drops = int((batch.msg_type == MSG_DROP).sum())
        self.windows.ingest(int(batch.timestamp // self.window_s),
                            uniq, cnt, byts, drops)
        # identity-pair heavy hitters: collapse the window keys
        # (already unique) onto (src, dst) — vectorized, then one
        # batch merge into the sketch
        puniq, pinv, _ = _unique_rows(uniq[:, :2])
        ppkts = np.bincount(pinv, weights=cnt,
                            minlength=len(puniq)).astype(np.int64)
        pbyts = np.bincount(pinv, weights=byts,
                            minlength=len(puniq)).astype(np.int64)
        self.pairs.update_batch(puniq, ppkts, pbyts)
        # flow 4-tuple heavy hitters: unique flows per batch (the
        # sketch's batch merge keeps python work O(k), never per
        # distinct flow)
        tup = hdr[:, _TUPLE_COLS].astype(np.int64)
        tuniq, tinv, tcnt = _unique_rows(tup)
        tbyts = np.bincount(tinv, weights=lens,
                            minlength=len(tuniq)).astype(np.int64)
        self.talkers.update_batch(tuniq, tcnt, tbyts)

    def _spike_incident(self, spike: dict) -> None:
        # thread-affinity: event-worker, capture, api, cli, offline
        if self._on_incident is not None:
            self._on_incident("drop-spike", spike)

    # -- reading -------------------------------------------------------
    @staticmethod
    def _render_talker(row: dict) -> dict:
        fam, s0, s1, s2, s3, d0, d1, d2, d3, sport, dport, proto = \
            row["key"]
        return {
            "src": words_to_ip(np.array([s0, s1, s2, s3],
                                        dtype=np.uint32), fam),
            "dst": words_to_ip(np.array([d0, d1, d2, d3],
                                        dtype=np.uint32), fam),
            "sport": sport, "dport": dport, "proto": proto,
            "packets": row["packets"], "bytes": row["bytes"],
            "error": row["error"],
        }

    def snapshot(self, top: int = 16) -> dict:
        # thread-affinity: capture, api, cli, offline
        """``GET /flows/aggregate``: windows, matrix, top talkers,
        spike state, ledger.  Drains pending first so queries read
        fresh aggregates (query threads are off the dispatch path by
        definition)."""
        self.drain()
        # the ledger reads OUTSIDE the aggregation lock: stats() now
        # takes both locks itself, and calling it from inside the
        # `with self._lock:` below would deadlock on the
        # non-reentrant lock
        ledger = self.stats()
        with self._lock:
            cur = self.windows.current
            out = {
                "enabled": self.enabled,
                "window-s": self.window_s,
                "windows-closed": self.windows.windows_closed,
                "retention": self.windows.retention,
                "current-window": (cur.to_dict(top)
                                   if cur is not None else None),
                "windows": [w.to_dict(top)
                            for w in self.windows.closed],
                "matrix": self.windows.matrix(top),
                "top-talkers": [self._render_talker(r)
                                for r in self.talkers.top(top)],
                "top-identity-pairs": [
                    {"src-identity": r["key"][0],
                     "dst-identity": r["key"][1],
                     "packets": r["packets"], "bytes": r["bytes"],
                     "error": r["error"]}
                    for r in self.pairs.top(top)],
                "top-k": self.topk,
                "sketch-error-bound": self.talkers.error_bound(),
                "evictions": (self.talkers.evictions
                              + self.pairs.evictions),
                "spike": self.detector.to_dict(),
                "ledger": ledger,
            }
            return out

    def stats(self) -> dict:
        # thread-affinity: any
        """The serving-stats / registry block (cheap counters; no
        drain — safe from any thread).  Takes both locks (aggregation
        then ledger, the drain() nesting order) so a scrape never
        reads a half-updated window count against the matching
        ledger; the bare reads it replaces raced live aggregation."""
        with self._lock:
            windows_closed = self.windows.windows_closed
            evictions = self.talkers.evictions + self.pairs.evictions
            spikes = self.detector.spikes
            packets = self.packets_seen
            with self._qlock:
                return {
                    "enabled": self.enabled,
                    "batches-submitted": self.batches_submitted,
                    "batches-ingested": self.batches_ingested,
                    "batches-dropped": self.batches_dropped,
                    "packets-seen": packets,
                    "pending": len(self._pending),
                    "windows-closed": windows_closed,
                    "talker-evictions": evictions,
                    "spikes": spikes,
                }
