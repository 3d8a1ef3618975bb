"""Device-resident event ring: the eventsmap/perf-buffer analogue.

Reference: upstream cilium's datapath emits events into a kernel perf
ring (``pkg/monitor/agent`` reads it); userspace drains at its own
cadence and the ring overwrites when the consumer lags.  The ring is a
fixed device buffer; each step appends **compacted** events (drops +
policy verdicts on NEW connections + 1/``trace_sample`` of
established-flow traces) on device, and the host drains at its own
cadence.

Ring semantics: wrap-overwrite (newest wins), like the Hubble observer
ring; the total appended count is monotone so the host computes loss as
``appended - capacity`` when it lags a full lap.

On the card ``ring_append`` launches the ``ring_append`` kernels and
``ring_gather`` the gather kernel (``csrc/ring.cu``).  JAX donated the
ring; here ``ring_append`` writes ``buf`` and ``cursor`` IN PLACE on
the current stream.  The host decode (``_unpack_rows`` ..
``_drain_window``) is a copy of the JAX package's.

Streams and threads: every kernel, copy and event of the serving path
goes to the current stream of the device, and no thread of the port
sets another, so all of them share the device's default stream and run
in the order the host enqueued them.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..datapath.verdict import (EV_TRACE, N_OUT, OUT_CT, OUT_EVENT,
                                OUT_ID_ROW, OUT_PROXY, OUT_REASON,
                                OUT_VERDICT)
from ..device import resolve_device
from ..u32 import MASK, narrow, to_numpy, widen

# Decoded ring row: the N_OUT out-columns + packet index within batch
# + batch seq.  On the device each row packs into RING_WORDS u32 (8 B):
#   w0: verdict(0..2) | event(3..4) | reason(5..8) | ct(9..11)
#       | proxy_idx(12..15) | id_row(16..31)
#   w1: pkt_idx(0..18) | batch(19..31, wraps)
# proxy_idx is the redirect port's 1-based index in the small listener
# table (0 = none).  Limits: id_row < 2^16, pkt_idx < 2^19 (batches up
# to 512k rows), batch seq wraps at 2^13, <= 15 live proxy listeners.
# Empty slots carry event bits 0b11 (no EV_* code uses 3), which is how
# the drain drops never-written rows.
RING_COLS = N_OUT + 2
COL_PKT_IDX = N_OUT
COL_BATCH = N_OUT + 1
EMPTY_BATCH = 0xFFFFFFFF
RING_WORDS = 2
MAX_PROXY_PORTS = 15
_EMPTY = 0xFFFFFFFF


@dataclass
class EventRing:
    """Device state of the ring."""

    buf: torch.Tensor  # [capacity, RING_WORDS] int32 (u32 packed rows)
    # total events ever appended as TWO u32 words [lo, hi]: a single
    # u32 wraps after 2^32 events and a wrapped cursor makes drain
    # misread a full ring as nearly empty
    cursor: torch.Tensor  # [2] int32 (u32)

    @staticmethod
    def create(capacity: int = 1 << 15, device=None) -> "EventRing":
        assert capacity & (capacity - 1) == 0, "capacity must be 2^k"
        device = resolve_device(device)
        return EventRing(
            buf=torch.full((capacity, RING_WORDS), -1, dtype=torch.int32,
                           device=device),
            cursor=torch.zeros((2,), dtype=torch.int32, device=device))

    @property
    def capacity(self) -> int:
        return self.buf.shape[0]


def ring_append_plain(ring: EventRing, out: torch.Tensor, batch_id: int,
                      trace_sample: int = 1024,
                      valid: Optional[torch.Tensor] = None,
                      proxy_ports: Optional[torch.Tensor] = None
                      ) -> EventRing:
    """Compact one batch's out tensor into the ring, in place (plain
    version).

    Keeps every non-TRACE event (drops, NEW-connection policy
    verdicts) plus one in ``trace_sample`` established-flow traces
    (``trace_sample=0`` disables trace sampling).  ``proxy_ports`` is
    the live listener table ([<= MAX_PROXY_PORTS] u32): redirect events
    store the PORT's index in it; pass the same table to
    :func:`ring_drain` to restore ports."""
    n = out.shape[0]
    assert n <= (1 << 19), "pkt_idx packs into 19 bits"
    dev = out.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    o = widen(out)
    keep = o[:, OUT_EVENT] != EV_TRACE
    if trace_sample:
        keep = keep | (idx % trace_sample == 0)
    if valid is not None:
        keep = keep & valid
    pos = torch.cumsum(keep.to(torch.int64), 0) - 1
    count = keep.sum()
    cap = ring.capacity
    cur = widen(ring.cursor)
    lo, hi = cur[0], cur[1]
    # newest-wins under overflow: when one batch keeps more events than
    # the ring holds, only the newest `capacity` rows write
    target = keep & (pos + cap >= count)
    slot = (lo + pos) & (cap - 1)
    if proxy_ports is None or proxy_ports.shape[0] == 0:
        pidx = torch.zeros(n, dtype=torch.int64, device=dev)
    else:
        assert proxy_ports.shape[0] <= MAX_PROXY_PORTS, \
            "listener index packs into 4 bits"
        port = o[:, OUT_PROXY]
        hit = port[:, None] == widen(proxy_ports)[None, :]
        pidx = torch.where(hit.any(dim=1) & (port != 0),
                           torch.argmax(hit.to(torch.int8), dim=1) + 1, 0)
    # mask each field to its wire width: a value past its width must
    # corrupt only itself, never a neighbor
    w0 = ((o[:, OUT_VERDICT] & 0x7) | ((o[:, OUT_EVENT] & 0x3) << 3)
          | ((o[:, OUT_REASON] & 0xF) << 5) | ((o[:, OUT_CT] & 0x7) << 9)
          | (pidx << 12) | ((o[:, OUT_ID_ROW] & 0xFFFF) << 16))
    w1 = idx | ((int(batch_id) & 0x1FFF) << 19)
    rows = narrow(torch.stack([w0, w1], dim=1))
    ring.buf[slot[target]] = rows[target]
    new_lo = (lo + count) & 0xFFFFFFFF
    new_hi = hi + (new_lo < lo).to(torch.int64)  # carry
    ring.cursor.copy_(narrow(torch.stack([new_lo, new_hi])))
    return ring


def ring_append(ring: EventRing, out: torch.Tensor, batch_id: int,
                trace_sample: int = 1024,
                valid: Optional[torch.Tensor] = None,
                proxy_ports: Optional[torch.Tensor] = None) -> EventRing:
    """Compact one batch's events into the ring, in place: see
    :func:`ring_append_plain`.  CUDA tensors launch the ``ring_append``
    kernels."""
    if out.is_cuda:
        from ..kernels import launch_ring_append

        return launch_ring_append(ring, out, batch_id, trace_sample,
                                  valid, proxy_ports)
    if out.device.type != "cpu":
        raise ValueError(f"ring_append: no kernel for {out.device}")
    return ring_append_plain(ring, out, batch_id, trace_sample, valid,
                             proxy_ports)


def serve_step(state, ring: EventRing, hdr: torch.Tensor, now: int,
               batch_id: int, trace_sample: int = 1024,
               valid: Optional[torch.Tensor] = None,
               proxy_ports: Optional[torch.Tensor] = None,
               audit: bool = False):
    """The serving-path step over wide rows: datapath + event-ring
    append, no host fetch.  Returns (state, ring), both updated in
    place."""
    from ..datapath.verdict import datapath_step

    out, state = datapath_step(state, hdr, now, valid=valid, audit=audit)
    ring = ring_append(ring, out, batch_id, trace_sample=trace_sample,
                       valid=valid, proxy_ports=proxy_ports)
    return state, ring


def serve_step_packed(state, ring: EventRing, packed: torch.Tensor,
                      now: int, batch_id: int, ep: int, dirn: int,
                      trace_sample: int = 1024,
                      valid: Optional[torch.Tensor] = None,
                      proxy_ports: Optional[torch.Tensor] = None,
                      audit: bool = False):
    """Serving path for the packed ingest format (16 B/packet): unpack
    + datapath + ring append.  ``valid`` masks the batcher's padding
    rows: padding touches neither CT, metrics, nor the ring."""
    from ..datapath.verdict import datapath_step_packed

    out, state = datapath_step_packed(state, packed, now, ep, dirn,
                                      valid=valid, audit=audit)
    ring = ring_append(ring, out, batch_id, trace_sample=trace_sample,
                       valid=valid, proxy_ports=proxy_ports)
    return state, ring


# -- K-batch superbatch dispatch -------------------------------------
# K batches in one host call: one staging copy, one lock window, then
# K steps of the verdict, CT update and ring append kernels queued on
# the stream.  Per-step ``valid`` masks do double duty, as on the
# reference: within a step they mask the batcher's padding rows, and an
# ALL-FALSE step masks an empty slot of a partially filled superbatch:
# it touches neither CT, metrics nor the ring (its append moves the
# cursor by 0).  The K steps all read the state the caller passed, so a
# concurrent table swap lands wholly before or after the superbatch.


def serve_superbatch(state, ring: EventRing, hdr: torch.Tensor, now: int,
                     batch_id0: int, trace_sample: int = 1024,
                     valid: Optional[torch.Tensor] = None,
                     proxy_ports: Optional[torch.Tensor] = None,
                     audit: bool = False):
    """K wide batches: ``hdr`` [K, bucket, N_COLS], ``valid`` [K,
    bucket] (required: the empty-step masking depends on it), batch
    ids ``batch_id0 + k`` (u32, wrapping; the ring keeps 13 bits).
    Returns (state, ring), both updated in place."""
    if valid is None:
        raise ValueError("superbatch dispatch requires valid masks")
    for k in range(hdr.shape[0]):
        state, ring = serve_step(state, ring, hdr[k], now,
                                 (int(batch_id0) + k) & MASK,
                                 trace_sample=trace_sample,
                                 valid=valid[k], proxy_ports=proxy_ports,
                                 audit=audit)
    return state, ring


def serve_superbatch_packed(state, ring: EventRing, packed: torch.Tensor,
                            now: int, batch_id0: int, eps, dirns,
                            trace_sample: int = 1024,
                            valid: Optional[torch.Tensor] = None,
                            proxy_ports: Optional[torch.Tensor] = None,
                            audit: bool = False):
    """K packed batches: ``packed`` [K, bucket, 4], ``eps``/``dirns``
    the K per-step stream scalars (host integers), ``valid`` [K,
    bucket]; otherwise as :func:`serve_superbatch`."""
    if valid is None:
        raise ValueError("superbatch dispatch requires valid masks")
    for k in range(packed.shape[0]):
        state, ring = serve_step_packed(
            state, ring, packed[k], now, (int(batch_id0) + k) & MASK,
            int(eps[k]), int(dirns[k]), trace_sample=trace_sample,
            valid=valid[k], proxy_ports=proxy_ports, audit=audit)
    return state, ring


# -- occupancy-bounded drain ------------------------------------------
# The fetched window's byte count scales with the EVENTS the window
# appended, not the ring's capacity: the swap reads the 8-byte cursor
# first, so the host knows the occupancy before a buffer byte moves.  A
# device gather pulls just the occupied slots (wrap-aware: the i-th
# surviving event sits in slot (start + i) & mask, start = 0 until the
# ring laps) into a contiguous buffer of a power-of-two RUNG, and the
# device-to-host copy ships rung * 8 bytes instead of capacity * 8.
GATHER_MIN_RUNG = 64


def _gather_rung(kept: int, cap: int) -> int:
    """Smallest ladder rung holding ``kept`` rows (power of two,
    floored at GATHER_MIN_RUNG, capped at the ring capacity)."""
    r = min(GATHER_MIN_RUNG, cap)
    while r < kept:
        r <<= 1
    return min(r, cap)


def ring_gather_plain(buf: torch.Tensor, starts, rung: int,
                      cap: int) -> torch.Tensor:
    """Gather each shard's window slots, in append order, into a
    contiguous [n_shards * rung, RING_WORDS] tensor (plain version).

    ``buf`` is [n_shards * cap, RING_WORDS] (one shard for the
    single-card ring), ``starts`` the host integers of each shard's
    oldest surviving slot ((total - kept) & mask; 0 until the ring
    laps).  Slots past a shard's occupancy are EMPTY on a fresh-per-
    window ring, so the host's empty-slot filter drops them as the
    full-copy path does."""
    st = torch.tensor([int(x) & MASK for x in starts], dtype=torch.int64,
                      device=buf.device)
    offs = torch.arange(rung, dtype=torch.int64, device=buf.device)
    idx = (st[:, None] + offs[None, :]) & (cap - 1)
    idx = idx + (torch.arange(st.shape[0], dtype=torch.int64,
                              device=buf.device) * cap)[:, None]
    return buf[idx.reshape(-1)]


def ring_gather(buf: torch.Tensor, starts, rung: int,
                cap: int) -> torch.Tensor:
    """See :func:`ring_gather_plain`.  CUDA tensors launch the
    ``ring_gather`` kernel."""
    if buf.is_cuda:
        from ..kernels import launch_ring_gather

        return launch_ring_gather(buf, starts, rung, cap)
    if buf.device.type != "cpu":
        raise ValueError(f"ring_gather: no kernel for {buf.device}")
    return ring_gather_plain(buf, starts, rung, cap)


def _cursor_totals(cursor: np.ndarray) -> np.ndarray:
    """Host cursor ([2] or [S, 2] of u32 lo/hi words) -> int64 totals
    per shard ([S])."""
    c = np.asarray(cursor, dtype=np.uint64).reshape(-1, 2)
    return (c[:, 0] | (c[:, 1] << np.uint64(32))).astype(np.int64)



@dataclass
class RingWindow:
    """One drained window's in-flight handle: the host buffer its
    device-to-host copy is filling, the event that marks the copy done,
    and what the event-join worker needs to finish the window: the
    host cursor, the occupancy and loss math done at swap time, and the
    drainer for counter accounting.

    The window holds the ring and the gathered device rows until
    :meth:`fetch`, so neither is freed while its copy is queued.
    Ownership: ``swap_window`` hands the window out and the drainer
    forgets it; exactly one thread (the event-join worker) calls
    :meth:`fetch` exactly once."""

    buf: Optional[object]  # host rows: pinned tensor, or numpy (CPU)
    cursor: np.ndarray  # host copy, [n_shards (or 1), 2] u32
    capacity: int  # slots per shard
    n_shards: int  # 0 = single-card ring
    appended: int  # events appended across shards this window
    lost: int  # lap loss (appended - capacity when the host lagged)
    d2h_bytes: int  # bytes this window put on the device-to-host link
    gathered: bool  # buf is a rung gather, already in append order
    rung: int
    proxy_ports: Optional[np.ndarray]
    drainer: object
    done: Optional[object] = None  # torch.cuda.Event after the copy
    device_refs: tuple = ()  # ring and gather output, kept until fetch
    t_swap: float = field(default_factory=time.monotonic)

    def fetch(self):
        # thread-affinity: event-worker, api, offline -- the blocking
        # wait for the copy lives here; the drain thread only swaps
        """Wait for the copy, decode, and give the host buffer back to
        the drainer's pool.  Returns ``(rows, shard_ids, appended,
        lost)``: a sharded window decodes its shards round-robin, shard
        0 first, with shard-LOCAL packet indices, and ``shard_ids``
        gives each row's shard (None for a single-card window).
        Updates the drainer's windows/events/lost counters."""
        d = self.drainer
        if self.buf is None:
            if d is not None:
                d.windows += 1
            shards = np.zeros(0, dtype=np.int64) if self.n_shards else None
            return (np.zeros((0, RING_COLS), dtype=np.uint32), shards, 0,
                    0)
        host, self.buf = self.buf, None
        if self.done is not None:
            self.done.synchronize()
        words = (host.numpy().view(np.uint32)
                 if isinstance(host, torch.Tensor) else host)
        totals = _cursor_totals(self.cursor)
        shards = None
        if self.n_shards:
            rows, shards, _total, _lost = _decode_sharded(
                words, totals, self.capacity, self.proxy_ports,
                gathered=self.gathered)
        else:
            rows, _total, _lost = _decode_fetched(
                words, int(totals[0]), self.capacity, self.proxy_ports,
                gathered=self.gathered)
        self.device_refs = ()
        if d is not None:
            if isinstance(host, torch.Tensor):
                d._release(host)
            d.windows += 1
            d.events += self.appended - self.lost
            d.lost += self.lost
        return rows, shards, self.appended, self.lost


def _start_window(ring: EventRing, capacity: int, n_shards: int,
                  proxy_ports, drainer, gather: bool) -> RingWindow:
    # thread-affinity: drain, api, offline
    """The swap leg: read the cursor (which retires every queued
    dispatch), do the occupancy math on the host, start the
    asynchronous copy of either the rung gather or the whole buffer,
    and wrap it all in a :class:`RingWindow`."""
    # hot-path-ok: the 8-byte cursor read waits for every kernel and
    # copy queued on the stream before it (the staging copies of the
    # pinned batcher arena included: see serving/batcher.py); it also
    # makes the occupancy-bounded gather possible at all
    cur = to_numpy(ring.cursor).reshape(-1, 2).copy()
    totals = _cursor_totals(cur)
    appended = int(totals.sum())
    lost = int(np.maximum(totals - capacity, 0).sum())
    if appended == 0:
        return RingWindow(buf=None, cursor=cur, capacity=capacity,
                          n_shards=n_shards, appended=0, lost=0,
                          d2h_bytes=0,
                          gathered=False, rung=0,
                          proxy_ports=proxy_ports, drainer=drainer)
    if gather:
        # one rung for every shard (the largest occupancy), so the
        # fetched layout stays one block a shard
        kept = np.minimum(totals, capacity)
        rung = _gather_rung(int(kept.max()), capacity)
        # oldest surviving slot: 0 until the ring laps, then the
        # wrapped cursor (total & mask)
        starts = np.where(totals > capacity, totals & (capacity - 1), 0)
        dev = ring_gather(ring.buf, starts, rung, capacity)
    else:
        rung, dev = capacity, ring.buf
    host, done = drainer._copy_to_host(dev)
    return RingWindow(buf=host, cursor=cur, capacity=capacity,
                      n_shards=n_shards, appended=appended, lost=lost,
                      d2h_bytes=dev.numel() * 4 + cur.nbytes,
                      gathered=gather, rung=rung, proxy_ports=proxy_ports,
                      drainer=drainer, done=done, device_refs=(ring, dev))


class AsyncRingDrainer:
    """Double-buffered drain: the host fetches window N-1 while the
    device steps window N.

    At each window boundary ``swap_window(ring)`` reads the cursor,
    starts an ASYNCHRONOUS copy of the window's rows into pinned host
    memory (followed by a CUDA event) and hands the serve loop a fresh
    ring; the event-join worker's ``fetch`` waits on that event, so the
    drain thread never waits for the buffer.  Pinned buffers cost
    milliseconds to allocate, so each rung keeps a small pool of them;
    a buffer goes back to its pool when its window is fetched.

    Because every window starts on a fresh ring, the fetched cursor IS
    the window's append count and per-window loss is ``max(0,
    appended - capacity)`` with no cross-window bookkeeping."""

    n_shards = 0  # a single-card ring

    def __init__(self, capacity: int = 1 << 15,
                 proxy_ports: np.ndarray = None, gather: bool = True,
                 device=None):
        self.capacity = capacity
        self.proxy_ports = proxy_ports
        # occupancy-bounded fetch (module comment at GATHER_MIN_RUNG)
        self.gather = bool(gather)
        self.device = resolve_device(device)
        self._pool: Dict[int, List[torch.Tensor]] = {}
        self._pool_lock = threading.Lock()
        # guarded-by: _pool_lock: _pool
        self.windows = 0
        self.events = 0
        self.lost = 0

    def fresh(self) -> EventRing:
        return EventRing.create(self.capacity, self.device)

    def _copy_to_host(self, dev: torch.Tensor):
        # thread-affinity: drain, api, offline
        """Start the copy of ``dev`` to the host; returns (host buffer,
        CUDA event recorded after the copy, or None on the CPU)."""
        if not dev.is_cuda:
            return to_numpy(dev), None
        rows = dev.shape[0]
        with self._pool_lock:
            free = self._pool.setdefault(rows, [])
            host = free.pop() if free else None
        if host is None:
            host = torch.empty((rows, RING_WORDS), dtype=torch.int32,
                               pin_memory=True)
        host.copy_(dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _release(self, host: torch.Tensor) -> None:
        # thread-affinity: event-worker, api, offline
        with self._pool_lock:
            self._pool.setdefault(host.shape[0], []).append(host)

    def swap_window(self, ring: EventRing
                    ) -> Tuple[RingWindow, EventRing]:
        # thread-affinity: drain, api, offline
        """Start the asynchronous fetch of ``ring`` and hand its window
        out as a :class:`RingWindow` (ownership transfers to the
        caller, the event-join worker's shape); returns the fresh ring
        for the next window beside it."""
        from ..infra import faults

        faults.check(faults.SITE_RING_SWAP)
        window = _start_window(ring, self.capacity, self.n_shards,
                               self.proxy_ports, self, self.gather)
        return window, self.fresh()


class ShardedAsyncRingDrainer(AsyncRingDrainer):
    """The :class:`AsyncRingDrainer` shape for per-shard rings: one
    [S * capacity, RING_WORDS] buffer and [S, 2] cursor hold every
    shard's private ring (``parallel.make_sharded_ring``).  The swap
    reads the S cursors, gathers every shard at one common rung (K6
    takes up to 8 shards) and the window decodes the shards
    round-robin.  Loss is per shard per window (every window starts on
    fresh rings), summed."""

    def __init__(self, capacity: int, n_shards: int, fresh_fn,
                 proxy_ports: np.ndarray = None, gather: bool = True,
                 device=None):
        # fresh_fn: () -> the sharded EventRing (parallel.mesh builds
        # it: the layout belongs to the mesh)
        super().__init__(capacity, proxy_ports=proxy_ports, gather=gather,
                         device=device)
        self.n_shards = int(n_shards)
        self._fresh_fn = fresh_fn

    def fresh(self) -> EventRing:
        return self._fresh_fn()


def _unpack_rows(packed: np.ndarray,
                 proxy_ports: np.ndarray = None) -> np.ndarray:
    """Packed [m, RING_WORDS] device rows -> decoded [m, RING_COLS]
    (OUT_* columns + pkt_idx + batch), pure host numpy.
    ``proxy_ports`` (same table given to :func:`ring_append`) restores
    redirect ports from their 4-bit wire index."""
    w0, w1 = packed[:, 0], packed[:, 1]
    rows = np.empty((len(packed), RING_COLS), dtype=np.uint32)
    rows[:, OUT_VERDICT] = w0 & 0x7
    rows[:, OUT_EVENT] = (w0 >> 3) & 0x3
    rows[:, OUT_REASON] = (w0 >> 5) & 0xF
    rows[:, OUT_CT] = (w0 >> 9) & 0x7
    pidx = (w0 >> 12) & 0xF
    if proxy_ports is None:
        rows[:, OUT_PROXY] = 0
    else:
        # pad to the full 4-bit index space: a drain given a SHORTER
        # table than append used (listener removed between windows)
        # must degrade stale rows to port 0, not crash the drain
        table = np.zeros(MAX_PROXY_PORTS + 1, dtype=np.uint32)
        pp = np.asarray(proxy_ports, dtype=np.uint32)
        table[1:1 + len(pp)] = pp
        rows[:, OUT_PROXY] = table[pidx]
    rows[:, OUT_ID_ROW] = w0 >> 16
    rows[:, COL_PKT_IDX] = w1 & 0x7FFFF
    rows[:, COL_BATCH] = w1 >> 19
    return rows


def _decode_fetched(buf: np.ndarray, total: int, cap: int,
                    proxy_ports: np.ndarray = None,
                    gathered: bool = False
                    ) -> Tuple[np.ndarray, int, int]:
    # thread-affinity: event-worker, api, cli, offline
    """Decode ONE ring's fetched window given its 64-bit append total:
    wrap/lost math, empty-slot filter, wire unpack.  The single
    definition of the drain rules — :func:`ring_drain` (one ring),
    :func:`sharded_ring_drain` (per-chip rings), and
    :meth:`RingWindow.fetch` (the async event plane) all land here,
    the sharded ones through :func:`_decode_sharded`, so a future
    wire-format change (e.g. widening the 4-bit reason field) lands in
    one place.

    ``gathered=True`` means ``buf`` is a ``ring_gather`` output:
    already rotated into append order on device (its length is the
    rung, not the capacity), so only the prefix/empty filter
    applies."""
    lost = max(0, total - cap)
    if gathered:
        rows = buf[:min(total, cap, buf.shape[0])]
    elif total <= cap:
        rows = buf[:total]
    else:
        head = total & (cap - 1)
        rows = np.concatenate([buf[head:], buf[:head]])
    # empty slots carry event bits 0b11 (no EV_* code is 3)
    rows = rows[((rows[:, 0] >> 3) & 0x3) != 0x3]
    return _unpack_rows(rows, proxy_ports), total, lost


def _drain_window(buf: np.ndarray, cursor: np.ndarray,
                  proxy_ports: np.ndarray = None
                  ) -> Tuple[np.ndarray, int, int]:
    """Legacy full-copy decode: cursor words -> total, then
    :func:`_decode_fetched` over the whole fetched buffer."""
    total = int(_cursor_totals(cursor)[0])
    return _decode_fetched(buf, total, buf.shape[0], proxy_ports)


def _decode_sharded(words: np.ndarray, totals: np.ndarray, capacity: int,
                    proxy_ports: np.ndarray = None, gathered: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    # thread-affinity: event-worker, api, offline
    """Decode a sharded window, shard 0 first: shard s's block of
    ``words`` (its ring, or its ``ring_gather`` rung with
    ``gathered``) through :func:`_decode_fetched` with its append total
    ``totals[s]``.  Returns ``(rows, shard_ids, appended, lost)``, the
    rows with shard-LOCAL packet indices."""
    blk = words.shape[0] // len(totals)
    parts, sids = [], []
    appended = lost = 0
    for s, total in enumerate(totals):
        rows, total, lost_s = _decode_fetched(
            words[s * blk:(s + 1) * blk], int(total), capacity,
            proxy_ports, gathered)
        parts.append(rows)
        sids.append(np.full(len(rows), s, dtype=np.int64))
        appended += total
        lost += lost_s
    return np.concatenate(parts), np.concatenate(sids), appended, lost


def sharded_ring_drain(buf: np.ndarray, cursor: np.ndarray,
                       proxy_ports: np.ndarray = None
                       ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Host decode of a SHARDED ring window (per-shard private rings
    drained round-robin, shard 0 first).

    ``buf`` is the fetched [n_shards * cap, RING_WORDS] buffer (shard
    s owns rows [s*cap, (s+1)*cap)), ``cursor`` the [n_shards, 2]
    per-shard cursors.  Returns ``(rows, shard_ids, appended, lost)``
    — ``rows`` decoded like :func:`ring_drain` with shard-LOCAL packet
    indices, ``shard_ids`` aligned per row (global row = shard * block
    + pkt_idx)."""
    return _decode_sharded(buf, _cursor_totals(cursor),
                           buf.shape[0] // cursor.shape[0], proxy_ports)


def ring_drain(ring: EventRing,
               proxy_ports: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, int, int]:
    """Fetch + decode the ring on the host: ONE device->host copy of
    buffer and cursor together, then the host decode.

    Returns (rows [m, RING_COLS] in append order, total_appended,
    n_overwritten)."""
    words = to_numpy(torch.cat([ring.cursor, ring.buf.reshape(-1)]))
    return _drain_window(words[2:].reshape(-1, RING_WORDS), words[:2],
                         proxy_ports)
