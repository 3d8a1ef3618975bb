"""Adaptive batcher: stream -> fixed-shape device batches.

The device path wants large fixed shapes (every distinct batch shape
has its own staging slots); the stream wants low latency.  The batcher pads
to a small LADDER of power-of-two bucket sizes — bounding the set of
compiled shapes to ``len(ladder)`` — and flushes on bucket-full OR a
max-wait deadline, so tail latency is bounded at low load and
throughput is maximized at high load (the continuous-batching
trade-off every serving stack makes; upstream's analogue is NAPI
polling — batch what arrived, don't wait for a full ring).

Padding rows are ZEROS carried with a ``valid`` mask: the datapath
masks them out of CT and metrics (``datapath_step(valid=...)``) and
the event ring never emits them, so a padded batch is
indistinguishable from its real rows downstream.

Two staging disciplines:

- **Arena (the production hot path).** Buffers come from a
  preallocated per-bucket :class:`BucketArena` recycled round-robin —
  no per-batch allocation, queue rows memcpy straight into the slot
  (``IngressQueue.take_into``).  OWNERSHIP HANDOFF RULE: a slot handed
  out with batch N of bucket B is reused by batch N + ``depth`` of
  the SAME bucket; the consumer (the daemon retains ``hdr`` for the
  drain-time event join, and may still be feeding an async h2d copy)
  must be done with it by then.  ``Daemon.start_serving`` sizes
  ``depth`` to its retention window, which is the only consumer
  contract.  With the async event plane (``serving/eventplane.py``)
  that horizon covers WINDOWS IN FLIGHT
  ON THE EVENT-JOIN WORKER too: each drain window snapshots its
  batch records (arena-slot ``hdr`` references included) at swap
  time and rides a bounded queue until the worker joins it, so a
  slot may be live for up to (window_queue_depth [queued] + 1
  [joining] + 1 [accumulating] + 1 [mid-join slack]) * drain_every
  batches after dispatch — the ``(window_queue_depth + 3) *
  drain_every + 2`` depth ``start_serving`` passes.  The depth is a
  GUARANTEE, not a hope: the worker refuses joins older than the
  matching join horizon (``Daemon._event_join``) as counted drops,
  so a stalled plane can never join against a recycled slot.  A
  dropped window releases its references when the worker counts the
  drop; nothing extends the horizon past stop() because
  ``stop_serving`` drains the worker before the runtime sweeps.
- **``pack=...`` (the 16 B/packet h2d format).** When a batch's rows
  are IPv4 with one (ep, dir) stream (``core.packets.
  pack_eligibility``), the batcher emits PACKED [bucket, 4] rows
  (``AssembledBatch.packed`` True, ``ep``/``dirn`` carried as stream
  metadata) — 4x fewer bytes on the host->device link.  Ineligible
  traffic (IPv6, mixed streams, out-of-width fields) keeps the wide
  [bucket, N_COLS] fallback shape, so each ladder rung compiles at
  most one packed and one wide executable.

On the card (``pin=True``) every arena slot is a numpy ``uint32`` (or
``bool``) view of a PINNED int32 (or bool) torch tensor, so the loader
stages a batch with ONE ``non_blocking`` host-to-device copy straight
out of the slot (``TorchLoader._to_device``).  That copy is still in
flight when the dispatch returns: the recycling horizon above is what
makes it safe.  The daemon's drain tick, which fires at least once
every ``drain_every`` dispatches and ``depth`` exceeds, reads the ring
cursor to the host, and that read waits for every copy and kernel
issued on the stream before it; so a slot's copy has landed before
the slot is handed out again.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from .ingress import IngressQueue

# default arena depth: enough slots that a consumer retaining a
# handful of in-flight windows (async h2d + event join) never sees a
# slot recycled under it; Daemon.start_serving overrides to match its
# actual retention horizon
DEFAULT_ARENA_DEPTH = 16


class AssembledBatch(NamedTuple):
    hdr: np.ndarray  # [bucket, N_COLS] u32, or [bucket, 4] when packed
    valid: np.ndarray  # [bucket] bool
    n_valid: int
    arrivals: List[Tuple[int, float]]  # (count, t_arrival) chunks
    packed: bool = False  # hdr is the 16 B/packet wire format
    ep: int = 0  # stream metadata scalars (packed batches only)
    dirn: int = 0


class SuperBatch(NamedTuple):
    """K batches fused into ONE device dispatch: the
    drain loop pays its per-dispatch Python cost (lock window, arena
    bookkeeping, one loader call) once per K batches.  Every step is a
    FULL top-rung bucket — :meth:`AdaptiveBatcher.assemble_super`
    rounds the ready-batch count DOWN to a power-of-two K, so no
    device math is wasted on empty steps and per-step valid masks are
    all-true (they still ship: one compiled shape per (bucket, K)).

    ``hdr``/``valid`` are ``steps=K`` arena slots under the same
    recycling-horizon contract as single batches — a superbatch slot
    is handed out per DISPATCH, so it recycles after ``depth`` more
    superbatches of the same shape, which is K times LONGER in batch
    units than the single-batch horizon the consumer is sized for."""

    hdr: np.ndarray  # [K, bucket, N_COLS] u32, or [K, bucket, 4]
    valid: np.ndarray  # [K, bucket] bool
    bucket: int
    arrivals: List[Tuple[int, float]]  # merged (count, t) chunks
    packed: bool = False
    eps: Optional[np.ndarray] = None  # [K] u32 per-step stream meta
    dirns: Optional[np.ndarray] = None  # (packed superbatches only)

    @property
    def k(self) -> int:
        return self.hdr.shape[0]

    @property
    def n_valid(self) -> int:
        # every step is a full bucket (assemble_super's contract)
        return self.hdr.shape[0] * self.bucket


def _pinned_zeros(shape: tuple, dtype) -> np.ndarray:
    """Zeroed numpy array over pinned (page-locked) host memory: a
    ``uint32`` view of an int32 tensor, or a bool one.  The array keeps
    its tensor alive (numpy's base reference)."""
    import torch

    if np.dtype(dtype) == np.bool_:
        return torch.zeros(shape, dtype=torch.bool,
                           pin_memory=True).numpy()
    if np.dtype(dtype) != np.uint32:
        raise TypeError(f"pinned arena slots are uint32 or bool, not "
                        f"{np.dtype(dtype)}")
    return torch.zeros(shape, dtype=torch.int32,
                       pin_memory=True).numpy().view(np.uint32)


class BucketArena:
    """Preallocated per-(bucket, width) staging slots, recycled
    round-robin.  Slots allocate lazily on first use of a shape, so
    an all-packed session never pays for wide slots at the big rungs
    (and vice versa).  ``pin=True`` places them in pinned host memory
    (module doc: one asynchronous copy to the card per batch)."""

    def __init__(self, depth: int = DEFAULT_ARENA_DEPTH,
                 pin: bool = False):
        assert depth >= 2, "arena depth < 2 would alias consecutive batches"
        self.depth = int(depth)
        self.pin = bool(pin)
        self._slots: Dict[tuple, np.ndarray] = {}
        self._next: Dict[tuple, int] = {}

    def slot(self, bucket: int, cols: int,
             dtype=np.uint32, steps: int = 0) -> np.ndarray:
        # thread-affinity: drain, api
        """Next staging buffer for this shape ([bucket, cols], or
        [bucket] when cols is 0; ``steps=K`` prepends a superbatch
        axis: [K, bucket, cols]).  The caller owns it for the next
        ``depth - 1`` requests of the SAME shape (see module doc) —
        superbatch slots are requested per DISPATCH, so their horizon
        in batch units is K times the single-batch one."""
        key = (int(steps), int(bucket), int(cols),
               np.dtype(dtype).str)
        pool = self._slots.get(key)
        if pool is None:
            shape = (bucket, cols) if cols else (bucket,)
            if steps:
                shape = (steps,) + shape
            shape = (self.depth,) + shape
            pool = (_pinned_zeros(shape, dtype) if self.pin
                    else np.zeros(shape, dtype=dtype))
            self._slots[key] = pool
        i = self._next.get(key, 0)
        self._next[key] = (i + 1) % self.depth
        return pool[i]

    def occupancy(self) -> Dict[str, int]:
        # thread-affinity: drain
        """Allocated staging footprint (shapes lazily materialize on
        first use) — the obs plane's arena-occupancy gauge.  DRAIN
        THREAD ONLY: iterating the lazily-growing slot dict is only
        safe on the thread that grows it (runtime._sample_gauges)."""
        return {"shapes": len(self._slots),
                "bytes": sum(p.nbytes for p in self._slots.values())}


class AdaptiveBatcher:
    def __init__(self, bucket_ladder, max_wait_us: float,
                 pack: bool = False,
                 arena_depth: int = DEFAULT_ARENA_DEPTH,
                 pin: bool = False):
        self.ladder = tuple(int(b) for b in bucket_ladder)
        assert self.ladder == tuple(sorted(set(self.ladder))), \
            "ladder must be validated (ascending, unique) upstream"
        self.max_wait_s = float(max_wait_us) * 1e-6
        self.pack = bool(pack)
        self.arena = BucketArena(arena_depth, pin=pin)
        # wide dequeue scratch, reused EVERY batch: rows land here
        # from the queue, then one copy moves them to their arena slot
        # (wide) or packs them 4x smaller (packed) — never handed out
        self._scratch: Optional[np.ndarray] = None

    def bucket_for(self, n: int) -> int:
        """Smallest ladder bucket holding ``n`` rows (the largest
        bucket when ``n`` exceeds it — callers take at most that)."""
        for b in self.ladder:
            if n <= b:
                return b
        return self.ladder[-1]

    def due(self, queue: IngressQueue,
            now: Optional[float] = None) -> bool:
        # thread-affinity: drain, api
        """Is a flush warranted right now?  Full-bucket OR deadline."""
        pending = queue.pending
        if pending == 0:
            return False
        if pending >= self.ladder[-1]:
            return True
        return queue.oldest_age(now) >= self.max_wait_s

    def assemble(self, queue: IngressQueue,
                 now: Optional[float] = None,
                 force: bool = False) -> Optional[AssembledBatch]:
        # thread-affinity: drain, api
        """Dequeue one batch if a flush is due; None otherwise.
        ``force`` flushes whatever is queued regardless of deadline
        (the stop/drain path).

        The returned ``hdr``/``valid`` buffers are ARENA slots —
        ownership transfers to the dispatcher under the recycling
        horizon documented in the module header: the dispatcher may
        retain ``hdr`` for the drain-time event join and feed an
        async h2d copy, and the slot is not touched again until
        ``depth`` more batches of the same shape have assembled.

        The ``valid`` mask is passed even for full buckets so each
        bucket size stays ONE compiled shape (a with-mask and a
        without-mask variant would double the compile count)."""
        if now is None:
            now = time.monotonic()
        if not force and not self.due(queue, now):
            return None
        cap = self.ladder[-1]
        if self._scratch is None or self._scratch.shape[0] < cap:
            w = queue.row_width()
            if w is None:  # force-flush of an empty queue
                return None
            # one scratch per session: the queue admits a single row
            # schema (submit() width-checks), so the first chunk's
            # width is THE width
            self._scratch = np.zeros((cap, w), dtype=np.uint32)
        n, arrivals = queue.take_into(self._scratch)
        if n == 0:
            return None
        bucket = self.bucket_for(n)
        rows = self._scratch[:n]
        packed, ep, dirn = False, 0, 0
        if self.pack:
            from ..core.packets import (PACKED_COLS, pack_eligibility,
                                        pack_rows)

            packed, ep, dirn = pack_eligibility(rows)
        if packed:
            hdr = self.arena.slot(bucket, PACKED_COLS)
            pack_rows(rows, out=hdr)
        else:
            hdr = self.arena.slot(bucket, self._scratch.shape[1])
            hdr[:n] = rows
        # recycled-slot hygiene, shared by both wire formats: the tail
        # may hold a previous batch's rows
        hdr[n:] = 0
        valid = self.arena.slot(bucket, 0, dtype=bool)
        valid[:n] = True
        valid[n:] = False
        return AssembledBatch(hdr=hdr, valid=valid, n_valid=n,
                              arrivals=arrivals, packed=packed,
                              ep=ep, dirn=dirn)

    def assemble_super(self, queue: IngressQueue, k_max: int,
                       now: Optional[float] = None,
                       force: bool = False):
        # thread-affinity: drain, api
        """Multi-batch assembly: when at least TWO full
        top-rung buckets are pending, dequeue K of them — K rounded
        DOWN to the largest power of two <= min(k_max, ready) so no
        step is ever padded whole — in ONE exception-atomic
        ``take_into`` against a ``steps=K`` arena slot, and return a
        :class:`SuperBatch` for the fused K-batch dispatch.

        Anything less rides the single-batch path unchanged (the
        adaptive K=1 fallback): a partial bucket keeps its own
        deadline semantics and per-batch pack eligibility, so low
        offered load sees byte-identical behavior to ``assemble`` —
        superbatching only engages when the queue is deep enough that
        dispatch amortization is the binding constraint.

        Packed wire format: the K steps dequeue into the WIDE slot
        first (it doubles as staging), each step's eligibility is
        checked independently, and only an all-eligible superbatch
        re-packs into the 16 B/packet slot — per-step ``eps``/
        ``dirns`` ride along, so steps need not share a stream."""
        if now is None:
            now = time.monotonic()
        if not force and not self.due(queue, now):
            return None
        cap = self.ladder[-1]
        ready = queue.pending // cap
        if int(k_max) < 2 or ready < 2:
            return self.assemble(queue, now=now, force=force)
        K = 1
        while K * 2 <= min(int(k_max), ready):
            K *= 2
        w = queue.row_width()
        if w is None:
            return None
        wide = self.arena.slot(cap, w, steps=K)
        # ONE locked, exception-atomic dequeue for all K steps: the
        # drain thread is the only consumer, so the K*cap rows seen
        # pending above cannot shrink before the take
        n, arrivals = queue.take_into(wide.reshape(K * cap, w))
        assert n == K * cap, f"superbatch dequeue got {n}/{K * cap}"
        packed, eps, dirns, hdr = False, None, None, wide
        if self.pack:
            from ..core.packets import (PACKED_COLS, pack_eligibility,
                                        pack_rows)

            metas = [pack_eligibility(wide[k]) for k in range(K)]
            if all(m[0] for m in metas):
                hdr = self.arena.slot(cap, PACKED_COLS, steps=K)
                for k in range(K):
                    pack_rows(wide[k], out=hdr[k])
                packed = True
                eps = np.fromiter((m[1] for m in metas),
                                  dtype=np.uint32, count=K)
                dirns = np.fromiter((m[2] for m in metas),
                                    dtype=np.uint32, count=K)
        valid = self.arena.slot(cap, 0, dtype=bool, steps=K)
        valid[:] = True  # every step is a full bucket
        return SuperBatch(hdr=hdr, valid=valid, bucket=cap,
                          arrivals=arrivals, packed=packed,
                          eps=eps, dirns=dirns)

    def time_to_deadline(self, queue: IngressQueue,
                         now: Optional[float] = None) -> float:
        # thread-affinity: drain, api
        """Seconds until the head-of-line chunk's deadline expires
        (max_wait when empty) — the runtime's idle-wait bound."""
        if queue.pending == 0:
            return self.max_wait_s
        return max(0.0, self.max_wait_s - queue.oldest_age(now))
