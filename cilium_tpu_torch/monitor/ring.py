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

On the card ``ring_append`` launches the ``ring_append`` kernels
(``csrc/ring.cu``).  JAX donated the ring; here ``ring_append`` writes
``buf`` and ``cursor`` IN PLACE on the current stream.  The host decode
(``_unpack_rows`` .. ``_drain_window``) is a copy of the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..datapath.verdict import (EV_TRACE, N_OUT, OUT_CT, OUT_EVENT,
                                OUT_ID_ROW, OUT_PROXY, OUT_REASON,
                                OUT_VERDICT)
from ..device import resolve_device
from ..u32 import narrow, to_numpy, widen

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


def _cursor_totals(cursor: np.ndarray) -> np.ndarray:
    """Host cursor ([2] or [S, 2] of u32 lo/hi words) -> int64 totals
    per shard ([S])."""
    c = np.asarray(cursor, dtype=np.uint64).reshape(-1, 2)
    return (c[:, 0] | (c[:, 1] << np.uint64(32))).astype(np.int64)



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
    :meth:`RingWindow.fetch` (the async event plane) all land here in
    the JAX package, so a future wire-format change (e.g. widening the 4-bit reason
    field) lands in one place.

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
